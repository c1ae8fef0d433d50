"""Throughput of the contact-physics pushing env (twin of
examples/bench_physics_env.py).

Measures env-steps/s for `rl/env_physics.py` -- each step is 4 substeps
of the sequential-impulse contact solve (manifold + 8 PGS iterations +
grasp weld + floor friction) plus observation/reward -- batched over
thousands of scenes on `--device`, `chain` dependent steps a call (the
JAX bench's chain inside one jit, here an eager loop ended by one
synchronize); one call warms up, then the best of 5 is reported in the
JAX bench's line, followed by a line with the device, its power limit
and the slowest and fastest rates.

    BENCH_BATCH=4096 BENCH_CHAIN=25 python -m \
        alore_legged_manipulator_tpu_torch.examples.bench_physics_env [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import torch

from ..bench import device_fields, rate_band, timed
from ..rl import env_physics as penv
from ..utils.precision import resolve_device, set_precision_policy


def physics_env_line(B: int = 4096, chain: int = 25, reps: int = 5,
                     device=None, states=None):
    """(text, out): the JAX bench's line, and out = {"best_s",
    "steps_per_s", "rate_min_max", "timed_iters", "reward_sum" and
    "state" of the last call, "device", "power_limit_w"}.
    states: the B scenes to start from (None: `env_reset` from the CPU
    generator seeded 0)."""
    dev = resolve_device(device)
    set_precision_policy()
    cfg = penv.PhysicsEnvConfig()
    sts = states if states is not None else penv.env_reset(
        torch.Generator().manual_seed(0), cfg, n_envs=B, device=dev)
    acts = torch.zeros((B, 9), dtype=torch.float32, device=dev)
    acts[:, 0] = 0.4

    def chained(sts):
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(chain):
            sts, _, r, _ = penv.env_step(sts, acts, cfg)
            total = total + r.sum()
        return sts, total

    with torch.no_grad():
        sts, checksum = chained(sts)                            # warm
        times = []
        for _ in range(reps):
            t, (sts, checksum) = timed(lambda: chained(sts), dev)
            times.append(t)
    best = min(times)
    steps_per_s = B * chain / best
    text = (f"physics env: B={B} K={chain} batch-time {best*1e3:.1f} ms "
            f"-> {steps_per_s/1e3:.1f}k env-steps/s/chip "
            f"({steps_per_s*cfg.base.dt:.0f}x realtime aggregate)")
    return text, {"best_s": best, "steps_per_s": steps_per_s,
                  "rate_min_max": rate_band(B * chain, times),
                  "timed_iters": len(times), "reward_sum": float(checksum),
                  "state": sts, **device_fields(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = resolve_device(ap.parse_args(argv).device)
    text, out = physics_env_line(int(os.environ.get("BENCH_BATCH", "4096")),
                                 int(os.environ.get("BENCH_CHAIN", "25")),
                                 device=dev)
    print(text, flush=True)
    print(f"device: {out['device']}, power_limit_w: {out['power_limit_w']}, "
          f"rate_min_max: {out['rate_min_max']} env-steps/s, "
          f"timed_iters: {out['timed_iters']}", flush=True)
    return {k: v for k, v in out.items() if k != "state"} | {"line": text}


if __name__ == "__main__":
    main()
