"""Entry points of the port (twin of the repo's `__graft_entry__.py`).

`entry()` returns the flagship forward step, one batched NMPC RTI tick
(prepare + condense + box-QP + expand) at the reference horizon (N=50,
dt=0.01) over B=64 scenarios, with its example inputs on the card.
`dryrun_multichip(n)` runs the four sharded programs of the multi-device
dry run over n ranks (`parallel/dryrun.py`).

    python -m alore_legged_manipulator_tpu_torch.entry [--device cpu]

runs the tick once, then the dry run over every card of the host (one
gloo rank with `--device cpu`).
"""
from __future__ import annotations

import numpy as np
import torch

from .control.nmpc import NmpcCarry, NmpcConfig, nmpc_rti_step
from .core.dynamics import ICRParams
from .utils.precision import resolve_device, set_precision_policy

B = 64


def entry_inputs(n: int = 50, dtype=torch.float32, device=None):
    """The tick's example inputs (x_traj, u_traj, x_est, ref_x, ref_u),
    drawn from numpy's generator seeded 0 as the JAX entry draws them and
    cast to `dtype` on `device` (None: the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x_traj = rng.standard_normal((B, n + 1, 3)) * 0.1
    u_traj = rng.standard_normal((B, n, 2)) * 0.1
    x_est = rng.standard_normal((B, 3)) * 0.1
    ts = 0.01 * np.arange(1, n + 2)
    ref_x = np.broadcast_to(np.stack([ts, 0 * ts, 0 * ts]), (B, 3, n + 1))
    ref_u = np.ones((B, 2, n + 1))
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dtype=dtype,
                                                            device=dev)
                 for a in (x_traj, u_traj, x_est, ref_x, ref_u))


def entry(device=None, dtype=torch.float32):
    """(fn, example_args): fn(x_traj, u_traj, x_est, ref_x, ref_u) -> the
    (B, 2) wheel commands of one RTI tick over the lane axis; the example
    arguments in `dtype` on `device` (None: the card)."""
    set_precision_policy()
    cfg = NmpcConfig()
    icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)

    def fn(x_traj, u_traj, x_est, ref_x, ref_u):
        _, u_cmd, _, _ = nmpc_rti_step(NmpcCarry(x_traj=x_traj, u_traj=u_traj),
                                       x_est, ref_x, ref_u, icr, cfg)
        return u_cmd

    return fn, entry_inputs(cfg.horizon, dtype, device)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The four sharded programs (closed-loop tick, contact env step,
    back-end plan fleet, mission fleet) over `n_devices` ranks at the
    JAX package's per-device sizes, one process a rank
    (`parallel/dryrun.py`, NCCL on cards, gloo with device="cpu")."""
    from .parallel import dryrun
    dryrun.main(["--ranks", str(n_devices), "--device", device])


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    fn, args = entry(device=a.device)
    out = fn(*args)
    print("entry OK:", tuple(out.shape))
    dryrun_multichip(torch.cuda.device_count() if a.device == "cuda" else 1,
                     a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
