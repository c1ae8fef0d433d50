"""The port's twin of `bench.py` (`alore_legged_manipulator_tpu_torch/bench.py`)
at tiny sizes on the CPU.

* Same lines: each of the five lines carries its JAX twin's metric name
  and exactly its keys (read from the `json.dumps({...})` literals of
  `bench.py` by `ast`), plus `device` ("cpu" here), `power_limit_w`
  (null here) and, where the JAX line reports only a median,
  `rate_min_max` and `timed_iters`.  The twin reads the JAX bench's
  environment variables with its defaults (`ast` again), and `main`
  passes them on.
* Same results as JAX, float32, the JAX side with x64 off as the bench
  runs it:
  - the NMPC lines (B=2, chain 2; B=1, chain 2): the chain's sum of
    commands against the JAX bench's chained program, 1e-4 (absolute and
    relative: ten float32 commands a tick, summed);
  - the wavefront line (B=4, plain version against JAX's `xla` path):
    the sum of the start cells' distances within 1e-6 relative (the
    fields are equal; the sum's order may differ) and the valid path
    cells exactly;
  - the back-end line (B=2, chain 1), held to JAX's run recorded by
    tests/bench_capture.py: no collision on either side, every final XY
    error under 1e-2 m (tests/test_torch_backend.py's goal bound), the
    fleet's and the chain's total durations within 5% (its duration
    band);
  - the mission line (B=2, K=1, 700 / 300 ticks, 30-tick correction
    legs, one iteration, no warm-up), held to the same capture:
    `delivered_frac`, `corrected_legs` and `correction_rounds` equal,
    the delivered flags before the rounds equal, and each object's
    error before and after the rounds within MISSION_BAND_M of JAX's.
    The pushes carry the objects from 6.0-6.7 m to 1.8-3.1 m of their
    targets but do not deliver them, so every leg runs all three rounds
    and the counts do not hang on the plant noise, whose streams differ
    between JAX and the port.  MISSION_BAND_M is four times the largest
    JAX-vs-JAX gap in the capture, where JAX ran each mission again with
    another noise seed and the start moved 1e-4 m (seen 0.101 m).
* No fallback: without a card the default device raises.
"""
import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch import bench as tb
from tests import bench_capture as cap

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
EXTRA = {"device", "power_limit_w", "rate_min_max", "timed_iters"}
CAPTURE = np.load(REPO / "alore_legged_manipulator_tpu_torch" / "data" /
                  "bench_capture.npz")
# the object errors' band, m: four times the largest JAX-vs-JAX gap of
# the capture's `*_alt` runs (0.101 m)
MISSION_BAND_M = 0.4


def jax_lines(path):
    """{metric: its keys} of every `json.dumps({...})` literal of a file."""
    lines = {}
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys = [k.value for k in node.args[0].keys]
            metric = node.args[0].values[keys.index("metric")].value
            lines[metric] = set(keys)
    return lines


def env_reads(path):
    """{name: default} of every `os.environ.get(name[, default])` (or a
    local alias `env(...)`) of a file."""
    reads = {}
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr == "get"
                and ast.unparse(f.value) == "os.environ") or \
                (isinstance(f, ast.Name) and f.id == "env"):
            if isinstance(node.args[0], ast.Constant):
                d = node.args[1] if len(node.args) > 1 else None
                reads[node.args[0].value] = (
                    d.value if isinstance(d, ast.Constant) else
                    None if d is None else ast.unparse(d))
    return reads


def check_line(line, jax_keys, median_only=True):
    assert set(line) - EXTRA == jax_keys, sorted(set(line) ^ jax_keys)
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    if median_only:
        assert line["timed_iters"] >= 1
    json.dumps(line)


JAX_LINES = jax_lines(REPO / "bench.py")


def test_bench_twin_reads_the_jax_variables():
    jax_env = env_reads(REPO / "bench.py")
    assert len(jax_env) == 16
    # the unroll default is an expression of the config in JAX
    # (2 * mem_size); the twin reads the variable alone and computes the
    # same default in `backend_line`
    assert jax_env.pop("BENCH_BACKEND_UNROLL") == \
        "str(2 * cfg.lbfgs.mem_size)"
    twin_env = env_reads(Path(tb.__file__))
    assert twin_env.pop("BENCH_BACKEND_UNROLL") is None
    assert twin_env == jax_env


def _jax_nmpc_chain(B, K, perturb_traj):
    """The JAX bench's chained RTI program on its inputs, with the first
    repetition's 1e-6 perturbation of x_est (line 1) or x_traj (line 2)."""
    from alore_legged_manipulator_tpu.control.nmpc import (
        NmpcCarry, NmpcConfig, nmpc_rti_step)
    from alore_legged_manipulator_tpu.core.dynamics import ICRParams
    cfg = NmpcConfig()
    icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)
    xt, ut, xe, rx, ru = (jnp.asarray(t.numpy()) for t in
                          tb.nmpc_inputs(B, cfg.horizon, "cpu"))
    if perturb_traj:
        xt = xt + jnp.float32(1e-6)
    else:
        xe = xe + jnp.float32(1e-6)

    @jax.jit
    def chained(x_traj, u_traj, x_est):
        def body(carry, _):
            xt, ut = carry
            f = jax.vmap(lambda xt, ut, xe, rx, ru: nmpc_rti_step(
                NmpcCarry(x_traj=xt, u_traj=ut), xe, rx, ru, icr, cfg))
            c2, u_cmd, _, _ = f(xt, ut, x_est, rx, ru)
            return (c2.x_traj, c2.u_traj), jnp.sum(u_cmd)
        _, sums = jax.lax.scan(body, (x_traj, u_traj), None, length=K)
        return jnp.sum(sums)

    return float(chained(xt, ut, xe))


def test_nmpc_rti_line():
    line, out = tb.nmpc_rti_line(2, 2, 1, device="cpu")
    check_line(line, JAX_LINES["nmpc_rti_solves_per_s_per_chip_N50"])
    assert line["timed_iters"] == 1 and out["peak_mem_bytes"] is None
    with jax.enable_x64(False):
        ref = _jax_nmpc_chain(2, 2, perturb_traj=False)
    np.testing.assert_allclose(out["checksum"], ref, rtol=1e-4, atol=1e-4)


def test_nmpc_latency_line():
    line, out = tb.nmpc_latency_line(2, 1, device="cpu")
    check_line(line, JAX_LINES["nmpc_solve_latency_onchip_ms"])
    assert line["budget_ms"] == 9.7 and line["p50_ms"] == line["value"]
    with jax.enable_x64(False):
        ref = _jax_nmpc_chain(1, 2, perturb_traj=True)
    np.testing.assert_allclose(out["checksum"], ref, rtol=1e-4, atol=1e-4)


def test_wavefront_line():
    from alore_legged_manipulator_tpu.ops.esdf import esdf_from_occupancy
    from alore_legged_manipulator_tpu.ops.wavefront import wavefront_path
    from alore_legged_manipulator_tpu.planner.frontend import FrontendConfig
    B = 4
    line, out = tb.wavefront_line(B, "torch", 1, device="cpu")
    check_line(line, JAX_LINES["wavefront_frontend_paths_per_s_per_chip"])
    assert line["fleet"] == B and line["impl"] == "torch"
    with jax.enable_x64(False):
        occ = np.zeros((100, 100), bool)
        occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
        occ[40:44, 10:70] = True
        occ[70:74, 30:95] = True
        esdf = esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1)
        blocked = esdf.dist < FrontendConfig().safe_dis
        s_cells, g_cells = (jnp.asarray(t.numpy().astype(np.int32))
                            for t in tb.wavefront_starts_goals(B, "cpu"))

        def one(sc, gc):
            dist, _, n = wavefront_path(blocked, gc, sc, 256, impl="xla")
            return dist[sc[0], sc[1]], jnp.sum(n)
        d, n = jax.jit(jax.vmap(one))(s_cells, g_cells)
    np.testing.assert_allclose(out["dist_sum"], float(jnp.sum(d)), rtol=1e-6)
    assert out["path_cells"] == int(jnp.sum(n))


def test_wavefront_impl_names():
    assert tb.WAVEFRONT_IMPLS["pallas"] == "auto"
    assert tb.WAVEFRONT_IMPLS["jnp"] == tb.WAVEFRONT_IMPLS["xla"] == "torch"
    # "auto" (the default) is the kernel on the card, plain on the CPU
    assert tb.wavefront_line(2, "auto", 1, device="cpu")[0]["impl"] == \
        "torch"


def test_backend_line():
    line, out = tb.backend_line(cap.BACKEND_B, chain=cap.BACKEND_CHAIN,
                                lat_goals=1, reps=1, lat_reps=1,
                                warmup=False, device="cpu")
    check_line(line, JAX_LINES["backend_full_plans_per_s_per_chip"])
    assert line["budget_ms"] == 50.0
    assert out["collisions"] == 0 == int(CAPTURE["backend_collision"].sum())
    assert out["goal_err_max"] < 1e-2
    assert CAPTURE["backend_final_xy_err"].max() < 1e-2
    ref = float(CAPTURE["backend_duration"].sum())
    assert abs(out["times_sum"] - ref) / ref < 0.05, (out["times_sum"], ref)
    ref = float(CAPTURE["backend_lat_checksum"])
    assert abs(out["lat_checksum"] - ref) / ref < 0.05, (out["lat_checksum"],
                                                        ref)


def test_mission_line():
    line, out = tb.mission_line(cap.MISSION_B, 1, K=cap.MISSION_K,
                                approach_ticks=cap.MISSION_TICKS[0],
                                push_ticks=cap.MISSION_TICKS[1],
                                corr_ticks=cap.MISSION_CORR, warmup=False,
                                device="cpu")
    # the JAX line already reports rate_min_max and timed_iters
    assert set(line) - {"device", "power_limit_w"} == \
        JAX_LINES["full_missions_per_s_per_chip"]
    assert line["device"] == "cpu" and line["timed_iters"] == 1
    assert line["objects_per_mission"] == cap.MISSION_K
    miss = CAPTURE["mission_miss_counts"]
    assert line["delivered_frac"] == \
        round(float(CAPTURE["mission_delivered"].mean()), 4)
    assert line["corrected_legs"] == int(miss.sum())
    assert line["correction_rounds"] == len(miss)
    assert out["delivered_before"] == \
        float(CAPTURE["mission_delivered_before"].mean())
    for key in ("object_err_before", "object_err"):
        np.testing.assert_allclose(out[key], CAPTURE[f"mission_{key}"],
                                   rtol=0, atol=MISSION_BAND_M, err_msg=key)


def test_main_passes_the_jax_defaults_and_variables(monkeypatch):
    calls = {}

    def fake(name):
        def run(*args, **kw):
            calls[name] = args
            return {"metric": name}, {}
        return run

    for name in ("nmpc_rti_line", "nmpc_latency_line", "backend_line",
                 "wavefront_line", "mission_line"):
        monkeypatch.setattr(tb, name, fake(name))
    for var in env_reads(REPO / "bench.py"):
        monkeypatch.delenv(var, raising=False)
    lines = tb.main(["--device", "cpu"])
    assert [x["metric"] for x in lines] == [
        "nmpc_rti_line", "nmpc_latency_line", "backend_line",
        "wavefront_line", "mission_line"]
    assert calls["nmpc_rti_line"] == (16384, 10)
    assert calls["nmpc_latency_line"] == (100, 12)
    assert calls["backend_line"] == (512, "compact", 6, 4, None)
    assert calls["wavefront_line"] == (16384, "auto")
    assert calls["mission_line"] == (64, 4, "compact")
    calls.clear()
    for var, val in (("BENCH_NMPC_LATENCY", "0"), ("BENCH_WAVEFRONT", "0"),
                     ("BENCH_MISSION", "0"), ("BENCH_BATCH", "8"),
                     ("BENCH_BACKEND_UNROLL", "3"),
                     ("BENCH_WAVEFRONT_IMPL", "jnp")):
        monkeypatch.setenv(var, val)
    tb.main(["--device", "cpu"])
    assert sorted(calls) == ["backend_line", "nmpc_rti_line"]
    assert calls["nmpc_rti_line"] == (8, 10)
    assert calls["backend_line"][-1] == 3


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.nmpc_rti_line(2, 1, 1)
