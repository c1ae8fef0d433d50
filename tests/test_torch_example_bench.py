"""The port's twins of the seven throughput examples
(`alore_legged_manipulator_tpu_torch/examples/bench_*.py`) at tiny sizes
on the CPU.

* Same lines: each JSON line carries its JAX example's metric name and
  exactly its keys (the `json.dumps({...})` literals, read by `ast`),
  plus `device`, `power_limit_w`, `rate_min_max` and `timed_iters`; the
  two examples that print text print the JAX example's text (the
  physics env's f-string pieces in order; the front end's header equal
  to the JAX header's value, each row three right-aligned numbers of
  its widths).  Each twin reads its example's environment variables
  with the same defaults.
* Same results as JAX, float32, the JAX side with x64 off as the
  examples run it:
  - closed loop (fleet 4, chain 2, one timed call after the warm-up),
    the plant noise drawn from the JAX example's per-lane keys and fed
    to the twin: every state leaf within 1e-5 after the four ticks
    (tests/test_torch_parallel.py's float32 tolerance for the tick);
  - physics env (B=4, chain 2), the twin started from the JAX resets
    (converted): poses and velocities within 1e-4 after the four steps,
    the last call's reward sum within 1e-4 (tests/test_torch_env_physics.py's
    float32 tolerance);
  - mapping (fleet 2, chain 2): the per-tick sums of log_odds[:, 0, 0]
    and the final log odds within 1e-5, the gridmaps equal;
  - front end (one fleet of 4, one timed device call): every host plan
    found on both sides with each FlatTraj field within 1e-5, the sum of
    the start cells' distances within 1e-6 relative and the valid path
    cells equal;
  - back end (B=2) and mission legs (B=2, 20 ticks), held to JAX's runs
    recorded by tests/bench_capture.py: `goal_ok_frac` and
    `collision_frac` equal, durations within 5% (tests/test_torch_backend.py's
    band), the legs' max tracking error within 2.5e-4 m (the plant noise
    streams differ; seen: 5.4e-5 m of 1.4e-3 m at 20 ticks);
  - mission fleet (B=2, K=1, 300 / 300 ticks, CORRECTION=50,
    CORRECTION_MODE=redispatch, one timed call and no separate first
    call), held to the same capture: the delivered flags before and after
    the correction and the corrected count equal, each object's error
    before and after the correction within tests/test_torch_bench.py's
    MISSION_BAND_M of JAX's (the pushes carry the objects metres toward
    their targets without delivering them, as the mission line's).
* No fallback: each `main([])` raises without a card.
"""
import ast
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.examples import (
    bench_backend, bench_closed_loop, bench_frontend, bench_mapping,
    bench_mission_fleet, bench_mission_legs, bench_physics_env)
from tests import bench_capture as cap
from tests.test_torch_bench import (CAPTURE, EXTRA, MISSION_BAND_M,
                                   env_reads, jax_lines)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TWINS = {"bench_backend": bench_backend,
         "bench_closed_loop": bench_closed_loop,
         "bench_frontend": bench_frontend, "bench_mapping": bench_mapping,
         "bench_mission_fleet": bench_mission_fleet,
         "bench_mission_legs": bench_mission_legs,
         "bench_physics_env": bench_physics_env}


def check_line(line, example):
    (metric, keys), = jax_lines(REPO / "examples" / f"{example}.py").items()
    assert line["metric"] == metric
    assert set(line) - EXTRA == keys, sorted(set(line) ^ keys)
    assert set(line) >= EXTRA
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    json.dumps(line)


# defaults that are expressions of other settings in the JAX example;
# the twin reads the variable alone and computes the same default in its
# line function
EXPRESSION_DEFAULTS = {"CORRECTION_MODE": '"inline" if corr else "none"'}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_reads_the_example_variables(name):
    jax_env = env_reads(REPO / "examples" / f"{name}.py")
    twin_env = env_reads(Path(TWINS[name].__file__))
    for var, expr in EXPRESSION_DEFAULTS.items():
        if var in jax_env:
            assert ast.dump(ast.parse(jax_env.pop(var))) == \
                ast.dump(ast.parse(expr))
            assert twin_env.pop(var) is None
    assert twin_env == jax_env


@pytest.mark.parametrize("name", sorted(TWINS))
def test_default_device_is_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TWINS[name].main([])


def test_closed_loop():
    from alore_legged_manipulator_tpu.control.nmpc import NmpcConfig
    from alore_legged_manipulator_tpu.parallel import mesh as jmesh
    from alore_legged_manipulator_tpu.parallel import scaling as jscaling
    from alore_legged_manipulator_tpu.core.dynamics import ICRParams
    from tests.test_torch_parallel import _jax_noise
    B, chain = 4, 2
    with jax.enable_x64(False):
        # jitted here only to spare the test their eager setup time
        jtt = jax.jit(lambda: jscaling._tiny_traj()[0])()
        icr = ICRParams(yr=-0.3, yl=0.3, xv=0.2)     # _tiny_traj's
        cfg = NmpcConfig()
        jstep = jax.jit(jmesh.batched_tracking_step(jtt, icr, nmpc_cfg=cfg))
        state = jax.jit(jscaling.make_fleet, static_argnums=(0, 1))(B, cfg)
        lane_noise = jax.jit(_jax_noise, static_argnums=(1, 2))
        noise = []
        for k in list(range(chain)) * 2:       # the warm-up, one timed call
            draw, _ = lane_noise(state[4], 5, jnp.float32)
            noise.append(torch.tensor(np.asarray(draw)))
            state = jstep(*state, jnp.float32(0.0) + k * cfg.dt)
    line, out = bench_closed_loop.closed_loop_line(B, chain, 1, device="cpu",
                                                   noise=noise)
    check_line(line, "bench_closed_loop")
    assert (line["fleet"], line["chain"]) == (B, chain)
    got = []
    from alore_legged_manipulator_tpu_torch.parallel.mesh import tree_map
    tree_map(got.append, out["state"])
    ref = jax.tree.leaves(state[:4])
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_physics_env():
    from alore_legged_manipulator_tpu.rl import env_physics as jep
    B, chain = 4, 2
    with jax.enable_x64(False):
        cfg = jep.PhysicsEnvConfig()
        sts = jax.jit(jax.vmap(lambda k: jep.env_reset(k, cfg)))(
            jax.random.split(jax.random.PRNGKey(0), B))
        start = from_jax_numpy(jax.tree.map(np.array, sts))
        acts = jnp.zeros((B, 9), jnp.float32).at[:, 0].set(0.4)
        step = jax.jit(jax.vmap(lambda s, a: jep.env_step(s, a, cfg)))
        total = 0.0
        for i in range(2 * chain):
            sts, _, r, _ = step(sts, acts)
            if i >= chain:
                total += float(jnp.sum(r))
    text, out = bench_physics_env.physics_env_line(B, chain, 1, device="cpu",
                                                   states=start)
    src = (REPO / "examples" / "bench_physics_env.py").read_text()
    fstr = next(n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.JoinedStr)
                and "physics env" in ast.unparse(n))
    parts = [v.value for v in fstr.values if isinstance(v, ast.Constant)]
    assert len(parts) == 6
    pos = 0
    for p in parts:
        pos = text.index(p, pos) + len(p)
    assert text.startswith(f"physics env: B={B} K={chain} ")
    assert out["timed_iters"] == 1 and out["device"] == "cpu"
    for f in ("pose", "vel"):
        np.testing.assert_allclose(getattr(out["state"].bodies, f).numpy(),
                                   np.asarray(getattr(sts.bodies, f)),
                                   rtol=0, atol=1e-4, err_msg=f)
    np.testing.assert_allclose(out["reward_sum"], total, rtol=0, atol=1e-4)


def test_mapping():
    from alore_legged_manipulator_tpu.world.lidar import (
        LidarConfig, OccupancyConfig, lidar_scan, occupancy_init,
        occupancy_update)
    B, K = 2, 2
    line, out = bench_mapping.mapping_line(B, K, 1, device="cpu")
    check_line(line, "bench_mapping")
    assert (line["fleet"], line["chain"]) == (B, K)
    with jax.enable_x64(False):
        lcfg = LidarConfig(n_beams=128, fov_rad=2 * np.pi, max_range=4.0,
                           n_steps=192)
        ocfg = OccupancyConfig()
        occ, poses = (jnp.asarray(t.numpy())
                      for t in bench_mapping.mapping_scene(B, "cpu"))
        lower = jnp.zeros(2, jnp.float32)
        st = jax.vmap(lambda _: occupancy_init((120, 120), ocfg))(
            jnp.arange(B))

        def tick(state, pose):
            ranges, hits = lidar_scan(occ, lower, jnp.float32(0.1), pose,
                                      lcfg)
            return occupancy_update(state, lower, jnp.float32(0.1), pose,
                                    ranges, hits, lcfg, ocfg)

        sums = []
        for i in range(K):
            p = poses.at[:, 2].add(0.05 * jnp.float32(i))
            st = jax.jit(jax.vmap(tick))(st, p)
            sums.append(float(jnp.sum(st.log_odds[:, 0, 0])))
    np.testing.assert_allclose(out["sums"].numpy(), sums, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["state"].log_odds.numpy(),
                               np.asarray(st.log_odds), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["state"].grid.numpy(),
                                  np.asarray(st.grid))


def test_frontend():
    from alore_legged_manipulator_tpu.ops.esdf import esdf_from_occupancy
    from alore_legged_manipulator_tpu.ops.wavefront import (
        extract_path, octile_distance_field)
    from alore_legged_manipulator_tpu.planner.frontend import (FrontendConfig,
                                                               plan_frontend)
    B = 4
    printed = []
    (row,) = bench_frontend.frontend_rows([B], device="cpu",
                                          out=printed.append, calls=1)
    src = (REPO / "examples" / "bench_frontend.py").read_text()
    header = next(n for n in ast.walk(ast.parse(src))
                  if isinstance(n, ast.JoinedStr)
                  and "host plans/s" in ast.unparse(n))
    assert printed[0] == eval(compile(ast.Expression(header), "<h>", "eval"))
    assert re.fullmatch(r" *\d+ +\d+\.\d +\d+\.\d", printed[1])
    assert len(printed[1]) == len(printed[0])
    assert printed[1].split()[0] == str(B) and row["n_ok"] == B
    rng = np.random.default_rng(0)
    s = rng.uniform([1.0, 1.0], [3.0, 8.5], (B, 2))
    g = rng.uniform([8.0, 1.0], [9.5, 8.5], (B, 2))
    with jax.enable_x64(False):
        occ = np.zeros((100, 100), bool)
        occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
        occ[40:44, 10:70] = True
        occ[70:74, 30:95] = True
        esdf = esdf_from_occupancy(jnp.asarray(occ), jnp.zeros(2), 0.1)
        esdf_np = np.asarray(esdf.dist)
        cfg = FrontendConfig()
        for i in range(B):
            ref = plan_frontend(esdf_np, (0.0, 0.0), 0.1, (*s[i], 0.0),
                                (*g[i], 0.0), cfg)
            got = row["host_flats"][i]
            for f in ref._fields:
                np.testing.assert_allclose(
                    getattr(got, f)[0].numpy().astype(float),
                    np.asarray(getattr(ref, f), float),
                    rtol=0, atol=1e-5, err_msg=f"lane {i} {f}")
        blocked = esdf.dist < cfg.safe_dis
        sc = jnp.asarray((s / 0.1).astype(np.int32))
        gc = jnp.asarray((g / 0.1).astype(np.int32))

        def one(sc, gc):
            dist = octile_distance_field(blocked, gc)
            _, n = extract_path(dist, blocked, sc, max_len=256)
            return dist[sc[0], sc[1]], n
        d, n = jax.jit(jax.vmap(one))(sc, gc)
    np.testing.assert_allclose(row["dist_sum"], float(jnp.sum(d)), rtol=1e-6)
    assert row["path_cells"] == int(jnp.sum(n))


def test_backend():
    line, out = bench_backend.backend_fleet_line(cap.BACKEND_B, reps=1,
                                                 device="cpu")
    check_line(line, "bench_backend")
    err = CAPTURE["ex_backend_final_xy_err"]
    assert line["goal_ok_frac"] == float(np.mean(err < 0.05))
    assert line["collision_frac"] == \
        float(np.mean(CAPTURE["ex_backend_collision"]))
    ref = CAPTURE["ex_backend_duration"]
    np.testing.assert_array_less(np.abs(out["duration"] - ref) / ref, 0.05)


def test_mission_legs():
    line, out = bench_mission_legs.legs_line(cap.LEGS_B, cap.LEGS_TICKS, 1,
                                             device="cpu")
    check_line(line, "bench_mission_legs")
    assert line["ticks_per_leg"] == cap.LEGS_TICKS
    assert line["goal_ok_frac"] == \
        float(np.mean(CAPTURE["legs_final_xy_err"] < 0.05))
    assert line["collision_frac"] == float(np.mean(CAPTURE["legs_collision"]))
    np.testing.assert_allclose(out["track_err_max"],
                               CAPTURE["legs_track_err_max"], rtol=0,
                               atol=2.5e-4)


def test_mission_fleet():
    line, out = bench_mission_fleet.mission_fleet_line(
        cap.FLEET_B, cap.FLEET_K, "kinematic", cap.FLEET_CORR, "redispatch",
        iters=1, approach_ticks=cap.FLEET_TICKS[0],
        push_ticks=cap.FLEET_TICKS[1], first_call=False, device="cpu")
    check_line(line, "bench_mission_fleet")
    assert line["correction_mode"] == "redispatch"
    assert line["corrected_lanes"] == int(CAPTURE["fleet_corrected"])
    np.testing.assert_array_equal(out["delivered_before"],
                                  CAPTURE["fleet_delivered_before"])
    np.testing.assert_array_equal(out["delivered"],
                                  CAPTURE["fleet_delivered"])
    assert line["delivered_frac"] == \
        float(CAPTURE["fleet_delivered"].mean())
    assert line["first_call_s"] is None
    for key in ("object_err_before", "object_err"):
        np.testing.assert_allclose(out[key], CAPTURE[f"fleet_{key}"],
                                   rtol=0, atol=MISSION_BAND_M, err_msg=key)
