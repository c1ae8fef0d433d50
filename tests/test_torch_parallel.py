"""Port parity: the data-parallel layer (`parallel/`).

The twins of tests/test_parallel.py and tests/test_distributed.py, on
gloo ranks on the CPU (tests/torch_dist_worker.py: one process per
rank, meeting through a FileStore under tmp_path, one thread each, a
120 s deadline for all of them):

* the closed-loop tick sharded over 2 ranks and gathered equals one
  process within 1e-12 at float64; the port's tick equals the JAX
  package's `batched_tracking_step` with the plant noise drawn from its
  per-lane keys, within 1e-9 at float64 and 1e-5 (the JAX test's) at
  float32, over three ticks;
* a tick issues no collective, a fleet reduction exactly one, counted by
  wrapping every collective of `torch.distributed`;
* the back-end cost and gradient sharded against one process within
  1e-12 / 1e-9 (and one process against the JAX package within 1e-9);
  the back-end plans and the mission fleet sharded against one process at
  the JAX tests' tolerances (every plan on its goal and collision-free,
  median durations within 20%; object errors within 5 cm, delivered
  verdicts equal, tracking errors within 50% + 5 cm);
* `measure_scaling([1, 2, 4])` on 4 ranks;
* the cross-rank sum and the N=50 tick over 2 ranks of
  tests/test_distributed.py; the dry run's four programs at small sizes;
* `make_mesh`: sub-meshes, refusals, the one-rank group it opens itself
  and no silent CPU fallback.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.control.nmpc import NmpcConfig as JNmpc
from alore_legged_manipulator_tpu.parallel import mesh as jmesh
from alore_legged_manipulator_tpu.parallel import scaling as jscaling
from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
from alore_legged_manipulator_tpu_torch.parallel.dryrun import (plan_esdf,
                                                                 synth_flats)
from alore_legged_manipulator_tpu_torch.planner import backend as bk
from alore_legged_manipulator_tpu_torch.runtime.mission_fleet import (
    run_mission)
from tests.torch_dist_worker import (backend_cost_grad, launch, run_ranks,
                                     small_mission, tick_inputs)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree):
    out = []
    pm.tree_map(lambda x: out.append(x), tree)
    return out


def _max_gap(a, b):
    return max(float(torch.max(torch.abs(x.double() - y.double())))
               for x, y in zip(_leaves(a), _leaves(b)))


def test_sharded_tick_matches_single_process(tmp_path):
    ranks = launch("tick", 2, tmp_path, B=16, horizon=8, dtype="float64")
    tt, icr, cfg, state, noise = tick_inputs(16, 8, torch.float64)
    single = pm.batched_tracking_step(tt, icr, nmpc_cfg=cfg)(*state, noise,
                                                             0.0)[:4]
    r = ranks.results()
    assert [x["local_lanes"] for x in r] == [8, 8]
    for x in r:
        assert _max_gap(x["out"], single) <= 1e-12
        assert x["mean_u"] == pytest.approx(
            float(torch.mean(torch.abs(single[3]))), rel=1e-12)


def test_sharded_tick_is_collective_free(tmp_path):
    """The sharded tick issues no collective of any kind; the fleet-level
    reduction of its commands issues exactly one all-reduce (the psum
    `jnp.mean` over a sharded array lowers to in the JAX package)."""
    for x in run_ranks("tick", 2, tmp_path, B=8, horizon=8, dtype="float32"):
        assert x["tick_collectives"] == {}
        assert x["reduce_collectives"] == {"all_reduce": 1}


def _jax_noise(keys, substeps, dtype):
    """The plant noise `batched_tracking_step` draws from each lane's key
    in one tick: (B, substeps, 2) normals for (v, omega), and the keys
    after it."""
    def lane(key):
        out = []
        for _ in range(substeps):
            key, sk = jax.random.split(key)
            kv, kw = jax.random.split(sk)
            out.append(jnp.stack([jax.random.normal(kv, dtype=dtype),
                                  jax.random.normal(kw, dtype=dtype)]))
        return jnp.stack(out), key
    return jax.vmap(lane)(keys)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-9), ("float32", 1e-5)])
def test_tick_matches_jax(dtype, tol):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    B, N, ticks = 16, 8, 3
    jtt, icr = jscaling._tiny_traj(jdt)
    jcfg = JNmpc(horizon=N)
    jstep = jax.jit(jmesh.batched_tracking_step(jtt, icr, nmpc_cfg=jcfg))
    jstate = jscaling.make_fleet(B, jcfg, jdt)
    tt, _, cfg, state, _ = tick_inputs(B, N, tdt)
    step = pm.batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    for k in range(ticks):
        t = 0.01 * k
        noise, _ = _jax_noise(jstate[4], 5, jdt)
        jstate = jstep(*jstate, jnp.asarray(t, jdt))
        state = step(*state, torch.tensor(np.asarray(noise)), t)[:4]
        for got, ref in zip(_leaves(state), jax.tree.leaves(jstate[:4])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=0, atol=tol)


def test_sharded_backend_cost_eval_matches_single_process(tmp_path):
    ranks = launch("backend_cost", 2, tmp_path, B=16)
    flats = synth_flats(torch.linspace(1.5, 2.5, 16, dtype=torch.float64),
                        torch.float64)
    c, g = backend_cost_grad(bk, flats, plan_esdf("cpu", torch.float64))
    # one process against the JAX package's eval_fleet
    from tests.test_parallel import _small_esdf, _synth_flat_batch
    from alore_legged_manipulator_tpu.planner import backend as jbk
    jflats = _synth_flat_batch(16, jnp.float64)
    esdf = _small_esdf(jnp.float64)
    bcfg = jbk.BackendConfig()

    def one(flat):
        tau = jbk.real_to_virtual_time(
            jnp.full((3,), flat.init_piece_time, jnp.float64))
        x = jbk.pack_vars(flat.inner_yaw_s, flat.final_state[1, 0], tau)
        f = lambda x: jbk.stage2_cost(x, flat, esdf, bcfg.safe_dis,  # noqa
                                      jnp.zeros(2), jnp.ones(2), bcfg)
        return f(x), jax.grad(f)(x)
    jc, jg = jax.jit(jax.vmap(one))(jflats)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9,
                               atol=1e-9)
    for x in ranks.results():
        np.testing.assert_allclose(x["cost"].numpy(), c.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(x["grad"].numpy(), g.numpy(), rtol=1e-9,
                                   atol=1e-10)


def test_sharded_backend_planner_quality_matches_single_process(tmp_path):
    """test_parallel.py's layer 2: plans sharded (8 lanes a rank) and in
    one process (16) are each on their goal and collision-free, and their
    duration distributions agree (per-lane plans may settle in other
    local optima: see that test)."""
    ranks = launch("plan", 2, tmp_path, per_rank=8)
    res = bk.plan_backend(synth_flats(torch.linspace(1.5, 2.5, 16)),
                          plan_esdf("cpu"), bk.BackendConfig())
    sh = ranks.results()[0]
    for times, coll, err in ((res.times, res.collision, res.final_xy_err),
                             (sh["times"], sh["collision"], sh["err"])):
        assert float(torch.abs(err).max()) < 1e-2
        assert int(coll.sum()) == 0
    d_single = res.times.sum(-1).numpy()
    d_shard = sh["times"].sum(-1).numpy()
    assert abs(np.median(d_shard) - np.median(d_single)) \
        < 0.2 * np.median(d_single)
    assert d_shard.max() < 3.0 * d_single.max()


def test_sharded_mission_fleet_matches_single_process(tmp_path):
    """test_parallel.py's mission fleet (approach 30 / push 40; 8 of its
    16 lanes) sharded over 2 ranks against one process, at that test's
    tolerances (each rank draws its own plant noise)."""
    ranks = launch("mission", 2, tmp_path, B=8)
    items, targets, robots, esdf, icr, mcfg = small_mission(8)
    res = run_mission(items, targets, robots, esdf, icr, mcfg, device="cpu")
    sh = ranks.results()[0]
    np.testing.assert_allclose(sh["object_err"].numpy(),
                               res.object_err.numpy(), atol=0.05)
    np.testing.assert_array_equal(sh["delivered"].numpy(),
                                  res.delivered.numpy())
    np.testing.assert_allclose(sh["track_err_max"].numpy(),
                               res.track_err_max.numpy(), rtol=0.5,
                               atol=0.05)


def test_scaling_harness_runs(tmp_path):
    """measure_scaling on 4 ranks gives monotone fleet sizes and finite
    rates (gloo ranks share the host's cores: the efficiency says
    nothing of a card)."""
    for x in run_ranks("scaling", 4, tmp_path, sizes=[1, 2, 4])[:1]:
        pts = x["points"]
        assert [p.n_devices for p in pts] == [1, 2, 4]
        assert all(np.isfinite(p.scenario_ticks_per_s) for p in pts)
        assert all(p.fleet == 4 * p.n_devices for p in pts)


def test_two_rank_cross_rank_sum(tmp_path):
    """tests/test_distributed.py's checks on 2 gloo ranks: cross-rank sums
    and the N=50 tracking tick with a fleet reduction of its commands."""
    r = run_ranks("cross_rank_sum", 2, tmp_path)
    expect_x = sum(float(np.sum(np.arange(8) + 1000.0 * p)) for p in (0, 1))
    for x in r:
        assert abs(x["ones"] - 16.0) < 1e-3
        assert abs(x["x_sum"] - expect_x) < 1e-2
        assert x["tick_fleet"] == 16
        assert np.isfinite(x["mean_cmd"]) and x["mean_cmd"] > 0.0
    assert r[0]["mean_cmd"] == r[1]["mean_cmd"]


def test_dryrun_multichip_small(tmp_path):
    """The dry run's four sharded programs on 2 ranks at small per-rank
    sizes, the mission at its delivering budgets (300 / 400 ticks)."""
    r = run_ranks("dryrun", 2, tmp_path, timeout=150, tick_batch=4,
                  env_batch=3, plan_batch=2, mission_batch=1)
    assert r[0] == r[1]
    assert r[0]["plan_collisions"] == 0
    assert r[0]["mission_err_max"] < 0.3


def test_mesh_blocks_and_reductions(tmp_path):
    r = run_ranks("mesh_checks", 2, tmp_path)
    x = torch.arange(12, dtype=torch.float64).reshape(-1, 3)
    flags = torch.arange(4) % 3 == 0
    for k, out in enumerate(r):
        assert out["rank"] == k and out["size"] == 2
        assert out["too_big_raises"] and out["indivisible_raises"]
        assert out["sub"] == ((0, 1) if k == 0 else (-1, 1))
        assert torch.equal(out["local"]["x"], x[2 * k:2 * k + 2])
        assert torch.equal(out["gathered"]["x"], x)
        assert torch.equal(out["gathered"]["flags"], flags)
        assert out["reduced"] == {"mean": 5.5, "sum": 66.0, "max": 11.0,
                                  "min": 0.0}


def test_make_mesh_opens_one_rank_group():
    """With no process group, make_mesh(device="cpu") opens a one-rank
    gloo group itself; a larger mesh without a group raises; device None
    means the card and raises without one (no CPU fallback)."""
    code = (
        "import torch\n"
        "from alore_legged_manipulator_tpu_torch.parallel.mesh import "
        "make_mesh\n"
        "import torch.distributed as dist\n"
        "try:\n"
        "    make_mesh(2, device='cpu')\n"
        "except ValueError:\n"
        "    print('TWO_RAISES')\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        make_mesh()\n"
        "    except RuntimeError:\n"
        "        print('NO_CARD_RAISES')\n"
        "m = make_mesh(device='cpu')\n"
        "print('MESH', m.rank, m.size, m.device, dist.get_backend())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "TWO_RAISES" in out.stdout
    assert "NO_CARD_RAISES" in out.stdout
    assert "MESH 0 1 cpu gloo" in out.stdout


def test_make_fleet_defaults_to_the_card(monkeypatch):
    """make_fleet puts the fleet on the card unless asked for the CPU,
    and raises without one (no CPU fallback)."""
    from alore_legged_manipulator_tpu_torch.control.nmpc import NmpcConfig
    from alore_legged_manipulator_tpu_torch.parallel.scaling import (
        make_fleet)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_fleet(4, NmpcConfig(horizon=8))
    plants, ekfs, carries, u_prev, gen = make_fleet(4, NmpcConfig(horizon=8),
                                                    device="cpu")
    assert gen.device.type == "cpu"
    assert all(x.device.type == "cpu"
               for x in _leaves((plants, ekfs, carries, u_prev)))
