"""The port's batched LTV-MPC closed-loop tick
(`parallel/mesh.py::batched_ltv_tracking_step`) against the benchmark's
plain reference (`portbench/reference/ltv_tick.py`), which shares no code
with the port.

* Three lanes under way on a short seeded route, five ticks, each
  recomputed by the reference from the port's input state: 1e-9 at
  float64 (the same arithmetic ordered otherwise: the reference
  assembles the QP row by row and solves with inverted factors; 1e-13
  seen on the commands), and within the `ltv-fleet4096` cell's limits
  at float32.  The route's pose grid is fine enough (4096 steps over 4
  s) that the port's pre-integrated flow is exact to rounding.
* Each lane of a three-lane tick equals that lane run alone.
* One traced tick opens `tick` with its children, three passes of
  `ltv.linearize`, `admm.factor` and `admm.iterate`, and counts 450
  ADMM steps.
* The reference's node reproduces the command of the compiled
  reference's `curve_d1` golden (tests/golden/ltv) within the tolerance
  of `tests/test_torch_ltv_mpc.py` (5e-5 at float64, 4000 ADMM steps).
"""
import json
import os

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.control.ltv_mpc import (
    LtvMpcCarry, LtvMpcConfig)
from alore_legged_manipulator_tpu_torch.control.tracked_traj import (
    build_tracked_traj)
from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
from alore_legged_manipulator_tpu_torch.estimator.icr_ekf import (
    EkfConfig, EkfState)
from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
from alore_legged_manipulator_tpu_torch.planner.flat_traj import Polynome
from alore_legged_manipulator_tpu_torch.utils import profiling
from alore_legged_manipulator_tpu_torch.world.plant import (
    PlantConfig, PlantState)
from portbench.drivers.tracking import trajectory
from portbench.reference import ltv_tick as ref
from portbench.reference.spline import WorldTraj
from tests.torch_golden_io import ltv_case

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "portbench", "configs", "ltv-mpc-3ms.json")) as f:
    CONFIG = json.load(f)
with open(os.path.join(ROOT, "portbench", "traffic",
                       "ltv-closed-loop-4096.json")) as f:
    LIMITS = json.load(f)["limits"]
LTV = LtvMpcConfig(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in CONFIG["ltv"].items()})
EKF = EkfConfig(**{k: tuple(v) for k, v in CONFIG["ekf"].items()})
PLANT = PlantConfig(**CONFIG["plant"])
TRUE_ICR = tuple(CONFIG["true_icr"])
REF_CFG = {"ltv": LTV._asdict(), "ekf": CONFIG["ekf"],
           "plant": CONFIG["plant"], "substeps": CONFIG["substeps"]}
ROUTE = trajectory({"pieces": 4, "piece_time": 1.0, "turn": 0.5,
                    "step": [0.6, 1.0]}, 2 ** 31 + 7)
T0 = 0.5                     # the first tick's time on the route, s


def _routes(dtype):
    """The port's tracked route in `dtype` and the reference's, float64."""
    r = ROUTE
    t = {k: torch.tensor(v, dtype=dtype) for k, v in r.items()}
    icr = torch.tensor([CONFIG["planner_icr"]], dtype=dtype)
    msg = Polynome(traj_start_time=torch.zeros(1, dtype=dtype),
                   inner_points=t["inner"], piece_times=t["times"],
                   init_state=t["init"], tail_state=t["tail"],
                   start_position=t["start"], icr=icr)
    t64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in r.items()}
    world = WorldTraj(t64["init"], t64["tail"], t64["inner"], t64["times"],
                      t64["start"][:, :2], icr.double())
    return build_tracked_traj(msg, n_grid=4096), world


def _state(dtype, B=3):
    """Lanes under way near the route at T0: plant, EKF and node state
    from numpy seed 0 (start offsets of a few cm, a plan of 0.5-0.9 m/s)."""
    rng = np.random.default_rng(0)
    _, world = _routes(torch.float64)
    pose = world.pose(torch.tensor([[T0]], dtype=torch.float64))[0, 0]
    xy = pose.numpy() + rng.normal(0, 0.03, (B, 3))
    v, w = rng.uniform(0.5, 0.9, B), rng.uniform(-0.3, 0.3, B)
    T = LTV.horizon
    out = np.stack([v[:, None] + rng.normal(0, 0.02, (B, T)),
                    w[:, None] + rng.normal(0, 0.02, (B, T))], 1)
    ex = np.concatenate([xy + rng.normal(0, 0.01, (B, 3)),
                         np.tile([-0.25, 0.25, 0.15], (B, 1))], 1)
    P = np.eye(6) * 0.02 + 1e-3
    t = {k: torch.tensor(a, dtype=dtype) for k, a in dict(
        xy=xy, v=v - 0.1, w=w, out=out, buff=out[:, :, :1].transpose(0, 2, 1),
        ex=ex, P=np.tile(P, (B, 1, 1))).items()}
    z = torch.zeros(B, dtype=dtype)
    return (PlantState(xytheta=t["xy"], v=t["v"], omega=t["w"], vy=z, s=z),
            EkfState(x=t["ex"], P=t["P"]),
            LtvMpcCarry(output=t["out"], delay_buff=t["buff"]),
            torch.zeros((B, 2), dtype=dtype))


def _noise(k, B, dtype):
    g = torch.Generator().manual_seed(k)
    return (torch.randn((B, 3), generator=g, dtype=torch.float64)
            * 0.01).to(dtype)


def _as_ref(state):
    plant, ekf, carry, _ = state

    def c(x):
        return x.to(torch.float64)
    return {"plant": {"xytheta": c(plant.xytheta), "v": c(plant.v),
                      "omega": c(plant.omega), "vy": c(plant.vy),
                      "s": c(plant.s)},
            "ekf_x": c(ekf.x), "ekf_P": c(ekf.P), "output": c(carry.output),
            "delay_buff": c(carry.delay_buff)}


def _gaps(got, u, want, u_ref):
    """The cells' compared numbers: largest absolute gaps, the EKF's
    covariance relative to its lane's largest entry."""
    plant = max(float((got["plant"][k] - want["plant"][k]).abs().max())
                for k in ("xytheta", "v", "omega", "vy", "s"))
    scale = want["ekf_P"].abs().amax(dim=(1, 2))[:, None, None]
    return {"u_cmd_gap": float((u.double() - u_ref).abs().max()),
            "plan_gap": float((got["output"] - want["output"]).abs().max()),
            "ekf_state_gap": float((got["ekf_x"] - want["ekf_x"]).abs().max()),
            "ekf_cov_rel_gap": float(((got["ekf_P"] - want["ekf_P"]).abs()
                                      / scale).max()),
            "plant_gap": plant}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tick_matches_the_plain_reference(dtype):
    tt, world = _routes(dtype)
    step = pm.batched_ltv_tracking_step(tt, ICRParams(*TRUE_ICR), LTV, EKF,
                                        PLANT, CONFIG["substeps"])
    state = _state(dtype)
    B = state[0].xytheta.shape[0]
    for k in range(5):
        t = float(torch.tensor(T0 + k * LTV.dt, dtype=dtype))
        noise = _noise(k, B, dtype)
        out = step(*state, noise, t)
        want, u_ref = ref.tick(_as_ref(state), noise.double(), t, world,
                               TRUE_ICR, REF_CFG)
        gaps = _gaps(_as_ref(out[:4]), out[3], want, u_ref)
        if dtype == torch.float64:
            assert max(gaps.values()) < 1e-9, gaps
        else:
            assert all(v <= LIMITS[n] for n, v in gaps.items()), gaps
        assert float(out[3][:, 0].abs().max()) > 0.3     # under way
        state = out[:4]


def _leaves(tree):
    out = []
    pm.tree_map(out.append, tree)
    return out


def test_each_lane_equals_the_lane_alone():
    tt, _ = _routes(torch.float64)
    step = pm.batched_ltv_tracking_step(tt, ICRParams(*TRUE_ICR), LTV, EKF,
                                        PLANT, CONFIG["substeps"])
    state = _state(torch.float64)
    noise = _noise(0, 3, torch.float64)
    out = _leaves(step(*state, noise, T0)[:4])
    for b in range(3):
        lane = pm.tree_map(lambda x: x[b:b + 1], state)
        alone = _leaves(step(*lane, noise[b:b + 1], T0)[:4])
        assert len(alone) == len(out) == 10
        for a, c in zip(out, alone):
            np.testing.assert_allclose(a[b:b + 1].numpy(), c.numpy(),
                                       rtol=0, atol=1e-13)


def test_a_traced_tick_opens_its_spans_and_counts_the_steps():
    tt, _ = _routes(torch.float32)
    step = pm.batched_ltv_tracking_step(tt, ICRParams(*TRUE_ICR), LTV, EKF,
                                        PLANT, CONFIG["substeps"])
    state = _state(torch.float32, B=2)
    profiling.reset()
    profiling.enable()
    try:
        step(*state, None, T0)
    finally:
        profiling.disable()
    try:
        (q,) = profiling.snapshot()["requests"]
    finally:
        profiling.reset()
    assert q["name"] == "tick" and q["lanes"] == 2
    assert {k: v["n"] for k, v in q["spans"].items()} == {
        "tick": 1, "ref": 1, "ltv.linearize": 3, "admm.factor": 3,
        "admm.iterate": 3, "ekf.predict": 1, "plant": 1, "ekf.update": 1}
    assert q["counts"] == {"admm.iters": 450}


def test_the_reference_node_reproduces_a_golden_command():
    fields, state, xref, dref, output, buff, g = ltv_case("curve_d1")
    cfg = {**LTV._asdict(), **fields, "admm_iters": 4000}
    t = {k: torch.tensor(np.asarray(v, float))[None] for k, v in dict(
        state=state[:3], xref=xref, dref=dref, output=output,
        buff=buff).items()}
    xr = t["xref"].clone()
    xr[:, 3] = ref.smooth_yaw(t["state"][:, 2], xr[:, 3])
    out, buff_after, cmd = ref.ltv_mpc(t["output"], t["buff"], t["state"], xr,
                                       t["dref"], cfg)
    np.testing.assert_allclose(cmd[0].numpy(), g["cmd"], rtol=0, atol=5e-5)
    np.testing.assert_allclose(buff_after[0].numpy(), g["buff_after"],
                               rtol=0, atol=5e-5)
