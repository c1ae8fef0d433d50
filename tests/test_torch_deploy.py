"""Port parity: the deployment runtime (`runtime/deploy.py`,
`runtime/obs_assembly.py`) and the host modules the port keeps its own
copies of (`runtime/contracts.py`, `runtime/remote.py`,
`runtime/z1_arm.py`).

* The 799-d assembly against JAX at float64 (1e-12; seen: 0) and float32
  (1e-6; seen: 6.0e-8)
  over 30 ticks of random low states, with any number of lead axes, and
  `split_obs799`.
* `DeployController` with the policy in the loop: 50 ticks of raw low
  state -> `run_obs_assembly_tick` -> the frozen low-level policy (a
  randomized reference twin converted by each package) -> joint command,
  against the JAX controller doing the same; float32 as the JAX
  package's deployment runs, targets within 1e-5 (seen: 3.0e-8), gains and
  states equal.  The state machine with and without the operator's
  remote gate gives the same commands and states tick by tick.
* The copies: message packing, the mocap noise stream (same seed, same
  draws), the remote frames and gate, and the Z1 arm loop are equal to
  the JAX package's, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.models.torch_convert import (
    convert_low_level_actor as j_convert)
from alore_legged_manipulator_tpu.runtime import contracts as jc
from alore_legged_manipulator_tpu.runtime import deploy as jd
from alore_legged_manipulator_tpu.runtime import obs_assembly as joa
from alore_legged_manipulator_tpu.runtime import remote as jrem
from alore_legged_manipulator_tpu.runtime import z1_arm as jz
from alore_legged_manipulator_tpu_torch.models.torch_convert import (
    convert_low_level_actor as t_convert)
from alore_legged_manipulator_tpu_torch.rl.hierarchy import (
    low_level_policy_cfg)
from alore_legged_manipulator_tpu_torch.runtime import contracts as tc
from alore_legged_manipulator_tpu_torch.runtime import deploy as td
from alore_legged_manipulator_tpu_torch.runtime import obs_assembly as toa
from alore_legged_manipulator_tpu_torch.runtime import remote as trem
from alore_legged_manipulator_tpu_torch.runtime import z1_arm as tz
from tests.test_torch_convert import TorchLowAC, _randomize

torch.set_num_threads(1)


def _low_state(rng):
    return {"roll": rng.normal() * 0.05, "pitch": rng.normal() * 0.05,
            "ang_vel": rng.normal(size=3), "q": rng.normal(size=18) * 0.3,
            "dq": rng.normal(size=18)}


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float64, torch.float64, 1e-12),
                                         (jnp.float32, torch.float32, 1e-6)],
                         ids=["f64", "f32"])
def test_assembly_matches_jax(jdt, tdt, tol):
    rng = np.random.default_rng(0)
    js = joa.LowObsState.create(jdt)
    ts = toa.LowObsState.create(tdt, device="cpu")
    qd = rng.normal(size=18)
    for k in range(30):
        ls = _low_state(rng)
        cmd = rng.normal(size=3)
        args = (ls["roll"], ls["pitch"], ls["ang_vel"], ls["q"], ls["dq"],
                qd, cmd)
        js, jp, jo = joa.assemble_low_level_obs(
            js, *(jnp.asarray(a, jdt) for a in args), 0.02)
        ts, tp, to = toa.assemble_low_level_obs(
            ts, *(torch.as_tensor(np.asarray(a)).to(tdt) for a in args),
            0.02)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(ts.gait_phase.numpy(),
                                   np.asarray(js.gait_phase), rtol=0,
                                   atol=tol)
    assert to.shape == (toa.OBS_799,)
    for a, b in zip(toa.split_obs799(to), joa.split_obs799(jo)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


def test_assembly_lanes_equal_single():
    rng = np.random.default_rng(1)
    B = 4
    ts = toa.LowObsState.create(torch.float64, "cpu", batch=(B,))
    singles = [toa.LowObsState.create(torch.float64, "cpu")
               for _ in range(B)]
    for _ in range(12):
        lss = [_low_state(rng) for _ in range(B)]
        cmd = rng.normal(size=(B, 3))
        t = lambda k: torch.as_tensor(np.stack([np.asarray(l[k])
                                                for l in lss]))
        ts, _, obs = toa.assemble_low_level_obs(
            ts, t("roll"), t("pitch"), t("ang_vel"), t("q"), t("dq"),
            torch.zeros(18, dtype=torch.float64), torch.as_tensor(cmd), 0.005)
        for i in range(B):
            singles[i], _, o = toa.assemble_low_level_obs(
                singles[i], *(torch.as_tensor(np.asarray(lss[i][k])) for k in
                              ("roll", "pitch", "ang_vel", "q", "dq")),
                torch.zeros(18, dtype=torch.float64),
                torch.as_tensor(cmd[i]), 0.005)
            torch.testing.assert_close(obs[i], o, rtol=0, atol=0)


@pytest.fixture(scope="module")
def low_fns():
    sd = _randomize(TorchLowAC(), seed=11)
    pol = low_level_policy_cfg()
    pol.load_state_dict(t_convert(sd))
    return jd.make_low_level_fn(j_convert(sd)), td.make_low_level_fn(
        pol.eval())


def _cmds_equal(tcmd, jcmd, tol):
    np.testing.assert_allclose(tcmd.q_target, jcmd.q_target, rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(tcmd.kp, jcmd.kp)
    np.testing.assert_array_equal(tcmd.kd, jcmd.kd)


def test_policy_in_the_loop_fifty_ticks(low_fns):
    jfn, tfn = low_fns
    rng = np.random.default_rng(2)
    sides = []
    for mod, fn, state in ((jd, jfn, joa.LowObsState.create()),
                           (td, tfn, toa.LowObsState.create(device="cpu"))):
        cfg = mod.DeployConfig(move_to_default_s=0.04)
        sides.append([mod, mod.DeployController(bus=mod.MessageBus(),
                                                low_level_fn=fn, cfg=cfg),
                      state])
    for _, ctl, _ in sides:
        ctl.request_policy()
    for k in range(50):
        ls = _low_state(rng)
        cmd = rng.uniform(-1, 1, 3)
        out = []
        for side in sides:
            mod, ctl, state = side
            state, prop, obs = mod.run_obs_assembly_tick(state, ls, cmd,
                                                         ctl.cfg)
            side[2] = state
            p, _, hist = (toa if mod is td else joa).split_obs799(obs)
            ctl.bus.publish("low_state", {
                "q": ls["q"], "dq": ls["dq"],
                "prop": np.asarray(p.cpu() if mod is td else p),
                "prop_hist": np.asarray(hist.cpu() if mod is td else hist)})
            out.append(ctl.tick())
        assert sides[0][1].state.name == sides[1][1].state.name
        _cmds_equal(out[1], out[0], 1e-5)
    assert sides[1][1].state == td.DeployState.POLICY
    assert np.abs(out[1].q_target[:12] - sides[1][1].cfg.default_pose[:12]
                  ).max() > 1e-4



@pytest.mark.parametrize("with_remote", [False, True])
def test_state_machine_matches_jax(with_remote):
    rng = np.random.default_rng(3)
    ctls = []
    for mod, rem in ((jd, jrem), (td, trem)):
        bus = mod.MessageBus()
        gate = rem.RemoteGate() if with_remote else None
        ctl = mod.DeployController(
            bus=bus, low_level_fn=lambda p, h: np.arange(18) * 0.01,
            cfg=mod.DeployConfig(move_to_default_s=0.1), remote=gate)
        ctls.append((ctl, bus, rem))
    script = {2: "request", 3: [jrem.KeyMap.start], 12: [jrem.KeyMap.A],
              25: "estop", 26: [jrem.KeyMap.select]}
    for k in range(30):
        q = rng.normal(size=18)
        outs = []
        for ctl, bus, rem in ctls:
            bus.publish("low_state", {"q": q, "dq": np.zeros(18),
                                      "prop": np.zeros(33),
                                      "prop_hist": np.zeros((10, 33))})
            act = script.get(k)
            if act == "request":
                ctl.request_policy()
            elif act == "estop" and not with_remote:
                ctl.emergency_stop()
            elif isinstance(act, list) and with_remote:
                bus.publish("wireless_remote", rem.pack_remote(buttons=act))
            outs.append(ctl.tick())
        assert ctls[0][0].state.name == ctls[1][0].state.name, k
        _cmds_equal(outs[1], outs[0], 0.0)


def test_contract_copies_equal():
    rng = np.random.default_rng(4)
    d = rng.normal(size=15).astype(np.float32)
    d[13] = 5
    np.testing.assert_array_equal(tc.EnvControlData.unpack(d).pack(),
                                  jc.EnvControlData.unpack(d).pack())
    o = rng.normal(size=40).astype(np.float32)
    np.testing.assert_array_equal(tc.EnvObs.unpack(o).pack(),
                                  jc.EnvObs.unpack(o).pack())
    s = rng.normal(size=15)
    np.testing.assert_array_equal(tc.SimulatedCarState.unpack(s).pack(),
                                  jc.SimulatedCarState.unpack(s).pack())
    ks_t = tc.KinematicState.from_rates(0.7, -0.4, 1.0, 1.5, 2.0)
    ks_j = jc.KinematicState.from_rates(0.7, -0.4, 1.0, 1.5, 2.0)
    np.testing.assert_array_equal(ks_t.pack(), ks_j.pack())
    mt, mj = tc.MocapPerception(seed=9), jc.MocapPerception(seed=9)
    for _ in range(5):
        r = rng.normal(size=3)
        objs = [rng.normal(size=3) for _ in range(2)]
        np.testing.assert_array_equal(mt.observe(r, objs).pack(),
                                      mj.observe(r, objs).pack())


def test_remote_and_arm_copies_equal():
    frame = jrem.pack_remote(lx=0.25, rx=-0.5, ry=0.75, ly=-1.0,
                             buttons=[jrem.KeyMap.A, jrem.KeyMap.up])
    assert trem.pack_remote(lx=0.25, rx=-0.5, ry=0.75, ly=-1.0,
                            buttons=[trem.KeyMap.A, trem.KeyMap.up]) == frame
    gt, gj = trem.RemoteGate(), jrem.RemoteGate()
    for b in ([2], [8], [8], [3]):
        gt.feed(trem.pack_remote(lx=0.4, buttons=b))
        gj.feed(jrem.pack_remote(lx=0.4, buttons=b))
        gt.ramp_done()
        gj.ramp_done()
        assert gt.phase == gj.phase
        np.testing.assert_array_equal(gt.teleop_cmd(), gj.teleop_cmd())
    at, aj = tz.Z1ArmController(), jz.Z1ArmController()
    rng = np.random.default_rng(5)
    for cls in tz.OBJECT_CLASS_BY_ID:
        for r in np.linspace(0, 1, 6):
            tgt = tz.arm_target_from_ratio(cls, r) + rng.normal(size=7) * 0.01
            st, sj = at.tick(tgt), aj.tick(tgt)
            for k in st:
                np.testing.assert_array_equal(st[k], sj[k])
        np.testing.assert_array_equal(tz.grasp_pose_for(cls),
                                      jz.grasp_pose_for(cls))
        assert tz.grasp_distance_for(cls) == jz.grasp_distance_for(cls)
    q = rng.normal(size=6)
    np.testing.assert_array_equal(tz.forward_kinematics(q),
                                  jz.forward_kinematics(q))
