"""Port parity: the reference yaml profile builders (`config/profiles.py`).

The reference profiles are not in the repository, so the test writes
profile dicts itself: the JAX package's config defaults mapped back onto
the yaml keys, every number scaled so that a transposed key would show.
The port's builders must build the same configs as JAX's from them
(field by field, nested configs included), overrides must apply, a
missing key must raise the port's `ProfileKeyError` (readParam's hard
fail), `load_profile` must read a yaml file written to `tmp_path` (it
skips without PyYAML, which the port imports only there), and the paths
of `reference_profile_paths` must be JAX's under the same root.
"""
import dataclasses

import pytest

from alore_legged_manipulator_tpu import config as jcfg
from alore_legged_manipulator_tpu.control.nmpc import NmpcConfig
from alore_legged_manipulator_tpu.control.ltv_mpc import LtvMpcConfig
from alore_legged_manipulator_tpu.planner.backend import BackendConfig
from alore_legged_manipulator_tpu.planner.frontend import FrontendConfig
from alore_legged_manipulator_tpu.world.lidar import OccupancyConfig
from alore_legged_manipulator_tpu_torch import config as tcfg
from alore_legged_manipulator_tpu_torch.convert import port_class


def _profiles(scale=1.25):
    """car, global_planning, jps, nmpc, ltv and mapsim profiles."""
    b, f = BackendConfig(), FrontendConfig()
    n, lt, o = NmpcConfig(), LtvMpcConfig(), OccupancyConfig()

    def s(v):
        return [x * scale for x in v] if isinstance(v, tuple) else v * scale

    def lb(p, extra=()):
        return {"past": p.past + 1, "g_epsilon": s(p.g_epsilon),
                "min_step": s(p.min_step), "delta": s(p.delta),
                **dict(extra)}
    car = {"max_vel": s(b.max_vel), "min_vel": s(b.min_vel),
           "max_acc": s(b.max_acc), "max_omega": s(b.max_omega),
           "max_domega": s(b.max_domega),
           "max_centripetal_acc": s(b.max_cen_acc),
           "if_directly_constrain_v_omega": not b.directly_constrain_v_omega,
           "checkpoint": [x * scale for pt in b.checkpoints for x in pt]}
    w, pw = b.weights, b.path_weights
    glob = {
        "penaltyWeights": {k: s(getattr(w, k)) for k in w._fields},
        "PathpenaltyWeights": {
            "time_weight": s(pw.time_weight),
            "bigpath_sdf_weight": s(pw.bigpath_weight),
            "mean_time_weight": s(pw.mean_time_weight),
            "moment_weight": s(pw.moment_weight),
            "acc_weight": s(pw.acc_weight),
            "domega_weight": s(pw.domega_weight)},
        "lbfgs_params": lb(b.lbfgs),
        "path_lbfgs_params": lb(b.path_lbfgs, {
            "shot_path_past": b.shot_path_past + 1,
            "shot_path_horizon": s(b.shot_path_horizon)}),
        "smoothingFactor": s(b.smooth_eps),
        "sparseResolution": b.sparse_resolution + 2,
        "safeDis": s(b.safe_dis),
        "finalMinSafeDis": s(b.final_min_safe_dis),
        "finalSafeDisCheckNum": b.final_check_resolution + 1,
        "safeReplanMaxTime": b.max_collision_replans + 1,
        "energyWeights": s(b.energy_weights),
        "trajCutLength": s(f.traj_cut_length),
        "timeResolution": s(f.sample_time),
        "mintrajNum": f.min_traj_num + 1}
    for pre, a in (("", b.alm), ("Cut", b.cut_alm)):
        glob.update({f"{pre}EqualLambda": s(a.lambda0),
                     f"{pre}EqualRho": s(a.rho0),
                     f"{pre}EqualRhoMax": s(a.rho_max),
                     f"{pre}EqualGamma": s(a.gamma),
                     f"{pre}EqualTolerance": [s(a.tolerance)]})
    jps = {"jps_safe_dis": s(f.safe_dis),
           "jps_distance_weight": s(f.distance_weight),
           "jps_yaw_weight": s(f.yaw_weight)}
    nmpc = {"matrix_q": s(n.q_diag), "matrix_r": s(n.r_diag),
            "delay_num": n.delay_num + 1}
    ltv = {"predict_steps": lt.horizon + 5, "dt": s(lt.dt),
           "matrix_q": s(lt.q_diag), "matrix_r": s(lt.r_diag),
           "matrix_rd": s(lt.rd_diag), "delay_num": lt.delay_num + 1}
    mapsim = {k: getattr(o, k) * 0.99 for k in
              ("p_hit", "p_miss", "p_min", "p_max", "p_occ")}
    return dict(car=car, glob=glob, jps=jps, nmpc=nmpc, ltv=ltv,
                mapsim=mapsim)


def _same(jax_obj, port_obj, where):
    assert type(port_obj).__name__ == type(jax_obj).__name__, where
    if hasattr(jax_obj, "_fields"):
        assert tuple(jax_obj._fields) == tuple(port_obj._fields), where
        for f in jax_obj._fields:
            _same(getattr(jax_obj, f), getattr(port_obj, f), f"{where}.{f}")
    else:
        assert jax_obj == port_obj, f"{where}: {jax_obj!r} != {port_obj!r}"


BUILDERS = {
    "backend": (lambda m, p, **kw: m.backend_config_from_profiles(
        p["car"], p["glob"], **kw), dict(standard_diff=True)),
    "frontend": (lambda m, p, **kw: m.frontend_config_from_profiles(
        p["jps"], p["car"], p["glob"], **kw),
        dict(piece_buckets=(4, 8, 16, 24))),
    "nmpc": (lambda m, p, **kw: m.nmpc_config_from_profile(p["nmpc"], **kw),
             dict(horizon=30)),
    "ltv": (lambda m, p, **kw: m.ltv_config_from_profiles(
        p["ltv"], p["car"], **kw), dict(admm_iters=40)),
    "occupancy": (lambda m, p, **kw: m.occupancy_config_from_profile(
        p["mapsim"], **kw), dict(max_trace_cells=90)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_match_jax(name):
    build, overrides = BUILDERS[name]
    prof = _profiles()
    ref, got = build(jcfg, prof), build(tcfg, prof)
    assert type(got) is port_class(type(ref).__name__)
    _same(ref, got, name)
    # the scaled profile really moved the config off its defaults
    assert got != type(got)()
    ref_o, got_o = build(jcfg, prof, **overrides), build(tcfg, prof,
                                                         **overrides)
    _same(ref_o, got_o, name)
    for k, v in overrides.items():
        assert getattr(got_o, k) == v


@pytest.mark.parametrize("profile,key,name", [
    ("car", "max_vel", "backend"), ("glob", "penaltyWeights", "backend"),
    ("nmpc", "matrix_q", "nmpc"), ("ltv", "matrix_rd", "ltv"),
    ("mapsim", "p_occ", "occupancy"), ("jps", "jps_yaw_weight", "frontend")])
def test_missing_key_hard_fails(profile, key, name):
    prof = _profiles()
    del prof[profile][key]
    with pytest.raises(tcfg.ProfileKeyError, match=key):
        BUILDERS[name][0](tcfg, prof)
    with pytest.raises(jcfg.ProfileKeyError, match=key):
        BUILDERS[name][0](jcfg, prof)


def test_missing_nested_key_hard_fails():
    prof = _profiles()
    del prof["glob"]["lbfgs_params"]["delta"]
    with pytest.raises(tcfg.ProfileKeyError, match="lbfgs_params/delta"):
        tcfg.backend_config_from_profiles(prof["car"], prof["glob"])


def test_load_profile_reads_yaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    prof = _profiles()
    path = tmp_path / "global_planning3ms.yaml"
    path.write_text(yaml.safe_dump(prof["glob"]))
    loaded = tcfg.load_profile(str(path))
    assert loaded == jcfg.load_profile(str(path)) == prof["glob"]
    (tmp_path / "list.yaml").write_text("- 1\n- 2\n")
    with pytest.raises(ValueError):
        tcfg.load_profile(str(tmp_path / "list.yaml"))
    with pytest.raises(OSError):
        tcfg.load_profile(str(tmp_path / "missing.yaml"))


def test_reference_paths_match_jax(tmp_path):
    assert tcfg.reference_profile_paths(str(tmp_path)) == \
        jcfg.reference_profile_paths(str(tmp_path))


def test_port_builds_from_defaults_like_the_e2e_tests():
    """The port's planner-simulation configs (tests/test_e2e_parity.py's
    overrides on the defaults) equal JAX's."""
    from alore_legged_manipulator_tpu.mission.plan_manager import (
        PlanManagerConfig)
    from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
    ref = PlanManagerConfig(
        replan_period=0.08, max_replan_time=0.05,
        backend=BackendConfig(standard_diff=True),
        frontend=FrontendConfig(piece_buckets=(4, 8, 16, 24)))
    got = from_jax_numpy(ref)
    for f in dataclasses.fields(ref):
        if f.name != "dtype":
            _same(getattr(ref, f.name), getattr(got, f.name), f.name)
