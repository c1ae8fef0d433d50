"""Reference yaml profile loader with readParam hard-fail semantics
(port of config/profiles.py: the same builders, returning the port's
configs).

The reference stack configures every node from per-package yaml
profiles loaded onto the ROS param server (plan_manager/config/car3ms.yaml,
back_end/config/global_planning3ms.yaml, front_end/config/jps3ms.yaml,
nmpc_controller/config/mpc3ms.yaml, mpc_controller/config/mpc3ms.yaml,
utils/plan_env/config/mapsim.yaml, wired in
plan_manager/launch/planner_sim.launch:49-121).  Its `readParam` helper
aborts the node when a key is missing (back_end/include/back_end/
optimizer.h:278-297); this module reproduces that contract: every key a
builder consumes must be present in the profile dict or a
`ProfileKeyError` is raised.

The builders map the yaml keys onto the port's typed NamedTuple
configs, whose defaults equal the JAX package's.  PyYAML is imported only
inside `load_profile`, so importing the port never needs it.
"""
from __future__ import annotations

import os
from typing import Mapping

from ..control.ltv_mpc import LtvMpcConfig
from ..control.nmpc import NmpcConfig
from ..planner.backend import (AlmConfig, BackendConfig, BackendWeights,
                               PathWeights)
from ..planner.frontend import FrontendConfig
from ..world.lidar import OccupancyConfig


class ProfileKeyError(KeyError):
    """A profile is missing a key a builder needs (readParam hard-fail)."""

    def __init__(self, key: str, source: str):
        super().__init__(f"missing required profile key {key!r} (from "
                         f"{source}) -- the reference's readParam aborts "
                         f"the node on this (optimizer.h:278-297)")


def load_profile(path: str) -> dict:
    """Load one flat reference yaml profile into a dict.

    The reference profiles are flat scalar/list/one-level-nested yaml;
    PyYAML handles them directly.  Missing file raises (the launch file
    would fail the same way).
    """
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f)
    if not isinstance(data, Mapping):
        raise ValueError(f"profile {path} did not parse to a mapping")
    return dict(data)


def reference_profile_paths(root: str) -> dict:
    """Paths of the profiles planner_sim.launch composes, under `root`,
    a checkout of the reference planner (planning_ddr_opt)."""
    return {
        "car": os.path.join(root, "plan_manager/config/car3ms.yaml"),
        "global_planning": os.path.join(
            root, "back_end/config/global_planning3ms.yaml"),
        "jps": os.path.join(root, "front_end/config/jps3ms.yaml"),
        "nmpc": os.path.join(root, "nmpc_controller/config/mpc3ms.yaml"),
        "ltv": os.path.join(root, "mpc_controller/config/mpc3ms.yaml"),
        "mapsim": os.path.join(root, "utils/plan_env/config/mapsim.yaml"),
    }


def _get(profile: Mapping, key: str, source: str):
    if key not in profile:
        raise ProfileKeyError(key, source)
    return profile[key]


def _nested(profile: Mapping, group: str, key: str, source: str):
    sub = _get(profile, group, source)
    if not isinstance(sub, Mapping) or key not in sub:
        raise ProfileKeyError(f"{group}/{key}", source)
    return sub[key]


def backend_config_from_profiles(car: Mapping, glob: Mapping,
                                 **overrides) -> BackendConfig:
    """BackendConfig from car3ms.yaml + global_planning3ms.yaml.

    Solver-shape knobs with no yaml counterpart (mem_size ring length,
    hard iteration caps, flat_bfgs, max_outer) keep this framework's
    defaults; every numerical weight/limit/schedule comes from the yaml.
    """
    g = lambda k: _get(glob, k, "global_planning3ms.yaml")  # noqa: E731
    c = lambda k: _get(car, k, "car3ms.yaml")  # noqa: E731
    gl = lambda grp, k: _nested(glob, grp, k, "global_planning3ms.yaml")  # noqa: E731

    checkpoint_flat = c("checkpoint")
    checkpoints = tuple(
        (float(checkpoint_flat[i]), float(checkpoint_flat[i + 1]))
        for i in range(0, len(checkpoint_flat), 2))

    weights = BackendWeights(
        time_weight=float(gl("penaltyWeights", "time_weight")),
        acc_weight=float(gl("penaltyWeights", "acc_weight")),
        domega_weight=float(gl("penaltyWeights", "domega_weight")),
        collision_weight=float(gl("penaltyWeights", "collision_weight")),
        moment_weight=float(gl("penaltyWeights", "moment_weight")),
        mean_time_weight=float(gl("penaltyWeights", "mean_time_weight")),
        cen_acc_weight=float(gl("penaltyWeights", "cen_acc_weight")))
    path_weights = PathWeights(
        time_weight=float(gl("PathpenaltyWeights", "time_weight")),
        bigpath_weight=float(gl("PathpenaltyWeights", "bigpath_sdf_weight")),
        mean_time_weight=float(gl("PathpenaltyWeights", "mean_time_weight")),
        moment_weight=float(gl("PathpenaltyWeights", "moment_weight")),
        acc_weight=float(gl("PathpenaltyWeights", "acc_weight")),
        domega_weight=float(gl("PathpenaltyWeights", "domega_weight")))

    defaults = BackendConfig()
    alm = AlmConfig(
        lambda0=tuple(float(v) for v in g("EqualLambda")),
        rho0=tuple(float(v) for v in g("EqualRho")),
        rho_max=tuple(float(v) for v in g("EqualRhoMax")),
        gamma=tuple(float(v) for v in g("EqualGamma")),
        tolerance=float(g("EqualTolerance")[0]),
        max_outer=defaults.alm.max_outer)
    cut_alm = AlmConfig(
        lambda0=tuple(float(v) for v in g("CutEqualLambda")),
        rho0=tuple(float(v) for v in g("CutEqualRho")),
        rho_max=tuple(float(v) for v in g("CutEqualRhoMax")),
        gamma=tuple(float(v) for v in g("CutEqualGamma")),
        tolerance=float(g("CutEqualTolerance")[0]),
        max_outer=defaults.cut_alm.max_outer)
    lbfgs = defaults.lbfgs._replace(
        past=int(gl("lbfgs_params", "past")),
        g_epsilon=float(gl("lbfgs_params", "g_epsilon")),
        min_step=float(gl("lbfgs_params", "min_step")),
        delta=float(gl("lbfgs_params", "delta")))
    path_lbfgs = defaults.path_lbfgs._replace(
        past=int(gl("path_lbfgs_params", "past")),
        g_epsilon=float(gl("path_lbfgs_params", "g_epsilon")),
        min_step=float(gl("path_lbfgs_params", "min_step")),
        delta=float(gl("path_lbfgs_params", "delta")))

    cfg = BackendConfig(
        max_vel=float(c("max_vel")),
        min_vel=float(c("min_vel")),
        max_acc=float(c("max_acc")),
        max_omega=float(c("max_omega")),
        max_domega=float(c("max_domega")),
        max_cen_acc=float(c("max_centripetal_acc")),
        directly_constrain_v_omega=bool(
            c("if_directly_constrain_v_omega")),
        smooth_eps=float(g("smoothingFactor")),
        sparse_resolution=int(g("sparseResolution")),
        safe_dis=float(g("safeDis")),
        final_min_safe_dis=float(g("finalMinSafeDis")),
        final_check_resolution=int(g("finalSafeDisCheckNum")),
        max_collision_replans=int(g("safeReplanMaxTime")),
        checkpoints=checkpoints,
        energy_weights=tuple(float(v) for v in g("energyWeights")),
        weights=weights,
        path_weights=path_weights,
        alm=alm,
        cut_alm=cut_alm,
        lbfgs=lbfgs,
        path_lbfgs=path_lbfgs,
        shot_path_past=int(gl("path_lbfgs_params", "shot_path_past")),
        shot_path_horizon=float(
            gl("path_lbfgs_params", "shot_path_horizon")))
    return cfg._replace(**overrides) if overrides else cfg


def frontend_config_from_profiles(jps: Mapping, car: Mapping,
                                  glob: Mapping,
                                  **overrides) -> FrontendConfig:
    """FrontendConfig from jps3ms.yaml (+ car3ms limits + global
    timeResolution/mintrajNum/trajCutLength, which the reference wires
    into the front end: SURVEY.md 'actually used in front_end')."""
    j = lambda k: _get(jps, k, "jps3ms.yaml")  # noqa: E731
    cfg = FrontendConfig(
        safe_dis=float(j("jps_safe_dis")),
        distance_weight=float(j("jps_distance_weight")),
        yaw_weight=float(j("jps_yaw_weight")),
        traj_cut_length=float(
            _get(glob, "trajCutLength", "global_planning3ms.yaml")),
        max_vel=float(_get(car, "max_vel", "car3ms.yaml")),
        max_acc=float(_get(car, "max_acc", "car3ms.yaml")),
        sample_time=float(
            _get(glob, "timeResolution", "global_planning3ms.yaml")),
        min_traj_num=int(
            _get(glob, "mintrajNum", "global_planning3ms.yaml")))
    return cfg._replace(**overrides) if overrides else cfg


def nmpc_config_from_profile(mpc: Mapping, **overrides) -> NmpcConfig:
    """NmpcConfig from nmpc_controller/config/mpc3ms.yaml.

    Horizon/dt/bounds are compiled into the reference's ACADO codegen
    (UAV_CAR_model.cpp:53-56, 97-101), not yaml -- they stay this
    framework's (identical) defaults; the yaml supplies the runtime
    weights and the delay compensation depth (mpc.cpp:72-101 reads
    matrix_q/matrix_r/delay_num)."""
    m = lambda k: _get(mpc, k, "nmpc mpc3ms.yaml")  # noqa: E731
    cfg = NmpcConfig(
        q_diag=tuple(float(v) for v in m("matrix_q")),
        r_diag=tuple(float(v) for v in m("matrix_r")),
        delay_num=int(m("delay_num")))
    return cfg._replace(**overrides) if overrides else cfg


def ltv_config_from_profiles(mpc: Mapping, car: Mapping,
                             **overrides) -> LtvMpcConfig:
    """LtvMpcConfig from mpc_controller/config/mpc3ms.yaml + car3ms
    limits (the node reads /mpc/max_vel etc. from the same param tree,
    mpc_controller/src/mpc.cpp:14-20)."""
    m = lambda k: _get(mpc, k, "mpc_controller mpc3ms.yaml")  # noqa: E731
    c = lambda k: _get(car, k, "car3ms.yaml")  # noqa: E731
    q = [float(v) for v in m("matrix_q")]
    cfg = LtvMpcConfig(
        horizon=int(m("predict_steps")),
        dt=float(m("dt")),
        q_diag=tuple(q),
        r_diag=tuple(float(v) for v in m("matrix_r")),
        rd_diag=tuple(float(v) for v in m("matrix_rd")),
        max_speed=float(c("max_vel")),
        min_speed=float(c("min_vel")),
        max_omega=float(c("max_omega")),
        max_acc=float(c("max_acc")),
        max_domega=float(c("max_domega")),
        delay_num=int(m("delay_num")))
    return cfg._replace(**overrides) if overrides else cfg


def occupancy_config_from_profile(mapsim: Mapping,
                                  **overrides) -> OccupancyConfig:
    """OccupancyConfig log-odds parameters from mapsim.yaml
    (sdf_map.h:167-184)."""
    m = lambda k: _get(mapsim, k, "mapsim.yaml")  # noqa: E731
    cfg = OccupancyConfig(
        p_hit=float(m("p_hit")),
        p_miss=float(m("p_miss")),
        p_min=float(m("p_min")),
        p_max=float(m("p_max")),
        p_occ=float(m("p_occ")))
    return cfg._replace(**overrides) if overrides else cfg
