"""Scenario-fleet data parallelism on `torch.distributed` (port of
parallel/mesh.py).

The reference stack is a single-machine ROS graph with no data or model
parallelism (SURVEY.md section 2.5).  The scaling axis is the *scenario
fleet*: thousands of independent (object x start pose x corridor)
closed-loop scenarios, split over ranks:

  * axis "scenario": every field of the batched state carries a leading
    scenario dimension; each rank holds one contiguous block of it, the
    block `NamedSharding(mesh, P(axis))` gives that device in the JAX
    package.  No cross-scenario communication is needed in the steady
    state.
  * what JAX does implicitly on a sharded global array is explicit here:
    `gather_scenarios` reads the whole fleet (an all-gather),
    `fleet_reduce` is the psum that `jnp.mean` over a sharded array
    lowers to (one all-reduce).

A `Mesh` is one rank's view: its process group, rank, size and device.
On the card the group is NCCL, one process per card; the tests run gloo
ranks on the CPU.  `make_mesh` initializes a one-rank group itself when
none exists, so the single-card path runs the same code.
"""
from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..control.ltv_mpc import LtvMpcConfig, ltv_mpc_tick
from ..control.nmpc import NmpcConfig, nmpc_rti_step
from ..control.tracked_traj import TrackedTraj, ltv_ref_points, ref_points
from ..core.dynamics import ICRParams
from ..estimator.icr_ekf import EkfConfig, ekf_predict, ekf_update
from ..utils.precision import resolve_device
from ..utils.profiling import span
from ..world.plant import (PlantConfig, plant_step, plant_step_mpc_tick,
                           plant_wheel_feedback)


class Mesh(NamedTuple):
    """One rank's view of a one-axis device mesh.  `rank` is -1 on a rank
    that is not a member of the group (a sub-mesh of the first ranks)."""
    axis: str
    group: object          # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, axis: str = "scenario",
              device=None) -> Mesh:
    """The mesh over the first `n_devices` ranks (None: all of them).

    With a default process group, its ranks are the mesh; `n_devices`
    below its size makes a sub-mesh of the first ranks, a group that
    every rank must create (call `make_mesh` on every rank), and more
    raises.  With no group and `n_devices` None or 1, a one-rank group
    is initialized through a FileStore in a temporary directory: NCCL on
    a CUDA device, gloo only for `device="cpu"`.  A failing NCCL init
    raises; there is no fallback to gloo or to no group.  device: None
    is the card (cuda:<rank mod cards>)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"a {n_devices}-rank mesh needs a process group of "
                f"{n_devices} ranks: call torch.distributed."
                "init_process_group on each rank first")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        store = dist.FileStore(
            os.path.join(tempfile.mkdtemp(prefix="alore-mesh-"), "store"), 1)
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = _rank_device(dev, 0)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                **kw)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world or n < 1:
        raise ValueError(f"a {n}-device mesh on a {world}-rank group")
    group = dist.group.WORLD if n == world else dist.new_group(
        ranks=list(range(n)))
    rank = dist.get_rank()
    mesh = Mesh(axis=axis, group=group, rank=rank if rank < n else -1,
                size=n, device=_rank_device(dev, rank))
    if dev.type == "cuda" and mesh.rank >= 0:
        # the first collective opens the communicator: a failing NCCL
        # init raises here and not at the first real reduction
        torch.cuda.set_device(mesh.device)
        probe = torch.ones(1, device=mesh.device)
        dist.all_reduce(probe, group=group)
        if int(probe.item()) != n:
            raise RuntimeError(f"mesh probe summed to {probe.item()}, "
                               f"not {n}")
    return mesh


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """`fn` on every tensor (numpy arrays become tensors first) of a tree
    of tuples, NamedTuples, lists and dicts; other leaves unchanged."""
    if isinstance(tree, np.ndarray):
        tree = torch.as_tensor(tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of `n` scenarios."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over "
                         f"{mesh.size} ranks")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_scenarios(mesh: Mesh, tree):
    """This rank's block of the leading axis of every tensor in `tree`,
    on `mesh.device`.  A batch that the mesh size does not divide
    raises ValueError."""
    return tree_map(lambda x: x[block(mesh, x.shape[0])].to(mesh.device),
                    tree)


def gather_scenarios(mesh: Mesh, tree):
    """The whole fleet from every rank's block (one all-gather per
    tensor), on this rank's device: reading a sharded global array."""
    def gather(x):
        if mesh.size == 1:
            return x
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire.contiguous(), group=mesh.group)
        return torch.cat(parts).to(x.dtype)
    return tree_map(gather, tree)


def fleet_reduce(mesh: Mesh, x, op: str = "mean"):
    """A fleet-wide reduction of every element of this rank's `x` with
    every other rank's, in one all-reduce: "mean", "sum", "max" or
    "min".  The 0-d result is the same on every rank."""
    if op == "mean":
        buf = torch.stack([x.sum(), torch.tensor(float(x.numel()),
                                                 dtype=x.dtype,
                                                 device=x.device)])
        dist.all_reduce(buf, group=mesh.group)
        return buf[0] / buf[1]
    local = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[op](x)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(local, op=red, group=mesh.group)
    return local


# ---------------------------------------------------------------------------
# the sharded closed-loop tick
# ---------------------------------------------------------------------------

def _lanes(tt: TrackedTraj, n: int, dev) -> TrackedTraj:
    """One trajectory (lane axis 1) seen by `n` lanes on `dev`."""
    return tree_map(lambda x: x.to(dev).expand(n, *x.shape[1:]), tt)


def batched_tracking_step(tt: TrackedTraj, true_icr: ICRParams,
                          nmpc_cfg: NmpcConfig = NmpcConfig(),
                          ekf_cfg: EkfConfig = EkfConfig(),
                          plant_cfg: PlantConfig = PlantConfig(),
                          substeps: int = 5):
    """One full closed-loop control tick for a scenario batch.

    tt: one tracked trajectory (lane axis 1), shared by every scenario.
    Returns fn(plants, ekfs, carries, u_prevs, noise, t) -> (plants,
    ekfs, carries, u_cmds, noise), every state with a leading scenario
    axis.  `noise` is a torch.Generator on the lanes' device, the
    (B, substeps, 2) standard normals of the plant's (v, omega) noise
    per substep (lanes leading, so that `shard_scenarios` splits them
    like the state), or None for a noise-free plant.  The tick touches
    only its own lanes: it issues no collective.
    """
    dt = nmpc_cfg.dt

    def fn(plants, ekfs, carries, u_prevs, noise, t):
        dtype, dev = plants.xytheta.dtype, plants.xytheta.device
        B = plants.xytheta.shape[0]
        with span("tick", lanes=B):
            lanes = _lanes(tt, B, dev)
            t = float(torch.as_tensor(t, dtype=dtype))
            u_prevs = torch.as_tensor(u_prevs).to(dtype)
            est_pose = ekfs.x[:, :3]
            icr_est = ICRParams(yr=ekfs.x[:, 3], yl=ekfs.x[:, 4],
                                xv=ekfs.x[:, 5])
            with span("ref"):
                ref_x, ref_u = ref_points(lanes, t, nmpc_cfg.horizon, dt,
                                          est_pose[:, 2])
            carries, u_cmd, _, _ = nmpc_rti_step(carries, est_pose, ref_x,
                                                 ref_u, icr_est, nmpc_cfg)
            u_applied = torch.stack([u_prevs[:, 1], u_prevs[:, 0]], dim=1)
            with span("ekf.predict"):
                ekfs = ekf_predict(ekfs, u_applied, dt, ekf_cfg)
            gen = noise if isinstance(noise, torch.Generator) else None
            with span("plant"):
                for j in range(substeps):
                    draw = (noise[:, j] if isinstance(noise, torch.Tensor)
                            else None)
                    plants = plant_step(plants, u_applied, true_icr,
                                        dt / substeps, plant_cfg,
                                        generator=gen, noise=draw)
            with span("ekf.update"):
                ekfs = ekf_update(ekfs, plants.xytheta, ekf_cfg)
        return plants, ekfs, carries, u_cmd, noise

    return fn


def batched_ltv_tracking_step(tt: TrackedTraj, true_icr: ICRParams,
                              ltv_cfg: LtvMpcConfig = LtvMpcConfig(),
                              ekf_cfg: EkfConfig = EkfConfig(),
                              plant_cfg: PlantConfig = PlantConfig(),
                              substeps: int = 5):
    """One closed-loop tick of the LTV-MPC stack for a scenario batch:
    the mpc_controller node on the ICR-EKF estimate, the simulator's
    (v, omega) CarState path (planner_sim.launch, simulator.h:203-262).

    tt: one tracked trajectory (lane axis 1), shared by every scenario.
    Returns fn(plants, ekfs, carries, u_prevs, noise, t) -> (plants,
    ekfs, carries, u_cmds, noise), every state with a leading scenario
    axis, as `batched_tracking_step` does.  In order: the references at
    t on the estimate's yaw, `ltv_mpc_tick` on the estimated pose, the
    EKF predict on the plant's wheel feedback through the true ICR (the
    last tick's command, decayed), the plant adopting the new (v, omega)
    command at once and decaying it over `substeps`, the EKF update on
    the plant's pose plus `noise`, the (B, 3) pose measurement error
    (None: exact).  `u_prevs`, last tick's command, is not read: the
    carry's delay buffer holds it.  The tick reads nothing back to the
    host and issues no collective.
    """
    dt = ltv_cfg.dt

    def fn(plants, ekfs, carries, u_prevs, noise, t):
        dtype, dev = plants.xytheta.dtype, plants.xytheta.device
        B = plants.xytheta.shape[0]
        with span("tick", lanes=B):
            lanes = _lanes(tt, B, dev)
            t = float(torch.as_tensor(t, dtype=dtype))
            est_pose = ekfs.x[:, :3]
            with span("ref"):
                xref, dref = ltv_ref_points(lanes, t, ltv_cfg.horizon, dt,
                                            est_pose[:, 2])
            carries, u_cmd = ltv_mpc_tick(carries, est_pose, xref, dref,
                                          ltv_cfg)
            with span("ekf.predict"):
                ekfs = ekf_predict(ekfs, plant_wheel_feedback(plants,
                                                              true_icr),
                                   dt, ekf_cfg)
            with span("plant"):
                plants = plant_step_mpc_tick(plants, u_cmd[:, 0],
                                             u_cmd[:, 1], plant_cfg,
                                             substeps, dt / substeps)
            with span("ekf.update"):
                obs = plants.xytheta if noise is None \
                    else plants.xytheta + noise
                ekfs = ekf_update(ekfs, obs, ekf_cfg)
        return plants, ekfs, carries, u_cmd, noise

    return fn
