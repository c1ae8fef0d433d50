"""Multi-rank runs of the port on the CPU, for the tests.

`run_ranks(case, world, tmp_path, **args)` starts `world` processes of
this script, each one gloo rank of a group that meets through a
FileStore under `tmp_path` (no TCP port, so that parallel test workers
cannot collide), runs the named case on every rank and returns what each
rank saved (`launch` starts them and returns at once).  Every rank runs
with one thread.  The processes share one deadline (120 s by default): a
rank that has not exited by then is killed, and the run fails with every
rank's output.

Imports only the port (and torch, numpy).  Run as

    python tests/torch_dist_worker.py CASE RANK WORLD STORE OUT_DIR ARGS_JSON
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

HERE = os.path.abspath(__file__)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "gather", "scatter",
               "barrier", "send", "recv", "isend", "irecv")


class Ranks:
    """`world` gloo ranks of this script running `case` (started by
    `launch`); `results()` waits for them and returns what each saved."""

    def __init__(self, case: str, world: int, tmp_path, timeout: float,
                 args: dict):
        self.case, self.world, self.timeout = case, world, timeout
        self.out_dir = os.path.join(str(tmp_path), f"ranks-{case}")
        os.makedirs(self.out_dir, exist_ok=True)
        store = os.path.join(self.out_dir, "store")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
        env["OMP_NUM_THREADS"] = "1"
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for r in range(world):
            with open(self._path(r, "log"), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, HERE, case, str(r), str(world), store,
                     self.out_dir, json.dumps(args)],
                    stdout=log, stderr=subprocess.STDOUT, env=env))

    def _path(self, r, ext):
        return os.path.join(self.out_dir, f"rank{r}.{ext}")

    def results(self):
        hung = False
        try:
            for p in self.procs:
                try:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 0.0))
                except subprocess.TimeoutExpired:
                    hung = True
                    break
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for r in range(self.world):
            with open(self._path(r, "log")) as f:
                texts.append(f.read())
        report = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{t}"
                           for r, (p, t) in enumerate(zip(self.procs, texts)))
        assert not hung, \
            f"ranks of {self.case!r} hung past {self.timeout} s:\n{report}"
        assert all(p.returncode == 0 for p in self.procs), report
        return [torch.load(self._path(r, "pt"), weights_only=False)
                for r in range(self.world)]


def launch(case: str, world: int, tmp_path, timeout: float = 120.0,
           **args) -> Ranks:
    """Start `case` on `world` gloo ranks and return at once, so that the
    caller can compute its single-process reference meanwhile."""
    return Ranks(case, world, tmp_path, timeout, args)


def run_ranks(case: str, world: int, tmp_path, timeout: float = 120.0,
              **args):
    """Run `case` on `world` gloo ranks; returns what each rank saved."""
    return launch(case, world, tmp_path, timeout, **args).results()


@contextlib.contextmanager
def count_collectives():
    """Counts every torch.distributed collective and point-to-point call
    made inside the block, by name: yields the dict of counts."""
    counts = {}
    saved = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue
        saved[name] = fn

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(dist, name, wrapped)
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _dtype(name):
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# the programs the tests hold, run the same way in one process and on ranks
# ---------------------------------------------------------------------------

def tick_inputs(B, horizon, dtype, seed=0, substeps=5):
    """(tt, icr, cfg, state, noise) of test_parallel.py's tick: the tiny
    trajectory, a fleet at rest, (B, substeps, 2) plant noise."""
    from alore_legged_manipulator_tpu_torch.control.nmpc import NmpcConfig
    from alore_legged_manipulator_tpu_torch.parallel.scaling import (
        _tiny_traj, make_fleet)
    tt, icr = _tiny_traj(dtype)
    cfg = NmpcConfig(horizon=horizon)
    state = make_fleet(B, cfg, dtype, device="cpu")[:4]
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(rng.standard_normal((B, substeps, 2)),
                            dtype=dtype)
    return tt, icr, cfg, state, noise


def small_mission(B, dtype=torch.float32):
    """tests/test_parallel.py::test_sharded_mission_fleet_matches_single_
    device's fleet: (items, targets, robots, esdf, icr, cfg)."""
    from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
    from alore_legged_manipulator_tpu_torch.parallel.dryrun import plan_esdf
    from alore_legged_manipulator_tpu_torch.planner.backend import (
        BackendConfig)
    from alore_legged_manipulator_tpu_torch.runtime.mission_fleet import (
        MissionFleetConfig)
    mcfg = MissionFleetConfig(
        backend=BackendConfig(), n_pieces=3, approach_ticks=30,
        grasp_ticks=2, release_ticks=2, push_ticks=40, correction_ticks=0)
    rng = np.random.default_rng(3)
    items = torch.as_tensor(rng.uniform(0.9, 1.1, (B, 1, 2)), dtype=dtype)
    targets = torch.as_tensor(rng.uniform([2.5, 1.1], [2.7, 1.3], (B, 1, 2)),
                              dtype=dtype)
    robots = torch.tensor([0.5, 0.5, 0.0], dtype=dtype).expand(B, 3).clone()
    return (items, targets, robots, plan_esdf("cpu"),
            ICRParams(yr=-0.3, yl=0.3, xv=0.2), mcfg)


def train_cfg(**over):
    """tests/test_train_sharded.py::_cfg() in the port's types."""
    from alore_legged_manipulator_tpu_torch.rl.ppo import PpoConfig
    from alore_legged_manipulator_tpu_torch.rl.runner import TrainConfig
    kw = dict(num_envs=24, steps_per_env=6, iterations=2,
              ppo=PpoConfig(minibatches=2, epochs=1), seed=7)
    kw.update(over)
    return TrainConfig(**kw)


def train_f64(cfg, mesh=None, models=None):
    """`train` at float64 from `init_models(cfg)` (or `models`) on the
    CPU; returns (history, state_dicts, lanes this rank stepped per
    iteration, checkpoints this rank wrote)."""
    from alore_legged_manipulator_tpu_torch.rl import runner as rn
    if models is None:
        models, _ = rn.init_models(cfg, device="cpu")
        models = rn.Models(actor=models.actor.double(),
                           critic=models.critic.double())
    lanes, saved = [], []
    real = rn.collect, rn.save_checkpoint

    def collect(params, env, states, c, draws):
        out = real[0](params, env, states, c, draws)
        lanes.append(out[1].rewards.shape[1])
        return out

    def save_checkpoint(path, state, step):
        saved.append(step)
        return real[1](path, state, step)

    rn.collect, rn.save_checkpoint = collect, save_checkpoint
    try:
        state, hist = rn.train(cfg, mesh=mesh, device="cpu", models=models)
    finally:
        rn.collect, rn.save_checkpoint = real
    sds = {k: {n: v.clone() for n, v in m.state_dict().items()}
           for k, m in state.params.items()}
    return hist, sds, lanes, saved


# ---------------------------------------------------------------------------
# cases: (args, mesh) -> what this rank saves
# ---------------------------------------------------------------------------

def case_mesh_checks(args, mesh):
    """make_mesh's sizes, shard_scenarios' blocks and refusals, the
    gathers and reductions, on every rank."""
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    out = {"rank": mesh.rank, "size": mesh.size}
    try:
        pm.make_mesh(mesh.size + 1, device="cpu")
    except ValueError:
        out["too_big_raises"] = True
    sub = pm.make_mesh(1, device="cpu")          # every rank creates it
    out["sub"] = (sub.rank, sub.size)
    try:
        pm.shard_scenarios(mesh, torch.zeros(2 * mesh.size + 1))
    except ValueError:
        out["indivisible_raises"] = True
    x = torch.arange(6 * mesh.size, dtype=torch.float64).reshape(-1, 3)
    flags = torch.arange(2 * mesh.size) % 3 == 0
    local = pm.shard_scenarios(mesh, {"x": x, "flags": flags})
    out["local"] = local
    out["gathered"] = pm.gather_scenarios(mesh, local)
    out["reduced"] = {op: float(pm.fleet_reduce(mesh, local["x"], op))
                      for op in ("mean", "sum", "max", "min")}
    return out


def case_tick(args, mesh):
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    dtype = _dtype(args["dtype"])
    tt, icr, cfg, state, noise = tick_inputs(args["B"], args["horizon"],
                                             dtype, args.get("seed", 0))
    step = pm.batched_tracking_step(tt, icr, nmpc_cfg=cfg)
    local = pm.shard_scenarios(mesh, (*state, noise))
    with count_collectives() as tick_counts:
        out = step(*local, 0.0)
    with count_collectives() as reduce_counts:
        mean_u = pm.fleet_reduce(mesh, torch.abs(out[3]), "mean")
    full = pm.gather_scenarios(mesh, out[:4])
    return {"out": full, "local_lanes": out[3].shape[0],
            "tick_collectives": tick_counts,
            "reduce_collectives": reduce_counts, "mean_u": float(mean_u)}


def case_backend_cost(args, mesh):
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    from alore_legged_manipulator_tpu_torch.parallel.dryrun import (
        plan_esdf, synth_flats)
    from alore_legged_manipulator_tpu_torch.planner import backend as bk
    B = args["B"]
    dtype = torch.float64
    flats = synth_flats(torch.linspace(1.5, 2.5, B, dtype=dtype), dtype)
    (local,) = pm.shard_scenarios(mesh, (flats,))
    c, g = backend_cost_grad(bk, local, plan_esdf("cpu", dtype))
    return {"cost": pm.gather_scenarios(mesh, c),
            "grad": pm.gather_scenarios(mesh, g)}


def backend_cost_grad(bk, flats, esdf):
    """One stage-2 cost and its gradient per lane at the lanes' start
    point, as test_parallel.py's eval_fleet forms them."""
    dtype = flats.start_state.dtype
    B = flats.start_state.shape[0]
    bcfg = bk.BackendConfig()
    tau = bk.real_to_virtual_time(
        flats.init_piece_time[:, None].expand(B, 3).to(dtype))
    x = bk.pack_vars(flats.inner_yaw_s, flats.final_state[:, 1, 0], tau)
    x = x.detach().requires_grad_(True)
    lam = torch.zeros((B, 2), dtype=dtype)
    rho = torch.ones((B, 2), dtype=dtype)
    safe = torch.full((B,), bcfg.safe_dis, dtype=dtype)
    c = bk.stage2_cost(x, flats, esdf, safe, lam, rho, bcfg)
    (g,) = torch.autograd.grad(c.sum(), x)
    return c.detach(), g


def case_plan(args, mesh):
    from alore_legged_manipulator_tpu_torch.parallel import dryrun, mesh as pm
    (times, coll, err), _, _ = dryrun.plan_program(mesh, args["per_rank"])
    return {"times": pm.gather_scenarios(mesh, times),
            "collision": pm.gather_scenarios(mesh, coll),
            "err": pm.gather_scenarios(mesh, err)}


def case_mission(args, mesh):
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    from alore_legged_manipulator_tpu_torch.runtime.mission_fleet import (
        run_mission)
    items, targets, robots, esdf, icr, mcfg = small_mission(args["B"])
    items, targets, robots = pm.shard_scenarios(mesh, (items, targets, robots))
    res = run_mission(items, targets, robots, esdf, icr, mcfg, device="cpu")
    return pm.gather_scenarios(
        mesh, {"object_err": res.object_err, "delivered": res.delivered,
               "track_err_max": res.track_err_max})


def case_scaling(args, mesh):
    from alore_legged_manipulator_tpu_torch.parallel.scaling import (
        measure_scaling)
    return {"points": measure_scaling(args["sizes"], batch_per_device=4,
                                      horizon=8, iters=2, device="cpu")}


def case_cross_rank_sum(args, mesh):
    """tests/distributed_worker.py's checks on the port: a cross-rank sum
    and mean, and the N=50 tracking tick over the ranks with a fleet
    reduction of its commands."""
    from alore_legged_manipulator_tpu_torch.parallel import dryrun
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    b = 8
    local = torch.arange(b, dtype=torch.float32) + 1000.0 * mesh.rank
    ones = pm.fleet_reduce(mesh, torch.sin(local) ** 2 + torch.cos(local) ** 2,
                           "sum")
    x_sum = pm.fleet_reduce(mesh, local, "sum")
    _, mean_cmd = dryrun.tick_program(mesh, batch=8)
    return {"ones": float(ones), "x_sum": float(x_sum),
            "tick_fleet": 8 * mesh.size, "mean_cmd": mean_cmd}


def case_dryrun(args, mesh):
    from alore_legged_manipulator_tpu_torch.parallel.dryrun import (
        dryrun_multichip)
    return dryrun_multichip(mesh, **args)


def case_train_check(args, mesh):
    from alore_legged_manipulator_tpu_torch.parallel.dryrun import (
        train_check)
    return train_check(mesh, args["iterations"], args["num_envs"])


def case_train(args, mesh):
    cfg = train_cfg(**args.get("over", {}))
    hist, sds, lanes, saved = train_f64(cfg, mesh)
    return {"hist": hist, "params": sds, "lanes": lanes, "saved": saved}


def case_train_one_rank(args, mesh):
    """The same run in this process on the one-rank mesh and without
    one."""
    cfg = train_cfg(**args.get("over", {}))
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        hist, sds, lanes, _ = train_f64(cfg, m)
        out[name] = {"hist": hist, "params": sds, "lanes": lanes}
    return out


def case_train_injected(args, mesh):
    """`train` on a mesh with the JAX package's draws (saved by the test
    in the port's types) in place of the generators': initial states,
    per step the global noise and fresh states of every lane, per
    iteration the permutations."""
    from alore_legged_manipulator_tpu_torch.parallel import mesh as pm
    from alore_legged_manipulator_tpu_torch.rl import ppo as pp
    from alore_legged_manipulator_tpu_torch.rl import runner as rn
    d = torch.load(args["draws"], weights_only=False)
    cfg = train_cfg(**args.get("over", {}))
    models = rn.load_models(d["params"], device="cpu", dtype=torch.float64)
    step = iter(range(10 ** 6))
    perms = iter(d["perms"])

    class Injected(rn.ShardedDraws):
        def noise(self, k, mean):
            self.i = next(step)
            full = d["noise"][self.i]
            return full[pm.block(self.mesh, full.shape[0])]

        def reset_done(self, k, states, done):
            idx = torch.nonzero(done)[:, 0]
            if idx.numel() == 0:
                return states
            g = idx + self.mesh.rank * done.shape[0]
            fresh = rn._tree_map(lambda x: x[g], d["fresh"][self.i])
            return rn.put_lanes(states, idx, fresh)

    real = (rn.ShardedDraws, rn.make_env, pp.draw_permutations)

    def make_env(c, dtype, dev):
        env = real[1](c, dtype, dev)
        return rn.EnvFns(lambda gen, n: d["init"], env.step, env.push_of)

    rn.ShardedDraws, rn.make_env = Injected, make_env
    pp.draw_permutations = lambda n, epochs, gen: next(perms)
    try:
        hist, sds, lanes, _ = train_f64(cfg, mesh, models)
    finally:
        rn.ShardedDraws, rn.make_env, pp.draw_permutations = real
    return {"hist": hist, "params": sds, "lanes": lanes}


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def main():
    case, rank, world, store, out_dir, args = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from alore_legged_manipulator_tpu_torch.parallel.mesh import (
            make_mesh)
        mesh = make_mesh(world, device="cpu")
        out = CASES[case](json.loads(args), mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
