"""Readers of the compiled reference's goldens (tests/golden/), numpy
only: they import neither JAX nor the JAX package, so that both the
port's CPU tests and chip_smoke.py on the card read the goldens through
them.  Each returns what tests/test_*_parity.py's own reader returns,
as plain numpy arrays and floats.

* `minco_case(case)`: the back end's MINCO cases (head, tail, inner,
  times, energy weights, the oracle's output) and `minco_ref_coeffs`.
* `backend_scenario(name)`, `backend_xs(name)`, `backend_cost(name)`,
  `backend_solve(name)`: the back end's FlatTraj scenarios with their
  ESDF grids, the decision vectors and the cost / solve outputs (read
  by the oracle's own numpy reader, tests/golden/backend_oracle/
  oracle_io.py).
* `trajanal_case(name)`, `ekf_case(name)`, `esdf_case(kind)`,
  `plant_case(name)`, `ltv_case(name)`, `acado_circle()`,
  `fusion_case(name)`.

A check is a triple (label, deviation, tolerance), passed when the
deviation is at most the tolerance: `deviation` makes one from two
arrays and an atol / rtol pair as `np.testing.assert_allclose` judges
them (the element nearest its tolerance), `bound` from a value and its
limit; `assert_checks` fails on any check past its tolerance.
"""
import importlib.util
import os
import struct

import numpy as np

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# the back-end oracle's own reader (numpy only), loaded from its file
_spec = importlib.util.spec_from_file_location(
    "oracle_io", os.path.join(GOLDEN, "backend_oracle", "oracle_io.py"))
oracle_io = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(oracle_io)

MINCO_CASES = ("minco_s0_n7", "minco_s1_n3", "minco_s2_n12")
BACKEND_SCENARIOS = ("straight", "turn", "cut")
TRAJANAL_CASES = ("a", "b", "c")
EKF_CASES = ("sweep", "slow_turn")
ESDF_CASES = ("boxes", "single")
PLANT_CASES = ("cruise", "reverse_switch", "saturating")
FUSION_CASES = ("fusion", "fusion_cirsup", "fusion_persp")
LTV_CASES = ("curve_d1", "straight_d0", "tightturn_d2", "coldstart_d1",
             "yawwrap_d1")

# the EKF oracle ran the reference constructor defaults (icrekf.h:143-160)
EKF_Q_DIAG = (0.2 ** 2, 0.2 ** 2, 0.314 ** 2, 0.01 ** 2, 0.01 ** 2,
              0.01 ** 2)
EKF_R_DIAG = (0.01 ** 2, 0.01 ** 2, 0.0157 ** 2)
# ESDF cell states of the oracle's grids
UNKNOWN, OCC = 0, 2


def _path(*parts):
    return os.path.join(GOLDEN, *parts)


def _floats(s):
    return np.array([float(v) for v in s.split()])


def _share(dev, tol):
    """A deviation's share of its tolerance (a zero tolerance: equality)."""
    return dev / tol if tol > 0 else (0.0 if dev == 0 else np.inf)


def deviation(label, got, ref, atol, rtol=0.0):
    """(label, |got - ref|, atol + rtol |ref|) at the element where the
    deviation takes the largest share of its tolerance."""
    got = np.asarray(got, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    assert got.shape == ref.shape and got.size, (label, got.shape, ref.shape)
    err = np.abs(got - ref)
    lim = atol + rtol * np.abs(ref)
    err_ = np.nan_to_num(err, nan=np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        shares = np.where(lim > 0, err_ / lim,
                          np.where(err_ == 0, 0.0, np.inf))
    i = int(np.argmax(shares))
    return label, float(err[i]), float(lim[i])


def bound(label, value, limit):
    """(label, value, limit) for a value that must stay below a limit."""
    return label, float(value), float(limit)


def assert_checks(checks):
    bad = [c for c in checks if not c[1] <= c[2]]
    assert not bad, "beyond tolerance (label, deviation, tolerance): " + \
        "; ".join(f"{lbl} {dev:.3e} > {tol:.3e}" for lbl, dev, tol in bad)


def worst(checks):
    """The check whose deviation takes the largest share of its
    tolerance."""
    return max(checks, key=lambda c: _share(c[1], c[2]))


# ---------------------------------------------------------------------------
# back end (tests/golden/backend, tests/test_backend_parity.py)
# ---------------------------------------------------------------------------

def as_list(v):
    return v if isinstance(v, list) else [v]


def minco_case(case):
    """(head (2, 3), tail (2, 3), inner (2, N-1), times (N,), energy
    weights (2,), oracle output)."""
    it = iter(open(_path("backend", case + "_in.txt")).read().split())
    n = int(next(it))
    head, tail = np.zeros((2, 3)), np.zeros((2, 3))
    for mat in (head, tail):
        for c in range(3):
            for r in range(2):
                mat[r, c] = float(next(it))
    inner = np.zeros((2, n - 1))
    for c in range(n - 1):
        for r in range(2):
            inner[r, c] = float(next(it))
    times = np.array([float(next(it)) for _ in range(n)])
    ew = np.array([float(next(it)), float(next(it))])
    ref = oracle_io.parse_output(_path("backend", case + "_out.txt"))
    return head, tail, inner, times, ew, ref


def minco_ref_coeffs(ref, n):
    """The oracle's coefficients as (N, 6, 2), ascending powers."""
    return ref["coeffs"].reshape(2, 6 * n).T.reshape(n, 6, 2)


def backend_scenario(name):
    """The scenario as FlatTraj fields (numpy, no lane axis) plus the
    back end's settings: dict with the FlatTraj field names and
    `standard_diff`, `icr_xv`, `checkpoints`, `safe_dis`, and the ESDF
    grid (`dist` (nx, ny) float64, `lower`, `res`)."""
    sc = oracle_io.load_scenario(_path("backend", name + "_scenario.txt"))
    dist, lower, res = oracle_io.load_grid(_path("backend",
                                                 name + "_grid.bin"))
    k = sc["inner_yaw_s"].shape[1]
    out = {f: sc[f] for f in ("inner_yaw_s", "start_state", "final_state",
                              "start_xytheta", "final_xytheta")}
    out.update(
        init_piece_time=np.float64(sc["init_t"]),
        inner_positions=np.concatenate(
            [sc["inner_positions"].reshape(k, 3), sc["final_xytheta"][None]],
            0),
        if_cut=np.bool_(sc["if_cut"]), standard_diff=sc["standard_diff"],
        icr_xv=sc["icr_ylr_xv"][2],
        checkpoints=tuple(map(tuple, sc["checkpoints"])),
        safe_dis=sc["safe_dis"], dist=dist, lower=lower, res=res)
    return out


FLAT_FIELDS = ("inner_yaw_s", "init_piece_time", "inner_positions",
               "start_state", "final_state", "start_xytheta",
               "final_xytheta", "if_cut")


def backend_xs(name):
    """The decision vectors the cost goldens were taken at, (K, n)."""
    toks = open(_path("backend", name + "_xs.txt")).read().split()
    n, dim = int(toks[0]), int(toks[1])
    return np.array([float(t) for t in toks[2:]]).reshape(n, dim)


def backend_cost(name):
    return oracle_io.parse_output(_path("backend", name + "_cost_out.txt"))


def backend_solve(name):
    return oracle_io.parse_output(_path("backend", name + "_solve_out.txt"))


# ---------------------------------------------------------------------------
# trajectory analysis (tests/golden/trajanal)
# ---------------------------------------------------------------------------

def trajanal_case(name):
    """(init (2, 3), tail (2, 3), inner (2, N-1), times (N,), start (3,),
    icr (3,), duration, rows (M, 8): t, x, y, yaw, dyaw, ds, ayaw, as)."""
    with open(_path("trajanal", f"{name}_input.txt")) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    n = int(lines[1])
    rows = [_floats(lines[i]) for i in range(2, 8)]
    times = _floats(lines[8])
    sv = _floats(lines[9])
    assert times.size == n
    with open(_path("trajanal", f"{name}_results.txt")) as f:
        rlines = [ln for ln in f.read().split("\n") if ln.strip()]
    dur = float(rlines[0].split()[1])
    q = np.array([[float(v) for v in ln.split()[1:]] for ln in rlines[1:]])
    return (np.stack(rows[0:2]), np.stack(rows[2:4]), np.stack(rows[4:6]),
            times, sv[:3], sv[3:], dur, q)


# ---------------------------------------------------------------------------
# ICR-EKF (tests/golden/ekf)
# ---------------------------------------------------------------------------

def ekf_case(name):
    """(x0 (6,), ops [(op, args)], states [(6,)], covariances [(6, 6)]);
    op "F" predicts on (vl, vr, dt), any other updates on a pose."""
    ops = []
    with open(_path("ekf", f"{name}_scenario.txt")) as f:
        x0 = _floats(f.readline())
        for line in f:
            parts = line.split()
            ops.append((parts[0], np.array([float(v) for v in parts[1:]])))
    xs, ps = [], []
    with open(_path("ekf", f"{name}_trace.txt")) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "X":
                xs.append(np.array([float(v) for v in parts[1:]]))
            elif parts and parts[0] == "P":
                ps.append(np.array([float(v) for v in parts[1:]])
                          .reshape(6, 6))
    assert len(xs) == len(ops) and len(ps) == len(ops)
    return x0, ops, xs, ps


# ---------------------------------------------------------------------------
# ESDF (tests/golden/esdf)
# ---------------------------------------------------------------------------

def esdf_case(kind):
    """(states (nx, ny) uint8, lower (2,), res, field (nx, ny), queries
    (Q, 2), bilinear results (Q, 3): distance, gradient)."""
    with open(_path("esdf", f"{kind}_grid.bin"), "rb") as f:
        nx, ny = struct.unpack("<ii", f.read(8))
        x0, y0, res = struct.unpack("<ddd", f.read(24))
        states = np.frombuffer(f.read(nx * ny), np.uint8).reshape(nx, ny)
    queries = np.atleast_2d(np.loadtxt(_path("esdf", f"{kind}_queries.txt")))
    dists, bilin = None, []
    with open(_path("esdf", f"{kind}_results.txt")) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "D":
                dists = np.array([float(v) for v in parts[1:]]).reshape(
                    nx, ny)
            elif parts and parts[0] == "B":
                bilin.append([float(v) for v in parts[1:]])
    return states, np.array([x0, y0]), res, dists, queries, np.array(bilin)


# ---------------------------------------------------------------------------
# plant (tests/golden/plant)
# ---------------------------------------------------------------------------

def plant_case(name):
    """(params: sx sy syaw max_acc max_domega yr yl xv, commands
    [(vl, vr, ticks)], trace (T, 8): x y theta v omega vy s yaw_accum)."""
    with open(_path("plant", f"{name}.txt")) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    params = [float(v) for v in lines[0].split()]
    cmds = []
    for c in lines[1].split(";"):
        vl, vr, n = c.split()
        cmds.append((float(vl), float(vr), int(n)))
    trace = np.array([[float(v) for v in r.split()] for r in lines[2:]])
    return params, cmds, trace


# ---------------------------------------------------------------------------
# LTV-MPC (tests/golden/ltv) and the ACADO NMPC circle
# ---------------------------------------------------------------------------

def ltv_case(name):
    """(config fields, state, xref (4, T), dref (2, T), output (2, T),
    delay buffer (delay, 2), golden dict).  xref's yaw row is as
    recorded: the reference smooths it toward the state's yaw before the
    tick (mpc.cpp:168), which the caller does with its own
    smooth_yaw_sequence."""
    with open(_path("ltv", f"{name}_in.txt")) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    T, dt, delay, n_iters = lines[0].split()
    T, delay, n_iters, dt = int(T), int(delay), int(n_iters), float(dt)
    lim = _floats(lines[4])
    cfg = dict(horizon=T, dt=dt, q_diag=tuple(map(float, _floats(lines[1]))),
               r_diag=tuple(map(float, _floats(lines[2]))),
               rd_diag=tuple(map(float, _floats(lines[3]))),
               max_speed=float(lim[0]), min_speed=float(lim[1]),
               max_omega=float(lim[2]), max_acc=float(lim[3]),
               max_domega=float(lim[4]), delay_num=delay, sqp_iters=n_iters)
    state = _floats(lines[5])
    xref = np.stack([_floats(lines[6 + i]) for i in range(4)])
    dref = np.stack([_floats(lines[10 + i]) for i in range(2)])
    output = np.stack([_floats(lines[12 + i]) for i in range(2)])
    buff = np.array([_floats(lines[14 + i])
                     for i in range(delay)]).reshape(delay, 2)
    with open(_path("ltv", f"{name}_out.txt")) as f:
        out = [ln for ln in f.read().split("\n") if ln.strip()]
    n, nc = (int(v) for v in out[0].split()[1:])
    # each line past P starts with its tag (q, l, u, SOL0, OUT, CMD, BUFF)
    golden = dict(
        P=np.stack([_floats(out[1 + i]) for i in range(n)]),
        q=_floats(out[1 + n][2:]), lb=_floats(out[2 + n][2:]),
        ub=_floats(out[3 + n][2:]),
        A=np.stack([_floats(out[4 + n + i]) for i in range(nc)]),
        sol0=_floats(out[4 + n + nc][5:]),
        out=_floats(out[5 + n + nc][4:]).reshape(2, T),
        cmd=_floats(out[6 + n + nc][4:]),
        buff_after=(_floats(out[7 + n + nc][5:]).reshape(delay, 2)
                    if delay > 0 else np.zeros((0, 2))))
    return cfg, state, xref, dref, output, buff, golden


def acado_circle():
    """The ACADO NMPC's 120-tick closed loop on the circle: (T, 6) rows
    t, x, y, yaw, v_r, v_l."""
    return np.loadtxt(_path("acado_nmpc_circle.txt"))


# ---------------------------------------------------------------------------
# occupancy fusion (tests/golden/fusion, fusion_cirsup, fusion_persp)
# ---------------------------------------------------------------------------

def fusion_case(name):
    """((nx, ny, res, range, beams, circular support, perspective),
    scans, grid (nx, ny) int, log-odds (nx, ny)): a scan is (pose,
    ranges float32, hits bool), or (pose, points (n, 2) float32) for the
    perspective branch."""
    d = _path(name)
    with open(os.path.join(d, "meta.txt")) as f:
        v = f.read().split()
    meta = (int(v[0]), int(v[1]), float(v[2]), float(v[3]), int(v[4]),
            bool(int(v[5])), bool(int(v[6])))
    persp = meta[6]
    with open(os.path.join(d, "scans.txt")) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    scans = []
    for i in range(0, len(lines), 3):
        pose = _floats(lines[i])
        a = np.array(lines[i + 1].split(), np.float64).astype(np.float32)
        if persp:
            b = np.array(lines[i + 2].split(), np.float64).astype(np.float32)
            scans.append((pose, np.stack([a, b], -1)))
        else:
            scans.append((pose, a, np.array([int(x) for x in
                                             lines[i + 2].split()], bool)))
    with open(os.path.join(d, "result.txt")) as f:
        gl = f.readline().split()[1:]
        ol = f.readline().split()[1:]
    grid = np.array([int(x) for x in gl]).reshape(meta[0], meta[1])
    lo = np.array([float(x) for x in ol]).reshape(meta[0], meta[1])
    return meta, scans, grid, lo
