"""Batched planar rigid-body contact dynamics (port of world/physics2d.py).

Oriented boxes with mass, inertia and COM offset; a traction-limited
velocity servo for the robot base; a SAT + reference-face-clipping
2-point OBB manifold; a sequential-impulse (projected Gauss-Seidel)
solve with Coulomb friction and Baumgarte bias; planar floor friction as
exact velocity-space impulse projections; and an optional grasp weld
(2-D point constraint + yaw lock).  The solver math is the standard
sequential-impulse formulation (Catto, "Iterative Dynamics with Temporal
Coherence").

Every field of `BodyState` carries a leading lane axis, (B, NB, ...),
where the JAX package vmaps one scene.  Body indices, the pair list and
the grasp's bodies are static Python integers.  The solver's fixed
iteration counts become Python loops that update a cloned velocity with
index writes.  All arithmetic is elementwise per lane (no matrix
products), so a lane computes the same bits alone as in a batch.  The
grasp's 2x2 solve is the closed form (Cramer's rule).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

GRAV = 9.81


class BodyState(NamedTuple):
    """Struct-of-arrays over NB bodies per lane.  The body frame is the
    COM frame; `box_off` places the box center in that frame."""

    pose: torch.Tensor       # (B, NB, 3) x, y, yaw of the COM frame (world)
    vel: torch.Tensor        # (B, NB, 3) vx, vy (world), omega
    mass: torch.Tensor       # (B, NB)
    inertia: torch.Tensor    # (B, NB) yaw inertia about the COM
    half_ext: torch.Tensor   # (B, NB, 2) box half extents
    box_off: torch.Tensor    # (B, NB, 2) box center in the COM frame
    mu_ground: torch.Tensor  # (B, NB) Coulomb friction against the floor


class PhysicsConfig(NamedTuple):
    dt: float = 0.005
    solver_iters: int = 4
    mu_contact: float = 0.6
    restitution: float = 0.0
    baumgarte: float = 0.2
    slop: float = 0.005
    servo_gain: float = 200.0
    servo_yaw_gain: float = 200.0
    mu_feet: float = 1.0
    grasp_beta: float = 0.2
    grasp_impulse_cap: float = 1e9


def _cos_sin(yaw):
    return torch.cos(yaw), torch.sin(yaw)


def _rotate(c, s, v):
    """R(yaw) @ v for v (..., 2), with c, s shaped as v[..., 0]."""
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _cross_z(w, v):
    """z x v for a scalar z (angular) and 2-vector v."""
    return torch.stack([-w * v[..., 1], w * v[..., 0]], dim=-1)


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def box_inertia(mass, half_ext):
    """Yaw inertia of a uniform box about its center."""
    return mass * (half_ext[..., 0] ** 2 + half_ext[..., 1] ** 2) / 3.0


class Manifold(NamedTuple):
    points: torch.Tensor   # (..., 2, 2) world contact points
    normal: torch.Tensor   # (..., 2) world, from A toward B
    depth: torch.Tensor    # (..., 2) penetration depth (>0 = penetrating)
    valid: torch.Tensor    # (..., 2) bool


_CORNERS = ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0))


def _gather_last(x, idx):
    """x (..., n) at integer idx (...)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def obb_manifold(centerA, yawA, heA, centerB, yawB, heB) -> Manifold:
    """Two-point contact manifold between oriented boxes.

    SAT over the 4 face normals picks the minimum-penetration reference
    face (the first minimum, A's axes preferred on near-ties); the
    incident box's two deepest vertices (a stable sort, so ties keep
    vertex order) are clipped to the reference face's side planes.
    Branchless; leading dims are lanes."""
    dtype, dev = centerA.dtype, centerA.device
    cA, sA = _cos_sin(yawA)
    cB, sB = _cos_sin(yawB)
    # world axes: the columns of R_A and R_B
    axes = torch.stack([torch.stack([cA, sA], -1), torch.stack([-sA, cA], -1),
                        torch.stack([cB, sB], -1), torch.stack([-sB, cB], -1)],
                       dim=-2)                                   # (..., 4, 2)
    d = centerB - centerA

    def support(c, s, he):
        col0 = torch.stack([c, s], -1)[..., None, :]
        col1 = torch.stack([-s, c], -1)[..., None, :]
        return (torch.abs(_dot(axes, col0)) * he[..., None, 0]
                + torch.abs(_dot(axes, col1)) * he[..., None, 1])

    dist = torch.abs(_dot(axes, d[..., None, :]))
    overlap = support(cA, sA, heA) + support(cB, sB, heB) - dist  # (..., 4)
    separated = torch.any(overlap < 0.0, dim=-1)

    bias = torch.tensor([0.0, 0.0, 1e-6, 1e-6], dtype=dtype, device=dev)
    k = torch.argmin(overlap + bias, dim=-1)                      # first min
    ref_is_A = k < 2
    n = torch.gather(axes, -2, k[..., None, None].expand(*k.shape, 1, 2))[..., 0, :]
    n = torch.where((_dot(n, d) < 0.0)[..., None], -n, n)        # A -> B
    sgn = torch.where(ref_is_A, torch.ones_like(yawA), -torch.ones_like(yawA))
    n_ref = sgn[..., None] * n

    ra = ref_is_A[..., None]
    ref_center = torch.where(ra, centerA, centerB)
    ref_he = torch.where(ra, heA, heB)
    inc_center = torch.where(ra, centerB, centerA)
    inc_yaw = torch.where(ref_is_A, yawB, yawA)
    inc_he = torch.where(ra, heB, heA)

    face_axis = torch.remainder(k, 2)
    face_half = _gather_last(ref_he, face_axis)
    face_off = _dot(ref_center, n_ref) + face_half
    side = torch.stack([-n_ref[..., 1], n_ref[..., 0]], -1)
    side_half = _gather_last(ref_he, 1 - face_axis)
    side_c = _dot(ref_center, side)

    # incident box vertices; take the two deepest along -n_ref
    ci, si = _cos_sin(inc_yaw)
    corners = torch.tensor(_CORNERS, dtype=dtype, device=dev) \
        * inc_he[..., None, :]                                    # (..., 4, 2)
    verts = inc_center[..., None, :] + _rotate(ci[..., None], si[..., None],
                                               corners)
    vdepth = face_off[..., None] - _dot(verts, n_ref[..., None, :])
    order = torch.argsort(-vdepth, dim=-1, stable=True)
    p1 = torch.gather(verts, -2, order[..., 0, None, None].expand(
        *order.shape[:-1], 1, 2))[..., 0, :]
    p2 = torch.gather(verts, -2, order[..., 1, None, None].expand(
        *order.shape[:-1], 1, 2))[..., 0, :]

    def clip_point(p):
        t0 = _dot(p, side) - side_c
        t = torch.clamp(t0, -side_half, side_half)
        return p + (t - t0)[..., None] * side

    p1c, p2c = clip_point(p1), clip_point(p2)
    d1 = face_off - _dot(p1c, n_ref)
    d2 = face_off - _dot(p2c, n_ref)
    pts = torch.stack([p1c, p2c], dim=-2)
    dep = torch.stack([d1, d2], dim=-1)
    val = (dep > 0.0) & torch.logical_not(separated)[..., None]
    return Manifold(points=pts, normal=n, depth=dep, valid=val)


class ContactDebug(NamedTuple):
    pn: torch.Tensor   # (B, C, 2) accumulated normal impulses
    pt: torch.Tensor   # (B, C, 2) accumulated tangential impulses


def _split(vel):
    """(B, NB, 3) -> per-body lists [vx, vy, w] of (B,) tensors."""
    return [list(b.unbind(-1)) for b in vel.unbind(1)]


def _join(v):
    return torch.stack([torch.stack(b, -1) for b in v], 1)


def _impulse(v, body: int, ix, iy, rx, ry, im, iI, sign: int):
    """Body `body` of the split velocity `v` takes the impulse
    sign * (ix, iy) at the arm (rx, ry): the JAX package's
    vel.at[body, :2].add(imp * inv_m).at[body, 2].add(cross2(arm, imp) *
    inv_I), with the sign folded into an add or a subtract (negation is
    exact, so the sums are the same)."""
    b = v[body]
    if sign > 0:
        b[0] = b[0] + ix * im
        b[1] = b[1] + iy * im
        b[2] = b[2] + (rx * iy - ry * ix) * iI
    else:
        b[0] = b[0] - ix * im
        b[1] = b[1] - iy * im
        b[2] = b[2] - (rx * iy - ry * ix) * iI


class _Weld(NamedTuple):
    """What one grasp pass needs that does not change within a substep."""

    ga: int
    gb: int
    wa: tuple                # anchor arms (x, y) of (B,) tensors
    wb: tuple
    bias: tuple              # grasp_beta / dt * anchor separation
    k00: torch.Tensor        # the 2x2 effective-mass matrix, symmetric
    k01: torch.Tensor
    k11: torch.Tensor
    det: torch.Tensor
    active: torch.Tensor     # bool () or (B,)
    lock: torch.Tensor       # active & yaw_lock
    kw: torch.Tensor
    inv: tuple               # (inv_m a, inv_I a, inv_m b, inv_I b)


def _weld(st: BodyState, grasp, cfg: PhysicsConfig, inv_m, inv_I) -> _Weld:
    active, ga, anch_a, gb, anch_b, yaw_lock = grasp
    ca, sa = _cos_sin(st.pose[:, ga, 2])
    cb, sb = _cos_sin(st.pose[:, gb, 2])
    wa = _rotate(ca, sa, anch_a)
    wb = _rotate(cb, sb, anch_b)
    err = (st.pose[:, gb, :2] + wb) - (st.pose[:, ga, :2] + wa)
    bias = cfg.grasp_beta / cfg.dt * err
    ima, iIa, imb, iIb = inv_m[:, ga], inv_I[:, ga], inv_m[:, gb], inv_I[:, gb]

    def kmat(inv_mi, inv_Ii, r):
        # inv_m * I + inv_I * [[ry^2, -rx ry], [-rx ry, rx^2]]
        return (inv_mi + inv_Ii * r[:, 1] ** 2, inv_Ii * (-r[:, 0] * r[:, 1]),
                inv_mi + inv_Ii * r[:, 0] ** 2)

    k00a, k01a, k11a = kmat(ima, iIa, wa)
    k00b, k01b, k11b = kmat(imb, iIb, wb)
    k00, k01, k11 = k00a + k00b, k01a + k01b, k11a + k11b
    active = torch.as_tensor(active, device=st.vel.device)
    lock = active & torch.as_tensor(yaw_lock, device=st.vel.device)
    return _Weld(ga=ga, gb=gb, wa=tuple(wa.unbind(-1)), wb=tuple(wb.unbind(-1)),
                 bias=tuple(bias.unbind(-1)), k00=k00, k01=k01, k11=k11,
                 det=k00 * k11 - k01 * k01, active=active, lock=lock,
                 kw=iIa + iIb, inv=(ima, iIa, imb, iIb))


def _weld_pass(v, w: _Weld, cfg: PhysicsConfig):
    """One PGS pass of the grasp weld on the split velocity `v`: the
    anchors' relative velocity (with Baumgarte bias) driven to zero by the
    closed-form 2x2 solve, capped at the grip budget, then the yaw lock."""
    a, b = v[w.ga], v[w.gb]
    (wax, way), (wbx, wby) = w.wa, w.wb
    rv0 = ((b[0] - b[2] * wby) - (a[0] - a[2] * way)) + w.bias[0]
    rv1 = ((b[1] + b[2] * wbx) - (a[1] + a[2] * wax)) + w.bias[1]
    imp0 = -((w.k11 * rv0 - w.k01 * rv1) / w.det)
    imp1 = -((w.k00 * rv1 - w.k01 * rv0) / w.det)
    # grip-force limit: beyond it the weld slips
    cap = cfg.grasp_impulse_cap * cfg.dt
    mag = torch.sqrt((imp0 * imp0 + imp1 * imp1) + 1e-18)
    scale = torch.clamp(mag, max=cap) / torch.clamp(mag, min=1e-12)
    imp0 = torch.where(w.active, imp0 * scale, 0.0)
    imp1 = torch.where(w.active, imp1 * scale, 0.0)
    ima, iIa, imb, iIb = w.inv
    _impulse(v, w.ga, imp0, imp1, wax, way, ima, iIa, -1)
    _impulse(v, w.gb, imp0, imp1, wbx, wby, imb, iIb, +1)
    # optional yaw lock: zero relative omega
    pw = torch.where(w.lock, -(v[w.gb][2] - v[w.ga][2]) / w.kw, 0.0)
    v[w.ga][2] = v[w.ga][2] - pw * iIa
    v[w.gb][2] = v[w.gb][2] + pw * iIb


def _grasp_impulse(st: BodyState, vel, grasp, cfg: PhysicsConfig, inv_m,
                   inv_I):
    """One PGS pass of the grasp weld: returns the new (B, NB, 3)
    velocity.  grasp = (active, body_a, anchor_a, body_b, anchor_b,
    yaw_lock) with static body indices; active / yaw_lock bool () or
    (B,), anchors (2,) or (B, 2).  The 2x2 solve is the closed form."""
    v = _split(vel)
    _weld_pass(v, _weld(st, grasp, cfg, inv_m, inv_I), cfg)
    return _join(v)


def _pair_manifold(st: BodyState, a: int, b: int) -> Manifold:
    ca, sa = _cos_sin(st.pose[:, a, 2])
    cb, sb = _cos_sin(st.pose[:, b, 2])
    cA = st.pose[:, a, :2] + _rotate(ca, sa, st.box_off[:, a])
    cB = st.pose[:, b, :2] + _rotate(cb, sb, st.box_off[:, b])
    return obb_manifold(cA, st.pose[:, a, 2], st.half_ext[:, a],
                        cB, st.pose[:, b, 2], st.half_ext[:, b])


class _Pair(NamedTuple):
    """One contact pair's constants within a substep, as (B,) tensors
    (pairs of them per manifold point)."""

    a: int
    b: int
    nx: torch.Tensor
    ny: torch.Tensor
    ra: tuple                # ((x, y) of point 0, (x, y) of point 1)
    rb: tuple
    neg_mt: tuple            # -(tangential effective mass) per point
    valid: tuple
    bias: tuple
    a11: torch.Tensor
    a22: torch.Tensor
    a12: torch.Tensor
    neg_a22: torch.Tensor
    inv_det: torch.Tensor
    det_ok: torch.Tensor
    inv: tuple               # (inv_m a, inv_I a, inv_m b, inv_I b)


def _rel(v, pr: _Pair, p: int):
    """Relative velocity (x, y) of the pair's bodies at point p."""
    a, b = v[pr.a], v[pr.b]
    (rax, ray), (rbx, rby) = pr.ra[p], pr.rb[p]
    return ((b[0] - b[2] * rby) - (a[0] - a[2] * ray),
            (b[1] + b[2] * rbx) - (a[1] + a[2] * rax))


def _pair_pass(v, pr: _Pair, pn, pt, cfg: PhysicsConfig):
    """One PGS pass over one pair: the exact 2-point normal LCP
    (Box2D-style block solver over the 4 active-set cases on TOTAL
    impulses), then per-point friction clamped to the cone.  pn, pt:
    the pair's accumulated impulses [point 0, point 1], updated."""
    nx, ny = pr.nx, pr.ny
    ima, iIa, imb, iIb = pr.inv
    vn = []
    for p in (0, 1):
        rx, ry = _rel(v, pr, p)
        vn.append(rx * nx + ry * ny)
    Ap0 = pr.a11 * pn[0] + pr.a12 * pn[1]
    Ap1 = pr.a12 * pn[0] + pr.a22 * pn[1]
    # an invalid manifold point: constraint trivially satisfied at 0
    b0 = torch.where(pr.valid[0], (vn[0] - Ap0) - pr.bias[0], 1e30)
    b1 = torch.where(pr.valid[1], (vn[1] - Ap1) - pr.bias[1], 1e30)
    x1 = (pr.neg_a22 * b0 + pr.a12 * b1) * pr.inv_det
    x2 = (pr.a12 * b0 - pr.a11 * b1) * pr.inv_det
    c1 = (x1 >= 0.0) & (x2 >= 0.0) & pr.det_ok
    y1 = -b0 / pr.a11
    c2 = (y1 >= 0.0) & (pr.a12 * y1 + b1 >= 0.0)
    z2 = -b1 / pr.a22
    c3 = (z2 >= 0.0) & (pr.a12 * z2 + b0 >= 0.0)
    new0 = torch.where(c1, x1, torch.where(c2, y1, 0.0))
    new1 = torch.where(c1, x2, torch.where(c2, 0.0, torch.where(c3, z2, 0.0)))
    new = (torch.where(pr.valid[0], new0, 0.0),
           torch.where(pr.valid[1], new1, 0.0))
    for p in (0, 1):
        d = new[p] - pn[p]
        ix, iy = d * nx, d * ny
        _impulse(v, pr.a, ix, iy, *pr.ra[p], ima, iIa, -1)
        _impulse(v, pr.b, ix, iy, *pr.rb[p], imb, iIb, +1)
    pn[0], pn[1] = new

    tx, ty = -ny, nx
    for p in (0, 1):
        rx, ry = _rel(v, pr, p)
        dpt = pr.neg_mt[p] * (rx * tx + ry * ty)
        hi = cfg.mu_contact * pn[p]
        pt_new = torch.clamp(pt[p] + dpt, -hi, hi)
        dpt = torch.where(pr.valid[p], pt_new - pt[p], 0.0)
        ix, iy = dpt * tx, dpt * ty
        _impulse(v, pr.a, ix, iy, *pr.ra[p], ima, iIa, -1)
        _impulse(v, pr.b, ix, iy, *pr.rb[p], imb, iIb, +1)
        pt[p] = pt[p] + dpt


def _stack_pairs(acc):
    return torch.stack([torch.stack(x, -1) for x in acc], 1)


def solve_contacts(st: BodyState, pairs, cfg: PhysicsConfig, grasp=None):
    """Impulse solve over the given body-index pairs (a static list).
    Returns (new_vel, ContactDebug).  `grasp`, if given, is
    (active, body_a, anchor_a, body_b, anchor_b, yaw_lock), solved inside
    the same PGS loop after the pairs.

    The loop runs on per-body velocity components, (B,) tensors, so a
    pass is a short chain of elementwise operations without indexing."""
    dtype, dev = st.vel.dtype, st.vel.device
    B = st.vel.shape[0]
    inv_m = 1.0 / st.mass
    inv_I = 1.0 / st.inertia
    C = len(pairs)
    v = _split(st.vel)
    weld = None if grasp is None else _weld(st, grasp, cfg, inv_m, inv_I)
    if C == 0:
        if weld is not None:
            for _ in range(cfg.solver_iters):
                _weld_pass(v, weld, cfg)
        empty = torch.zeros((B, 0, 2), dtype=dtype, device=dev)
        return _join(v), ContactDebug(pn=empty, pt=empty.clone())

    mans = [_pair_manifold(st, a, b) for a, b in pairs]
    normals = torch.stack([m.normal for m in mans], 1)          # (B, C, 2)
    points = torch.stack([m.points for m in mans], 1)           # (B, C, 2, 2)
    depths = torch.stack([m.depth for m in mans], 1)            # (B, C, 2)
    valids = torch.stack([m.valid for m in mans], 1)            # (B, C, 2)
    ia = [p[0] for p in pairs]
    ib = [p[1] for p in pairs]

    # contact arms about each COM
    ra = points - st.pose[:, ia, None, :2]                      # (B, C, 2, 2)
    rb = points - st.pose[:, ib, None, :2]
    tangents = torch.stack([-normals[..., 1], normals[..., 0]], dim=-1)
    im_a, im_b = inv_m[:, ia, None], inv_m[:, ib, None]         # (B, C, 1)
    iI_a, iI_b = inv_I[:, ia, None], inv_I[:, ib, None]

    def eff_mass(dirs):
        ran = ra[..., 0] * dirs[..., None, 1] - ra[..., 1] * dirs[..., None, 0]
        rbn = rb[..., 0] * dirs[..., None, 1] - rb[..., 1] * dirs[..., None, 0]
        k = im_a + im_b + iI_a * ran ** 2 + iI_b * rbn ** 2
        return 1.0 / k, ran, rbn

    mn, ran_n, rbn_n = eff_mass(normals)
    mt, _, _ = eff_mass(tangents)
    # restitution on the PRE-solve approach velocity + Baumgarte bias
    wa0 = st.vel[:, ia, None, 2]
    wb0 = st.vel[:, ib, None, 2]
    va0 = st.vel[:, ia, None, :2] + torch.stack(
        [-wa0 * ra[..., 1], wa0 * ra[..., 0]], dim=-1)
    vb0 = st.vel[:, ib, None, :2] + torch.stack(
        [-wb0 * rb[..., 1], wb0 * rb[..., 0]], dim=-1)
    vn0 = torch.sum((vb0 - va0) * normals[..., None, :], dim=-1)
    bias = cfg.baumgarte / cfg.dt * torch.clamp(depths - cfg.slop, min=0.0) \
        + cfg.restitution * torch.clamp(-vn0, min=0.0)

    # 2x2 normal-block coupling of the two manifold points
    a11 = 1.0 / mn[..., 0]
    a22 = 1.0 / mn[..., 1]
    a12 = inv_m[:, ia] + inv_m[:, ib] + inv_I[:, ia] * ran_n[..., 0] \
        * ran_n[..., 1] + inv_I[:, ib] * rbn_n[..., 0] * rbn_n[..., 1]
    det = a11 * a22 - a12 * a12
    inv_det = 1.0 / torch.clamp(det, min=1e-12)

    def points_of(r):
        return [tuple(tuple(q.unbind(-1)) for q in rc.unbind(1))
                for rc in r.unbind(1)]

    ra_c, rb_c = points_of(ra), points_of(rb)
    neg_mt, neg_a22, det_ok = -mt, -a22, det > 1e-12
    prs = []
    for c in range(C):
        prs.append(_Pair(
            a=ia[c], b=ib[c], nx=normals[:, c, 0], ny=normals[:, c, 1],
            ra=ra_c[c], rb=rb_c[c], neg_mt=tuple(neg_mt[:, c].unbind(-1)),
            valid=tuple(valids[:, c].unbind(-1)),
            bias=tuple(bias[:, c].unbind(-1)), a11=a11[:, c], a22=a22[:, c],
            a12=a12[:, c], neg_a22=neg_a22[:, c], inv_det=inv_det[:, c],
            det_ok=det_ok[:, c],
            inv=(inv_m[:, ia[c]], inv_I[:, ia[c]], inv_m[:, ib[c]],
                 inv_I[:, ib[c]])))

    zero = torch.zeros_like(a11[:, 0])
    pn = [[zero, zero] for _ in range(C)]
    pt = [[zero, zero] for _ in range(C)]
    for _ in range(cfg.solver_iters):
        for c in range(C):
            _pair_pass(v, prs[c], pn[c], pt[c], cfg)
        if weld is not None:
            _weld_pass(v, weld, cfg)
    return _join(v), ContactDebug(pn=_stack_pairs(pn), pt=_stack_pairs(pt))


def ground_friction(st: BodyState, cfg: PhysicsConfig,
                    skip_mask=None) -> torch.Tensor:
    """Planar Coulomb floor friction as an exact impulse projection:
    linear |P| <= mu m g dt, torsional the same with an arm of
    0.5 * mean(half_ext).  skip_mask (NB,) or (B, NB) bool: bodies that
    keep their velocity (the servoed robot)."""
    v = st.vel[..., :2]
    speed = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-18)
    # mass cancels in the velocity change; avoiding the ratio keeps
    # infinite-mass STATIC bodies NaN-free
    dv_mag = torch.minimum(speed, st.mu_ground * GRAV * cfg.dt)
    v_new = v - v * (dv_mag / torch.clamp(speed, min=1e-9))[..., None]

    w = st.vel[..., 2]
    arm = 0.5 * torch.mean(st.half_ext, dim=-1)
    m_over_I = torch.where(torch.isfinite(st.mass), st.mass / st.inertia,
                           torch.zeros_like(st.mass))
    tw_max = st.mu_ground * GRAV * arm * cfg.dt * m_over_I
    w_new = w - torch.clamp(w, -tw_max, tw_max)

    vel = torch.cat([v_new, w_new[..., None]], dim=-1)
    if skip_mask is None:
        return vel
    skip = torch.as_tensor(skip_mask, device=vel.device)
    return torch.where(skip[..., None], st.vel, vel)


def servo_forces(st: BodyState, body: int, v_cmd_body, cfg: PhysicsConfig):
    """Traction-limited velocity servo on one body (the WBC abstraction).
    v_cmd_body (B, 3) = (vx, vy, w) in the body frame.  Returns a
    (B, NB, 3) force/torque array."""
    c, s = _cos_sin(st.pose[:, body, 2])
    v_cmd_w = _rotate(c, s, v_cmd_body[:, :2])
    m = st.mass[:, body]
    f = m[:, None] * cfg.servo_gain * (v_cmd_w - st.vel[:, body, :2])
    f_max = cfg.mu_feet * m * GRAV
    fn = torch.sqrt(torch.sum(f * f, dim=-1) + 1e-18)
    f = f * (torch.minimum(fn, f_max) / torch.clamp(fn, min=1e-9))[:, None]
    tau = st.inertia[:, body] * cfg.servo_yaw_gain * (v_cmd_body[:, 2]
                                                      - st.vel[:, body, 2])
    arm = 0.5 * torch.mean(st.half_ext[:, body], dim=-1)
    lim = f_max * arm
    tau = torch.clamp(tau, -lim, lim)
    wrench = torch.zeros_like(st.vel)
    wrench[:, body, :2] = f
    wrench[:, body, 2] = tau
    return wrench


def physics_substep(st: BodyState, wrench, pairs, cfg: PhysicsConfig,
                    grasp=None, servo_mask=None):
    """One dt substep: forces -> contact impulses -> floor friction ->
    integrate.  `wrench` (B, NB, 3) external force/torque; bodies in
    `servo_mask` skip floor friction.  Returns (state, ContactDebug)."""
    inv_m = 1.0 / st.mass
    inv = torch.stack([inv_m, inv_m, 1.0 / st.inertia], dim=-1)
    vel = st.vel + cfg.dt * wrench * inv
    st = st._replace(vel=vel)
    vel, dbg = solve_contacts(st, pairs, cfg, grasp=grasp)
    st = st._replace(vel=vel)
    vel = ground_friction(st, cfg, skip_mask=servo_mask)
    pose = st.pose + cfg.dt * vel
    return st._replace(pose=pose, vel=vel), dbg
