"""Port parity: the planar rigid-body contact engine (world/physics2d.py).

Every function of the module against the JAX package on the scenes of
tests/test_physics2d.py, in float64 and within 1e-12: the OBB manifold
(separated, axis-aligned overlap with its vertex-depth ties, a rotated
corner, the mission's docked robot/object pair, and a seeded batch of
random pairs), `box_inertia`, `servo_forces`, `ground_friction`,
`_grasp_impulse`, `solve_contacts` and rollouts of `physics_substep`
(contact, restitution, friction, floor friction without pairs, the
servoed push, the traction limit, the grasp weld, an inactive grasp and
an infinite-mass static body).  The JAX side runs jitted, as its own
tests run it, on the CPU with x64 on.

In float32 the same rollouts agree within 2e-5 m / 2e-4 m/s (a few
hundred substeps of rounding in another order).  A batch of lanes equals
each lane run alone bit for bit, and the port meets the JAX tests'
physical invariants on its own.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.world import physics2d as jp
from alore_legged_manipulator_tpu_torch.world import physics2d as tp

torch.set_num_threads(1)

F64 = dict(rtol=0, atol=1e-12)


def _bodies(poses, vels, masses, half_exts, mu_ground=0.5):
    """numpy fields of one scene (NB bodies)."""
    poses = np.asarray(poses, float)
    n = poses.shape[0]
    masses = np.asarray(masses, float)
    he = np.asarray(half_exts, float)
    with np.errstate(invalid="ignore"):
        inertia = masses * (he[:, 0] ** 2 + he[:, 1] ** 2) / 3.0
    return dict(pose=poses, vel=np.asarray(vels, float), mass=masses,
                inertia=inertia, half_ext=he, box_off=np.zeros((n, 2)),
                mu_ground=np.full(n, mu_ground, float))


def _jax_state(fields, dtype=jnp.float64):
    return jp.BodyState(**{k: jnp.asarray(v, dtype) for k, v in fields.items()})


def _port_state(fields, dtype=torch.float64):
    """One lane of the scene."""
    return tp.BodyState(**{k: torch.as_tensor(np.asarray(v)).to(dtype)[None]
                           for k, v in fields.items()})


# ---------------------------------------------------------------------------
# manifold
# ---------------------------------------------------------------------------

MANIFOLD_SCENES = {
    "separated": ([0.0, 0.0], 0.0, [0.5, 0.5], [2.0, 0.0], 0.0, [0.5, 0.5]),
    "aligned_overlap": ([0.0, 0.0], 0.0, [0.5, 0.5], [0.9, 0.0], 0.0,
                        [0.5, 0.5]),
    "rotated_corner": ([0.0, 0.0], 0.0, [1.0, 0.5],
                       [0.0, 0.5 + 0.5 * np.sqrt(2.0) - 0.05], np.pi / 4,
                       [0.5, 0.5]),
    # the mission's docked pair: robot and object share the yaw, so the
    # incident vertices tie in depth
    "docked_pair": ([1.0, 2.0], 0.7, [0.45, 0.3],
                    [1.0 + 0.74 * np.cos(0.7), 2.0 + 0.74 * np.sin(0.7)],
                    0.7, [0.3, 0.3]),
}


@pytest.mark.parametrize("scene", sorted(MANIFOLD_SCENES))
def test_manifold_matches_jax(scene):
    cA, yA, hA, cB, yB, hB = MANIFOLD_SCENES[scene]
    args = [np.asarray(v, float) for v in (cA, yA, hA, cB, yB, hB)]
    ref = jp.obb_manifold(*map(jnp.asarray, args))
    got = tp.obb_manifold(*(torch.as_tensor(a)[None] for a in args))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(ref.valid))
    for name in ("points", "normal", "depth"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(ref, name)), **F64,
                                   err_msg=name)
    if scene == "aligned_overlap":
        assert got.valid.all()
        np.testing.assert_allclose(got.depth[0].numpy(), [0.1, 0.1], **F64)


def _random_pairs(n, seed):
    rng = np.random.default_rng(seed)
    cA = rng.uniform(-0.2, 0.2, (n, 2))
    yA = rng.uniform(-np.pi, np.pi, n)
    hA = rng.uniform(0.2, 0.6, (n, 2))
    cB = cA + rng.uniform(-0.9, 0.9, (n, 2))
    # a quarter of the pairs share the yaw (tied depths), the rest are random
    yB = np.where(np.arange(n) % 4 == 0, yA, rng.uniform(-np.pi, np.pi, n))
    hB = rng.uniform(0.2, 0.6, (n, 2))
    return cA, yA, hA, cB, yB, hB


def test_manifold_random_batch_matches_jax():
    """Where the two clipped points are at different depths, the points
    come in JAX's order to 1e-12.  Where their depths tie (boxes that
    share the yaw), the order is decided by the last bit: XLA evaluates
    the 2-vector dot products with a fused multiply-add, the port with
    two roundings, so the same pair of points may come in the other
    order (test_tied_order_does_not_change_the_solve shows this changes
    no velocity)."""
    args = _random_pairs(64, 3)
    ref = jax.vmap(jp.obb_manifold)(*map(jnp.asarray, args))
    got = tp.obb_manifold(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0 < int(got.valid.sum()) < 2 * 64
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(ref.normal),
                               **F64)
    r_pts, r_dep = np.asarray(ref.points), np.asarray(ref.depth)
    g_pts, g_dep = got.points.numpy(), got.depth.numpy()
    tied = np.abs(r_dep[:, 0] - r_dep[:, 1]) < 1e-9
    assert set(np.nonzero(tied)[0]) <= set(range(0, 64, 4))
    np.testing.assert_allclose(g_pts[~tied], r_pts[~tied], **F64)
    np.testing.assert_allclose(g_dep[~tied], r_dep[~tied], **F64)
    for b in np.nonzero(tied)[0]:
        order = np.lexsort(g_pts[b].T), np.lexsort(r_pts[b].T)
        np.testing.assert_allclose(g_pts[b][order[0]], r_pts[b][order[1]],
                                   **F64)
        np.testing.assert_allclose(g_dep[b], r_dep[b], rtol=0, atol=1e-9)


def test_tied_order_does_not_change_the_solve(monkeypatch):
    """Swapping the two manifold points changes the PGS friction passes'
    order; for boxes that share the yaw (the docked pair, where depths
    tie) the solve is symmetric and the velocities agree to 1e-12."""
    rng = np.random.default_rng(1)
    B = 64
    yaw = rng.uniform(-3.0, 3.0, B)
    gap = rng.uniform(0.70, 0.76, B)
    poses = np.zeros((B, 2, 3))
    poses[:, 1, 0] = gap * np.cos(yaw)
    poses[:, 1, 1] = gap * np.sin(yaw)
    poses[:, :, 2] = yaw[:, None]
    he = np.broadcast_to([[0.45, 0.3], [0.3, 0.3]], (B, 2, 2)).copy()
    m = np.broadcast_to([60.0, 12.0], (B, 2)).copy()
    st = tp.BodyState(
        pose=torch.as_tensor(poses),
        vel=torch.as_tensor(rng.normal(0.0, 0.3, (B, 2, 3))),
        mass=torch.as_tensor(m),
        inertia=torch.as_tensor(m * (he[..., 0] ** 2 + he[..., 1] ** 2) / 3),
        half_ext=torch.as_tensor(he),
        box_off=torch.zeros(B, 2, 2, dtype=torch.float64),
        mu_ground=torch.full((B, 2), 0.4, dtype=torch.float64))
    cfg = tp.PhysicsConfig()
    v1, d1 = tp.solve_contacts(st, [(0, 1)], cfg)
    orig = tp.obb_manifold

    def swapped(*a):
        m = orig(*a)
        return tp.Manifold(points=m.points.flip(-2), normal=m.normal,
                           depth=m.depth.flip(-1), valid=m.valid.flip(-1))
    monkeypatch.setattr(tp, "obb_manifold", swapped)
    v2, d2 = tp.solve_contacts(st, [(0, 1)], cfg)
    assert int((d1.pn.sum((1, 2)) > 0).sum()) > B // 2
    np.testing.assert_allclose(v2.numpy(), v1.numpy(), **F64)
    np.testing.assert_allclose(d2.pn.flip(-1).numpy(), d1.pn.numpy(),
                               rtol=0, atol=1e-10)


def test_box_inertia_matches_jax():
    m = np.array([60.0, 15.0, np.inf])
    he = np.array([[0.45, 0.3], [0.3, 0.3], [1.0, 0.2]])
    np.testing.assert_array_equal(
        tp.box_inertia(torch.as_tensor(m), torch.as_tensor(he)).numpy(),
        np.asarray(jp.box_inertia(jnp.asarray(m), jnp.asarray(he))))


# ---------------------------------------------------------------------------
# rollouts of physics_substep
# ---------------------------------------------------------------------------

PUSH = dict(poses=[[0.0, 0.0, 0.0], [0.75, 0.0, 0.0]], vels=np.zeros((2, 3)),
            masses=[60.0, 10.0], half_exts=[[0.45, 0.3], [0.3, 0.3]],
            mu_ground=0.3)
GRASP = ((0.6, 0.0), (-0.3, 0.0))

# name: (scene, config kwargs, pairs, steps, servo command or None,
#        grasp: None / "on" / "off")
ROLLOUTS = {
    "head_on": (dict(poses=[[0.0, 0.0, 0.0], [1.003, 0.0, 0.0]],
                     vels=[[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], masses=[2.0, 3.0],
                     half_exts=[[0.5, 0.5], [0.5, 0.5]], mu_ground=0.0),
                dict(mu_contact=0.0, baumgarte=0.0), ((0, 1),), 5, None, None),
    "restitution": (dict(poses=[[0.0, 0.0, 0.0], [1.002, 0.0, 0.0]],
                         vels=[[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                         masses=[1.0, 1e9], half_exts=[[0.5, 0.5], [0.5, 0.5]],
                         mu_ground=0.0),
                    dict(mu_contact=0.0, baumgarte=0.0, restitution=0.8),
                    ((0, 1),), 3, None, None),
    "oblique_friction": (dict(poses=[[0.0, 0.0, 0.0], [0.95, 0.3, 0.0]],
                              vels=[[1.0, 0.5, 0.0], [0.0, 0.0, 0.0]],
                              masses=[1.0, 1.0],
                              half_exts=[[0.5, 0.5], [0.5, 0.5]],
                              mu_ground=0.0),
                         dict(mu_contact=0.4, baumgarte=0.0), ((0, 1),), 20,
                         None, None),
    "penetration": (dict(poses=[[0.0, 0.0, 0.0], [0.92, 0.0, 0.0]],
                         vels=np.zeros((2, 3)), masses=[1.0, 1.0],
                         half_exts=[[0.5, 0.5], [0.5, 0.5]], mu_ground=0.0),
                    {}, ((0, 1),), 300, None, None),
    "slide_and_spin": (dict(poses=[[0.0, 0.0, 0.0]], vels=[[2.0, 0.5, 3.0]],
                            masses=[5.0], half_exts=[[0.4, 0.4]],
                            mu_ground=0.5), {}, (), 150, None, None),
    "servo_push": (PUSH, {}, ((0, 1),), 400, (0.4, 0.0, 0.0), None),
    "servo_turn": (PUSH, {}, ((0, 1),), 300, (0.3, 0.1, 0.4), None),
    "traction_wall": (dict(poses=[[0.0, 0.0, 0.0], [0.8, 0.0, 0.0]],
                           vels=np.zeros((2, 3)), masses=[60.0, 1e7],
                           half_exts=[[0.45, 0.3], [0.3, 0.3]], mu_ground=5.0),
                      {}, ((0, 1),), 200, (1.0, 0.0, 0.0), None),
    "grasp_drag": (dict(poses=[[0.0, 0.0, 0.0], [0.9, 0.0, 0.0]],
                        vels=np.zeros((2, 3)), masses=[60.0, 12.0],
                        half_exts=[[0.45, 0.3], [0.3, 0.3]], mu_ground=0.4),
                   {}, ((0, 1),), 400, (-0.3, 0.05, 0.2), "on"),
    "grasp_capped": (dict(poses=[[0.0, 0.0, 0.0], [0.9, 0.0, 0.0]],
                          vels=np.zeros((2, 3)), masses=[60.0, 12.0],
                          half_exts=[[0.45, 0.3], [0.3, 0.3]], mu_ground=0.4),
                     dict(grasp_impulse_cap=50.0), ((0, 1),), 200,
                     (-0.6, 0.0, 0.5), "on"),
    "grasp_inactive": (dict(poses=[[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]],
                            vels=np.zeros((2, 3)), masses=[60.0, 12.0],
                            half_exts=[[0.45, 0.3], [0.3, 0.3]]),
                       {}, ((0, 1),), 20, (0.3, 0.0, 0.0), "off"),
    "grasp_no_pairs": (dict(poses=[[0.0, 0.0, 0.0], [0.9, 0.0, 0.0]],
                            vels=np.zeros((2, 3)), masses=[60.0, 12.0],
                            half_exts=[[0.45, 0.3], [0.3, 0.3]],
                            mu_ground=0.4),
                       {}, (), 100, (0.3, 0.0, 0.3), "on"),
    # an infinite-mass STATIC body struck by a sliding, spinning box
    "static_body": (dict(poses=[[0.0, 0.0, 0.3], [1.2, 0.1, 0.0]],
                         vels=[[2.0, 0.3, 1.0], [0.0, 0.0, 0.0]],
                         masses=[3.0, np.inf],
                         half_exts=[[0.4, 0.3], [0.5, 0.5]], mu_ground=0.3),
                    {}, ((0, 1),), 120, None, None),
}


def _grasp_args(kind, dtype_np):
    if kind is None:
        return None, None
    on = kind == "on"
    a, b = (np.asarray(v, dtype_np) for v in GRASP)
    gj = (jnp.asarray(on), 0, jnp.asarray(a), 1, jnp.asarray(b),
          jnp.asarray(True))
    gt = (torch.tensor(on), 0, torch.as_tensor(a), 1, torch.as_tensor(b),
          torch.tensor(True))
    return gj, gt


@partial(jax.jit, static_argnums=(1, 2, 3, 5))
def _jax_rollout(st, cfg, pairs, steps, v_cmd, servo, grasp):
    mask = jnp.asarray([True] + [False] * (st.mass.shape[0] - 1)) \
        if servo else None

    def step(st, _):
        w = (jp.servo_forces(st, 0, v_cmd, cfg) if servo
             else jnp.zeros_like(st.vel))
        st, dbg = jp.physics_substep(st, w, list(pairs), cfg, grasp=grasp,
                                     servo_mask=mask)
        return st, (st.pose, st.vel, dbg.pn, dbg.pt)
    _, outs = jax.lax.scan(step, st, None, length=steps)
    return outs


def _port_rollout(st, cfg, pairs, steps, v_cmd, grasp):
    mask = None
    if v_cmd is not None:
        mask = torch.tensor([True] + [False] * (st.mass.shape[1] - 1))
    outs = []
    for _ in range(steps):
        w = (tp.servo_forces(st, 0, v_cmd, cfg) if v_cmd is not None
             else torch.zeros_like(st.vel))
        st, dbg = tp.physics_substep(st, w, list(pairs), cfg, grasp=grasp,
                                     servo_mask=mask)
        outs.append((st.pose, st.vel, dbg.pn, dbg.pt))
    return [torch.stack(o, 1) for o in zip(*outs)]


def _both_rollouts(name, dtype_np):
    scene, ckw, pairs, steps, cmd, gkind = ROLLOUTS[name]
    fields = _bodies(**scene)
    jdt = jnp.float64 if dtype_np == np.float64 else jnp.float32
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    gj, gt = _grasp_args(gkind, dtype_np)
    cmd_np = np.asarray(cmd if cmd is not None else (0.0, 0.0, 0.0), dtype_np)
    ref = _jax_rollout(_jax_state(fields, jdt), jp.PhysicsConfig(**ckw),
                       pairs, steps, jnp.asarray(cmd_np), cmd is not None, gj)
    st = _port_state(fields, tdt)
    v_cmd = (torch.as_tensor(cmd_np).expand(st.pose.shape[0], 3)
             if cmd is not None else None)
    got = _port_rollout(st, tp.PhysicsConfig(**ckw), pairs, steps, v_cmd, gt)
    return [np.asarray(r) for r in ref], got


@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_substep_rollout_matches_jax_f64(name):
    ref, got = _both_rollouts(name, np.float64)
    for label, r, g in zip(("pose", "vel", "pn", "pt"), ref, got):
        g = g[0].numpy()
        assert np.all(np.isfinite(g)), label
        np.testing.assert_allclose(g, r, **F64, err_msg=label)
    if name == "static_body":
        # the static body never moves, and the box did reach it
        np.testing.assert_array_equal(got[0][0, :, 1].numpy(),
                                      np.broadcast_to([1.2, 0.1, 0.0],
                                                      (120, 3)))
        assert float(got[2].max()) > 0.0


@pytest.mark.parametrize("name", ["servo_push", "grasp_drag", "static_body",
                                  "oblique_friction"])
def test_substep_rollout_matches_jax_f32(name):
    ref, got = _both_rollouts(name, np.float32)
    np.testing.assert_allclose(got[0][0].numpy(), ref[0], rtol=0, atol=2e-5,
                               err_msg="pose")
    np.testing.assert_allclose(got[1][0].numpy(), ref[1], rtol=0, atol=2e-4,
                               err_msg="vel")


def test_servo_and_ground_friction_match_jax():
    rng = np.random.default_rng(5)
    fields = _bodies(rng.uniform(-1, 1, (3, 3)), rng.uniform(-2, 2, (3, 3)),
                     [60.0, 10.0, np.inf], [[0.45, 0.3], [0.3, 0.3],
                                            [0.5, 0.2]], 0.4)
    cfg = jp.PhysicsConfig()
    cmd = np.array([0.7, -0.2, 0.9])
    st_j, st_t = _jax_state(fields), _port_state(fields)
    np.testing.assert_allclose(
        tp.servo_forces(st_t, 0, torch.as_tensor(cmd)[None],
                        tp.PhysicsConfig())[0].numpy(),
        np.asarray(jp.servo_forces(st_j, 0, jnp.asarray(cmd), cfg)), **F64)
    for mask in (None, [True, False, False]):
        ref = jp.ground_friction(st_j, cfg, None if mask is None
                                 else jnp.asarray(mask))
        got = tp.ground_friction(st_t, tp.PhysicsConfig(), mask if mask is None
                                 else torch.tensor(mask))
        assert np.all(np.isfinite(got.numpy()))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), **F64)


def test_grasp_impulse_and_solve_match_jax():
    """One grasp pass and one full solve on a penetrating, moving pair."""
    fields = _bodies([[0.0, 0.0, 0.01], [0.74, 0.02, 0.0]],
                     [[0.4, 0.1, 0.2], [0.0, 0.0, 0.0]], [60.0, 15.0],
                     [[0.45, 0.3], [0.3, 0.3]], 0.4)
    st_j, st_t = _jax_state(fields), _port_state(fields)
    gj, gt = _grasp_args("on", np.float64)
    cfg_j, cfg_t = jp.PhysicsConfig(), tp.PhysicsConfig()
    ref = jp._grasp_impulse(st_j, st_j.vel, gj, cfg_j, 1.0 / st_j.mass,
                            1.0 / st_j.inertia)
    vel = tp._grasp_impulse(st_t, st_t.vel, gt, cfg_t, 1.0 / st_t.mass,
                            1.0 / st_t.inertia)
    np.testing.assert_allclose(vel[0].numpy(), np.asarray(ref), **F64)
    for g_j, g_t in ((None, None), (gj, gt)):
        v_ref, d_ref = jp.solve_contacts(st_j, [(0, 1)], cfg_j, grasp=g_j)
        v_got, d_got = tp.solve_contacts(st_t, [(0, 1)], cfg_t, grasp=g_t)
        np.testing.assert_allclose(v_got[0].numpy(), np.asarray(v_ref), **F64)
        np.testing.assert_allclose(d_got.pn[0].numpy(), np.asarray(d_ref.pn),
                                   **F64)
        np.testing.assert_allclose(d_got.pt[0].numpy(), np.asarray(d_ref.pt),
                                   **F64)
    assert float(d_got.pn.max()) == 0.0    # the weld pulls the pair apart
    assert float(jp.solve_contacts(st_j, [(0, 1)], cfg_j)[1].pn.max()) > 0.0


def test_batch_equals_each_lane_bit_for_bit():
    """16 docked pairs with a grasp, batched and one by one."""
    rng = np.random.default_rng(7)
    B = 16
    yaw = rng.uniform(-np.pi, np.pi, B)
    gap = rng.uniform(0.72, 0.78, B)
    poses = np.zeros((B, 2, 3))
    poses[:, 1, 0] = gap * np.cos(yaw)
    poses[:, 1, 1] = gap * np.sin(yaw)
    poses[:, :, 2] = yaw[:, None]
    he = np.broadcast_to([[0.45, 0.3], [0.3, 0.3]], (B, 2, 2))
    m = np.broadcast_to([60.0, 12.0], (B, 2))
    st = tp.BodyState(
        pose=torch.as_tensor(poses), vel=torch.zeros(B, 2, 3,
                                                     dtype=torch.float64),
        mass=torch.as_tensor(m.copy()),
        inertia=torch.as_tensor(m * (he[..., 0] ** 2 + he[..., 1] ** 2) / 3.0),
        half_ext=torch.as_tensor(he.copy()),
        box_off=torch.zeros(B, 2, 2, dtype=torch.float64),
        mu_ground=torch.full((B, 2), 0.4, dtype=torch.float64))
    cmd = torch.as_tensor(np.stack([rng.uniform(-0.5, 0.5, B),
                                    rng.uniform(-0.2, 0.2, B),
                                    rng.uniform(-0.5, 0.5, B)], -1))
    _, gt = _grasp_args("on", np.float64)
    cfg = tp.PhysicsConfig()
    full = _port_rollout(st, cfg, ((0, 1),), 30, cmd, gt)
    for b in (0, 5, 15):
        one = tp.BodyState(*(f[b:b + 1] for f in st))
        alone = _port_rollout(one, cfg, ((0, 1),), 30, cmd[b:b + 1], gt)
        for f, a in zip(full, alone):
            assert torch.equal(f[b:b + 1], a)


# ---------------------------------------------------------------------------
# the port on its own: tests/test_physics2d.py's physical invariants
# ---------------------------------------------------------------------------

def test_port_momentum_and_friction_cone():
    _, got = _both_rollouts("head_on", np.float64)
    fields = _bodies(**ROLLOUTS["head_on"][0])
    p0 = np.sum(fields["mass"][:, None] * fields["vel"][:, :2], axis=0)
    vel = got[1][0, -1].numpy()
    np.testing.assert_allclose(np.sum(fields["mass"][:, None] * vel[:, :2], 0),
                               p0, atol=1e-10)
    assert abs(vel[1, 0] - vel[0, 0]) < 1e-6
    _, got = _both_rollouts("oblique_friction", np.float64)
    pn, pt = got[2][0, 0].numpy(), np.abs(got[3][0, 0].numpy())
    assert np.all(pt <= 0.4 * pn + 1e-9) and pn.max() > 0


def test_port_sliding_box_stops_at_mu_g():
    st = _port_state(_bodies([[0.0, 0.0, 0.0]], [[2.0, 0.0, 0.0]], [5.0],
                             [[0.4, 0.4]], 0.5))
    cfg = tp.PhysicsConfig()
    vels = _port_rollout(st, cfg, (), 120, None, None)[1][0, :, 0, 0].numpy()
    stop_idx = int(np.argmax(vels < 1e-6))
    assert abs(stop_idx * cfg.dt - 2.0 / (0.5 * tp.GRAV)) < 0.02
    assert np.all(vels >= -1e-12)
    assert abs((vels[0] - vels[40]) / (40 * cfg.dt) - 0.5 * tp.GRAV) < 0.05


def test_port_grasp_weld_drags_object():
    _, got = _both_rollouts("grasp_drag", np.float64)
    pose = got[0][0, -1].numpy()
    assert pose[1, 0] < 0.5
    c0, s0 = np.cos(pose[0, 2]), np.sin(pose[0, 2])
    c1, s1 = np.cos(pose[1, 2]), np.sin(pose[1, 2])
    gap = (pose[1, :2] + np.array([-0.3 * c1, -0.3 * s1])) \
        - (pose[0, :2] + np.array([0.6 * c0, 0.6 * s0]))
    assert np.linalg.norm(gap) < 0.02
