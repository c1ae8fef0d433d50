"""Port parity: the JPS front end, its native build, and the grid map.

* The port's `native/jps.cpp` equals the JAX package's byte for byte,
  and `jps_search` returns the JAX package's paths cell for cell on every
  query of the reference goldens (tests/golden/jps); held to the
  goldens' optimal costs as tests/test_jps_parity.py holds JAX.
* `jps_search` raises RuntimeError when g++ is missing (no A* fallback,
  which would return another path of equal cost); `_astar_fallback`
  stays the plain search whose costs JPS is held to.
* The sampling stages replayed on the reference's raw paths
  (tests/golden/kino, as tests/test_kino_parity.py replays them): pruned
  path exact, time allocation within 1e-9 (float64).
* `plan_frontend` against JAX at float64 on seeded maps: every FlatTraj
  field within 1e-12, with and without piece buckets, a replan start
  path (stitched or not), truncation, and a failed search.
* The pruning, trapezoid and coordinate helpers against JAX.
* `paint_rect` / `paint_circle` against JAX cell for cell;
  `random_boxes` draws from a torch.Generator.
"""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.planner import frontend as jf
from alore_legged_manipulator_tpu.world import grid_map as jg
from alore_legged_manipulator_tpu_torch import native as tnative
from alore_legged_manipulator_tpu_torch.planner import frontend as tf
from alore_legged_manipulator_tpu_torch.world import grid_map as tg
from tests.test_jps_parity import GOLDEN as JPS_GOLDEN
from tests.test_jps_parity import _load_grid, _load_results, _octile_cost
from tests.test_kino_parity import SETS as KINO_SETS
from tests.test_kino_parity import _load as _load_kino

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_jps_source_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(REPO, "alore_legged_manipulator_tpu", "native",
                           "jps.cpp"), "rb") as f:
        ref = f.read()
    assert tnative.SRC.read_bytes() == ref


def test_jps_builds_into_build_dir():
    so = tnative.build()
    assert so.exists() and so.parent.parent.name == "build"
    assert so.parent.name.startswith("jps-")
    assert tnative.load_jps() is tnative.load_jps()


def test_jps_search_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tf.jps_search(np.zeros((8, 8), np.uint8), (1, 1), (6, 6))


@pytest.mark.parametrize("kind", ["boxes", "corridor", "dense"])
def test_jps_identical_to_jax_and_golden_costs(kind):
    _, dist = _load_grid(os.path.join(JPS_GOLDEN, f"{kind}_grid.bin"))
    queries = np.loadtxt(os.path.join(JPS_GOLDEN, f"{kind}_queries.txt"))
    results = _load_results(os.path.join(JPS_GOLDEN, f"{kind}_results.txt"))
    assert len(queries) == len(results)
    for (sx, sy, gx, gy, safe, _), (found, ref_cost, _) in zip(queries,
                                                              results):
        blocked = (dist < safe).astype(np.uint8)
        s, g = (int(sx), int(sy)), (int(gx), int(gy))
        got = tf.jps_search(blocked, s, g)
        ref = jf.jps_search(blocked, s, g)
        assert (got is None) == (ref is None) == (not found)
        if got is None:
            continue
        np.testing.assert_array_equal(got, ref)
        assert tuple(got[0]) == s and tuple(got[-1]) == g
        assert abs(_octile_cost(got) - ref_cost) < 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_jps_cost_equals_plain_astar(seed):
    rng = np.random.default_rng(seed)
    g = rng.random((60, 60)) < 0.12
    g[:2, :] = g[-2:, :] = g[:, :2] = g[:, -2:] = False
    jps = tf.jps_search(g.astype(np.uint8), (2, 2), (57, 57))
    ast = tf._astar_fallback(g, (2, 2), (57, 57))
    assert (jps is None) == (ast is None)
    if jps is not None:
        assert abs(_octile_cost(jps) - _octile_cost(np.asarray(ast))) < 1e-9
        for a, b in zip(jps[:-1], jps[1:]):
            assert not any(g[c] for c in tf._bresenham(a, b))


@pytest.mark.parametrize("name", KINO_SETS)
def test_sampling_matches_reference_oracle(name):
    grid, dist, lower, res, prof, queries, results = _load_kino(name)
    (safe_dis, _, dw, yw, cutlen, mv, ma, _, _, tres, mintraj, _) = prof
    cfg = tf.FrontendConfig(safe_dis=safe_dis, distance_weight=dw,
                            yaw_weight=yw, traj_cut_length=cutlen,
                            max_vel=mv, max_acc=ma, sample_time=tres,
                            min_traj_num=int(mintraj), piece_buckets=())

    def cell_d(p):
        ix = min(max(int((p[0] - lower[0]) / res), 0), grid.shape[0] - 1)
        iy = min(max(int((p[1] - lower[1]) / res), 0), grid.shape[1] - 1)
        return dist[ix, iy]

    for (s, g, _, sp, vaj, oaj), ref in zip(queries, results):
        search_start = np.asarray(sp[-1][:2] if sp else s[:2])
        safe = max(min(safe_dis, cell_d(search_start) * 0.8), 0.0)
        safe = max(min(safe, cell_d(g) * 0.8), 0.0)
        blocked = dist < safe
        pruned = tf.remove_corner_pts(ref["raw"], blocked, lower, res)
        np.testing.assert_array_equal(np.asarray(pruned), ref["pruned"])
        start_eff = np.asarray(sp[0][:3] if sp else s)
        states = tf.sample_states([np.asarray(p) for p in pruned], start_eff,
                                  g[2])
        ft = tf.build_flat_traj(states, start_eff, np.asarray(vaj),
                                np.asarray(oaj), cfg, dtype=torch.float64,
                                device="cpu")
        assert ft.inner_yaw_s.shape == (1, 2, ref["n"])
        assert float(ft.init_piece_time[0]) == pytest.approx(ref["init_t"],
                                                             rel=1e-12)
        assert bool(ft.if_cut[0]) == bool(ref["if_cut"])
        np.testing.assert_allclose(ft.inner_yaw_s[0].numpy().T,
                                   ref["triples"][:, :2], atol=1e-9)
        pos = ft.inner_positions[0].numpy()
        np.testing.assert_allclose(pos[:-1], ref["positions"], atol=1e-9)
        np.testing.assert_allclose(pos[-1], ref["final_xyt"], atol=1e-9)
        np.testing.assert_allclose(ft.start_state[0].numpy(),
                                   ref["start_state"], atol=1e-12)
        np.testing.assert_allclose(ft.final_state[0].numpy(),
                                   ref["final_state"], atol=1e-9)


def _seeded_dist(seed, h=70, w=70):
    from alore_legged_manipulator_tpu_torch.ops.esdf import (
        esdf_from_occupancy)
    rng = np.random.default_rng(seed)
    occ = torch.zeros((h, w), dtype=torch.bool)
    for _ in range(5):
        x, y = rng.integers(8, h - 16), rng.integers(8, w - 16)
        occ[x:x + rng.integers(3, 10), y:y + rng.integers(3, 10)] = True
    return esdf_from_occupancy(occ, torch.zeros(2), 0.1).dist.numpy()


# (seed, start, goal, cfg kwargs, start_path)
FRONTEND_CASES = {
    "buckets": (0, (0.5, 0.5, 0.3), (6.5, 6.2, 1.0), {}, None),
    "exact_pieces": (1, (0.6, 6.0, -0.5), (6.4, 0.7, 0.0),
                     dict(piece_buckets=()), None),
    "cut": (2, (0.5, 0.5, 0.0), (6.5, 6.5, 0.0),
            dict(traj_cut_length=3.0), None),
    "start_path": (3, (1.0, 1.0, 0.0), (6.0, 5.0, 0.5), {},
                   [(1.0, 1.0, 0.0), (1.8, 1.2, 0.2)]),
    "stitched": (3, (1.0, 1.0, 0.0), (6.0, 5.0, 0.5),
                 dict(stitch_full_path=True, piece_buckets=()),
                 [(1.0, 1.0, 0.0), (1.5, 1.0, 0.0), (1.8, 1.6, 1.2)]),
    "moving_start": (4, (0.7, 3.5, 0.0), (6.3, 3.5, 3.0), {}, None),
}


@pytest.mark.parametrize("case", sorted(FRONTEND_CASES))
def test_plan_frontend_matches_jax_f64(case):
    seed, start, goal, kw, sp = FRONTEND_CASES[case]
    dist = _seeded_dist(seed)
    vaj = (0.4, 0.1, 0.0) if case == "moving_start" else (0.0, 0.0, 0.0)
    oaj = (0.1, 0.0, 0.0) if case == "moving_start" else (0.0, 0.0, 0.0)
    ref = jf.plan_frontend(dist, (0.0, 0.0), 0.1, start, goal,
                           jf.FrontendConfig(**kw), vaj, oaj,
                           dtype=jnp.float64, start_path=sp)
    got = tf.plan_frontend(dist, (0.0, 0.0), 0.1, start, goal,
                           tf.FrontendConfig(**kw), vaj, oaj,
                           dtype=torch.float64, start_path=sp, device="cpu")
    assert ref is not None and got is not None
    assert got.num_pieces == ref.num_pieces
    for name, a, b in zip(ref._fields, ref, got):
        assert b.shape == (1, *np.shape(a)), name
        assert b.device.type == "cpu"
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12, err_msg=name)
    if case == "cut":
        assert bool(got.if_cut[0])


def test_plan_frontend_no_path_and_default_device(monkeypatch):
    dist = np.full((40, 40), 2.0)
    dist[:, 20] = -0.1
    assert tf.plan_frontend(dist, (0.0, 0.0), 0.1, (2.0, 0.5, 0.0),
                            (2.0, 3.5, 0.0), device="cpu") is None
    assert jf.plan_frontend(dist, (0.0, 0.0), 0.1, (2.0, 0.5, 0.0),
                            (2.0, 3.5, 0.0)) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tf.plan_frontend(np.full((40, 40), 2.0), (0.0, 0.0), 0.1,
                         (0.5, 0.5, 0.0), (3.0, 3.0, 0.0))


def test_helpers_match_jax():
    rng = np.random.default_rng(9)
    blocked = rng.random((30, 30)) < 0.2
    for _ in range(20):
        a, b = rng.integers(0, 30, 2), rng.integers(0, 30, 2)
        assert tf._bresenham(a, b) == jf._bresenham(a, b)
        p, q = rng.uniform(0, 3, 2), rng.uniform(0, 3, 2)
        assert tf._line_collides(blocked, (0.0, 0.0), 0.1, p, q) == \
            jf._line_collides(blocked, (0.0, 0.0), 0.1, p, q)
        np.testing.assert_array_equal(tf.world_to_grid(p, (0.05, 0.0), 0.1),
                                      jf.world_to_grid(p, (0.05, 0.0), 0.1))
        np.testing.assert_array_equal(tf.grid_to_world(a, (0.05, 0.0), 0.1),
                                      jf.grid_to_world(a, (0.05, 0.0), 0.1))
    path = [rng.uniform(0, 3, 2) for _ in range(9)]
    np.testing.assert_array_equal(
        np.asarray(tf.remove_corner_pts(path, blocked, (0.0, 0.0), 0.1)),
        np.asarray(jf.remove_corner_pts(path, blocked, (0.0, 0.0), 0.1)))
    np.testing.assert_array_equal(tf.sample_states(path, (0.0, 0.0, 0.2), 1.0),
                                  jf.sample_states(path, (0.0, 0.0, 0.2), 1.0))
    for L, v0 in [(10.0, 0.0), (3.0, 1.5), (0.5, 2.0), (30.0, 0.5)]:
        T = tf.evaluate_duration(L, v0, 0.0, 3.0, 2.0)
        assert T == jf.evaluate_duration(L, v0, 0.0, 3.0, 2.0)
        for t in np.linspace(0.0, T, 7):
            assert tf.evaluate_length(t, L, v0, 0.0, 3.0, 2.0) == \
                jf.evaluate_length(t, L, v0, 0.0, 3.0, 2.0)


# ---------------------------------------------------------------------------
# grid map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lower", [(0.0, 0.0), (-2.05, 0.35)])
def test_paint_matches_jax(lower):
    occ = np.zeros((50, 40), bool)
    occ[10:14, 5:30] = True
    rects = [((2.5, 2.0), (0.5, 0.5), 0.0, True),
             ((0.25, 1.05), (1.2, 0.4), 0.7, True),
             ((1.0, 2.5), (0.6, 0.6), 0.0, False),
             ((2.25, 3.25), (1.0, 0.5), 2.9, True)]
    ref, got = jnp.asarray(occ), torch.as_tensor(occ)
    for center, size, yaw, value in rects:
        ref = jg.paint_rect(ref, jnp.asarray(lower, jnp.float32), 0.1,
                            np.asarray(center, float), size, yaw, value)
        got = tg.paint_rect(got, torch.tensor(lower, dtype=torch.float32),
                            0.1, torch.tensor(center, dtype=torch.float64),
                            size, yaw, value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = jg.paint_circle(ref, jnp.asarray(lower, jnp.float32), 0.1,
                          np.asarray((1.5, 1.5)), 0.45)
    got = tg.paint_circle(got, torch.tensor(lower, dtype=torch.float32), 0.1,
                          torch.tensor((1.5, 1.5), dtype=torch.float64), 0.45)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < got.numel()


def test_make_occupancy_and_random_boxes(monkeypatch):
    occ = tg.make_occupancy(60, 50, device="cpu")
    assert occ.shape == (60, 50) and occ.dtype == torch.bool
    assert not bool(occ.any())
    gen = torch.Generator().manual_seed(4)
    a = tg.random_boxes(gen, occ, (0.0, 0.0), 0.1, 4)
    b = tg.random_boxes(torch.Generator().manual_seed(4), occ, (0.0, 0.0),
                        0.1, 4)
    assert torch.equal(a, b)
    assert 0 < int(a.sum()) < a.numel() // 2
    # box centers stay 1 m inside the map and boxes reach at most
    # 0.85 m from their centers: the border rows and columns stay free
    assert not (a[0].any() or a[-1].any() or a[:, 0].any()
                or a[:, -1].any())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tg.make_occupancy(4, 4)


def test_pcd_reader_matches_jax(tmp_path):
    path = tmp_path / "pts.pcd"
    path.write_text("VERSION .7\nFIELDS x y z\nPOINTS 3\nDATA ascii\n"
                    "0.05 0.05 0\n1.23 0.41 0\n9.0 9.0 0\n")
    got = tg.occupancy_from_pcd(str(path), (0.0, 0.0), 0.1, (20, 20))
    ref = jg.occupancy_from_pcd(str(path), (0.0, 0.0), 0.1, (20, 20))
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 2
