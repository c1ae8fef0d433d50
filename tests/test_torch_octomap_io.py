"""Port parity: OctoMap .bt / .ot interchange (`world/octomap_io.py`).

* the port's files are byte for byte the JAX package's, from numpy grids
  and from tensors, with and without per-voxel log-odds;
* each package reads the other's files into the same boxes and grids;
* tests/test_octomap_io.py's self round trips on the port, and a
  `VoxelMapState` from the port's `insert_point_cloud` written with
  `write_voxel_map` and read back;
* interop with the real octomap library (the oracle of
  tests/golden/octomap_oracle): skipped, as tests/test_octomap_io.py's
  oracle tests are, where the reference tree or a compiler is absent.
"""
import subprocess

import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu.world import octomap_io as jo
from alore_legged_manipulator_tpu_torch.convert import from_jax_numpy
from alore_legged_manipulator_tpu_torch.world import octomap_io as to
from alore_legged_manipulator_tpu_torch.world import voxel_map as vm
from tests.test_octomap_io import (LOWER, ORACLE, RES, SHAPE,
                                   _dense_from_oracle_dump, _ensure_oracle,
                                   _map)


def _log_odds(occ, seed=3):
    rng = np.random.default_rng(seed)
    return np.where(occ, rng.uniform(0.5, 2.0, SHAPE),
                    rng.uniform(-2.0, -0.5, SHAPE)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_files_byte_equal_jax(tmp_path, seed, as_tensor):
    occ, known = _map(seed)
    lo = _log_odds(occ, seed)
    conv = torch.as_tensor if as_tensor else (lambda x: x)
    to.write_bt(tmp_path / "p.bt", conv(occ), conv(known), conv(LOWER), RES)
    jo.write_bt(tmp_path / "j.bt", occ, known, LOWER, RES)
    to.write_ot(tmp_path / "p.ot", conv(occ), conv(known), conv(LOWER), RES)
    jo.write_ot(tmp_path / "j.ot", occ, known, LOWER, RES)
    to.write_ot(tmp_path / "pl.ot", conv(occ), conv(known), conv(LOWER), RES,
                log_odds=conv(lo))
    jo.write_ot(tmp_path / "jl.ot", occ, known, LOWER, RES, log_odds=lo)
    for a, b in (("p.bt", "j.bt"), ("p.ot", "j.ot"), ("pl.ot", "jl.ot")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes(), a


@pytest.mark.parametrize("ext", ["bt", "ot"])
def test_each_reads_the_others(tmp_path, ext):
    occ, known = _map(2)
    lo = _log_odds(occ, 2) if ext == "ot" else None
    kw = {} if lo is None else {"log_odds": lo}
    getattr(to, f"write_{ext}")(tmp_path / f"p.{ext}", occ, known, LOWER,
                                RES, **kw)
    getattr(jo, f"write_{ext}")(tmp_path / f"j.{ext}", occ, known, LOWER,
                                RES, **kw)
    for path in (tmp_path / f"p.{ext}", tmp_path / f"j.{ext}"):
        a = getattr(to, f"read_{ext}")(path)
        b = getattr(jo, f"read_{ext}")(path)
        assert a.res == b.res and len(a.boxes) == len(b.boxes)
        for (ka, sa, oa, la), (kb, sb, ob, lb) in zip(a.boxes, b.boxes):
            np.testing.assert_array_equal(ka, kb)
            assert (sa, oa, la) == (sb, ob, lb)
        for t in (a, from_jax_numpy(b)):
            o2, k2 = t.to_dense(LOWER, SHAPE)
            np.testing.assert_array_equal(k2, known)
            np.testing.assert_array_equal(o2, occ)


@pytest.mark.parametrize("seed", [0, 7])
def test_self_roundtrip(tmp_path, seed):
    occ, known = _map(seed)
    for ext in ("bt", "ot"):
        f = tmp_path / f"m.{ext}"
        getattr(to, f"write_{ext}")(f, occ, known, LOWER, RES)
        t = getattr(to, f"read_{ext}")(f)
        assert abs(t.res - RES) < 1e-12
        occ2, known2 = t.to_dense(LOWER, SHAPE)
        np.testing.assert_array_equal(known2, known)
        np.testing.assert_array_equal(occ2, occ)


def test_ot_log_odds_roundtrip(tmp_path):
    occ, known = _map(3)
    lo = _log_odds(occ)
    to.write_ot(tmp_path / "m.ot", occ, known, LOWER, RES, log_odds=lo)
    key0 = np.floor(LOWER / RES + 0.5).astype(int) + 32768
    for kmin, size, is_occ, val in to.read_ot(tmp_path / "m.ot").boxes:
        if size == 1:
            idx = tuple(np.asarray(kmin) - key0)
            assert abs(val - lo[idx]) < 1e-6 and is_occ == bool(occ[idx])


def test_voxel_map_state_roundtrip(tmp_path):
    """A map fused from a point cloud through the port's voxel map,
    written as .bt and .ot and read back to its own grids."""
    shape = (20, 16, 8)
    lower = np.array([0.0, -0.8, 0.0])
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0.5, 1.8, 200), rng.uniform(-0.6, 0.6, 200),
                    rng.uniform(0.1, 0.7, 200)], 1)
    st = vm.voxel_map_init(shape, device="cpu")
    st = vm.insert_point_cloud(st, lower, RES, np.array([0.05, 0.0, 0.4]),
                               torch.as_tensor(pts, dtype=torch.float32),
                               max_range=3.0)
    occ = vm.occupied_mask(st).numpy()
    assert occ.any() and (st.known.numpy() & ~occ).any()
    to.write_voxel_map(tmp_path / "m.bt", st, lower, RES)
    to.write_voxel_map(tmp_path / "m.ot", st, lower, RES)
    for t in (to.read_bt(tmp_path / "m.bt"), to.read_ot(tmp_path / "m.ot")):
        o2, k2 = t.to_dense(lower, shape)
        np.testing.assert_array_equal(k2, st.known.numpy())
        np.testing.assert_array_equal(o2, occ)
    with pytest.raises(ValueError, match="bt or .ot"):
        to.write_voxel_map(tmp_path / "m.txt", st, lower, RES)


def _oracle():
    if not _ensure_oracle():
        pytest.skip("octomap oracle unavailable (no reference tree / "
                    "compiler)")


@pytest.mark.parametrize("ext", ["bt", "ot"])
def test_real_octomap_reads_port_files(tmp_path, ext):
    _oracle()
    occ, known = _map(0 if ext == "bt" else 1)
    f = tmp_path / f"ours.{ext}"
    getattr(to, f"write_{ext}")(f, occ, known, LOWER, RES)
    out = subprocess.run([str(ORACLE), "read" if ext == "bt" else "readot",
                          str(f)], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    o_occ, o_known = _dense_from_oracle_dump(out.stdout)
    assert np.array_equal(o_known, known)
    assert np.array_equal(o_occ & known, occ)


def test_port_reads_real_octomap_files(tmp_path):
    _oracle()
    occ, known = _map(2)
    idx = np.argwhere(known)
    centers = LOWER[None, :] + (idx + 0.5) * RES
    flags = occ[known].astype(int)
    stdin = f"{RES} {len(idx)}\n" + "\n".join(
        f"{c[0]:.9f} {c[1]:.9f} {c[2]:.9f} {o}"
        for c, o in zip(centers, flags))
    btf, otf = tmp_path / "ref.bt", tmp_path / "ref.ot"
    out = subprocess.run([str(ORACLE), "make", str(btf), str(otf)],
                         input=stdin, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    for reader, path in ((to.read_bt, btf), (to.read_ot, otf)):
        occ2, known2 = reader(path).to_dense(LOWER, SHAPE)
        assert np.array_equal(known2, known)
        assert np.array_equal(occ2, occ)
