"""The port's ESDF held to the compiled reference SDFmap's goldens
(tests/golden/esdf: `boxes`, `single`), port only, on the CPU, with
tests/test_esdf_parity.py's tolerances.

* `ops/esdf.py::esdf_from_occupancy` (float32, the port's only field
  dtype) on the oracle's grids of unknown / free / occupied cells,
  within 1e-5 m of the oracle's `updateESDF2d` field on the written
  region (the reference never writes the last row and column of its
  update window: they keep DBL_MAX).
* The golden exercises the unknown-cell rule: unknown cells are free in
  the positive pass (their distances are not negative) and sources of
  the negative pass.
* `sample_dist_grad_bilinear` at the oracle's queries (float32, out of
  map 100): distance within 1e-5, gradient within 1e-4, out-of-map
  queries exactly 100 with a zero gradient; queries whose stencil
  touches the unwritten row or column are skipped, as in JAX.
"""
import numpy as np
import pytest
import torch

from alore_legged_manipulator_tpu_torch.ops.esdf import (
    esdf_from_occupancy, sample_dist_grad_bilinear)
from tests import torch_golden_io as gio

torch.set_num_threads(1)
DBL_MAX = np.finfo(np.float64).max


def field(kind, device="cpu"):
    states, lower, res, gold, queries, gold_b = gio.esdf_case(kind)
    esdf = esdf_from_occupancy(
        torch.as_tensor(states == gio.OCC, device=device),
        torch.as_tensor(lower, dtype=torch.float32), res)
    return esdf, states, lower, res, gold, queries, gold_b


def field_checks(kind, device="cpu"):
    esdf, _, _, _, gold, _, _ = field(kind, device)
    assert esdf.dist.dtype == torch.float32
    assert np.all(gold[-1, :] == DBL_MAX)
    assert np.all(gold[:, -1] == DBL_MAX)
    ours = esdf.dist.to(torch.float64).cpu().numpy()
    return [gio.deviation(f"{kind} field", ours[:-1, :-1], gold[:-1, :-1],
                          1e-5)]


@pytest.mark.parametrize("kind", gio.ESDF_CASES)
def test_distance_field_matches_reference(kind):
    gio.assert_checks(field_checks(kind))


def test_unknown_cells_are_negative_pass_sources():
    esdf, states, _, _, gold, _, _ = field("boxes")
    assert (states == gio.UNKNOWN).any() and (states == gio.OCC).any()
    unk = (states == gio.UNKNOWN)[:-1, :-1]
    assert np.all(gold[:-1, :-1][unk] >= 0.0)
    assert np.all(esdf.dist.numpy()[:-1, :-1][unk] >= 0.0)


def bilinear_checks(kind, device="cpu"):
    """Distance and gradient at the compared queries; out-of-map queries
    must come back as exactly 100 with a zero gradient."""
    esdf, states, lower, res, _, queries, gold_b = field(kind, device)
    nx, ny = states.shape
    pos = torch.as_tensor(queries, dtype=torch.float32, device=device)[None]
    d, g = sample_dist_grad_bilinear(esdf, pos, out_value=100.0)
    d = d[0].to(torch.float64).cpu().numpy()
    g = g[0].to(torch.float64).cpu().numpy()
    keep = []
    for i, ((px, py), gd) in enumerate(zip(queries, gold_b[:, 0])):
        ix = int((px - lower[0]) / res - 0.5)
        iy = int((py - lower[1]) / res - 0.5)
        if gd == 100.0:
            assert d[i] == 100.0 and np.all(g[i] == 0.0), (px, py, d[i], g[i])
        elif ix + 1 < nx - 1 and iy + 1 < ny - 1:
            keep.append(i)
    assert keep
    return [gio.deviation(f"{kind} bilinear distance", d[keep],
                          gold_b[keep, 0], 1e-5),
            gio.deviation(f"{kind} bilinear gradient", g[keep],
                          gold_b[keep, 1:], 1e-4)]


@pytest.mark.parametrize("kind", gio.ESDF_CASES)
def test_bilinear_matches_reference(kind):
    gio.assert_checks(bilinear_checks(kind))
