"""Port parity: the entry point (`alore_legged_manipulator_tpu_torch/entry.py`)
against the JAX one (`__graft_entry__.py`).

* The example arguments equal JAX `entry()`'s bit for bit (float32), and
  the same draws at float64 equal tests/test_torch_nmpc.py's
  `_entry_inputs()`.
* `fn` on those arguments equals JAX's jitted `fn` within 1e-9 at
  float64 and 1e-4 at float32 (tests/test_torch_nmpc.py's tolerances for
  the same tick).
* `entry()` defaults to the card: without one it raises.
* `main` prints the tick's shape as the JAX entry does, then runs the
  dry run through `parallel/dryrun.py` (its programs are held by
  tests/test_torch_parallel.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from alore_legged_manipulator_tpu_torch import entry as tentry
from tests.test_torch_nmpc import _entry_inputs

torch.set_num_threads(1)


def test_example_args_equal_jax():
    _, jargs = jentry.entry()
    _, targs = tentry.entry(device="cpu")
    assert len(targs) == len(jargs) == 5
    for j, t in zip(jargs, targs):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert j.dtype == jnp.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for a, t in zip(_entry_inputs(),
                    tentry.entry_inputs(dtype=torch.float64, device="cpu")):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9),
                                       (np.float32, 1e-4)])
def test_fn_matches_jax(dtype, tol):
    jfn, _ = jentry.entry()
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tfn, targs = tentry.entry(device="cpu", dtype=tdtype)
    ref = jax.jit(jfn)(*[jnp.asarray(a.numpy()) for a in targs])
    got = tfn(*targs)
    assert got.shape == (64, 2) and got.dtype == tdtype
    assert np.asarray(ref).dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=tol)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tentry.entry()
    with pytest.raises(RuntimeError):
        tentry.main([])


def test_main_runs_the_tick_then_the_dry_run(monkeypatch, capsys):
    """`python -m ...entry --device cpu` prints the tick's shape as the
    JAX entry does, then hands the dry run to `parallel/dryrun.py` (one
    gloo rank on the CPU, as the JAX entry's CPU run has one device)."""
    from alore_legged_manipulator_tpu_torch.parallel import dryrun
    calls = []
    monkeypatch.setattr(dryrun, "main", lambda argv: calls.append(argv) or 0)
    assert tentry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == "entry OK: (64, 2)\n"
    tentry.dryrun_multichip(4)
    assert calls == [["--ranks", "1", "--device", "cpu"],
                     ["--ranks", "4", "--device", "cuda"]]
