"""Port parity: the training runner (`rl/runner.py`) on the contact
plant, alone and with the frozen low-level WBC in the loop.

The harness of `tests/test_torch_runner.py`: one whole iteration of the
JAX package's `train` at float64 against the port's with the JAX
package's draws injected (initial states, action noise, fresh episodes,
permutations); `tip_vel_limit` 0.2 m/s so that some lanes finish and
are reset.  Held: every rollout tensor and the last value within 1e-9,
every parameter after the update within 1e-8, the metrics to 1e-9
relative (the tied contact order of ROADMAP.md section 3 did not show).
"""
import pytest

from tests.test_torch_runner import run_both


@pytest.mark.parametrize("hier", [False, True], ids=["physics",
                                                     "physics_wbc"])
def test_iteration_matches_jax(hier, monkeypatch):
    run_both(True, hier, 0.2, monkeypatch)
