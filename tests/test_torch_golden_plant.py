"""The port's plant held to the compiled reference simulator's goldens
(tests/golden/plant: `cruise`, `reverse_switch`, `saturating`), port
only, on the CPU, with tests/test_plant_parity.py's tolerances: every
tick of `world/plant.py::plant_step` (noise off, 500 Hz, the rate
limiter on the 100 Hz pose interval) within 1e-12 at float64 and 5e-4
at float32, columns x, y, theta, v, omega, vy, s.
"""
import pytest
import torch

from alore_legged_manipulator_tpu_torch.core.dynamics import ICRParams
from alore_legged_manipulator_tpu_torch.world.plant import (PlantConfig,
                                                            plant_init,
                                                            plant_step)
from tests import torch_golden_io as gio

torch.set_num_threads(1)


def replay(params, cmds, dtype, device="cpu"):
    """The golden's command script through plant_step, (T, 7) rows."""
    sx, sy, syaw, max_a, max_dw, yr, yl, xv = params
    icr = ICRParams(yr=yr, yl=yl, xv=xv)
    cfg = PlantConfig(max_acc=max_a, max_domega=max_dw, rate_limit_dt=0.01,
                      add_noise=False)
    dt = torch.tensor(1.0 / 500.0, dtype=dtype, device=device)
    st = plant_init(torch.tensor([[sx, sy, syaw]], dtype=dtype,
                                 device=device), dtype)
    rows = []
    for vl, vr, n in cmds:
        cmd = torch.tensor([[vl, vr]], dtype=dtype, device=device)
        for _ in range(n):
            st = plant_step(st, cmd, icr, dt, cfg)
            rows.append(torch.cat([st.xytheta[0], st.v, st.omega, st.vy,
                                   st.s]))
    return torch.stack(rows).to(torch.float64).cpu().numpy()


ATOL = {torch.float64: 1e-12, torch.float32: 5e-4}


def plant_checks(name, dtype, device="cpu"):
    params, cmds, gold = gio.plant_case(name)
    return [gio.deviation(f"{name} {str(dtype)[6:]}",
                          replay(params, cmds, dtype, device), gold[:, :7],
                          ATOL[dtype])]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", gio.PLANT_CASES)
def test_plant_matches_reference_oracle(name, dtype):
    gio.assert_checks(plant_checks(name, dtype))
