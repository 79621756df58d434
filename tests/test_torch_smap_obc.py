"""roms_tpu_torch.parallel on the CPU: blocked runs through the open
boundaries, wetting-drying, boundary data, volume conservation and an
uneven split against one block (tests/test_smap.py and
tests/test_partition_invariance.py), and the uneven split against
roms_tpu's 2 x 4 partitioned state in tests/data/torch_nesting_small.npz.

roms_tpu's partition test runs UPWELLING 26 x 26 x 4 at ndtfast 6, which
blows up after 3 steps in both packages (its assert_allclose holds NaN
equal to NaN); ndtfast 15 here keeps the five steps finite."""

import numpy as np
import torch

from roms_tpu_torch.config import Config, LBC, BC_RADIATION
from roms_tpu_torch.grid import build_grid
from roms_tpu_torch.models import cases
from roms_tpu_torch.ops import bc as bc_mod
from roms_tpu_torch.parallel import smap
from roms_tpu_torch.state import initial_state
from chip_smoke import nesting_fixture_script
from test_torch_smap import blocked_against_one

torch.set_num_threads(1)

fx = nesting_fixture_script()


def test_smap_radiation_obc_wetdry():
    """Radiation open boundaries and wetting-drying on 2 x 4 blocks: the
    obc.py ring writes and the wet/dry masks are edge-gated; the result
    equals one block's."""
    rad = LBC(west=BC_RADIATION, east=BC_RADIATION)
    cfg = Config(
        name="smap_rad", Lm=24, Mm=16, N=4, ntracers=2,
        ew_periodic=False, ns_periodic=False,
        dt=60.0, ndtfast=10, solve3d=True,
        vtransform=2, vstretching=4, theta_s=0.0, theta_b=0.0,
        tcline=1.0e16, uv_adv=True, uv_cor=False,
        bottom_drag="linear", rdrg=3.0e-4,
        vmix="none", eos="linear", Tcoef=0.0, Scoef=0.0,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        lbc_zeta=rad, lbc_ubar=rad, lbc_vbar=rad,
        lbc_u=rad, lbc_v=rad, lbc_t=rad,
        wetdry=True, dcrit=0.1, dtype="float64")
    grid, cfg = build_grid(
        cfg, Xsize=24.0e3, Esize=16.0e3, f0=0.0, beta=0.0,
        depth_fn=lambda x, y, i, j, c: 5.0 + 95.0 * x / 24.0e3,
        device="cpu")
    x = grid.xr - 12.0e3
    y = grid.yr - 8.0e3
    zeta0 = bc_mod.fill_halo(
        cfg, 0.2 * torch.exp(-(x ** 2 + y ** 2) / (3.0e3 ** 2)))
    t0 = torch.stack(
        [torch.full((cfg.N, cfg.ny_tot, cfg.nx_tot), 17.0,
                    dtype=torch.float64),
         torch.full((cfg.N, cfg.ny_tot, cfg.nx_tot), 35.0,
                    dtype=torch.float64)])
    s0 = initial_state(cfg, device="cpu", zeta=zeta0, t=t0)
    _, _, err = blocked_against_one(cfg, grid, s0, None, 4)
    assert all(e <= 1e-11 for e in err.values()), err


def test_smap_tidal_bry_volcons():
    """KELVIN's tidal boundary data (bry lines built from the grid
    argument) and OBC volume conservation (face integrals summed over all
    blocks) on 2 x 4 blocks equal one block."""
    cfg, grid, s0, ffn = cases.kelvin(
        cases.kelvin_config(Lm=24, Mm=16, N=4, dt=300.0, ndtfast=20),
        device="cpu")
    cfg = cfg.replace(volcons=("west", "east"))
    _, _, err = blocked_against_one(cfg, grid, s0, ffn, 3)
    assert all(e <= 1e-11 for e in err.values()), err


def test_partition_invariance_uneven_blocks():
    """UPWELLING 26 x 26 x 4 on 2 x 4 blocks of 13 x (7, 7, 6, 6) points:
    one block's result, and roms_tpu's on its 2 x 4 mesh."""
    cfg, grid, s0, ffn = fx.upwelling_case(fx.port(), fx.PARTITION)
    _, sB, err = blocked_against_one(cfg, grid, s0, ffn,
                                     fx.PARTITION_STEPS)
    assert all(e <= 1e-11 for e in err.values()), err
    errors = fx.errors("partition", {"g": (cfg, sB)}, np.load(fx.OUT))
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad
    widths = {smap.bounds(cfg, (2, 4), (0, c))[3] for c in range(4)}
    assert widths == {6, 7}
