"""roms_tpu_torch.parallel on the CPU: the blocked domain decomposition
(parallel/smap.py) with its in-process halo exchange (parallel/halo.py)
against one block and against roms_tpu: block/unblock, the exchange
against roms_tpu's global fill_halo, UPWELLING on 2 x 4 blocks against
one block (tests/test_smap.py's atol 1e-11) and against roms_tpu's 2 x 4
shard_map state in tests/data/torch_nesting_small.npz, and the closed
basin, whose four walls exercise the edge ownership."""

import jax.numpy as jnp
import numpy as np
import torch

from roms_tpu.config import Config as JConfig
from roms_tpu.ops import bc as jbc
from roms_tpu_torch import stepping
from roms_tpu_torch.config import Config
from roms_tpu_torch.models import cases, upwelling
from roms_tpu_torch.ops import bc
from roms_tpu_torch.parallel import halo, smap
from chip_smoke import nesting_fixture_script

torch.set_num_threads(1)

fx = nesting_fixture_script()
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")


def blocked_against_one(cfg, grid, s0, ffn, nsteps, layout=(2, 4)):
    """The state after nsteps on one block and on `layout` (in process),
    and the largest |difference| of each field."""
    sA = stepping.run(cfg, grid, s0, nsteps, ffn)
    lay = smap.Layout(*layout)
    step = smap.make_smap_stepper(cfg, grid, lay, ffn)
    sb = smap.block(cfg, lay, s0)
    for _ in range(nsteps):
        sb = step(sb)
    sB = smap.unblock(cfg, lay, sb)
    for name in FIELDS:
        assert torch.isfinite(getattr(sA, name)).all(), name
    return sA, sB, {name: float((getattr(sA, name) -
                                 getattr(sB, name)).abs().max())
                    for name in FIELDS}


def test_block_unblock_roundtrip():
    """Even (24 x 16) and uneven (26 x 26: 7, 7, 6, 6 points along xi)
    splits on 2 x 4 blocks come back bitwise."""
    for sizes in (dict(Lm=24, Mm=16, N=4), dict(Lm=26, Mm=26, N=4)):
        cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(**sizes),
                                             device="cpu")
        sb = smap.block(cfg, (2, 4), s0)
        assert sorted(sb) == [(r, c) for r in range(2) for c in range(4)]
        widths = [sb[(0, c)].zeta.shape[-1] - 2 * cfg.halo
                  for c in range(4)]
        assert sum(widths) == cfg.Lm and max(widths) - min(widths) <= 1
        s1 = smap.unblock(cfg, (2, 4), sb)
        for name in ("zeta", "u", "v", "t", "Akv", "bed_mass"):
            assert torch.equal(getattr(s0, name), getattr(s1, name)), name
        assert (s1.time, s1.iic) == (s0.time, s0.iic)


def test_exchange_matches_fill_halo():
    """1 x 8 blocks along xi: halo.exchange_2d (periodic) and the blocked
    bc.fill_halo (closed walls: the rings restored, the outer halo
    replicated) give every block the halos of roms_tpu's global
    fill_halo."""
    for periodic in (True, False):
        _exchange_against_fill_halo(periodic)


def _exchange_against_fill_halo(periodic):
    kw = dict(Lm=32, Mm=16, N=1, ew_periodic=periodic, ns_periodic=periodic)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    H = cfg.halo
    rng = np.random.default_rng(7)
    padded = rng.standard_normal((cfg.ny_tot, cfg.nx_tot))
    if periodic:
        padded[:H] = padded[-H:] = 0.0
        padded[:, :H] = padded[:, -H:] = 0.0
    ref = np.asarray(jbc.fill_halo(jcfg, jnp.asarray(padded)))
    lay = smap.Layout(1, 8)
    blocks = smap.block(cfg, lay, torch.as_tensor(padded))
    cfg_l = smap.local_config(cfg, lay)
    nloc = cfg_l.Lm
    for pos, b in blocks.items():
        # only the interior and the physical rings are data
        keep = torch.zeros_like(b, dtype=torch.bool)
        keep[H:H + cfg_l.Mm, H:H + nloc] = True
        if not periodic:
            keep[H - 1, :] = keep[H + cfg_l.Mm, :] = True
            keep[:, H - 1] |= pos[1] == 0
            keep[:, H + nloc] |= pos[1] == 7
        blocks[pos] = torch.where(keep, b, torch.nan)

    def refresh(pos, b):
        if periodic:
            return halo.exchange_2d(cfg_l, b, exchange=lay.exchange)
        return bc.fill_halo(cfg_l, b)

    out = smap.run_blocked(lay, refresh, blocks)
    for p in range(8):
        want = ref[:, p * nloc:p * nloc + nloc + 2 * H]
        np.testing.assert_array_equal(out[(0, p)].numpy(), want,
                                      err_msg=f"block {p}")


def test_smap_matches_one_block_and_roms_tpu():
    cfg, grid, s0, ffn = fx.upwelling_case(fx.port(), fx.SMAP)
    assert smap.supported(cfg)
    _, sB, err = blocked_against_one(cfg, grid, s0, ffn, fx.SMAP_STEPS)
    assert all(e <= 1e-11 for e in err.values()), err
    errors = fx.errors("smap", {"g": (cfg, sB)}, np.load(fx.OUT))
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad


def test_smap_matches_one_block_closed_basin():
    """Fully closed domain (no periodic wrap anywhere) exercises the
    edge-ownership gating on all four sides."""
    cfg, grid, s0, ffn = cases.basin(
        cases.basin_config(Lm=24, Mm=16, N=4, ndtfast=8), device="cpu")
    _, _, err = blocked_against_one(cfg, grid, s0, ffn, 3)
    assert all(e <= 1e-11 for e in err.values()), err
