"""The launch plans of the diag kernels (ops/diag_cuda.grid_flux_plan,
ops/diag_cuda.eos_plan): for every depth up to 64 levels, in both dtypes,
the tiles cover the padded grid, a block's shared memory leaves room for
three blocks an SM of an H100, and it is sized as the kernel lays out its
arrays (csrc/diag.cuh flux_words, eos_words), with every region and box
read of grid_flux inside its arrays.  Pure Python: no jax, no card."""

import pytest
import torch

from roms_tpu_torch.ops import diag_cuda

# padded grids (ny, nx): BENCHMARK1, UPWELLING, the small BENCHMARK, and a
# grid smaller than one tile
GRIDS = [(70, 518), (86, 47), (38, 70), (3, 5)]
SMEM = 232_448
WORD = {torch.float32: 4, torch.float64: 8}


def _threads_fit(plan, npts):
    """A thread per (level slot, tile point): the block's threads a
    multiple of the tile's points and of a warp, at most 256."""
    assert npts & (npts - 1) == 0, plan                  # a power of two
    assert plan["threads"] == diag_cuda.THREADS == 256, plan
    assert plan["threads"] % npts == 0 and plan["threads"] % 32 == 0, plan


def _reads(tx, ty):
    """The region and box indices grid_flux reads for a tile tx x ty
    (csrc/diag.cuh FluxTile.region and grid_flux_tile, their index
    arithmetic written out): each box point's column and the columns
    behind it along xi and eta; the fluxes of each tile point and of its
    neighbours ahead along xi and eta."""
    rw, bw = tx + 2, tx + 1
    box = [(y, x) for y in range(ty) for x in range(tx)] + \
        [(y, tx) for y in range(ty)] + [(ty, x) for x in range(tx)]
    region = [(y + 1 + dy) * rw + x + 1 + dx for y, x in box
              for dy, dx in ((0, 0), (0, -1), (-1, 0))]
    fluxes = [y * bw + x + d for y in range(ty) for x in range(tx)
              for d in (0, 1, bw)]
    return region, fluxes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_flux_plan_fits_and_covers(dtype):
    for N in range(1, 65):
        for ny, nx in GRIDS:
            plan = diag_cuda.grid_flux_plan(dtype, N, ny, nx)
            tx, ty = plan["tile"]
            bx, by = -(-nx // tx), -(-ny // ty)
            assert plan["blocks"] == bx * by, plan
            assert (bx - 1) * tx < nx <= bx * tx, plan
            assert (by - 1) * ty < ny <= by * ty, plan
            _threads_fit(plan, tx * ty)
            assert 3 * plan["smem_bytes"] <= SMEM, (N, plan)
            # zeta, h, hinv, on_u, om_v of every region point; sc_r, Cs_r
            # (N), sc_w, Cs_w (N + 1); Huon and Hvom of every level and
            # box point; the omega sums of every level and tile point; wrk
            # of every tile point
            region, box = (tx + 2) * (ty + 2), (tx + 1) * (ty + 1)
            words = 5 * region + 2 * N + 2 * (N + 1) + 2 * N * box + \
                N * tx * ty + tx * ty
            assert plan["smem_bytes"] == words * WORD[dtype], plan
            reads, fluxes = _reads(tx, ty)
            assert 0 <= min(reads) and max(reads) < region, plan
            assert 0 <= min(fluxes) and max(fluxes) < box, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eos_plan_fits_and_covers(dtype):
    for N in range(1, 65):
        for ny, nx in GRIDS:
            S = ny * nx
            for jm95 in (False, True):
                for bvf in (False, True):
                    plan = diag_cuda.eos_plan(dtype, N, ny, nx, jm95, bvf)
                    if not (jm95 and bvf):
                        # a thread a point of the w grid, no shared memory
                        assert plan["tile"] is None, plan
                        assert plan["smem_bytes"] == 0, plan
                        assert (plan["blocks"] - 1) * plan["threads"] < \
                            (N + 1) * S <= plan["blocks"] * plan["threads"]
                        continue
                    tile = plan["tile"]
                    assert 1 <= tile <= diag_cuda.EOS_TILE, plan
                    assert (plan["blocks"] - 1) * tile < S <= \
                        plan["blocks"] * tile, plan
                    _threads_fit(plan, tile)
                    # den1, K0, K1, K2, z_r and z_w of every level and
                    # tile point
                    assert plan["smem_bytes"] == \
                        6 * N * tile * WORD[dtype], plan
                    assert 3 * plan["smem_bytes"] <= SMEM, (N, plan)
                    # the largest tile that leaves room for three blocks
                    if tile < diag_cuda.EOS_TILE:
                        assert 3 * 2 * plan["smem_bytes"] > SMEM, plan


def test_diag_plans_at_benchmark1_and_upwelling():
    """BENCHMARK1 (N = 30, 70 x 518 padded points): grid_flux on 32 x 4
    tiles in float32 and 32 x 2 in float64, each at least two blocks an SM
    with room for three; eos (JM95 with bvf) on runs of 32 points.
    UPWELLING (N = 16, 86 x 47; linear EOS, no bvf): grid_flux on 32 x 1
    tiles, eos a thread a point."""
    for dtype, tile, blocks, smem, eos_smem in (
            (torch.float32, (32, 4), 17 * 18, 60_040, 23_040),
            (torch.float64, (32, 2), 17 * 35, 69_808, 46_080)):
        gf = diag_cuda.grid_flux_plan(dtype, 30, 70, 518)
        assert gf == dict(tile=tile, blocks=blocks, threads=256,
                          smem_bytes=smem), gf
        assert gf["blocks"] >= 2 * 132 and 3 * smem <= SMEM
        eos = diag_cuda.eos_plan(dtype, 30, 70, 518, True, True)
        assert eos == dict(tile=32, blocks=-(-70 * 518 // 32), threads=256,
                           smem_bytes=eos_smem), eos
        up = diag_cuda.grid_flux_plan(dtype, 16, 86, 47)
        assert up["tile"] == (32, 1) and up["blocks"] == 2 * 86, up
        assert diag_cuda.eos_plan(dtype, 16, 86, 47, False, False)["tile"] \
            is None
