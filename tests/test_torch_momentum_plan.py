"""The launch plans of the momentum-phase kernels (ops/prsgrd_cuda.
prsgrd_plan, ops/rhs3d_cuda.rhs3d_plan): for every depth the kernels take,
a tile fits the shared memory of an H100 block, the tiles cover the padded
grid, and every shared-memory read of a tile's stencils stays inside the
arrays the plan sizes.  Pure Python: no jax, no card."""

import pytest
import torch

from roms_tpu_torch.ops import prsgrd_cuda, rhs3d_cuda

# padded grids (ny, nx): BENCHMARK1, UPWELLING, the small BENCHMARK, a
# grid smaller than one tile, LMD_TEST (10 x 10, doubly periodic, N = 50)
# and BL_TEST (Mm = 4)
GRIDS = [(70, 518), (86, 47), (38, 70), (3, 5), (16, 16), (10, 45)]
SMEM = 232_448
WORD = {torch.float32: 4, torch.float64: 8}


def _covers(plan, ny, nx):
    tx, ty = plan["tile"]
    bx, by = -(-nx // tx), -(-ny // ty)
    return plan["blocks"] == bx * by and (bx - 1) * tx < nx <= bx * tx \
        and (by - 1) * ty < ny <= by * ty


def _rhs3d_reach(tx, ty):
    """The lowest and highest region row and column (csrc/rhs3d.cuh: the
    region starts 3 points before the tile) that rhs3d's stencils read,
    for a tile tx x ty.  Rho faces (the rho rectangle, from one point
    before the tile) sit at region offset 2, psi faces at 3, tile points
    at 3; a U3 flux differences two centres, each moved by an edge shift
    of at most one point, and each second difference reads one point
    either side."""
    lo, hi = [], []
    for first, last in ((0, tx), (0, ty)):
        rho = (first + 2, last + 2)      # rho faces along this axis
        psi = (first + 3, last + 3)      # psi faces
        # along: centres q, q+1; across (psi): centres q-1, q
        lo.append(min(rho[0] - 1 - 1, psi[0] - 1 - 1 - 1))
        hi.append(max(rho[1] + 1 + 1 + 1, psi[1] + 1 + 1))
    return lo, hi


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prsgrd_plan_fits_and_covers(dtype):
    for N in range(1, 65):
        for ny, nx in GRIDS:
            plan = prsgrd_cuda.prsgrd_plan(dtype, N, ny, nx)
            tx, ty = plan["tile"]
            assert plan["smem_bytes"] <= SMEM, (N, plan)
            assert _covers(plan, ny, nx), plan
            assert plan["threads"] == prsgrd_cuda.THREADS
            assert plan["threads"] % (tx * ty) == 0, plan
            # rho, z_r and P at every level of each region column (the
            # tile's and one more west and south: the columns the
            # gradients read), and the columns' offsets
            cols = (tx + 1) * (ty + 1)
            assert plan["smem_bytes"] == cols * (3 * N * WORD[dtype] + 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rhs3d_plan_fits_and_covers(dtype):
    for N in range(1, 65):
        for ny, nx in GRIDS:
            plan = rhs3d_cuda.rhs3d_plan(dtype, N, ny, nx)
            (tx, ty), ks = plan["tile"], plan["levels"]
            assert plan["smem_bytes"] <= SMEM, (N, plan)
            assert _covers(plan, ny, nx), plan
            assert plan["threads"] == tx * ty * ks <= rhs3d_cuda.THREADS
            rx, ry = tx + 6, ty + 6
            (xlo, ylo), (xhi, yhi) = _rhs3d_reach(tx, ty)
            assert 0 <= xlo and xhi < rx and 0 <= ylo and yhi < ry
            # per level slot two sets of six region planes (u, v, Huon,
            # Hvom, Hz, W) and eight face arrays; fomn, dndx, dmde; DC0;
            # the region's offsets and the faces' edge shifts
            fa, npts = (tx + 1) * (ty + 1), tx * ty
            assert npts % 32 == 0, plan      # a slot's barrier: whole warps
            words = ks * (12 * rx * ry + 8 * fa) + 3 * fa + 2 * npts
            assert plan["smem_bytes"] == words * WORD[dtype] + \
                4 * (rx * ry + fa)


def test_plans_at_benchmark1():
    """BENCHMARK1 (N = 30, 70 x 518 padded points): prsgrd32 on 32 x 4
    tiles in float32 and 32 x 2 in float64, rhs3d on 32 x 4 tiles of two
    level slots in float32 and one in float64, each with room for three
    blocks an SM and at least two blocks an SM."""
    for dtype, prs_tile, prs_smem, slots, rhs_smem in (
            (torch.float32, (32, 4), 60_060, 2, 52_224),
            (torch.float64, (32, 2), 71_676, 1, 55_228)):
        prs = prsgrd_cuda.prsgrd_plan(dtype, 30, 70, 518)
        ty = prs_tile[1]
        assert prs == dict(tile=prs_tile, blocks=17 * -(-70 // ty),
                           threads=256, smem_bytes=prs_smem), prs
        rhs = rhs3d_cuda.rhs3d_plan(dtype, 30, 70, 518)
        assert rhs == dict(tile=(32, 4), levels=slots, blocks=17 * 18,
                           threads=128 * slots, smem_bytes=rhs_smem), rhs
        for plan in (prs, rhs):
            assert 3 * plan["smem_bytes"] <= SMEM
            assert plan["blocks"] >= 2 * 132
