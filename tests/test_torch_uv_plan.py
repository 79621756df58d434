"""The launch plans of the momentum corrector and the harmonic viscosity
(ops/step3d_cuda.uv_plan, ops/mix3d_cuda.uv3dmix2_plan): for every depth
the kernels take, a tile's shared memory leaves room for three blocks an
SM of an H100, the tiles cover the padded grid, and every shared-memory
read of uv3dmix2's stencils stays inside the arrays the plan sizes.  Pure
Python: no jax, no card."""

import functools

import pytest
import torch

from roms_tpu_torch.ops import mix3d_cuda, step3d_cuda

# padded grids (ny, nx): BENCHMARK1, UPWELLING, the small BENCHMARK, a
# grid smaller than one tile, LMD_TEST (10 x 10, doubly periodic, N = 50)
# and BL_TEST (Mm = 4)
GRIDS = [(70, 518), (86, 47), (38, 70), (3, 5), (16, 16), (10, 45)]
SMEM = 232_448
WORD = {torch.float32: 4, torch.float64: 8}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uv_plan_fits_and_covers(dtype):
    for N in range(1, 65):
        for ny, nx in GRIDS:
            plan = step3d_cuda.uv_plan(dtype, N, ny, nx)
            tile, blocks = plan["tile"], plan["blocks"]
            assert 1 <= tile <= step3d_cuda.TILE, plan
            assert tile & (tile - 1) == 0, plan      # a power of two
            assert 3 * plan["smem_bytes"] <= SMEM, (N, plan)
            assert (blocks - 1) * tile < ny * nx <= blocks * tile, plan
            # a thread per column and level slot, at least four slots
            # (the two directions' solves, and their sums beside them)
            assert plan["threads"] == step3d_cuda.TILE_THREADS // \
                (2 if dtype == torch.float64 else 1)
            assert plan["threads"] % tile == 0, plan
            assert plan["threads"] >= 4 * tile, plan
            # per direction and column: velocity, Hk, 1/Hk, DCk, CFs (N
            # each), AK, flux (N + 1 each), CF0, the sum of DCk, err, FCc
            assert plan["smem_bytes"] == \
                tile * 2 * (7 * N + 6) * WORD[dtype], plan
            # the largest tile that leaves room for three blocks an SM
            if tile < step3d_cuda.TILE:
                assert 3 * 2 * plan["smem_bytes"] > SMEM, plan


@functools.cache
def _uv3dmix2_reads(tx, ty):
    """The region indices and rectangle indices that uv3dmix2's stencils
    read on a tile tx x ty (csrc/mix3d.cuh uv3dmix2_tile, its index
    arithmetic written out): (region lo, hi, rectangle lo, hi)."""
    rx, fw = tx + 2, tx + 1
    region, rect = [], []
    for y in range(ty + 1):
        for x in range(tx + 1):
            q = y * rx + x                       # rho point, region (y, x)
            region += [q, q + 1, q + rx]         # cx, U, cy, V, HZ
            s = q + rx + 1                       # psi point, (y+1, x+1)
            region += [s, s - 1, s - rx, s - rx - 1]
    for ly in range(ty):
        for lx in range(tx):
            region.append((ly + 1) * rx + lx + 1)   # the point's factors
            fr, fp = (ly + 1) * fw + lx + 1, ly * fw + lx
            rect += [fr, fr - 1, fr - fw, fp, fp + 1, fp + fw]
    return min(region), max(region), min(rect), max(rect)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uv3dmix2_plan_fits_and_covers(dtype):
    for N in range(1, 65):
        for ny, nx in GRIDS:
            plan = mix3d_cuda.uv3dmix2_plan(dtype, N, ny, nx)
            (tx, ty), ks = plan["tile"], plan["levels"]
            npts = tx * ty
            assert 3 * plan["smem_bytes"] <= SMEM, (N, plan)
            bx, by = -(-nx // tx), -(-ny // ty)
            assert plan["blocks"] == bx * by, plan
            assert (bx - 1) * tx < nx <= bx * tx, plan
            assert (by - 1) * ty < ny <= by * ty, plan
            assert plan["threads"] == npts * ks <= mix3d_cuda.THREADS
            assert npts % 32 == 0 and 1 <= ks <= 15, plan   # slot barriers
            # the region (tile and one point around it) and the rho and
            # psi rectangles (one point more along each axis)
            ra, fa = (tx + 2) * (ty + 2), (tx + 1) * (ty + 1)
            lo, hi, rlo, rhi = _uv3dmix2_reads(tx, ty)
            assert 0 <= lo and hi < ra, (plan, lo, hi)
            assert 0 <= rlo and rhi < fa, (plan, rlo, rhi)
            # per slot two sets of u, v, Hz planes and four face arrays;
            # the region's four metric sums; the rectangles' nine
            # factors; with slots, du and dv of each level and point; the
            # region's offsets
            words = ks * (6 * ra + 4 * fa) + 4 * ra + 9 * fa + \
                (2 * N * npts if ks > 1 else 0)
            assert plan["smem_bytes"] == words * WORD[dtype] + 4 * ra, plan


def test_plans_at_benchmark1_and_upwelling():
    """BENCHMARK1 (N = 30, 70 x 518 padded points): uv_corrector on tiles
    of 32 columns and 256 threads in float32, 16 columns and 128 threads
    in float64, uv3dmix2 on 32 x 4 tiles with two level slots in float32
    and one in float64, each with room for three blocks an SM and at
    least two blocks an SM; UPWELLING (N = 16, 86 x 47): uv3dmix2 on 32 x
    1 tiles of eight level slots."""
    for dtype, tile, threads, slots, mix_smem in (
            (torch.float32, 32, 256, 2, 55_812),
            (torch.float64, 16, 128, 1, 34_296)):
        uv = step3d_cuda.uv_plan(dtype, 30, 70, 518)
        assert uv == dict(tile=tile, blocks=-(-70 * 518 // tile),
                          threads=threads, smem_bytes=55_296), uv
        mix = mix3d_cuda.uv3dmix2_plan(dtype, 30, 70, 518)
        assert mix == dict(tile=(32, 4), levels=slots, blocks=17 * 18,
                           threads=128 * slots, smem_bytes=mix_smem), mix
        for plan in (uv, mix):
            assert 3 * plan["smem_bytes"] <= SMEM
            assert plan["blocks"] >= 2 * 132
        up = mix3d_cuda.uv3dmix2_plan(dtype, 16, 86, 47)
        assert up["tile"] == (32, 1) and up["levels"] == 8, up
        assert step3d_cuda.uv_plan(dtype, 16, 86, 47)["tile"] == 32
