"""The launch plan of the two tracer kernels (ops/step3d_cuda.tracer_plan):
for every depth and tracer count the kernels take, a tile fits the shared
memory of an H100 block and the tiles cover the padded grid.  Pure Python:
no jax, no card."""

import pytest
import torch

from roms_tpu_torch.ops import step3d_cuda

# padded grids (ny, nx): BENCHMARK1, UPWELLING, the small BENCHMARK, a
# grid smaller than one tile, LMD_TEST (10 x 10, doubly periodic, N = 50)
# and BL_TEST (Mm = 4)
GRIDS = [(70, 518), (86, 47), (38, 70), (3, 5), (16, 16), (10, 45)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["tracer_predictor", "tracer_corrector"])
def test_tracer_plan_fits_and_covers(name, dtype):
    for N in range(1, 65):
        for NT in range(1, 17):
            for ny, nx in GRIDS:
                plan = step3d_cuda.tracer_plan(name, dtype, N, NT, ny, nx)
                tile, blocks = plan["tile"], plan["blocks"]
                assert 1 <= tile <= step3d_cuda.TILE, plan
                assert tile & (tile - 1) == 0, plan      # a power of two
                assert plan["smem_bytes"] <= 232_448, (N, NT, plan)
                assert (blocks - 1) * tile < ny * nx <= blocks * tile, plan
                assert plan["threads"] % tile == 0, plan
                assert tile <= plan["threads"] <= step3d_cuda.TILE_THREADS


def test_tracer_plan_at_benchmark1():
    """BENCHMARK1 (N = 30, 2 tracers, 70 x 518 padded points): tiles of 32
    points in float32 and 16 in float64, three blocks an SM by shared
    memory."""
    for dtype, nbytes, tile in ((torch.float32, 4, 32),
                                (torch.float64, 8, 16)):
        for name, rows in (("tracer_predictor", 453),
                           ("tracer_corrector", 545)):
            plan = step3d_cuda.tracer_plan(name, dtype, 30, 2, 70, 518)
            assert plan == dict(tile=tile, blocks=-(-70 * 518 // tile),
                                threads=256,
                                smem_bytes=tile * rows * nbytes), plan
            assert 3 * plan["smem_bytes"] <= 232_448
