"""The launch plans of the diag kernels (ops/diag_cuda.grid_flux_plan,
ops/diag_cuda.eos_plan): for every depth up to 64 levels, in both dtypes,
the tiles cover the padded grid, a block's shared memory leaves room for
three blocks an SM of an H100, and it is sized as the kernel lays out its
arrays (csrc/diag.cuh flux_words, eos_words), with every region and box
read of grid_flux inside its arrays and W written at every padded point
from its source.  Pure Python: no jax, no card."""

import pytest
import torch

from roms_tpu_torch.ops import diag_cuda

# padded grids (ny, nx): BENCHMARK1, UPWELLING, the small BENCHMARK, a
# grid smaller than one tile, LMD_TEST (10 x 10, doubly periodic, N = 50)
# and BL_TEST (Mm = 4)
GRIDS = [(70, 518), (86, 47), (38, 70), (3, 5), (16, 16), (10, 45)]
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
            # box point; the omega sums of every level and tile point
            region, box = (tx + 2) * (ty + 2), (tx + 1) * (ty + 1)
            words = 5 * region + 2 * N + 2 * (N + 1) + 2 * N * box + \
                N * tx * ty
            assert plan["smem_bytes"] == words * WORD[dtype], plan
            reads, fluxes = _reads(tx, ty)
            assert 0 <= min(reads) and max(reads) < region, plan
            assert 0 <= min(fluxes) and max(fluxes) < box, plan


def _omega_src(a, H, n, per):
    """The W source of padded index a along an axis of n interior points
    (csrc/diag.cuh omega_src): the periodic image, or the nearest interior
    index on a closed axis."""
    if per:
        return a + n if a < H else (a - n if a >= H + n else a)
    return min(max(a, H), H + n - 1)


def _tile_starts(t, npad, per):
    """The starts of an axis's tiles of t points (csrc/diag.cuh
    tile_start): on a closed axis the last ends at the last point."""
    nt = -(-npad // t)
    return [npad - t if not per and k == nt - 1 and npad > t else k * t
            for k in range(nt)]


def _w_targets(a, H, n, per, t0, t):
    """The indices along an axis at which the thread of index a in the
    tile [t0, t0 + t) writes W: csrc/diag.cuh omega_targets, its bits
    written out as indices (omega_target)."""
    bits = {31}
    if H <= a < H + n:
        outside = not t0 <= a - n < t0 + t, not t0 <= a + n < t0 + t
        if per:
            if a >= n and a - n < H and outside[0]:
                bits.add(a - n)
            if a < 2 * H and outside[1]:
                bits.add(a)
        else:
            def clip(b):
                return min(max(b, 0), H)
            if a == H:
                bits |= set(range(H)) - set(range(clip(t0), clip(t0 + t)))
            if a == H + n - 1:
                bits |= {H + b for b in set(range(H)) - set(range(
                    clip(t0 - H - n), clip(t0 + t - H - n)))}
    return sorted(a if b == 31 else (b if b < H else n + b) for b in bits)


def _w_writes(H, n, per, t):
    """Along one axis of n interior points padded by H, with tiles of t
    points: for each tile, the (index, source index) pairs of the W it
    writes.  The thread of index a whose source is in the tile writes
    at _w_targets of a: a, and for an interior a the halo indices of its
    W outside the tile."""
    npad = n + 2 * H
    out = []
    for t0 in _tile_starts(t, npad, per):
        out.append({(b, _omega_src(a, H, n, per))
                    for a in range(t0, min(t0 + t, npad))
                    if t0 <= _omega_src(a, H, n, per) < t0 + t
                    for b in _w_targets(a, H, n, per, t0, t)})
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_flux_writes_w_everywhere_from_its_source(dtype):
    """grid_flux's pass D on its plans' tiles, periodic and closed along
    each axis: a tile writes the products of its (index, source) pairs
    along eta and xi, every pair's index takes W from that source, and
    every padded point is written.  A tile narrower than a wall band
    scatters it."""
    H = 3
    for N in (16, 30, 50, 64):
        for ny, nx in [(70, 518), (86, 47), (38, 70), (8, 26), (7, 7),
                       (16, 16), (10, 45)]:
            tx, ty = diag_cuda.grid_flux_plan(dtype, N, ny, nx)["tile"]
            M, L = ny - 2 * H, nx - 2 * H
            # a periodic axis holds at least H interior points
            for ns_per in (0, 1)[:1 + (M >= H)]:
                for ew_per in (0, 1)[:1 + (L >= H)]:
                    ys = _w_writes(H, M, ns_per, ty)
                    xs = _w_writes(H, L, ew_per, tx)
                    for axis, n, per in ((ys, M, ns_per), (xs, L, ew_per)):
                        for pairs in axis:
                            assert all(_omega_src(b, H, n, per) == a
                                       for b, a in pairs), (n, per)
                    done = set()
                    for wy in ys:
                        for wx in xs:
                            done |= {(j, i) for j, _ in wy for i, _ in wx}
                    assert len(done) == ny * nx, (N, ny, nx, ns_per, ew_per,
                                                  (tx, ty))


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
            (torch.float32, (32, 4), 17 * 18, 59_528, 23_040),
            (torch.float64, (32, 2), 17 * 35, 69_296, 46_080)):
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
