// Diagnostic ("time n") kernels of the baroclinic step: set_depth, mass
// fluxes, omega, and the equation of state.
//
//   grid_flux - set_depth + set_massflux + omega in one launch.  Replaces
//               the TPU kernel roms_tpu/ops/diag_pallas.py::grid_flux_fused.
//   omega     - omega of given fluxes.  Replaces diag_pallas.omega_fused.
//   eos       - rho_eos (+ the Brunt-Vaisala frequency).  Replaces
//               diag_pallas.eos_fused.
//
// All are bound by device-memory bandwidth on the H100: a handful of
// operations per byte moved (grid_flux reads u, v and five planes, writes
// six (N,Ny,Nx) fields: ~35 MB at BENCHMARK1 in float32, 0.011 ms at 3.35
// TB/s; omega reads Huon, Hvom and z_w and writes W: ~17.7 MB, 0.0053
// ms).  What keeps a thread-a-column kernel from that is the latency of
// its serial loads and the round trips between launches.
//
// grid_flux works on 2-D tiles (grid_flux_tile): a block owns tx x ty
// padded points (ops/diag_cuda.grid_flux_plan) with a thread per (level
// slot, tile point) and keeps, in shared memory, zeta, h and the metrics
// of its region (the tile and one ring of points around it), [k][point]
// arrays of the filled fluxes of its box (the tile, one column east and
// one row north) and omega's sums; Hz is recomputed from zeta and h
// wherever a flux needs it, with the expression that writes it, so
// nothing goes round through device memory.  At BENCHMARK1 every block is
// resident at once, so their loads, stores and column sums come in the
// same order in all of them and overlap little; and W's halo is written
// by the tiles that hold its sources.
// eos with JM95 and bvf works on runs of consecutive padded points
// (eos_bvf_tile) and evaluates the polynomials once a point; the linear EOS
// and JM95 without bvf run one thread a point (eos_kernel).  omega runs one
// thread a column (omega_kernel): on 2-D tiles in shared memory it was
// slower at BENCHMARK1.
//
// Every expression keeps the plain version's operation order and the
// library is built with --fmad=false, so the kernels round like their
// plain PyTorch versions (a Python `c / x` is torch's reciprocal(x) * c,
// equal to c / x for c = 1 or 2); W's column sums run in k order, where
// torch's cumsum on the card may add in another.
#pragma once

#include "column.cuh"

namespace roms {

// The launch of grid_flux, chosen by ops/diag_cuda.grid_flux_plan: points
// of a tile along xi and eta, threads a block and the dynamic shared
// memory, which the entry point checks against flux_words.
struct FluxPlan {
  int tx, ty, threads, smem;
};

struct DiagParams {
  Geom g;
  int N;
  int vtransform;
  double hc;
  FluxPlan plan;   // grid_flux only
};

template <typename T>
struct FluxPtrs {
  const T *zeta, *h, *pm, *pn, *u, *v, *sc_r, *Cs_r, *sc_w, *Cs_w;
  T *z_r, *z_w, *Hz, *Huon, *Hvom, *W;
};

// points of a tile's region: the tile and one ring of points around it
__host__ __device__ constexpr int flux_region(int tx, int ty) {
  return (tx + 2) * (ty + 2);
}

// points of a tile's box: the tile, one column to the east and one row to
// the north (the filled fluxes omega's divergence reads)
__host__ __device__ constexpr int flux_box(int tx, int ty) {
  return (tx + 1) * (ty + 1);
}

// shared words of a grid_flux block: zeta, h, hinv, on_u and om_v of every
// region point; the stretching tables sc_r, Cs_r (N), sc_w, Cs_w (N + 1);
// the filled Huon and Hvom of every level and box point; omega's
// divergence (then its k-ascending sums) of every level and tile point
__host__ __device__ constexpr int flux_words(int N, int tx, int ty) {
  return 5 * flux_region(tx, ty) + 4 * N + 2 + 2 * N * flux_box(tx, ty) +
         N * tx * ty;
}

// a wrapped by one period at most into [0, n)
__device__ __forceinline__ int wrap1(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

// Wait for the copy groups of part c of kParts parts, all committed before
// one more group: the groups committed after it may still be in flight.
template <int kParts>
__device__ __forceinline__ void copy_async_wait_for(int c) {
  switch (kParts - c) {
    case 4: copy_async_wait<4>(); break;
    case 3: copy_async_wait<3>(); break;
    case 2: copy_async_wait<2>(); break;
    default: copy_async_wait<1>(); break;
  }
}

// 1/(hc + h) (Vtransform 2) or 1/h (Vtransform 1)
template <int VT, typename T>
__device__ __forceinline__ T depth_hinv(T hc, T hp) {
  return VT == 2 ? T(1) / (hc + hp) : T(1) / hp;
}

// The depth of s-level (sc, Cs) in a column of depth hp, free surface zp
// and hinv = depth_hinv (set_depth.F:160-250, vgrid.set_depth)
template <int VT, typename T>
__device__ __forceinline__ T depth_at(T hc, T sc, T Cs, T zp, T hp, T hinv) {
  if (VT == 2) {
    const T cff = (hc * sc + Cs * hp) * hinv;
    return zp + (zp + hp) * cff;
  }
  const T z0 = hc * (sc - Cs) + Cs * hp;
  return z0 + zp * (T(1) + z0 * hinv);
}

// zeta, h and hinv of one water column
template <typename T>
struct DepthCol {
  T zeta, h, hinv;
};

// The source index of W at padded index a along one axis of n interior
// points: omega's zero-gradient BC on all sides, then the halo fill
// (bc.apply_bc_rho, gathered).
__device__ __forceinline__ int omega_src(int a, int H, int n, int per) {
  return rho_bc_src(fill_src(a, H, n, per), H, n, per, BC_GRA, BC_GRA);
}

// Tiles along one axis of n padded points: t points each from 0, and on a
// closed axis (shift) the last one moved back to end at n, so that the
// halo band at either wall lies in one tile with the points whose W it
// copies.  The start of tile k of nt:
__device__ __forceinline__ int tile_start(int k, int t, int n, bool shift) {
  const int nt = (n + t - 1) / t;
  return shift && k == nt - 1 && n > t ? n - t : k * t;
}

// bits lo <= b < hi of a word (none when hi <= lo; 0 <= lo, hi <= 31)
__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  return hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
}

// The indices along one axis at which a thread that holds W at index a,
// in a tile of t points from t0, writes it: a (bit 31), and, for interior
// a, the halo indices whose W source is a and that lie outside the tile
// (bit m for index m < H, bit H + m for index H + n + m); the tile's own
// halo points gather it.  A periodic axis's halo index a - n or a + n; a
// closed axis's band of H at either wall, whose source is the first or
// last interior index.  Where two tiles overlap, both may write a point,
// the same value.
__device__ __forceinline__ unsigned omega_targets(int a, int H, int n,
                                                  int per, int t0, int t) {
  unsigned bits = 1u << 31;
  if (a < H || a >= H + n) return bits;
  const auto outside = [&](int b) { return b < t0 || b >= t0 + t; };
  if (per) {
    if (a >= n && a - n < H && outside(a - n)) bits |= 1u << (a - n);
    if (a < 2 * H && outside(a + n)) bits |= 1u << a;
    return bits;
  }
  // the bands' bits, less those of the tile's own points
  const auto clip = [&](int b) { return b < 0 ? 0 : (b > H ? H : b); };
  if (a == H)
    bits |= bit_range(0, H) & ~bit_range(clip(t0), clip(t0 + t));
  if (a == H + n - 1)
    bits |= (bit_range(0, H) &
             ~bit_range(clip(t0 - H - n), clip(t0 + t - H - n)))
            << H;
  return bits;
}

// The index of the lowest bit of omega_targets(a, H, n, ...) bits (not 0)
__device__ __forceinline__ int omega_target(unsigned bits, int a, int H,
                                            int n) {
  const int b = __ffs(bits) - 1;
  return b == 31 ? a : (b < H ? b : n + b);
}

// wrk, the moving-grid correction of a column whose divergence sums to
// sum over its depth zwN - zw0
template <typename T>
__device__ __forceinline__ T omega_wrk(T sum, T zwN, T zw0) {
  return (-sum) / (zwN - zw0);
}

// W at w level 1 <= kw <= N - 1 from the sum through level kw - 1, wrk and
// the column's z_w at kw and 0
template <typename T>
__device__ __forceinline__ T omega_level(T sum, T wrk, T zwk, T zw0) {
  return (-sum) - wrk * (zwk - zw0);
}

// The block's view of its tile for grid_flux: the region's values in shared
// memory and, for a column outside the region, device memory.
template <typename T, int VT>
struct FluxTile {
  const Geom g;
  const int N, j0, i0, tx, ty, npts, nbox, S;
  const T hc;
  const T *u, *v, *zh, *hh, *pm, *pn;   // device memory
  T *zeta, *h, *hinv, *on_u, *om_v;     // a region point each
  T *sc_r, *Cs_r, *sc_w, *Cs_w;
  T *HU, *HV;                           // [k][box point]
  T* DIV;                               // [k][tile point]

  __device__ FluxTile(const DiagParams& P, const FluxPtrs<T>& A, T* sm,
                      int bx, int by)
      : g(P.g),
        N(P.N),
        j0(tile_start(by, P.plan.ty, P.g.Ny, !P.g.ns_per)),
        i0(tile_start(bx, P.plan.tx, P.g.Nx, !P.g.ew_per)),
        tx(P.plan.tx),
        ty(P.plan.ty),
        npts(P.plan.tx * P.plan.ty),
        nbox(flux_box(P.plan.tx, P.plan.ty)),
        S(P.g.Ny * P.g.Nx),
        hc(T(P.hc)),
        u(A.u),
        v(A.v),
        zh(A.zeta),
        hh(A.h),
        pm(A.pm),
        pn(A.pn) {
    const int nr = flux_region(tx, ty);
    zeta = sm;
    h = zeta + nr;
    hinv = h + nr;
    on_u = hinv + nr;
    om_v = on_u + nr;
    sc_r = om_v + nr;
    Cs_r = sc_r + N;
    sc_w = Cs_r + N;
    Cs_w = sc_w + N + 1;
    HU = Cs_w + N + 1;
    HV = HU + N * nbox;
    DIV = HV + N * nbox;
  }

  // region index of padded point (J, I), or -1 outside the region
  __device__ int region(int J, int I) const {
    const int rj = J - j0 + 1, ri = I - i0 + 1;
    return rj >= 0 && rj < ty + 2 && ri >= 0 && ri < tx + 2
               ? rj * (tx + 2) + ri
               : -1;
  }
  // tile point of padded point (J, I), or -1 outside the tile
  __device__ int tile(int J, int I) const {
    const int ly = J - j0, lx = I - i0;
    return ly >= 0 && ly < ty && lx >= 0 && lx < tx ? ly * tx + lx : -1;
  }
  __device__ DepthCol<T> col(int J, int I) const {
    const int r = region(J, I);
    if (r >= 0) return {zeta[r], h[r], hinv[r]};
    const int q = J * g.Nx + I;
    const T hp = hh[q];
    return {zh[q], hp, depth_hinv<VT>(hc, hp)};
  }
  // z_w at w level k >= 1 of column c
  __device__ T zw(int k, const DepthCol<T>& c) const {
    return depth_at<VT>(hc, sc_w[k], Cs_w[k], c.zeta, c.h, c.hinv);
  }
  // z_w at w level k >= 0 (z_w[0] = -h)
  __device__ T zw0(int k, const DepthCol<T>& c) const {
    return k == 0 ? -c.h : zw(k, c);
  }
  // on_u = 2/(pn[i-1] + pn[i]) (xi) or om_v = 2/(pm[j-1] + pm[j]) at (J, I)
  __device__ T metric(int J, int I, bool xi) const {
    const int r = region(J, I);
    if (r >= 0) return xi ? on_u[r] : om_v[r];
    const int q = J * g.Nx + I;
    return xi ? T(2) / (pn[q - I + wrap1(I - 1, g.Nx)] + pn[q])
              : T(2) / (pm[wrap1(J - 1, g.Ny) * g.Nx + I] + pm[q]);
  }
};

// grid_flux on the tile (bx, by) of block tid's thread; sm: flux_words
// words.  A thread owns tile point tid % npts and a run of levels (its
// level slot tid / npts).  Passes, a block barrier after each:
//   A0  the block loads the region's zeta, h, pm and pn, then copies u
//       and v at the fill source of every tile point, and u (v) at that of
//       every point of the box's east column (north row), into shared
//       memory (cp.async, in four groups of levels, all in flight), then
//       fills the region's zeta, h, hinv, on_u and om_v and the stretching
//       tables;
//   A1  a thread per (level, point) writes z_r, z_w and Hz of the point,
//       and Huon and Hvom, the fluxes at its fill source (set_massflux and
//       its halo fill, gathered), each group of levels as its copies
//       arrive; the block forms the filled fluxes of the box's east column
//       and north row;
//   B   a thread per interior point forms omega's divergence of its
//       column at every level from the box's fluxes and sums it up the
//       column, in k order;
//   C   a thread per (w level, interior point) forms wrk from the column's
//       whole sum and W there, over the sums;
//   D   a thread per (w level, point) writes W at the point from its W
//       source (apply_bc_rho and the halo fill, gathered) where the tile
//       holds the source; then the few threads whose point is the source
//       of halo points outside the tile write W there too (scattered: a
//       wall band of a tile too narrow to hold it, or the far side of a
//       periodic axis).  A closed axis's last tile ends at its last point,
//       so that both walls' bands gather where the tile is wide enough.
// Hz is recomputed from zeta and h wherever a flux needs it, with the
// expression that writes it, and carried up each run of levels.  Every
// thread reaches every barrier.
template <typename T, int VT>
__device__ void grid_flux_tile(const DiagParams& P, const FluxPtrs<T>& A,
                               T* sm, int bx, int by, int tid) {
  const FluxTile<T, VT> F(P, A, sm, bx, by);
  const Geom& g = F.g;
  const int N = F.N, S = F.S, npts = F.npts, tx = F.tx, nth = P.plan.threads;
  const int rw = tx + 2, bw = tx + 1;       // region and box row widths
  const int pt = tid % npts, slot = tid / npts, nslots = nth / npts;
  const int ly = pt / tx, lx = pt - ly * tx;
  const int j = F.j0 + ly, i = F.i0 + lx;
  const bool live = j < g.Ny && i < g.Nx;   // the tile's ragged edge
  const int p = j * g.Nx + i;
  const int bp = ly * bw + lx;              // the point's box index
  const int Jf = fill_src(j, g.H, g.M, g.ns_per);
  const int If = fill_src(i, g.H, g.L, g.ew_per);
  // interior: the point is its own W source
  const bool inner = omega_src(j, g.H, g.M, g.ns_per) == j &&
                     omega_src(i, g.H, g.L, g.ew_per) == i;
  // the thread's run of rho levels [k0, k1) and of w levels [w0, w1)
  const int k0 = slot * N / nslots, k1 = (slot + 1) * N / nslots;
  const int w0 = slot * (N + 1) / nslots, w1 = (slot + 1) * (N + 1) / nslots;
  // the box's east column and north row: ty + tx points, each in runs of
  // kRun levels
  constexpr int kRun = 8;
  const int nextra = (F.ty + tx) * ((N + kRun - 1) / kRun);
  // the thread's run in kParts parts, each copied in as a group of its own
  constexpr int kParts = 4;
  auto part = [&](int c) { return k0 + (k1 - k0) * c / kParts; };

  // A0: the region's inputs are loaded first, ahead of the copies in the
  // device's queues, and used after them
  const int nr = flux_region(tx, F.ty);
  struct RegionIn {
    T zeta, h, pn, pn_w, pm, pm_s;
  };
  auto region_in = [&](int r) {
    const int ry = r / rw;
    const int J = wrap(F.j0 - 1 + ry, g.Ny);
    const int I = wrap(F.i0 - 1 + r - ry * rw, g.Nx);
    const int q = J * g.Nx + I;
    return RegionIn{F.zh[q], F.hh[q], F.pn[q], F.pn[q - I + wrap1(I - 1, g.Nx)],
                    F.pm[q], F.pm[wrap1(J - 1, g.Ny) * g.Nx + I]};
  };
  auto region_out = [&](int r, const RegionIn& v) {
    F.zeta[r] = v.zeta;
    F.h[r] = v.h;
    F.hinv[r] = depth_hinv<VT>(F.hc, v.h);
    F.on_u[r] = T(2) / (v.pn_w + v.pn);
    F.om_v[r] = T(2) / (v.pm_s + v.pm);
  };
  const RegionIn first = tid < nr ? region_in(tid) : RegionIn{};
  asm volatile("" ::: "memory");
  const int q = Jf * g.Nx + If;
#pragma unroll
  for (int c = 0; c < kParts; ++c) {
    if (live) {
      for (int k = part(c); k < part(c + 1); ++k) {
        copy_async(F.HU + k * F.nbox + bp, F.u + k * S + q);
        copy_async(F.HV + k * F.nbox + bp, F.v + k * S + q);
      }
    }
    copy_async_commit();
  }
  for (int e = tid; e < nextra; e += nth) {
    const int x = e % (F.ty + tx), kr = e / (F.ty + tx) * kRun;
    const bool xi = x < F.ty;               // east column, else north row
    const int J = F.j0 + (xi ? x : F.ty), I = F.i0 + (xi ? tx : x - F.ty);
    if (J >= g.Ny || I >= g.Nx) continue;
    const int qx = fill_src(J, g.H, g.M, g.ns_per) * g.Nx +
                   fill_src(I, g.H, g.L, g.ew_per);
    const int b = (xi ? x : F.ty) * bw + (xi ? tx : x - F.ty);
    for (int k = kr; k < kr + kRun && k < N; ++k)
      copy_async((xi ? F.HU : F.HV) + k * F.nbox + b,
                 (xi ? F.u : F.v) + k * S + qx);
  }
  copy_async_commit();
  if (tid < nr) region_out(tid, first);
  for (int r = tid + nth; r < nr; r += nth) region_out(r, region_in(r));
  for (int k = tid; k <= N; k += nth) {
    if (k < N) {
      F.sc_r[k] = A.sc_r[k];
      F.Cs_r[k] = A.Cs_r[k];
    }
    F.sc_w[k] = A.sc_w[k];
    F.Cs_w[k] = A.Cs_w[k];
  }
  __syncthreads();

  // A1: the point's own column, its fill source f and f's neighbours
  // behind along xi (w) and eta (s); each z_w is carried up the run, whose
  // parts start as their copies arrive
  if (live) {
    const DepthCol<T> own = F.col(j, i);
    const bool self = Jf == j && If == i;
    const DepthCol<T> cf = F.col(Jf, If);
    const DepthCol<T> cw = F.col(Jf, wrap1(If - 1, g.Nx));
    const DepthCol<T> cs = F.col(wrap1(Jf - 1, g.Ny), If);
    const T on_u = F.metric(Jf, If, true), om_v = F.metric(Jf, If, false);
    T z_own = F.zw0(k0, own), z_f = F.zw0(k0, cf);
    T z_w = F.zw0(k0, cw), z_s = F.zw0(k0, cs);
    if (k0 == 0 && k1 > 0) A.z_w[p] = z_own;
#pragma unroll
    for (int c = 0; c < kParts; ++c) {
      copy_async_wait_for<kParts>(c);
      for (int k = part(c); k < part(c + 1); ++k) {
        const int o = k * S + p, t = k * F.nbox + bp;
        const T up_own = F.zw(k + 1, own);
        const T Hq = up_own - z_own;
        A.z_r[o] = depth_at<VT>(F.hc, F.sc_r[k], F.Cs_r[k], own.zeta, own.h,
                                own.hinv);
        A.z_w[o + S] = up_own;
        A.Hz[o] = Hq;
        T Hf = Hq;
        if (!self) {
          const T up_f = F.zw(k + 1, cf);
          Hf = up_f - z_f;
          z_f = up_f;
        }
        const T up_w = F.zw(k + 1, cw), up_s = F.zw(k + 1, cs);
        const T hu = T(0.5) * (Hf + (up_w - z_w)) * F.HU[t] * on_u;
        const T hv = T(0.5) * (Hf + (up_s - z_s)) * F.HV[t] * om_v;
        F.HU[t] = hu;
        F.HV[t] = hv;
        A.Huon[o] = hu;
        A.Hvom[o] = hv;
        z_own = up_own;
        z_w = up_w;
        z_s = up_s;
      }
    }
  }
  copy_async_wait<0>();
  // the box's east column (Huon) and north row (Hvom): the flux at the
  // point's fill source f over u (v) there, from f and the column behind
  for (int e = tid; e < nextra; e += nth) {
    const int x = e % (F.ty + tx), kr = e / (F.ty + tx) * kRun;
    const bool xi = x < F.ty;
    const int J = F.j0 + (xi ? x : F.ty), I = F.i0 + (xi ? tx : x - F.ty);
    if (J >= g.Ny || I >= g.Nx) continue;
    const int Jx = fill_src(J, g.H, g.M, g.ns_per);
    const int Ix = fill_src(I, g.H, g.L, g.ew_per);
    const DepthCol<T> cf = F.col(Jx, Ix);
    const DepthCol<T> cb = xi ? F.col(Jx, wrap1(Ix - 1, g.Nx))
                              : F.col(wrap1(Jx - 1, g.Ny), Ix);
    const T m = F.metric(Jx, Ix, xi);
    T* HX = (xi ? F.HU : F.HV) + (xi ? x : F.ty) * bw + (xi ? tx : x - F.ty);
    const int k1x = kr + kRun < N ? kr + kRun : N;
    T z_f = F.zw0(kr, cf), z_b = F.zw0(kr, cb);
    for (int k = kr; k < k1x; ++k) {
      const T up_f = F.zw(k + 1, cf), up_b = F.zw(k + 1, cb);
      HX[k * F.nbox] =
          T(0.5) * ((up_f - z_f) + (up_b - z_b)) * HX[k * F.nbox] * m;
      z_f = up_f;
      z_b = up_b;
    }
  }
  __syncthreads();

  // B
  if (slot == 0 && live && inner) {
    T acc = T(0);
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      const T* hu = F.HU + k * F.nbox + bp;
      const T* hv = F.HV + k * F.nbox + bp;
      acc += (hu[1] - hu[0]) + (hv[bw] - hv[0]);
      F.DIV[k * npts + pt] = acc;
    }
  }
  __syncthreads();

  // C
  if (live && inner) {
    const DepthCol<T> own = F.col(j, i);
    const T wrk = omega_wrk(F.DIV[(N - 1) * npts + pt], F.zw(N, own), -own.h);
    for (int kw = w0 > 1 ? w0 : 1; kw < w1 && kw < N; ++kw) {
      T& d = F.DIV[(kw - 1) * npts + pt];
      d = omega_level(d, wrk, F.zw(kw, own), -own.h);
    }
  }
  __syncthreads();

  // D
  const int tc = F.tile(omega_src(j, g.H, g.M, g.ns_per),
                        omega_src(i, g.H, g.L, g.ew_per));
  if (!live || tc < 0) return;
  const T* sums = F.DIV + tc;
  const auto w_at = [&](int kw) {
    return kw == 0 || kw == N ? T(0) : sums[(kw - 1) * npts];
  };
  for (int kw = w0; kw < w1; ++kw) A.W[kw * S + p] = w_at(kw);
  const unsigned ys = omega_targets(j, g.H, g.M, g.ns_per, F.j0, F.ty);
  const unsigned xs = omega_targets(i, g.H, g.L, g.ew_per, F.i0, tx);
  if ((ys | xs) == 1u << 31) return;
  for (unsigned yb = ys; yb; yb &= yb - 1) {
    const int row = omega_target(yb, j, g.H, g.M) * g.Nx;
    for (unsigned xb = xs; xb; xb &= xb - 1) {
      const int o = row + omega_target(xb, i, g.H, g.L);
      if (o == p) continue;
      for (int kw = w0; kw < w1; ++kw) A.W[kw * S + o] = w_at(kw);
    }
  }
}

inline DiagParams diag_params(const int* ip, const double* dp) {
  DiagParams prm;
  prm.N = ip[0];
  prm.g.Ny = ip[1];
  prm.g.Nx = ip[2];
  prm.g.H = ip[3];
  prm.g.L = ip[4];
  prm.g.M = ip[5];
  prm.g.ew_per = ip[6];
  prm.g.ns_per = ip[7];
  prm.vtransform = ip[8];
  prm.hc = dp[0];
  prm.plan = FluxPlan{0, 0, 0, 0};
  return prm;
}

template <typename T>
FluxPtrs<T> flux_ptrs(void* const* ptr) {
  FluxPtrs<T> A;
  A.zeta = static_cast<const T*>(ptr[0]);
  A.h = static_cast<const T*>(ptr[1]);
  A.pm = static_cast<const T*>(ptr[2]);
  A.pn = static_cast<const T*>(ptr[3]);
  A.u = static_cast<const T*>(ptr[4]);
  A.v = static_cast<const T*>(ptr[5]);
  A.sc_r = static_cast<const T*>(ptr[6]);
  A.Cs_r = static_cast<const T*>(ptr[7]);
  A.sc_w = static_cast<const T*>(ptr[8]);
  A.Cs_w = static_cast<const T*>(ptr[9]);
  A.z_r = static_cast<T*>(ptr[10]);
  A.z_w = static_cast<T*>(ptr[11]);
  A.Hz = static_cast<T*>(ptr[12]);
  A.Huon = static_cast<T*>(ptr[13]);
  A.Hvom = static_cast<T*>(ptr[14]);
  A.W = static_cast<T*>(ptr[15]);
  return A;
}

// omega (omega.F:120-225): W from the bottom-up integral of the flux
// divergence with the moving-grid correction, then the zero-gradient BC
// on all sides and the halo fill, both as a gather of the source column.
// One thread per (j,i) water column, looping over k.
template <typename T>
__global__ void omega_kernel(const T* __restrict__ Huon,
                             const T* __restrict__ Hvom,
                             const T* __restrict__ z_w, T* __restrict__ W,
                             DiagParams prm) {
  const Geom& g = prm.g;
  const int S = g.Ny * g.Nx;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= S) return;
  const int N = prm.N;
  const int J = omega_src(p / g.Nx, g.H, g.M, g.ns_per);
  const int I = omega_src(p % g.Nx, g.H, g.L, g.ew_per);
  const int q = J * g.Nx + I;
  const int qip = J * g.Nx + wrap(I + 1, g.Nx);
  const int qjp = wrap(J + 1, g.Ny) * g.Nx + I;
  T acc = T(0);
  for (int k = 0; k < N; ++k) {
    const int o = k * S;
    acc += (Huon[o + qip] - Huon[o + q]) + (Hvom[o + qjp] - Hvom[o + q]);
  }
  const T zw0 = z_w[q];
  const T wrk = omega_wrk(acc, z_w[N * S + q], zw0);
  W[p] = T(0);
  acc = T(0);
  for (int k = 0; k < N - 1; ++k) {
    const int o = k * S;
    acc += (Huon[o + qip] - Huon[o + q]) + (Hvom[o + qjp] - Hvom[o + q]);
    W[(k + 1) * S + p] = omega_level(acc, wrk, z_w[(k + 1) * S + q], zw0);
  }
  W[N * S + p] = T(0);
}

// ---------------------------------------------------------------------------
// Equation of state (rho_eos.F): linear or Jackett & McDougall 1995, with
// the Brunt-Vaisala frequency when asked for.
// ---------------------------------------------------------------------------

// The launch of eos, chosen by ops/diag_cuda.eos_plan: padded points a
// tile (0: eos_kernel, a thread a point of the w grid; else eos_bvf_tile,
// a power of two up to 32), threads a block and the dynamic shared memory,
// which the entry point checks against eos_words.
struct EosPlan {
  int tile, threads, smem;
};

struct EosParams {
  int NT, N, S;
  int jm95, want_bvf, use_salt;
  double R0, R0Tcoef, T0, R0Scoef, S0;
  double neg_g_over_rho0;  // -(g/rho0), linear bvf
  double neg_g;            // -g, JM95 bvf
  EosPlan plan;
};

// shared words of an eos_bvf_tile block: den1, K0, K1, K2, z_r and z_w of
// every level and tile point
__host__ __device__ constexpr int eos_words(int N, int tile) {
  return 6 * N * tile;
}

template <typename T>
struct Jm95 {
  T den1, K0, K1, K2;
};

// _jm95_parts (rho_eos.F:247-322)
template <typename T>
__device__ __forceinline__ Jm95<T> jm95_parts(T Tt, T salt) {
  const T Ts = salt > T(0) ? salt : T(0);
  const T sqrtTs = sqrt(Ts);
  const T C0 = T(9.99842594e+02) +
               Tt * (T(6.793952e-02) +
                     Tt * (T(-9.095290e-03) +
                           Tt * (T(1.001685e-04) +
                                 Tt * (T(-1.120083e-06) +
                                       Tt * T(6.536332e-09)))));
  const T C1 = T(8.24493e-01) +
               Tt * (T(-4.08990e-03) +
                     Tt * (T(7.64380e-05) +
                           Tt * (T(-8.24670e-07) + Tt * T(5.38750e-09))));
  const T C2 = T(-5.72466e-03) + Tt * (T(1.02270e-04) + Tt * T(-1.65460e-06));
  Jm95<T> r;
  r.den1 = C0 + Ts * (C1 + sqrtTs * C2 + Ts * T(4.8314e-04));
  r.K0 = T(1.909256e+04) +
         Tt * (T(2.098925e+02) +
               Tt * (T(-3.041638e+00) +
                     Tt * (T(-1.852732e-03) + Tt * T(-1.361629e-05)))) +
         Ts * (T(1.044077e+02) +
               Tt * (T(-6.500517e+00) +
                     Tt * (T(1.553190e-01) + Tt * T(2.326469e-04))) +
               sqrtTs * (T(-5.587545e+00) +
                         Tt * (T(7.390729e-01) + Tt * T(-1.909078e-02))));
  r.K1 = T(4.721788e-01) +
         Tt * (T(1.028859e-02) +
               Tt * (T(-2.512549e-04) + Tt * T(-5.939910e-07))) +
         Ts * (T(-1.571896e-02) +
               Tt * (T(-2.598241e-04) + Tt * T(7.267926e-06)) +
               sqrtTs * T(2.042967e-03));
  r.K2 = T(1.045941e-05) + Tt * (T(-5.782165e-10) + Tt * T(1.296821e-07)) +
         Ts * (T(-2.595994e-07) +
               Tt * (T(-1.248266e-09) + Tt * T(-3.508914e-09)));
  return r;
}

template <typename T>
__device__ __forceinline__ T rho_linear(const EosParams& e, T temp, T salt) {
  T rho = T(e.R0) - T(e.R0Tcoef) * (temp - T(e.T0));
  if (e.use_salt) rho = rho + T(e.R0Scoef) * (salt - T(e.S0));
  return rho - T(1000);
}

// JM95 density of parts c at pressure proxy z (bvf: z_w)
template <typename T>
__device__ __forceinline__ T den_jm95(const Jm95<T>& c, T z) {
  const T bulk = c.K0 - z * (c.K1 - c.K2 * z);
  return c.den1 * bulk / (bulk + T(0.1) * z);
}

// The linear EOS (with or without bvf) and JM95 without bvf: one thread per
// point of the (N+1)-level w grid; thread (k,p) writes rho/pden at rho
// level k < N and bvf at w level k.
template <typename T>
__global__ void eos_kernel(const T* __restrict__ t,
                           const T* __restrict__ z_r, T* __restrict__ rho,
                           T* __restrict__ pden, T* __restrict__ bvf,
                           EosParams e) {
  const int S = e.S;
  const int N = e.N;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (N + 1) * S) return;
  const int k = idx / S;
  const int p = idx - k * S;
  const T* temp = t;
  const T* salt = e.NT >= 2 ? t + N * S : nullptr;
  auto sal = [&](int kk) { return salt ? salt[kk * S + p] : T(0); };
  if (k < N) {
    const T tk = temp[k * S + p];
    if (e.jm95) {
      const Jm95<T> c = jm95_parts(tk, sal(k));
      const T zr = z_r[k * S + p];
      const T bulk = c.K0 - zr * (c.K1 - zr * c.K2);
      rho[k * S + p] = (c.den1 * bulk) / (bulk + T(0.1) * zr) - T(1000);
      pden[k * S + p] = c.den1 - T(1000);
    } else {
      const T r = rho_linear(e, tk, sal(k));
      rho[k * S + p] = r;
      pden[k * S + p] = r;
    }
  }
  if (!e.want_bvf) return;
  if (k == 0 || k == N) {
    bvf[k * S + p] = T(0);
    return;
  }
  const T dz = z_r[k * S + p] - z_r[(k - 1) * S + p];
  const T r_up = rho_linear(e, temp[k * S + p], sal(k));
  const T r_dn = rho_linear(e, temp[(k - 1) * S + p], sal(k - 1));
  bvf[k * S + p] = T(e.neg_g_over_rho0) * (r_up - r_dn) / dz;
}

// JM95 with bvf on the run of `tile` padded points b * tile + [0, tile) of
// block tid's thread; sm: eos_words words.  The polynomials are evaluated
// once a point and level, where a thread a w point evaluated them for its
// two rho levels.  A thread owns run point tid % tile and a run of levels
// (its level slot).  Passes:
//   A  a thread per (level, point) copies temp, salt, z_r and z_w in
//      (cp.async, all levels in flight), evaluates jm95_parts once, writes
//      rho and pden and keeps den1, K0, K1 and K2 over temp and salt;
//   B  after a block barrier, a thread per (w level, point) forms bvf from
//      the parts of levels k and k - 1 at z_w[k].
template <typename T>
__device__ void eos_bvf_tile(const EosParams& e, const T* t, const T* z_r,
                             const T* z_w, T* rho, T* pden, T* bvf, T* sm,
                             int b, int tid) {
  const int S = e.S, N = e.N, tile = e.plan.tile;
  const int pt = tid % tile, slot = tid / tile;
  const int nslots = e.plan.threads / tile;
  const int p = b * tile + pt;
  const bool live = p < S;
  const T* salt = e.NT >= 2 ? t + N * S : nullptr;
  T* D1 = sm;                  // [k][point]: temp, then den1
  T* K0 = D1 + N * tile;       // salt, then K0
  T* K1 = K0 + N * tile;
  T* K2 = K1 + N * tile;
  T* ZR = K2 + N * tile;
  T* ZW = ZR + N * tile;       // z_w at levels 1 .. N-1
  const int k0 = slot * N / nslots, k1 = (slot + 1) * N / nslots;
  if (live) {
    for (int k = k0; k < k1; ++k) {
      const int s = k * tile + pt, q = k * S + p;
      copy_async(D1 + s, t + q);
      if (salt) copy_async(K0 + s, salt + q);
      copy_async(ZR + s, z_r + q);
      if (k > 0) copy_async(ZW + s, z_w + q);
    }
  }
  copy_async_commit();
  copy_async_wait<0>();
  if (live) {
    for (int k = k0; k < k1; ++k) {
      const int s = k * tile + pt, q = k * S + p;
      const Jm95<T> c = jm95_parts(D1[s], salt ? K0[s] : T(0));
      const T zr = ZR[s];
      const T bulk = c.K0 - zr * (c.K1 - zr * c.K2);
      rho[q] = (c.den1 * bulk) / (bulk + T(0.1) * zr) - T(1000);
      pden[q] = c.den1 - T(1000);
      D1[s] = c.den1;
      K0[s] = c.K0;
      K1[s] = c.K1;
      K2[s] = c.K2;
    }
  }
  __syncthreads();
  if (!live) return;
  const int w0 = slot * (N + 1) / nslots, w1 = (slot + 1) * (N + 1) / nslots;
  for (int k = w0; k < w1; ++k) {
    if (k == 0 || k == N) {
      bvf[k * S + p] = T(0);
      continue;
    }
    const int s = k * tile + pt, sd = s - tile;
    const T zwk = ZW[s];
    const T den_up = den_jm95(Jm95<T>{D1[s], K0[s], K1[s], K2[s]}, zwk);
    const T den_dn = den_jm95(Jm95<T>{D1[sd], K0[sd], K1[sd], K2[sd]}, zwk);
    const T dz = ZR[s] - ZR[sd];
    bvf[k * S + p] =
        T(e.neg_g) * (den_up - den_dn) / (T(0.5) * (den_up + den_dn) * dz);
  }
}

}  // namespace roms
