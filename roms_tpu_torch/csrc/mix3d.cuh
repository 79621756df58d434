// Harmonic viscosity along s-surfaces, uv3dmix2 (uv3dmix2_s.h K_LOOP), for
// one 2-D tile of padded (j,i) points and both directions per block.
//
// Replaces the TPU kernel roms_tpu/ops/mix3d_pallas.py::uv3dmix2_fused.
// Like it, the kernel adds into u_nnew, v_nnew, rufrc and rvfrc in place
// (the Pallas kernel donates them).
// Bound on the H100: bandwidth.  It must read u, v, Hz and u_nnew/v_nnew
// (5 (N,Ny,Nx) planes) and write u_nnew/v_nnew: ~30 MB at BENCHMARK1 in
// float32, 0.009 ms at 3.35 TB/s, for ~100 operations a point of each
// direction.  What keeps it from that is the latency of each level's
// loads and of the barriers between a level's steps.
// Design: block (bx, by) owns a tile of tx x ty points (the plan,
// ops/mix3d_cuda.uv3dmix2_plan) and both directions; its threads are ks
// level slots of one thread a tile point.  Slot s walks its own run of
// consecutive levels with its own barriers, as csrc/rhs3d.cuh's slots do.
// Once a block it works out the region's padded offsets (the tile and one
// point around it, wrapped) and the 2-D metric factors of mix3d.py: the
// sums pm + pm[j-1], pn + pn[i-1], ... over the region, pm/pn, pn/pm and
// on_r^2 visc2, om_r^2 visc2 on the tile's rho rectangle, sum_pm/sum_pn,
// sum_pn/sum_pm, om_p^2, on_p^2 and pmask on its psi rectangle.  At each
// level a slot
//   (a) copies u, v and Hz of the NEXT level over the region into its
//       second set of shared planes (cp.async: in flight while this level
//       computes), and loads its point's u_nnew and v_nnew;
//   (b) computes the two stress terms once each into shared memory: cff_r
//       on the rho rectangle (the tile and one row south and one column
//       west) as UFx and VFe, and cff_p pmask visc2 on the psi rectangle
//       (the tile and one row north and one column east) as UFe and VFx,
//       which the plain version forms at every point and shifts (each u
//       and each v point differences two of each);
//   (c) differences them at its point into du1 + du2 and dv1 - dv2 and
//       updates u_nnew and v_nnew.
// With more than one slot a point's per-level terms stay in shared memory,
// and after the last level one thread a point adds them in k order (one
// slot's threads for u, another's for v); with one slot the thread sums as
// it goes.  The sum is added to rufrc/rvfrc after it, as the plain version
// adds torch.sum(du1 + du2, dim=0).
// Neighbours wrap modulo the padded extent, as torch.roll does, so every
// padded point is computed, halo included.  Every value keeps the plain
// version's expression and operation order, so u_nnew and v_nnew are the
// plain version's bitwise; the column sum runs in k order, which torch.sum
// on the card does not, so rufrc/rvfrc differ from it by round-off.
#pragma once

#include "column.cuh"

namespace roms {

// The launch, chosen by ops/mix3d_cuda.uv3dmix2_plan: points of a tile along
// xi and eta, level slots, threads a block (tx * ty * ks) and the dynamic
// shared memory, which the entry point checks against uv3dmix2_smem.
struct MixPlan {
  int tx, ty, ks, threads, smem;
};

struct MixParams {
  Geom g;
  int N;
  MixPlan plan;
  double dt, visc2;
};

template <typename T>
struct MixPtrs {
  const T *u, *v, *Hz, *pm, *pn, *pmask;
  T *vel_nnew[2], *rfrc[2];   // read and written in place
};

// padded index of (j, i), each wrapped
__device__ __forceinline__ int at_ji(const Geom& g, int j, int i) {
  return wrap(j, g.Ny) * g.Nx + wrap(i, g.Nx);
}

// The shared arrays of a tile: the region, tx+2 x ty+2 points from (j0-1,
// i0-1), and the rho and psi rectangles, tx+1 x ty+1 points each, from
// (j0-1, i0-1) and from (j0, i0).
struct MixLayout {
  int rx, ra, fw, fa, npts;
  __host__ __device__ constexpr MixLayout(int tx, int ty)
      : rx(tx + 2), ra((tx + 2) * (ty + 2)), fw(tx + 1),
        fa((tx + 1) * (ty + 1)), npts(tx * ty) {}
  // words of T: a slot's two sets of 3 planes (u, v, Hz) and its 4 face
  // arrays; the region's 4 metric sums; the rho rectangle's 4 and the psi
  // rectangle's 5 factors; with more than one slot, du and dv of each
  // level and point
  __host__ __device__ constexpr int words(int ks, int N) const {
    return ks * (6 * ra + 4 * fa) + 4 * ra + 9 * fa +
           (ks > 1 ? 2 * N * npts : 0);
  }
};

__host__ __device__ constexpr int uv3dmix2_smem(int tx, int ty, int ks,
                                                int N, int word) {
  // and an int a region point: its padded offset
  return MixLayout(tx, ty).words(ks, N) * word + MixLayout(tx, ty).ra * 4;
}

// The tile (bx, by) of block tid's thread; sm: uv3dmix2_smem bytes.
// slot_sync() is the barrier of the thread's level slot (the tile's
// points); every thread reaches every barrier of its slot, and every
// __syncthreads().
template <typename T, class Sync>
__device__ void uv3dmix2_tile(const MixParams& P, const MixPtrs<T>& A,
                              unsigned char* sm, int bx, int by, int tid,
                              Sync slot_sync) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int tx = P.plan.tx, ty = P.plan.ty, ks = P.plan.ks;
  const MixLayout L(tx, ty);
  const int npts = L.npts, nth = ks * npts;
  const int rx = L.rx, ra = L.ra, fw = L.fw, fa = L.fa;
  const int i0 = bx * tx, j0 = by * ty;
  const int slot = tid / npts, pt = tid - slot * npts;
  const T visc2 = T(P.visc2);

  // shared arrays: this slot's two sets of planes u v Hz over the region
  // and its face arrays; the region's metric sums; the rectangles'
  // factors; the per-level terms; the region's padded offsets
  T* base = reinterpret_cast<T*>(sm);
  T* planes = base + slot * 6 * ra;
  T* fc = base + ks * 6 * ra + slot * 4 * fa;
  T* sums = base + ks * (6 * ra + 4 * fa);
  T *cx = sums, *cy = sums + ra, *px = sums + 2 * ra, *py = sums + 3 * ra;
  T* rho = sums + 4 * ra;
  T *ar = rho, *br = rho + fa, *Ar = rho + 2 * fa, *Br = rho + 3 * fa;
  T* psi = rho + 4 * fa;
  T *ap = psi, *bp = psi + fa, *Op = psi + 2 * fa, *Np = psi + 3 * fa,
    *pmk = psi + 4 * fa;
  T* terms = psi + 5 * fa;     // [k][d][point], with more than one slot
  int* off = reinterpret_cast<int*>(terms + (ks > 1 ? 2 * N * npts : 0));
  T *UFx = fc, *VFe = fc + fa, *UFe = fc + 2 * fa, *VFx = fc + 3 * fa;

  // region point (j0-1+y, i0-1+x): its offset and the sums im1(pn) + pn
  // (cx), jm1(pm) + pm (cy), jm1(pn) + pn (px) and im1(pm) + pm (py)
  for (Walk w(tid, nth, rx); w.e < ra; w.next()) {
    const int J = j0 - 1 + w.y, I = i0 - 1 + w.x;
    const int q = at_ji(g, J, I);
    const int qw = at_ji(g, J, I - 1), qs = at_ji(g, J - 1, I);
    off[w.e] = q;
    cx[w.e] = A.pn[qw] + A.pn[q];
    cy[w.e] = A.pm[qs] + A.pm[q];
    px[w.e] = A.pn[qs] + A.pn[q];
    py[w.e] = A.pm[qw] + A.pm[q];
  }
  for (Walk w(tid, nth, fw); w.e < fa; w.next()) {
    // rho point (j0-1+y, i0-1+x): pm/pn, pn/pm, on_r^2 visc2, om_r^2 visc2
    // (on_r = 1/pn, om_r = 1/pm)
    const int q = at_ji(g, j0 - 1 + w.y, i0 - 1 + w.x);
    const T pmq = A.pm[q], pnq = A.pn[q];
    const T on_r = T(1) / pnq, om_r = T(1) / pmq;
    ar[w.e] = pmq / pnq;
    br[w.e] = pnq / pmq;
    Ar[w.e] = on_r * on_r * visc2;
    Br[w.e] = om_r * om_r * visc2;
    // psi point (j0+y, i0+x): sum_pm/sum_pn, sum_pn/sum_pm, om_p^2, on_p^2
    // (om_p = 4/sum_pm, on_p = 4/sum_pn) and pmask
    const int J = j0 + w.y, I = i0 + w.x;
    const int s = at_ji(g, J, I), sw = at_ji(g, J, I - 1),
              ss = at_ji(g, J - 1, I), ssw = at_ji(g, J - 1, I - 1);
    const T spm = A.pm[ssw] + A.pm[sw] + A.pm[ss] + A.pm[s];
    const T spn = A.pn[ssw] + A.pn[sw] + A.pn[ss] + A.pn[s];
    const T om_p = T(1) / spm * T(4), on_p = T(1) / spn * T(4);
    ap[w.e] = spm / spn;
    bp[w.e] = spn / spm;
    Op[w.e] = om_p * om_p;
    Np[w.e] = on_p * on_p;
    pmk[w.e] = A.pmask[s];
  }
  __syncthreads();

  // this thread's point: its region, rho and psi rectangle places, padded
  // offset, and its factors cffu = dt/4 (pm + pm[i-1]) (pn + pn[i-1]),
  // 0.5 (pn + pn[i-1]), 0.5 (pm + pm[i-1]) and their v counterparts
  const int ly = pt / tx, lx = pt - ly * tx;
  const int j = j0 + ly, i = i0 + lx;
  const bool live = j < g.Ny && i < g.Nx;   // the tile's ragged edge
  const int p = live ? j * g.Nx + i : 0;
  const int cp = (ly + 1) * rx + lx + 1;
  const int fr = (ly + 1) * fw + lx + 1;
  const int fp = ly * fw + lx;
  const T cffu = T(P.dt * 0.25) * py[cp] * cx[cp];
  const T hpn_u = T(0.5) * cx[cp], hpm_u = T(0.5) * py[cp];
  const T cffv = T(P.dt * 0.25) * cy[cp] * px[cp];
  const T hpn_v = T(0.5) * px[cp], hpm_v = T(0.5) * cy[cp];

  // the slot's levels k0 .. k1 - 1; every slot makes nlev rounds
  const int nlev = (N + ks - 1) / ks;
  const int k0 = slot * nlev, k1 = min(N, k0 + nlev);
  auto copy_planes = [&](int k, T* dst) {
    const int o = k * S;
    for (int e = pt; e < ra; e += npts) {
      const int q = o + off[e];
      copy_async(dst + e, A.u + q);
      copy_async(dst + ra + e, A.v + q);
      copy_async(dst + 2 * ra + e, A.Hz + q);
    }
  };
  if (k0 < k1) copy_planes(k0, planes);
  copy_async_commit();
  T sum[2] = {T(0), T(0)};
  for (int n = 0; n < nlev; ++n) {
    const int k = k0 + n;
    const bool lev = k < k1;
    const int o = k * S;
    const T* pl = planes + (n & 1) * 3 * ra;
    const T *U = pl, *V = pl + ra, *HZ = pl + 2 * ra;
    // (a) the next level's planes, in flight through this one; this
    // level's u_nnew and v_nnew at the point
    if (k + 1 < k1) copy_planes(k + 1, planes + ((n + 1) & 1) * 3 * ra);
    copy_async_commit();
    const T un = lev && live ? A.vel_nnew[0][o + p] : T(0);
    const T vn = lev && live ? A.vel_nnew[1][o + p] : T(0);
    copy_async_wait<1>();     // this level's planes
    slot_sync();
    // (b) the stress terms of this level
    if (lev) {
      for (Walk w(pt, npts, fw); w.e < fa; w.next()) {
        // rho point (j0-1+y, i0-1+x), region (y, x)
        const int q = w.y * rx + w.x;
        const T du = cx[q + 1] * U[q + 1] - cx[q] * U[q];
        const T dv = cy[q + rx] * V[q + rx] - cy[q] * V[q];
        const T cff_r = HZ[q] * T(0.5) * (ar[w.e] * du - br[w.e] * dv);
        UFx[w.e] = Ar[w.e] * cff_r;
        VFe[w.e] = Br[w.e] * cff_r;
        // psi point (j0+y, i0+x), region (y+1, x+1)
        const int s = q + rx + 1;
        const T Hz_p =
            T(0.125) * (HZ[s - 1] + HZ[s] + HZ[s - rx - 1] + HZ[s - rx]);
        const T dvp = px[s] * V[s] - px[s - 1] * V[s - 1];
        const T dup = py[s] * U[s] - py[s - rx] * U[s - rx];
        const T cff_p =
            Hz_p * (ap[w.e] * dvp + bp[w.e] * dup) * pmk[w.e] * visc2;
        UFe[w.e] = Op[w.e] * cff_p;
        VFx[w.e] = Np[w.e] * cff_p;
      }
    }
    slot_sync();
    // (c) this level at the point: du1 + du2 and dv1 - dv2
    if (lev) {
      const T du1 = hpn_u * (UFx[fr] - UFx[fr - 1]);
      const T du2 = hpm_u * (UFe[fp + fw] - UFe[fp]);
      const T dku = du1 + du2;
      const T dv1 = hpn_v * (VFx[fp + 1] - VFx[fp]);
      const T dv2 = hpm_v * (VFe[fr] - VFe[fr - fw]);
      const T dkv = dv1 - dv2;
      if (live) {
        A.vel_nnew[0][o + p] = un + cffu * dku;
        A.vel_nnew[1][o + p] = vn + cffv * dkv;
      }
      if (ks > 1) {
        terms[2 * k * npts + pt] = dku;
        terms[(2 * k + 1) * npts + pt] = dkv;
      } else {
        sum[0] = sum[0] + dku;
        sum[1] = sum[1] + dkv;
      }
    }
  }

  // rufrc += sum_k (du1 + du2), rvfrc += sum_k (dv1 - dv2), in k order
  if (ks > 1) {
    __syncthreads();
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (slot != d || !live) continue;
      for (int k = 0; k < N; ++k)
        sum[d] = sum[d] + terms[(2 * k + d) * npts + pt];
    }
  }
#pragma unroll
  for (int d = 0; d < 2; ++d)
    if (live && slot == (ks > 1 ? d : 0))
      A.rfrc[d][p] = A.rfrc[d][p] + sum[d];
}

// ---------------------------------------------------------------------------
// Harmonic tracer diffusion rotated to geopotential surfaces, t3dmix2_geo
// (t3dmix2_geo.h), for one tile of padded (j,i) points and one tracer per
// block, walking k upwards.
//
// Replaces the TPU kernel roms_tpu/ops/mix3d_pallas.py::t3dmix2_geo_fused.
// Like it, the kernel adds into t_nnew in place (the Pallas kernel donates
// it), and recomputes on_u and om_v from pn and pm (its _grid_lite).
// Bound on the H100: bandwidth.  It must read t, Hz, z_r and t_nnew (4
// (N,Ny,Nx) planes a tracer, Hz and z_r shared), pm and pn, and write
// t_nnew: ~35 MB for BENCHMARK1's two tracers in float32, ~0.010 ms.
// Design: block (x, y, z) owns a kGeoTX x kGeoTY tile of rho points and the
// z-th tracer with tnu2 != 0 (the others are not touched), one thread a
// point.  It keeps in shared memory a rolling window of the planes that
// level k needs, each with a one-point halo and loaded once, neighbouring
// threads on neighbouring addresses: the tracer and z_r at levels k and
// k+1, dT/dz at interfaces k and k+1 and Hz at level k.  At each level it
// computes the triad fluxes of the port's ops/mix3d.py::_triad_fluxes_geo
// once: FX on the tile's u faces and FE on its v faces into shared memory,
// FS at the interface above each point in a register (FS below is carried
// from the level under it, and is 0 at the bottom and top interfaces);
// then the divergence and the update of t_nnew, while the next level's
// planes load.  Halo points take the wrapped indices of at_ji, so
// neighbours wrap modulo the padded extent as torch.roll does, and every
// padded point is computed, halo included.  Each FX, FE, FS and dT/dz
// keeps the plain version's expression and operation order, so the result
// is the plain version's bitwise.
struct GeoParams {
  Geom g;
  int N, ntr;
  int itrc[kMaxTr];     // tracer index of each blockIdx.z
  double c_h[kMaxTr];   // 0.25 * (2 tnu2): the FX/FE coefficient
  double c_s[kMaxTr];   // 0.5 tnu2: the FS coefficient
  double dt;
};

template <typename T>
struct GeoPtrs {
  const T *t, *Hz, *z_r, *pm, *pn;
  T* t_nnew;   // read and written in place
};

constexpr int kGeoTX = 32, kGeoTY = 8;            // the tile, in points
constexpr int kGeoThreads = kGeoTX * kGeoTY;      // one thread a point
constexpr int kGeoHX = kGeoTX + 2, kGeoHY = kGeoTY + 2;   // with its halo
constexpr int kGeoHalo = kGeoHX * kGeoHY;
constexpr int kGeoPer = (kGeoHalo + kGeoThreads - 1) / kGeoThreads;
constexpr int kGeoUF = kGeoTY * (kGeoTX + 1);    // u faces of a tile
constexpr int kGeoVF = (kGeoTY + 1) * kGeoTX;    // v faces of a tile

// A tile's shared memory.  Halo planes are [row][column] with the tile's
// point (ty, tx) at [ty + 1][tx + 1]; u face fi of row ty lies between
// halo columns fi and fi + 1, v face fj of column tx between halo rows fj
// and fj + 1.  A level's or interface's plane sits in slot (index % 2).
template <typename T>
struct GeoShared {
  T q[2][kGeoHY][kGeoHX];       // the tracer at levels k, k+1
  T zr[2][kGeoHY][kGeoHX];      // z_r at levels k, k+1
  T dz[2][kGeoHY][kGeoHX];      // dT/dz at interfaces k, k+1
  T Hz[kGeoHY][kGeoHX];         // Hz at level k
  T FX[kGeoTY][kGeoTX + 1];     // FX at level k
  T FE[kGeoTY + 1][kGeoTX];     // FE at level k
  T cffu[kGeoTY][kGeoTX + 1];   // 0.5 (pm + pm[i-1])
  T chu[kGeoTY][kGeoTX + 1];    // c_h on_u
  T cffv[kGeoTY + 1][kGeoTX];   // 0.5 (pn + pn[j-1])
  T chv[kGeoTY + 1][kGeoTX];    // c_h om_v
};

// The stencil pieces of _triad_fluxes_geo on a tile's shared planes.
template <typename T>
struct GeoTile {
  GeoShared<T>& s;
  using Plane = const T (*)[kGeoHX];

  // dZdx or dTdx of plane f at u face fi of row ty
  __device__ __forceinline__ T ddx(Plane f, int ty, int fi) const {
    return s.cffu[ty][fi] * (f[ty + 1][fi + 1] - f[ty + 1][fi]);
  }
  // dZde or dTde of plane f at v face fj of column tx
  __device__ __forceinline__ T dde(Plane f, int fj, int tx) const {
    return s.cffv[fj][tx] * (f[fj + 1][tx + 1] - f[fj][tx + 1]);
  }
  // FX at u face fi of row ty, level in slot c (its upper interface in
  // slot 1 - c), without the dt
  __device__ T FX(int c, int ty, int fi) const {
    const int n = 1 - c, h = ty + 1;
    const T dz = ddx(s.zr[c], ty, fi);
    const T m = fmin(dz, T(0));
    const T pp = fmax(dz, T(0));
    const T cfx = s.chu[ty][fi] * (s.Hz[h][fi + 1] + s.Hz[h][fi]);
    return cfx * (ddx(s.q[c], ty, fi) -
                  T(0.5) * (m * (s.dz[c][h][fi] + s.dz[n][h][fi + 1]) +
                            pp * (s.dz[n][h][fi] + s.dz[c][h][fi + 1])));
  }
  __device__ T FE(int c, int fj, int tx) const {
    const int n = 1 - c, h = tx + 1;
    const T dz = dde(s.zr[c], fj, tx);
    const T m = fmin(dz, T(0));
    const T pp = fmax(dz, T(0));
    const T cfe = s.chv[fj][tx] * (s.Hz[fj + 1][h] + s.Hz[fj][h]);
    return cfe * (dde(s.q[c], fj, tx) -
                  T(0.5) * (m * (s.dz[c][fj][h] + s.dz[n][fj + 1][h]) +
                            pp * (s.dz[n][fj][h] + s.dz[c][fj + 1][h])));
  }
  // FS at the interface between the levels in slots c (below) and 1 - c
  // (above) at point (ty, tx)
  __device__ T FS(T c_s, int c, int ty, int tx) const {
    const int n = 1 - c;
    const T dtz = s.dz[n][ty + 1][tx + 1];
    const T c1 = fmin(ddx(s.zr[c], ty, tx), T(0));
    const T c2 = fmin(ddx(s.zr[n], ty, tx + 1), T(0));
    const T c3 = fmax(ddx(s.zr[n], ty, tx), T(0));
    const T c4 = fmax(ddx(s.zr[c], ty, tx + 1), T(0));
    const T sx = c1 * (c1 * dtz - ddx(s.q[c], ty, tx)) +
                 c2 * (c2 * dtz - ddx(s.q[n], ty, tx + 1)) +
                 c3 * (c3 * dtz - ddx(s.q[n], ty, tx)) +
                 c4 * (c4 * dtz - ddx(s.q[c], ty, tx + 1));
    const T e1 = fmin(dde(s.zr[c], ty, tx), T(0));
    const T e2 = fmin(dde(s.zr[n], ty + 1, tx), T(0));
    const T e3 = fmax(dde(s.zr[n], ty, tx), T(0));
    const T e4 = fmax(dde(s.zr[c], ty + 1, tx), T(0));
    const T se = e1 * (e1 * dtz - dde(s.q[c], ty, tx)) +
                 e2 * (e2 * dtz - dde(s.q[n], ty + 1, tx)) +
                 e3 * (e3 * dtz - dde(s.q[n], ty, tx)) +
                 e4 * (e4 * dtz - dde(s.q[c], ty + 1, tx));
    return c_s * sx + c_s * se;
  }
  // dT/dz at the interface between the levels in slots lo and 1 - lo, at
  // halo element (hy, hx)
  __device__ __forceinline__ T dTdz(int lo, int hy, int hx) const {
    const int up = 1 - lo;
    return (s.q[up][hy][hx] - s.q[lo][hy][hx]) /
           (s.zr[up][hy][hx] - s.zr[lo][hy][hx]);
  }
};

// The body of the kernel (mix3d.cu): block (bx, by) of the tile grid and
// mixed tracer y, thread tid of kGeoThreads.  Every thread reaches every
// barrier.
template <typename T>
__device__ void t3dmix2_geo_tile(const GeoParams& P, const GeoPtrs<T>& A,
                                 GeoShared<T>& s, int bx, int by, int y,
                                 int tid) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int i0 = bx * kGeoTX, j0 = by * kGeoTY;
  const int tx = tid % kGeoTX, ty = tid / kGeoTX;
  const int j = j0 + ty, i = i0 + tx;
  const bool mine = j < g.Ny && i < g.Nx;   // the tile's ragged edge
  const int p = j * g.Nx + i;
  const size_t plane = static_cast<size_t>(N) * S;
  const T* q = A.t + P.itrc[y] * plane;
  T* tn = A.t_nnew + P.itrc[y] * plane;
  const T* pm = A.pm;
  const T* pn = A.pn;
  const T c_h = T(P.c_h[y]);
  const T c_s = T(P.c_s[y]);
  const T dt = T(P.dt);
  const GeoTile<T> G{s};

  // this thread's halo elements: (row, column) and padded index
  int hy[kGeoPer], hx[kGeoPer], off[kGeoPer];
  for (int r = 0; r < kGeoPer; ++r) {
    const int e = tid + r * kGeoThreads;
    hy[r] = e / kGeoHX;
    hx[r] = e - hy[r] * kGeoHX;
    off[r] = e < kGeoHalo ? at_ji(g, j0 - 1 + hy[r], i0 - 1 + hx[r]) : -1;
  }
  auto load = [&](T (*dst)[kGeoHX], const T* src, int k) {
    for (int r = 0; r < kGeoPer; ++r)
      if (off[r] >= 0) dst[hy[r]][hx[r]] = src[k * S + off[r]];
  };

  // the 2-D face coefficients, as Geo's cffu/cffv and FX/FE's on_u/om_v
  for (int e = tid; e < kGeoUF; e += kGeoThreads) {
    const int fy = e / (kGeoTX + 1), fi = e - fy * (kGeoTX + 1);
    const int qi = at_ji(g, j0 + fy, i0 + fi);
    const int qw = at_ji(g, j0 + fy, i0 + fi - 1);
    s.cffu[fy][fi] = T(0.5) * (pm[qi] + pm[qw]);
    const T on_u = T(1) / (pn[qw] + pn[qi]) * T(2);
    s.chu[fy][fi] = c_h * on_u;
  }
  for (int e = tid; e < kGeoVF; e += kGeoThreads) {
    const int fj = e / kGeoTX, fx = e - fj * kGeoTX;
    const int qj = at_ji(g, j0 + fj, i0 + fx);
    const int qs = at_ji(g, j0 + fj - 1, i0 + fx);
    s.cffv[fj][fx] = T(0.5) * (pn[qj] + pn[qs]);
    const T om_v = T(1) / (pm[qs] + pm[qj]) * T(2);
    s.chv[fj][fx] = c_h * om_v;
  }
  // levels 0 and 1, Hz at level 0 (N >= 3)
  load(s.q[0], q, 0);
  load(s.zr[0], A.z_r, 0);
  load(s.q[1], q, 1);
  load(s.zr[1], A.z_r, 1);
  load(s.Hz, A.Hz, 0);
  __syncthreads();
  // dT/dz at interfaces 0 (zero) and 1
  for (int r = 0; r < kGeoPer; ++r) {
    if (off[r] < 0) continue;
    s.dz[0][hy[r]][hx[r]] = T(0);
    s.dz[1][hy[r]][hx[r]] = G.dTdz(0, hy[r], hx[r]);
  }
  __syncthreads();

  const T pmn = mine ? pm[p] * pn[p] : T(0);
  T FS_lo = T(0);
  for (int k = 0; k < N; ++k) {
    const int c = k & 1;
    // FX and FE on the tile's faces, FS above the thread's point
    for (int e = tid; e < kGeoUF; e += kGeoThreads) {
      const int fy = e / (kGeoTX + 1), fi = e - fy * (kGeoTX + 1);
      s.FX[fy][fi] = G.FX(c, fy, fi);
    }
    for (int e = tid; e < kGeoVF; e += kGeoThreads) {
      const int fj = e / kGeoTX, fx = e - fj * kGeoTX;
      s.FE[fj][fx] = G.FE(c, fj, fx);
    }
    const T FS_hi = k + 1 < N ? G.FS(c_s, c, ty, tx) : T(0);
    __syncthreads();
    // level k+2's planes and level k+1's Hz into the slots level k used,
    // and the update of t_nnew at level k
    if (k + 2 < N) {
      load(s.q[c], q, k + 2);
      load(s.zr[c], A.z_r, k + 2);
    }
    if (k + 1 < N) load(s.Hz, A.Hz, k + 1);
    if (mine) {
      const T dx = s.FX[ty][tx + 1] - s.FX[ty][tx];
      const T de = s.FE[ty + 1][tx] - s.FE[ty][tx];
      const T div = pmn * (dx + de) + (FS_hi - FS_lo);
      tn[k * S + p] = tn[k * S + p] + dt * div;
    }
    FS_lo = FS_hi;
    __syncthreads();
    // dT/dz at interface k+2 (zero at the top interface N)
    if (k + 2 <= N) {
      for (int r = 0; r < kGeoPer; ++r)
        if (off[r] >= 0)
          s.dz[c][hy[r]][hx[r]] =
              k + 2 < N ? G.dTdz(1 - c, hy[r], hx[r]) : T(0);
      __syncthreads();
    }
  }
}

// the caller has checked 1 <= ip[8] <= kMaxTr
inline GeoParams geo_params(const int* ip, const double* dp) {
  GeoParams P;
  int n = 0;
  P.N = ip[n++];
  P.g.Ny = ip[n++];
  P.g.Nx = ip[n++];
  P.g.H = ip[n++];
  P.g.L = ip[n++];
  P.g.M = ip[n++];
  P.g.ew_per = ip[n++];
  P.g.ns_per = ip[n++];
  P.ntr = ip[n++];
  P.dt = dp[0];
  for (int y = 0; y < P.ntr; ++y) {
    P.itrc[y] = ip[n++];
    P.c_h[y] = dp[1 + 2 * y];
    P.c_s[y] = dp[2 + 2 * y];
  }
  return P;
}

template <typename T>
GeoPtrs<T> geo_ptrs(void* const* ptr) {
  GeoPtrs<T> A;
  A.t = static_cast<const T*>(ptr[0]);
  A.Hz = static_cast<const T*>(ptr[1]);
  A.z_r = static_cast<const T*>(ptr[2]);
  A.pm = static_cast<const T*>(ptr[3]);
  A.pn = static_cast<const T*>(ptr[4]);
  A.t_nnew = static_cast<T*>(ptr[5]);
  return A;
}

inline MixParams mix_params(const int* ip, const double* dp) {
  MixParams P;
  int n = 0;
  P.N = ip[n++];
  P.g.Ny = ip[n++];
  P.g.Nx = ip[n++];
  P.g.H = ip[n++];
  P.g.L = ip[n++];
  P.g.M = ip[n++];
  P.g.ew_per = ip[n++];
  P.g.ns_per = ip[n++];
  P.plan.tx = ip[n++];
  P.plan.ty = ip[n++];
  P.plan.ks = ip[n++];
  P.plan.threads = ip[n++];
  P.plan.smem = ip[n++];
  P.dt = dp[0];
  P.visc2 = dp[1];
  return P;
}

template <typename T>
MixPtrs<T> mix_ptrs(void* const* ptr) {
  MixPtrs<T> A;
  auto in = [&](int n) { return static_cast<const T*>(ptr[n]); };
  auto out = [&](int n) { return static_cast<T*>(ptr[n]); };
  A.u = in(0);
  A.v = in(1);
  A.Hz = in(2);
  A.pm = in(3);
  A.pn = in(4);
  A.pmask = in(5);
  A.vel_nnew[0] = out(6);
  A.vel_nnew[1] = out(7);
  A.rfrc[0] = out(8);
  A.rfrc[1] = out(9);
  return A;
}

}  // namespace roms
