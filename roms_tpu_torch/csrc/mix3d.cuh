// Harmonic viscosity along s-surfaces, uv3dmix2 (uv3dmix2_s.h K_LOOP), for
// one padded (j,i) point and direction per thread, looping over k.
//
// Replaces the TPU kernel roms_tpu/ops/mix3d_pallas.py::uv3dmix2_fused.
// Like it, the kernel adds into u_nnew, v_nnew, rufrc and rvfrc in place
// (the Pallas kernel donates them).
// Bound on the H100: bandwidth (it reads u, v, Hz and u_nnew/v_nnew, about
// 5 (N,Ny,Nx) planes, and writes 2, for ~100 operations a point of each
// direction), but at UPWELLING size one thread per point and direction is
// ~8000 threads for 132 SMs, so the time is one thread's serial k-walk.
// Design: one thread per padded point, blockIdx.y the direction (u or v),
// both in one launch.  The two stress terms the stencil differences,
// cff_r at rho points and cff_p at psi points (mix3d.py), are recomputed
// by each thread at the two points it needs (i and i-1 or j and j-1 for
// cff_r, j and j+1 or i and i+1 for cff_p) rather than staged through
// device memory, as csrc/prsgrd.cuh recomputes its neighbours' pressure.
// Neighbours wrap modulo the padded extent, as torch.roll does, so every
// padded point is computed, halo included.  The column sum into
// rufrc/rvfrc runs in k order in the thread and is added after the sum, as
// the plain version adds torch.sum(du1 + du2, dim=0).
#pragma once

#include "column.cuh"

namespace roms {

struct MixParams {
  Geom g;
  int N;
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

// cff_r at rho point (j, i) of level plane o (mix3d.py uv3dmix2)
template <typename T>
__device__ __forceinline__ T mix_cff_r(const Geom& g, const MixPtrs<T>& A,
                                       int o, int j, int i) {
  const T* pm = A.pm;
  const T* pn = A.pn;
  const T* u = A.u + o;
  const T* v = A.v + o;
  const int q = at_ji(g, j, i);
  const int qe = at_ji(g, j, i + 1);
  const int qw = at_ji(g, j, i - 1);
  const int qn = at_ji(g, j + 1, i);
  const int qs = at_ji(g, j - 1, i);
  const T du = (pn[q] + pn[qe]) * u[qe] - (pn[qw] + pn[q]) * u[q];
  const T dv = (pm[q] + pm[qn]) * v[qn] - (pm[qs] + pm[q]) * v[q];
  return A.Hz[o + q] * T(0.5) * (pm[q] / pn[q] * du - pn[q] / pm[q] * dv);
}

// cff_p at psi point (j, i) of level plane o, times pmask and visc2
template <typename T>
__device__ __forceinline__ T mix_cff_p(const Geom& g, const MixPtrs<T>& A,
                                       T visc2, int o, int j, int i) {
  const T* pm = A.pm;
  const T* pn = A.pn;
  const T* u = A.u + o;
  const T* v = A.v + o;
  const T* Hz = A.Hz + o;
  const int q = at_ji(g, j, i);
  const int qw = at_ji(g, j, i - 1);
  const int qs = at_ji(g, j - 1, i);
  const int qsw = at_ji(g, j - 1, i - 1);
  const T sum_pm = pm[qsw] + pm[qw] + pm[qs] + pm[q];
  const T sum_pn = pn[qsw] + pn[qw] + pn[qs] + pn[q];
  const T Hz_p = T(0.125) * (Hz[qw] + Hz[q] + Hz[qsw] + Hz[qs]);
  const T dv = (pn[qs] + pn[q]) * v[q] - (pn[qsw] + pn[qw]) * v[qw];
  const T du = (pm[qw] + pm[q]) * u[q] - (pm[qsw] + pm[qs]) * u[qs];
  const T cff_p = Hz_p * (sum_pm / sum_pn * dv + sum_pn / sum_pm * du);
  return cff_p * A.pmask[q] * visc2;
}

template <typename T>
__device__ void uv3dmix2_column(const MixParams& P, const MixPtrs<T>& A,
                                int p, int d) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int j = p / g.Nx;
  const int i = p - j * g.Nx;
  const T* pm = A.pm;
  const T* pn = A.pn;
  const T visc2 = T(P.visc2);
  // the point behind (i-1 for u, j-1 for v) and the metric factors there
  const int qm = d == 0 ? at_ji(g, j, i - 1) : at_ji(g, j - 1, i);
  const T cff = T(P.dt * 0.25) * (pm[qm] + pm[p]) * (pn[qm] + pn[p]);
  const T hpn = T(0.5) * (pn[qm] + pn[p]);
  const T hpm = T(0.5) * (pm[qm] + pm[p]);
  // on_r^2 and om_r^2 (on_r = 1/pn, om_r = 1/pm) at p and qm, and
  // om_p^2 or on_p^2 (4/sum_pm, 4/sum_pn) at the two psi points
  auto sq_r = [&](const T* m, int q) {
    const T r = T(1) / m[q];
    return r * r;
  };
  auto sq_p = [&](const T* m, int jj, int ii) {
    const T s = m[at_ji(g, jj - 1, ii - 1)] + m[at_ji(g, jj, ii - 1)] +
                m[at_ji(g, jj - 1, ii)] + m[at_ji(g, jj, ii)];
    const T r = T(1) / s * T(4);
    return r * r;
  };
  T sum = T(0);
  T* vn = A.vel_nnew[d];
  for (int k = 0; k < P.N; ++k) {
    const int o = k * S;
    T dk;
    if (d == 0) {
      // du1 = 0.5 (pn[i-1] + pn) (UFx - UFx[i-1]), UFx = on_r^2 visc2 cff_r
      // du2 = 0.5 (pm[i-1] + pm) (UFe[j+1] - UFe), UFe = om_p^2 cff_p
      const T UFx = sq_r(pn, p) * visc2 * mix_cff_r(g, A, o, j, i);
      const T UFx_m = sq_r(pn, qm) * visc2 * mix_cff_r(g, A, o, j, i - 1);
      const T UFe_n =
          sq_p(pm, j + 1, i) * mix_cff_p(g, A, visc2, o, j + 1, i);
      const T UFe = sq_p(pm, j, i) * mix_cff_p(g, A, visc2, o, j, i);
      const T du1 = hpn * (UFx - UFx_m);
      const T du2 = hpm * (UFe_n - UFe);
      dk = du1 + du2;
    } else {
      // dv1 = 0.5 (pn[j-1] + pn) (VFx[i+1] - VFx), VFx = on_p^2 cff_p
      // dv2 = 0.5 (pm[j-1] + pm) (VFe - VFe[j-1]), VFe = om_r^2 visc2 cff_r
      const T VFx_e =
          sq_p(pn, j, i + 1) * mix_cff_p(g, A, visc2, o, j, i + 1);
      const T VFx = sq_p(pn, j, i) * mix_cff_p(g, A, visc2, o, j, i);
      const T VFe = sq_r(pm, p) * visc2 * mix_cff_r(g, A, o, j, i);
      const T VFe_m = sq_r(pm, qm) * visc2 * mix_cff_r(g, A, o, j - 1, i);
      const T dv1 = hpn * (VFx_e - VFx);
      const T dv2 = hpm * (VFe - VFe_m);
      dk = dv1 - dv2;
    }
    sum = sum + dk;
    vn[o + p] = vn[o + p] + cff * dk;
  }
  A.rfrc[d][p] = A.rfrc[d][p] + sum;
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
