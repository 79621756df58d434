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
// (t3dmix2_geo.h), for one padded (j,i) point and tracer per thread,
// looping over k upwards.
//
// Replaces the TPU kernel roms_tpu/ops/mix3d_pallas.py::t3dmix2_geo_fused.
// Like it, the kernel adds into t_nnew in place (the Pallas kernel donates
// it), and recomputes on_u and om_v from pn and pm (its _grid_lite).
// Bound on the H100: bandwidth.  It must read t, Hz, z_r and t_nnew (4
// (N,Ny,Nx) planes a tracer, Hz and z_r shared), pm and pn, and write
// t_nnew: ~35 MB for BENCHMARK1's two tracers in float32, ~0.010 ms.
// Design: thread (p, y) owns padded point p and the y-th tracer with
// tnu2 != 0 (the others are not touched).  The triad fluxes of the port's
// ops/mix3d.py::_triad_fluxes_geo are recomputed where the thread needs
// them rather than staged through device memory: FX at its two xi faces
// and FE at its two eta faces of each level, and FS at the interface above
// the level; FS at the interface below is carried from the level under it
// as a rolling value, and is 0 at the bottom and top interfaces.
// Neighbours wrap modulo the padded extent, as torch.roll does, so every
// padded point is computed, halo included.  Each expression keeps the
// plain version's operation order.
struct GeoParams {
  Geom g;
  int N, ntr;
  int itrc[kMaxTr];     // tracer index of each blockIdx.y
  double c_h[kMaxTr];   // 0.25 * (2 tnu2): the FX/FE coefficient
  double c_s[kMaxTr];   // 0.5 tnu2: the FS coefficient
  double dt;
};

template <typename T>
struct GeoPtrs {
  const T *t, *Hz, *z_r, *pm, *pn;
  T* t_nnew;   // read and written in place
};

// One tracer's fields and the stencil pieces of _triad_fluxes_geo.
template <typename T>
struct Geo {
  const Geom& g;
  int S, N;
  const T *q, *Hz, *z_r, *pm, *pn;

  __device__ __forceinline__ int at(int j, int i) const {
    return at_ji(g, j, i);
  }
  // dZdx, dTdx at u point (j, i) of level k: 0.5 (pm + pm[i-1]) * diff
  __device__ __forceinline__ T cffu(int j, int i) const {
    return T(0.5) * (pm[at(j, i)] + pm[at(j, i - 1)]);
  }
  __device__ __forceinline__ T cffv(int j, int i) const {
    return T(0.5) * (pn[at(j, i)] + pn[at(j - 1, i)]);
  }
  __device__ __forceinline__ T dZdx(int k, int j, int i) const {
    const int o = k * S;
    return cffu(j, i) * (z_r[o + at(j, i)] - z_r[o + at(j, i - 1)]);
  }
  __device__ __forceinline__ T dTdx(int k, int j, int i) const {
    const int o = k * S;
    return cffu(j, i) * (q[o + at(j, i)] - q[o + at(j, i - 1)]);
  }
  __device__ __forceinline__ T dZde(int k, int j, int i) const {
    const int o = k * S;
    return cffv(j, i) * (z_r[o + at(j, i)] - z_r[o + at(j - 1, i)]);
  }
  __device__ __forceinline__ T dTde(int k, int j, int i) const {
    const int o = k * S;
    return cffv(j, i) * (q[o + at(j, i)] - q[o + at(j - 1, i)]);
  }
  // dT/dz at interface kw (0 at kw = 0 and kw = N)
  __device__ __forceinline__ T dTdz(int kw, int j, int i) const {
    if (kw <= 0 || kw >= N) return T(0);
    const int q1 = kw * S + at(j, i);
    const int q0 = q1 - S;
    return (q[q1] - q[q0]) / (z_r[q1] - z_r[q0]);
  }
  // FX at u point (j, i) of level k, without its coefficient c_h
  __device__ T FX(T c_h, int k, int j, int i) const {
    const T dz = dZdx(k, j, i);
    const T m = fmin(dz, T(0));
    const T pp = fmax(dz, T(0));
    const T on_u = T(1) / (pn[at(j, i - 1)] + pn[at(j, i)]) * T(2);
    const int o = k * S;
    const T cfx = c_h * on_u * (Hz[o + at(j, i)] + Hz[o + at(j, i - 1)]);
    return cfx * (dTdx(k, j, i) -
                  T(0.5) * (m * (dTdz(k, j, i - 1) + dTdz(k + 1, j, i)) +
                            pp * (dTdz(k + 1, j, i - 1) + dTdz(k, j, i))));
  }
  __device__ T FE(T c_h, int k, int j, int i) const {
    const T dz = dZde(k, j, i);
    const T m = fmin(dz, T(0));
    const T pp = fmax(dz, T(0));
    const T om_v = T(1) / (pm[at(j - 1, i)] + pm[at(j, i)]) * T(2);
    const int o = k * S;
    const T cfe = c_h * om_v * (Hz[o + at(j, i)] + Hz[o + at(j - 1, i)]);
    return cfe * (dTde(k, j, i) -
                  T(0.5) * (m * (dTdz(k, j - 1, i) + dTdz(k + 1, j, i)) +
                            pp * (dTdz(k + 1, j - 1, i) + dTdz(k, j, i))));
  }
  // FS at interior interface kw (1..N-1) of rho point (j, i)
  __device__ T FS(T c_s, int kw, int j, int i) const {
    const int kd = kw - 1;
    const T dtz = dTdz(kw, j, i);
    const T c1 = fmin(dZdx(kd, j, i), T(0));
    const T c2 = fmin(dZdx(kw, j, i + 1), T(0));
    const T c3 = fmax(dZdx(kw, j, i), T(0));
    const T c4 = fmax(dZdx(kd, j, i + 1), T(0));
    const T sx = c1 * (c1 * dtz - dTdx(kd, j, i)) +
                 c2 * (c2 * dtz - dTdx(kw, j, i + 1)) +
                 c3 * (c3 * dtz - dTdx(kw, j, i)) +
                 c4 * (c4 * dtz - dTdx(kd, j, i + 1));
    const T e1 = fmin(dZde(kd, j, i), T(0));
    const T e2 = fmin(dZde(kw, j + 1, i), T(0));
    const T e3 = fmax(dZde(kw, j, i), T(0));
    const T e4 = fmax(dZde(kd, j + 1, i), T(0));
    const T se = e1 * (e1 * dtz - dTde(kd, j, i)) +
                 e2 * (e2 * dtz - dTde(kw, j + 1, i)) +
                 e3 * (e3 * dtz - dTde(kw, j, i)) +
                 e4 * (e4 * dtz - dTde(kd, j + 1, i));
    return c_s * sx + c_s * se;
  }
};

template <typename T>
__device__ void t3dmix2_geo_column(const GeoParams& P, const GeoPtrs<T>& A,
                                   int p, int y) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int j = p / g.Nx;
  const int i = p - j * g.Nx;
  const int N = P.N;
  const size_t plane = static_cast<size_t>(N) * S;
  const int itrc = P.itrc[y];
  const Geo<T> G{g, S, N, A.t + itrc * plane, A.Hz, A.z_r, A.pm, A.pn};
  T* tn = A.t_nnew + itrc * plane;
  const T c_h = T(P.c_h[y]);
  const T c_s = T(P.c_s[y]);
  const T dt = T(P.dt);
  const T pmn = A.pm[p] * A.pn[p];
  T FS_lo = T(0);
  for (int k = 0; k < N; ++k) {
    const T FS_hi = k + 1 < N ? G.FS(c_s, k + 1, j, i) : T(0);
    const T dx = G.FX(c_h, k, j, i + 1) - G.FX(c_h, k, j, i);
    const T de = G.FE(c_h, k, j + 1, i) - G.FE(c_h, k, j, i);
    const T div = pmn * (dx + de) + (FS_hi - FS_lo);
    tn[k * S + p] = tn[k * S + p] + dt * div;
    FS_lo = FS_hi;
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
