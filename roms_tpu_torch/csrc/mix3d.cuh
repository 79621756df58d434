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
