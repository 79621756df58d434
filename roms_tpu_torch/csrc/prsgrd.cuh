// Baroclinic pressure gradient, prsgrd32 (splines density Jacobian,
// prsgrd32.h:119-285), for one water column per thread.
//
// Replaces the TPU kernel roms_tpu/ops/prsgrd_pallas.py::prsgrd32_fused.
// Bound on the H100: its work is bandwidth-bound (it reads rho, z_r, Hz,
// z_w, pm and pn once and writes ru and rv, about 6N planes, for ~110
// operations a (k,j,i) point), but at UPWELLING size it has one thread per
// water column, 4042 threads for 132 SMs, so the time is the latency of
// one thread's serial walk down its columns, not bytes or operations.
// Design: one thread per (j,i) column, looping over k, so neighbouring
// threads read neighbouring xi addresses.  The downward pressure integral
// P (prsgrd_pallas._scratch_rcumsum) runs in thread-local storage; the
// thread integrates its own column and its west and south neighbours (the
// xi and eta gradients need both), which triples that part of the work
// instead of a second launch through a device-memory P.  Neighbours wrap
// modulo the padded extent, as torch.roll does, so every padded point is
// computed, halo included, with no boundary write (prsgrd32 has none).
#pragma once

#include "column.cuh"

namespace roms {

struct PrsParams {
  Geom g;
  int N;
  double grav, GRho, HalfGRho;
};

template <typename T>
struct PrsPtrs {
  const T *rho, *z_r, *z_w, *Hz, *pm, *pn, *eq_tide;
  T *ru, *rv;
};

// prsgrd._harm_clamped: 2ab/(a+b) where 2ab > 1e-10, else 0
template <typename T>
__device__ __forceinline__ T harm_clamped(T a, T b) {
  const T cff = T(2) * a * b;
  return cff > T(1.0e-10) ? cff / (a + b) : T(0);
}

// P (N levels) of column q: the surface pressure and the downward integral
// of the density-Jacobian increments (prsgrd32.h:134-186).  The sum runs
// from the top down in k order, as the plain version's flipped cumsum.
template <typename T>
__device__ void column_pressure(const PrsParams& P, const PrsPtrs<T>& A,
                                int q, T* Pc, T* dRm, T* dZm) {
  const int S = P.g.Ny * P.g.Nx;
  const int N = P.N;
  const T* rho = A.rho;
  const T* zr = A.z_r;
  auto dRp = [&](int m) {   // the end-padded first differences
    const int a = clampi(m - 1, 0, N - 2);
    return rho[(a + 1) * S + q] - rho[a * S + q];
  };
  auto dZp = [&](int m) {
    const int a = clampi(m - 1, 0, N - 2);
    return zr[(a + 1) * S + q] - zr[a * S + q];
  };
  for (int k = 0; k < N; ++k) {
    dRm[k] = harm_clamped(dRp(k + 1), dRp(k));
    const T a = dZp(k + 1);
    const T b = dZp(k);
    dZm[k] = T(2) * a * b / (a + b);
  }
  const T g = T(P.grav);
  const T GRho = T(P.GRho);
  const T HalfGRho = T(P.HalfGRho);
  const T OneFifth = T(0.2);
  const T OneTwelfth = T(1.0 / 12.0);
  const T zwN = A.z_w[N * S + q];
  const T rN = rho[(N - 1) * S + q];
  const T rN1 = rho[(N - 2) * S + q];
  const T zN = zr[(N - 1) * S + q];
  const T zN1 = zr[(N - 2) * S + q];
  const T cff2 = T(0.5) * (rN - rN1) * (zwN - zN) / (zN - zN1);
  T top = g * zwN + GRho * (rN + cff2) * (zwN - zN);
  if (A.eq_tide) top = top - g * A.eq_tide[q];
  Pc[N - 1] = top;
  T acc = T(0);
  for (int k = N - 2; k >= 0; --k) {
    const T r0 = rho[k * S + q];
    const T r1 = rho[(k + 1) * S + q];
    const T z0 = zr[k * S + q];
    const T z1 = zr[(k + 1) * S + q];
    const T inc =
        HalfGRho *
        ((r1 + r0) * (z1 - z0) -
         OneFifth * ((dRm[k + 1] - dRm[k]) *
                         (z1 - z0 - OneTwelfth * (dZm[k + 1] + dZm[k])) -
                     (dZm[k + 1] - dZm[k]) *
                         (r1 - r0 - OneTwelfth * (dRm[k + 1] + dRm[k]))));
    acc = acc + inc;
    Pc[k] = top + acc;
  }
}

// One directional component at level k (prsgrd32.h:188-285) of point q,
// with neighbours qm (i-1 or j-1), qmm (i-2 or j-2) and qp (i+1 or j+1);
// metric = on_u or om_v at q, Pm = P of the qm column.
template <typename T>
__device__ __forceinline__ T prsgrd_component(const PrsParams& P,
                                              const PrsPtrs<T>& A, int o,
                                              int q, int qm, int qmm, int qp,
                                              T metric, T Pq, T Pm) {
  const T HalfGRho = T(P.HalfGRho);
  const T OneFifth = T(0.2);
  const T OneTwelfth = T(1.0 / 12.0);
  const T* r = A.rho + o;
  const T* z = A.z_r + o;
  const T dz = z[q] - z[qm];
  const T dz_m = z[qm] - z[qmm];
  const T dz_p = z[qp] - z[q];
  const T dr = r[q] - r[qm];
  const T dr_m = r[qm] - r[qmm];
  const T dr_p = r[qp] - r[q];
  const T dZ = harm_clamped(dz, dz_p);
  const T dZ_m = harm_clamped(dz_m, dz);
  const T dR = harm_clamped(dr, dr_p);
  const T dR_m = harm_clamped(dr_m, dr);
  return metric * T(0.5) * (A.Hz[o + q] + A.Hz[o + qm]) *
         (Pm - Pq -
          HalfGRho * ((r[q] + r[qm]) * dz -
                      OneFifth * ((dR - dR_m) * (dz - OneTwelfth * (dZ + dZ_m)) -
                                  (dZ - dZ_m) * (dr - OneTwelfth * (dR + dR_m)))));
}

template <typename T>
__device__ void prsgrd32_column(const PrsParams& P, const PrsPtrs<T>& A,
                                int p) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int j = p / g.Nx;
  const int i = p - j * g.Nx;
  const int row = j * g.Nx;
  const int qw = row + wrap(i - 1, g.Nx);
  const int qww = row + wrap(i - 2, g.Nx);
  const int qe = row + wrap(i + 1, g.Nx);
  const int qs = wrap(j - 1, g.Ny) * g.Nx + i;
  const int qss = wrap(j - 2, g.Ny) * g.Nx + i;
  const int qn = wrap(j + 1, g.Ny) * g.Nx + i;
  T Pc[kMaxN], Pw[kMaxN], Ps[kMaxN], dRm[kMaxN], dZm[kMaxN];
  column_pressure(P, A, p, Pc, dRm, dZm);
  column_pressure(P, A, qw, Pw, dRm, dZm);
  column_pressure(P, A, qs, Ps, dRm, dZm);
  // on_u = 2/(pn[i-1] + pn[i]), om_v = 2/(pm[j-1] + pm[j]) (grid.py)
  const T on_u = T(1) / (A.pn[qw] + A.pn[p]) * T(2);
  const T om_v = T(1) / (A.pm[qs] + A.pm[p]) * T(2);
  for (int k = 0; k < P.N; ++k) {
    const int o = k * S;
    A.ru[o + p] =
        prsgrd_component(P, A, o, p, qw, qww, qe, on_u, Pc[k], Pw[k]);
    A.rv[o + p] =
        prsgrd_component(P, A, o, p, qs, qss, qn, om_v, Pc[k], Ps[k]);
  }
}

inline PrsParams prsgrd_params(const int* ip, const double* dp) {
  PrsParams P;
  P.N = ip[0];
  P.g.Ny = ip[1];
  P.g.Nx = ip[2];
  P.g.H = ip[3];
  P.g.L = ip[4];
  P.g.M = ip[5];
  P.g.ew_per = ip[6];
  P.g.ns_per = ip[7];
  P.grav = dp[0];
  P.GRho = dp[1];
  P.HalfGRho = dp[2];
  return P;
}

template <typename T>
PrsPtrs<T> prsgrd_ptrs(void* const* ptr) {
  PrsPtrs<T> A;
  A.rho = static_cast<const T*>(ptr[0]);
  A.z_r = static_cast<const T*>(ptr[1]);
  A.z_w = static_cast<const T*>(ptr[2]);
  A.Hz = static_cast<const T*>(ptr[3]);
  A.pm = static_cast<const T*>(ptr[4]);
  A.pn = static_cast<const T*>(ptr[5]);
  A.eq_tide = static_cast<const T*>(ptr[6]);
  A.ru = static_cast<T*>(ptr[7]);
  A.rv = static_cast<T*>(ptr[8]);
  return A;
}

}  // namespace roms
