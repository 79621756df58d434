// Diagnostic ("time n") kernels of the baroclinic step: set_depth, mass
// fluxes, omega, and the equation of state.
//
// Replaces the TPU kernels roms_tpu/ops/diag_pallas.py::grid_flux_fused,
// ::omega_fused and ::eos_fused.  All three are bound by device-memory
// bandwidth: a handful of operations per byte moved.  Design: one thread
// per (j,i) water column, looping over k, so that neighbouring threads
// read neighbouring xi addresses (coalesced); the column sums of omega stay
// in registers.  The eos kernel runs one thread per point.  Nothing else is
// done about bandwidth yet: grid_flux writes z_r/z_w/Hz and reads Hz back
// in the next launch, where one fused launch could keep it on chip.
#pragma once

#include "bc.cuh"

namespace roms {

struct DiagParams {
  Geom g;
  int N;
  int vtransform;
  double hc;
};

// set_depth (set_depth.F:160-250) for one column p
template <typename T>
__global__ void depth_kernel(const T* __restrict__ zeta,
                             const T* __restrict__ h,
                             const T* __restrict__ sc_r,
                             const T* __restrict__ Cs_r,
                             const T* __restrict__ sc_w,
                             const T* __restrict__ Cs_w, T* __restrict__ z_r,
                             T* __restrict__ z_w, T* __restrict__ Hz,
                             DiagParams prm) {
  const int S = prm.g.Ny * prm.g.Nx;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= S) return;
  const int N = prm.N;
  const T hc = T(prm.hc);
  const T hp = h[p];
  const T zp = zeta[p];
  T zw_below = -hp;
  z_w[p] = zw_below;
  if (prm.vtransform == 2) {
    const T hinv = T(1) / (hc + hp);
    for (int k = 0; k < N; ++k) {
      const T cff_w = (hc * sc_w[k + 1] + Cs_w[k + 1] * hp) * hinv;
      const T zw = zp + (zp + hp) * cff_w;
      const T cff_r = (hc * sc_r[k] + Cs_r[k] * hp) * hinv;
      z_r[k * S + p] = zp + (zp + hp) * cff_r;
      z_w[(k + 1) * S + p] = zw;
      Hz[k * S + p] = zw - zw_below;
      zw_below = zw;
    }
  } else {  // vtransform 1
    const T hinv = T(1) / hp;
    for (int k = 0; k < N; ++k) {
      const T z_w0 = hc * (sc_w[k + 1] - Cs_w[k + 1]) + Cs_w[k + 1] * hp;
      const T zw = z_w0 + zp * (T(1) + z_w0 * hinv);
      const T z_r0 = hc * (sc_r[k] - Cs_r[k]) + Cs_r[k] * hp;
      z_r[k * S + p] = z_r0 + zp * (T(1) + z_r0 * hinv);
      z_w[(k + 1) * S + p] = zw;
      Hz[k * S + p] = zw - zw_below;
      zw_below = zw;
    }
  }
}

// set_massflux with its halo fill folded in: the output point (j,i) copies
// the flux computed at its fill source point.
template <typename T>
__global__ void massflux_kernel(const T* __restrict__ Hz,
                                const T* __restrict__ u,
                                const T* __restrict__ v,
                                const T* __restrict__ pm,
                                const T* __restrict__ pn,
                                T* __restrict__ Huon, T* __restrict__ Hvom,
                                DiagParams prm) {
  const Geom& g = prm.g;
  const int S = g.Ny * g.Nx;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= S) return;
  const int J = fill_src(p / g.Nx, g.H, g.M, g.ns_per);
  const int I = fill_src(p % g.Nx, g.H, g.L, g.ew_per);
  const int q = J * g.Nx + I;
  const int qim = J * g.Nx + wrap(I - 1, g.Nx);
  const int qjm = wrap(J - 1, g.Ny) * g.Nx + I;
  const T on_u = T(2) / (pn[qim] + pn[q]);
  const T om_v = T(2) / (pm[qjm] + pm[q]);
  for (int k = 0; k < prm.N; ++k) {
    const int o = k * S;
    Huon[o + p] = T(0.5) * (Hz[o + q] + Hz[o + qim]) * u[o + q] * on_u;
    Hvom[o + p] = T(0.5) * (Hz[o + q] + Hz[o + qjm]) * v[o + q] * om_v;
  }
}

// omega (omega.F:120-225): W from the bottom-up integral of the flux
// divergence with the moving-grid correction, then the zero-gradient BC
// on all sides and the halo fill, both as a gather of the source column.
// Shared by grid_flux and omega.
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
  const int J = rho_bc_src(fill_src(p / g.Nx, g.H, g.M, g.ns_per), g.H, g.M,
                           g.ns_per, BC_GRA, BC_GRA);
  const int I = rho_bc_src(fill_src(p % g.Nx, g.H, g.L, g.ew_per), g.H, g.L,
                           g.ew_per, BC_GRA, BC_GRA);
  const int q = J * g.Nx + I;
  const int qip = J * g.Nx + wrap(I + 1, g.Nx);
  const int qjp = wrap(J + 1, g.Ny) * g.Nx + I;
  T acc = T(0);
  for (int k = 0; k < N; ++k) {
    const int o = k * S;
    acc += (Huon[o + qip] - Huon[o + q]) + (Hvom[o + qjp] - Hvom[o + q]);
  }
  const T zw0 = z_w[q];
  const T wrk = (-acc) / (z_w[N * S + q] - zw0);
  W[p] = T(0);
  acc = T(0);
  for (int k = 0; k < N - 1; ++k) {
    const int o = k * S;
    acc += (Huon[o + qip] - Huon[o + q]) + (Hvom[o + qjp] - Hvom[o + q]);
    W[(k + 1) * S + p] = (-acc) - wrk * (z_w[(k + 1) * S + q] - zw0);
  }
  W[N * S + p] = T(0);
}

// ---------------------------------------------------------------------------
// Equation of state (rho_eos.F): linear or Jackett & McDougall 1995, with
// the Brunt-Vaisala frequency when asked for.  One thread per point of the
// (N+1)-level w grid; thread (k,p) writes rho/pden at rho level k < N and
// bvf at w level k.
// ---------------------------------------------------------------------------
struct EosParams {
  int NT, N, S;
  int jm95, want_bvf, use_salt;
  double R0, R0Tcoef, T0, R0Scoef, S0;
  double neg_g_over_rho0;  // -(g/rho0), linear bvf
  double neg_g;            // -g, JM95 bvf
};

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

// density at rho level k, pressure proxy z (in-situ: z_r, bvf: z_w)
template <typename T>
__device__ __forceinline__ T den_jm95(const Jm95<T>& c, T z) {
  const T bulk = c.K0 - z * (c.K1 - c.K2 * z);
  return c.den1 * bulk / (bulk + T(0.1) * z);
}

template <typename T>
__global__ void eos_kernel(const T* __restrict__ t,
                           const T* __restrict__ z_r,
                           const T* __restrict__ z_w, T* __restrict__ rho,
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
  if (e.jm95) {
    const T zwk = z_w[k * S + p];
    const Jm95<T> up = jm95_parts(temp[k * S + p], sal(k));
    const Jm95<T> dn = jm95_parts(temp[(k - 1) * S + p], sal(k - 1));
    const T den_up = den_jm95(up, zwk);
    const T den_dn = den_jm95(dn, zwk);
    bvf[k * S + p] =
        T(e.neg_g) * (den_up - den_dn) / (T(0.5) * (den_up + den_dn) * dz);
  } else {
    const T r_up = rho_linear(e, temp[k * S + p], sal(k));
    const T r_dn = rho_linear(e, temp[(k - 1) * S + p], sal(k - 1));
    bvf[k * S + p] = T(e.neg_g_over_rho0) * (r_up - r_dn) / dz;
  }
}

}  // namespace roms
