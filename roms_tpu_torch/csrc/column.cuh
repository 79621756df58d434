// Per-water-column pieces shared by the 3-D predictor/corrector kernels
// (step3d.cuh): the tracer advection fluxes and the vertical solves of
// roms_tpu_torch/ops/advection.py and ops/tridiag.py, written for one
// thread that owns one (j,i) column and loops over k.
//
// Every expression keeps the plain version's operation order (and the
// library is built with --fmad=false), so a kernel rounds like its plain
// PyTorch version; a Python `c / x` is torch's reciprocal(x) * c.
// Column arrays live in thread-local storage of kMaxN levels.
#pragma once

#include "bc.cuh"

namespace roms {

constexpr int kMaxN = 64;     // most vertical levels a column kernel takes
constexpr int kMaxTr = 16;    // most tracers a tracer kernel takes

// scheme codes, as passed from Python (ops/step3d_cuda.py)
enum HScheme { H_U3 = 0, H_C4 = 1 };
enum VScheme { V_C4 = 0, V_SPLINES = 1 };

__host__ __device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// A column read from a (k, j, i) array: element k at p[k * s].
template <typename T>
struct Col {
  const T* p;
  int s;
  __device__ __forceinline__ T operator[](int k) const { return p[k * s]; }
};

// Horizontal advective flux (advection.hadv_fluxes) at face a of one grid
// line of n points: q[b * st] and the mass flux F[b * st] (Huon along xi,
// Hvom along eta).  Neighbours wrap modulo n, as torch.roll does; at a
// non-periodic edge the first differences at lo and hi are extrapolated
// (bc.extrap_west/east or south/north).
template <typename T>
__device__ __forceinline__ T hadv_flux(const T* q, const T* F, int st, int n,
                                       int a, int per, int lo, int hi,
                                       int scheme) {
  auto dq = [&](int b) {
    b = extrap_src(b, per, lo, hi);
    return q[b * st] - q[wrap(b - 1, n) * st];
  };
  const int am = wrap(a - 1, n);
  const int ap = wrap(a + 1, n);
  const T qa = q[a * st];
  const T qm = q[am * st];
  const T Fa = F[a * st];
  const T dq_a = dq(a);
  if (scheme == H_U3) {
    const T curv = dq(ap) - dq_a;
    const T curv_m = dq_a - dq(am);
    const T Fpos = Fa > T(0) ? Fa : T(0);
    const T Fneg = Fa < T(0) ? Fa : T(0);
    return Fa * T(0.5) * (qm + qa) -
           T(1.0 / 6.0) * (curv_m * Fpos + curv * Fneg);
  }
  const T grad = T(0.5) * (dq(ap) + dq_a);
  const T grad_m = T(0.5) * (dq_a + dq(am));
  return Fa * T(0.5) * (qm + qa - T(1.0 / 3.0) * (grad - grad_m));
}

// The two flux differences of a tracer at column (J, I) of level plane q
// (advection.hadv_fluxes, then (ip1(FX) - FX) + (jp1(FE) - FE)).
template <typename T>
__device__ __forceinline__ T hadv_div(const Geom& g, const T* q,
                                      const T* Huon, const T* Hvom, int J,
                                      int I, int scheme) {
  const int row = J * g.Nx;
  const T FXe = hadv_flux(q + row, Huon + row, 1, g.Nx, wrap(I + 1, g.Nx),
                          g.ew_per, g.H - 1, g.H + g.L + 1, scheme);
  const T FXw = hadv_flux(q + row, Huon + row, 1, g.Nx, I, g.ew_per,
                          g.H - 1, g.H + g.L + 1, scheme);
  const T FEn = hadv_flux(q + I, Hvom + I, g.Nx, g.Ny, wrap(J + 1, g.Ny),
                          g.ns_per, g.H - 1, g.H + g.M + 1, scheme);
  const T FEs = hadv_flux(q + I, Hvom + I, g.Nx, g.Ny, J, g.ns_per, g.H - 1,
                          g.H + g.M + 1, scheme);
  return (FXe - FXw) + (FEn - FEs);
}

// Vertical advective flux at interfaces 0..N into FC (advection.vadv_flux,
// FC[0] = FC[N] = 0): C4 with reduced-order end interfaces, or the
// parabolic-spline interpolation (tridiag.spline_interp_flux) with end
// conditions (c_bot, cf1, c_top, d_top).  q is the tracer column (local),
// Hz and W columns of the layer thickness and the vertical velocity.
template <typename T>
__device__ void vadv_flux(int scheme, const T* q, Col<T> Hz, Col<T> W,
                          int N, double c_bot, double cf1, double c_top,
                          double d_top, T* FC, T* CFs) {
  FC[0] = T(0);
  FC[N] = T(0);
  if (scheme == V_C4) {
    const T c1 = T(0.5), c2 = T(7.0 / 12.0), c3 = T(1.0 / 12.0);
    for (int k = 1; k < N; ++k) {
      if (k == 1)
        FC[k] = W[1] * (c1 * q[0] + c2 * q[1] - c3 * q[2]);
      else if (k == N - 1)
        FC[k] = W[N - 1] * (c1 * q[N - 1] + c2 * q[N - 2] - c3 * q[N - 3]);
      else
        FC[k] = W[k] * (c2 * (q[k - 1] + q[k]) - c3 * (q[k - 2] + q[k + 1]));
    }
    return;
  }
  T FCm1 = T(c_bot) * q[0];
  T CFk = T(cf1);
  for (int k = 0; k < N - 1; ++k) {
    const T Hzk = Hz[k];
    const T Hzk1 = Hz[k + 1];
    const T cff = T(1) / (T(2) * Hzk + Hzk1 * (T(2) - CFk));
    CFk = cff * Hzk;
    FCm1 = cff * (T(3) * (Hzk * q[k + 1] + Hzk1 * q[k]) - Hzk1 * FCm1);
    CFs[k] = CFk;
    FC[k + 1] = FCm1;
  }
  T FCnext = (T(c_top) * q[N - 1] - FCm1) / (T(d_top) - CFk);
  for (int k = N - 2; k >= 0; --k) {
    FCnext = FC[k + 1] - CFs[k] * FCnext;
    FC[k + 1] = W[k + 1] * FCnext;
  }
}

// Parabolic-spline implicit vertical diffusion (tridiag.spline_vdiff_flux):
// interface flux AK * dq/dz into flux[0..N], flux[0] = flux[N] = 0.
template <typename T>
__device__ void spline_vdiff_flux(T dt, const T* Hz, const T* oHz,
                                  const T* AK, const T* q, int N, T* flux,
                                  T* CFs) {
  const T sixth = T(1.0 / 6.0);
  const T third = T(1.0 / 3.0);
  T CFp = T(0);
  T DCp = T(0);
  for (int k = 0; k < N - 1; ++k) {
    const T FC = sixth * Hz[k] - dt * AK[k] * oHz[k];
    const T CF = sixth * Hz[k + 1] - dt * AK[k + 2] * oHz[k + 1];
    const T BC = third * (Hz[k] + Hz[k + 1]) +
                 dt * AK[k + 1] * (oHz[k] + oHz[k + 1]);
    const T cff = T(1) / (BC - FC * CFp);
    CFp = cff * CF;
    DCp = cff * ((q[k + 1] - q[k]) - FC * DCp);
    CFs[k] = CFp;
    flux[k + 1] = DCp;
  }
  T Dnext = T(0);
  for (int k = N - 2; k >= 0; --k) {
    Dnext = flux[k + 1] - CFs[k] * Dnext;
    flux[k + 1] = AK[k + 1] * Dnext;
  }
  flux[0] = T(0);
  flux[N] = T(0);
}

// Standard implicit vertical diffusion (tridiag.thomas_implicit with
// lambda = 1): q holds the mass-weighted right-hand side on entry and the
// solution on exit.  FC: N+1 scratch, CFs: N scratch.
template <typename T>
__device__ void thomas_implicit(double dt, const T* Hz, Col<T> z_r,
                                Col<T> AK, T* q, int N, T* FC, T* CFs) {
  FC[0] = T(0);
  FC[N] = T(0);
  for (int k = 1; k < N; ++k)
    FC[k] = T(-dt) * AK[k] / (z_r[k] - z_r[k - 1]);
  T CFp = T(0);
  T DCp = T(0);
  for (int k = 0; k < N; ++k) {
    const T BC = Hz[k] - FC[k + 1] - FC[k];
    const T cff = T(1) / (BC - FC[k] * CFp);
    CFp = cff * FC[k + 1];
    DCp = cff * (q[k] - FC[k] * DCp);
    CFs[k] = CFp;
    q[k] = DCp;
  }
  T qnext = T(0);
  for (int k = N - 1; k >= 0; --k) {
    qnext = q[k] - CFs[k] * qnext;
    q[k] = qnext;
  }
}

}  // namespace roms
