// The 3-D predictor/corrector stages of the baroclinic step, one thread per
// (j,i) water column looping over k:
//
//   tracer_predictor - pre_step3d's tracer loop (LF-AM3 predictor t3 and
//                      the t(nnew) start).  Replaces the TPU kernel
//                      roms_tpu/ops/step3d_pallas.py::tracer_predictor_fused.
//   tracer_corrector - step3d_t: advection of t3 with the corrected fluxes
//                      and implicit vertical diffusion (splines or Thomas).
//                      Replaces step3d_pallas.tracer_corrector_fused.
//   uv_corrector     - step3d_uv: AB3 update, spline vertical viscosity,
//                      mean replacement, lateral BCs, boundary-ring
//                      corrections, ubar and the time-centred mass flux.
//                      Replaces step3d_pallas.uv_corrector_fused.
//
// Bound on the H100: the work is bandwidth-bound (each reads and writes a
// few (N,Ny,Nx) planes per tracer or direction for ~110 operations a
// point, below the card's operations-per-byte balance), but at UPWELLING
// size one thread per column and tracer or direction is ~8000 threads for
// 132 SMs, so the time is the latency of the serial k-loops of one
// thread, far above the bandwidth bound.
// Design: a thread owns one column, so the vertical solves and column sums
// are serial loops in thread-local storage with no synchronisation, and
// neighbouring threads read neighbouring xi addresses.  One launch covers
// every tracer (blockIdx.y) or both directions.  The TPU kernels' splits
// (per tracer and per direction, for VMEM) and unrolled solvers (for
// Mosaic) are not carried over.  Nothing else is done about bandwidth yet:
// the horizontal stencils re-read neighbours through the caches.
//
// Boundary writes and the halo fill are gathers (csrc/bc.cuh): the thread
// for padded point p computes the column its value comes from, so every
// padded point agrees with the plain version, halo included.  Column sums
// (uv_corrector) run in k order inside the thread; torch.sum on the card
// sums in another order, so the two differ by round-off.
#pragma once

#include "column.cuh"

namespace roms {

// ---------------------------------------------------------------------------
// tracer predictor (pre_step3d.py tracer_predictor, pre_step3d.F:336-598)
// ---------------------------------------------------------------------------
struct PredParams {
  Geom g;
  int N, NT;
  int ng;      // tracers with a KPP nonlocal flux ghats (0: none)
  int sol;     // penetrating shortwave (srflx and swdk_w given)
  int bt[4];   // lbc_t kinds W S E N
  int hadv[kMaxTr], vadv[kMaxTr];
  double dt;
  double coef[kMaxTr][4];   // cff cff1 cff2 cffv
};

template <typename T>
struct PredPtrs {
  const T *t, *t_prev, *Hz, *Huon, *Hvom, *W, *Akt, *pm, *pn, *stflx,
      *btflx, *ghats, *srflx, *swdk_w;
  T *t3, *t_nnew;
};

// apply_bc_rho source column of padded point p (no mask)
__device__ __forceinline__ int rho_src(const Geom& g, const int* b, int p) {
  const int J = rho_bc_src(fill_src(p / g.Nx, g.H, g.M, g.ns_per), g.H, g.M,
                           g.ns_per, b[1], b[3]);
  const int I = rho_bc_src(fill_src(p % g.Nx, g.H, g.L, g.ew_per), g.H, g.L,
                           g.ew_per, b[0], b[2]);
  return J * g.Nx + I;
}

template <typename T>
__device__ void tracer_predictor_column(const PredParams& P,
                                        const PredPtrs<T>& A, int p,
                                        int itrc) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int ltrc = P.NT >= 2 ? (itrc < 1 ? itrc : 1) : 0;
  const T* q = A.t + itrc * N * S;
  const T* qp = A.t_prev + itrc * N * S;
  const T* Akt = A.Akt + ltrc * (N + 1) * S;
  const T cff = T(P.coef[itrc][0]);
  const T cff1 = T(P.coef[itrc][1]);
  const T cff2 = T(P.coef[itrc][2]);
  const T cffv = T(P.coef[itrc][3]);
  const T dt = T(P.dt);

  // t3 of the column the BC/fill copies into p
  const int c = rho_src(g, P.bt, p);
  const int J = c / g.Nx;
  const int I = c - J * g.Nx;
  const int cip = J * g.Nx + wrap(I + 1, g.Nx);
  const int cjp = wrap(J + 1, g.Ny) * g.Nx + I;
  T qc[kMaxN], FC[kMaxN + 1], CFs[kMaxN];
  for (int k = 0; k < N; ++k) qc[k] = q[k * S + c];
  vadv_flux(P.vadv[itrc], qc, Col<T>{A.Hz + c, S}, Col<T>{A.W + c, S}, N,
            1.5, 0.5, 3.0, 2.0, FC, CFs);
  const T pmn = A.pm[c] * A.pn[c];
  T* t3 = A.t3 + itrc * N * S;
  for (int k = 0; k < N; ++k) {
    const int o = k * S;
    const T Hzk = A.Hz[o + c];
    const T t3k = Hzk * (cff1 * qc[k] + cff2 * qp[o + c]) -
                  cff * pmn *
                      hadv_div(g, q + o, A.Huon + o, A.Hvom + o, J, I,
                               P.hadv[itrc]);
    const T DC = T(1) / (Hzk - cffv * pmn *
                                   ((A.Huon[o + cip] - A.Huon[o + c]) +
                                    (A.Hvom[o + cjp] - A.Hvom[o + c]) +
                                    (A.W[o + S + c] - A.W[o + c])));
    t3[o + p] = DC * (t3k - cffv * pmn * (FC[k + 1] - FC[k]));
  }

  // t(nnew) start at p itself: surface/bottom, nonlocal and solar fluxes
  const T* gh = itrc < P.ng ? A.ghats + itrc * (N + 1) * S : nullptr;
  const bool sol = P.sol && itrc == 0;
  auto FCd = [&](int k) {          // interface k
    if (k == 0) return dt * A.btflx[itrc * S + p];
    if (k == N) return dt * A.stflx[itrc * S + p];
    T v = T(0);
    if (gh) v = v - dt * Akt[k * S + p] * gh[k * S + p];
    if (sol) v = v + dt * A.srflx[p] * A.swdk_w[k * S + p];
    return v;
  };
  T* tn = A.t_nnew + itrc * N * S;
  T below = FCd(0);
  for (int k = 0; k < N; ++k) {
    const int o = k * S;
    const T above = FCd(k + 1);
    tn[o + p] = A.Hz[o + p] * q[o + p] + (above - below);
    below = above;
  }
}

inline PredParams pred_params(const int* ip, const double* dp) {
  PredParams P;
  int n = 0;
  P.N = ip[n++];
  P.g.Ny = ip[n++];
  P.g.Nx = ip[n++];
  P.g.H = ip[n++];
  P.g.L = ip[n++];
  P.g.M = ip[n++];
  P.g.ew_per = ip[n++];
  P.g.ns_per = ip[n++];
  P.NT = ip[n++];
  P.ng = ip[n++];
  P.sol = ip[n++];
  for (int s = 0; s < 4; ++s) P.bt[s] = ip[n++];
  for (int t = 0; t < P.NT; ++t) P.hadv[t] = ip[n++];
  for (int t = 0; t < P.NT; ++t) P.vadv[t] = ip[n++];
  P.dt = dp[0];
  for (int t = 0; t < P.NT; ++t)
    for (int c = 0; c < 4; ++c) P.coef[t][c] = dp[1 + 4 * t + c];
  return P;
}

template <typename T>
PredPtrs<T> pred_ptrs(void* const* ptr) {
  PredPtrs<T> A;
  A.t = static_cast<const T*>(ptr[0]);
  A.t_prev = static_cast<const T*>(ptr[1]);
  A.Hz = static_cast<const T*>(ptr[2]);
  A.Huon = static_cast<const T*>(ptr[3]);
  A.Hvom = static_cast<const T*>(ptr[4]);
  A.W = static_cast<const T*>(ptr[5]);
  A.Akt = static_cast<const T*>(ptr[6]);
  A.pm = static_cast<const T*>(ptr[7]);
  A.pn = static_cast<const T*>(ptr[8]);
  A.stflx = static_cast<const T*>(ptr[9]);
  A.btflx = static_cast<const T*>(ptr[10]);
  A.ghats = static_cast<const T*>(ptr[11]);
  A.srflx = static_cast<const T*>(ptr[12]);
  A.swdk_w = static_cast<const T*>(ptr[13]);
  A.t3 = static_cast<T*>(ptr[14]);
  A.t_nnew = static_cast<T*>(ptr[15]);
  return A;
}

// ---------------------------------------------------------------------------
// tracer corrector (step3d_t.py tracer_corrector, step3d_t.F:227-1142)
// ---------------------------------------------------------------------------
struct CorrParams {
  Geom g;
  int N, NT;
  int bt[4];
  int splines;   // cfg.splines_vdiff (else the Thomas solve)
  int hadv[kMaxTr], vadv[kMaxTr];
  double dt;
};

template <typename T>
struct CorrPtrs {
  const T *t_nnew, *t3, *Huon, *Hvom, *W, *Hz, *z_r, *Akt, *pm, *pn;
  T* t;
};

template <typename T>
__device__ void tracer_corrector_column(const CorrParams& P,
                                        const CorrPtrs<T>& A, int p,
                                        int itrc) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int ltrc = P.NT >= 2 ? (itrc < 1 ? itrc : 1) : 0;
  const T* q = A.t3 + itrc * N * S;
  const T* tnn = A.t_nnew + itrc * N * S;
  const T dt = T(P.dt);
  const int c = rho_src(g, P.bt, p);
  const int J = c / g.Nx;
  const int I = c - J * g.Nx;
  T qc[kMaxN], tn[kMaxN], Hz[kMaxN], oHz[kMaxN], FC[kMaxN + 1],
      CFs[kMaxN];
  for (int k = 0; k < N; ++k) {
    qc[k] = q[k * S + c];
    Hz[k] = A.Hz[k * S + c];
    oHz[k] = T(1) / Hz[k];
  }
  vadv_flux(P.vadv[itrc], qc, Col<T>{A.Hz + c, S}, Col<T>{A.W + c, S}, N,
            2.0, 1.0, 2.0, 1.0, FC, CFs);
  const T pmn = A.pm[c] * A.pn[c];
  for (int k = 0; k < N; ++k) {
    const int o = k * S;
    const T tk = tnn[o + c] -
                 dt * pmn *
                     hadv_div(g, q + o, A.Huon + o, A.Hvom + o, J, I,
                              P.hadv[itrc]);
    tn[k] = (tk - dt * pmn * (FC[k + 1] - FC[k])) * oHz[k];
  }
  const Col<T> Akt{A.Akt + ltrc * (N + 1) * S + c, S};
  if (P.splines) {
    T AK[kMaxN + 1];
    for (int k = 0; k <= N; ++k) AK[k] = Akt[k];
    spline_vdiff_flux(dt, Hz, oHz, AK, tn, N, FC, CFs);
    for (int k = 0; k < N; ++k)
      tn[k] = tn[k] + dt * oHz[k] * (FC[k + 1] - FC[k]);
  } else {
    for (int k = 0; k < N; ++k) tn[k] = tn[k] * Hz[k];
    thomas_implicit(P.dt, Hz, Col<T>{A.z_r + c, S}, Akt, tn, N, FC, CFs);
  }
  T* out = A.t + itrc * N * S;
  for (int k = 0; k < N; ++k) out[k * S + p] = tn[k];
}

inline CorrParams corr_params(const int* ip, const double* dp) {
  CorrParams P;
  int n = 0;
  P.N = ip[n++];
  P.g.Ny = ip[n++];
  P.g.Nx = ip[n++];
  P.g.H = ip[n++];
  P.g.L = ip[n++];
  P.g.M = ip[n++];
  P.g.ew_per = ip[n++];
  P.g.ns_per = ip[n++];
  P.NT = ip[n++];
  for (int s = 0; s < 4; ++s) P.bt[s] = ip[n++];
  P.splines = ip[n++];
  for (int t = 0; t < P.NT; ++t) P.hadv[t] = ip[n++];
  for (int t = 0; t < P.NT; ++t) P.vadv[t] = ip[n++];
  P.dt = dp[0];
  return P;
}

template <typename T>
CorrPtrs<T> corr_ptrs(void* const* ptr) {
  CorrPtrs<T> A;
  A.t_nnew = static_cast<const T*>(ptr[0]);
  A.t3 = static_cast<const T*>(ptr[1]);
  A.Huon = static_cast<const T*>(ptr[2]);
  A.Hvom = static_cast<const T*>(ptr[3]);
  A.W = static_cast<const T*>(ptr[4]);
  A.Hz = static_cast<const T*>(ptr[5]);
  A.z_r = static_cast<const T*>(ptr[6]);
  A.Akt = static_cast<const T*>(ptr[7]);
  A.pm = static_cast<const T*>(ptr[8]);
  A.pn = static_cast<const T*>(ptr[9]);
  A.t = static_cast<T*>(ptr[10]);
  return A;
}

// ---------------------------------------------------------------------------
// momentum corrector (step3d_uv.py, step3d_uv.F), direction d: 0 xi, 1 eta
// ---------------------------------------------------------------------------
struct UvParams {
  Geom g;
  int N;
  int bu[4], bv[4];   // lbc_u, lbc_v kinds W S E N
  int splines;        // cfg.splines_vvisc
  double dt, cff, gamma2;
};

template <typename T>
struct UvPtrs {
  // [d] = xi (u) or eta (v) counterpart
  const T *vel_nnew[2], *r[2], *Hz, *Akv, *D1[2], *D2[2], *flx_old[2], *pm,
      *pn, *mask[2];
  T *vel[2], *bar[2], *flx[2];
};

template <typename T>
__device__ void uv_corrector_column(const UvParams& P, const UvPtrs<T>& A,
                                    int p, int d) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const T dt = T(P.dt);
  const T* vn = A.vel_nnew[d];
  const T* r = A.r[d];
  const T* D1 = A.D1[d];
  const T* mask = A.mask[d];
  // the i-1 (xi) or j-1 (eta) neighbour of point q, and the metric on_u
  // = 2/(pn[i-1] + pn[i]) or om_v = 2/(pm[j-1] + pm[j]) there (grid.py)
  auto back = [&](int q) {
    const int J = q / g.Nx;
    const int I = q - J * g.Nx;
    return d == 0 ? J * g.Nx + wrap(I - 1, g.Nx)
                  : wrap(J - 1, g.Ny) * g.Nx + I;
  };
  auto metric = [&](int q) {
    const T* m = d == 0 ? A.pn : A.pm;
    return T(1) / (m[back(q)] + m[q]) * T(2);
  };

  // the point the halo fill copies into p, and the point whose pre-BC
  // value apply_bc_u/v writes there
  const int Jf = fill_src(p / g.Nx, g.H, g.M, g.ns_per);
  const int If = fill_src(p % g.Nx, g.H, g.L, g.ew_per);
  const int f = Jf * g.Nx + If;
  const BcSrc src = d == 0 ? bc_u_src(g, P.bu, Jf, If)
                           : bc_v_src(g, P.bv, Jf, If);

  T vel[kMaxN], Hk[kMaxN], oH[kMaxN], AK[kMaxN + 1], flux[kMaxN + 1],
      CFs[kMaxN];
  if (!src.zero) {
    // AB3 update, vertical viscosity and mean replacement at column b
    const int b = src.q;
    const int bw = back(b);
    const T DC0 = T(P.cff) * (A.pm[b] + A.pm[bw]) * (A.pn[b] + A.pn[bw]);
    for (int k = 0; k < N; ++k) {
      const int o = k * S;
      Hk[k] = T(0.5) * (A.Hz[o + b] + A.Hz[o + bw]);
      oH[k] = T(1) / Hk[k];
      vel[k] = (vn[o + b] + DC0 * r[o + b]) * oH[k];
    }
    if (P.splines) {
      for (int k = 0; k <= N; ++k)
        AK[k] = T(0.5) * (A.Akv[k * S + b] + A.Akv[k * S + bw]);
      spline_vdiff_flux(dt, Hk, oH, AK, vel, N, flux, CFs);
      for (int k = 0; k < N; ++k)
        vel[k] = vel[k] + dt * oH[k] * (flux[k + 1] - flux[k]);
    }
    T CF0 = T(0);
    T DCm = T(0);
    for (int k = 0; k < N; ++k) {
      CF0 = CF0 + Hk[k];
      DCm = DCm + vel[k] * Hk[k];
    }
    const T mb = metric(b);
    const T err = (DCm * mb - D1[b]) / (CF0 * mb);
    for (int k = 0; k < N; ++k) vel[k] = (vel[k] - err) * mask[b];
  }
  // lateral BC and mask at f
  const T gamma2 = T(P.gamma2);
  for (int k = 0; k < N; ++k) {
    const T v = src.zero ? T(0) : vel[k];
    vel[k] = mask[f] * (src.gamma ? gamma2 * v : v);
  }

  // 2-D/3-D coupling at f (step3d_uv.F:997-1213)
  const int fw = back(f);
  const T half_metric = T(0.5) * metric(f);
  T sumD = T(0);
  T sumDv = T(0);
  for (int k = 0; k < N; ++k) {
    const int o = k * S;
    Hk[k] = half_metric * (A.Hz[o + f] + A.Hz[o + fw]);   // DCk
    sumD = sumD + Hk[k];
    sumDv = sumDv + Hk[k] * vel[k];
  }
  const T oD = T(1) / sumD;
  const T CFb = oD * (sumDv - D1[f]);
  A.bar[d][p] = oD * D1[f];
  // boundary-ring-only replacement at non-periodic edges: u at the wall
  // faces I = H, H+L and the rows J = H-1, H+M; v at the columns I = H-1,
  // H+L and the wall faces J = H, H+M
  const bool col = !g.ew_per && (If == (d == 0 ? g.H : g.H - 1) ||
                                 If == g.H + g.L);
  const bool row = !g.ns_per && (Jf == (d == 0 ? g.H - 1 : g.H) ||
                                 Jf == g.H + g.M);
  T sumF = T(0);
  const T* fo = A.flx_old[d];
  for (int k = 0; k < N; ++k) {
    if (col) vel[k] = vel[k] + -CFb;
    if (row) vel[k] = vel[k] + -CFb;
    flux[k] = T(0.5) * (fo[k * S + f] + vel[k] * Hk[k]);
    sumF = sumF + flux[k];
  }
  const T FCc = oD * (sumF - A.D2[d][f]);
  for (int k = 0; k < N; ++k) {
    A.vel[d][k * S + p] = vel[k];
    A.flx[d][k * S + p] = flux[k] - Hk[k] * FCc;
  }
}

inline UvParams uv_params(const int* ip, const double* dp) {
  UvParams P;
  int n = 0;
  P.N = ip[n++];
  P.g.Ny = ip[n++];
  P.g.Nx = ip[n++];
  P.g.H = ip[n++];
  P.g.L = ip[n++];
  P.g.M = ip[n++];
  P.g.ew_per = ip[n++];
  P.g.ns_per = ip[n++];
  for (int s = 0; s < 4; ++s) P.bu[s] = ip[n++];
  for (int s = 0; s < 4; ++s) P.bv[s] = ip[n++];
  P.splines = ip[n++];
  P.dt = dp[0];
  P.cff = dp[1];
  P.gamma2 = dp[2];
  return P;
}

template <typename T>
UvPtrs<T> uv_ptrs(void* const* ptr) {
  UvPtrs<T> A;
  auto in = [&](int n) { return static_cast<const T*>(ptr[n]); };
  auto out = [&](int n) { return static_cast<T*>(ptr[n]); };
  for (int d = 0; d < 2; ++d) {
    A.vel_nnew[d] = in(0 + d);
    A.r[d] = in(2 + d);
    A.D1[d] = in(6 + d);
    A.D2[d] = in(8 + d);
    A.flx_old[d] = in(10 + d);
    A.mask[d] = in(14 + d);
    A.vel[d] = out(16 + d);
    A.bar[d] = out(18 + d);
    A.flx[d] = out(20 + d);
  }
  A.Hz = in(4);
  A.Akv = in(5);
  A.pm = in(12);
  A.pn = in(13);
  return A;
}

}  // namespace roms
