// Slow momentum right-hand side, rhs3d.F (with the pre_step3d momentum
// start, pre_step3d.F:659-700), for one padded (j,i) point and direction
// per thread, looping over k:
//
//   start (optional) - u_nnew/v_nnew: the AB3 history terms and the
//                      surface - bottom stress fluxes (pre_step3d.py
//                      momentum_init);
//   stage a          - Coriolis, curvilinear metric terms and U3
//                      horizontal advection added to the pressure gradient
//                      ru/rv;
//   stage b          - C4 vertical advection, then the barotropic forcing
//                      rufrc = sum_k ru + (surface - bottom stress) om on.
//
// Replaces the TPU kernel roms_tpu/ops/rhs3d_pallas.py::rhs3d_fused (two
// pallas_calls a direction, stage a then stage b, split for the TPU's
// VMEM) and the XLA momentum_init that momentum_rhs_fused runs before it.
// Bound on the H100: bandwidth (it reads ~13 (N,Ny,Nx) planes and writes 4,
// 6 with the start, for ~150 operations a point of each direction, under
// the card's operations-per-byte balance), but at UPWELLING size one thread
// per point and direction is ~8000 threads for 132 SMs, so the time is one
// thread's serial k-walk with its neighbour reads.
// Design: one thread per padded point, blockIdx.y the direction, so both
// directions go in one launch and neighbouring threads read neighbouring
// xi addresses.  Each direction is written once, in a frame of "along"
// (xi for u, eta for v) and "across" coordinates.  Neighbours wrap modulo
// the padded extent, as torch.roll does, so every padded point is computed,
// halo included; the one-sided edge extrapolations of U3 (bc.extrap_*) are
// index maps (bc.cuh extrap_src).  The vertical flux runs as a rolling
// value down the column, and the column sum in k order in the thread.
#pragma once

#include "column.cuh"

namespace roms {

struct RhsParams {
  Geom g;
  int N;
  int cor;     // cfg.uv_cor
  int adv;     // cfg.uv_adv
  int curv;    // cfg.curvgrid (with uv_adv)
  int start;   // compute momentum_init's u_nnew/v_nnew too
  double dt, a1, a2;
};

template <typename T>
struct RhsPtrs {
  // [d]: the u (d = 0) or v (d = 1) member of a pair
  const T *vel[2], *Fl[2];          // u v; Huon Hvom
  const T *W, *Hz, *r_in[2], *sstr[2], *bstr[2], *pm, *pn, *f, *dndx,
      *dmde;
  const T *r_prev[2], *r_prev2[2];  // null without the start
  T *r[2], *rfrc[2], *vel_nnew[2];  // vel_nnew null without the start
};

// A direction's frame: coordinate a along the direction (xi for u, eta for
// v) and c across it; padded index of (a, c), each wrapped.
struct Frame {
  int d, Nx, na, nc;
  int per_a, per_c;   // periodic along / across
  int lo_a, hi_a;     // U3 extrapolation faces along: H, H + n_along
  int lo_c, hi_c;     // and across: H - 1, H + n_across
  __host__ __device__ __forceinline__ int at(int a, int c) const {
    a = wrap(a, na);
    c = wrap(c, nc);
    return d == 0 ? c * Nx + a : a * Nx + c;
  }
};

__host__ __device__ __forceinline__ Frame frame_of(const Geom& g, int d) {
  Frame F;
  F.d = d;
  F.Nx = g.Nx;
  F.na = d == 0 ? g.Nx : g.Ny;
  F.nc = d == 0 ? g.Ny : g.Nx;
  F.per_a = d == 0 ? g.ew_per : g.ns_per;
  F.per_c = d == 0 ? g.ns_per : g.ew_per;
  F.lo_a = g.H;
  F.hi_a = g.H + (d == 0 ? g.L : g.M);
  F.lo_c = g.H - 1;
  F.hi_c = g.H + (d == 0 ? g.M : g.L);
  return F;
}

// Second difference along (ax = 0) or across (ax = 1) of plane f at (a, c):
// (f[-1] - 2 f) + f[+1], read at the source of the edge extrapolation when
// `ex` (rhs3d.py: uxx, Huxx, uee and their v counterparts).
template <typename T>
__device__ __forceinline__ T dd(const Frame& F, const T* f, int a, int c,
                                int ax, bool ex) {
  if (ax == 0) {
    a = wrap(a, F.na);
    if (ex) a = extrap_src(a, F.per_a, F.lo_a, F.hi_a);
    return f[F.at(a - 1, c)] - T(2) * f[F.at(a, c)] + f[F.at(a + 1, c)];
  }
  c = wrap(c, F.nc);
  if (ex) c = extrap_src(c, F.per_c, F.lo_c, F.hi_c);
  return f[F.at(a, c - 1)] - T(2) * f[F.at(a, c)] + f[F.at(a, c + 1)];
}

constexpr double kGadv = -0.25;   // rhs3d.py GADV

// U3 flux of the velocity along its own direction at the rho point (a, c)
// between vel(a, c) and vel(a+1, c): UFx for u, VFe for v.
template <typename T>
__device__ __forceinline__ T u3_along(const Frame& F, const T* vel,
                                      const T* Fa, int a, int c) {
  const T cff1 = vel[F.at(a, c)] + vel[F.at(a + 1, c)];
  const T cup = cff1 > T(0) ? dd(F, vel, a, c, 0, true)
                            : dd(F, vel, a + 1, c, 0, true);
  return T(0.25) * (cff1 + T(kGadv) * cup) *
         (Fa[F.at(a, c)] + Fa[F.at(a + 1, c)] +
          T(kGadv * 0.5) *
              (dd(F, Fa, a, c, 0, true) + dd(F, Fa, a + 1, c, 0, true)));
}

// U3 flux across at the psi point (a, c) between vel(a, c-1) and vel(a, c),
// carried by the other direction's mass flux Fc: UFe for u, VFx for v.
template <typename T>
__device__ __forceinline__ T u3_across(const Frame& F, const T* vel,
                                       const T* Fc, int a, int c) {
  const T cff1 = vel[F.at(a, c)] + vel[F.at(a, c - 1)];
  const T cff2 = Fc[F.at(a, c)] + Fc[F.at(a - 1, c)];
  const T cup = cff2 > T(0) ? dd(F, vel, a, c - 1, 1, true)
                            : dd(F, vel, a, c, 1, true);
  return T(0.25) * (cff1 + T(kGadv) * cup) *
         (cff2 + T(kGadv * 0.5) * (dd(F, Fc, a, c, 0, false) +
                                   dd(F, Fc, a - 1, c, 0, false)));
}

// C4 vertical flux of vel at interface k (1 <= k <= N-1) of column (a, c),
// with W averaged to the velocity point (rhs3d.py Wu / Wv and FCu / FCv).
template <typename T>
__device__ __forceinline__ T vflux(const Frame& F, const T* vel, const T* W,
                                   int S, int N, int a, int c, int k) {
  const T c1 = T(9.0 / 16.0);
  const T c2 = T(1.0 / 16.0);
  const T* w = W + k * S;
  const T Wk = c1 * (w[F.at(a, c)] + w[F.at(a - 1, c)]) -
               c2 * (w[F.at(a + 1, c)] + w[F.at(a - 2, c)]);
  const int q = F.at(a, c);
  auto x = [&](int m) { return vel[m * S + q]; };
  if (k == 1) return (c1 * (x(0) + x(1)) - c2 * (x(0) + x(2))) * Wk;
  if (k == N - 1)
    return (c1 * (x(N - 2) + x(N - 1)) - c2 * (x(N - 3) + x(N - 1))) * Wk;
  return (c1 * (x(k - 1) + x(k)) - c2 * (x(k - 2) + x(k + 1))) * Wk;
}

template <typename T>
__device__ void rhs3d_column(const RhsParams& P, const RhsPtrs<T>& A, int p,
                             int d) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const Frame F = frame_of(g, d);
  const int a = d == 0 ? p % g.Nx : p / g.Nx;
  const int c = d == 0 ? p / g.Nx : p % g.Nx;
  const T* vel0 = A.vel[d];
  const T* oth0 = A.vel[1 - d];
  const T* Fa0 = A.Fl[d];
  const T* Fc0 = A.Fl[1 - d];
  const int qm = F.at(a - 1, c);      // the point behind, along

  // Coriolis and curvilinear terms: X(q) (oth(q) + oth(q + across)),
  // averaged over q = p and the point behind, times +-1/2 (rhs3d.py)
  const T half = d == 0 ? T(0.5) : T(-0.5);
  const T fomn_p = A.f[p] / (A.pm[p] * A.pn[p]);
  const T fomn_m = A.f[qm] / (A.pm[qm] * A.pn[qm]);
  // curvilinear cff = 0.5 (v + v[j+1]) dndx - 0.5 (u + u[i+1]) dmde at q
  auto curv_cff = [&](const T* vel, const T* oth, int q, int aq) {
    const T vel2 = vel[q] + vel[F.at(aq + 1, c)];
    const T oth2 = oth[q] + oth[F.at(aq, c + 1)];
    const T V2 = d == 0 ? oth2 : vel2;
    const T U2 = d == 0 ? vel2 : oth2;
    return T(0.5) * V2 * A.dndx[q] - T(0.5) * U2 * A.dmde[q];
  };

  // the barotropic stress term and the start's metric factor
  const T om = T(1) / (A.pm[qm] + A.pm[p]) * T(2);
  const T on = T(1) / (A.pn[qm] + A.pn[p]) * T(2);
  const T stress = (A.sstr[d][p] - A.bstr[d][p]) * om * on;
  const T DC0 = T(P.dt * 0.25) * (A.pm[p] + A.pm[qm]) * (A.pn[p] + A.pn[qm]);
  const T dt = T(P.dt);
  const T a1 = T(P.a1);
  const T a2 = T(P.a2);

  T FCk = T(0);       // vertical flux at interface k, FC[0] = 0
  T sum = T(0);
  for (int k = 0; k < N; ++k) {
    const int o = k * S;
    const T* vel = vel0 + o;
    const T* oth = oth0 + o;
    const T* Hz = A.Hz + o;

    if (P.start) {
      const T fc_lo = k == 0 ? dt * A.bstr[d][p] : T(0);
      const T fc_hi = k == N - 1 ? dt * A.sstr[d][p] : T(0);
      A.vel_nnew[d][o + p] =
          vel[p] * T(0.5) * (Hz[p] + Hz[qm]) +
          DC0 * (a1 * A.r_prev2[d][o + p] + a2 * A.r_prev[d][o + p]) +
          (fc_hi - fc_lo);
    }

    T r = A.r_in[d][o + p];
    if (P.cor) {
      const T Xp = T(0.5) * Hz[p] * fomn_p * (oth[p] + oth[F.at(a, c + 1)]);
      const T Xm =
          T(0.5) * Hz[qm] * fomn_m * (oth[qm] + oth[F.at(a - 1, c + 1)]);
      r = r + half * (Xp + Xm);
    }
    if (P.curv) {
      const T Xp = Hz[p] * curv_cff(vel, oth, p, a) * T(0.5) *
                   (oth[p] + oth[F.at(a, c + 1)]);
      const T Xm = Hz[qm] * curv_cff(vel, oth, qm, a - 1) * T(0.5) *
                   (oth[qm] + oth[F.at(a - 1, c + 1)]);
      r = r + half * (Xp + Xm);
    }
    if (P.adv) {
      const T* Fa = Fa0 + o;
      const T* Fc = Fc0 + o;
      const T along = -(u3_along(F, vel, Fa, a, c) -
                        u3_along(F, vel, Fa, a - 1, c));
      const T across = -(u3_across(F, vel, Fc, a, c + 1) -
                         u3_across(F, vel, Fc, a, c));
      // rhs3d.py adds the xi term first: along for u, across for v
      r = d == 0 ? r + along + across : r + across + along;
      const T FCk1 = k == N - 1 ? T(0)
                                : vflux(F, vel0, A.W, S, N, a, c, k + 1);
      r = r + -(FCk1 - FCk);
      FCk = FCk1;
    }
    A.r[d][o + p] = r;
    sum = sum + r;
  }
  A.rfrc[d][p] = sum + stress;
}

inline RhsParams rhs_params(const int* ip, const double* dp) {
  RhsParams P;
  int n = 0;
  P.N = ip[n++];
  P.g.Ny = ip[n++];
  P.g.Nx = ip[n++];
  P.g.H = ip[n++];
  P.g.L = ip[n++];
  P.g.M = ip[n++];
  P.g.ew_per = ip[n++];
  P.g.ns_per = ip[n++];
  P.cor = ip[n++];
  P.adv = ip[n++];
  P.curv = ip[n++];
  P.start = ip[n++];
  P.dt = dp[0];
  P.a1 = dp[1];
  P.a2 = dp[2];
  return P;
}

template <typename T>
RhsPtrs<T> rhs_ptrs(void* const* ptr) {
  RhsPtrs<T> A;
  auto in = [&](int n) { return static_cast<const T*>(ptr[n]); };
  auto out = [&](int n) { return static_cast<T*>(ptr[n]); };
  for (int d = 0; d < 2; ++d) {
    A.vel[d] = in(0 + d);
    A.Fl[d] = in(2 + d);
    A.r_in[d] = in(6 + d);
    A.sstr[d] = in(8 + d);
    A.bstr[d] = in(10 + d);
    A.r_prev[d] = in(17 + d);
    A.r_prev2[d] = in(19 + d);
    A.r[d] = out(21 + d);
    A.rfrc[d] = out(23 + d);
    A.vel_nnew[d] = out(25 + d);
  }
  A.W = in(4);
  A.Hz = in(5);
  A.pm = in(12);
  A.pn = in(13);
  A.f = in(14);
  A.dndx = in(15);
  A.dmde = in(16);
  return A;
}

}  // namespace roms
