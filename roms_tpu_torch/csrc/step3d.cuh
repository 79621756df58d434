// The 3-D predictor/corrector stages of the baroclinic step:
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
// Bound on the H100: bandwidth.  Each reads and writes a few (N,Ny,Nx)
// planes per tracer or direction for ~110 operations a point, below the
// card's operations-per-byte balance.  What keeps a kernel from it is the
// latency of its serial vertical recurrences and of its loads.
//
// The two tracer kernels work on tiles.  A block owns `tile` consecutive
// padded points (flattened j, i) and every tracer, and stages its columns
// in shared memory as [k][column] arrays (neighbouring threads, neighbouring
// banks), sized at launch from N, NT and the dtype (tracer_plan in
// ops/step3d_cuda.py).  Its threads split into tile columns x level slots;
// the lanes of one slot hold neighbouring columns at one level.
//   - The parts that are pointwise in k run with a thread per (level,
//     column), its levels strided by the slots, so that a block has the
//     loads of all its levels in flight at once: the column's Hz, W, mass
//     fluxes and Akt, once for all tracers; the horizontal advection; the
//     C4 vertical flux; the updates around the vertical solves; the
//     predictor's t(nnew) start; every store.  The horizontal stencil
//     takes its xi neighbours from the neighbouring lanes (warp shuffles)
//     where they hold them, and loads the rest through its Line.
//   - The serial recurrences (SPLINES vertical advection, the spline or
//     Thomas vertical diffusion) run one thread per column and tracer, in
//     the plain version's order, from shared memory.
//   - Block barriers separate the two.
// uv_corrector keeps one thread per column and direction, its column
// arrays in thread-local storage.
//
// Boundary writes and the halo fill are gathers (csrc/bc.cuh): a tile's
// point p computes the column its value comes from, c = rho_src(p), so
// every padded point agrees with the plain version, halo included (the
// predictor's t(nnew) start, which has no boundary write, at p itself).
// Column sums (uv_corrector) run in k order inside the thread; torch.sum on
// the card sums in another order, so the two differ by round-off.
#pragma once

#include "column.cuh"

namespace roms {

// The launch of a tracer kernel, chosen by ops/step3d_cuda.py tracer_plan:
// points a tile (a power of two, at most 32), threads a block (a multiple
// of the tile) and the dynamic shared memory, which the entry point checks
// against tracer_rows.
struct TilePlan {
  int tile, threads, smem;
};

// apply_bc_rho source column of padded point p (no mask)
__device__ __forceinline__ int rho_src(const Geom& g, const int* b, int p) {
  const int J = rho_bc_src(fill_src(p / g.Nx, g.H, g.M, g.ns_per), g.H, g.M,
                           g.ns_per, b[1], b[3]);
  const int I = rho_bc_src(fill_src(p % g.Nx, g.H, g.L, g.ew_per), g.H, g.L,
                           g.ew_per, b[0], b[2]);
  return J * g.Nx + I;
}

// Shared words a tile column of a tracer kernel holds: Hz, W, the mass
// fluxes at its four faces, the predictor's divergence or the corrector's
// 1/Hz, Akt planes and z_r, and per tracer its column, its update, FC and
// the solves' scratch.
__host__ __device__ constexpr int tracer_rows(bool corrector, int N,
                                              int NT) {
  return corrector ? 8 * N + 1 + (NT >= 2 ? 2 : 1) * (N + 1) +
                         NT * (4 * N + 1)
                   : 7 * N + 1 + NT * (4 * N + 1);
}

// v of the lane d columns along in this tile segment (d = -2..2); every
// lane of the warp calls it
template <typename V>
__device__ __forceinline__ V lane_shift(V v, int d, int width) {
  return d < 0 ? __shfl_up_sync(0xffffffffu, v, -d, width)
               : __shfl_down_sync(0xffffffffu, v, d, width);
}

// the offset of Line neighbour j: -2, -1, 1, 2
__host__ __device__ constexpr int lane_d(int j) {
  return j < 2 ? j - 2 : j - 1;
}

// One thread's place in a tile: its column slot, its first level and the
// level stride, its padded point p, the column c that p copies, c's
// neighbours along xi and eta, and which xi neighbours (bit j for Line
// neighbour j) a lane of its segment holds.  Every thread constructs one.
struct TileThread {
  int col, k0, dk, p, c, xin;
  bool live;   // p lies on the grid (the last tile may be ragged)
  Line X, Y;
  __device__ TileThread(const Geom& g, const int* bt, const TilePlan& L,
                        int blk, int t) {
    col = t % L.tile;
    k0 = t / L.tile;
    dk = L.threads / L.tile;
    p = blk * L.tile + col;
    live = p < g.Ny * g.Nx;
    c = live ? rho_src(g, bt, p) : 0;
    const int J = c / g.Nx;
    const int I = c - J * g.Nx;
    X = x_line(g, J, I);
    Y = y_line(g, J, I);
    xin = 0;
    for (int j = 0; j < 4; ++j) {
      const int d = lane_d(j);
      const int nc = lane_shift(c, d, L.tile);
      const int nlive = lane_shift(static_cast<int>(live), d, L.tile);
      if (col + d >= 0 && col + d < L.tile && nlive && nc == X.o[j])
        xin |= 1 << j;
    }
  }
  // the loop counts that give every level slot (n items) the same trips,
  // so that all lanes reach the shuffles together
  __device__ int trips(int n) const { return (n + dk - 1) / dk; }
};

// The (tracer, level) items of one thread, k0, k0 + dk, ... of NT * N in
// tracer-major order, stepped without a division.
struct Items {
  int tr, k;
  __device__ Items(int k0, int N) : tr(k0 / N), k(k0 % N) {}
  __device__ void next(int dk, int N) {
    k += dk;
    while (k >= N) k -= N, ++tr;
  }
};

// A tracer level plane's values at c's xi and eta neighbours: qc is the
// plane at c on every lane (on the lanes with on set), the xi neighbours
// come from the lanes that hold them, the rest from q.  Every lane of the
// warp calls it.
template <typename T>
__device__ __forceinline__ void gather(const TileThread& me, int tile,
                                       const T* __restrict__ q, T qc,
                                       bool on, T (&xv)[4], T (&yv)[4]) {
  T xl[4];
  for (int j = 0; j < 4; ++j) {
    xl[j] = on && !(me.xin >> j & 1) ? __ldg(q + me.X.o[j]) : T(0);
    yv[j] = on ? __ldg(q + me.Y.o[j]) : T(0);
  }
  for (int j = 0; j < 4; ++j) {
    const T s = lane_shift(qc, lane_d(j), tile);
    xv[j] = me.xin >> j & 1 ? s : xl[j];
  }
}

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
  TilePlan plan;
  double dt;
  double coef[kMaxTr][4];   // cff cff1 cff2 cffv
};

template <typename T>
struct PredPtrs {
  const T *t, *t_prev, *Hz, *Huon, *Hvom, *W, *Akt, *pm, *pn, *stflx,
      *btflx, *ghats, *srflx, *swdk_w;
  T *t3, *t_nnew;
};

// The tile of block blk; sm: its tracer_rows(false, N, NT) x tile words.
template <typename T>
__device__ void tracer_predictor_tile(const PredParams& P,
                                      const PredPtrs<T>& A, T* sm, int blk,
                                      int t) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int NT = P.NT;
  const int tile = P.plan.tile;
  const int nth = P.plan.threads;
  const TileThread me(g, P.bt, P.plan, blk, t);
  const int c = me.c;
  const int p = me.p;
  auto arr = [&](int row) { return Col<T>{sm + row * tile + me.col, tile}; };
  const Col<T> Hz = arr(0), dv = arr(N), W = arr(2 * N);
  const Col<T> Fw = arr(3 * N + 1), Fe = arr(4 * N + 1),
               Gs = arr(5 * N + 1), Gn = arr(6 * N + 1);
  auto trc = [&](int tr, int a) {   // 0 q, 1 t3 before vadv, 2 FC, 3 CFs
    return arr(7 * N + 1 + tr * (4 * N + 1) + a * N + (a == 3));
  };
  const T pmn = me.live ? A.pm[c] * A.pn[c] : T(0);
  const T dt = T(P.dt);

  // the column's W, Hz, mass fluxes and their divergence: a thread per
  // (level, column)
#pragma unroll 2
  for (int m = 0; m < me.trips(N + 1); ++m) {
    const int k = me.k0 + m * me.dk;
    const bool on = me.live && k <= N;
    const bool lev = on && k < N;
    const int o = k * S;
    const T Wk = on ? __ldg(A.W + o + c) : T(0);
    const T Wk1 = lev ? __ldg(A.W + o + S + c) : T(0);
    const T Hzk = lev ? __ldg(A.Hz + o + c) : T(0);
    const T fw = lev ? __ldg(A.Huon + o + c) : T(0);
    const T gs = lev ? __ldg(A.Hvom + o + c) : T(0);
    const T gn = lev ? __ldg(A.Hvom + o + me.Y.o[2]) : T(0);
    // Huon at the next face along xi: the next lane's fw (xin bit 2)
    const T fl = lev && !(me.xin & 4) ? __ldg(A.Huon + o + me.X.o[2]) : T(0);
    const T fs = lane_shift(fw, 1, tile);
    const T fe = me.xin & 4 ? fs : fl;
    if (on) W[k] = Wk;
    if (!lev) continue;
    Hz[k] = Hzk;
    Fw[k] = fw, Fe[k] = fe, Gs[k] = gs, Gn[k] = gn;
    dv[k] = (fe - fw) + (gn - gs) + (Wk1 - Wk);
  }
  __syncthreads();

  // horizontal advection: a thread per (tracer, level, column)
  Items it(me.k0, N);
  for (int m = 0; m < me.trips(NT * N); ++m, it.next(me.dk, N)) {
    const bool on = me.live && it.tr < NT;
    const int tr = on ? it.tr : 0;
    const int k = on ? it.k : 0;
    const T* q = A.t + (tr * N + k) * S;
    const T qc = on ? __ldg(q + c) : T(0);
    const T qp = on ? __ldg(A.t_prev + (tr * N + k) * S + c) : T(0);
    T xv[4], yv[4];
    gather(me, tile, q, qc, on, xv, yv);
    if (!on) continue;
    const T div = line_div(q, me.X, xv, qc, Fw[k], Fe[k], P.hadv[tr]) +
                  line_div(q, me.Y, yv, qc, Gs[k], Gn[k], P.hadv[tr]);
    const T cff = T(P.coef[tr][0]);
    const T cff1 = T(P.coef[tr][1]);
    const T cff2 = T(P.coef[tr][2]);
    trc(tr, 0)[k] = qc;
    trc(tr, 1)[k] = Hz[k] * (cff1 * qc + cff2 * qp) - cff * pmn * div;
  }

  // t(nnew) at p itself: surface/bottom, nonlocal and solar fluxes at the
  // interfaces k and k+1 (the same items: Hz and the tracer at p are this
  // thread's own where p is c).  Every load of an item comes first; the
  // flux terms that are off read a stand-in array.
  if (me.live) {
#pragma unroll 2
    for (Items it(me.k0, N); it.tr < NT; it.next(me.dk, N)) {
      const int tr = it.tr;
      const int k = it.k;
      const int o = k * S;
      const int ltrc = NT >= 2 ? (tr < 1 ? tr : 1) : 0;
      const bool nonlocal = tr < P.ng;
      const bool sol = P.sol && tr == 0;
      const T* Akt = nonlocal ? A.Akt + ltrc * (N + 1) * S : A.W;
      const T* gh = nonlocal ? A.ghats + tr * (N + 1) * S : A.W;
      const T* swdk = sol ? A.swdk_w : A.W;
      const T* srflx = sol ? A.srflx : A.pm;
      T ak[2], g[2], sw[2];
      for (int e = 0; e < 2; ++e) {
        ak[e] = __ldg(Akt + o + e * S + p);
        g[e] = __ldg(gh + o + e * S + p);
        sw[e] = __ldg(swdk + o + e * S + p);
      }
      const T sr = __ldg(srflx + p);
      const T bot = __ldg(A.btflx + tr * S + p);
      const T top = __ldg(A.stflx + tr * S + p);
      const T Hzp = p == c ? Hz[k] : __ldg(A.Hz + o + p);
      const T qp = p == c ? trc(tr, 0)[k] : __ldg(A.t + (tr * N + k) * S + p);
      T FCd[2];
      for (int e = 0; e < 2; ++e) {
        T v = T(0);
        if (nonlocal) v = v - dt * ak[e] * g[e];
        if (sol) v = v + dt * sr * sw[e];
        FCd[e] = k + e == 0 ? dt * bot : (k + e == N ? dt * top : v);
      }
      A.t_nnew[(tr * N + k) * S + p] = Hzp * qp + (FCd[1] - FCd[0]);
    }
  }
  __syncthreads();

  // vertical advection: C4 a thread per (interface, column), SPLINES a
  // thread per (tracer, column)
  if (me.live) {
    for (int tr = 0; tr < NT; ++tr) {
      if (P.vadv[tr] != V_C4) continue;
      const Col<T> q = trc(tr, 0), FC = trc(tr, 2);
      for (int k = me.k0; k <= N; k += me.dk)
        FC[k] = k == 0 || k == N ? T(0) : c4_flux<T>(q, W, N, k);
    }
  }
  for (int u = t; u < NT * tile; u += nth) {
    const int tr = u / tile;
    if (me.live && P.vadv[tr] == V_SPLINES)
      spline_interp_flux<T>(trc(tr, 0), Hz, W, N, 1.5, 0.5, 3.0, 2.0,
                            trc(tr, 2), trc(tr, 3));
  }
  __syncthreads();

  // t3 with the vertical flux and the artificial continuity, at p
  if (me.live) {
    for (int k = me.k0; k < N; k += me.dk) {
      const T Hzk = Hz[k];
      const T dvk = dv[k];
      for (int tr = 0; tr < NT; ++tr) {
        const T cffv = T(P.coef[tr][3]);
        const Col<T> FC = trc(tr, 2);
        const T DC = T(1) / (Hzk - cffv * pmn * dvk);
        A.t3[(tr * N + k) * S + p] =
            DC * (trc(tr, 1)[k] - cffv * pmn * (FC[k + 1] - FC[k]));
      }
    }
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
  P.plan.tile = ip[n++];
  P.plan.threads = ip[n++];
  P.plan.smem = ip[n++];
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
  TilePlan plan;
  double dt;
};

template <typename T>
struct CorrPtrs {
  const T *t_nnew, *t3, *Huon, *Hvom, *W, *Hz, *z_r, *Akt, *pm, *pn;
  T* t;
};

// The tile of block blk; sm: its tracer_rows(true, N, NT) x tile words.
template <typename T>
__device__ void tracer_corrector_tile(const CorrParams& P,
                                      const CorrPtrs<T>& A, T* sm, int blk,
                                      int t) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int NT = P.NT;
  const int nak = NT >= 2 ? 2 : 1;
  const int tile = P.plan.tile;
  const int nth = P.plan.threads;
  const TileThread me(g, P.bt, P.plan, blk, t);
  const int c = me.c;
  auto arr = [&](int row) { return Col<T>{sm + row * tile + me.col, tile}; };
  const Col<T> Hz = arr(0), oHz = arr(N), W = arr(2 * N);
  const Col<T> Fw = arr(3 * N + 1), Fe = arr(4 * N + 1),
               Gs = arr(5 * N + 1), Gn = arr(6 * N + 1), zr = arr(7 * N + 1);
  auto AK = [&](int l) { return arr(8 * N + 1 + l * (N + 1)); };
  auto trc = [&](int tr, int a) {   // 0 q, 1 t(n+1), 2 FC, 3 CFs
    return arr(8 * N + 1 + nak * (N + 1) + tr * (4 * N + 1) + a * N +
               (a == 3));
  };
  const T pmn = me.live ? A.pm[c] * A.pn[c] : T(0);
  const T dt = T(P.dt);

  // the column's Hz, W, mass fluxes, Akt and z_r: a thread per (level,
  // column)
#pragma unroll 2
  for (int m = 0; m < me.trips(N + 1); ++m) {
    const int k = me.k0 + m * me.dk;
    const bool on = me.live && k <= N;
    const bool lev = on && k < N;
    const int o = k * S;
    T ak[2];
    for (int l = 0; l < 2; ++l)
      ak[l] = on && l < nak ? __ldg(A.Akt + l * (N + 1) * S + o + c) : T(0);
    const T Wk = on ? __ldg(A.W + o + c) : T(0);
    const T Hzk = lev ? __ldg(A.Hz + o + c) : T(0);
    const T zrk = lev && !P.splines ? __ldg(A.z_r + o + c) : T(0);
    const T fw = lev ? __ldg(A.Huon + o + c) : T(0);
    const T gs = lev ? __ldg(A.Hvom + o + c) : T(0);
    const T gn = lev ? __ldg(A.Hvom + o + me.Y.o[2]) : T(0);
    // Huon at the next face along xi: the next lane's fw (xin bit 2)
    const T fl = lev && !(me.xin & 4) ? __ldg(A.Huon + o + me.X.o[2]) : T(0);
    const T fs = lane_shift(fw, 1, tile);
    const T fe = me.xin & 4 ? fs : fl;
    if (!on) continue;
    W[k] = Wk;
    for (int l = 0; l < nak; ++l) AK(l)[k] = ak[l];
    if (!lev) continue;
    Hz[k] = Hzk;
    oHz[k] = T(1) / Hzk;
    zr[k] = zrk;
    Fw[k] = fw, Fe[k] = fe, Gs[k] = gs, Gn[k] = gn;
  }
  __syncthreads();

  // horizontal advection: a thread per (tracer, level, column)
  Items it(me.k0, N);
  for (int m = 0; m < me.trips(NT * N); ++m, it.next(me.dk, N)) {
    const bool on = me.live && it.tr < NT;
    const int tr = on ? it.tr : 0;
    const int k = on ? it.k : 0;
    const T* q = A.t3 + (tr * N + k) * S;
    const T qc = on ? __ldg(q + c) : T(0);
    const T tnn = on ? __ldg(A.t_nnew + (tr * N + k) * S + c) : T(0);
    T xv[4], yv[4];
    gather(me, tile, q, qc, on, xv, yv);
    if (!on) continue;
    const T div = line_div(q, me.X, xv, qc, Fw[k], Fe[k], P.hadv[tr]) +
                  line_div(q, me.Y, yv, qc, Gs[k], Gn[k], P.hadv[tr]);
    trc(tr, 0)[k] = qc;
    trc(tr, 1)[k] = tnn - dt * pmn * div;
  }
  __syncthreads();

  // vertical advection: C4 a thread per (interface, column), SPLINES a
  // thread per (tracer, column)
  if (me.live) {
    for (int tr = 0; tr < NT; ++tr) {
      if (P.vadv[tr] != V_C4) continue;
      const Col<T> q = trc(tr, 0), FC = trc(tr, 2);
      for (int k = me.k0; k <= N; k += me.dk)
        FC[k] = k == 0 || k == N ? T(0) : c4_flux<T>(q, W, N, k);
    }
  }
  for (int u = t; u < NT * tile; u += nth) {
    const int tr = u / tile;
    if (me.live && P.vadv[tr] == V_SPLINES)
      spline_interp_flux<T>(trc(tr, 0), Hz, W, N, 2.0, 1.0, 2.0, 1.0,
                            trc(tr, 2), trc(tr, 3));
  }
  __syncthreads();

  // the vertical flux, over Hz (times Hz again for the Thomas solve)
  if (me.live) {
    for (int k = me.k0; k < N; k += me.dk) {
      for (int tr = 0; tr < NT; ++tr) {
        const Col<T> tn = trc(tr, 1), FC = trc(tr, 2);
        T v = (tn[k] - dt * pmn * (FC[k + 1] - FC[k])) * oHz[k];
        if (!P.splines) v = v * Hz[k];
        tn[k] = v;
      }
    }
  }
  __syncthreads();

  // implicit vertical diffusion: a thread per (tracer, column)
  for (int u = t; u < NT * tile; u += nth) {
    const int tr = u / tile;
    if (!me.live) continue;
    const Col<T> Akt = AK(NT >= 2 ? (tr < 1 ? tr : 1) : 0);
    if (P.splines)
      spline_vdiff_flux(dt, Hz, oHz, Akt, trc(tr, 1), N, trc(tr, 2),
                        trc(tr, 3));
    else
      thomas_implicit<T>(P.dt, Hz, zr, Akt, trc(tr, 1), N, trc(tr, 2),
                         trc(tr, 3));
  }
  __syncthreads();

  // the splines' flux divergence, and the new tracers at p
  if (me.live) {
    for (int k = me.k0; k < N; k += me.dk) {
      for (int tr = 0; tr < NT; ++tr) {
        const Col<T> tn = trc(tr, 1), FC = trc(tr, 2);
        T v = tn[k];
        if (P.splines) v = v + dt * oHz[k] * (FC[k + 1] - FC[k]);
        A.t[(tr * N + k) * S + me.p] = v;
      }
    }
  }
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
  P.plan.tile = ip[n++];
  P.plan.threads = ip[n++];
  P.plan.smem = ip[n++];
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
