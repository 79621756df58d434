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
//     vertical fluxes but SPLINES; the updates around the vertical solves;
//     the predictor's t(nnew) start; every store.  The horizontal stencil
//     takes its xi neighbours from the neighbouring lanes (warp shuffles)
//     where they hold them, and loads the rest through its Line.
//   - The serial recurrences (SPLINES vertical advection, the spline or
//     Thomas vertical diffusion) run one thread per column and tracer, in
//     the plain version's order, from shared memory.
//   - Block barriers separate the two.
// uv_corrector works on tiles the same way, both directions a block (its
// passes are listed at uv_corrector_tile).
//
// Boundary writes and the halo fill are gathers (csrc/bc.cuh): a tile's
// point p computes the column its value comes from, c = rho_src(p), so
// every padded point agrees with the plain version, halo included (the
// predictor's t(nnew) start, which has no boundary write, at p itself).
// uv_corrector's column sums run in k order in one thread a column and
// direction; torch.sum on the card sums in another order, so the two
// differ by round-off.
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
static_assert(sizeof(PredParams) + sizeof(PredPtrs<double>) <=
                  kMaxParamBytes,
              "the tracer predictor's parameters outgrow a launch at kMaxTr");

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

  // vertical advection: SPLINES a thread per (tracer, column), the other
  // schemes a thread per (interface, column)
  if (me.live) {
    for (int tr = 0; tr < NT; ++tr) {
      if (P.vadv[tr] == V_SPLINES) continue;
      const Col<T> q = trc(tr, 0), FC = trc(tr, 2);
      for (int k = me.k0; k <= N; k += me.dk)
        FC[k] = vadv_flux<T>(P.vadv[tr], q, W, N, k);
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
static_assert(sizeof(CorrParams) + sizeof(CorrPtrs<double>) <=
                  kMaxParamBytes,
              "the tracer corrector's parameters outgrow a launch at kMaxTr");

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

  // vertical advection: SPLINES a thread per (tracer, column), the other
  // schemes a thread per (interface, column)
  if (me.live) {
    for (int tr = 0; tr < NT; ++tr) {
      if (P.vadv[tr] == V_SPLINES) continue;
      const Col<T> q = trc(tr, 0), FC = trc(tr, 2);
      for (int k = me.k0; k <= N; k += me.dk)
        FC[k] = vadv_flux<T>(P.vadv[tr], q, W, N, k);
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
  TilePlan plan;
  double dt, cff, gamma2;
};

template <typename T>
struct UvPtrs {
  // [d] = xi (u) or eta (v) counterpart
  const T *vel_nnew[2], *r[2], *Hz, *Akv, *D1[2], *D2[2], *flx_old[2], *pm,
      *pn, *mask[2];
  T *vel[2], *bar[2], *flx[2];
};

// Shared words a tile column of uv_corrector holds: for each direction its
// velocity, Hk, 1/Hk, the coupling's thickness DCk and CFs (N each: CFs is
// the solve's scratch, then the old mass flux, then the time-centred
// flux), AK and the solve's flux (N+1 each), and the column's CF0, sum of
// DCk, err and FCc.
__host__ __device__ constexpr int uv_rows(int N) { return 2 * (7 * N + 6); }

// the i-1 (d = 0) or j-1 (d = 1) neighbour of padded point q
__device__ __forceinline__ int uv_back(const Geom& g, int q, int d) {
  const int J = q / g.Nx;
  const int I = q - J * g.Nx;
  return d == 0 ? J * g.Nx + wrap(I - 1, g.Nx)
                : wrap(J - 1, g.Ny) * g.Nx + I;
}

// What padded point p of direction d takes from where: f, the point the
// halo fill copies into p; b, the point whose AB3 update apply_bc_u/v
// writes at f (zero: none, the normal-direction closed wall; gamma: times
// gamma2); their back neighbours bw and fw; and whether the coupling adds
// -CFb at f once for a boundary column and once for a boundary row (u at
// the wall faces I = H, H+L and the rows J = H-1, H+M; v at the columns I
// = H-1, H+L and the wall faces J = H, H+M, on non-periodic edges).
struct UvCol {
  int b, bw, f, fw;
  bool zero, gamma, col, row;
};

__device__ __forceinline__ UvCol uv_col(const UvParams& P, int p, int d) {
  const Geom& g = P.g;
  const int Jf = fill_src(p / g.Nx, g.H, g.M, g.ns_per);
  const int If = fill_src(p % g.Nx, g.H, g.L, g.ew_per);
  const BcSrc src =
      d == 0 ? bc_u_src(g, P.bu, Jf, If) : bc_v_src(g, P.bv, Jf, If);
  UvCol c;
  c.f = Jf * g.Nx + If;
  c.b = src.zero ? c.f : src.q;
  c.bw = uv_back(g, c.b, d);
  c.fw = uv_back(g, c.f, d);
  c.zero = src.zero;
  c.gamma = src.gamma;
  c.col = !g.ew_per && (If == (d == 0 ? g.H : g.H - 1) || If == g.H + g.L);
  c.row = !g.ns_per && (Jf == (d == 0 ? g.H - 1 : g.H) || Jf == g.H + g.M);
  return c;
}

// The tile of block blk; sm: its uv_rows(N) x tile words.
//
// A block owns `tile` consecutive padded points (flattened j, i) and both
// directions; its threads split into tile columns x level slots (at least
// four), as the tracer kernels' do.  Each thread works out, for its column
// and both directions, where the column's values come from (UvCol): in the
// interior b = f = p, at the halo and the walls other columns, whose
// inputs it reads from device memory (L2), never from the tile.  Then:
//   A. a thread per (level, column): Hk, 1/Hk and the AB3 velocity at b,
//      AK (splines) and DCk at f - both directions, the lanes of a warp
//      neighbouring columns of one level, so that the loads coalesce;
//   B. a thread per (direction, column): the spline solve of the vertical
//      viscosity, from shared memory (column.cuh spline_vdiff_flux); beside
//      it, another thread per (direction, column) sums Hk (CF0) and DCk,
//      which do not depend on the solve;
//   C. a thread per (level, column): the solve's update of the velocity;
//   D. a thread per (direction, column): the sum DCm and the barotropic
//      error err, after issuing the copies of the old mass flux at f into
//      the column (cp.async), which it reads in F;
//   E. a thread per (level, column): the mean replacement and mask, the
//      lateral BC and mask at f;
//   F. a thread per (direction, column): the sum of DCk u, ubar, the
//      boundary-ring correction -CFb, the time-centred flux and its sum,
//      and FCc;
//   G. a thread per (level, column): the stores of u (v) and Huon (Hvom).
// Block barriers separate the passes; every sum runs in k order.
template <typename T>
__device__ void uv_corrector_tile(const UvParams& P, const UvPtrs<T>& A,
                                  T* sm, int blk, int t) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int tile = P.plan.tile;
  const int col = t % tile;
  const int k0 = t / tile;      // the direction (k0 % 2) in B, D and F
  const int dk = P.plan.threads / tile;
  const int p = blk * tile + col;
  const bool live = p < S;
  const bool solver = k0 < 2 && live;             // B (the solve), D, F
  const bool summer = k0 >= 2 && k0 < 4 && live;  // B (the sums)
  const T dt = T(P.dt);
  const T gamma2 = T(P.gamma2);
  auto arr = [&](int d, int row) {
    return Col<T>{sm + (d * (7 * N + 6) + row) * tile + col, tile};
  };
  auto vel = [&](int d) { return arr(d, 0); };
  auto Hk = [&](int d) { return arr(d, N); };
  auto oH = [&](int d) { return arr(d, 2 * N); };
  auto DCk = [&](int d) { return arr(d, 3 * N); };
  auto CFs = [&](int d) { return arr(d, 4 * N); };
  auto AK = [&](int d) { return arr(d, 5 * N); };
  auto flux = [&](int d) { return arr(d, 6 * N + 1); };
  auto scalar = [&](int d, int n) {   // 0 CF0, 1 sum DCk, 2 err, 3 FCc
    return arr(d, 7 * N + 2 + n);
  };
  // the metric on_u = 2/(pn[i-1] + pn[i]) or om_v = 2/(pm[j-1] + pm[j]) at
  // q, whose back neighbour is qw (grid.py)
  auto metric = [&](int d, int qw, int q) {
    const T* m = d == 0 ? A.pn : A.pm;
    return T(1) / (m[qw] + m[q]) * T(2);
  };
  // member d of a pair, d known at run time only (selects, so that no
  // array is indexed at run time and nothing goes to the stack)
  auto pick = [](auto pair, int d) { return d == 0 ? pair[0] : pair[1]; };

  // this column's sources, and its constants of each direction: the AB3
  // factor DC0 at b, the masks at b and f, and 0.5 on_u (om_v) at f
  UvCol c[2];
  T DC0[2], mask_b[2], mask_f[2], half_metric[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    c[d] = uv_col(P, live ? p : 0, d);
    const int b = c[d].b, bw = c[d].bw;
    DC0[d] = T(P.cff) * (A.pm[b] + A.pm[bw]) * (A.pn[b] + A.pn[bw]);
    mask_b[d] = A.mask[d][b];
    mask_f[d] = A.mask[d][c[d].f];
    half_metric[d] = T(0.5) * metric(d, c[d].fw, c[d].f);
  }

  // A. the AB3 velocity at b over Hk, AK, and DCk at f: a thread per
  // (level, column)
#pragma unroll 2
  for (int k = k0; k <= N; k += dk) {
    const int o = k * S;
    T hz[2], hzw[2], hzf[2], hzfw[2], vn[2], r[2], ak[2], akw[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const bool lev = live && k < N;
      const bool on = live && !c[d].zero;
      const bool lon = on && k < N;
      const bool sp = on && P.splines;
      const int b = c[d].b, bw = c[d].bw;
      hz[d] = lon ? __ldg(A.Hz + o + b) : T(0);
      hzw[d] = lon ? __ldg(A.Hz + o + bw) : T(0);
      hzf[d] = lev ? __ldg(A.Hz + o + c[d].f) : T(0);
      hzfw[d] = lev ? __ldg(A.Hz + o + c[d].fw) : T(0);
      vn[d] = lon ? __ldg(A.vel_nnew[d] + o + b) : T(0);
      r[d] = lon ? __ldg(A.r[d] + o + b) : T(0);
      ak[d] = sp ? __ldg(A.Akv + o + b) : T(0);
      akw[d] = sp ? __ldg(A.Akv + o + bw) : T(0);
    }
    if (!live) continue;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (k < N) DCk(d)[k] = half_metric[d] * (hzf[d] + hzfw[d]);
      if (c[d].zero) continue;
      if (k < N) {
        const T h = T(0.5) * (hz[d] + hzw[d]);
        const T oh = T(1) / h;
        Hk(d)[k] = h;
        oH(d)[k] = oh;
        vel(d)[k] = (vn[d] + DC0[d] * r[d]) * oh;
      }
      if (P.splines) AK(d)[k] = T(0.5) * (ak[d] + akw[d]);
    }
  }
  __syncthreads();

  // B. the spline vertical viscosity, and the column sums of Hk and DCk: a
  // thread per (direction, column) each
  if (solver && P.splines && !pick(c, k0).zero)
    spline_vdiff_flux(dt, Hk(k0), oH(k0), AK(k0), vel(k0), N, flux(k0),
                      CFs(k0));
  if (summer) {
    const int d = k0 - 2;
    const Col<T> h = Hk(d), D = DCk(d);
    T CF0 = T(0);
    T sumD = T(0);
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      if (!pick(c, d).zero) CF0 = CF0 + h[k];
      sumD = sumD + D[k];
    }
    scalar(d, 0)[0] = CF0;
    scalar(d, 1)[0] = sumD;
  }
  __syncthreads();

  if (P.splines) {
    // C. the solve's update of the velocity: a thread per (level, column)
    for (int k = k0; k < N; k += dk) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        if (!live || c[d].zero) continue;
        const Col<T> v = vel(d), F = flux(d);
        v[k] = v[k] + dt * oH(d)[k] * (F[k + 1] - F[k]);
      }
    }
    __syncthreads();
  }

  // D. the old mass flux at f into CFs, in flight until F; the sum DCm
  // and the barotropic error: a thread per (direction, column)
  if (solver) {
    const int d = k0;
    const UvCol cd = pick(c, d);
    const Col<T> fo = CFs(d);
    const T* flx_old = pick(A.flx_old, d);
    for (int k = 0; k < N; ++k)
      copy_async(&fo[k], flx_old + k * S + cd.f);
    copy_async_commit();
    if (!cd.zero) {
      const Col<T> v = vel(d), h = Hk(d);
      T DCm = T(0);
#pragma unroll 4
      for (int k = 0; k < N; ++k) DCm = DCm + v[k] * h[k];
      const T mb = metric(d, cd.bw, cd.b);
      scalar(d, 2)[0] =
          (DCm * mb - pick(A.D1, d)[cd.b]) / (scalar(d, 0)[0] * mb);
    }
  }
  __syncthreads();

  // E. mean replacement and mask at b, lateral BC and mask at f: a thread
  // per (level, column)
  if (live) {
    for (int k = k0; k < N; k += dk) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const Col<T> v = vel(d);
        const T u =
            c[d].zero ? T(0) : (v[k] - scalar(d, 2)[0]) * mask_b[d];
        v[k] = mask_f[d] * (c[d].gamma ? gamma2 * u : u);
      }
    }
  }
  __syncthreads();

  // F. the 2-D/3-D coupling at f (step3d_uv.F:997-1213): a thread per
  // (direction, column)
  if (solver) {
    const int d = k0;
    const UvCol cd = pick(c, d);
    const Col<T> v = vel(d), D = DCk(d), fo = CFs(d);
    const T D1f = pick(A.D1, d)[cd.f];
    const T D2f = pick(A.D2, d)[cd.f];
    T sumDv = T(0);
#pragma unroll 4
    for (int k = 0; k < N; ++k) sumDv = sumDv + D[k] * v[k];
    const T oD = T(1) / scalar(d, 1)[0];
    const T CFb = oD * (sumDv - D1f);
    pick(A.bar, d)[p] = oD * D1f;
    copy_async_wait<0>();     // the old mass flux
    T sumF = T(0);
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      T u = v[k];
      if (cd.col) u = u + -CFb;
      if (cd.row) u = u + -CFb;
      const T fl = T(0.5) * (fo[k] + u * D[k]);
      sumF = sumF + fl;
      v[k] = u;
      fo[k] = fl;
    }
    scalar(d, 3)[0] = oD * (sumF - D2f);
  }
  __syncthreads();

  // G. u (v) and Huon (Hvom) at p: a thread per (level, column)
  if (live) {
    for (int k = k0; k < N; k += dk) {
      const int o = k * S;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        A.vel[d][o + p] = vel(d)[k];
        A.flx[d][o + p] = CFs(d)[k] - DCk(d)[k] * scalar(d, 3)[0];
      }
    }
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
  P.plan.tile = ip[n++];
  P.plan.threads = ip[n++];
  P.plan.smem = ip[n++];
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
