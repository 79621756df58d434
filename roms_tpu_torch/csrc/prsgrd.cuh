// Baroclinic pressure gradient, prsgrd32 (splines density Jacobian,
// prsgrd32.h:119-285), for one 2-D tile of padded points per block.
//
// Replaces the TPU kernel roms_tpu/ops/prsgrd_pallas.py::prsgrd32_fused.
// Bound on the H100: bandwidth.  It must read rho, z_r and Hz (3 (N,Ny,Nx)
// planes), the surface plane of z_w, pm and pn, and write ru and rv: ~22 MB
// at BENCHMARK1 in float32, 0.0066 ms at 3.35 TB/s, for ~110 operations a
// (k,j,i) point.  The serial part is the downward pressure integral, N - 1
// dependent additions a water column.
// Design: block (bx, by) owns a tile of tx x ty points (the plan,
// ops/prsgrd_cuda.prsgrd_plan) and its region: the tile's columns and one
// more to the west and to the south, the columns whose pressure the xi and
// eta gradients read.  Each region column is integrated once, from shared
// memory, in three passes over [k][column] arrays:
//   A1  a thread per (level, column) copies rho and z_r in (cp.async), so
//       that a block has the loads of all its levels in flight at once;
//   A2  a thread per (level, column) computes the pressure increment of
//       prsgrd32.h:134-186 (the monotonized differences dRm and dZm at the
//       two levels it needs, from the loaded columns);
//   A3  a thread per column runs the sum from the top down, in k order
//       (acc = acc + inc; P[k] = top + acc), the order in which torch's
//       flip(cumsum(flip)) adds on the card.
// Then a thread per (level, point) computes ru and rv from P, rho and z_r in
// shared memory; the neighbours i-2, i+1, j-2 and j+1 that the region does
// not hold (on the tile's edge) come from device memory.  Neighbours wrap
// modulo the padded extent, as torch.roll does, so every padded point is
// computed, halo included, with no boundary write (prsgrd32 has none).  No
// thread holds a column in its own storage: the kernel has no stack frame.
#pragma once

#include "column.cuh"

namespace roms {

// The launch, chosen by ops/prsgrd_cuda.prsgrd_plan: points of a tile
// along xi and eta, threads a block and the dynamic shared memory, which
// the entry point checks against prsgrd_smem.
struct PrsPlan {
  int tx, ty, threads, smem;
};

struct PrsParams {
  Geom g;
  int N;
  PrsPlan plan;
  double grav, GRho, HalfGRho;
};

template <typename T>
struct PrsPtrs {
  const T *rho, *z_r, *z_w, *Hz, *pm, *pn, *eq_tide;
  T *ru, *rv;
};

// columns of a tile's region: the tile and one column west, one row south
__host__ __device__ constexpr int prsgrd_columns(int tx, int ty) {
  return (tx + 1) * (ty + 1);
}

// shared bytes of a block: rho, z_r and P of every region column and level,
// then the columns' padded offsets
__host__ __device__ constexpr int prsgrd_smem(int N, int tx, int ty,
                                              int word) {
  return prsgrd_columns(tx, ty) * (3 * N * word + 4);
}

// prsgrd._harm_clamped: 2ab/(a+b) where 2ab > 1e-10, else 0
template <typename T>
__device__ __forceinline__ T harm_clamped(T a, T b) {
  const T cff = T(2) * a * b;
  return cff > T(1.0e-10) ? cff / (a + b) : T(0);
}

// The pressure increment between levels k and k+1 (0 <= k <= N-2) of a
// column whose rho and z_r are r[m * s] and z[m * s] (prsgrd32.h:134-186):
// the end-padded first differences dRp/dZp, their monotonized means dRm/dZm
// at k and k+1, and the spline integral.
template <typename T>
__device__ __forceinline__ T pressure_increment(T HalfGRho, const T* r,
                                                const T* z, int s, int N,
                                                int k) {
  auto dp = [&](const T* f, int m) {
    const int a = clampi(m - 1, 0, N - 2);
    return f[(a + 1) * s] - f[a * s];
  };
  const T dR0 = dp(r, k), dR1 = dp(r, k + 1), dR2 = dp(r, k + 2);
  const T dZ0 = dp(z, k), dZ1 = dp(z, k + 1), dZ2 = dp(z, k + 2);
  const T dRm0 = harm_clamped(dR1, dR0);
  const T dRm1 = harm_clamped(dR2, dR1);
  const T dZm0 = T(2) * dZ1 * dZ0 / (dZ1 + dZ0);
  const T dZm1 = T(2) * dZ2 * dZ1 / (dZ2 + dZ1);
  const T OneFifth = T(0.2);
  const T OneTwelfth = T(1.0 / 12.0);
  const T r0 = r[k * s], r1 = r[(k + 1) * s];
  const T z0 = z[k * s], z1 = z[(k + 1) * s];
  return HalfGRho *
         ((r1 + r0) * (z1 - z0) -
          OneFifth * ((dRm1 - dRm0) * (z1 - z0 - OneTwelfth * (dZm1 + dZm0)) -
                      (dZm1 - dZm0) * (r1 - r0 - OneTwelfth * (dRm1 + dRm0))));
}

// One directional component at one level (prsgrd32.h:188-285) at point q,
// from rho (r*) and z_r (z*) at q, its neighbour behind (m: i-1 or j-1),
// the one behind that (mm) and the one ahead (p); metric = on_u or om_v at
// q, Hq/Hm = Hz at q and m, Pq/Pm = P at q and m.
template <typename T>
__device__ __forceinline__ T prsgrd_component(T HalfGRho, T metric, T Hq,
                                              T Hm, T Pq, T Pm, T rq, T rm,
                                              T rmm, T rp, T zq, T zm, T zmm,
                                              T zp) {
  const T OneFifth = T(0.2);
  const T OneTwelfth = T(1.0 / 12.0);
  const T dz = zq - zm;
  const T dz_m = zm - zmm;
  const T dz_p = zp - zq;
  const T dr = rq - rm;
  const T dr_m = rm - rmm;
  const T dr_p = rp - rq;
  const T dZ = harm_clamped(dz, dz_p);
  const T dZ_m = harm_clamped(dz_m, dz);
  const T dR = harm_clamped(dr, dr_p);
  const T dR_m = harm_clamped(dr_m, dr);
  return metric * T(0.5) * (Hq + Hm) *
         (Pm - Pq -
          HalfGRho * ((rq + rm) * dz -
                      OneFifth * ((dR - dR_m) * (dz - OneTwelfth * (dZ + dZ_m)) -
                                  (dZ - dZ_m) * (dr - OneTwelfth * (dR + dR_m)))));
}

// The tile (bx, by) of block tid's thread; sm: prsgrd_smem bytes.  Every
// thread reaches every barrier.
template <typename T>
__device__ void prsgrd32_tile(const PrsParams& P, const PrsPtrs<T>& A,
                              unsigned char* sm, int bx, int by, int tid) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int tx = P.plan.tx, ty = P.plan.ty, nth = P.plan.threads;
  const int cw = tx + 1;                    // region columns a row
  const int nc = prsgrd_columns(tx, ty);
  T* R = reinterpret_cast<T*>(sm);          // [k][column], column c is
  T* Z = R + N * nc;                        // (cy, cx) = (c / cw, c % cw):
  T* Pr = Z + N * nc;                       // padded point (j0-1+cy, i0-1+cx)
  int* off = reinterpret_cast<int*>(Pr + N * nc);
  const int i0 = bx * tx, j0 = by * ty;
  const T HalfGRho = T(P.HalfGRho);

  for (int c = tid; c < nc; c += nth) {
    const int cy = c / cw;
    off[c] = wrap(j0 - 1 + cy, g.Ny) * g.Nx + wrap(i0 - 1 + c - cy * cw, g.Nx);
  }
  __syncthreads();
  // A1: rho and z_r of every region column (x) and level (y), all in
  // flight
  for (Walk w(tid, nth, nc); w.y < N; w.next()) {
    const int q = w.y * S + off[w.x];
    copy_async(R + w.e, A.rho + q);
    copy_async(Z + w.e, A.z_r + q);
  }
  copy_async_commit();
  copy_async_wait<0>();
  __syncthreads();
  // A2: the increments between levels k and k+1, into P's level k
  for (Walk w(tid, nth, nc); w.y < N - 1; w.next())
    Pr[w.e] = pressure_increment(HalfGRho, R + w.x, Z + w.x, nc, N, w.y);
  __syncthreads();
  // A3: the surface pressure and the sum from the top down
  for (int c = tid; c < nc; c += nth) {
    const T g0 = T(P.grav);
    const T GRho = T(P.GRho);
    const T zwN = __ldg(A.z_w + N * S + off[c]);
    const T rN = R[(N - 1) * nc + c], rN1 = R[(N - 2) * nc + c];
    const T zN = Z[(N - 1) * nc + c], zN1 = Z[(N - 2) * nc + c];
    const T cff2 = T(0.5) * (rN - rN1) * (zwN - zN) / (zN - zN1);
    T top = g0 * zwN + GRho * (rN + cff2) * (zwN - zN);
    if (A.eq_tide) top = top - g0 * __ldg(A.eq_tide + off[c]);
    T* pc = Pr + c;
    pc[(N - 1) * nc] = top;
    T acc = T(0);
    for (int k = N - 2; k >= 0; --k) {
      acc = acc + pc[k * nc];
      pc[k * nc] = top + acc;
    }
  }
  __syncthreads();

  // B: a thread per (level, point); tx * ty divides the threads
  const int npts = tx * ty;
  const int pt = tid % npts;
  const int dk = nth / npts;
  const int ly = pt / tx, lx = pt - ly * tx;
  const int j = j0 + ly, i = i0 + lx;
  const bool live = j < g.Ny && i < g.Nx;   // the tile's ragged edge
  const int jw = wrap(j, g.Ny) * g.Nx, iw = wrap(i, g.Nx);
  const int p = jw + iw;
  const int qw = jw + wrap(i - 1, g.Nx);
  const int qs = wrap(j - 1, g.Ny) * g.Nx + iw;
  // the neighbours the region lacks on the tile's edge: i-2, i+1, j-2, j+1
  const int qww = jw + wrap(i - 2, g.Nx), qe = jw + wrap(i + 1, g.Nx);
  const int qss = wrap(j - 2, g.Ny) * g.Nx + iw;
  const int qn = wrap(j + 1, g.Ny) * g.Nx + iw;
  const bool ww_in = lx >= 1, e_in = lx + 1 < tx;
  const bool ss_in = ly >= 1, n_in = ly + 1 < ty;
  const int c = (ly + 1) * cw + lx + 1;     // the point's region column
  // on_u = 2/(pn[i-1] + pn[i]), om_v = 2/(pm[j-1] + pm[j]) (grid.py)
  const T on_u = T(1) / (__ldg(A.pn + qw) + __ldg(A.pn + p)) * T(2);
  const T om_v = T(1) / (__ldg(A.pm + qs) + __ldg(A.pm + p)) * T(2);
  for (int k = tid / npts; k < N; k += dk) {
    const int o = k * S;
    const T* r = R + k * nc;
    const T* z = Z + k * nc;
    const T* pk = Pr + k * nc;
    auto at = [&](const T* sh, const T* f, bool in, int cs, int q) {
      return in ? sh[cs] : __ldg(f + o + q);
    };
    const T Hq = __ldg(A.Hz + o + p);
    const T ru = prsgrd_component(
        HalfGRho, on_u, Hq, __ldg(A.Hz + o + qw), pk[c], pk[c - 1], r[c],
        r[c - 1], at(r, A.rho, ww_in, c - 2, qww),
        at(r, A.rho, e_in, c + 1, qe), z[c], z[c - 1],
        at(z, A.z_r, ww_in, c - 2, qww), at(z, A.z_r, e_in, c + 1, qe));
    const T rv = prsgrd_component(
        HalfGRho, om_v, Hq, __ldg(A.Hz + o + qs), pk[c], pk[c - cw], r[c],
        r[c - cw], at(r, A.rho, ss_in, c - 2 * cw, qss),
        at(r, A.rho, n_in, c + cw, qn), z[c], z[c - cw],
        at(z, A.z_r, ss_in, c - 2 * cw, qss), at(z, A.z_r, n_in, c + cw, qn));
    if (live) {
      A.ru[o + p] = ru;
      A.rv[o + p] = rv;
    }
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
  P.plan.tx = ip[8];
  P.plan.ty = ip[9];
  P.plan.threads = ip[10];
  P.plan.smem = ip[11];
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
