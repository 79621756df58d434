// Slow momentum right-hand side, rhs3d.F (with the pre_step3d momentum
// start, pre_step3d.F:659-700), for one 2-D tile of padded points and both
// directions per block:
//
//   start (optional) - u_nnew/v_nnew: the AB3 history terms and the
//                      surface - bottom stress fluxes (pre_step3d.py
//                      momentum_init);
//   terms            - Coriolis, curvilinear metric terms, U3 horizontal
//                      and C4 vertical advection added to the pressure
//                      gradient ru/rv;
//   column sum       - the barotropic forcing rufrc = sum_k ru + (surface
//                      - bottom stress) om on.
//
// Replaces the TPU kernel roms_tpu/ops/rhs3d_pallas.py::rhs3d_fused (two
// pallas_calls a direction, split for the TPU's VMEM) and the XLA
// momentum_init that momentum_rhs_fused runs before it.
// Bound on the H100: bandwidth.  It must read u, v, Huon, Hvom, Hz, W, ru,
// rv and, with the start, the four AB3 history planes (13 (N,Ny,Nx)
// planes), and write ru, rv, u_nnew and v_nnew: ~71 MB at BENCHMARK1 in
// float32, 0.021 ms at 3.35 TB/s, for ~300 operations a (k,j,i) point.
// What keeps it from that is the latency of each level's loads and of the
// barriers between a level's steps.
// Design: block (bx, by) owns a tile of tx x ty points (the plan,
// ops/rhs3d_cuda.rhs3d_plan) and both directions; its threads are ks level
// slots of one thread a point.  Slot s walks its own run of consecutive
// levels, independently of the other slots (its barriers are its own), so
// that while one slot waits for its loads another computes.  At each level
// a slot
//   (a) copies u, v, Huon, Hvom, Hz and W (at the top interface) of the
//       NEXT level over the tile's region (the tile and 3 points around
//       it, wrapped) into its second set of shared planes (cp.async: no
//       registers, all in flight while this level computes), once for both
//       directions, and loads its point's inputs for this level;
//   (b) computes each face value once into shared memory: the U3 fluxes
//       UFx and VFe at rho points, UFe and VFx at psi points, and the
//       Coriolis and curvilinear terms X(q) at rho points, which the plain
//       version forms at every point and shifts (each u point differences
//       two of them, as does each v point);
//   (c) differences them at its point into ru and rv, adds the C4 vertical
//       flux difference (the flux at the level's top from a rolling window
//       of the point's velocities, the one at its bottom carried from the
//       level below) and computes the start's u_nnew and v_nnew.
// After the last level, one thread a point adds its ru column (another its
// rv column) in k order, reading back what the block wrote.  The one-sided
// edge extrapolations of U3 (bc.extrap_*) are index shifts of the second
// differences' centres, tabled once a block (bc.cuh extrap_src); they move
// a centre by one point at most, so a face reads its region only.
// Neighbours wrap modulo the padded extent, as torch.roll does, so every
// padded point is computed, halo included.  Every value keeps the plain
// version's expression and operation order, so ru, rv, u_nnew and v_nnew
// are the plain version's bitwise; the column sum runs in k order, which
// torch.sum on the card does not, so rufrc/rvfrc differ from it by
// round-off.
#pragma once

#include "column.cuh"

namespace roms {

// The launch, chosen by ops/rhs3d_cuda.rhs3d_plan: points of a tile along xi
// and eta, level slots, threads a block (tx * ty * ks) and the dynamic
// shared memory, which the entry point checks against rhs3d_smem.
struct RhsPlan {
  int tx, ty, ks, threads, smem;
};

struct RhsParams {
  Geom g;
  int N;
  int cor;     // cfg.uv_cor
  int adv;     // cfg.uv_adv
  int curv;    // cfg.curvgrid (with uv_adv)
  int start;   // compute momentum_init's u_nnew/v_nnew too
  RhsPlan plan;
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

// The shared arrays of a tile: the region, tx+6 x ty+6 points from (j0-3,
// i0-3), and the face rectangles, tx+1 x ty+1 points: rho points from
// (j0-1, i0-1), psi points from (j0, i0).
struct RhsLayout {
  int rx, ry, ra, fw, fa, npts;
  __host__ __device__ constexpr RhsLayout(int tx, int ty)
      : rx(tx + 6), ry(ty + 6), ra((tx + 6) * (ty + 6)), fw(tx + 1),
        fa((tx + 1) * (ty + 1)), npts(tx * ty) {}
  // words of T: a slot's two sets of 6 planes and its 8 face arrays; fomn,
  // dndx and dmde; the start's DC0 of each point and direction
  __host__ __device__ constexpr int words(int ks) const {
    return ks * (12 * ra + 8 * fa) + 3 * fa + 2 * npts;
  }
  // ints: the region's padded offsets and the faces' edge shifts
  __host__ __device__ constexpr int ints() const { return ra + fa; }
};

__host__ __device__ constexpr int rhs3d_smem(int tx, int ty, int ks,
                                             int word) {
  return RhsLayout(tx, ty).words(ks) * word + RhsLayout(tx, ty).ints() * 4;
}

constexpr double kGadv = -0.25;   // rhs3d.py GADV

// Second difference of plane f at q along step st (1: xi, rx: eta):
// (f[-1] - 2 f) + f[+1] (rhs3d.py uxx, Huxx, uee and their v counterparts).
template <typename T>
__device__ __forceinline__ T dd(const T* f, int q, int st) {
  return f[q - st] - T(2) * f[q] + f[q + st];
}

// U3 flux of a velocity along its own direction (step st) at the rho point
// between vel[q] and vel[q + st], carried by its own mass flux Fa: UFx for
// u, VFe for v.  sh0, sh1: the edge shifts of the centres q and q + st.
template <typename T>
__device__ __forceinline__ T u3_along(const T* vel, const T* Fa, int q,
                                      int st, int sh0, int sh1) {
  const int c0 = q + sh0 * st, c1 = q + st + sh1 * st;
  const T cff1 = vel[q] + vel[q + st];
  const T cup = dd(vel, cff1 > T(0) ? c0 : c1, st);
  return T(0.25) * (cff1 + T(kGadv) * cup) *
         (Fa[q] + Fa[q + st] +
          T(kGadv * 0.5) * (dd(Fa, c0, st) + dd(Fa, c1, st)));
}

// U3 flux of a velocity across (step sc) at the psi point between vel[q -
// sc] and vel[q], carried by the other direction's mass flux Fc, whose
// second differences run along (step sa): UFe for u, VFx for v.  sh0, sh1:
// the edge shifts of the centres q - sc and q.
template <typename T>
__device__ __forceinline__ T u3_across(const T* vel, const T* Fc, int q,
                                       int sa, int sc, int sh0, int sh1) {
  const T cff1 = vel[q] + vel[q - sc];
  const T cff2 = Fc[q] + Fc[q - sa];
  const T cup = dd(vel, cff2 > T(0) ? q - sc + sh0 * sc : q + sh1 * sc, sc);
  return T(0.25) * (cff1 + T(kGadv) * cup) *
         (cff2 + T(kGadv * 0.5) * (dd(Fc, q, sa) + dd(Fc, q - sa, sa)));
}

// C4 vertical flux of a velocity at interface K (1 <= K <= N-1) of a
// column, from its values x0..x3 at levels K-2 .. K+1 (those beyond the
// column unused) and W averaged to the velocity point, WK (rhs3d.py FCu /
// FCv): one-sided at the bottom and top interfaces.
template <typename T>
__device__ __forceinline__ T c4_vflux(T x0, T x1, T x2, T x3, T WK, int K,
                                      int N) {
  const T c1 = T(9.0 / 16.0);
  const T c2 = T(1.0 / 16.0);
  if (K == 1) return (c1 * (x1 + x2) - c2 * (x1 + x3)) * WK;
  if (K == N - 1) return (c1 * (x1 + x2) - c2 * (x0 + x2)) * WK;
  return (c1 * (x1 + x2) - c2 * (x0 + x3)) * WK;
}

// W at an interface averaged to a velocity point q from its neighbours
// along (step st): q-2, q-1, q, q+1 (rhs3d.py Wu / Wv)
template <typename T>
__device__ __forceinline__ T w_at(const T* w, int q, int st) {
  return T(9.0 / 16.0) * (w[q] + w[q - st]) -
         T(1.0 / 16.0) * (w[q + st] + w[q - 2 * st]);
}

// The edge shift (-1, 0, 1) of field f of a face's packed shifts (2 bits a
// field): 0/1 the centres q, q+1 of UFx; 2/3 those of VFe; 4/5 the centres
// q-rx, q of UFe; 6/7 the centres q-1, q of VFx.
__device__ __forceinline__ int edge_shift(int bits, int f) {
  return ((bits >> (2 * f)) & 3) - 1;
}

// The tile (bx, by) of block tid's thread; sm: rhs3d_smem bytes.
// slot_sync() is the barrier of the thread's level slot (the tile's
// points); every thread reaches every barrier of its slot, and every
// __syncthreads().
template <typename T, class Sync>
__device__ void rhs3d_tile(const RhsParams& P, const RhsPtrs<T>& A,
                           unsigned char* sm, int bx, int by, int tid,
                           Sync slot_sync) {
  const Geom& g = P.g;
  const int S = g.Ny * g.Nx;
  const int N = P.N;
  const int tx = P.plan.tx, ty = P.plan.ty, ks = P.plan.ks;
  const RhsLayout L(tx, ty);
  const int npts = L.npts, nth = ks * npts;
  const int rx = L.rx, ra = L.ra, fw = L.fw, fa = L.fa;
  const int i0 = bx * tx, j0 = by * ty;
  const int slot = tid / npts, pt = tid - slot * npts;

  // shared arrays: this slot's two sets of planes u v Huon Hvom Hz W (W at
  // the level's top interface) over the region and its face arrays; fomn,
  // dndx, dmde on the rho rectangle; DC0; the region's padded offsets; the
  // faces' edge shifts
  T* base = reinterpret_cast<T*>(sm);
  T* planes = base + slot * 12 * ra;
  T* fc = base + ks * 12 * ra + slot * 8 * fa;
  T* rect = base + ks * (12 * ra + 8 * fa);
  T* DC0 = rect + 3 * fa;
  int* off = reinterpret_cast<int*>(DC0 + 2 * npts);
  int* shf = off + ra;
  T *Xcu = fc, *Xcv = fc + fa, *Xku = fc + 2 * fa, *Xkv = fc + 3 * fa,
    *UFx = fc + 4 * fa, *VFe = fc + 5 * fa, *UFe = fc + 6 * fa,
    *VFx = fc + 7 * fa;

  for (int e = tid; e < ra; e += nth) {
    const int r = e / rx;
    off[e] = wrap(j0 - 3 + r, g.Ny) * g.Nx + wrap(i0 - 3 + e - r * rx, g.Nx);
  }
  for (Walk w(tid, nth, fw); w.e < fa; w.next()) {
    // rho point (j0-1+y, i0-1+x), region (y+2, x+2)
    const int q = wrap(j0 - 1 + w.y, g.Ny) * g.Nx + wrap(i0 - 1 + w.x, g.Nx);
    if (P.cor) rect[w.e] = A.f[q] / (A.pm[q] * A.pn[q]);
    if (P.curv) {
      rect[fa + w.e] = A.dndx[q];
      rect[2 * fa + w.e] = A.dmde[q];
    }
    // bc.extrap_* of u along xi (H, H+L), v along eta (H, H+M), u across
    // eta (H-1, H+M), v across xi (H-1, H+L), at region columns c and rows
    // r: field 2f + h is the shift at the centre's column or row + h
    auto xs = [&](int c, int lo, int hi) {
      const int I = wrap(i0 - 3 + c, g.Nx);
      return extrap_src(I, g.ew_per, lo, hi) - I;
    };
    auto ys = [&](int r, int lo, int hi) {
      const int J = wrap(j0 - 3 + r, g.Ny);
      return extrap_src(J, g.ns_per, lo, hi) - J;
    };
    const int c = w.x + 2, r = w.y + 2;
    const int sh[8] = {xs(c, g.H, g.H + g.L), xs(c + 1, g.H, g.H + g.L),
                       ys(r, g.H, g.H + g.M), ys(r + 1, g.H, g.H + g.M),
                       ys(r, g.H - 1, g.H + g.M), ys(r + 1, g.H - 1, g.H + g.M),
                       xs(c, g.H - 1, g.H + g.L), xs(c + 1, g.H - 1, g.H + g.L)};
    int bits = 0;
    for (int f = 0; f < 8; ++f) bits |= (sh[f] + 1) << (2 * f);
    shf[w.e] = bits;
  }

  // this thread's point: its region index, rho and psi rectangle places,
  // padded offset, and the start's metric factor DC0 = dt/4 (pm + pm[qm])
  // (pn + pn[qm]) at it (qm: i-1 for u, j-1 for v)
  const int ly = pt / tx, lx = pt - ly * tx;
  const int j = j0 + ly, i = i0 + lx;
  const bool live = j < g.Ny && i < g.Nx;   // the tile's ragged edge
  const int jr = wrap(j, g.Ny) * g.Nx, ir = wrap(i, g.Nx);
  const int p = jr + ir;
  auto qm = [&](int d) {
    return d == 0 ? jr + wrap(i - 1, g.Nx) : wrap(j - 1, g.Ny) * g.Nx + ir;
  };
  if (slot == 0)
#pragma unroll
    for (int d = 0; d < 2; ++d)
      DC0[d * npts + pt] = T(P.dt * 0.25) * (A.pm[p] + A.pm[qm(d)]) *
                           (A.pn[p] + A.pn[qm(d)]);
  __syncthreads();
  const int cp = (ly + 3) * rx + lx + 3;
  const int fr = (ly + 1) * fw + lx + 1;
  const int fp = ly * fw + lx;
  const int st[2] = {1, rx};       // along u (xi) and v (eta)

  // the slot's levels k0 .. k1 - 1; every slot makes nlev rounds
  const int nlev = (N + ks - 1) / ks;
  const int k0 = slot * nlev, k1 = min(N, k0 + nlev);
  // level k's planes and the W plane above it into dst
  auto copy_planes = [&](int k, T* dst) {
    const int o = k * S;
    for (int e = pt; e < ra; e += npts) {
      const int q = o + off[e];
      copy_async(dst + e, A.vel[0] + q);
      copy_async(dst + ra + e, A.vel[1] + q);
      copy_async(dst + 2 * ra + e, A.Fl[0] + q);
      copy_async(dst + 3 * ra + e, A.Fl[1] + q);
      copy_async(dst + 4 * ra + e, A.Hz + q);
      copy_async(dst + 5 * ra + e, A.W + S + q);
    }
  };
  // the point's velocities at levels k-1, k, k+1 (clamped to the column)
  // and the vertical flux at the bottom of level k
  auto vel_at = [&](int d, int m) {
    return __ldg(A.vel[d] + clampi(m, 0, N - 1) * S + p);
  };
  T x[2][3], FCb[2];
  if (k0 < k1) copy_planes(k0, planes);
  copy_async_commit();
#pragma unroll
  for (int d = 0; d < 2; ++d) {
#pragma unroll
    for (int m = 0; m < 3; ++m) x[d][m] = vel_at(d, k0 - 1 + m);
    FCb[d] = T(0);
    if (P.adv && k0 >= 1 && k0 < k1) {
      // W at interface k0, from device memory: the planes hold the tops
      const T* w = A.W + k0 * S;
      const int a = d == 0 ? i : j, n = d == 0 ? g.Nx : g.Ny;
      auto at = [&](int da) {
        const int b = wrap(a + da, n);
        return __ldg(w + (d == 0 ? jr + b : b * g.Nx + ir));
      };
      const T WK = T(9.0 / 16.0) * (at(0) + at(-1)) -
                   T(1.0 / 16.0) * (at(1) + at(-2));
      FCb[d] = c4_vflux(vel_at(d, k0 - 2), x[d][0], x[d][1], x[d][2], WK,
                        k0, N);
    }
  }

  for (int n = 0; n < nlev; ++n) {
    const int k = k0 + n;
    const bool lev = k < k1;
    const int o = k * S;
    const T* pl = planes + (n & 1) * 6 * ra;
    const T *U = pl, *V = pl + ra, *HU = pl + 2 * ra, *HV = pl + 3 * ra,
            *HZ = pl + 4 * ra, *Wt = pl + 5 * ra;
    // (a) the next level's planes, in flight through this one; this
    // level's point inputs
    if (k + 1 < k1) copy_planes(k + 1, planes + ((n + 1) & 1) * 6 * ra);
    copy_async_commit();
    T rin[2], prev[2], prev2[2], x3[2];
    if (lev) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        rin[d] = __ldg(A.r_in[d] + o + p);
        if (P.start) {
          prev[d] = __ldg(A.r_prev[d] + o + p);
          prev2[d] = __ldg(A.r_prev2[d] + o + p);
        }
        x3[d] = vel_at(d, k + 2);
      }
    }
    copy_async_wait<1>();     // this level's planes
    slot_sync();
    // (b) the face values of this level
    if (lev) {
      for (Walk w(pt, npts, fw); w.e < fa; w.next()) {
        // rho point (j0-1+y, i0-1+x)
        const int q = (w.y + 2) * rx + w.x + 2;
        if (P.cor || P.curv) {
          const T vs = V[q] + V[q + rx];   // v + v[j+1]
          const T us = U[q] + U[q + 1];    // u + u[i+1]
          if (P.cor) {
            const T cor = T(0.5) * HZ[q] * rect[w.e];
            Xcu[w.e] = cor * vs;
            Xcv[w.e] = cor * us;
          }
          if (P.curv) {
            const T cff = T(0.5) * vs * rect[fa + w.e] -
                          T(0.5) * us * rect[2 * fa + w.e];
            Xku[w.e] = HZ[q] * cff * T(0.5) * vs;
            Xkv[w.e] = HZ[q] * cff * T(0.5) * us;
          }
        }
        if (P.adv) {
          const int b = shf[w.e];
          UFx[w.e] = u3_along(U, HU, q, 1, edge_shift(b, 0),
                              edge_shift(b, 1));
          VFe[w.e] = u3_along(V, HV, q, rx, edge_shift(b, 2),
                              edge_shift(b, 3));
          // psi point (j0+y, i0+x)
          const int s = q + rx + 1;
          UFe[w.e] = u3_across(U, HV, s, 1, rx, edge_shift(b, 4),
                               edge_shift(b, 5));
          VFx[w.e] = u3_across(V, HU, s, rx, 1, edge_shift(b, 6),
                               edge_shift(b, 7));
        }
      }
    }
    slot_sync();
    // (c) this level at the point
    if (lev) {
      T r[2] = {rin[0], rin[1]};
      if (P.cor) {
        r[0] = r[0] + T(0.5) * (Xcu[fr] + Xcu[fr - 1]);
        r[1] = r[1] + T(-0.5) * (Xcv[fr] + Xcv[fr - fw]);
      }
      if (P.curv) {
        r[0] = r[0] + T(0.5) * (Xku[fr] + Xku[fr - 1]);
        r[1] = r[1] + T(-0.5) * (Xkv[fr] + Xkv[fr - fw]);
      }
      if (P.adv) {
        // rhs3d.py adds the xi term first: along for u, across for v
        const T along_u = -(UFx[fr] - UFx[fr - 1]);
        const T across_u = -(UFe[fp + fw] - UFe[fp]);
        r[0] = r[0] + along_u + across_u;
        const T along_v = -(VFe[fr] - VFe[fr - fw]);
        const T across_v = -(VFx[fp + 1] - VFx[fp]);
        r[1] = r[1] + across_v + along_v;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const T FCt =
              k + 1 < N ? c4_vflux(x[d][0], x[d][1], x[d][2], x3[d],
                                   w_at(Wt, cp, st[d]), k + 1, N)
                        : T(0);
          r[d] = r[d] + -(FCt - FCb[d]);
          FCb[d] = FCt;
          x[d][0] = x[d][1];
          x[d][1] = x[d][2];
          x[d][2] = x3[d];
        }
      }
      if (live) {
        A.r[0][o + p] = r[0];
        A.r[1][o + p] = r[1];
      }
      if (P.start) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const T fc_lo = k == 0 ? T(P.dt) * A.bstr[d][p] : T(0);
          const T fc_hi = k == N - 1 ? T(P.dt) * A.sstr[d][p] : T(0);
          const T vn = pl[d * ra + cp] * T(0.5) * (HZ[cp] + HZ[cp - st[d]]) +
                       DC0[d * npts + pt] *
                           (T(P.a1) * prev2[d] + T(P.a2) * prev[d]) +
                       (fc_hi - fc_lo);
          if (live) A.vel_nnew[d][o + p] = vn;
        }
      }
    }
    slot_sync();
  }

  // rufrc = sum_k ru + (sustr - bustr) om_u on_u, om_u = 2/(pm[i-1] + pm),
  // the sum in k order from what the block's slots wrote
  __syncthreads();
#pragma unroll
  for (int d = 0; d < 2; ++d)
    if (slot == (d < ks ? d : 0) && live) {
      T sum = T(0);
      for (int k = 0; k < N; ++k) sum = sum + A.r[d][k * S + p];
      const int m = qm(d);
      const T om = T(1) / (A.pm[m] + A.pm[p]) * T(2);
      const T on = T(1) / (A.pn[m] + A.pn[p]) * T(2);
      A.rfrc[d][p] = sum + (A.sstr[d][p] - A.bstr[d][p]) * om * on;
    }
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
  P.plan.tx = ip[n++];
  P.plan.ty = ip[n++];
  P.plan.ks = ip[n++];
  P.plan.threads = ip[n++];
  P.plan.smem = ip[n++];
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
