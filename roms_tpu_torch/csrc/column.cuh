// Per-water-column pieces shared by the 3-D column kernels (step3d.cuh,
// prsgrd.cuh): the tracer advection fluxes and the vertical solves of
// roms_tpu_torch/ops/advection.py and ops/tridiag.py.
//
// The vertical helpers take their columns as accessors, a Col over a
// block's shared memory in the kernels, so one solve serves them all.  The
// horizontal advection takes a Line, the wrapped neighbours of one column
// along xi or eta, worked out once per thread and reused at every level
// and tracer.
//
// Every expression keeps the plain version's operation order (and the
// library is built with --fmad=false), so a kernel rounds like its plain
// PyTorch version; a Python `c / x` is torch's reciprocal(x) * c.
#pragma once

#include "bc.cuh"

namespace roms {

constexpr int kMaxTr = 16;    // most tracers a tracer kernel takes

// scheme codes, as passed from Python (ops/step3d_cuda.py)
enum HScheme { H_U3 = 0, H_C4 = 1, H_C2 = 2, H_U1 = 3, H_A4 = 4 };
enum VScheme { V_C4 = 0, V_SPLINES = 1, V_C2 = 2, V_U1 = 3, V_A4 = 4 };

// the Akima select's threshold (advection._EPS)
constexpr double kAkimaEps = 1.0e-16;

__host__ __device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// The positions e = t, t + step, ... of a row-major array n wide, as
// (y, x) = (e / n, e % n), stepped without a division.
struct Walk {
  int e, y, x, dy, dx, n, step;
  __device__ Walk(int t, int step_, int n_)
      : e(t), y(t / n_), x(t % n_), dy(step_ / n_), dx(step_ % n_), n(n_),
        step(step_) {}
  __device__ void next() {
    e += step;
    y += dy;
    x += dx;
    if (x >= n) x -= n, ++y;
  }
};

// Copy one value from device memory into shared memory without passing
// through a register (cp.async): a thread issues all its copies, commits
// them as a group and waits once (copy_async_wait), so their loads are in
// flight together.  Compiled for the host, where it never runs on device
// memory, it is a plain copy.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

// Close this thread's group of copy_async copies issued since the last
// commit.
__device__ __forceinline__ void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most `pending` of this thread's committed groups are still
// in flight; a barrier after it makes the copies visible to the others.
template <int pending>
__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
#endif
}

// The barrier of one level slot's n threads (a multiple of 32) in a
// kernel whose slots walk their own levels (rhs3d.cuh, mix3d.cuh): hardware
// barrier 1 + slot, so that the slots of a block wait for none but their
// own threads.
struct SlotBarrier {
  int id, n;
  __device__ void operator()() const {
#ifdef __CUDA_ARCH__
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
#endif
  }
};

// A column of a [k][column] array: element k at p[k * s].
template <typename T>
struct Col {
  T* p;
  int s;
  __device__ __forceinline__ T& operator[](int k) const { return p[k * s]; }
};

// One grid line through a column at index a of n points along xi or eta:
// the plane offsets of its wrapped neighbours a-2, a-1, a+1, a+2 (o) and
// a-3, a+3 (far), and, two bits for each j = 0..3, which raw first
// difference the plain version's dq at b = a-1+j takes.  dq = q - im1(q),
// then extrapolated at lo and hi on a non-periodic edge (bc.extrap_*:
// dq[lo] = dq[lo+1], dq[hi] = dq[hi-1]), so dq(b) is the raw difference at
// b-1, b or b+1 (sel 0, 1, 2).
struct Line {
  int o[4];
  int far[2];
  int sel;
};

// base: offset of the line's point 0; st: its stride
__device__ __forceinline__ Line make_line(int a, int n, int base, int st,
                                          int per, int lo, int hi) {
  Line L;
  L.o[0] = base + wrap(a - 2, n) * st;
  L.o[1] = base + wrap(a - 1, n) * st;
  L.o[2] = base + wrap(a + 1, n) * st;
  L.o[3] = base + wrap(a + 2, n) * st;
  L.far[0] = base + wrap(a - 3, n) * st;
  L.far[1] = base + wrap(a + 3, n) * st;
  L.sel = 0;
  for (int j = 0; j < 4; ++j) {
    const int b = wrap(a - 1 + j, n);
    L.sel |= (extrap_src(b, per, lo, hi) - b + 1) << (2 * j);
  }
  return L;
}

// the xi line and the eta line through column (J, I)
__device__ __forceinline__ Line x_line(const Geom& g, int J, int I) {
  return make_line(I, g.Nx, J * g.Nx, 1, g.ew_per, g.H - 1, g.H + g.L + 1);
}

__device__ __forceinline__ Line y_line(const Geom& g, int J, int I) {
  return make_line(J, g.Ny, I, g.Nx, g.ns_per, g.H - 1, g.H + g.M + 1);
}

// Akima's harmonic-mean gradient of two first differences (advection
// _akima): zero unless 2 d_hi d_lo exceeds kAkimaEps.
template <typename T>
__device__ __forceinline__ T akima(T d_hi, T d_lo) {
  const T cff = T(2) * d_hi * d_lo;
  return cff > T(kAkimaEps) ? cff / (d_hi + d_lo) : T(0);
}

// Horizontal advective flux (advection.hadv_fluxes) at one face: the
// tracer on either side (qm, qa), the mass flux there, and dq at the face
// before it, at it and after it (read by U3, C4 and A4).
template <typename T>
__device__ __forceinline__ T hadv_face(int scheme, T qm, T qa, T Fa, T dq_m,
                                       T dq_a, T dq_p) {
  const T Fpos = Fa > T(0) ? Fa : T(0);
  const T Fneg = Fa < T(0) ? Fa : T(0);
  if (scheme == H_C2) return Fa * T(0.5) * (qm + qa);
  if (scheme == H_U1) return Fpos * qm + Fneg * qa;
  if (scheme == H_U3) {
    const T curv = dq_p - dq_a;
    const T curv_m = dq_a - dq_m;
    return Fa * T(0.5) * (qm + qa) -
           T(1.0 / 6.0) * (curv_m * Fpos + curv * Fneg);
  }
  const bool a4 = scheme == H_A4;
  const T grad = a4 ? akima(dq_p, dq_a) : T(0.5) * (dq_p + dq_a);
  const T grad_m = a4 ? akima(dq_a, dq_m) : T(0.5) * (dq_a + dq_m);
  return Fa * T(0.5) * (qm + qa - T(1.0 / 3.0) * (grad - grad_m));
}

// The flux difference along one line at the column (ip1(FX) - FX, or
// jp1(FE) - FE): q is the tracer's level plane, v its values at the
// column's neighbours a-2, a-1, a+1, a+2 (Line order), qc at the column,
// Fw and Fe the mass flux at the column's own face and the next.
template <typename T>
__device__ __forceinline__ T line_div(const T* __restrict__ q, const Line& L,
                                      const T (&v)[4], T qc, T Fw, T Fe,
                                      int scheme) {
  // raw first differences at a-2 .. a+3 (r[0] and r[5] only where an edge
  // extrapolation reaches them)
  T r[6];
  r[0] = T(0);
  r[1] = v[1] - v[0];
  r[2] = qc - v[1];
  r[3] = v[2] - qc;
  r[4] = v[3] - v[2];
  r[5] = T(0);
  if ((L.sel & 3) == 0) r[0] = v[0] - __ldg(q + L.far[0]);
  if (((L.sel >> 6) & 3) == 2) r[5] = __ldg(q + L.far[1]) - v[3];
  T dq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = (L.sel >> (2 * j)) & 3;
    dq[j] = s == 0 ? r[j] : (s == 2 ? r[j + 2] : r[j + 1]);
  }
  const T west = hadv_face(scheme, v[1], qc, Fw, dq[0], dq[1], dq[2]);
  const T east = hadv_face(scheme, qc, v[2], Fe, dq[1], dq[2], dq[3]);
  return east - west;
}

// Vertical advective flux (advection.vadv_flux) at interface k, 0 <= k <=
// N, of a scheme that is pointwise in k (all but SPLINES): zero at the
// bottom and the surface.  C4 has reduced-order end interfaces; A4 pads
// its first differences d(k) = q[k] - q[k-1] with d(0) = d(1) and d(N) =
// d(N-1).  q is the tracer column and W the vertical velocity's.
template <typename T, class Q, class V>
__device__ __forceinline__ T vadv_flux(int scheme, Q q, V W, int N, int k) {
  if (k == 0 || k == N) return T(0);
  const T Wk = W[k];
  if (scheme == V_C2) return Wk * T(0.5) * (q[k - 1] + q[k]);
  if (scheme == V_U1) {
    const T Wpos = Wk > T(0) ? Wk : T(0);
    const T Wneg = Wk < T(0) ? Wk : T(0);
    return Wpos * q[k - 1] + Wneg * q[k];
  }
  if (scheme == V_A4) {
    auto d = [&](int j) {
      const int i = clampi(j, 1, N - 1);
      return q[i] - q[i - 1];
    };
    const T dm = d(k - 1), da = d(k), dp = d(k + 1);
    return Wk * T(0.5) *
           (q[k - 1] + q[k] - T(1.0 / 3.0) * (akima(dp, da) - akima(da, dm)));
  }
  const T c1 = T(0.5), c2 = T(7.0 / 12.0), c3 = T(1.0 / 12.0);
  if (k == 1) return Wk * (c1 * q[0] + c2 * q[1] - c3 * q[2]);
  if (k == N - 1)
    return Wk * (c1 * q[N - 1] + c2 * q[N - 2] - c3 * q[N - 3]);
  return Wk * (c2 * (q[k - 1] + q[k]) - c3 * (q[k - 2] + q[k + 1]));
}

// Vertical SPLINES advective flux at interfaces 0..N into FC
// (tridiag.spline_interp_flux, FC[0] = FC[N] = 0) with end conditions
// (c_bot, cf1, c_top, d_top); CFs: N scratch.
template <typename T, class Q, class A>
__device__ void spline_interp_flux(Q q, Q Hz, Q W, int N, double c_bot,
                                   double cf1, double c_top, double d_top,
                                   A FC, A CFs) {
  FC[0] = T(0);
  FC[N] = T(0);
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
// interface flux AK * dq/dz into flux[0..N], flux[0] = flux[N] = 0.  Each
// step reads the next step's operands before it stores, so that the loads
// stay off the recurrence.
template <typename T, class C, class A>
__device__ void spline_vdiff_flux(T dt, C Hz, C oHz, C AK, C q, int N,
                                  A flux, A CFs) {
  const T sixth = T(1.0 / 6.0);
  const T third = T(1.0 / 3.0);
  T CFp = T(0);
  T DCp = T(0);
  T Hz0 = Hz[0], Hz1 = Hz[1], oHz0 = oHz[0], oHz1 = oHz[1];
  T AK0 = AK[0], AK1 = AK[1], AK2 = AK[2], q0 = q[0], q1 = q[1];
  for (int k = 0; k < N - 1; ++k) {
    const bool more = k + 2 < N;
    const T Hz2 = more ? Hz[k + 2] : T(0);
    const T oHz2 = more ? oHz[k + 2] : T(0);
    const T AK3 = more ? AK[k + 3] : T(0);
    const T q2 = more ? q[k + 2] : T(0);
    const T FC = sixth * Hz0 - dt * AK0 * oHz0;
    const T CF = sixth * Hz1 - dt * AK2 * oHz1;
    const T BC = third * (Hz0 + Hz1) + dt * AK1 * (oHz0 + oHz1);
    const T cff = T(1) / (BC - FC * CFp);
    CFp = cff * CF;
    DCp = cff * ((q1 - q0) - FC * DCp);
    CFs[k] = CFp;
    flux[k + 1] = DCp;
    Hz0 = Hz1, Hz1 = Hz2, oHz0 = oHz1, oHz1 = oHz2;
    AK0 = AK1, AK1 = AK2, AK2 = AK3, q0 = q1, q1 = q2;
  }
  T Dnext = T(0);
  if (N >= 2) {
    T f = flux[N - 1], cf = CFs[N - 2], ak = AK[N - 1];
    for (int k = N - 2; k >= 0; --k) {
      const T f_next = k > 0 ? flux[k] : T(0);
      const T cf_next = k > 0 ? CFs[k - 1] : T(0);
      const T ak_next = k > 0 ? AK[k] : T(0);
      Dnext = f - cf * Dnext;
      flux[k + 1] = ak * Dnext;
      f = f_next, cf = cf_next, ak = ak_next;
    }
  }
  flux[0] = T(0);
  flux[N] = T(0);
}

// Standard implicit vertical diffusion (tridiag.thomas_implicit with
// lambda = 1): q holds the mass-weighted right-hand side on entry and the
// solution on exit.  FC: N+1 scratch, CFs: N scratch.
template <typename T, class A>
__device__ void thomas_implicit(double dt, A Hz, A z_r, A AK, A q, int N,
                                A FC, A CFs) {
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
