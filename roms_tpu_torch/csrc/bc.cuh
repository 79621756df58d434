// Index maps shared by the kernels: the halo fill, the lateral boundary
// writes and the one-sided edge extrapolations of roms_tpu_torch/ops/bc.py,
// expressed as "which padded point does this output point copy from".
//
// A kernel computes a value at EVERY padded point, as the plain version
// does with torch.roll: neighbours wrap modulo the padded extent (wrap), and
// a field whose halo the plain version refreshes is written by gathering
// through these maps, so that kernel and plain version agree over the whole
// padded array, halo included.
#pragma once

namespace roms {

// lateral BC kinds, as passed from Python (ops/bc.py accepts only these)
enum BcKind { BC_PER = 0, BC_CLO = 1, BC_GRA = 2 };

struct Geom {
  int Ny, Nx;       // padded extents
  int H, L, M;      // halo width, interior Lm, interior Mm
  int ew_per, ns_per;
};

__host__ __device__ __forceinline__ int wrap(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// fill_halo along one axis: source index of padded index a.
// Periodic: period n_int (Lm or Mm), not the padded extent.
// Closed: replicate the boundary ring at H-1 and H+n_int.
__device__ __forceinline__ int fill_src(int a, int H, int n_int, int per) {
  if (per) {
    if (a < H) return a + n_int;
    if (a >= H + n_int) return a - n_int;
    return a;
  }
  if (a < H - 1) return H - 1;
  if (a > H + n_int) return H + n_int;
  return a;
}

__device__ __forceinline__ bool grad_like(int kind) {
  return kind == BC_CLO || kind == BC_GRA;
}

// apply_bc_rho along one axis (before the fill): the boundary ring takes
// the first interior value on closed and gradient sides.
__device__ __forceinline__ int rho_bc_src(int a, int H, int n_int, int per,
                                          int lo, int hi) {
  if (per) return a;
  if (a == H - 1 && grad_like(lo)) return H;
  if (a == H + n_int && grad_like(hi)) return H + n_int - 1;
  return a;
}

// bc.extrap_west/east (or south/north) at array indices a_lo/a_hi, applied
// when a gradient array is read: g[a_lo] = g[a_lo+1], g[a_hi] = g[a_hi-1].
__device__ __forceinline__ int extrap_src(int a, int per, int a_lo,
                                          int a_hi) {
  if (per) return a;
  if (a == a_lo) return a_lo + 1;
  if (a == a_hi) return a_hi - 1;
  return a;
}

// Value of fill_halo(mask * apply_bc_rho(f)) at padded point (j, i).
// bz = {west, south, east, north} kinds.
template <typename T>
__device__ __forceinline__ T rho_bc_fill(const Geom& g, const int* bz,
                                         const T* f, const T* mask, int j,
                                         int i) {
  const int J = fill_src(j, g.H, g.M, g.ns_per);
  const int I = fill_src(i, g.H, g.L, g.ew_per);
  const int Js = rho_bc_src(J, g.H, g.M, g.ns_per, bz[1], bz[3]);
  const int Is = rho_bc_src(I, g.H, g.L, g.ew_per, bz[0], bz[2]);
  const T v = f[Js * g.Nx + Is];
  return mask ? mask[J * g.Nx + I] * v : v;
}

// fill_halo(f) at padded point (j, i)
template <typename T>
__device__ __forceinline__ T fill(const Geom& g, const T* f, int j, int i) {
  return f[fill_src(j, g.H, g.M, g.ns_per) * g.Nx +
           fill_src(i, g.H, g.L, g.ew_per)];
}

// apply_bc_u before mask and fill: the E-W writes (normal direction,
// including the pinned ghost column H-1) come first, then the N-S rows
// (tangential, gamma2 slip) copy rows that already carry them.
template <typename T>
__device__ __forceinline__ T bc_u_ew(const Geom& g, const int* b, const T* f,
                                     int J, int I) {
  const int r = J * g.Nx;
  if (!g.ew_per) {
    if (I == g.H || I == g.H - 1) {
      if (b[0] == BC_CLO) return T(0);
      if (b[0] == BC_GRA) return f[r + g.H + 1];
      return f[r + g.H];
    }
    if (I == g.H + g.L) {
      if (b[2] == BC_CLO) return T(0);
      if (b[2] == BC_GRA) return f[r + g.H + g.L - 1];
    }
  }
  return f[r + I];
}

template <typename T>
__device__ __forceinline__ T bc_u_val(const Geom& g, const int* b, T gamma2,
                                      const T* f, int J, int I) {
  if (!g.ns_per) {
    if (J == g.H - 1) {
      if (b[1] == BC_CLO) return gamma2 * bc_u_ew(g, b, f, g.H, I);
      if (b[1] == BC_GRA) return bc_u_ew(g, b, f, g.H, I);
    } else if (J == g.H + g.M) {
      if (b[3] == BC_CLO) return gamma2 * bc_u_ew(g, b, f, g.H + g.M - 1, I);
      if (b[3] == BC_GRA) return bc_u_ew(g, b, f, g.H + g.M - 1, I);
    }
  }
  return bc_u_ew(g, b, f, J, I);
}

// apply_bc_v before mask and fill: N-S (normal) rows first, then the E-W
// (tangential) columns.
template <typename T>
__device__ __forceinline__ T bc_v_ns(const Geom& g, const int* b, const T* f,
                                     int J, int I) {
  if (!g.ns_per) {
    if (J == g.H || J == g.H - 1) {
      if (b[1] == BC_CLO) return T(0);
      if (b[1] == BC_GRA) return f[(g.H + 1) * g.Nx + I];
      return f[g.H * g.Nx + I];
    }
    if (J == g.H + g.M) {
      if (b[3] == BC_CLO) return T(0);
      if (b[3] == BC_GRA) return f[(g.H + g.M - 1) * g.Nx + I];
    }
  }
  return f[J * g.Nx + I];
}

template <typename T>
__device__ __forceinline__ T bc_v_val(const Geom& g, const int* b, T gamma2,
                                      const T* f, int J, int I) {
  if (!g.ew_per) {
    if (I == g.H - 1) {
      if (b[0] == BC_CLO) return gamma2 * bc_v_ns(g, b, f, J, g.H);
      if (b[0] == BC_GRA) return bc_v_ns(g, b, f, J, g.H);
    } else if (I == g.H + g.L) {
      if (b[2] == BC_CLO) return gamma2 * bc_v_ns(g, b, f, J, g.H + g.L - 1);
      if (b[2] == BC_GRA) return bc_v_ns(g, b, f, J, g.H + g.L - 1);
    }
  }
  return bc_v_ns(g, b, f, J, I);
}

// fill_halo(mask * apply_bc_u(f)) and fill_halo(mask * apply_bc_v(f))
template <typename T>
__device__ __forceinline__ T u_bc_fill(const Geom& g, const int* b, T gamma2,
                                       const T* f, const T* mask, int j,
                                       int i) {
  const int J = fill_src(j, g.H, g.M, g.ns_per);
  const int I = fill_src(i, g.H, g.L, g.ew_per);
  return mask[J * g.Nx + I] * bc_u_val(g, b, gamma2, f, J, I);
}

template <typename T>
__device__ __forceinline__ T v_bc_fill(const Geom& g, const int* b, T gamma2,
                                       const T* f, const T* mask, int j,
                                       int i) {
  const int J = fill_src(j, g.H, g.M, g.ns_per);
  const int I = fill_src(i, g.H, g.L, g.ew_per);
  return mask[J * g.Nx + I] * bc_v_val(g, b, gamma2, f, J, I);
}

}  // namespace roms
