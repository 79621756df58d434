// C entry points of the diagnostic kernels (diag.cuh), loaded with ctypes by
// roms_tpu_torch/ops/diag_cuda.py.  Each launches on the given stream,
// does not synchronize, and returns a CUDA error code (cudaGetLastError()
// after the launch, or the refusal of a plan that does not match its
// kernel).
//
// Arguments: dtype flag (1 = float64, 0 = float32), a host array of device
// pointers, a host array of ints and one of doubles; their order is fixed
// by the Python wrapper.
#include <cuda_runtime.h>

#include "diag.cuh"

namespace {

constexpr int kThreads = 256;   // threads a block, every kernel

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// VT: the Vtransform, 1 or 2
template <typename T, int VT>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    grid_flux_kernel(const __grid_constant__ roms::DiagParams P,
                     const __grid_constant__ roms::FluxPtrs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  roms::grid_flux_tile<T, VT>(P, A, reinterpret_cast<T*>(smem), blockIdx.x,
                              blockIdx.y, threadIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    eos_bvf_kernel(const __grid_constant__ roms::EosParams e,
                   const T* __restrict__ t, const T* __restrict__ z_r,
                   const T* __restrict__ z_w, T* __restrict__ rho,
                   T* __restrict__ pden, T* __restrict__ bvf) {
  extern __shared__ __align__(16) unsigned char smem[];
  roms::eos_bvf_tile(e, t, z_r, z_w, rho, pden, bvf,
                     reinterpret_cast<T*>(smem), blockIdx.x, threadIdx.x);
}

// Let kernel take smem bytes of dynamic shared memory; a CUDA error code.
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// A tile of npts points with a thread per (level slot, point): the block's
// threads a multiple of it and of a warp.
inline bool slots_fit(int npts, int threads) {
  return npts >= 1 && threads <= kThreads && threads % 32 == 0 &&
         threads % npts == 0;
}

template <typename T, int VT>
int grid_flux(void* const* ptr, const roms::DiagParams& P, cudaStream_t s) {
  const roms::FluxPlan& L = P.plan;
  if (L.tx < 1 || L.ty < 1 || !slots_fit(L.tx * L.ty, L.threads) ||
      L.smem != roms::flux_words(P.N, L.tx, L.ty) *
                    static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(grid_flux_kernel<T, VT>, L.smem);
  if (err != 0) return err;
  const dim3 grid((P.g.Nx + L.tx - 1) / L.tx, (P.g.Ny + L.ty - 1) / L.ty);
  grid_flux_kernel<T, VT><<<grid, L.threads, L.smem, s>>>(
      P, roms::flux_ptrs<T>(ptr));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grid_flux(void* const* ptr, const roms::DiagParams& P, cudaStream_t s) {
  if (P.vtransform == 2) return grid_flux<T, 2>(ptr, P, s);
  if (P.vtransform == 1) return grid_flux<T, 1>(ptr, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int omega(void* const* ptr, const roms::DiagParams& prm, cudaStream_t s) {
  roms::omega_kernel<T><<<blocks_for(prm.g.Ny * prm.g.Nx), kThreads, 0, s>>>(
      static_cast<const T*>(ptr[0]), static_cast<const T*>(ptr[1]),
      static_cast<const T*>(ptr[2]), static_cast<T*>(ptr[3]), prm);
  return static_cast<int>(cudaGetLastError());
}

// tile 0: eos_kernel, a thread a point of the w grid (the linear EOS, and
// JM95 without bvf); else eos_bvf_kernel (JM95 with bvf) on runs of tile
// points
template <typename T>
int eos(void* const* ptr, const roms::EosParams& e, cudaStream_t s) {
  const roms::EosPlan& L = e.plan;
  const T* t = static_cast<const T*>(ptr[0]);
  const T* z_r = static_cast<const T*>(ptr[1]);
  const T* z_w = static_cast<const T*>(ptr[2]);
  T* rho = static_cast<T*>(ptr[3]);
  T* pden = static_cast<T*>(ptr[4]);
  T* bvf = static_cast<T*>(ptr[5]);
  const bool tiled = e.jm95 && e.want_bvf;
  if (!tiled) {
    if (L.tile != 0 || L.threads != kThreads || L.smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    roms::eos_kernel<T><<<blocks_for((e.N + 1) * e.S), kThreads, 0, s>>>(
        t, z_r, rho, pden, bvf, e);
    return static_cast<int>(cudaGetLastError());
  }
  if (L.tile > 32 || (L.tile & (L.tile - 1)) != 0 ||
      !slots_fit(L.tile, L.threads) ||
      L.smem != roms::eos_words(e.N, L.tile) * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_smem(eos_bvf_kernel<T>, L.smem);
  if (err != 0) return err;
  eos_bvf_kernel<T><<<(e.S + L.tile - 1) / L.tile, L.threads, L.smem, s>>>(
      e, t, z_r, z_w, rho, pden, bvf);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int layout(K kernel, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// ptr: zeta h pm pn u v sc_r Cs_r sc_w Cs_w | z_r z_w Hz Huon Hvom W
// ip:  N Ny Nx H L M ew_per ns_per vtransform | tile_x tile_y threads smem
// dp:  hc
int roms_grid_flux(int f64, void* const* ptr, const int* ip, const double* dp,
                   void* stream) {
  roms::DiagParams P = roms::diag_params(ip, dp);
  P.plan = roms::FluxPlan{ip[9], ip[10], ip[11], ip[12]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? grid_flux<double>(ptr, P, s) : grid_flux<float>(ptr, P, s);
}

// ptr: Huon Hvom z_w | W;  ip as roms_grid_flux's first nine (vtransform
// unused)
int roms_omega(int f64, void* const* ptr, const int* ip, const double* dp,
               void* stream) {
  const roms::DiagParams prm = roms::diag_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? omega<double>(ptr, prm, s) : omega<float>(ptr, prm, s);
}

// ptr: t z_r z_w | rho pden bvf  (z_w and bvf may be null without bvf)
// ip:  NT N S jm95 want_bvf use_salt | tile threads smem
// dp:  R0 R0*Tcoef T0 R0*Scoef S0 -(g/rho0) -g
int roms_eos(int f64, void* const* ptr, const int* ip, const double* dp,
             void* stream) {
  roms::EosParams e;
  e.NT = ip[0];
  e.N = ip[1];
  e.S = ip[2];
  e.jm95 = ip[3];
  e.want_bvf = ip[4];
  e.use_salt = ip[5];
  e.plan = roms::EosPlan{ip[6], ip[7], ip[8]};
  e.R0 = dp[0];
  e.R0Tcoef = dp[1];
  e.T0 = dp[2];
  e.R0Scoef = dp[3];
  e.S0 = dp[4];
  e.neg_g_over_rho0 = dp[5];
  e.neg_g = dp[6];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? eos<double>(ptr, e, s) : eos<float>(ptr, e, s);
}

// out: the registers a thread and the local memory (stack frame) a thread
// of the grid_flux kernel (Vtransform 2).  Returns a CUDA error code.
int roms_grid_flux_layout(int f64, int* out) {
  return f64 ? layout(grid_flux_kernel<double, 2>, out)
             : layout(grid_flux_kernel<float, 2>, out);
}

// out: as roms_grid_flux_layout, of the omega kernel
int roms_omega_layout(int f64, int* out) {
  return f64 ? layout(roms::omega_kernel<double>, out)
             : layout(roms::omega_kernel<float>, out);
}

// out: as roms_grid_flux_layout, of the JM95-with-bvf eos kernel
int roms_eos_layout(int f64, int* out) {
  return f64 ? layout(eos_bvf_kernel<double>, out)
             : layout(eos_bvf_kernel<float>, out);
}

}  // extern "C"
