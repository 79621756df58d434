// C entry points of the prsgrd32 kernel (prsgrd.cuh), loaded with ctypes by
// roms_tpu_torch/ops/prsgrd_cuda.py.  The kernel launches one block per
// tile of padded points, with the plan (tile, threads, dynamic shared
// memory) the wrapper passes, on the given stream; it does not synchronize
// and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "prsgrd.cuh"

namespace {

constexpr int kMaxThreads = 256;   // threads a block, at most

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    prsgrd32_kernel(const __grid_constant__ roms::PrsParams P,
                    const roms::PrsPtrs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  roms::prsgrd32_tile(P, A, smem, blockIdx.x, blockIdx.y, threadIdx.x);
}

template <typename T>
int prsgrd32(void* const* ptr, const roms::PrsParams& P, cudaStream_t s) {
  const roms::PrsPlan& L = P.plan;
  const int npts = L.tx * L.ty;
  if (L.tx < 1 || L.ty < 1 || L.threads > kMaxThreads ||
      L.threads % 32 != 0 || npts > L.threads || L.threads % npts != 0 ||
      L.smem != roms::prsgrd_smem(P.N, L.tx, L.ty, sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        prsgrd32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((P.g.Nx + L.tx - 1) / L.tx, (P.g.Ny + L.ty - 1) / L.ty);
  prsgrd32_kernel<T><<<grid, L.threads, L.smem, s>>>(
      P, roms::prsgrd_ptrs<T>(ptr));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int layout(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, prsgrd32_kernel<T>);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// ptr: rho z_r z_w Hz pm pn eq_tide(or null) | ru rv
// ip:  N Ny Nx H L M ew_per ns_per | tile_x tile_y threads smem
// dp:  g g/rho0 0.5*g/rho0
int roms_prsgrd32(int f64, void* const* ptr, const int* ip, const double* dp,
                  void* stream) {
  const roms::PrsParams P = roms::prsgrd_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? prsgrd32<double>(ptr, P, s) : prsgrd32<float>(ptr, P, s);
}

// out: the registers a thread and the local memory (stack frame) a thread
// of the kernel.  Returns a CUDA error code.
int roms_prsgrd32_layout(int f64, int* out) {
  return f64 ? layout<double>(out) : layout<float>(out);
}

}  // extern "C"
