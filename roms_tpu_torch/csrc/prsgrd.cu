// C entry point of the prsgrd32 kernel (prsgrd.cuh), loaded with ctypes by
// roms_tpu_torch/ops/prsgrd_cuda.py.  Launches on the given stream, does
// not synchronize, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "prsgrd.cuh"

namespace {

constexpr int kThreads = 64;   // small blocks spread the columns over SMs

template <typename T>
__global__ void prsgrd32_kernel(roms::PrsParams P, roms::PrsPtrs<T> A) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P.g.Ny * P.g.Nx) roms::prsgrd32_column(P, A, p);
}

template <typename T>
void prsgrd32(void* const* ptr, const roms::PrsParams& P, cudaStream_t s) {
  const int nb = (P.g.Ny * P.g.Nx + kThreads - 1) / kThreads;
  prsgrd32_kernel<T><<<nb, kThreads, 0, s>>>(P, roms::prsgrd_ptrs<T>(ptr));
}

}  // namespace

extern "C" {

// ptr: rho z_r z_w Hz pm pn eq_tide(or null) | ru rv
// ip:  N Ny Nx H L M ew_per ns_per;  dp: g g/rho0 0.5*g/rho0
int roms_prsgrd32(int f64, void* const* ptr, const int* ip, const double* dp,
                  void* stream) {
  const roms::PrsParams P = roms::prsgrd_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    prsgrd32<double>(ptr, P, s);
  else
    prsgrd32<float>(ptr, P, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
