// C entry point of the harmonic viscosity kernel (mix3d.cuh), loaded with
// ctypes by roms_tpu_torch/ops/mix3d_cuda.py.  Launches one thread per
// padded (j,i) point and direction on the given stream, does not
// synchronize, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mix3d.cuh"

namespace {

constexpr int kThreads = 64;   // small blocks spread the points over SMs

template <typename T>
__global__ void uv3dmix2_kernel(roms::MixParams P, roms::MixPtrs<T> A) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P.g.Ny * P.g.Nx) roms::uv3dmix2_column(P, A, p, blockIdx.y);
}

}  // namespace

extern "C" {

// ptr: u v Hz pm pn pmask | u_nnew v_nnew rufrc rvfrc (updated in place)
// ip:  N Ny Nx H L M ew_per ns_per;  dp: dt visc2
int roms_uv3dmix2(int f64, void* const* ptr, const int* ip, const double* dp,
                  void* stream) {
  const roms::MixParams P = roms::mix_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((P.g.Ny * P.g.Nx + kThreads - 1) / kThreads, 2);
  if (f64)
    uv3dmix2_kernel<double><<<grid, kThreads, 0, s>>>(
        P, roms::mix_ptrs<double>(ptr));
  else
    uv3dmix2_kernel<float><<<grid, kThreads, 0, s>>>(
        P, roms::mix_ptrs<float>(ptr));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
