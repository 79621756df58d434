// C entry point of the momentum right-hand side kernel (rhs3d.cuh), loaded
// with ctypes by roms_tpu_torch/ops/rhs3d_cuda.py.  Launches one thread per
// padded (j,i) point and direction on the given stream, does not
// synchronize, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "rhs3d.cuh"

namespace {

constexpr int kThreads = 64;   // small blocks spread the points over SMs

template <typename T>
__global__ void rhs3d_kernel(roms::RhsParams P, roms::RhsPtrs<T> A) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P.g.Ny * P.g.Nx) roms::rhs3d_column(P, A, p, blockIdx.y);
}

}  // namespace

extern "C" {

// ptr: u v Huon Hvom W Hz ru rv sustr svstr bustr bvstr pm pn f
//      dndx dmde (null without curvgrid)
//      ru_prev rv_prev ru_prev2 rv_prev2 (null without the start) |
//      ru rv rufrc rvfrc u_nnew v_nnew (the last two null without it)
// ip:  N Ny Nx H L M ew_per ns_per | uv_cor uv_adv curv start
// dp:  dt a1 a2
int roms_rhs3d(int f64, void* const* ptr, const int* ip, const double* dp,
               void* stream) {
  const roms::RhsParams P = roms::rhs_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((P.g.Ny * P.g.Nx + kThreads - 1) / kThreads, 2);
  if (f64)
    rhs3d_kernel<double><<<grid, kThreads, 0, s>>>(P,
                                                   roms::rhs_ptrs<double>(ptr));
  else
    rhs3d_kernel<float><<<grid, kThreads, 0, s>>>(P,
                                                  roms::rhs_ptrs<float>(ptr));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
