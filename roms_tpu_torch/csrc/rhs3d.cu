// C entry points of the momentum right-hand side kernel (rhs3d.cuh), loaded
// with ctypes by roms_tpu_torch/ops/rhs3d_cuda.py.  The kernel launches one
// block per tile of padded points, both directions, with the plan (tile,
// level slots, threads, dynamic shared memory) the wrapper passes, on the
// given stream; it does not synchronize and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "rhs3d.cuh"

namespace {

constexpr int kMaxThreads = 256;   // threads a block, at most

// three blocks an SM in float32 (at most 80 registers a thread)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 3 : 2)
    rhs3d_kernel(const __grid_constant__ roms::RhsParams P,
                 const roms::RhsPtrs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npts = P.plan.tx * P.plan.ty;
  roms::rhs3d_tile(P, A, smem, blockIdx.x, blockIdx.y, threadIdx.x,
                   roms::SlotBarrier{
                       1 + static_cast<int>(threadIdx.x) / npts, npts});
}

template <typename T>
int rhs3d(void* const* ptr, const roms::RhsParams& P, cudaStream_t s) {
  const roms::RhsPlan& L = P.plan;
  if (L.tx < 1 || L.ty < 1 || L.ks < 1 || L.ks > 15 ||
      L.threads > kMaxThreads || L.threads != L.tx * L.ty * L.ks ||
      (L.tx * L.ty) % 32 != 0 ||
      L.smem != roms::rhs3d_smem(L.tx, L.ty, L.ks, sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rhs3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((P.g.Nx + L.tx - 1) / L.tx, (P.g.Ny + L.ty - 1) / L.ty);
  rhs3d_kernel<T><<<grid, L.threads, L.smem, s>>>(P,
                                                   roms::rhs_ptrs<T>(ptr));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int layout(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, rhs3d_kernel<T>);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// ptr: u v Huon Hvom W Hz ru rv sustr svstr bustr bvstr pm pn f
//      dndx dmde (null without curvgrid)
//      ru_prev rv_prev ru_prev2 rv_prev2 (null without the start) |
//      ru rv rufrc rvfrc u_nnew v_nnew (the last two null without it)
// ip:  N Ny Nx H L M ew_per ns_per | uv_cor uv_adv curv start |
//      tile_x tile_y level_slots threads smem
// dp:  dt a1 a2
int roms_rhs3d(int f64, void* const* ptr, const int* ip, const double* dp,
               void* stream) {
  const roms::RhsParams P = roms::rhs_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? rhs3d<double>(ptr, P, s) : rhs3d<float>(ptr, P, s);
}

// out: the registers a thread and the local memory (stack frame) a thread
// of the kernel.  Returns a CUDA error code.
int roms_rhs3d_layout(int f64, int* out) {
  return f64 ? layout<double>(out) : layout<float>(out);
}

}  // extern "C"
