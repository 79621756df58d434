// C entry points of the harmonic viscosity and the geopotential tracer
// diffusion kernels (mix3d.cuh), loaded with ctypes by
// roms_tpu_torch/ops/mix3d_cuda.py.  The viscosity launches one block per
// 2-D tile of padded points, both directions, with the plan (tile, level
// slots, threads, dynamic shared memory) the wrapper passes; the tracer
// diffusion one block per tile of points and mixed tracer.  Each launches
// on the given stream, does not synchronize, and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include "mix3d.cuh"

namespace {

constexpr int kMaxThreads = 256;   // uv3dmix2: threads a block, at most

// three blocks an SM in float32 (at most 80 registers a thread)
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, sizeof(T) == 4 ? 3 : 2)
    uv3dmix2_kernel(const __grid_constant__ roms::MixParams P,
                    const __grid_constant__ roms::MixPtrs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npts = P.plan.tx * P.plan.ty;
  roms::uv3dmix2_tile(P, A, smem, blockIdx.x, blockIdx.y, threadIdx.x,
                      roms::SlotBarrier{
                          1 + static_cast<int>(threadIdx.x) / npts, npts});
}

// Check the plan against the kernel's layout, let the kernel take its
// dynamic shared memory and launch it; returns a CUDA error code.
template <typename T>
int uv3dmix2(void* const* ptr, const roms::MixParams& P, cudaStream_t s) {
  const roms::MixPlan& L = P.plan;
  if (L.tx < 1 || L.ty < 1 || L.ks < 1 || L.ks > 15 ||
      L.threads > kMaxThreads || L.threads != L.tx * L.ty * L.ks ||
      (L.tx * L.ty) % 32 != 0 ||
      L.smem != roms::uv3dmix2_smem(L.tx, L.ty, L.ks, P.N, sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        uv3dmix2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((P.g.Nx + L.tx - 1) / L.tx, (P.g.Ny + L.ty - 1) / L.ty);
  uv3dmix2_kernel<T><<<grid, L.threads, L.smem, s>>>(
      P, roms::mix_ptrs<T>(ptr));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int uv3dmix2_layout(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, uv3dmix2_kernel<T>);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

template <typename T>
__global__ void __launch_bounds__(roms::kGeoThreads)
    t3dmix2_geo_kernel(roms::GeoParams P, roms::GeoPtrs<T> A) {
  __shared__ roms::GeoShared<T> s;
  roms::t3dmix2_geo_tile(P, A, s, blockIdx.x, blockIdx.y, blockIdx.z,
                         threadIdx.x);
}

template <typename T>
int geo_layout(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, t3dmix2_geo_kernel<T>);
  out[0] = roms::kGeoTX;
  out[1] = roms::kGeoTY;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.numRegs;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// ptr: u v Hz pm pn pmask | u_nnew v_nnew rufrc rvfrc (updated in place)
// ip:  N Ny Nx H L M ew_per ns_per | tile_x tile_y level_slots threads smem
// dp:  dt visc2
int roms_uv3dmix2(int f64, void* const* ptr, const int* ip, const double* dp,
                  void* stream) {
  const roms::MixParams P = roms::mix_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? uv3dmix2<double>(ptr, P, s) : uv3dmix2<float>(ptr, P, s);
}

// out: the registers a thread and the local memory (stack frame) a thread
// of the viscosity kernel.  Returns a CUDA error code.
int roms_uv3dmix2_layout(int f64, int* out) {
  return f64 ? uv3dmix2_layout<double>(out) : uv3dmix2_layout<float>(out);
}

// ptr: t Hz z_r pm pn | t_nnew (updated in place)
// ip:  N Ny Nx H L M ew_per ns_per ntr itrc[ntr]
// dp:  dt, then c_h c_s of each of the ntr tracers
int roms_t3dmix2_geo(int f64, void* const* ptr, const int* ip,
                     const double* dp, void* stream) {
  if (ip[8] < 1 || ip[8] > roms::kMaxTr) return -1;
  const roms::GeoParams P = roms::geo_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((P.g.Nx + roms::kGeoTX - 1) / roms::kGeoTX,
                  (P.g.Ny + roms::kGeoTY - 1) / roms::kGeoTY, P.ntr);
  if (f64)
    t3dmix2_geo_kernel<double><<<grid, roms::kGeoThreads, 0, s>>>(
        P, roms::geo_ptrs<double>(ptr));
  else
    t3dmix2_geo_kernel<float><<<grid, roms::kGeoThreads, 0, s>>>(
        P, roms::geo_ptrs<float>(ptr));
  return static_cast<int>(cudaGetLastError());
}

// out: the tile's points along xi and eta, the kernel's static shared
// memory in bytes and its registers a thread.  Returns a CUDA error code.
int roms_t3dmix2_geo_layout(int f64, int* out) {
  return f64 ? geo_layout<double>(out) : geo_layout<float>(out);
}

}  // extern "C"
