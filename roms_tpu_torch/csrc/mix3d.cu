// C entry points of the harmonic viscosity and the geopotential tracer
// diffusion kernels (mix3d.cuh), loaded with ctypes by
// roms_tpu_torch/ops/mix3d_cuda.py.  The viscosity launches one thread per
// padded (j,i) point and direction, the tracer diffusion one block per
// tile of points and mixed tracer; each launches on the given stream, does
// not synchronize, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "mix3d.cuh"

namespace {

constexpr int kThreads = 64;   // uv3dmix2: small blocks spread the points

template <typename T>
__global__ void uv3dmix2_kernel(roms::MixParams P, roms::MixPtrs<T> A) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P.g.Ny * P.g.Nx) roms::uv3dmix2_column(P, A, p, blockIdx.y);
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
