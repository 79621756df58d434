// C entry points of the 3-D predictor/corrector kernels (step3d.cuh),
// loaded with ctypes by roms_tpu_torch/ops/step3d_cuda.py.  Each launches
// one thread per padded (j,i) point and tracer (or direction) on the given
// stream, does not synchronize, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "step3d.cuh"

namespace {

constexpr int kThreads = 64;   // small blocks spread the columns over SMs

inline dim3 grid_for(int S, int ny) {
  return dim3((S + kThreads - 1) / kThreads, ny);
}

template <typename T>
__global__ void tracer_predictor_kernel(roms::PredParams P,
                                        roms::PredPtrs<T> A) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P.g.Ny * P.g.Nx) roms::tracer_predictor_column(P, A, p, blockIdx.y);
}

template <typename T>
__global__ void tracer_corrector_kernel(roms::CorrParams P,
                                        roms::CorrPtrs<T> A) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P.g.Ny * P.g.Nx) roms::tracer_corrector_column(P, A, p, blockIdx.y);
}

template <typename T>
__global__ void uv_corrector_kernel(roms::UvParams P, roms::UvPtrs<T> A) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < P.g.Ny * P.g.Nx) roms::uv_corrector_column(P, A, p, blockIdx.y);
}

}  // namespace

extern "C" {

// ptr: t t_prev Hz Huon Hvom W Akt pm pn stflx btflx ghats srflx swdk_w
//      (the last three may be null) | t3 t_nnew
// ip:  N Ny Nx H L M ew_per ns_per NT ng sol | lbc_t kinds W S E N |
//      hadv[NT] vadv[NT];  dp: dt | cff cff1 cff2 cffv per tracer
int roms_tracer_predictor(int f64, void* const* ptr, const int* ip,
                          const double* dp, void* stream) {
  const roms::PredParams P = roms::pred_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(P.g.Ny * P.g.Nx, P.NT);
  if (f64)
    tracer_predictor_kernel<double><<<grid, kThreads, 0, s>>>(
        P, roms::pred_ptrs<double>(ptr));
  else
    tracer_predictor_kernel<float><<<grid, kThreads, 0, s>>>(
        P, roms::pred_ptrs<float>(ptr));
  return static_cast<int>(cudaGetLastError());
}

// ptr: t_nnew t3 Huon Hvom W Hz z_r(null with splines) Akt pm pn | t
// ip:  N Ny Nx H L M ew_per ns_per NT | lbc_t kinds | splines |
//      hadv[NT] vadv[NT];  dp: dt
int roms_tracer_corrector(int f64, void* const* ptr, const int* ip,
                          const double* dp, void* stream) {
  const roms::CorrParams P = roms::corr_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(P.g.Ny * P.g.Nx, P.NT);
  if (f64)
    tracer_corrector_kernel<double><<<grid, kThreads, 0, s>>>(
        P, roms::corr_ptrs<double>(ptr));
  else
    tracer_corrector_kernel<float><<<grid, kThreads, 0, s>>>(
        P, roms::corr_ptrs<float>(ptr));
  return static_cast<int>(cudaGetLastError());
}

// ptr: u_nnew v_nnew ru rv Hz Akv DU_avg1 DV_avg1 DU_avg2 DV_avg2 Huon Hvom
//      pm pn umask vmask | u v ubar vbar Huon Hvom
// ip:  N Ny Nx H L M ew_per ns_per | lbc_u kinds | lbc_v kinds | splines
// dp:  dt cff gamma2
int roms_uv_corrector(int f64, void* const* ptr, const int* ip,
                      const double* dp, void* stream) {
  const roms::UvParams P = roms::uv_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(P.g.Ny * P.g.Nx, 2);
  if (f64)
    uv_corrector_kernel<double><<<grid, kThreads, 0, s>>>(
        P, roms::uv_ptrs<double>(ptr));
  else
    uv_corrector_kernel<float><<<grid, kThreads, 0, s>>>(
        P, roms::uv_ptrs<float>(ptr));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
