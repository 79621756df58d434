// C entry points of the 3-D predictor/corrector kernels (step3d.cuh),
// loaded with ctypes by roms_tpu_torch/ops/step3d_cuda.py.  The tracer
// tracer kernels and the momentum corrector launch one block per tile of
// padded points, with the plan (points a tile, threads, dynamic shared
// memory) the wrapper passes.  Each launches on the given stream, does not
// synchronize, and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "step3d.cuh"

namespace {

constexpr int kTileThreads = 256;   // threads a tile block (at most)

template <typename T>
__global__ void __launch_bounds__(kTileThreads, sizeof(T) == 4 ? 3 : 2)
    tracer_predictor_kernel(const __grid_constant__ roms::PredParams P,
                            const roms::PredPtrs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  roms::tracer_predictor_tile(P, A, reinterpret_cast<T*>(smem), blockIdx.x,
                              threadIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, sizeof(T) == 4 ? 3 : 2)
    tracer_corrector_kernel(const __grid_constant__ roms::CorrParams P,
                            const roms::CorrPtrs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  roms::tracer_corrector_tile(P, A, reinterpret_cast<T*>(smem), blockIdx.x,
                              threadIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, sizeof(T) == 4 ? 3 : 2)
    uv_corrector_kernel(const __grid_constant__ roms::UvParams P,
                        const __grid_constant__ roms::UvPtrs<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  roms::uv_corrector_tile(P, A, reinterpret_cast<T*>(smem), blockIdx.x,
                          threadIdx.x);
}

// Check a tile kernel's plan against its layout (rows shared words a tile
// column) and let it take the plan's dynamic shared memory; returns a CUDA
// error code.
template <typename T, typename K>
int prepare(K kernel, const roms::TilePlan& L, int rows) {
  if (L.tile < 1 || L.tile > 32 || (L.tile & (L.tile - 1)) != 0 ||
      L.threads % 32 != 0 || L.threads % L.tile != 0 ||
      L.threads > kTileThreads ||
      L.smem != rows * L.tile * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem));
}

inline int tiles(const roms::Geom& g, const roms::TilePlan& L) {
  return (g.Ny * g.Nx + L.tile - 1) / L.tile;
}

template <typename T>
int launch_predictor(const roms::PredParams& P, void* const* ptr,
                     cudaStream_t s) {
  const int err = prepare<T>(tracer_predictor_kernel<T>, P.plan,
                             roms::tracer_rows(false, P.N, P.NT));
  if (err != 0) return err;
  tracer_predictor_kernel<T><<<tiles(P.g, P.plan), P.plan.threads,
                               P.plan.smem, s>>>(P, roms::pred_ptrs<T>(ptr));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_corrector(const roms::CorrParams& P, void* const* ptr,
                     cudaStream_t s) {
  const int err = prepare<T>(tracer_corrector_kernel<T>, P.plan,
                             roms::tracer_rows(true, P.N, P.NT));
  if (err != 0) return err;
  tracer_corrector_kernel<T><<<tiles(P.g, P.plan), P.plan.threads,
                               P.plan.smem, s>>>(P, roms::corr_ptrs<T>(ptr));
  return static_cast<int>(cudaGetLastError());
}

// at least four threads a tile column: two directions' solves and their
// sums beside them
template <typename T>
int launch_uv(const roms::UvParams& P, void* const* ptr, cudaStream_t s) {
  if (P.plan.threads < 4 * P.plan.tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err =
      prepare<T>(uv_corrector_kernel<T>, P.plan, roms::uv_rows(P.N));
  if (err != 0) return err;
  uv_corrector_kernel<T><<<tiles(P.g, P.plan), P.plan.threads, P.plan.smem,
                           s>>>(P, roms::uv_ptrs<T>(ptr));
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

template <typename T>
int tracer_layout(int corrector, int* out) {
  return corrector ? layout(tracer_corrector_kernel<T>, out)
                   : layout(tracer_predictor_kernel<T>, out);
}

}  // namespace

extern "C" {

// ptr: t t_prev Hz Huon Hvom W Akt pm pn stflx btflx ghats srflx swdk_w
//      (the last three may be null) | t3 t_nnew
// ip:  N Ny Nx H L M ew_per ns_per NT ng sol | lbc_t kinds W S E N |
//      hadv[NT] vadv[NT] | tile threads smem
// dp:  dt | cff cff1 cff2 cffv per tracer
int roms_tracer_predictor(int f64, void* const* ptr, const int* ip,
                          const double* dp, void* stream) {
  if (ip[8] < 1 || ip[8] > roms::kMaxTr)
    return static_cast<int>(cudaErrorInvalidValue);
  const roms::PredParams P = roms::pred_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_predictor<double>(P, ptr, s)
             : launch_predictor<float>(P, ptr, s);
}

// ptr: t_nnew t3 Huon Hvom W Hz z_r(null with splines) Akt pm pn | t
// ip:  N Ny Nx H L M ew_per ns_per NT | lbc_t kinds | splines |
//      hadv[NT] vadv[NT] | tile threads smem
// dp:  dt
int roms_tracer_corrector(int f64, void* const* ptr, const int* ip,
                          const double* dp, void* stream) {
  if (ip[8] < 1 || ip[8] > roms::kMaxTr)
    return static_cast<int>(cudaErrorInvalidValue);
  const roms::CorrParams P = roms::corr_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_corrector<double>(P, ptr, s)
             : launch_corrector<float>(P, ptr, s);
}

// ptr: u_nnew v_nnew ru rv Hz Akv DU_avg1 DV_avg1 DU_avg2 DV_avg2 Huon Hvom
//      pm pn umask vmask | u v ubar vbar Huon Hvom
// ip:  N Ny Nx H L M ew_per ns_per | lbc_u kinds | lbc_v kinds | splines |
//      tile threads smem
// dp:  dt cff gamma2
int roms_uv_corrector(int f64, void* const* ptr, const int* ip,
                      const double* dp, void* stream) {
  const roms::UvParams P = roms::uv_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_uv<double>(P, ptr, s) : launch_uv<float>(P, ptr, s);
}

// out: the registers a thread and the local memory (stack frame) a thread
// of the predictor (corrector 0) or corrector kernel.  Returns a CUDA
// error code.
int roms_tracer_layout(int f64, int corrector, int* out) {
  return f64 ? tracer_layout<double>(corrector, out)
             : tracer_layout<float>(corrector, out);
}

// out: the registers a thread and the local memory (stack frame) a thread
// of the momentum corrector.  Returns a CUDA error code.
int roms_uv_corrector_layout(int f64, int* out) {
  return f64 ? layout(uv_corrector_kernel<double>, out)
             : layout(uv_corrector_kernel<float>, out);
}

}  // extern "C"
