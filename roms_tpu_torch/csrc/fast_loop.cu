// C entry points of the fused fast barotropic loop (fast_loop.cuh), loaded
// with ctypes by roms_tpu_torch/ops/step2d_cuda.py.  The loop is one
// cooperative launch of the blocks plan() gives on the given stream: it
// does not synchronize, and returns the launch's error code, which the
// caller raises on (a grid that cannot be co-resident is refused).
#include <cuda_runtime.h>

#include "fast_loop.cuh"

namespace {

constexpr int kMaxDevices = 16;
constexpr int kSizes = roms::kFastMaxThreads / 32 + 1;

// Blocks of `threads` threads that can be co-resident on one SM, and the
// SM count, of the current device: queried once per device, dtype and
// block size.
template <typename T>
cudaError_t occupancy(int threads, int* per_sm, int* sms) {
  static int sm_count[kMaxDevices];
  static int resident[kMaxDevices][kSizes];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int& n = resident[dev][threads / 32];
  if (n == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, roms::fast_loop_kernel<T>, threads, 0);
    if (err != cudaSuccess) return err;
  }
  *per_sm = n;
  *sms = sm_count[dev];
  return cudaSuccess;
}

// out: blocks (enough for S points at one a thread, at most the
// co-resident limit), co-resident blocks per SM, SMs.
template <typename T>
cudaError_t plan(int threads, int S, int* out) {
  if (threads < 32 || threads > roms::kFastMaxThreads || threads % 32)
    return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const cudaError_t err = occupancy<T>(threads, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int need = (S + threads - 1) / threads;
  out[0] = need < per_sm * sms ? need : per_sm * sms;
  out[1] = per_sm;
  out[2] = sms;
  return cudaSuccess;
}

template <typename T>
int launch(void* const* ptr, roms::FastParams P, int threads,
           cudaStream_t s) {
  roms::FastPtrs<T> A;
  int n = 0;
  for (int k = 0; k < roms::N_FS; ++k) A.fs[k] = static_cast<T*>(ptr[n++]);
  for (int k = 0; k < roms::N_FRC; ++k)
    A.frc[k] = static_cast<const T*>(ptr[n++]);
  for (int k = 0; k < roms::N_GRID; ++k)
    A.grd[k] = static_cast<const T*>(ptr[n++]);
  A.w1 = static_cast<const T*>(ptr[n++]);
  A.w2 = static_cast<const T*>(ptr[n++]);
  A.rufrc_c = static_cast<T*>(ptr[n++]);
  A.rvfrc_c = static_cast<T*>(ptr[n++]);
  A.scratch = static_cast<T*>(ptr[n++]);
  int pl[3];
  const cudaError_t err = plan<T>(threads, P.g.Ny * P.g.Nx, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&P, &A};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(roms::fast_loop_kernel<T>), dim3(pl[0]),
      dim3(threads), args, 0, s));
}

}  // namespace

extern "C" {

// Number of scratch planes (Ny*Nx each) the caller allocates.
int roms_fast_loop_scratch_planes() { return roms::N_SCRATCH; }

// ptr: 17 fast-state fields (updated in place) | rufrc rvfrc ru0_nm1 ru0_nm2
//      rv0_nm1 rv0_nm2 | h f pm pn dndx dmde rmask umask vmask pmask |
//      weight1 weight2 | rufrc_c rvfrc_c | scratch
// ip:  Ny Nx H L M ew_per ns_per | zeta, ubar, vbar BC kinds (W S E N
//      each) | uv_adv uv_cor curvgrid uv_vis2 nfast | threads a block
// dp:  dtfast g visc2 gamma2 w_now w_m1 w_m2
int roms_fast_loop(int f64, void* const* ptr, const int* ip,
                   const double* dp, void* stream) {
  roms::FastParams P;
  int n = 0;
  P.g.Ny = ip[n++];
  P.g.Nx = ip[n++];
  P.g.H = ip[n++];
  P.g.L = ip[n++];
  P.g.M = ip[n++];
  P.g.ew_per = ip[n++];
  P.g.ns_per = ip[n++];
  for (int k = 0; k < 4; ++k) P.bz[k] = ip[n++];
  for (int k = 0; k < 4; ++k) P.bu[k] = ip[n++];
  for (int k = 0; k < 4; ++k) P.bv[k] = ip[n++];
  P.uv_adv = ip[n++];
  P.uv_cor = ip[n++];
  P.curvgrid = ip[n++];
  P.uv_vis2 = ip[n++];
  P.nfast = ip[n++];
  const int threads = ip[n++];
  P.dtfast = dp[0];
  P.grav = dp[1];
  P.visc2 = dp[2];
  P.gamma2 = dp[3];
  P.w_now = dp[4];
  P.w_m1 = dp[5];
  P.w_m2 = dp[6];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(ptr, P, threads, s)
             : launch<float>(ptr, P, threads, s);
}

// The launch roms_fast_loop makes for S padded points and `threads` a
// block; out: blocks, co-resident blocks per SM, SMs.  Returns a CUDA
// error code.
int roms_fast_loop_plan(int f64, int threads, int S, int* out) {
  return static_cast<int>(f64 ? plan<double>(threads, S, out)
                              : plan<float>(threads, S, out));
}

// nbar grid barriers in one cooperative launch of blocks x threads on the
// given stream (no synchronization): the cost of the loop's barriers alone.
int roms_grid_barriers(int blocks, int threads, int nbar, void* stream) {
  void* args[] = {&nbar};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(roms::grid_barrier_kernel),
      dim3(blocks), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
