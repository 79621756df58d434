// C entry point of the fused fast barotropic loop (fast_loop.cuh), loaded
// with ctypes by roms_tpu_torch/ops/step2d_cuda.py.  Launches one block on
// the given stream, does not synchronize, returns cudaGetLastError().
#include <cuda_runtime.h>

#include "fast_loop.cuh"

namespace {

template <typename T>
int launch(void* const* ptr, const roms::FastParams& P, cudaStream_t s) {
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
  roms::fast_loop_kernel<T><<<1, roms::kFastThreads, 0, s>>>(P, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of scratch planes (Ny*Nx each) the caller allocates.
int roms_fast_loop_scratch_planes() { return roms::N_SCRATCH; }

// ptr: 17 fast-state fields (updated in place) | rufrc rvfrc ru0_nm1 ru0_nm2
//      rv0_nm1 rv0_nm2 | h f pm pn dndx dmde rmask umask vmask pmask |
//      weight1 weight2 | rufrc_c rvfrc_c | scratch
// ip:  Ny Nx H L M ew_per ns_per | zeta, ubar, vbar BC kinds (W S E N
//      each) | uv_adv uv_cor curvgrid uv_vis2 nfast
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
  P.dtfast = dp[0];
  P.grav = dp[1];
  P.visc2 = dp[2];
  P.gamma2 = dp[3];
  P.w_now = dp[4];
  P.w_m1 = dp[5];
  P.w_m2 = dp[6];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(ptr, P, s) : launch<float>(ptr, P, s);
}

}  // extern "C"
