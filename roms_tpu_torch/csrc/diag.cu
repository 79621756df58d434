// C entry points of the diagnostic kernels (diag.cuh), loaded with ctypes by
// roms_tpu_torch/ops/diag_cuda.py.  Each launches on the given stream,
// does not synchronize, and returns cudaGetLastError().
//
// Arguments: dtype flag (1 = float64, 0 = float32), a host array of device
// pointers, a host array of ints and one of doubles; their order is fixed
// by the Python wrapper.
#include <cuda_runtime.h>

#include "diag.cuh"

namespace {

constexpr int kThreads = 256;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

roms::DiagParams diag_params(const int* ip, const double* dp) {
  roms::DiagParams prm;
  prm.N = ip[0];
  prm.g.Ny = ip[1];
  prm.g.Nx = ip[2];
  prm.g.H = ip[3];
  prm.g.L = ip[4];
  prm.g.M = ip[5];
  prm.g.ew_per = ip[6];
  prm.g.ns_per = ip[7];
  prm.vtransform = ip[8];
  prm.hc = dp[0];
  return prm;
}

template <typename T>
void grid_flux(void* const* ptr, const roms::DiagParams& prm,
               cudaStream_t s) {
  const T* zeta = static_cast<const T*>(ptr[0]);
  const T* h = static_cast<const T*>(ptr[1]);
  const T* pm = static_cast<const T*>(ptr[2]);
  const T* pn = static_cast<const T*>(ptr[3]);
  const T* u = static_cast<const T*>(ptr[4]);
  const T* v = static_cast<const T*>(ptr[5]);
  const T* sc_r = static_cast<const T*>(ptr[6]);
  const T* Cs_r = static_cast<const T*>(ptr[7]);
  const T* sc_w = static_cast<const T*>(ptr[8]);
  const T* Cs_w = static_cast<const T*>(ptr[9]);
  T* z_r = static_cast<T*>(ptr[10]);
  T* z_w = static_cast<T*>(ptr[11]);
  T* Hz = static_cast<T*>(ptr[12]);
  T* Huon = static_cast<T*>(ptr[13]);
  T* Hvom = static_cast<T*>(ptr[14]);
  T* W = static_cast<T*>(ptr[15]);
  const int nb = blocks_for(prm.g.Ny * prm.g.Nx);
  roms::depth_kernel<T><<<nb, kThreads, 0, s>>>(zeta, h, sc_r, Cs_r, sc_w,
                                                Cs_w, z_r, z_w, Hz, prm);
  roms::massflux_kernel<T><<<nb, kThreads, 0, s>>>(Hz, u, v, pm, pn, Huon,
                                                   Hvom, prm);
  roms::omega_kernel<T><<<nb, kThreads, 0, s>>>(Huon, Hvom, z_w, W, prm);
}

template <typename T>
void omega(void* const* ptr, const roms::DiagParams& prm, cudaStream_t s) {
  roms::omega_kernel<T><<<blocks_for(prm.g.Ny * prm.g.Nx), kThreads, 0, s>>>(
      static_cast<const T*>(ptr[0]), static_cast<const T*>(ptr[1]),
      static_cast<const T*>(ptr[2]), static_cast<T*>(ptr[3]), prm);
}

template <typename T>
void eos(void* const* ptr, const roms::EosParams& e, cudaStream_t s) {
  roms::eos_kernel<T><<<blocks_for((e.N + 1) * e.S), kThreads, 0, s>>>(
      static_cast<const T*>(ptr[0]), static_cast<const T*>(ptr[1]),
      static_cast<const T*>(ptr[2]), static_cast<T*>(ptr[3]),
      static_cast<T*>(ptr[4]), static_cast<T*>(ptr[5]), e);
}

}  // namespace

extern "C" {

// ptr: zeta h pm pn u v sc_r Cs_r sc_w Cs_w | z_r z_w Hz Huon Hvom W
// ip:  N Ny Nx H L M ew_per ns_per vtransform;  dp: hc
int roms_grid_flux(int f64, void* const* ptr, const int* ip, const double* dp,
                   void* stream) {
  const roms::DiagParams prm = diag_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    grid_flux<double>(ptr, prm, s);
  else
    grid_flux<float>(ptr, prm, s);
  return static_cast<int>(cudaGetLastError());
}

// ptr: Huon Hvom z_w | W;  ip as roms_grid_flux (vtransform unused)
int roms_omega(int f64, void* const* ptr, const int* ip, const double* dp,
               void* stream) {
  const roms::DiagParams prm = diag_params(ip, dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    omega<double>(ptr, prm, s);
  else
    omega<float>(ptr, prm, s);
  return static_cast<int>(cudaGetLastError());
}

// ptr: t z_r z_w | rho pden bvf  (z_w and bvf may be null without bvf)
// ip:  NT N S jm95 want_bvf use_salt
// dp:  R0 R0*Tcoef T0 R0*Scoef S0 -(g/rho0) -g
int roms_eos(int f64, void* const* ptr, const int* ip, const double* dp,
             void* stream) {
  roms::EosParams e;
  e.NT = ip[0];
  e.N = ip[1];
  e.S = ip[2];
  e.jm95 = ip[3];
  e.want_bvf = ip[4];
  e.use_salt = ip[5];
  e.R0 = dp[0];
  e.R0Tcoef = dp[1];
  e.T0 = dp[2];
  e.R0Scoef = dp[3];
  e.S0 = dp[4];
  e.neg_g_over_rho0 = dp[5];
  e.neg_g = dp[6];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    eos<double>(ptr, e, s);
  else
    eos<float>(ptr, e, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
