// The fast barotropic loop of one slow step (step2d_LF_AM3.h under the
// main3d.F:592-713 loop) in ONE launch of ONE thread block.
//
// Replaces the TPU kernel roms_tpu/ops/step2d_pallas.py::fast_loop_fused
// (its math core _core, :92-245) on the same configuration subset
// (supported() in ops/step2d_cuda.py).  It is bound by memory traffic and
// by synchronization, not by arithmetic: each substep is ~10 stencil sweeps
// of a few flops per point over the 2-D state, with a barrier between
// sweeps.  Design: the whole nfast loop runs inside one block, so each
// barrier is a __syncthreads() and no launch is paid per substep; the 2-D
// state (a few hundred KB at the UPWELLING size) stays in device memory and
// is served from L1/L2.  Nothing more is done about bandwidth yet: the
// choice between this single block, a persistent cooperative grid and
// per-substep launches in a CUDA graph is a later measurement.
//
// Every phase is a pointwise map over all padded points (thread-strided
// loop); neighbours wrap modulo the padded extent like torch.roll, and the
// boundary writes and halo fills are gathers (bc.cuh), so each phase reads
// only arrays completed before the preceding barrier.
#pragma once

#include "bc.cuh"

namespace roms {

struct FastParams {
  Geom g;
  int bz[4], bu[4], bv[4];  // zeta/ubar/vbar BC kinds: west south east north
  int uv_adv, uv_cor, curvgrid, uv_vis2;
  int nfast;
  double dtfast, grav, visc2, gamma2;
  double w_now, w_m1, w_m2;  // AB3 weights of the 2-D/3-D coupling (iic)
};

// fast-state fields, in the order of roms_tpu_torch/ops/step2d.py FS_FIELDS
enum FsField {
  ZETA_N, ZETA_NM1, UBAR_N, UBAR_NM1, VBAR_N, VBAR_NM1, RZETA_N, RZETA_NM1,
  RUBAR_N, RUBAR_NM1, RVBAR_N, RVBAR_NM1, ZT_AVG1, DU_AVG1, DV_AVG1,
  DU_AVG2, DV_AVG2, N_FS
};
enum Forcing { RUFRC, RVFRC, RU0_NM1, RU0_NM2, RV0_NM1, RV0_NM2, N_FRC };
enum GridField { G_H, G_F, G_PM, G_PN, G_DNDX, G_DMDE, G_RMASK, G_UMASK,
                 G_VMASK, G_PMASK, N_GRID };
// scratch planes
enum Scratch {
  S_ON_U, S_OM_V, S_ON_R, S_OM_R, S_FOMN, S_PMN,  // grid metrics
  S_DR, S_DUON, S_DVOM,                           // depth and fluxes
  S_RZ, S_ZNEW, S_DNEW, S_ZWRK,                   // zeta update
  S_G1, S_D1, S_G2, S_D2, S_G3, S_D3, S_G4, S_D4,  // advection curvatures
  S_UFX, S_UFE, S_VFX, S_VFE,                     // advective fluxes
  S_UFXC, S_VFEC, S_CU, S_CV,                     // Coriolis, curvilinear
  S_UFXV, S_VFEV, S_UFEV, S_VFXV,                 // viscous fluxes
  S_ZP, S_UP, S_VP,                               // predictor results
  S_URAW, S_VRAW, S_ZNBC,                         // before BCs / after
  S_A0, S_A1, S_A2, S_A3, S_A4,                   // final averages
  N_SCRATCH
};

template <typename T>
struct FastPtrs {
  T* fs[N_FS];
  const T* frc[N_FRC];
  const T* grd[N_GRID];
  const T* w1;
  const T* w2;
  T* rufrc_c;
  T* rvfrc_c;
  T* scratch;  // N_SCRATCH planes of Ny*Nx
};

// AUX: the auxiliary step iif = nfast+1, which only finishes the averages
enum Mode { FE_PRED, LF_PRED, CORR, AUX };

template <typename T>
struct Fast {
  const FastParams& P;
  const FastPtrs<T>& A;
  int S;

  __device__ T* sc(int k) const { return A.scratch + k * S; }
  __device__ const T* gr(int k) const { return A.grd[k]; }
  __device__ int at(int j, int i) const { return j * P.g.Nx + i; }
  __device__ int jw(int j) const { return wrap(j, P.g.Ny); }
  __device__ int iw(int i) const { return wrap(i, P.g.Nx); }

  // grid metrics, as the Grid properties compute them
  __device__ void metrics(int p) const {
    const int j = p / P.g.Nx, i = p - (p / P.g.Nx) * P.g.Nx;
    const T* pm = gr(G_PM);
    const T* pn = gr(G_PN);
    sc(S_ON_U)[p] = T(2) / (pn[at(j, iw(i - 1))] + pn[p]);
    sc(S_OM_V)[p] = T(2) / (pm[at(jw(j - 1), i)] + pm[p]);
    sc(S_ON_R)[p] = T(1) / pn[p];
    sc(S_OM_R)[p] = T(1) / pm[p];
    sc(S_FOMN)[p] = gr(G_F)[p] / (pm[p] * pn[p]);
    sc(S_PMN)[p] = pm[p] * pn[p];
  }

  // depth_fluxes(Z, U, V) and the filter accumulations (phase A)
  __device__ void depth(int p, Mode mode, const T* Z, const T* U,
                        const T* V, T cff1, T cff2) const {
    const int j = p / P.g.Nx, i = p - (p / P.g.Nx) * P.g.Nx;
    const T* h = gr(G_H);
    const int im = at(j, iw(i - 1)), jm = at(jw(j - 1), i);
    const T Dr = Z[p] + h[p];
    const T DUon = U[p] * (T(0.5) * ((Z[im] + h[im]) + Dr)) * sc(S_ON_U)[p];
    const T DVom = V[p] * (T(0.5) * ((Z[jm] + h[jm]) + Dr)) * sc(S_OM_V)[p];
    sc(S_DR)[p] = Dr;
    sc(S_DUON)[p] = DUon;
    sc(S_DVOM)[p] = DVom;
    T* const* fs = A.fs;
    if (mode == FE_PRED) {
      fs[ZT_AVG1][p] = T(0);
      fs[DU_AVG1][p] = T(0);
      fs[DV_AVG1][p] = T(0);
      fs[DU_AVG2][p] = cff2 * DUon;
      fs[DV_AVG2][p] = cff2 * DVom;
    } else if (mode == AUX) {  // sums into scratch: final_fill fills them
      sc(S_A0)[p] = fs[ZT_AVG1][p] + cff1 * fs[ZETA_N][p];
      sc(S_A1)[p] = fs[DU_AVG1][p] + cff1 * DUon;
      sc(S_A2)[p] = fs[DV_AVG1][p] + cff1 * DVom;
      sc(S_A3)[p] = fs[DU_AVG2][p] + cff2 * DUon;
      sc(S_A4)[p] = fs[DV_AVG2][p] + cff2 * DVom;
    } else if (mode == LF_PRED) {
      fs[ZT_AVG1][p] = fs[ZT_AVG1][p] + cff1 * fs[ZETA_N][p];
      fs[DU_AVG1][p] = fs[DU_AVG1][p] + cff1 * DUon;
      fs[DV_AVG1][p] = fs[DV_AVG1][p] + cff1 * DVom;
      fs[DU_AVG2][p] = fs[DU_AVG2][p] + cff2 * DUon;
      fs[DV_AVG2][p] = fs[DV_AVG2][p] + cff2 * DVom;
    } else {
      fs[DU_AVG2][p] = fs[DU_AVG2][p] + cff2 * DUon;
      fs[DV_AVG2][p] = fs[DV_AVG2][p] + cff2 * DVom;
    }
  }

  // continuity, new zeta before its BCs, and the advection curvatures
  // (phase B).  U, V: the velocities the momentum RHS is evaluated at.
  __device__ void zeta_update(int p, Mode mode, const T* U,
                              const T* V) const {
    const int j = p / P.g.Nx, i = p - (p / P.g.Nx) * P.g.Nx;
    const int ip = at(j, iw(i + 1)), im = at(j, iw(i - 1));
    const int jp = at(jw(j + 1), i), jm = at(jw(j - 1), i);
    T* const* fs = A.fs;
    const T* DUon = sc(S_DUON);
    const T* DVom = sc(S_DVOM);
    const T rz = (DUon[p] - DUon[ip]) + (DVom[p] - DVom[jp]);
    const T dtfast = T(P.dtfast);
    const T pmn = sc(S_PMN)[p];
    const T rmask = gr(G_RMASK)[p];
    T zn, zw;
    if (mode == FE_PRED) {
      zn = (fs[ZETA_N][p] + pmn * dtfast * rz) * rmask;
      zw = T(0.5) * (fs[ZETA_N][p] + zn);
    } else if (mode == LF_PRED) {
      zn = (fs[ZETA_NM1][p] + pmn * T(2.0 * P.dtfast) * rz) * rmask;
      zw = T(1.0 - 2.0 * (4.0 / 25.0)) * fs[ZETA_N][p] +
           T(4.0 / 25.0) * (fs[ZETA_NM1][p] + zn);
    } else {
      zn = (fs[ZETA_N][p] + pmn * (T(P.dtfast * 5.0 / 12.0) * rz +
                                   T(P.dtfast * 8.0 / 12.0) * fs[RZETA_N][p] -
                                   T(P.dtfast * 1.0 / 12.0) *
                                       fs[RZETA_NM1][p])) *
           rmask;
      zw = T(1.0 - 2.0 / 5.0) * zn + T(2.0 / 5.0) * sc(S_ZP)[p];
    }
    sc(S_RZ)[p] = rz;
    sc(S_ZNEW)[p] = zn;
    sc(S_DNEW)[p] = zn + gr(G_H)[p];
    sc(S_ZWRK)[p] = zw;
    if (P.uv_adv) {
      sc(S_G1)[p] = U[im] - T(2) * U[p] + U[ip];
      sc(S_D1)[p] = DUon[im] - T(2) * DUon[p] + DUon[ip];
      sc(S_G2)[p] = U[jm] - T(2) * U[p] + U[jp];
      sc(S_D2)[p] = DVom[im] - T(2) * DVom[p] + DVom[ip];
      sc(S_G3)[p] = V[im] - T(2) * V[p] + V[ip];
      sc(S_D3)[p] = DUon[jm] - T(2) * DUon[p] + DUon[jp];
      sc(S_G4)[p] = V[jm] - T(2) * V[p] + V[jp];
      sc(S_D4)[p] = DVom[jm] - T(2) * DVom[p] + DVom[jp];
    }
  }

  // zeta BCs, the momentum fluxes, and (predictor) the rzeta history
  // (phase C)
  __device__ void fluxes(int p, Mode mode, const T* U, const T* V) const {
    const Geom& g = P.g;
    const int j = p / g.Nx, i = p - (p / g.Nx) * g.Nx;
    const int ipi = iw(i + 1), imi = iw(i - 1);
    const int jpj = jw(j + 1), jmj = jw(j - 1);
    const int ip = at(j, ipi), im = at(j, imi);
    const int jp = at(jpj, i), jm = at(jmj, i), imjm = at(jmj, imi);
    T* const* fs = A.fs;
    const T zbc = rho_bc_fill(g, P.bz, sc(S_ZNEW), gr(G_RMASK), j, i);
    if (mode == CORR) {
      sc(S_ZNBC)[p] = zbc;
    } else {
      sc(S_ZP)[p] = zbc;
      fs[RZETA_NM1][p] = fs[RZETA_N][p];
      fs[RZETA_N][p] = fill(g, sc(S_RZ), j, i);
    }
    const T sixth = T(1.0 / 6.0);
    const T* DUon = sc(S_DUON);
    const T* DVom = sc(S_DVOM);
    const T* Dr = sc(S_DR);
    if (P.uv_adv) {
      // curvatures with the one-sided edge extrapolations applied on read
      const int H = g.H, L = g.L, M = g.M;
      auto xcol = [&](int ii, int lo, int hi) {
        return extrap_src(ii, g.ew_per, lo, hi);
      };
      auto yrow = [&](int jj, int lo, int hi) {
        return extrap_src(jj, g.ns_per, lo, hi);
      };
      const T* G1 = sc(S_G1);
      const T* D1 = sc(S_D1);
      sc(S_UFX)[p] =
          T(0.25) *
          (U[p] + U[ip] -
           sixth * (G1[at(j, xcol(i, H, H + L))] +
                    G1[at(j, xcol(ipi, H, H + L))])) *
          (DUon[p] + DUon[ip] -
           sixth * (D1[at(j, xcol(i, H, H + L))] +
                    D1[at(j, xcol(ipi, H, H + L))]));
      const T* G2 = sc(S_G2);
      const T* D2 = sc(S_D2);
      sc(S_UFE)[p] =
          T(0.25) *
          (U[p] + U[jm] -
           sixth * (G2[at(yrow(j, H - 1, H + M), i)] +
                    G2[at(yrow(jmj, H - 1, H + M), i)])) *
          (DVom[p] + DVom[im] - sixth * (D2[p] + D2[im]));
      const T* G3 = sc(S_G3);
      const T* D3 = sc(S_D3);
      sc(S_VFX)[p] =
          T(0.25) *
          (V[p] + V[im] -
           sixth * (G3[at(j, xcol(i, H - 1, H + L))] +
                    G3[at(j, xcol(imi, H - 1, H + L))])) *
          (DUon[p] + DUon[jm] - sixth * (D3[p] + D3[jm]));
      const T* G4 = sc(S_G4);
      const T* D4 = sc(S_D4);
      sc(S_VFE)[p] =
          T(0.25) *
          (V[p] + V[jp] -
           sixth * (G4[at(yrow(j, H, H + M), i)] +
                    G4[at(yrow(jpj, H, H + M), i)])) *
          (DVom[p] + DVom[jp] -
           sixth * (D4[at(yrow(j, H, H + M), i)] +
                    D4[at(yrow(jpj, H, H + M), i)]));
    }
    if (P.uv_cor) {
      const T cor = T(0.5) * Dr[p] * sc(S_FOMN)[p];
      sc(S_UFXC)[p] = cor * (V[p] + V[jp]);
      sc(S_VFEC)[p] = cor * (U[p] + U[ip]);
    }
    if (P.curvgrid && P.uv_adv) {
      const T cff = T(0.5) * (V[p] + V[jp]) * gr(G_DNDX)[p] -
                    T(0.5) * (U[p] + U[ip]) * gr(G_DMDE)[p];
      sc(S_CU)[p] = T(0.5) * Dr[p] * cff * (U[p] + U[ip]);
      sc(S_CV)[p] = T(0.5) * Dr[p] * cff * (V[p] + V[jp]);
    }
    if (P.uv_vis2) {
      const T* pm = gr(G_PM);
      const T* pn = gr(G_PN);
      const T visc2 = T(P.visc2);
      const T cff_r =
          visc2 * Dr[p] * T(0.5) *
          ((pm[p] / pn[p]) * ((pn[p] + pn[ip]) * U[ip] - (pn[im] + pn[p]) * U[p]) -
           (pn[p] / pm[p]) * ((pm[p] + pm[jp]) * V[jp] - (pm[jm] + pm[p]) * V[p]));
      sc(S_UFXV)[p] = sc(S_ON_R)[p] * sc(S_ON_R)[p] * cff_r;
      sc(S_VFEV)[p] = sc(S_OM_R)[p] * sc(S_OM_R)[p] * cff_r;
      const T Dr_p = T(0.25) * (Dr[p] + Dr[im] + Dr[jm] + Dr[imjm]);
      const T sum_pm = pm[imjm] + pm[im] + pm[jm] + pm[p];
      const T sum_pn = pn[imjm] + pn[im] + pn[jm] + pn[p];
      T cff_p =
          visc2 * Dr_p * T(0.5) *
          ((sum_pm / sum_pn) *
               ((pn[jm] + pn[p]) * V[p] - (pn[imjm] + pn[im]) * V[im]) +
           (sum_pn / sum_pm) *
               ((pm[im] + pm[p]) * U[p] - (pm[imjm] + pm[jm]) * U[jm]));
      cff_p = cff_p * gr(G_PMASK)[p];
      const T om_p = T(4) / sum_pm;
      const T on_p = T(4) / sum_pn;
      sc(S_UFEV)[p] = om_p * om_p * cff_p;
      sc(S_VFXV)[p] = on_p * on_p * cff_p;
    }
  }

  // the momentum RHS, its time combination, and the new ubar/vbar before
  // their BCs (phase D)
  __device__ void momentum(int p, Mode mode) const {
    const Geom& g = P.g;
    const int j = p / g.Nx, i = p - (p / g.Nx) * g.Nx;
    const int ip = at(j, iw(i + 1)), im = at(j, iw(i - 1));
    const int jp = at(jw(j + 1), i), jm = at(jw(j - 1), i);
    T* const* fs = A.fs;
    const T* h = gr(G_H);
    const T* pm = gr(G_PM);
    const T* pn = gr(G_PN);
    const T* zw = sc(S_ZWRK);
    const T half_g = T(0.5 * P.grav);
    T ru = half_g * sc(S_ON_U)[p] *
           ((h[im] + h[p]) * (zw[im] - zw[p]) +
            (zw[im] * zw[im] - zw[p] * zw[p]));
    T rv = half_g * sc(S_OM_V)[p] *
           ((h[jm] + h[p]) * (zw[jm] - zw[p]) +
            (zw[jm] * zw[jm] - zw[p] * zw[p]));
    if (P.uv_adv) {
      const T* UFx = sc(S_UFX);
      const T* UFe = sc(S_UFE);
      const T* VFx = sc(S_VFX);
      const T* VFe = sc(S_VFE);
      ru = ru - (UFx[p] - UFx[im]) - (UFe[jp] - UFe[p]);
      rv = rv - (VFx[ip] - VFx[p]) - (VFe[p] - VFe[jm]);
    }
    if (P.uv_cor) {
      ru = ru + T(0.5) * (sc(S_UFXC)[p] + sc(S_UFXC)[im]);
      rv = rv - T(0.5) * (sc(S_VFEC)[p] + sc(S_VFEC)[jm]);
    }
    if (P.curvgrid && P.uv_adv) {
      ru = ru + T(0.5) * (sc(S_CV)[p] + sc(S_CV)[im]);
      rv = rv - T(0.5) * (sc(S_CU)[p] + sc(S_CU)[jm]);
    }
    if (P.uv_vis2) {
      const T* UFxv = sc(S_UFXV);
      const T* VFev = sc(S_VFEV);
      const T* UFev = sc(S_UFEV);
      const T* VFxv = sc(S_VFXV);
      ru = ru + T(0.5) * (pn[im] + pn[p]) * (UFxv[p] - UFxv[im]) +
           T(0.5) * (pm[im] + pm[p]) * (UFev[jp] - UFev[p]);
      rv = rv + T(0.5) * (pn[jm] + pn[p]) * (VFxv[ip] - VFxv[p]) -
           T(0.5) * (pm[jm] + pm[p]) * (VFev[p] - VFev[jm]);
    }

    const T* Zs;   // zeta at the kstp level
    const T* Us;
    const T* Vs;
    T du, dv;
    if (mode == FE_PRED) {
      const T ruc = A.frc[RUFRC][p] - ru;
      const T rvc = A.frc[RVFRC][p] - rv;
      A.rufrc_c[p] = ruc;
      A.rvfrc_c[p] = rvc;
      ru = ru + T(P.w_now) * ruc - T(P.w_m1) * A.frc[RU0_NM1][p] +
           T(P.w_m2) * A.frc[RU0_NM2][p];
      rv = rv + T(P.w_now) * rvc - T(P.w_m1) * A.frc[RV0_NM1][p] +
           T(P.w_m2) * A.frc[RV0_NM2][p];
      du = T(0.5 * P.dtfast) * ru;
      dv = T(0.5 * P.dtfast) * rv;
      Zs = fs[ZETA_N];
      Us = fs[UBAR_N];
      Vs = fs[VBAR_N];
    } else if (mode == LF_PRED) {
      ru = ru + A.rufrc_c[p];
      rv = rv + A.rvfrc_c[p];
      du = T(P.dtfast) * ru;
      dv = T(P.dtfast) * rv;
      Zs = fs[ZETA_NM1];
      Us = fs[UBAR_NM1];
      Vs = fs[VBAR_NM1];
    } else {
      ru = ru + A.rufrc_c[p];
      rv = rv + A.rvfrc_c[p];
      du = T(0.5 * P.dtfast * 5.0 / 12.0) * ru +
           T(0.5 * P.dtfast * 8.0 / 12.0) * fs[RUBAR_N][p] -
           T(0.5 * P.dtfast * 1.0 / 12.0) * fs[RUBAR_NM1][p];
      dv = T(0.5 * P.dtfast * 5.0 / 12.0) * rv +
           T(0.5 * P.dtfast * 8.0 / 12.0) * fs[RVBAR_N][p] -
           T(0.5 * P.dtfast * 1.0 / 12.0) * fs[RVBAR_NM1][p];
      Zs = fs[ZETA_N];
      Us = fs[UBAR_N];
      Vs = fs[VBAR_N];
    }
    if (mode != CORR) {  // the predictor's rhs becomes the new history
      fs[RUBAR_NM1][p] = fs[RUBAR_N][p];
      fs[RUBAR_N][p] = ru;
      fs[RVBAR_NM1][p] = fs[RVBAR_N][p];
      fs[RVBAR_N][p] = rv;
    }
    // _step_momentum
    const T* Dn = sc(S_DNEW);
    const T Dsp = Zs[p] + h[p];
    sc(S_URAW)[p] = (Us[p] * (Dsp + (Zs[im] + h[im])) +
                     (pm[p] + pm[im]) * (pn[p] + pn[im]) * du) /
                    (Dn[p] + Dn[im]) * gr(G_UMASK)[p];
    sc(S_VRAW)[p] = (Vs[p] * (Dsp + (Zs[jm] + h[jm])) +
                     (pm[p] + pm[jm]) * (pn[p] + pn[jm]) * dv) /
                    (Dn[p] + Dn[jm]) * gr(G_VMASK)[p];
  }

  // ubar/vbar BCs, and (corrector) the time-level rotation (phase E)
  __device__ void uv_bcs(int p, Mode mode) const {
    const Geom& g = P.g;
    const int j = p / g.Nx, i = p - (p / g.Nx) * g.Nx;
    const T gamma2 = T(P.gamma2);
    const T ub = u_bc_fill(g, P.bu, gamma2, sc(S_URAW), gr(G_UMASK), j, i);
    const T vb = v_bc_fill(g, P.bv, gamma2, sc(S_VRAW), gr(G_VMASK), j, i);
    if (mode != CORR) {
      sc(S_UP)[p] = ub;
      sc(S_VP)[p] = vb;
      return;
    }
    T* const* fs = A.fs;
    fs[ZETA_NM1][p] = fs[ZETA_N][p];
    fs[ZETA_N][p] = sc(S_ZNBC)[p];
    fs[UBAR_NM1][p] = fs[UBAR_N][p];
    fs[UBAR_N][p] = ub;
    fs[VBAR_NM1][p] = fs[VBAR_N][p];
    fs[VBAR_N][p] = vb;
  }

  __device__ void final_fill(int p) const {
    const int j = p / P.g.Nx, i = p - (p / P.g.Nx) * P.g.Nx;
    T* const* fs = A.fs;
    fs[ZT_AVG1][p] = fill(P.g, sc(S_A0), j, i);
    fs[DU_AVG1][p] = fill(P.g, sc(S_A1), j, i);
    fs[DV_AVG1][p] = fill(P.g, sc(S_A2), j, i);
    fs[DU_AVG2][p] = fill(P.g, sc(S_A3), j, i);
    fs[DV_AVG2][p] = fill(P.g, sc(S_A4), j, i);
  }
};

#define ROMS_FOR_POINTS(p) \
  for (int p = threadIdx.x; p < f.S; p += blockDim.x)

// One substep half: predictor (FE or LF) or corrector, five phases.
template <typename T>
__device__ void half_step(const Fast<T>& f, Mode mode, T cff1, T cff2) {
  T* const* fs = f.A.fs;
  const bool pred = mode != CORR;
  const T* Z = pred ? fs[ZETA_N] : f.sc(S_ZP);
  const T* U = pred ? fs[UBAR_N] : f.sc(S_UP);
  const T* V = pred ? fs[VBAR_N] : f.sc(S_VP);
  ROMS_FOR_POINTS(p) f.depth(p, mode, Z, U, V, cff1, cff2);
  __syncthreads();
  ROMS_FOR_POINTS(p) f.zeta_update(p, mode, U, V);
  __syncthreads();
  ROMS_FOR_POINTS(p) f.fluxes(p, mode, U, V);
  __syncthreads();
  ROMS_FOR_POINTS(p) f.momentum(p, mode);
  __syncthreads();
  ROMS_FOR_POINTS(p) f.uv_bcs(p, mode);
  __syncthreads();
}

constexpr int kFastThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kFastThreads)
    fast_loop_kernel(FastParams P, FastPtrs<T> A) {
  const Fast<T> f{P, A, P.g.Ny * P.g.Nx};
  const T* w1 = A.w1;
  const T* w2 = A.w2;
  ROMS_FOR_POINTS(p) f.metrics(p);
  __syncthreads();

  // fast step 1: forward-Euler predictor, then the first corrector
  half_step(f, FE_PRED, T(0), T(-1.0 / 12.0) * w2[1]);
  half_step(f, CORR, T(0), w2[0]);
  // fast steps 2..nfast: leapfrog predictor, AM3 corrector
  for (int it = 2; it <= P.nfast; ++it) {
    half_step(f, LF_PRED, w1[it - 2],
              T(8.0 / 12.0) * w2[it - 1] - T(1.0 / 12.0) * w2[it]);
    half_step(f, CORR, T(0), T(5.0 / 12.0) * w2[it - 1]);
  }
  // auxiliary step iif = nfast+1: averages only
  const int it = P.nfast + 1;
  const T cff1 = w1[it - 2];
  const T cff2 = T(8.0 / 12.0) * w2[it - 1] - T(1.0 / 12.0) * w2[it];
  ROMS_FOR_POINTS(p)
      f.depth(p, AUX, A.fs[ZETA_N], A.fs[UBAR_N], A.fs[VBAR_N], cff1, cff2);
  __syncthreads();
  ROMS_FOR_POINTS(p) f.final_fill(p);
}

#undef ROMS_FOR_POINTS

}  // namespace roms
