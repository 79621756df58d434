"""Smoke run of roms_tpu_torch on one CUDA card: builds the kernels, checks
each against its plain PyTorch version, drives the UPWELLING and the
BENCHMARK1 steps through them, and checks the results.

    python3 chip_smoke.py
    python3 chip_smoke.py --column-times TREE [KERNEL ...]
                                                 # rows 1-4 and 6-10's
                                                 # times only (or the
                                                 # KERNELs'),
                                                 # roms_tpu_torch from TREE
    python3 chip_smoke.py --regional             # the build and phase 13
    python3 chip_smoke.py --regional-long        # the same, with
                                                 # ESTUARY_TEST's and
                                                 # RIVERPLUME1's signatures
    python3 chip_smoke.py --coastal              # the build and phase 14
    python3 chip_smoke.py --operators            # the build and phase 15
    python3 chip_smoke.py --cases2               # the build and phase 16
    python3 chip_smoke.py --cases2-long          # the same, with the
                                                 # physics checks over a
                                                 # minute
    python3 chip_smoke.py --sediment             # the build and phase 17
    python3 chip_smoke.py --sediment-long        # the same, with
                                                 # SED_TEST1's 400 steps
    python3 chip_smoke.py --biology              # the build and phase 18
    python3 chip_smoke.py --forward              # the build and phase 19
    python3 chip_smoke.py --forward-long         # the same, with
                                                 # SHOREFACE's 400 steps
    python3 chip_smoke.py --fourdvar             # the build and phase 20
    python3 chip_smoke.py --nesting-parallel     # the build and phase 21
    python3 chip_smoke.py --nesting-parallel-long
                                                 # the same, with the
                                                 # composite contact's
                                                 # 120 steps

Phases, one or more lines each; any failure exits non-zero:
  1. device: card name and power limit (nvidia-smi), torch and CUDA versions;
  2. kernel build (nvcc, sm_90a, one process per source) and its time;
  3. each kernel against its plain version on the arguments the main path
     gives it (one step of full-size UPWELLING from a developed state), in
     float64 and float32, plus the branches the main path does not take
     (eq_tide, KPP/solar terms, the Thomas solve, SPLINES vertical tracer
     advection, JM95 + bvf, closed E-W walls, land points, the curvilinear
     terms, the first step's momentum start; t3dmix2_geo, which UPWELLING
     with tnu2 = 0 does not call, on its tracers and depths): max abs
     error, tolerance (none for the outputs BITWISE holds bitwise), which
     outputs are bitwise equal, whether a second launch on the same input
     is bitwise equal to the first, the time a call of kernel and plain
     version (CUDA events around 10 calls back to back, median of 5 such
     batches; a kernel that updates its arguments in place gets fresh
     copies for each call; for the kernels held bitwise also their device
     time alone, under torch.profiler), and the kernel's bound (bytes and
     operations); the tiles of grid_flux, eos, the tracer kernels,
     prsgrd32, rhs3d, uv_corrector and uv3dmix2 (points, level slots,
     blocks, threads, shared memory, registers, stack frame), omega's
     launch (a thread a column: blocks, threads, registers, stack frame);
     and the fast loop's launch at 128, 256 and 512 threads a block:
     blocks, the co-resident limit, barriers, its time, the time of one
     grid barrier (an empty kernel of as many barriers at the same launch)
     and of one phase, each block size's result bitwise equal to the
     default's;
  4. the main path: 10 float64 steps of full-size UPWELLING through
     stepping.step, with every kernel's launch count (one a step each),
     checked against the pinned anchor (tests/data/upwelling_anchor.npz)
     and against the same steps with the kernels off (cfg.pallas2d=False);
  5. the 5-model-day UPWELLING run: 1440 float32 steps, finite fields,
     volume conservation, the upwelling signature, ms/step;
  6. torch.profiler over 10 float32 steps: launches a step, device busy and
     idle share, device time by kernel, host time by stage.
Then BENCHMARK1 (512x64x30, 2 tracers, DT 150 s, nfast 29), the main path
of the spherical grid, COARE bulk fluxes, KPP and the geopotential tracer
diffusion (queue 2 row 5, t3dmix2_geo):
  7. each of the eleven kernels against its plain version on the arguments
     the BENCHMARK1 step gives it (one step from a state three plain
     float64 steps from rest), in float64 and float32, with the checks,
     times, bounds and fast-loop launches of phase 3; t3dmix2_geo's and
     the tracer kernels' tiles; and t3dmix2_geo with one tracer at tnu2 =
     0, which must come back bitwise unchanged;
  8. three float64 steps from that state with the kernels on against
     cfg.pallas2d=False (every stage plain), each State field the step
     writes within 1e-9 x max|field|;
  9. the small BENCHMARK (64x32x12) with the kernels on against
     tests/data/torch_benchmark_small.npz, at 100x the CPU test's bounds;
 10. 200 float32 steps (8.3 model hours) with the kernels on: ms/step,
     grid-points/s, finite and bounded fields, southern-hemisphere f, an
     eastward mean surface current, one launch a step of every kernel;
 11. torch.profiler over 5 float32 steps, as phase 6.
Then the run driver (`roms_tpu_torch.driver`, its NetCDF streams and
restarts):
 12. UPWELLING through the CLI (`roms_tpu_torch.__main__.main`, 1440 float64
     steps, HIS every 72, a restart every 288, NINFO every 12): exit code,
     one launch a step of each of its ten kernels, 20 finite HIS records
     72 x dt apart, 5 restarts, the last record equal to the last restart
     and upwelling at the wall; the record of step 72 bitwise equal to
     stepping.run's state; the restart of step 288 continued 10 steps by
     Simulation bitwise equal to 298 straight steps, the caller's state and
     stepping.run's input unchanged; a NaN planted in u caught as a
     BlowupError with its final restart; then BENCHMARK1 float32 through
     Simulation (20 steps, AVG and QCK every 10, HIS at 20, NINFO every 10):
     ms/step of stepping.run, of Simulation.run without streams and with
     them, seconds a HIS, AVG and QCK record and a NINFO line take, one
     launch a step of all eleven kernels, the HIS record bitwise equal to
     stepping.run's state, the QCK surface slice, and each AVG record's
     zeta within 10 x 2^-23 x max|zeta| of the mean of its 10 states.
Then the regional cases KELVIN (50x30x10), ESTUARY_TEST (200x3x20) and
RIVERPLUME1 (39x67x13) at their published sizes, whose open boundaries or
river keep rows 8-11 on their plain versions (the general fast loop):
 13. (a) each kernel a case's step launches (rows 1-3, 6, 7; 4 and 5 on
     RIVERPLUME1) against its plain version on that step's arguments
     (three plain float64 steps from rest), float64 and float32, with the
     checks of phase 3 but untimed, and no other kernel called; (b) three
     float64 steps with the kernels on against cfg.pallas2d=False, each
     field within 1e-9 x max|field| (a v-like field against its u-like
     partner's max too), one launch a step of each of its kernels and none
     of the others; (c) the small cases against
     tests/data/torch_regional_small.npz at CARD_FACTOR x the CPU bounds;
     (d) the physics of roms_tpu's case tests in float64: KELVIN after 24
     steps (coastal amplitude over twice the offshore); ESTUARY_TEST after
     60 steps (salt in [-0.5, 30.5]) and RIVERPLUME1 after 24 (u exactly
     0 on masked faces, salt under S0 + 0.5 away from the channel), with
     --regional-long after 720 (6 h: also |zeta| > 0.05, |u| > 0.05) and
     120 (4 h: also salt below S0 - 1 near the source); with ms/step;
     (e) ESTUARY_TEST through the CLI (20 steps, HIS and a restart every
     10): the restart of step 10 +
     10 Simulation steps and 20 straight steps bitwise the restart of step
     20, which holds the GLS fields, and the last HIS record; (f) float32
     ms/step of each case (5 steps) beside (d)'s float64, with its
     launches a step.
Then the coastal path at full size: LAB_CANYON (110x250x25, the polar
annulus of roms_lab_canyon.in, north-south periodic, curvilinear), INLET_TEST
(100x100x8 on a grid file scripts/torch_coastal_fixture.py generates;
wetting-drying, an open-boundary tide, GLS, so rows 7-11 stay plain as
the JAX gates keep them) and BENCHMARK1 with the tide-generating force:
 14. (a) each kernel a case's step launches (rows 1-4 and 6-11 on
     LAB_CANYON; 1-4 and 6 on INLET_TEST; 1-3 and 6-11, prsgrd32 with
     eq_tide, on BENCHMARK1) against its plain version on that step's
     arguments (three plain float64 steps from rest), float64 and
     float32, untimed, and no other kernel called; three float64 steps
     with the kernels on against cfg.pallas2d=False, each field within
     1e-9 x max|field|, one launch a step of each; (b) LAB_CANYON's grid
     written with save_grid and its initial state with HistoryWriter, run
     through the CLI (`case: file`, 20 float64 steps, HIS at 20), the
     record against 20 analytic steps within roms_tpu's 1e-10; (c)
     LAB_CANYON's physics (|u|, |v| < 2e-3 after 20 steps, angler spanning
     (-3, 3), a constant tracer within 2e-5 after 10 steps); (d)
     INLET_TEST's ebb through the throat growing from step 15 to 45, dry
     cells, no total depth below half the critical depth, with ms/step;
     (e) BENCHMARK1 with the tide force: 0 < |u| < 0.5 after 5 steps; (f)
     the small cases and the wet/dry fast loop against
     tests/data/torch_coastal_small.npz at CARD_FACTOR x the CPU bounds;
     and float32 ms/step beside float64 with the launches a step.
Then the operator cases at their published sizes: BASIN (180x140x12,
biharmonic viscosity and diffusion), DOUBLE_GYRE (54x108x4), GRAV_ADJ
(128x4x40, north-south periodic, no Coriolis), CANYON3D (65x48x15),
OVERFLOW (4x128x20, isopycnal diffusion), WINDBASIN (101x52x25, no
momentum advection), CHANNEL_NECK (48x16x8, rotated viscosity) and
SEAMOUNT (49x48x13) under each of the five pressure-gradient schemes:
 15. (a) each kernel a case's step launches (rows 1-3 and 8-11 on all;
     4, 6, 7 as the JAX gates give them) against its plain version on
     that step's arguments (three plain float64 steps from rest),
     float64 and float32, untimed, and no other kernel called, with the
     tiles at GRAV_ADJ's N = 40 and OVERFLOW's Lm = 4; (b) three float64
     steps with the kernels on against cfg.pallas2d=False, each field
     within 1e-9 x max|field|, one launch a step of each of its kernels;
     (c) rows 8 and 9 on BASIN's and UPWELLING's step arguments under the
     advection pairs C2/C2, U1/U1, A4/A4, A4/SPLINES, C2/C4, U3/A4 (and
     U3/C4 to compare), float64 and float32: bitwise their plain
     versions, a second launch bitwise the first, timed with their
     bound; (c') the options no case uses (Smagorinsky viscosity,
     biharmonic diffusion along geopotentials and along isopycnals,
     biharmonic viscosity along geopotentials) on the small UPWELLING,
     kernels on against off over three float64 steps; (d) the physics of
     roms_tpu's case tests at their sizes in float64, with ms/step:
     SEAMOUNT's spurious current under each scheme (< 0.05 m/s after 10
     steps; max|u| after 100), GRAV_ADJ's fronts, DOUBLE_GYRE's spin-up,
     BASIN and CANYON3D finite, OVERFLOW's descent, WINDBASIN's return
     flow, CHANNEL_NECK's flow through the neck; (e) the small cases
     against tests/data/torch_operators_small.npz at CARD_FACTOR x the
     CPU bounds; (f) float32 and float64 ms/step of each case at its
     published size, with its launches a step.
Then KPP double diffusion, the ice shelf, mean age and the 2-D-only step:
CHANNEL (41x25x10), LMD_TEST (10x10x50, doubly periodic), MIXED_LAYER
(10x8x30, GLS with Craig-Banner), TEST_CHAN (100x3x20), RIVERPLUME2
(50x70x13), WEDDELL (300x10x30, the ice shelf) and BL_TEST (39x4x30) at
their published sizes, and SOLITON (96x32, 2-D only, no kernel):
 16. (a) each kernel a case's step launches (rows 1-3 and 6-11 on
     LMD_TEST and MIXED_LAYER, 4 too on CHANNEL; 1-3, 6, 7 on TEST_CHAN,
     RIVERPLUME2 and BL_TEST, whose bry, sources or radiation boundaries
     keep rows 8-11 plain; 2, 4, 6, 7 on WEDDELL, whose ice draft keeps
     rows 1 and 3 plain too) against its plain version on that step's
     arguments (three plain float64 steps from rest), float64 and float32,
     untimed, and no other kernel called, with the tiles at LMD_TEST's N =
     50 and BL_TEST's Mm = 4; (b) three float64 steps with the kernels on
     against cfg.pallas2d=False, each field within 1e-9 x max|field|, one
     launch a step of each of its kernels; (c) the small cases and
     SOLITON's 2-D steps against tests/data/torch_cases2_small.npz at
     CARD_FACTOR x the CPU bounds; (d) the physics of roms_tpu's tests in
     float64, with ms/step: CHANNEL's jet after 35 steps, LMD_TEST's
     boundary layer at N = 30 after 240, the DDMIX unit check, MIXED_LAYER's
     Craig-Banner tke and mixed layer after 240, WEDDELL's closed cavity at
     rest after 20, SOLITON at rest, its volume and its westward drift
     after 400, AGE_MEAN on a 4-tracer UPWELLING after 3; with
     --cases2-long also TEST_CHAN's flume flow after 300, RIVERPLUME2's
     plume and current after 120, WEDDELL's tide in the cavity after 500
     at Lm = 150 and BL_TEST's boundary layer and jet after 120; (e)
     LMD_TEST through the
     CLI (20 steps, HIS and a restart every 10): the restart of step 10 +
     10 Simulation steps and 20 straight steps bitwise the restart of step
     20, which holds hsbl and hbbl; `run --case soliton` exits 2; (f)
     float32 and float64 ms/step of each case at its published size with
     its launches a step, and SOLITON's.
Then the sediment family: SED_TOY (8x10x10, UPWELLING with a sediment
class), LAKE_SIGNELL (100x20x8: MPDATA, GLS, the SSW bottom boundary
layer, sand) and SED_TEST1 (100x12x10: MY2.5, HSIMT sand, open ends) at
their published sizes:
 17. (a) each kernel a case's step launches (rows 1-4, 6-11 on SED_TOY,
     whose tracer kernels carry its sediment class; 1-3, 6, 7, 10, 11 on
     LAKE_SIGNELL, whose MPDATA keeps rows 8-9 plain; 1-3, 6, 7 on
     SED_TEST1, whose open ends keep rows 8-11 plain) against its plain
     version on that step's arguments, float64 and float32, untimed, and
     no other kernel called; (b) three float64 steps with the kernels on
     against cfg.pallas2d=False, each field within 1e-12 x max|field|, one
     launch a step of each of its kernels; (c) the small cases (SED_TOY
     without a BBL, under SSW, MB and SG waves, with Soulsby's bedload and
     with SED_MORPH; LAKE_SIGNELL; SED_TEST1) against
     tests/data/torch_sediment_small.npz at CARD_FACTOR x the CPU bounds;
     (d) roms_tpu's physics checks in float64, with ms/step: SED_TOY's
     sediment conserved to 1e-8 over 30 steps while it deposits, its
     resuspension under SSW waves (and none without), SED_MORPH's
     deepening, LAKE_SIGNELL at rest for 120 steps at 50x10; with
     --sediment-long also SED_TEST1's bottom-heavy sand after 400 steps at
     Lm = 40; (e) LAKE_SIGNELL through the CLI (20 steps, HIS and a
     restart every 10), the restart, which holds the bed and the BBL
     memory, bitwise the straight run; (f) float32 and float64 ms/step of
     each case with its launches a step.
Then biology: BIO_TOY (10x12x12, NPZD Powell on 6 tracers) and seven more
models on UPWELLING's 41x80x16 (models/bio_toy.SETUPS: Franks, iron,
Fennel with oxygen and carbon, hypoxia with a respiration field, NEMURO,
the red tide with a cyst map and DIN, EcoSim on 22 tracers):
 18. (a) each kernel a case's step launches (rows 1-4, 6-11 on every case:
     the tracer kernels carry the bio tracers, 22 on EcoSim, whose tiles
     are printed) against its plain version on that step's arguments,
     float64 and float32, untimed, and no other kernel called; (b) three
     float64 steps of BIO_TOY and five of each model with the kernels on
     against cfg.pallas2d=False, each field within 1e-12 x max|field|
     (each tracer against its own max), one launch a step of each of its
     kernels; (c) the small BIO_TOY, Fennel and EcoSim steps against
     tests/data/torch_biology_small.npz at CARD_FACTOR x the CPU bounds,
     and each model's source term on the card against the CPU's and
     roms_tpu's stored output; (d) roms_tpu's BIO_TOY checks (40 steps
     conserve nitrogen to 1e-9 while the bloom grows, 30 steps with wDet
     = 80 m/day export monotonically) and the models' runs of (b) finite,
     EcoSim's PhyC1 positive; (e) examples/bio_toy.yaml through the CLI in
     a temporary directory, and BIO_TOY through the CLI with restarts,
     bitwise a straight run; (g) rows 8 and 9 on EcoSim's 22-tracer
     arguments and row 5 on them with tnu2 = 500 m2/s for all 22, bitwise,
     timed with their bounds; (f) float32 and float64 ms/step of each case
     with its launches a step.
Then the last branches of the forward model: FLT_TEST (14x12x4, the
stresses as body forces, floats), SHOREFACE (59x7x20, the Mellor05
radiation stress with the Stokes drift, wet/dry, GLS, the SSW layer,
sand) and the budget diagnostics on UPWELLING (41x80x16):
 19. (a) each kernel a case's step launches (rows 1-3, 6-11 on FLT_TEST,
     row 7 with its BODYFORCE branch; 2, 6, 7 on SHOREFACE, whose active
     radiation stress keeps 1 and 3 plain and whose bry and wet/dry keep
     8-11 plain) against its plain version, float64 and float32,
     untimed; (b) three float64 steps kernels on against off, within
     1e-12 x max|field| (SHOREFACE's wall fields within roms_tpu's own
     one-ulp spread there); (c) the small FLT_TEST with floats, SHOREFACE
     under Mellor05 and Mellor08 and UPWELLING's budget dict against
     tests/data/torch_forward_small.npz at CARD_FACTOR x the CPU bounds;
     (d) roms_tpu's float check (40 steps: the floats stay in the basin
     and move), SHOREFACE finite over 20 steps and, with --forward-long,
     its wave setup after 400; (e) FLT_TEST through the CLI with restarts,
     bitwise a straight run; (g) the budgets on UPWELLING: rows 7-9 off,
     rate the sum of the terms, the state unchanged, the DIA stream
     through the CLI; (h) row 7 under BODYFORCE on UPWELLING's arguments,
     bitwise but the column sums, timed with its bound beside the launch
     without it, and both kernels' registers; (f) float32 and float64
     ms/step of each case with its launches a step.
Then the tangent-linear and adjoint step and the 4D-Var drivers (obs.py,
fourdvar.py), float64:
 20. (a) UPWELLING 41x80x16, 5 steps in: the TLM (fourdvar.Linearization,
     the drivers' jvp from two vjps, on the plain path) against finite
     differences of the nonlinear step with the kernels on (eps 1e-4 and
     1e-5, the error below 1e-2 and falling), the adjoint symmetry <J dx,
     dy> = <dx, J^T dy> at 1e-10, the launches by row of each run (rows
     1-4 and 6-11 once a nonlinear step, none in a linearized run), and
     the ms of a nonlinear step kernels on and plain, of the recorded
     linearized step, of a TLM and an ADM step and of torch.func.jvp /
     vjp of fourdvar.step_map; (b) the eos wrapper on CUDA tensors under
     torch.func.vjp and on one that requires grad, and the uv3dmix2
     wrapper (which checks its arguments' aliasing by pointer) under
     torch.func.vjp, must raise their RuntimeError; (c) the one-step TLM and ADM, the small BENCHMARK's
     TLM, the I4D-Var, RBL4D-Var and R4D-Var twins, the wind-stress and
     FracObs twins and the bry control from roms_tpu's observations, and
     the port's own truth runs, against tests/data/torch_fourdvar_small.npz
     at CARD_FACTOR x the CPU bounds; (d) roms_tpu's 4D-Var checks on
     those runs (tests/test_fourdvar.py, tests/test_obs.py); (e) an
     I4D-Var twin at 41x80x16 (SST at step 2 over the interior, 5 CG
     iterations): Jo before and after, the CG residuals, the seconds, Jo
     falling and everything finite.
Then refinement and composite nesting (nesting.py), the blocked
decomposition (parallel/) and sharded output (io/pio.py), float64:
 21. (a) UPWELLING 41x80x16 with a refined patch over parent cells 10-19 x
     30-39 at factor 3 (30x30x16, dt 100 s; two_way, conserve,
     flux_coupling), 2 nested steps with the kernels on against
     cfg.pallas2d=False on both grids, each field within 1e-9 x
     max|field|; the launches by row of the parent's steps (rows 1-4 and
     6-11 once a step) and of the fine grid's (none of rows 8-11: its bry);
     the ms of a nested step; (b) the small nested and composite runs and
     the blocked UPWELLING runs (2 x 4 blocks, 26 x 26 on uneven ones)
     against tests/data/torch_nesting_small.npz at CARD_FACTOR x the CPU
     bounds, and roms_tpu's nesting checks (rest and constancy, the contact
     flux, volume conservation with the flux coupling; with
     --nesting-parallel-long the transparent composite contact over 120
     steps); (c) BENCHMARK1 512x64x30 from the state three plain steps from
     rest, 2 steps on 2 x 4 blocks in process against one block with the
     kernels off, each field within 1e-11 x max|field|, no kernel launched
     by the blocked run, ms/step of both; (d) the blocked run's sharded
     history assembled equal to the HistoryWriter records of its unblocked
     states, bitwise.
The last two lines are a JSON object of per-kernel results (BENCHMARK1
float32, launches of phase 10) and a JSON object {"ok": true, "device":
{...}}.  Without CUDA it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ANCHOR = os.path.join(ROOT, "tests", "data", "upwelling_anchor.npz")
BENCH_FIXTURE = os.path.join(ROOT, "tests", "data",
                             "torch_benchmark_small.npz")
REGIONAL_FIXTURE = os.path.join(ROOT, "tests", "data",
                                "torch_regional_small.npz")
OPERATORS_FIXTURE = os.path.join(ROOT, "tests", "data",
                                 "torch_operators_small.npz")
COASTAL_FIXTURE = os.path.join(ROOT, "tests", "data",
                               "torch_coastal_small.npz")
CASES2_FIXTURE = os.path.join(ROOT, "tests", "data",
                              "torch_cases2_small.npz")
SEDIMENT_FIXTURE = os.path.join(ROOT, "tests", "data",
                                "torch_sediment_small.npz")
BIOLOGY_FIXTURE = os.path.join(ROOT, "tests", "data",
                               "torch_biology_small.npz")
FORWARD_FIXTURE = os.path.join(ROOT, "tests", "data",
                               "torch_forward_small.npz")
# kernels-on against kernels-off over three full-size BENCHMARK1 float64
# steps, relative to max|field|
BENCH_EQUIV_RTOL = 1e-9
BENCH_STEPS = 200

# tests/test_anchor.py:47-66 bounds; the card runs them at 100x (nvcc's
# operation order is kept with --fmad=false, but the card's column sums
# and cumsums run in another order than the CPU's)
ANCHOR_ATOL = {"zeta": 1e-12, "u": 1e-13, "v": 1e-13, "temp": 1e-10}
CARD_FACTOR = 100.0
# kernel against plain version, relative to max|field|: one pass of
# round-off, except the fast loop, which compounds it over nfast substeps
KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-5}
FAST_RTOL = {"float64": 1e-10, "float32": 1e-4}
# kernels held to their plain versions bitwise: the outputs that have no
# column sum in another order than torch's (None: every output); rhs3d's
# and uv3dmix2's rufrc and rvfrc and grid_flux's W are column sums
BITWISE = {"tracer_predictor": None, "tracer_corrector": None,
           "t3dmix2_geo": None, "prsgrd32": None, "rhs3d": (0, 1, 4, 5),
           "uv3dmix2": (0, 1), "grid_flux": (0, 1, 2, 3, 4),
           "eos": (0, 1, 2)}
# kernels that update arguments in place: each timed call gets fresh copies
IN_PLACE = ("uv3dmix2", "t3dmix2_geo")
NRUNS, NBATCH = 10, 5
# the fast loop's block sizes that phases 3 and 7 time
FAST_THREADS_SWEEP = (128, 256, 512)
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bandwidth, and the
# non-tensor-core rate of each type (the kernels use no tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}


def _reads_all(*fields):
    """Reads every tensor among its arguments, and these grid fields."""
    return lambda g, a, kw: tensors_of(list(a) + list(kw.values())) + \
        [getattr(g, f) for f in fields]


def _reads_eos(g, a, kw):
    """eos(cfg, t, z_r, z_w, want_bvf): salinity where the density takes
    it, z_r for JM95 or bvf, z_w for JM95 with bvf."""
    cfg, t, z_r, z_w = a[:4]
    bvf, jm95 = kw.get("want_bvf", False), cfg.eos == "jm95"
    salt = cfg.ntracers >= 2 and (jm95 or cfg.Scoef != 0.0)
    return [t[:2] if salt else t[0]] + ([z_r] if jm95 or bvf else []) + \
        ([z_w] if jm95 and bvf else [])


def _reads_prsgrd32(g, a, kw):
    """prsgrd32(cfg, grid, rho, z_r, z_w, Hz, eq_tide): z_w's surface plane
    only."""
    rho, z_r, z_w, Hz = a[2:6]
    tide = kw.get("eq_tide")
    return [rho, z_r, z_w[-1], Hz, g.pm, g.pn] + \
        ([tide] if tide is not None else [])


def _reads_tracer_predictor(g, a, kw):
    """tracer_predictor(cfg, grid, iic, t, t_prev, Hz, Huon, Hvom, W, Akt,
    stflx, btflx, srflx=, ghats=, swdk_w=): Akt and ghats for the KPP
    nonlocal flux only, srflx and swdk_w for shortwave only, each at the
    interior w levels."""
    t, t_prev, Hz, Huon, Hvom, W, Akt, stflx, btflx = a[3:12]
    out = [t, t_prev, Hz, Huon, Hvom, W, stflx, btflx, g.pm, g.pn]
    ghats = kw.get("ghats")
    if ghats is not None:
        out += [Akt[:, 1:-1], ghats[:, 1:-1]]
    if kw.get("srflx") is not None and kw.get("swdk_w") is not None:
        out += [kw["srflx"], kw["swdk_w"][1:-1]]
    return out


def _reads_tracer_corrector(g, a, kw):
    """tracer_corrector(cfg, grid, t_nnew, t3, Huon, Hvom, W, Hz_new,
    z_r_new, Akt): z_r_new for the Thomas solve only."""
    cfg, _, t_nnew, t3, Huon, Hvom, W, Hz_new, z_r_new, Akt = a[:10]
    return [t_nnew, t3, Huon, Hvom, W, Hz_new, Akt, g.pm, g.pn] + \
        ([] if cfg.splines_vdiff else [z_r_new])


def _reads_rhs3d(g, a, kw):
    """rhs3d(cfg, grid, u, v, Huon, Hvom, W, Hz, ru, rv, sustr, svstr,
    bustr, bvstr, start=): the mass fluxes and W's interior levels with
    advection, f with Coriolis, dndx and dmde with the curvilinear terms,
    and the AB3 history with the start."""
    cfg = a[0]
    u, v, Huon, Hvom, W, Hz, ru, rv = a[2:10]
    out = [u, v, Hz, ru, rv, *a[10:14], g.pm, g.pn]
    if cfg.uv_adv:
        out += [Huon, Hvom, W[1:-1]]
    if cfg.uv_cor:
        out.append(g.f)
    if cfg.curvgrid and cfg.uv_adv:
        out += [g.dndx, g.dmde]
    if kw.get("start") is not None:
        out += list(kw["start"][2:])
    return out


def _geo_active(cfg):
    return [k for k in range(cfg.ntracers)
            if k < len(cfg.tnu2) and cfg.tnu2[k] != 0.0]


def _reads_t3dmix2_geo(g, a, kw):
    """t3dmix2_geo(cfg, grid, t, Hz, z_r, t_nnew, dt): t and t_nnew of the
    tracers with tnu2 != 0 only."""
    cfg, _, t, Hz, z_r, t_nnew = a[:6]
    act = _geo_active(cfg)
    return [t[act], t_nnew[act], Hz, z_r, g.pm, g.pn]


def _reads_uv_corrector(g, a, kw):
    """uv_corrector(cfg, grid, iic, u_nnew, v_nnew, ru, rv, Hz_new, Akv,
    DU_avg1, DV_avg1, DU_avg2, DV_avg2, Huon_old, Hvom_old): Akv for the
    spline vertical viscosity only."""
    cfg = a[0]
    ins = list(a[3:15])
    if not cfg.splines_vvisc:
        del ins[5]
    return ins + [g.pm, g.pn, g.umask, g.vmask]


# kernel -> (source, TPU kernel it replaces, reads(grid, args, kwargs):
# the inputs, or parts of them, that its call on these arguments must read)
KERNELS = {
    "grid_flux": ("roms_tpu_torch/csrc/diag.cu",
                  "roms_tpu/ops/diag_pallas.py:53",
                  _reads_all("h", "pm", "pn", "sc_r", "Cs_r", "sc_w",
                             "Cs_w")),
    "eos": ("roms_tpu_torch/csrc/diag.cu", "roms_tpu/ops/diag_pallas.py:108",
            _reads_eos),
    "omega": ("roms_tpu_torch/csrc/diag.cu",
              "roms_tpu/ops/diag_pallas.py:144", _reads_all()),
    "fast_loop": ("roms_tpu_torch/csrc/fast_loop.cu",
                  "roms_tpu/ops/step2d_pallas.py:260",
                  _reads_all("h", "f", "pm", "pn", "dndx", "dmde", "rmask",
                             "umask", "vmask", "pmask")),
    "prsgrd32": ("roms_tpu_torch/csrc/prsgrd.cu",
                 "roms_tpu/ops/prsgrd_pallas.py:63", _reads_prsgrd32),
    "rhs3d": ("roms_tpu_torch/csrc/rhs3d.cu",
              "roms_tpu/ops/rhs3d_pallas.py:60", _reads_rhs3d),
    "uv3dmix2": ("roms_tpu_torch/csrc/mix3d.cu",
                 "roms_tpu/ops/mix3d_pallas.py:114",
                 _reads_all("pm", "pn", "pmask")),
    "t3dmix2_geo": ("roms_tpu_torch/csrc/mix3d.cu",
                    "roms_tpu/ops/mix3d_pallas.py:78", _reads_t3dmix2_geo),
    "tracer_predictor": ("roms_tpu_torch/csrc/step3d.cu",
                         "roms_tpu/ops/step3d_pallas.py:116",
                         _reads_tracer_predictor),
    "uv_corrector": ("roms_tpu_torch/csrc/step3d.cu",
                     "roms_tpu/ops/step3d_pallas.py:220",
                     _reads_uv_corrector),
    "tracer_corrector": ("roms_tpu_torch/csrc/step3d.cu",
                         "roms_tpu/ops/step3d_pallas.py:301",
                         _reads_tracer_corrector),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def wrappers():
    """{kernel name: (module, wrapper attribute, plain version)}."""
    from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, prsgrd_cuda, \
        rhs3d_cuda, step2d_cuda, step3d_cuda
    return {
        "grid_flux": (diag_cuda, "grid_flux", diag_cuda.grid_flux_plain),
        "eos": (diag_cuda, "eos", diag_cuda.eos_plain),
        "omega": (diag_cuda, "omega", diag_cuda.omega_plain),
        "fast_loop": (step2d_cuda, "fast_loop", step2d_cuda.fast_loop_plain),
        "prsgrd32": (prsgrd_cuda, "prsgrd32", prsgrd_cuda.prsgrd32_plain),
        "rhs3d": (rhs3d_cuda, "rhs3d", rhs3d_cuda.rhs3d_plain),
        "uv3dmix2": (mix3d_cuda, "uv3dmix2", mix3d_cuda.uv3dmix2_plain),
        "t3dmix2_geo": (mix3d_cuda, "t3dmix2_geo",
                        mix3d_cuda.t3dmix2_geo_plain),
        "tracer_predictor": (step3d_cuda, "tracer_predictor",
                             step3d_cuda.tracer_predictor_plain),
        "uv_corrector": (step3d_cuda, "uv_corrector",
                         step3d_cuda.uv_corrector_plain),
        "tracer_corrector": (step3d_cuda, "tracer_corrector",
                             step3d_cuda.tracer_corrector_plain),
    }


@contextlib.contextmanager
def patched(sites, wrap):
    """Replace each (module, attribute) of `sites` by wrap(name, original)
    for the duration; restore them after."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in sites]
    try:
        for mod, attr, fn in saved:
            # wraps() copies `launches`, which a wrapper increments through
            # its module's name for it
            setattr(mod, attr, functools.wraps(fn)(wrap(attr, fn)))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def fresh(args):
    """`args` with every tensor among them cloned, a Fast2DState field by
    field (the fast-loop and uv3dmix2 kernels update their fields in
    place); a tensor passed twice stays one tensor."""
    import torch
    from roms_tpu_torch.ops.step2d import Fast2DState
    memo = {}

    def copy(a):
        if isinstance(a, torch.Tensor):
            return memo.setdefault(id(a), a.clone())
        if isinstance(a, Fast2DState):
            return dataclasses.replace(a, **{
                f.name: copy(getattr(a, f.name))
                for f in dataclasses.fields(a)})
        return a
    return tuple(copy(a) for a in args)


def captured_calls(cfg, grid, state, ffn):
    """The arguments each kernel wrapper receives in one kernels-on step
    from `state`: {name: (args, kwargs)}."""
    from roms_tpu_torch import stepping
    calls = {}

    def record(name, fn):
        def call(*args, **kw):
            calls[name] = (fresh(args), kw)
            return fn(*args, **kw)
        return call

    sites = [(mod, attr) for mod, attr, _ in wrappers().values()]
    with patched(sites, record):
        stepping.step(cfg, grid, state, ffn)
    return calls


_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt",
          "rsqrt", "exp", "log", "pow", "abs", "maximum", "minimum", "clamp",
          "clamp_min", "clamp_max", "where", "gt", "lt", "ge", "le", "eq",
          "ne", "sin", "cos", "tanh", "sign", "addcmul", "addcdiv", "floor"}
_REDUCE = {"sum", "cumsum", "mean", "amax", "amin"}


def count_ops(fn, args, kw) -> int:
    """Arithmetic operations the plain version performs on these inputs:
    the elements of every arithmetic aten op's output (of its input for a
    reduction), counted under a TorchDispatchMode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, a=(), k=None):
            out = func(*a, **(k or {}))
            name = func._overloadpacket.__name__.rstrip("_")
            if name in _REDUCE:
                Counter.ops += a[0].numel()
            elif name in _ARITH:
                Counter.ops += max((t.numel() for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor)),
                                   default=0)
            return out

    with Counter():
        fn(*fresh(args), **kw)
    return Counter.ops


def tensors_of(x):
    """The tensors in an argument or result (Fast2DState fields, tuple
    items), for the byte count."""
    import torch
    from roms_tpu_torch.ops.step2d import Fast2DState
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, Fast2DState):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for a in x for t in tensors_of(a)]
    return []


def bound(name, grid, args, kw, outs, ops, dtype):
    """(bound_ms, bound_by): the larger of the bytes the kernel must move
    (each input read once, each output written once) over the card's
    bandwidth, and its operations over the card's peak rate.  The inputs
    are the parts that KERNELS says this call reads, each counted once."""
    ins = KERNELS[name][2](grid, args, kw)
    unique = {(t.data_ptr(), t.shape): t for t in ins}
    nbytes = sum(t.numel() * t.element_size() for t in unique.values())
    if name == "t3dmix2_geo":       # writes the mixed tracers only
        outs = outs[_geo_active(args[0])]
    nbytes += sum(t.numel() * t.element_size() for t in tensors_of(outs))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def arg_sets(args, per_call):
    """The arguments of NRUNS calls, made before they are timed: a fresh
    copy for each call (per_call: the kernel updates them in place), else
    one copy for all.  A fast loop runs again on the state it updated,
    which is the same work."""
    if per_call:
        return [fresh(args) for _ in range(NRUNS)]
    return [fresh(args)] * NRUNS


def device_ms(fn, args, kw, per_call=False) -> float:
    """fn's time a call on the card: CUDA events around NRUNS calls back
    to back, after two warm-up calls; the median over NBATCH such batches,
    so that a stall of the shared host in one batch does not count."""
    import torch
    for a in arg_sets(args, per_call)[:2]:
        fn(*a, **kw)
    batches = []
    for _ in range(NBATCH):
        sets = arg_sets(args, per_call)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in sets:
            fn(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        batches.append(start.elapsed_time(end) / NRUNS)
    return sorted(batches)[NBATCH // 2]


def profiled_ms(fn, args, kw, per_call=False) -> float:
    """The device time of a call of fn: torch.profiler over NRUNS calls,
    the sum of the device events that start inside a `record_function`
    window around them over NRUNS.  The profiler can miss the first
    launches of a session, so two untimed calls run in it first; a batch
    whose events are not the same whole number a call runs again, at most
    three times in all, else nan.  Unlike device_ms it leaves out the
    host's time between launches."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    window = "profiled_ms"
    for a in arg_sets(args, per_call)[:2]:
        fn(*a, **kw)
    for _ in range(3):
        warm = arg_sets(args, per_call)[:2]
        sets = arg_sets(args, per_call)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            for a in warm:
                fn(*a, **kw)
            torch.cuda.synchronize()
            with record_function(window):
                for a in sets:
                    fn(*a, **kw)
                torch.cuda.synchronize()
        events = prof.events()
        t0 = min((e.time_range.start for e in events if e.name == window),
                 default=None)
        us = [e.time_range.elapsed_us() for e in events
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and e.name != window and t0 is not None
              and e.time_range.start >= t0]
        if us and len(us) % NRUNS == 0:
            return sum(us) / NRUNS / 1e3
    return float("nan")


def max_err(outs_k, outs_p, rtol, exact=()):
    """(max abs error, worst error/tolerance, the indices of the outputs
    that are bitwise equal) over paired outputs, each held to rtol *
    max|plain field| but those of index `exact`, held bitwise (the worst
    ratio over the others only)."""
    worst_abs, worst_ratio, equal = 0.0, 0.0, []
    pairs = zip(tensors_of(outs_k), tensors_of(outs_p))
    for n, (a, b) in enumerate(pairs):
        err = (a - b).abs().max().item()
        worst_abs = max(worst_abs, err)
        if err == 0.0:
            equal.append(n)
        if n not in exact:
            tol = rtol * max(b.abs().max().item(), 1e-30)
            worst_ratio = max(worst_ratio, err / tol)
    return worst_abs, worst_ratio, equal


def variants(cfg, grid, calls):
    """Cases beyond the main path's arguments: (label, kernel, args, kw)."""
    import numpy as np
    import torch
    from roms_tpu_torch.config import LBC
    rng = np.random.default_rng(7)
    like = dict(dtype=grid.h.dtype, device=grid.h.device)
    s2 = tuple(grid.h.shape)
    sw = (cfg.N + 1,) + s2

    def rand(shape, scale):
        return torch.tensor(scale * rng.standard_normal(shape), **like)

    out = [(name, name, args, kw) for name, (args, kw) in calls.items()]
    args, kw = calls["eos"]
    out.append(("eos[jm95+bvf]", "eos",
                (args[0].replace(eos="jm95"),) + args[1:],
                dict(kw, want_bvf=True)))
    args, kw = calls["prsgrd32"]
    out.append(("prsgrd32[eq_tide]", "prsgrd32", args,
                dict(kw, eq_tide=rand(s2, 0.05))))
    args, kw = calls["tracer_predictor"]
    out.append(("tracer_predictor[ghats+solar]", "tracer_predictor", args,
                dict(kw, ghats=rand((2,) + sw, 1e-3),
                     srflx=torch.tensor(1e-4 * rng.random(s2), **like),
                     swdk_w=torch.tensor(rng.random(sw), **like))))
    args, kw = calls["tracer_corrector"]
    out.append(("tracer_corrector[thomas]", "tracer_corrector",
                (args[0].replace(splines_vdiff=False),) + args[1:], kw))
    for name in ("tracer_predictor", "tracer_corrector"):
        args, kw = calls[name]
        vadv = ("SPLINES",) * args[0].ntracers
        out.append((f"{name}[splines vadv]", name,
                    (args[0].replace(t_vadv=vadv),) + args[1:], kw))
    closed = LBC()
    for name in ("rhs3d", "uv3dmix2", "omega"):
        args, kw = calls[name]
        out.append((f"{name}[closed E-W]", name, (args[0].replace(
            ew_periodic=False, gamma2=-1.0, lbc_zeta=closed, lbc_ubar=closed,
            lbc_vbar=closed, lbc_u=closed, lbc_v=closed, lbc_t=closed),)
            + args[1:], kw))
    args, kw = calls["rhs3d"]
    curv = dataclasses.replace(grid, dndx=rand(s2, 50.0),
                               dmde=rand(s2, 50.0))
    out.append(("rhs3d[curvgrid]", "rhs3d",
                (args[0].replace(curvgrid=True), curv) + args[2:], kw))
    out.append(("rhs3d[first step]", "rhs3d", args,
                dict(kw, start=(0.0, 0.0) + kw["start"][2:])))
    args, kw = calls["uv3dmix2"]
    out.append(("uv3dmix2[masked]", "uv3dmix2",
                (args[0], island(grid)) + args[2:], kw))
    if "t3dmix2_geo" not in calls:
        out.append(("t3dmix2_geo[both tracers]", "t3dmix2_geo",
                    geo_args(cfg, grid, calls), {}))
    return out


def geo_args(cfg, grid, calls):
    """t3dmix2_geo's arguments on a step that does not call it: the
    step's tracers, its time-n depths (grid_flux's plain version on the
    step's own arguments), t_nnew = t Hz, and tnu2 = 500 m2/s for both
    tracers as in BENCHMARK1."""
    from roms_tpu_torch.ops import diag_cuda
    z_r, _, Hz, *_ = diag_cuda.grid_flux_plain(*calls["grid_flux"][0])
    t = calls["tracer_predictor"][0][3]
    return (cfg.replace(tnu2=(500.0, 500.0)), grid, t, Hz, z_r,
            t * Hz[None], cfg.dt)


def island(grid):
    """The grid with a block of land points inside its interior."""
    import torch
    m = grid.rmask.clone()
    m[30:40, 15:25] = 0.0
    umask = m * torch.roll(m, 1, -1)
    vmask = m * torch.roll(m, 1, -2)
    return dataclasses.replace(grid, rmask=m, umask=umask, vmask=vmask,
                               pmask=umask * torch.roll(umask, 1, -2))


def check_variants(tag, grid, cases, dtype, results, timed=True):
    """Each (label, kernel, args, kw) of `cases` against its plain version:
    agreement, and with `timed` the times and the bound; one line each,
    into results[label][dtype]."""
    import torch
    table = wrappers()
    for label, name, args, kw in cases:
        mod, attr, plain = table[name]
        kern = getattr(mod, attr)
        rtol = FAST_RTOL if name == "fast_loop" else KERNEL_RTOL
        out_k = kern(*fresh(args), **kw)
        torch.cuda.synchronize()
        out_p = plain(*fresh(args), **kw)
        finite = all(bool(torch.isfinite(a).all())
                     for a in tensors_of(out_k))
        nout = len(tensors_of(out_k))
        exact = BITWISE.get(name, ())
        exact = range(nout) if exact is None else \
            tuple(n for n in exact if n < nout)
        err, ratio, equal = max_err(out_k, out_p, rtol[dtype], exact)
        bitwise = ",".join(map(str, equal)) or "none"
        equal = set(exact) <= set(equal)
        repeat = same(kern(*fresh(args), **kw), out_k)
        ok = finite and repeat and equal and ratio <= 1.0
        bar = f"tol={rtol[dtype]:g}*max|field|"
        if len(exact) == nout:
            bar = "bitwise"
        elif exact:
            bar = f"outputs {','.join(map(str, exact))} bitwise, {bar}"
        times = ""
        if timed:
            per_call = name in IN_PLACE
            ms = device_ms(kern, args, kw, per_call)
            plain_ms = device_ms(plain, args, kw, per_call)
            ops = count_ops(plain, args, kw)
            b_ms, b_by = bound(name, grid, args, kw, out_k, ops, dtype)
            dev = f" (device {profiled_ms(kern, args, kw, per_call):.4f} " \
                "ms)" if exact else ""
            times = f" kernel {ms:.4f} ms{dev}, plain {plain_ms:.4f} ms, " \
                f"bound {b_ms:.5f} ms by {b_by} ({ops:.4e} ops)"
        print(f"[{tag}] {label:30s} {dtype}: max_abs_err={err:.3e} "
              f"{bar} (worst err/tol {ratio:.3e}; outputs bitwise equal: "
              f"{bitwise}) finite={finite} repeat "
              f"bitwise={repeat}{times}  {'OK' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{label} {dtype}: kernel disagrees with its plain "
                  "version or with its own second launch")
        results.setdefault(label, {})[dtype] = dict(max_abs_err=err)
        if timed:
            results[label][dtype].update(ms=ms, plain_ms=plain_ms,
                                         bound_ms=b_ms, bound_by=b_by)
        if label == "fast_loop":
            fast_loop_launches(tag, args, kw, dtype, out_k)


def same(outs_a, outs_b) -> bool:
    """Whether two results are bitwise equal, tensor for tensor."""
    import torch
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in
               zip(tensors_of(outs_a), tensors_of(outs_b)))


def grid_barriers(blocks, threads, nbar):
    """One cooperative launch of blocks x threads that runs nbar grid
    barriers and nothing else."""
    import ctypes
    import torch
    from roms_tpu_torch.ops import _kernels
    err = _kernels.library().roms_grid_barriers(
        blocks, threads, nbar,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    check(err == 0, f"roms_grid_barriers: CUDA error {err}")


def fast_loop_launches(tag, args, kw, dtype, out_ref):
    """The fast loop at each block size of FAST_THREADS_SWEEP: its launch
    (blocks, co-resident limit), its barriers (10 nfast + 2) and phases (one
    more), its time, the time of an empty kernel of as many grid barriers
    at the same launch; each size's result bitwise equal to out_ref, the
    default size's."""
    import torch
    from roms_tpu_torch.ops import step2d_cuda
    cfg = args[0]
    points = cfg.ny_tot * cfg.nx_tot
    nbar = 10 * cfg.nfast + 2
    default = step2d_cuda.FAST_THREADS
    try:
        for threads in FAST_THREADS_SWEEP:
            step2d_cuda.FAST_THREADS = threads
            plan = step2d_cuda.launch_plan(getattr(torch, dtype), points)
            equal = same(step2d_cuda.fast_loop(*fresh(args), **kw), out_ref)
            ms = device_ms(step2d_cuda.fast_loop, args, kw)
            bar_ms = device_ms(grid_barriers,
                               (plan["blocks"], threads, nbar), {})
            mark = " (the default)" if threads == default else ""
            print(f"[{tag}] fast_loop launch {dtype}: {points} points, "
                  f"{plan['blocks']} blocks x {threads} threads{mark} "
                  f"(co-resident limit {plan['per_sm']} a SM x "
                  f"{plan['sms']} SMs), "
                  f"{nbar} grid barriers: kernel {ms:.4f} ms = "
                  f"{ms / (nbar + 1) * 1e3:.3f} us a phase; empty kernel of "
                  f"{nbar} barriers {bar_ms:.4f} ms = "
                  f"{bar_ms / nbar * 1e3:.3f} us a barrier; bitwise equal "
                  f"to the default size's result: {equal}", flush=True)
            check(plan["blocks"] > 1, "the fast loop runs on one block")
            check(equal, f"the fast loop at {threads} threads a block "
                         "differs from the default size's result")
    finally:
        step2d_cuda.FAST_THREADS = default


def column_tiles(tag, cfg, dtype):
    """The launch of rows 1-4 and 6-10 on this case: tile, level slots,
    blocks, threads, shared memory, and the registers and stack frame of
    the loaded kernel (eos's tiled kernel, JM95 with bvf, whether or not
    this case runs it; omega a thread a column, without a tile)."""
    import torch
    from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, prsgrd_cuda, \
        rhs3d_cuda, step3d_cuda
    t = getattr(torch, dtype)
    shape = (cfg.N, cfg.ny_tot, cfg.nx_tot)
    for name, plan, lay in (
            ("prsgrd32", prsgrd_cuda.prsgrd_plan(t, *shape),
             prsgrd_cuda.prsgrd_layout(t)),
            ("rhs3d", rhs3d_cuda.rhs3d_plan(t, *shape),
             rhs3d_cuda.rhs3d_layout(t)),
            ("uv3dmix2", mix3d_cuda.uv3dmix2_plan(t, *shape),
             mix3d_cuda.uv3dmix2_layout(t))):
        (tx, ty), slots = plan["tile"], plan.get("levels", 1)
        print(f"[{tag}] {name} tile {dtype}: {tx}x{ty} points a block "
              f"(xi x eta), {slots} level slot(s), {plan['blocks']} blocks "
              f"x {plan['threads']} threads for {cfg.ny_tot}x{cfg.nx_tot} "
              f"padded points and {cfg.N} levels, {plan['smem_bytes']} "
              f"bytes of shared memory, {lay['registers']} registers and "
              f"{lay['stack_bytes']} bytes of stack frame a thread",
              flush=True)
    gf = diag_cuda.grid_flux_plan(t, *shape)
    lay = diag_cuda.grid_flux_layout(t)
    tx, ty = gf["tile"]
    print(f"[{tag}] grid_flux tile {dtype}: {tx}x{ty} points a block (xi x "
          f"eta), {gf['threads'] // (tx * ty)} level slot(s), "
          f"{gf['blocks']} blocks x "
          f"{gf['threads']} threads for {cfg.ny_tot}x{cfg.nx_tot} padded "
          f"points and {cfg.N} levels, {gf['smem_bytes']} bytes of shared "
          f"memory, {lay['registers']} registers and {lay['stack_bytes']} "
          f"bytes of stack frame a thread (Vtransform 2)", flush=True)
    lay = diag_cuda.omega_layout(t)
    th = diag_cuda.THREADS
    print(f"[{tag}] omega launch {dtype}: a thread a column, "
          f"{-(-cfg.ny_tot * cfg.nx_tot // th)} blocks x {th} threads for "
          f"{cfg.ny_tot}x{cfg.nx_tot} padded points and {cfg.N} levels, "
          f"{lay['registers']} registers and {lay['stack_bytes']} bytes of "
          f"stack frame a thread", flush=True)
    eos = diag_cuda.eos_plan(t, *shape, True, True)
    lay = diag_cuda.eos_layout(t)
    print(f"[{tag}] eos tile {dtype} (JM95 with bvf): {eos['tile']} padded "
          f"points a block, {eos['blocks']} blocks x {eos['threads']} "
          f"threads for {cfg.ny_tot}x{cfg.nx_tot} padded points and "
          f"{cfg.N} levels, {eos['smem_bytes']} bytes of shared memory, "
          f"{lay['registers']} registers and {lay['stack_bytes']} bytes of "
          f"stack frame a thread", flush=True)
    for name in ("tracer_predictor", "tracer_corrector", "uv_corrector"):
        if name == "uv_corrector":
            plan, lay = step3d_cuda.uv_plan(t, *shape), \
                step3d_cuda.uv_layout(t)
            what = "both directions"
        else:
            plan = step3d_cuda.tracer_plan(name, t, cfg.N, cfg.ntracers,
                                           cfg.ny_tot, cfg.nx_tot)
            lay = step3d_cuda.tracer_layout(name, t)
            what = f"{cfg.ntracers} tracers"
        print(f"[{tag}] {name} tile {dtype}: {plan['tile']} padded points "
              f"a block, {plan['blocks']} blocks x {plan['threads']} "
              f"threads for {cfg.ny_tot}x{cfg.nx_tot} padded points and "
              f"{what}, {plan['smem_bytes']} bytes of "
              f"shared memory, {lay['registers']} registers and "
              f"{lay['stack_bytes']} bytes of stack frame a thread",
              flush=True)


def kernel_checks(results, device):
    """Phase 3: every kernel of the UPWELLING path (all but t3dmix2_geo:
    tnu2 = 0) against its plain version, f64 and f32."""
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS

    table = wrappers()
    # a developed state: 3 plain float64 steps from rest
    cfg64, grid64, s, ffn = upwelling.build(upwelling.make_config(),
                                           device=device)
    s = stepping.run(cfg64.replace(pallas2d=False), grid64, s, 3, ffn)
    for dtype in ("float64", "float32"):
        cfg, grid, _, ffn = upwelling.build(
            upwelling.make_config(dtype=dtype), device=device)
        state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                             for k in TENSOR_FIELDS})
        calls = captured_calls(cfg, grid, state, ffn)
        check(set(calls) == set(table) - {"t3dmix2_geo"},
              f"the main path called {sorted(calls)}, not every kernel")
        column_tiles("kernel", cfg, dtype)
        check_variants("kernel", grid, variants(cfg, grid, calls), dtype,
                       results)


def interior(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def main_path(device):
    """Phase 4: 10 float64 steps through stepping.step; returns the
    launch counts of that run."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling

    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(),
                                         device=device)
    nsteps = 10
    for w in table.values():
        w.launches = 0
    del table["t3dmix2_geo"]          # tnu2 = 0: not on this path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s0, nsteps, ffn)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / nsteps
    launches = {k: w.launches for k, w in table.items()}
    print(f"[main] {nsteps} float64 UPWELLING steps, kernels on: "
          f"{ms_step:.2f} ms/step (host clock incl. first-call set-up); "
          f"launches {launches}", flush=True)
    check(all(n == nsteps for n in launches.values()),
          f"a kernel of the main path did not launch once a step: "
          f"{launches}")

    s_plain = stepping.run(cfg.replace(pallas2d=False), grid, s0, nsteps,
                           ffn)
    fields = {"zeta": s.zeta, "u": s.u, "v": s.v, "temp": s.t[0]}
    plain = {"zeta": s_plain.zeta, "u": s_plain.u, "v": s_plain.v,
             "temp": s_plain.t[0]}
    check(all(bool(torch.isfinite(a).all()) for a in fields.values()),
          "non-finite fields after 10 steps")
    ref = np.load(ANCHOR)
    ref_of = {"zeta": ref["zeta"], "u": ref["u_full"], "v": ref["v_full"],
              "temp": ref["temp_full"]}
    for name, a in fields.items():
        lim = CARD_FACTOR * ANCHOR_ATOL[name]
        got = interior(cfg, a).cpu().numpy()
        e_anchor = float(np.abs(got - ref_of[name]).max())
        e_plain = float((interior(cfg, a) -
                         interior(cfg, plain[name])).abs().max())
        ok = e_anchor <= lim and e_plain <= lim
        print(f"[main] {name:5s}: |kernels - anchor| = {e_anchor:.3e}, "
              f"|kernels - kernels off| = {e_plain:.3e}, bound {lim:g} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} misses the anchor bound")
    zsum = float(interior(cfg, s.zeta).sum())
    print(f"[main] sum(zeta) over the interior = {zsum:.3e}")
    check(abs(zsum) < CARD_FACTOR * 1e-10, "free-surface volume drifted")
    return launches


def upwelling_signature(cfg, grid, s0, s):
    """(mean zeta over the cell area in m, change of surface temperature
    at the wall that cools most in degC) between states s0 and s."""
    area = interior(cfg, 1.0 / (grid.pm * grid.pn))
    zeta = interior(cfg, s.zeta)
    mean_zeta = float((zeta * area).sum() / area.sum())
    sst0 = interior(cfg, s0.t[0, -1])
    sst = interior(cfg, s.t[0, -1])
    dsst_south = float((sst[0] - sst0[0]).mean())
    dsst_north = float((sst[-1] - sst0[-1]).mean())
    return mean_zeta, min(dsst_south, dsst_north)


def long_run(device, name):
    """Phase 5: 1440 float32 steps (5 model days)."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling

    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(dtype="float32"), device=device)
    s = stepping.run(cfg, grid, s0, 2, ffn)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s, 1438, ffn)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1000.0 / 1438
    finite = all(bool(torch.isfinite(getattr(s, k)).all())
                 for k in ("zeta", "ubar", "vbar", "u", "v", "t"))
    mean_zeta, dsst = upwelling_signature(cfg, grid, s0, s)
    pts = cfg.Lm * cfg.Mm * cfg.N
    print(f"[run] 1440 float32 UPWELLING steps (5 days): {ms_step:.3f} "
          f"ms/step on {name}, {pts / ms_step * 1e3:.4e} grid-points/s; "
          f"finite={finite} mean zeta {mean_zeta:.3e} m, SST change at "
          f"the upwelling wall {dsst:.3f} degC", flush=True)
    check(finite, "non-finite fields in the 5-day run")
    check(abs(mean_zeta) < 1e-6, "free-surface volume drifted")
    check(dsst < -1.0, "no upwelling: the surface did not cool at a wall")
    return ms_step


def profile(device, case="upwelling"):
    """Phase 6 (UPWELLING, 10 steps) and 11 (BENCHMARK1, 5 steps):
    torch.profiler over float32 steps with a record_function span around
    every stage call of stepping.step."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from roms_tpu_torch import stepping, vgrid
    from roms_tpu_torch.models import benchmark, upwelling
    from roms_tpu_torch.ops import mix3d, rhs3d_cuda

    sites = [(mod, attr) for mod, attr, _ in wrappers().values()]
    sites += [(stepping, n) for n in ("set_vbc", "bulk_flux", "lmd_vmix",
                                      "swfrac")]
    sites.append((mix3d, "t3dmix2"))
    sites.append((rhs3d_cuda, "momentum_rhs"))
    sites.append((vgrid, "set_depth"))
    model, nsteps, tag = (upwelling, 10, "profile") if case == "upwelling" \
        else (benchmark, 5, "bench-profile")

    def span(name, fn):
        def call(*args, **kw):
            with record_function("stage:" + name):
                return fn(*args, **kw)
        return call

    cfg, grid, s, ffn = model.build(model.make_config(dtype="float32"),
                                    device=device)
    s = stepping.run(cfg, grid, s, 3, ffn)        # warm-up
    torch.cuda.synchronize()
    with patched(sites, span), torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = stepping.run(cfg, grid, s, nsteps, ffn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / nsteps
    check(bool(torch.isfinite(s.u).all()), "non-finite u in the profile")
    kernels = {}
    for e in prof.events():
        # device events, less the device-side copies of the stage spans
        if str(getattr(e, "device_type", "")).endswith("CUDA") and \
                not e.name.startswith("stage:"):
            ms = e.time_range.elapsed_us() / 1e3
            n, tot = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, tot + ms)
    launches = sum(n for n, _ in kernels.values()) / nsteps
    busy = sum(t for _, t in kernels.values()) / nsteps
    check(launches > 0, "the profiler saw no device activity")
    print(f"[{tag}] {nsteps} float32 {case} steps under torch.profiler: "
          f"{wall_ms:.3f} ms/step (profiler on), {launches:.1f} device "
          f"launches a step, device busy {busy:.3f} ms a step, idle "
          f"{100.0 * (1.0 - busy / wall_ms):.1f}%", flush=True)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    # the eight largest, and every kernel of the port's own library
    shown = [kv for i, kv in enumerate(ranked)
             if i < 8 or "at::native" not in kv[0]]
    for kname, (n, tot) in shown:
        print(f"[{tag}] device {tot / nsteps:8.4f} ms/step "
              f"{n / nsteps:7.1f} launches/step  {kname[:90]}")
    stages = [(e.key, e.cpu_time_total / 1e3 / nsteps)
              for e in prof.key_averages()
              if e.key.startswith("stage:") and e.cpu_time_total > 0]
    for key, ms in sorted(stages, key=lambda kv: -kv[1]):
        print(f"[{tag}] host {ms:8.3f} ms/step  {key[6:]}")


def bench_developed(device):
    """Full-size BENCHMARK1 in float64 and its state three plain steps
    from rest: (cfg, grid, state, forcing_fn)."""
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import benchmark
    cfg, grid, s, ffn = benchmark.build(benchmark.make_config(),
                                        device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s, 3, ffn)
    return cfg, grid, s, ffn


def bench_kernel_checks(results, device, s):
    """Phase 7: every kernel against its plain version on the arguments
    one BENCHMARK1 step from `s` gives it, f64 and f32; t3dmix2_geo also
    with the salt at tnu2 = 0, which must come back bitwise unchanged."""
    import torch
    from roms_tpu_torch.models import benchmark
    from roms_tpu_torch.ops import mix3d_cuda
    from roms_tpu_torch.state import TENSOR_FIELDS

    for dtype in ("float64", "float32"):
        cfg, grid, _, ffn = benchmark.build(
            benchmark.make_config(dtype=dtype), device=device)
        state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                             for k in TENSOR_FIELDS})
        calls = captured_calls(cfg, grid, state, ffn)
        check(set(calls) == set(wrappers()),
              f"the BENCHMARK1 step called {sorted(calls)}, not every "
              "kernel")
        cases = [(name, name, args, kw) for name, (args, kw) in
                 calls.items()]
        args, kw = calls["t3dmix2_geo"]
        one = (args[0].replace(tnu2=(500.0, 0.0)),) + args[1:]
        cases.append(("t3dmix2_geo[salt tnu2=0]", "t3dmix2_geo", one, kw))
        layout = mix3d_cuda.geo_layout(grid.h.dtype)
        tx, ty = layout["tile"]
        blocks = [-(-cfg.nx_tot // tx), -(-cfg.ny_tot // ty),
                  len(_geo_active(cfg))]
        print(f"[bench-kernel] t3dmix2_geo tile {dtype}: {tx}x{ty} points "
              f"a block (xi x eta), {layout['shared_bytes']} bytes of "
              f"shared memory, {layout['registers']} registers a thread; "
              f"{blocks[0]}x{blocks[1]}x{blocks[2]} blocks for "
              f"{cfg.nx_tot}x{cfg.ny_tot} padded points and "
              f"{blocks[2]} tracers", flush=True)
        column_tiles("bench-kernel", cfg, dtype)
        check_variants("bench-kernel", grid, cases, dtype, results)
        a = fresh(one)
        salt_in = a[5][1].clone()
        out = mix3d_cuda.t3dmix2_geo(*a, **kw)
        same = torch.equal(out[1], salt_in)
        print(f"[bench-kernel] t3dmix2_geo[salt tnu2=0] {dtype}: the salt's "
              f"t_nnew bitwise unchanged: {same}", flush=True)
        check(same, "t3dmix2_geo changed a tracer with tnu2 = 0")


BENCH_FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "Akv", "Akt",
                "hsbl")


def bench_equivalence(device, cfg, grid, s0, ffn):
    """Phase 8: three float64 BENCHMARK1 steps from s0 with the kernels on
    against cfg.pallas2d=False; returns the launch counts of the kernels-on
    run."""
    import torch
    from roms_tpu_torch import stepping

    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    nsteps = 3
    for w in table.values():
        w.launches = 0
    s_on = stepping.run(cfg, grid, s0, nsteps, ffn)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in table.items()}
    s_off = stepping.run(cfg.replace(pallas2d=False), grid, s0, nsteps, ffn)
    print(f"[bench-equiv] {nsteps} float64 BENCHMARK1 steps, kernels on: "
          f"launches {launches}", flush=True)
    check(all(n == nsteps for n in launches.values()),
          f"a kernel did not launch once a step: {launches}")
    worst = 0.0
    for name in BENCH_FIELDS:
        a, b = getattr(s_on, name), getattr(s_off, name)
        err = float((a - b).abs().max())
        tol = BENCH_EQUIV_RTOL * max(float(b.abs().max()), 1e-300)
        finite = bool(torch.isfinite(a).all())
        ok = finite and err <= tol
        worst = max(worst, err / tol)
        print(f"[bench-equiv] {name:5s}: |kernels on - off| = {err:.3e}, "
              f"{err / tol * BENCH_EQUIV_RTOL:.3e} x max|field| (bound "
              f"{BENCH_EQUIV_RTOL:g}) finite={finite} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"BENCHMARK1 {name}: kernels on and off disagree")
    return launches


def _script(name):
    """scripts/<name>.py as a module (importing it imports no jax)."""
    import importlib.util
    path = os.path.join(ROOT, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fixture_script():
    """scripts/torch_benchmark_fixture.py: its CASE, NSTEPS and errors()."""
    return _script("torch_benchmark_fixture")


def regional_fixture_script():
    """scripts/torch_regional_fixture.py: its CASES, NSTEPS and errors()."""
    return _script("torch_regional_fixture")


def coastal_fixture_script():
    """scripts/torch_coastal_fixture.py as a module."""
    return _script("torch_coastal_fixture")


def cases2_fixture_script():
    """scripts/torch_cases2_fixture.py as a module."""
    return _script("torch_cases2_fixture")


def sediment_fixture_script():
    """scripts/torch_sediment_fixture.py as a module."""
    return _script("torch_sediment_fixture")


def biology_fixture_script():
    """scripts/torch_biology_fixture.py as a module."""
    return _script("torch_biology_fixture")


def forward_fixture_script():
    """scripts/torch_forward_fixture.py as a module."""
    return _script("torch_forward_fixture")


def nesting_fixture_script():
    """scripts/torch_nesting_fixture.py as a module."""
    return _script("torch_nesting_fixture")


def bench_fixture(device):
    """Phase 9: the small BENCHMARK with the kernels on against the
    fixture, at CARD_FACTOR times the CPU test's bounds."""
    import numpy as np
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import benchmark

    fx = fixture_script()
    ref = np.load(BENCH_FIXTURE)
    cfg, grid, s0, ffn = benchmark.build(benchmark.make_config(**fx.CASE),
                                         device=device)
    s = stepping.run(cfg, grid, s0, fx.NSTEPS, ffn)
    errors = fx.errors(cfg, s0, s, ref, factor=CARD_FACTOR)
    for key, (err, lim) in sorted(errors.items(), key=lambda kv: kv[0]):
        print(f"[bench-fixture] {key:16s} {err:.3e} x max|field| (bound "
              f"{lim:g}) {'OK' if err <= lim else 'FAIL'}")
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    check(not bad, f"the small BENCHMARK misses its fixture: {bad}")


def bench_long_run(device, name):
    """Phase 10: BENCH_STEPS float32 BENCHMARK1 steps with the kernels on;
    returns the launch counts of the run."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import benchmark

    cfg, grid, s, ffn = benchmark.build(
        benchmark.make_config(dtype="float32"), device=device)
    s = stepping.run(cfg, grid, s, 2, ffn)       # warm-up
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    for w in table.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s, BENCH_STEPS, ffn)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1000.0 / BENCH_STEPS
    launches = {k: w.launches for k, w in table.items()}
    finite = all(bool(torch.isfinite(getattr(s, k)).all())
                 for k in BENCH_FIELDS)
    umax = float(interior(cfg, s.u).abs().max())
    fmax = float(grid.f.max())
    usurf = float(interior(cfg, s.u[-1]).mean())
    pts = cfg.Lm * cfg.Mm * cfg.N
    hours = (BENCH_STEPS + 2) * cfg.dt / 3600.0
    print(f"[bench-run] {BENCH_STEPS} float32 BENCHMARK1 steps ({hours:.1f} "
          f"model hours): {ms_step:.3f} ms/step on {name}, "
          f"{pts / ms_step * 1e3:.4e} grid-points/s; finite={finite} "
          f"umax {umax:.3f} m/s, max f {fmax:.3e}, mean surface u "
          f"{usurf:.3e} m/s; launches {launches}", flush=True)
    check(finite, "non-finite fields in the BENCHMARK1 run")
    check(umax < 2.0, f"BENCHMARK1 umax {umax} m/s")
    check(fmax < 0.0, "Coriolis not negative everywhere")
    check(usurf > 0.0, "the wind jet did not drive an eastward current")
    check(all(n == BENCH_STEPS for n in launches.values()),
          f"a kernel of the BENCHMARK1 path did not launch once a step: "
          f"{launches}")
    return launches


# the driver phase's UPWELLING run: examples/upwelling.yaml's settings as
# flags (the card's machine may lack PyYAML)
DRIVER_CLI = ("--case", "upwelling", "--nsteps", "1440", "--nhis", "72",
              "--nrst", "288", "--ninfo", "12")
DRIVER_BENCH_STEPS = 20
DRIVER_REPS = 3
# AVG record against the hand mean of the float32 states it averages:
# navg additions in float32, each within one rounding of max|zeta|
F32_EPS = 2.0 ** -23


def _same(cfg, record, tensor) -> bool:
    """A history record (big-endian float64) equal bit for bit to the
    interior of a state field."""
    import numpy as np
    want = interior(cfg, tensor).double().cpu().numpy()
    return np.asarray(record, "<f8").tobytes() == want.tobytes()


def _record_fields(s):
    return {"zeta": s.zeta, "ubar": s.ubar, "vbar": s.vbar, "u": s.u,
            "v": s.v, "temp": s.t[0], "salt": s.t[1]}


def driver_phase(device, smi):
    """Phase 12: the run driver, its NetCDF streams and restarts, through
    the CLI (`roms_tpu_torch.__main__.main`) and `Simulation`."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.__main__ import main as cli
    from roms_tpu_torch.driver import BlowupError, Simulation, restart
    from roms_tpu_torch.io.netcdf import read_history
    from roms_tpu_torch.models import benchmark, upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS

    t_phase = time.perf_counter()
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    quiet = dict(ninfo=0, log=lambda *a: None)
    with tempfile.TemporaryDirectory() as tmp:
        # UPWELLING, float64, 5 model days through the CLI
        his, rst = os.path.join(tmp, "his.nc"), os.path.join(tmp, "rst")
        argv = ["run", *DRIVER_CLI, "--his", his, "--rst", rst, "--device",
                "cuda"]
        out = io.StringIO()
        for w in table.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: w.launches for k, w in table.items()}
        lines = out.getvalue().splitlines()
        info = [ln for ln in lines if "KE=" in ln]
        print(f"[driver] python -m roms_tpu_torch {' '.join(argv)}: exit "
              f"{rc}, {secs:.2f} s ({secs * 1e3 / 1440:.3f} ms/step, "
              f"build and output included) on {smi}; {len(info)} NINFO "
              f"lines; launches {launches}", flush=True)
        for ln in lines[:2] + info[:1] + info[-1:]:
            print(f"[driver] | {ln}")
        report = lines[lines.index(info[-1]) + 1:] if info else lines
        for ln in report:
            if ln.strip():
                print(f"[driver] | {ln}")
        check(rc == 0, f"the CLI exited {rc}")
        check(len(info) == 1440 // 12, f"{len(info)} NINFO lines, not 120")
        del launches["t3dmix2_geo"]       # tnu2 = 0: not on this path
        check(all(n == 1440 for n in launches.values()),
              f"a kernel of the CLI's run did not launch once a step: "
              f"{launches}")
        h = read_history(his)
        cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(),
                                             device=device)
        times = h["ocean_time"]
        rsts = [f"{rst}_{n:07d}.pt" for n in range(288, 1441, 288)]
        finite = all(np.isfinite(h[k]).all() for k in _record_fields(s0))
        found = [os.path.basename(p) for p in rsts if os.path.exists(p)]
        print(f"[driver] HIS: {len(times)} records at "
              f"{sorted({float(d) for d in np.diff(times)})} s apart, "
              f"finite={finite}; "
              f"restarts {found}", flush=True)
        check(len(times) == 20 and np.array_equal(
            times, 72 * cfg.dt * np.arange(1, 21)), "HIS record times")
        check(finite, "non-finite fields in the HIS file")
        check(all(os.path.exists(p) for p in rsts), "missing restarts")
        s1440 = restart(cfg, rsts[-1], s0)
        check(all(_same(cfg, h[k][-1], a) for k, a in
                  _record_fields(s1440).items()),
              "the last HIS record differs from the last restart")
        mean_zeta, dsst = upwelling_signature(cfg, grid, s0, s1440)
        print(f"[driver] last record (day 5): mean zeta {mean_zeta:.3e} m, "
              f"SST change at the upwelling wall {dsst:.3f} degC",
              flush=True)
        check(abs(mean_zeta) < 1e-6, "free-surface volume drifted")
        check(dsst < -1.0, "no upwelling: the surface did not cool at a wall")

        # the CLI's records and restarts against stepping.run
        before = {k: getattr(s0, k).clone() for k in TENSOR_FIELDS}
        s72 = stepping.run(cfg, grid, s0, 72, ffn)
        same72 = all(_same(cfg, h[k][0], a) for k, a in
                     _record_fields(s72).items())
        s298 = stepping.run(cfg, grid, s72, 226, ffn)
        r288 = restart(cfg, rsts[0], s0)
        kept = {k: getattr(r288, k).clone() for k in TENSOR_FIELDS}
        sim = Simulation(cfg, grid, r288, ffn, **quiet)
        sim.run(10)
        same298 = all(torch.equal(getattr(sim.state, k), getattr(s298, k))
                      for k in TENSOR_FIELDS) and \
            (sim.state.iic, sim.state.time) == (s298.iic, s298.time)
        caller = all(torch.equal(getattr(r288, k), kept[k]) for k in
                     TENSOR_FIELDS)
        input_kept = all(torch.equal(getattr(s0, k), before[k]) for k in
                         TENSOR_FIELDS)
        print(f"[driver] HIS record of step 72 bitwise stepping.run's: "
              f"{same72}; restart of step 288 + 10 Simulation steps "
              f"bitwise 298 straight steps (every State field): "
              f"{same298}; the caller's state unchanged by Simulation.run: "
              f"{caller}; stepping.run's input unchanged: {input_kept}",
              flush=True)
        check(same72, "the HIS record of step 72 is not stepping.run's")
        check(same298, "the restarted run is not the straight run")
        check(caller and input_kept, "a run wrote into its input state")

        # blowup: a NaN in u stops the run at the first NINFO step
        H = cfg.halo
        u = s0.u.clone()
        u[2, H + 8, H + 8] = float("nan")
        caught = None
        sim = Simulation(cfg, grid, s0.replace(u=u), ffn, ninfo=1,
                         log=lambda *a: None, rst_file=os.path.join(
                             tmp, "blowup"), nrst=1000)
        try:
            sim.run(3)
        except BlowupError as exc:
            caught = exc
        print(f"[driver] NaN planted in u, ninfo=1: {caught!r}; final "
              f"restart {[os.path.basename(p) for p in sim.rst_paths]}",
              flush=True)
        check(caught is not None and sim.rst_paths,
              "the blowup was not caught")
        del cfg, grid, s0, s72, s298, s1440, r288, sim, h

        # BENCHMARK1, float32, through Simulation with AVG, QCK and HIS
        cfg, grid, s0, ffn = benchmark.build(
            benchmark.make_config(dtype="float32"), device=device)
        n = DRIVER_BENCH_STEPS
        stepping.run(cfg, grid, s0, 2, ffn)              # warm-up

        # stepping.run, Simulation.run without streams, and Simulation.run
        # with the AVG sums alone (navg past the run's end: no record), in
        # turn, DRIVER_REPS times: the host's speed drifts within a call
        def timed(run):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(n)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3 / n

        sums_file = os.path.join(tmp, "bench_sums.nc")
        makers = {
            "stepping.run": lambda: lambda k: stepping.run(cfg, grid, s0, k,
                                                           ffn),
            "Simulation.run": lambda: Simulation(cfg, grid, s0, ffn,
                                                 **quiet).run,
            "with the AVG sums": lambda: Simulation(
                cfg, grid, s0, ffn, avg_file=sums_file, navg=10 * n,
                **quiet).run,
        }
        alt = {k: [] for k in makers}
        for _ in range(DRIVER_REPS):
            for k, make in makers.items():
                out, ms = timed(make())
                alt[k].append(ms)
                if k == "stepping.run":
                    s = out
        med = {k: float(np.median(v)) for k, v in alt.items()}
        print(f"[driver] BENCHMARK1 float32, {n} steps a run, in turn "
              f"{DRIVER_REPS} times (ms/step): " + "; ".join(
                  f"{k} {', '.join(f'{x:.3f}' for x in v)} (median "
                  f"{med[k]:.3f}, spread {(max(v) - min(v)) / med[k]:.1%})"
                  for k, v in alt.items()) + f"; on {smi}", flush=True)
        zetas, si = [], s0
        for _ in range(n):
            si = stepping.step(cfg, grid, si, ffn)
            zetas.append(interior(cfg, si.zeta).double().cpu().numpy())
        paths = {k: os.path.join(tmp, f"bench_{k}.nc") for k in
                 ("his", "avg", "qck")}
        lines = []
        sim = Simulation(cfg, grid, s0, ffn, his_file=paths["his"],
                         nhis=20, avg_file=paths["avg"], navg=10,
                         qck_file=paths["qck"], nqck=10, ninfo=10,
                         log=lines.append)
        for w in table.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(n)
        torch.cuda.synchronize()
        ms_sim = (time.perf_counter() - t0) * 1e3 / n
        launches = {k: w.launches for k, w in table.items()}
        sim.finalize()
        acc, calls = sim.profiler.acc, sim.profiler.calls
        per = {k: acc[k] / max(calls[k], 1) for k in
               ("output: history", "output: averages", "output: quick",
                "diagnostics")}
        mb = sum(interior(cfg, a).numel() for a in
                 _record_fields(s).values()) * 8 / 1e6
        print(f"[driver] BENCHMARK1 float32, {n} steps: Simulation.run "
              f"with HIS/AVG/QCK/NINFO {ms_sim:.3f} ms/step, of it the "
              f"stepping region {acc['3d time stepping'] * 1e3 / n:.3f}; "
              f"a HIS record ({mb:.1f} MB of float64) "
              f"{per['output: history']:.4f} s, an AVG record "
              f"{per['output: averages']:.4f} s, a QCK record "
              f"{per['output: quick']:.4f} s, a NINFO line "
              f"{per['diagnostics']:.4f} s; on {smi}; launches {launches}",
              flush=True)
        for ln in lines[:2]:
            print(f"[driver] | {ln}")
        check(all(k == n for k in launches.values()),
              f"a kernel of the BENCHMARK1 driver run did not launch once a "
              f"step: {launches}")
        check(len(lines) == 2 + 1 and "KE=" in lines[0],
              "NINFO lines or the region profile missing")
        hb, avg, qck = (read_history(paths[k]) for k in ("his", "avg", "qck"))
        check(hb["zeta"].shape[0] == 1 and all(
            _same(cfg, hb[k][0], a) for k, a in _record_fields(s).items()),
            "the BENCHMARK1 HIS record is not stepping.run's state")
        check(qck["temp_sur"].shape == (2, cfg.Mm, cfg.Lm) and
              _same(cfg, qck["temp_sur"][-1], s.t[0, -1]),
              "the QCK surface slice")
        worst = 0.0
        for rec in range(2):
            want = np.mean(zetas[10 * rec:10 * rec + 10], axis=0)
            bound = 10 * F32_EPS * max(np.abs(z).max() for z in
                                       zetas[10 * rec:10 * rec + 10])
            err = float(np.abs(avg["zeta"][rec] - want).max())
            worst = max(worst, err / bound)
            print(f"[driver] AVG record {rec}: |zeta - mean of its 10 "
                  f"states| = {err:.3e} m, bound {bound:.3e} m "
                  f"(10 x 2^-23 x max|zeta|)", flush=True)
        check(worst <= 1.0, "the AVG record is not the mean of its states")
        check(np.array_equal(avg["ocean_time"],
                             cfg.dt * np.array([5.0, 15.0])),
              "AVG record times")
    print(f"[driver] phase 12 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# phase 13: the regional cases at their published sizes, the kernels each
# one's step launches (bry or sources keep rows 8-11 on their plain
# versions, as the JAX gates keep their Pallas kernels off)
REGIONAL = ("kelvin", "estuary", "riverplume")
_ROWS_1_7 = ("grid_flux", "eos", "omega", "prsgrd32", "rhs3d")
REGIONAL_KERNELS = {"kelvin": _ROWS_1_7, "estuary": _ROWS_1_7,
                    "riverplume": _ROWS_1_7 + ("uv3dmix2", "t3dmix2_geo")}
REGIONAL_EQUIV_STEPS = 3
# the physics signatures of tests/test_cases.py:70-77 and
# tests/test_cases_extra.py:73-106: KELVIN 6 h, ESTUARY_TEST 6 h (half an
# M2 cycle), RIVERPLUME1 4 h
REGIONAL_PHYSICS_STEPS = {"kelvin": 24, "estuary": 720, "riverplume": 120}
# the default run's ESTUARY_TEST and RIVERPLUME1 (their signatures take
# 300-430 s of the general plain fast loop: --regional-long): finite, the
# salt within its bounds, u 0 on masked faces
REGIONAL_SHORT_STEPS = {"kelvin": 24, "estuary": 60, "riverplume": 24}
# float32 steps timed on every phase-13 and phase-14 case
TIMED_STEPS = 5
# steps of the CLI runs with restarts (HIS and a restart every half)
CLI_STEPS = 20
GLS_FIELDS = ("tke", "gls", "tke_prev", "gls_prev", "Akk", "Akp", "Lscale")


def model_case(module, name, device, dtype="float64", **sizes):
    """(cfg, grid, state0, forcing_fn) of the case `name` of
    roms_tpu_torch.models.<module>, at its published sizes unless `sizes`
    cut them."""
    import importlib
    mod = importlib.import_module(f"roms_tpu_torch.models.{module}")
    return getattr(mod, name)(getattr(mod, name + "_config")(
        dtype=dtype, **sizes), device=device)


regional_case = functools.partial(model_case, "cases")


def case_kernel_checks(tag, names, case_fn, kernels, developed):
    """Every kernel each case's step launches, against its plain version
    on that step's arguments (from the developed[name] state), float64
    and float32, untimed; fails on a disagreement or a kernel set other
    than kernels[name].  case_fn(name, dtype) builds the case."""
    from roms_tpu_torch.state import TENSOR_FIELDS
    for name in names:
        s = developed[name][2]
        for dtype in ("float64", "float32"):
            cfg, grid, _, ffn = case_fn(name, dtype)
            state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                                 for k in TENSOR_FIELDS})
            calls = captured_calls(cfg, grid, state, ffn)
            check(set(calls) == set(kernels[name]),
                  f"{name}: the step called {sorted(calls)}, not "
                  f"{sorted(kernels[name])}")
            check_variants(tag, grid,
                           [(f"{name}:{k}", k, *calls[k]) for k in calls],
                           dtype, {}, timed=False)


def _rel_errors(case, fx, a, b):
    """{field: (|a - b| / max|b|, a finite)} over the fields the case's
    step writes, a velocity-like field against the larger of its own and
    its partner's max (fx.PARTNER), each tracer against its own max
    ("t[<n>]") where fx.PER_TRACER says so."""
    import torch
    out = {}
    for k in fx.fields_of(case):
        x, y = getattr(a, k), getattr(b, k)
        if k == "t" and getattr(fx, "PER_TRACER", False):
            for n in range(len(y)):
                out[f"t[{n}]"] = (float((x[n] - y[n]).abs().max()) /
                                  max(float(y[n].abs().max()), 1e-300),
                                  bool(torch.isfinite(x[n]).all()))
            continue
        scale = float(y.abs().max())
        if k in fx.PARTNER:
            scale = max(scale, float(getattr(b, fx.PARTNER[k]).abs().max()))
        scale = max(scale, getattr(fx, "FLOOR", {}).get((case, k), 0.0))
        out[k] = (float((x - y).abs().max()) / max(scale, 1e-300),
                  bool(torch.isfinite(x).all()))
    return out


def regional_equivalence(device, name, cfg, grid, s0, ffn):
    """Phase 13 (b): REGIONAL_EQUIV_STEPS float64 steps from s0 with the
    kernels on against cfg.pallas2d=False; returns the launches a step."""
    return kernels_on_off("regional-equiv", name, cfg, grid, s0, ffn,
                          REGIONAL_KERNELS[name], regional_fixture_script(),
                          REGIONAL_EQUIV_STEPS)


def kernels_on_off(tag, name, cfg, grid, s0, ffn, kernels, fx, n,
                   rtol=BENCH_EQUIV_RTOL, keep=None, bounds=None):
    """n float64 steps from s0 with the kernels on against
    cfg.pallas2d=False, every field fx.fields_of(name) lists within
    rtol x max|field| (a v-like field against its u-like partner's max
    too; bounds[field] instead where given), one launch a step of each of
    `kernels` and none of the others; returns the launches a step, and
    puts the kernels-on state in keep[name] where `keep` is given."""
    import torch
    from roms_tpu_torch import stepping
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    for w in table.values():
        w.launches = 0
    s_on = stepping.run(cfg, grid, s0, n, ffn)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in table.items()}
    s_off = stepping.run(cfg.replace(pallas2d=False), grid, s0, n, ffn)
    want = {k: n if k in kernels else 0 for k in table}
    print(f"[{tag}] {name}: {n} float64 steps, kernels on: launches "
          f"{launches}", flush=True)
    check(launches == want, f"{name}: launches {launches}, not {want}")
    errs = _rel_errors(name, fx, s_on, s_off)
    bounds = bounds or {}
    worst = max(e for e, _ in errs.values())
    print(f"[{tag}] {name}: |kernels on - off| / max|field| "
          + ", ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
          + f"; worst {worst:.3e} (bound {rtol:g}"
          + "".join(f", {k} {b:g}" for k, b in bounds.items()) + ")",
          flush=True)
    check(all(f and e <= bounds.get(k, rtol) for k, (e, f) in errs.items()),
          f"{name}: kernels on and off disagree")
    if keep is not None:
        keep[name] = s_on
    return {k: v / n for k, v in launches.items() if v}


def regional_fixture(device):
    """Phase 13 (c): the small cases with the kernels on against
    tests/data/torch_regional_small.npz, at CARD_FACTOR times the CPU
    test's bounds."""
    import numpy as np
    from roms_tpu_torch import stepping
    fx = regional_fixture_script()
    ref = np.load(fx.OUT)
    for name in fx.CASES:
        cfg, grid, s0, ffn = regional_case(name, device, **fx.CASES[name])
        s = stepping.run(cfg, grid, s0, fx.NSTEPS, ffn)
        errors = fx.errors(name, cfg, s0, s, ref, factor=CARD_FACTOR)
        worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
        print(f"[regional-fixture] {name}: " + ", ".join(
            f"{k} {e:.3e}" for k, (e, _) in errors.items()) +
            f"; worst against its bound: {worst[0]} {worst[1][0]:.3e} "
            f"(bound {worst[1][1]:g})", flush=True)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        check(not bad, f"the small {name} misses its fixture: {bad}")


def regional_physics(device, smi, long=False):
    """Phase 13 (d): the physics signatures of roms_tpu's case tests, at
    the published sizes in float64 (ESTUARY_TEST's and RIVERPLUME1's
    only when `long`, else their short runs' bounds); returns {case:
    (ms/step, steps)}."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    ms = {}
    for name in REGIONAL:
        cfg, grid, s0, ffn = regional_case(name, device)
        n = (REGIONAL_PHYSICS_STEPS if long else REGIONAL_SHORT_STEPS)[name]
        signature = n == REGIONAL_PHYSICS_STEPS[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = stepping.run(cfg, grid, s0, n, ffn)
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3 / n, n)
        z = interior(cfg, s.zeta).cpu().numpy()
        u = interior(cfg, s.u).cpu().numpy()
        salt = interior(cfg, s.t[1]).cpu().numpy()
        finite = bool(np.isfinite(z).all() and np.isfinite(u).all() and
                      np.isfinite(salt).all())
        head = (f"[regional-physics] {name} {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} "
                f"float64 steps ({n * cfg.dt / 3600.0:g} h): "
                f"{ms[name][0]:.1f} ms/step on {smi}; finite={finite}")
        if name == "kelvin":
            coast = float(np.abs(z[2, :10]).max())
            off = float(np.abs(z[-3, :10]).max())
            ok = finite and coast > 2.0 * off and np.abs(z).max() < 2.0
            print(f"{head}; |zeta| near the coast {coast:.4f} m, offshore "
                  f"{off:.4f} m (coast > 2 x offshore), max "
                  f"{np.abs(z).max():.4f} m  {'OK' if ok else 'FAIL'}",
                  flush=True)
        elif name == "estuary":
            umax = float(np.abs(s.u.cpu().numpy()).max())
            ok = finite and salt.min() > -0.5 and salt.max() < 30.5
            tide = ""
            if signature:
                ok = ok and np.abs(z).max() > 0.05 and umax > 0.05
                tide = " (> 0.05)"
            print(f"{head}; max|zeta| {np.abs(z).max():.4f} m{tide}, "
                  f"salt in [{salt.min():.4f}, {salt.max():.4f}] (within "
                  f"[-0.5, 30.5]), max|u| {umax:.4f} m/s{tide}  "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
        else:
            masked = float(np.abs(s.u.cpu().numpy() *
                                  (1.0 - grid.umask.cpu().numpy())).max())
            ok = finite and salt[:, :, 4:].max() < cfg.S0 + 0.5 and \
                masked == 0.0
            plume = ""
            if signature:
                ok = ok and salt.min() < cfg.S0 - 1.0
                plume = f" (< S0 - 1 = {cfg.S0 - 1.0:g})"
            print(f"{head}; min salt {salt.min():.4f}{plume}, max salt "
                  f"away from the channel {salt[:, :, 4:].max():.4f} (< S0 "
                  f"+ 0.5), max|u| on masked faces {masked:g} (= 0)  "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name}: the physics signature failed")
    return ms


def cli_restart_check(device, tag, case, fields, evolved):
    """`case` through the CLI with HIS and restarts: a restart plus the
    remaining steps through Simulation, and the straight run, bitwise
    equal to the last restart, which holds `fields`, `evolved` among them
    changed from the initial state; the last HIS salt record (temperature
    on a one-tracer case) bitwise the restart's."""
    import io
    import tempfile
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.__main__ import main as cli
    from roms_tpu_torch.driver import Simulation, restart
    from roms_tpu_torch.io.netcdf import read_history
    from roms_tpu_torch.state import TENSOR_FIELDS
    from roms_tpu_torch.utils.yamlcfg import build_from_dict
    n = CLI_STEPS
    half = n // 2
    with tempfile.TemporaryDirectory() as tmp:
        his, rst = os.path.join(tmp, "his.nc"), os.path.join(tmp, "rst")
        argv = ["run", "--case", case, "--nsteps", str(n), "--his", his,
                "--nhis", str(half), "--rst", rst, "--nrst", str(half),
                "--ninfo", str(half), "--device", "cuda"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli(argv)
        lines = out.getvalue().splitlines()
        print(f"[{tag}-cli] python -m roms_tpu_torch {' '.join(argv)}: "
              f"exit {rc}", flush=True)
        for ln in lines[:2] + [ln for ln in lines if "KE=" in ln]:
            print(f"[{tag}-cli] | {ln}")
        check(rc == 0, f"the CLI exited {rc}")
        cfg, grid, s0, ffn, _ = build_from_dict({"case": case},
                                                device=device)
        h = read_history(his)
        rsts = [f"{rst}_{k:07d}.pt" for k in (half, n)]
        check(all(os.path.exists(p) for p in rsts), "missing restarts")
        check(np.array_equal(h["ocean_time"],
                             half * cfg.dt * np.arange(1, 3)),
              "HIS record times")
        saved = torch.load(rsts[-1], weights_only=True)
        held = all(k in saved for k in fields) and not torch.equal(
            saved[evolved].to(device), getattr(s0, evolved))
        last = restart(cfg, rsts[-1], s0)
        sim = Simulation(cfg, grid, restart(cfg, rsts[0], s0), ffn, ninfo=0,
                         log=lambda *a: None)
        sim.run(n - half)
        straight = stepping.run(cfg, grid, s0, n, ffn)
        resumed = all(torch.equal(getattr(sim.state, k), getattr(last, k))
                      for k in TENSOR_FIELDS)
        whole = all(torch.equal(getattr(straight, k), getattr(last, k))
                    for k in TENSOR_FIELDS)
        tracer = 1 if cfg.ntracers > 1 else 0
        record = _same(cfg, h[("temp", "salt")[tracer]][-1],
                       last.t[tracer])
        print(f"[{tag}-cli] restart of step {half} + {n - half} Simulation "
              f"steps bitwise the restart of step {n}: {resumed}; {n} "
              f"straight steps bitwise it: {whole}; {', '.join(fields)} in "
              f"the restart and {evolved} evolved: {held}; last HIS "
              f"{('temp', 'salt')[tracer]} record bitwise it: {record}",
              flush=True)
        check(resumed and whole, "the restarted run is not the straight run")
        check(held, f"{', '.join(fields)} are not in the restart")
        check(record, "the HIS record is not the restart's state")


def case_times(tag, names, case_fn, smi, launches, ms64=None):
    """Float32 and float64 ms/step of each case (host clock, TIMED_STEPS
    steps after one; float64 from ms64[name] = (ms, steps) of a longer run
    where given), with its launches a step."""
    import torch
    from roms_tpu_torch import stepping

    def timed(cfg, grid, s0, ffn):
        s = stepping.run(cfg, grid, s0, 1, ffn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stepping.run(cfg, grid, s, TIMED_STEPS, ffn)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TIMED_STEPS

    ms64 = ms64 or {}
    for name in names:
        if name not in ms64:
            ms64[name] = (timed(*case_fn(name, "float64")), TIMED_STEPS)
        cfg, grid, s0, ffn = case_fn(name, "float32")
        ms32 = timed(cfg, grid, s0, ffn)
        ms, steps = ms64[name]
        print(f"[{tag}] {name} {cfg.Lm}x{cfg.Mm}x{cfg.N} nfast "
              f"{cfg.nfast}: float32 {ms32:.1f} ms/step "
              f"({TIMED_STEPS} steps), float64 {ms:.1f} "
              f"ms/step ({steps} steps); kernel launches a step "
              f"{launches[name]}; on {smi}", flush=True)


def case_family_phase(tag, phase, smi, names, case_fn, kernels, fx,
                      equiv_steps, parts, tiles=(),
                      equiv_rtol=BENCH_EQUIV_RTOL, keep=None,
                      equiv_bounds=None):
    """The frame of phases 13, 15 and 16 over the cases `names` at their
    published sizes (case_fn(name, dtype) builds one on the card):
    (a) every kernel each case's step launches against its plain version
    on that step's arguments, three plain float64 steps from rest, after
    the column tiles of the cases `tiles`; (b) kernels on against off
    over equiv_steps steps (or equiv_steps[name]), held to fixture module
    fx's fields within equiv_rtol x max|field| (equiv_bounds[name][field]
    instead where given), the kernels-on states into `keep` where given;
    then
    each (label, fn) of `parts` in turn, fn() returning None or the
    float64 {case: (ms/step, steps)} of its longer runs; and (f) float32
    and float64 ms/step (those from the parts where they gave them) with
    the launches a step from (b).  Prints each part's seconds."""
    from roms_tpu_torch import stepping
    t_phase = t_part = time.perf_counter()
    laps = {}

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        laps[part] = now - t_part
        t_part = now

    developed = {}
    for name in names:
        cfg, grid, s0, ffn = case_fn(name, "float64")
        developed[name] = (cfg, grid, stepping.run(
            cfg.replace(pallas2d=False), grid, s0, 3, ffn), ffn)
    lap("set-up")
    for name in tiles:
        for dtype in ("float64", "float32"):
            column_tiles(tag, case_fn(name, dtype)[0], dtype)
    case_kernel_checks(tag, names, case_fn, kernels, developed)
    lap("a")
    launches = {name: kernels_on_off(
        f"{tag}-equiv", name, *developed[name], kernels[name], fx,
        equiv_steps[name] if isinstance(equiv_steps, dict) else equiv_steps,
        equiv_rtol, keep, (equiv_bounds or {}).get(name))
        for name in names}
    del developed
    lap("b")
    ms64 = {}
    for label, fn in parts:
        ms64.update(fn() or {})
        lap(label)
    case_times(f"{tag}-times", names, case_fn, smi, launches, ms64)
    lap("f")
    print(f"[{tag}] phase {phase} took {time.perf_counter() - t_phase:.1f} "
          f"s (" + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ")",
          flush=True)


def regional_phase(device, smi, long=False):
    """Phase 13: KELVIN, ESTUARY_TEST and RIVERPLUME1 at their published
    sizes: (a) kernels against plain on each case's arguments, (b) kernels
    on against off, (c) the small fixture, (d) the physics signatures
    (ESTUARY_TEST's and RIVERPLUME1's only when `long`), (e) ESTUARY_TEST
    through the CLI with restarts, (f) ms/step."""
    case_family_phase(
        "regional", 13, smi, REGIONAL,
        lambda n, d: regional_case(n, device, d), REGIONAL_KERNELS,
        regional_fixture_script(), REGIONAL_EQUIV_STEPS,
        [("c", lambda: regional_fixture(device)),
         ("d", lambda: regional_physics(device, smi, long)),
         ("e", lambda: cli_restart_check(device, "regional", "estuary",
                                         GLS_FIELDS, "tke"))])


# phase 14: the coastal path at full size: LAB_CANYON (polar annulus,
# north-south periodic, all kernels but t3dmix2_geo), INLET_TEST on a
# generated grid file (wetting-drying and an open-boundary tide keep rows
# 7-11 on their plain versions, as the JAX gates do) and BENCHMARK1 with
# the tide-generating force (prsgrd32 with eq_tide)
COASTAL = ("lab_canyon", "inlet_test", "tide")
_STEP_KERNELS = ("grid_flux", "eos", "omega", "prsgrd32", "rhs3d",
                 "tracer_predictor", "tracer_corrector", "uv_corrector",
                 "fast_loop")
COASTAL_KERNELS = {
    "lab_canyon": _STEP_KERNELS + ("uv3dmix2",),
    "inlet_test": ("grid_flux", "eos", "omega", "prsgrd32", "uv3dmix2"),
    "tide": _STEP_KERNELS}
# INLET_TEST at 100 x 100 x 8 on the generated grid (20 m cells), with
# tests/test_cases4.py's dt = 8 s and ndtfast = 16
INLET_SIZE = (100, 100)
INLET_SETTINGS = dict(N=8, dt=8.0, ndtfast=16)
COASTAL_EQUIV_STEPS = 3
LAB_STEPS = 20            # tests/test_cases4.py: 20 steps at rest
LAB_CONSTANCY_STEPS = 10
INLET_STEPS = 45          # tests/test_cases4.py: fluxes at 15 and 45
TIDE_STEPS = 5            # tests/test_tides_avg.py
# roms_tpu's bound between a file-driven and the analytic run
# (tests/test_gridfile.py)
FILE_RUN_ATOL = 1e-10


def coastal_case(name, device, tmp, dtype="float64"):
    """(cfg, grid, state0, forcing_fn) of a phase-14 case at full size;
    INLET_TEST writes its grid file into directory tmp."""
    from roms_tpu_torch.models import benchmark, cases4
    fx = coastal_fixture_script()
    if name == "lab_canyon":
        return cases4.lab_canyon(cases4.lab_canyon_config(dtype=dtype),
                                 device=device)
    if name == "inlet_test":
        path = fx.inlet_grid(os.path.join(tmp, "inlet_grd.nc"), *INLET_SIZE)
        return cases4.inlet_test(
            cases4.inlet_test_config(dtype=dtype, **INLET_SETTINGS),
            device=device, grid_path=path)
    cfg, grid, s0, _ = benchmark.build(benchmark.make_config(dtype=dtype),
                                       device=device)
    return cfg.replace(**fx.TIDE_CHANGE), grid, s0, None


def _jsonable(v):
    """A Config value as JSON: tuples and LBCs become lists."""
    from roms_tpu_torch.config import LBC
    if isinstance(v, LBC):
        return [v.west, v.south, v.east, v.north]
    return list(v) if isinstance(v, tuple) else v


def lab_canyon_file_run(device, tmp, cfg, grid, s0, straight):
    """Phase 14 (b): LAB_CANYON's grid written with save_grid and its
    initial state with HistoryWriter, run through `python -m
    roms_tpu_torch run lab.yaml` (case: file, LAB_STEPS float64 steps, HIS
    at the last); its record equals the analytic run's state `straight`
    within roms_tpu's file-versus-analytic bound."""
    import contextlib
    import io
    import numpy as np
    from roms_tpu_torch.__main__ import main as cli
    from roms_tpu_torch.config import Config
    from roms_tpu_torch.io import gridfile
    from roms_tpu_torch.io.netcdf import HistoryWriter, read_history
    from roms_tpu_torch.ops import diag_cuda
    grd, ini = os.path.join(tmp, "lab_grd.nc"), os.path.join(tmp,
                                                             "lab_ini.nc")
    his, run = os.path.join(tmp, "lab_his.nc"), os.path.join(tmp,
                                                             "lab.yaml")
    gridfile.save_grid(grd, cfg, grid)
    w = HistoryWriter(ini, cfg, grid)
    w.write(s0)
    w.close()
    base = Config()
    settings = {f.name: _jsonable(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)
                if f.name not in ("Lm", "Mm", "hmin", "nfast")
                and getattr(cfg, f.name) != getattr(base, f.name)}
    doc = {"case": "file", "grid_file": grd, "ini_file": ini,
           "nsteps": LAB_STEPS, "config": settings,
           "output": {"his_file": his, "nhis": LAB_STEPS,
                      "ninfo": LAB_STEPS // 2}}
    with open(run, "w") as f:      # JSON, which is YAML too
        json.dump(doc, f, indent=1)
    argv = ["run", run, "--device", str(device)]
    before = diag_cuda.grid_flux.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    lines = out.getvalue().splitlines()
    print(f"[coastal-file] python -m roms_tpu_torch {' '.join(argv)} "
          f"(case: file, {len(settings)} config fields): exit {rc}",
          flush=True)
    for ln in lines[:1] + [ln for ln in lines if "KE=" in ln]:
        print(f"[coastal-file] | {ln}")
    check(rc == 0, f"the file-driven CLI run exited {rc}")
    check(diag_cuda.grid_flux.launches - before == LAB_STEPS,
          "the file-driven run did not launch grid_flux once a step")
    h = read_history(his)
    worst = 0.0
    errs = []
    for var, ref in (("zeta", straight.zeta), ("u", straight.u),
                     ("v", straight.v), ("temp", straight.t[0])):
        want = interior(cfg, ref).cpu().numpy()
        err = float(np.abs(np.asarray(h[var][-1], np.float64) - want).max())
        errs.append(f"{var} {err:.3e}")
        worst = max(worst, err)
    print(f"[coastal-file] HIS record of step {LAB_STEPS} against "
          f"{LAB_STEPS} analytic steps: max |file - analytic| "
          f"{', '.join(errs)} (bound {FILE_RUN_ATOL:g}, roms_tpu's "
          f"tests/test_gridfile.py)  {'OK' if worst <= FILE_RUN_ATOL else 'FAIL'}",
          flush=True)
    check(worst <= FILE_RUN_ATOL, "the file-driven run misses the analytic")


def lab_canyon_physics(device, cfg, grid, s0, straight):
    """Phase 14 (c): tests/test_cases4.py's LAB_CANYON checks at full
    size: |u|, |v| < 2e-3 m/s after LAB_STEPS steps at rest, angler
    spanning (-3, 3), and a constant tracer under a free-surface bump
    within 2e-5 of its value after LAB_CONSTANCY_STEPS steps."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.ops import bc
    umax = float(straight.u.abs().max())
    vmax = float(straight.v.abs().max())
    amin, amax = float(grid.angler.min()), float(grid.angler.max())
    t3 = torch.full_like(s0.t, 3.0)
    s2 = s0.replace(t=t3, t_prev=t3.clone(), zeta=bc.fill_halo(
        cfg, 5.0e-4 * torch.cos(3.0 * grid.angler)))
    s2 = stepping.run(cfg, grid, s2, LAB_CONSTANCY_STEPS, None)
    drift = float((s2.t - 3.0).abs().max())
    finite = bool(torch.isfinite(straight.zeta).all())
    ok = finite and umax < 2e-3 and vmax < 2e-3 and amin < -3.0 and \
        amax > 3.0 and drift < 2e-5
    print(f"[coastal-physics] lab_canyon {cfg.Lm}x{cfg.Mm}x{cfg.N} after "
          f"{LAB_STEPS} float64 steps: max|u| {umax:.3e}, max|v| "
          f"{vmax:.3e} m/s (< 2e-3); angler in [{amin:.4f}, {amax:.4f}] "
          f"(spans (-3, 3)); constant tracer after {LAB_CONSTANCY_STEPS} "
          f"steps off by {drift:.3e} (< 2e-5); finite={finite}  "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    check(ok, "lab_canyon: the physics checks failed")


def inlet_physics(device, smi, cfg, grid, s0, ffn):
    """Phase 14 (d): INLET_TEST's checks (tests/test_cases4.py and
    tests/test_wetdry.py) in float64: the ebb through the throat grows
    from step 15 to INLET_STEPS, some water cells are dry at the end, and
    no cell's total depth falls below half the critical depth; returns
    ms/step."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.ops import wetdry
    H = cfg.halo
    s = s0
    fluxes = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in range(INLET_STEPS):
        s = stepping.step(cfg, grid, s, ffn)
        if n % 15 == 14:
            fluxes.append(float(s.vbar[H + cfg.Mm // 2,
                                       H:H + cfg.Lm].sum()))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / INLET_STEPS
    dry = (wetdry.rho_wet(cfg, grid, s.zeta) == 0) & (grid.rmask == 1)
    ndry = int(interior(cfg, dry).sum())
    depth = float(interior(cfg, s.zeta + grid.h).min())
    finite = bool(torch.isfinite(s.zeta).all() and torch.isfinite(s.u).all())
    ok = finite and abs(fluxes[-1]) > abs(fluxes[0]) and ndry > 0 and \
        depth > 0.5 * cfg.dcrit
    print(f"[coastal-physics] inlet_test {cfg.Lm}x{cfg.Mm}x{cfg.N} "
          f"(generated grid, nfast {cfg.nfast}), {INLET_STEPS} float64 "
          f"steps ({INLET_STEPS * cfg.dt:g} s): {ms:.1f} ms/step on {smi}; "
          f"sum of vbar across the throat at steps 15, 30, 45: "
          + ", ".join(f"{f:.4e}" for f in fluxes)
          + f" (|45| > |15|); dry water cells {ndry} (> 0); min total depth "
          f"{depth:.6f} m (> 0.5 dcrit = {0.5 * cfg.dcrit:g}); "
          f"finite={finite}  {'OK' if ok else 'FAIL'}", flush=True)
    check(ok, "inlet_test: the physics checks failed")
    return ms


def tide_physics(device, cfg, grid, s0):
    """Phase 14 (e): tests/test_tides_avg.py's check at BENCHMARK1's size:
    from rest, TIDE_STEPS steps with the equilibrium-tide force give
    0 < |u| < 0.5 m/s; returns ms/step."""
    import torch
    from roms_tpu_torch import stepping
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s0, TIDE_STEPS, None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TIDE_STEPS
    umax = float(s.u.abs().max())
    ok = bool(torch.isfinite(s.u).all()) and 0.0 < umax < 0.5
    print(f"[coastal-physics] BENCHMARK1 {cfg.Lm}x{cfg.Mm}x{cfg.N} with the "
          f"tide-generating force, {TIDE_STEPS} float64 steps from rest: "
          f"max|u| {umax:.4e} m/s (0 < |u| < 0.5)  {'OK' if ok else 'FAIL'}",
          flush=True)
    check(ok, "tide: the physics check failed")
    return ms


def coastal_fixture(device, tmp):
    """Phase 14 (f): the small cases and the wet/dry fast loop against
    tests/data/torch_coastal_small.npz at CARD_FACTOR times the CPU
    bounds."""
    import numpy as np
    from roms_tpu_torch import stepping
    from roms_tpu_torch.ops import step2d
    fx = coastal_fixture_script()
    ref = np.load(fx.OUT)
    for name in fx.CASES:
        cfg, grid, s0, ffn = fx.build_port(name, tmp, device=device)
        s = stepping.run(cfg, grid, s0, fx.NSTEPS, ffn)
        errors = fx.errors(name, cfg, s0, s, ref, factor=CARD_FACTOR)
        worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
        print(f"[coastal-fixture] {name}: worst against its bound: "
              f"{worst[0]} {worst[1][0]:.3e} (bound {worst[1][1]:g})",
              flush=True)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        check(not bad, f"the small {name} misses its fixture: {bad}")
    cfg, grid, _, _ = fx.build_port("inlet_test", tmp, device=device)
    errors = fx.wetdry_errors(fx.port_wetdry_loop(step2d, cfg, grid), ref,
                              factor=CARD_FACTOR)
    worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
    print(f"[coastal-fixture] wet/dry fast loop: worst against its bound: "
          f"{worst[0]} {worst[1][0]:.3e} (bound {worst[1][1]:g})",
          flush=True)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    check(not bad, f"the wet/dry fast loop misses its fixture: {bad}")


def coastal_phase(device, smi):
    """Phase 14: LAB_CANYON, INLET_TEST and BENCHMARK1 with tides at full
    size: (a) kernels against plain on each case's arguments and (a')
    kernels on against off, (b) LAB_CANYON through a grid file and the
    CLI, (c) LAB_CANYON's physics, (d) INLET_TEST's, (e) the tide's,
    (f) the small fixture, and ms/step."""
    import tempfile
    import torch
    from roms_tpu_torch import stepping
    t_phase = t_part = time.perf_counter()
    parts = {}

    def lap(part):
        nonlocal t_part
        now = time.perf_counter()
        parts[part] = now - t_part
        t_part = now

    fx = coastal_fixture_script()
    with tempfile.TemporaryDirectory() as tmp:
        developed = {}
        for name in COASTAL:
            cfg, grid, s0, ffn = coastal_case(name, device, tmp)
            developed[name] = (cfg, grid, stepping.run(
                cfg.replace(pallas2d=False), grid, s0, 3, ffn), ffn)
        lap("set-up")
        case_kernel_checks("coastal", COASTAL,
                           lambda n, d: coastal_case(n, device, tmp, d),
                           COASTAL_KERNELS, developed)
        lap("a")
        launches = {name: kernels_on_off(
            "coastal-equiv", name, *developed[name], COASTAL_KERNELS[name],
            fx, COASTAL_EQUIV_STEPS) for name in COASTAL}
        del developed
        lap("a'")
        ms64 = {}
        cfg, grid, s0, ffn = coastal_case("lab_canyon", device, tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        straight = stepping.run(cfg, grid, s0, LAB_STEPS, ffn)
        torch.cuda.synchronize()
        ms64["lab_canyon"] = ((time.perf_counter() - t0) * 1e3 / LAB_STEPS,
                              LAB_STEPS)
        lab_canyon_file_run(device, tmp, cfg, grid, s0, straight)
        lap("b")
        lab_canyon_physics(device, cfg, grid, s0, straight)
        del straight
        lap("c")
        ms64["inlet_test"] = (inlet_physics(
            device, smi, *coastal_case("inlet_test", device, tmp)),
            INLET_STEPS)
        lap("d")
        cfg, grid, s0, _ = coastal_case("tide", device, tmp)
        ms64["tide"] = (tide_physics(device, cfg, grid, s0), TIDE_STEPS)
        lap("e")
        coastal_fixture(device, tmp)
        lap("f")
        case_times("coastal-times", COASTAL,
                   lambda n, d: coastal_case(n, device, tmp, d), smi,
                   launches, ms64)
        lap("times")
    print(f"[coastal] phase 14 took {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")",
          flush=True)


# phase 15: the operator cases at their published sizes: the other
# pressure-gradient schemes, biharmonic, isopycnal and rotated mixing, and
# C2/U1/A4 advection in the tracer kernels (rows 1-3 and 8-11 on all)
PG_SCHEMES = ("djs", "dj", "pj", "pjq2", "pjq4")
OPERATORS = ("basin", "double_gyre", "grav_adj", "canyon3d", "overflow",
             "windbasin", "channel_neck") + tuple(
                 f"seamount_{s}" for s in PG_SCHEMES)
_ROWS_STEP = ("grid_flux", "eos", "omega", "tracer_predictor",
              "tracer_corrector", "uv_corrector", "fast_loop")
_FUSED = _ROWS_STEP + ("prsgrd32", "rhs3d")
OPERATOR_KERNELS = {
    "basin": _ROWS_STEP + ("prsgrd32",),
    "double_gyre": _FUSED + ("uv3dmix2",),
    "grav_adj": _ROWS_STEP + ("prsgrd32", "uv3dmix2"),
    "canyon3d": _FUSED + ("uv3dmix2",),
    "overflow": _ROWS_STEP + ("prsgrd32", "uv3dmix2"),
    "windbasin": _ROWS_STEP + ("prsgrd32",),
    "channel_neck": _ROWS_STEP + ("prsgrd32",),
    "seamount_djs": _FUSED,
    **{f"seamount_{s}": _ROWS_STEP for s in PG_SCHEMES[1:]},
    # the options no case uses, on the fixture's small UPWELLING
    "upw_smagorinsky": _ROWS_STEP + ("prsgrd32",),
    "upw_t4_geo": _FUSED + ("uv3dmix2",),
    "upw_t4_iso": _FUSED + ("uv3dmix2",),
    "upw_uv4_geo": _ROWS_STEP + ("prsgrd32",)}
OPTIONS = ("upw_smagorinsky", "upw_t4_geo", "upw_t4_iso", "upw_uv4_geo")
# the (horizontal, vertical) advection schemes rows 8 and 9 are held to
# their plain versions under, beside the main path's U3/C4
SCHEME_PAIRS = (("C2", "C2"), ("U1", "U1"), ("A4", "A4"), ("A4", "SPLINES"),
                ("C2", "C4"), ("U3", "A4"))
OPERATOR_EQUIV_STEPS = 3
# roms_tpu's physics tests (tests/test_cases.py, test_cases_extra.py,
# test_cases4.py): their steps, and the sizes their thresholds were set
# at; SEAMOUNT runs at its published size, whose spurious current after
# 10 steps is checked and after 100 (1.7 h) is the figure users compare
OPERATOR_PHYSICS_STEPS = {"basin": 10, "double_gyre": 24, "grav_adj": 30,
                          "canyon3d": 10, "overflow": 240, "windbasin": 400,
                          "channel_neck": 25,
                          **{f"seamount_{s}": 100 for s in PG_SCHEMES}}
OPERATOR_PHYSICS_SIZES = {
    "basin": dict(Lm=45, Mm=35, N=6),
    "double_gyre": dict(Lm=27, Mm=54, N=4, dt=1800.0),
    "grav_adj": dict(Lm=64, Mm=4, N=20),
    "canyon3d": dict(Lm=33, Mm=24, N=8),
    "overflow": dict(Mm=64, N=12),
    "windbasin": dict(Lm=40, Mm=20, N=12),
    "channel_neck": dict(Lm=32, Mm=12, N=4, ndtfast=8)}
SEAMOUNT_CHECK_STEPS = 10


def operators_fixture_script():
    """scripts/torch_operators_fixture.py as a module."""
    return _script("torch_operators_fixture")


def operator_case(name, device, dtype="float64", **sizes):
    """(cfg, grid, state0, forcing_fn) of a phase-15 case at its published
    sizes unless `sizes` cut them; "seamount_<scheme>" is SEAMOUNT under
    that pressure-gradient scheme."""
    from roms_tpu_torch.models import cases
    if name.startswith("seamount_"):
        return cases.seamount(cases.seamount_config(
            dtype=dtype, prsgrd_scheme=name.split("_", 1)[1], **sizes),
            device=device)
    return model_case("cases4" if name == "channel_neck" else "cases", name,
                      device, dtype, **sizes)


def tracer_scheme_checks(results, device, developed):
    """Phase 15 (c): rows 8 and 9 on BASIN's and UPWELLING's step arguments
    (developed: {case: (cfg, grid, state, ffn)}) under each pair of
    SCHEME_PAIRS for every tracer, and under U3/C4 to compare, float64
    and float32: bitwise their plain versions, a second launch bitwise
    the first, timed with their bound."""
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS
    for case, (_, _, s, _) in developed.items():
        for dtype in ("float64", "float32"):
            if case == "upwelling":
                cfg, grid, _, ffn = upwelling.build(
                    upwelling.make_config(dtype=dtype), device=device)
            else:
                cfg, grid, _, ffn = operator_case(case, device, dtype)
            state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                                 for k in TENSOR_FIELDS})
            calls = captured_calls(cfg, grid, state, ffn)
            nt = cfg.ntracers
            cases = []
            for h, v in (("U3", "C4"),) + SCHEME_PAIRS:
                for name in ("tracer_predictor", "tracer_corrector"):
                    args, kw = calls[name]
                    c = args[0].replace(t_hadv=(h,) * nt, t_vadv=(v,) * nt)
                    cases.append((f"{case}:{name}[{h}/{v}]", name,
                                  (c,) + args[1:], kw))
            check_variants("operators-schemes", grid, cases, dtype, results)


def operator_physics(device, smi):
    """Phase 15 (d): the physics of roms_tpu's case tests in float64, at
    their sizes (OPERATOR_PHYSICS_SIZES; SEAMOUNT at its published size),
    with ms/step."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping, vgrid
    from roms_tpu_torch.grid import hc_of
    ms = {}

    def run(cfg, grid, s, n, ffn, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = stepping.run(cfg, grid, s, n, ffn)
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3 / n, n)
        return s

    def report(name, cfg, ok, what):
        n = OPERATOR_PHYSICS_STEPS[name]
        print(f"[operators-physics] {name} {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} "
              f"float64 steps: {ms[name][0]:.1f} ms/step on {smi}; {what}  "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name}: the physics signature failed")

    def inner(cfg, a):
        return interior(cfg, a).cpu().numpy()

    for scheme in PG_SCHEMES:
        name = f"seamount_{scheme}"
        cfg, grid, s0, ffn = operator_case(name, device)
        s = run(cfg, grid, s0, SEAMOUNT_CHECK_STEPS, ffn, name)
        u10 = float(np.abs(inner(cfg, s.u)).max())
        s = run(cfg, grid, s0, OPERATOR_PHYSICS_STEPS[name], ffn, name)
        u100 = float(np.abs(inner(cfg, s.u)).max())
        v100 = float(np.abs(inner(cfg, s.v)).max())
        report(name, cfg, np.isfinite(u100) and u10 < 0.05,
               f"spurious max|u| {u10:.4e} m/s after "
               f"{SEAMOUNT_CHECK_STEPS} steps (< 0.05), max|u| {u100:.4e}, "
               f"max|v| {v100:.4e} m/s after "
               f"{OPERATOR_PHYSICS_STEPS[name]} steps "
               f"({OPERATOR_PHYSICS_STEPS[name] * cfg.dt / 3600.0:g} h)")

    def case(name):
        return operator_case(name, device, **OPERATOR_PHYSICS_SIZES[name])

    name = "grav_adj"
    cfg, grid, s0, ffn = case(name)
    s = run(cfg, grid, s0, OPERATOR_PHYSICS_STEPS[name], ffn, name)
    u = inner(cfg, s.u)
    mid = u.shape[2] // 2
    top, bot = float(u[-1, :, mid].mean()), float(u[0, :, mid].mean())
    report(name, cfg, bool(np.isfinite(inner(cfg, s.t)).all()) and
           top > 1e-3 and bot < -1e-3,
           f"u at the lock, surface {top:.4e} (> 1e-3), bottom {bot:.4e} "
           f"m/s (< -1e-3)")

    name = "double_gyre"
    cfg, grid, s0, ffn = case(name)
    s = run(cfg, grid, s0, OPERATOR_PHYSICS_STEPS[name], ffn, name)
    ke = float((inner(cfg, s.u) ** 2).mean())
    report(name, cfg, bool(np.isfinite(inner(cfg, s.zeta)).all()) and
           0.0 < ke < 1.0, f"mean u^2 {ke:.4e} m2/s2 (in (0, 1))")

    for name in ("basin", "canyon3d"):
        cfg, grid, s0, ffn = case(name)
        s = run(cfg, grid, s0, OPERATOR_PHYSICS_STEPS[name], ffn, name)
        umax = float(np.abs(inner(cfg, s.u)).max())
        finite = bool(np.isfinite(inner(cfg, s.t)).all() and
                      np.isfinite(umax))
        report(name, cfg, finite and (name != "basin" or umax < 1.0),
               f"finite={finite}, max|u| {umax:.4e} m/s" +
               (" (< 1)" if name == "basin" else ""))

    name = "overflow"
    cfg, grid, s0, ffn = case(name)

    def cold_depth(s):
        z_r, _, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                                     grid.Cs_r, grid.sc_w, grid.Cs_w,
                                     cfg.vtransform)
        cold = torch.clamp(5.0 - s.t[0], min=0.0) * Hz
        cold, z_r = interior(cfg, cold), interior(cfg, z_r)
        return float((cold * z_r).sum() / cold.sum())

    z0 = cold_depth(s0)
    s = run(cfg, grid, s0, OPERATOR_PHYSICS_STEPS[name], ffn, name)
    z1 = cold_depth(s)
    vmax = float(s.v.abs().max())
    report(name, cfg, bool(torch.isfinite(s.t).all()) and z1 < z0 - 5.0 and
           vmax > 0.05, f"the cold water's centre of mass from {z0:.2f} to "
           f"{z1:.2f} m (at least 5 m deeper), max|v| {vmax:.4f} m/s "
           f"(> 0.05)")

    name = "windbasin"
    cfg, grid, s0, ffn = case(name)
    s = run(cfg, grid, s0, OPERATOR_PHYSICS_STEPS[name], ffn, name)
    u = inner(cfg, s.u)
    ub = float(np.abs(inner(cfg, s.ubar)).max())
    report(name, cfg, bool(np.isfinite(u).all()) and u[-1].mean() < 0.0
           and u[0].mean() > 0.0 and ub < 0.5 * np.abs(u[-1]).max(),
           f"mean surface u {u[-1].mean():.4e} (< 0), mean bottom u "
           f"{u[0].mean():.4e} m/s (> 0), max|ubar| {ub:.4e} (< half of "
           f"max|u surface| {np.abs(u[-1]).max():.4e})")

    name = "channel_neck"
    cfg, grid, s0, ffn = case(name)
    s = run(cfg, grid, s0, OPERATOR_PHYSICS_STEPS[name], ffn, name)
    u = s.u.cpu().numpy()
    land = float(np.abs(u * (1.0 - grid.umask.cpu().numpy())).max())
    # the neck: the middle fifth of the channel's length, its wet rows
    xr, yr = grid.xr.cpu().numpy(), grid.yr.cpu().numpy()
    Xsize, Esize = 1.0 / float(grid.pm[0, 0]) * cfg.Lm, \
        1.0 / float(grid.pn[0, 0]) * cfg.Mm
    cols = np.abs(xr[0] - 0.5 * Xsize) < 0.1 * Xsize
    rows = np.abs(yr[:, 0] - 0.5 * Esize) < Esize / 6.0
    neck = float(np.abs(u[:, rows][:, :, cols]).max())
    umax = float(np.abs(u).max())
    report(name, cfg, bool(np.isfinite(u).all()) and umax > 1e-3 and
           land == 0.0 and neck >= 0.5 * umax,
           f"max|u| {umax:.4e} m/s (> 1e-3), on land faces {land:g} (= 0), "
           f"in the neck {neck:.4e} (at least half the maximum)")


def operator_fixture(device):
    """Phase 15 (e): the small cases with the kernels on against
    tests/data/torch_operators_small.npz, at CARD_FACTOR times the CPU
    test's bounds."""
    import numpy as np
    from roms_tpu_torch import stepping
    fx = operators_fixture_script()
    ref = np.load(fx.OUT)
    for name in fx.CASES:
        cfg, grid, s0, ffn = fx.build_port(name, device=device)
        s = stepping.run(cfg, grid, s0, fx.NSTEPS, ffn)
        errors = fx.errors(name, cfg, s0, s, ref, factor=CARD_FACTOR)
        worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
        print(f"[operators-fixture] {name}: worst against its bound: "
              f"{worst[0]} {worst[1][0]:.3e} (bound {worst[1][1]:g})",
              flush=True)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        check(not bad, f"the small {name} misses its fixture: {bad}")


def operators_phase(device, smi):
    """Phase 15: the operator cases at their published sizes: (a) kernels
    against plain on each case's arguments, (b) kernels on against off,
    (c) rows 8-9 under the other advection schemes, (c') the options no
    case uses, (d) the physics, (e) the small fixture, (f) ms/step."""
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling
    fx = operators_fixture_script()

    def schemes():
        developed = {}
        for case, (cfg, grid, s0, ffn) in (
                ("basin", operator_case("basin", device)),
                ("upwelling", upwelling.build(upwelling.make_config(),
                                              device=device))):
            developed[case] = (cfg, grid, stepping.run(
                cfg.replace(pallas2d=False), grid, s0, 3, ffn), ffn)
        tracer_scheme_checks({}, device, developed)

    def options():
        for name in OPTIONS:
            cfg, grid, s0, ffn = fx.build_port(name, device=device)
            s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
            kernels_on_off("operators-options", name, cfg, grid, s, ffn,
                           OPERATOR_KERNELS[name], fx, OPERATOR_EQUIV_STEPS)

    case_family_phase(
        "operators", 15, smi, OPERATORS,
        lambda n, d: operator_case(n, device, d), OPERATOR_KERNELS, fx,
        OPERATOR_EQUIV_STEPS,
        [("c", schemes), ("c'", options),
         ("d", lambda: operator_physics(device, smi)),
         ("e", lambda: operator_fixture(device))],
        tiles=("grav_adj", "overflow"))


# phase 16: KPP double diffusion (LMD_TEST, BL_TEST), the ice shelf
# (WEDDELL), GLS with Craig-Banner (MIXED_LAYER), the ramped open flume
# (TEST_CHAN), wall sources (RIVERPLUME2), CHANNEL's balanced jet, mean age
# and the 2-D-only step (SOLITON).  The JAX gates keep rows 8-11 plain
# under bry, sources and the radiation boundaries, and rows 1 and 3 under
# the ice draft.
CASES2 = ("channel", "lmd_test", "mixed_layer", "test_chan", "riverplume2",
          "weddell", "bl_test")
_DIAG3 = ("grid_flux", "eos", "omega")
_COLUMN_ROWS = ("tracer_predictor", "tracer_corrector", "uv_corrector",
                "fast_loop")
CASES2_KERNELS = {
    "channel": _DIAG3 + ("prsgrd32", "rhs3d", "uv3dmix2") + _COLUMN_ROWS,
    "lmd_test": _DIAG3 + ("prsgrd32", "rhs3d") + _COLUMN_ROWS,
    "mixed_layer": _DIAG3 + ("prsgrd32", "rhs3d") + _COLUMN_ROWS,
    "test_chan": _DIAG3 + ("prsgrd32", "rhs3d"),
    "riverplume2": _DIAG3 + ("prsgrd32", "rhs3d"),
    "weddell": ("omega", "prsgrd32", "rhs3d", "uv3dmix2"),
    "bl_test": _DIAG3 + ("prsgrd32", "rhs3d")}
CASES2_EQUIV_STEPS = 3
# roms_tpu's physics tests (tests/test_cases3.py, test_step2d.py,
# test_step3d.py): their steps and sizes
CASES2_PHYSICS_STEPS = {"channel": 35, "lmd_test": 240, "mixed_layer": 240,
                        "test_chan": 300, "riverplume2": 120,
                        "weddell": 500, "weddell_rest": 20, "bl_test": 120,
                        "soliton": 400, "age_mean": 3}
# the checks that take about a minute or more on the card (the general
# plain fast loop's launches: TEST_CHAN 79 s, WEDDELL 162 s, BL_TEST 43-70
# s, RIVERPLUME2 34-58 s), run by --cases2-long
CASES2_LONG = ("test_chan", "riverplume2", "weddell", "bl_test")


cases2_case = functools.partial(model_case, "cases2")


def cases2_physics(device, smi, long):
    """Phase 16 (d): the physics of roms_tpu's tests of these cases in
    float64, with ms/step; CASES2_LONG only when `long`."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping, vgrid
    from roms_tpu_torch.config import GLSParams, LBC
    from roms_tpu_torch.grid import hc_of
    from roms_tpu_torch.models import soliton, upwelling
    from roms_tpu_torch.ops import eos, step2d, vmix
    ms = {}

    def run(cfg, grid, s, n, ffn, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = stepping.run(cfg, grid, s, n, ffn)
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3 / n, n)
        return s

    def report(name, cfg, ok, what):
        n = CASES2_PHYSICS_STEPS[name]
        print(f"[cases2-physics] {name} {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} "
              f"float64 steps: {ms[name][0]:.1f} ms/step on {smi}; {what}  "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name}: the physics signature failed")

    def inner(cfg, a):
        return interior(cfg, a).cpu().numpy()

    def finite(s):
        return all(bool(torch.isfinite(getattr(s, k)).all())
                   for k in ("zeta", "ubar", "vbar", "u", "v", "t"))

    name = "channel"
    cfg, grid, s0, ffn = cases2_case(name, device)
    s = run(cfg, grid, s0, CASES2_PHYSICS_STEPS[name], ffn, name)
    u0, u1 = inner(cfg, s0.u), inner(cfg, s.u)
    j0 = np.unravel_index(u0[-1].argmax(), u0[-1].shape)[0]
    j1 = np.unravel_index(u1[-1].argmax(), u1[-1].shape)[0]
    report(name, cfg, finite(s) and abs(u1.max() - u0.max()) <
           0.15 * u0.max() and abs(j1 - j0) <= 1,
           f"jet max u {u0.max():.4f} -> {u1.max():.4f} m/s (within 15%), "
           f"its row {j0} -> {j1} (within one)")

    name = "lmd_test"
    cfg, grid, s0, ffn = cases2_case(name, device, N=30)
    s = run(cfg, grid, s0, CASES2_PHYSICS_STEPS[name], ffn, name)
    depth = float(-inner(cfg, s.hsbl).mean())
    akt = s.Akt
    report(name, cfg, finite(s) and depth > 3.0 and
           bool(torch.isfinite(akt).all()) and float(akt.min()) >= 0.0,
           f"mean surface boundary layer depth {depth:.3f} m (> 3), min "
           f"Akt {float(akt.min()):.3e} (>= 0)")

    # the DDMIX unit check of tests/test_cases3.py:100 on the card
    cfg = dataclasses.replace(
        upwelling.make_config(Lm=8, Mm=8, N=12, ndtfast=6), vmix="kpp",
        lmd_ddmix=True, eos="jm95", tnu2=(0.0, 0.0), akt_bak=(1e-6, 1e-6))
    cfg, grid, s, _ = upwelling.build(cfg, device=device)
    z_r, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                                   grid.Cs_r, grid.sc_w, grid.Cs_w,
                                   cfg.vtransform)
    tr = torch.stack([14.0 + 8.0 * z_r / 150.0, 35.0 + 1.5 * z_r / 150.0])
    rho, pden, bvf = eos.rho_eos_pden_bvf(cfg, tr, z_r, z_w)
    zero = torch.zeros_like(s.zeta)
    args = (s.u, s.v, tr, rho, pden, bvf, Hz, z_r, z_w, zero, zero, zero,
            zero, torch.zeros_like(tr[:, 0]), zero, s.hsbl)
    Akt = vmix.lmd_vmix(cfg, grid, *args)[1]
    Akt0 = vmix.lmd_vmix(dataclasses.replace(cfg, lmd_ddmix=False), grid,
                         *args)[1]
    H = cfg.halo
    dS = float((Akt[1] - Akt0[1])[3:-3, H + 2, H + 2].max())
    dT = float((Akt[0] - Akt0[0])[3:-3, H + 2, H + 2].max())
    ok = dS > 1e-5 and dT > 1e-6 and dS > dT
    print(f"[cases2-physics] ddmix: salt fingering adds {dS:.4e} to the salt "
          f"and {dT:.4e} to the heat diffusivity (> 1e-5, > 1e-6, salt > "
          f"heat)  {'OK' if ok else 'FAIL'}", flush=True)
    check(ok, "the DDMIX unit check failed")

    name = "mixed_layer"
    cfg, grid, s0, ffn = cases2_case(name, device)
    s = run(cfg, grid, s0, CASES2_PHYSICS_STEPS[name], ffn, name)
    s2 = stepping.run(dataclasses.replace(cfg, gls_params=GLSParams()),
                      grid, s0, CASES2_PHYSICS_STEPS[name], ffn)
    tke_cb = float(inner(cfg, s.tke[-1]).mean())
    tke_plain = float(inner(cfg, s2.tke[-1]).mean())
    t0, t1 = inner(cfg, s0.t[0]), inner(cfg, s.t[0])
    d0, d1 = (t0[-1] - t0[-6]).mean(), (t1[-1] - t1[-6]).mean()
    report(name, cfg, finite(s) and tke_cb > 3.0 * tke_plain and
           d0 > 2.0 * d1, f"surface tke {tke_cb:.4e} with Craig-Banner, "
           f"{tke_plain:.4e} without (over 3x); surface - 5 levels down "
           f"{d0:.4f} -> {d1:.4f} degC (mixed layer: under half)")

    if long:
        name = "test_chan"
        cfg, grid, s0, ffn = cases2_case(name, device)
        s = run(cfg, grid, s0, CASES2_PHYSICS_STEPS[name], ffn, name)
        ub, z = inner(cfg, s.ubar), inner(cfg, s.zeta)
        report(name, cfg, finite(s) and ub.mean() > 0.005 and
               z[:, -1].mean() < z[:, 0].mean(),
               f"mean ubar {ub.mean():.4e} m/s (> 0.005), zeta west "
               f"{z[:, 0].mean():.4e} east {z[:, -1].mean():.4e} m (tilting "
               f"down)")

    if long:
        name = "riverplume2"
        cfg, grid, s0, ffn = cases2_case(name, device)
        s = run(cfg, grid, s0, CASES2_PHYSICS_STEPS[name], ffn, name)
        salt = inner(cfg, s.t[1])[-1]
        wet = inner(cfg, grid.rmask) > 0
        vb = inner(cfg, s.vbar)
        report(name, cfg, finite(s) and salt[wet].min() < cfg.S0 - 0.5 and
               vb[wet].mean() < -0.005,
               f"min surface salt {salt[wet].min():.4f} (< S0 - 0.5 = "
               f"{cfg.S0 - 0.5:g}), mean vbar {vb[wet].mean():.4e} m/s "
               f"(< -0.005)")

    if long:
        name = "weddell"
        cfg, grid, s0, ffn = cases2_case(name, device, Lm=150)
        z_cav = []
        s = s0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CASES2_PHYSICS_STEPS[name]):
            s = stepping.step(cfg, grid, s, ffn)
            z_cav.append(s.zeta[cfg.halo, cfg.halo + 2])
        z_cav = torch.stack(z_cav).cpu().numpy()
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3 /
                    CASES2_PHYSICS_STEPS[name], CASES2_PHYSICS_STEPS[name])
        H = cfg.halo
        ubmax = float(s.ubar.abs().max())
        ucav = float(s.u[-1, H:H + cfg.Mm, H:H + 16].abs().max())
        report(name, cfg, finite(s) and z_cav.std() > 0.03 and
               np.abs(z_cav).max() < 2.0 and ubmax < 1.0 and ucav < 1.0,
               f"cavity zeta std {z_cav.std():.4f} m (> 0.03), max "
               f"{np.abs(z_cav).max():.4f} (< 2), max|ubar| {ubmax:.4f} "
               f"(< 1), max|u| under the ice {ucav:.4f} m/s (< 1)")

    name = "weddell_rest"
    cfg, grid, s0, _ = cases2_case("weddell", device, Lm=80)
    clo = LBC("Clo", "Per", "Clo", "Per")
    cfg = dataclasses.replace(cfg, lbc_zeta=clo, lbc_ubar=clo, lbc_vbar=clo,
                              lbc_u=clo, lbc_v=clo, lbc_t=clo)
    s = run(cfg, grid, s0, CASES2_PHYSICS_STEPS[name], None, name)
    ub = float(s.ubar[cfg.halo:-cfg.halo, cfg.halo:-cfg.halo].abs().max())
    zm = float(s.zeta[cfg.halo:-cfg.halo, cfg.halo:-cfg.halo].abs().max())
    report(name, cfg, finite(s) and ub < 0.3 and zm < 0.5,
           f"closed cavity: max|ubar| {ub:.4e} m/s (< 0.3), max|zeta| "
           f"{zm:.4e} m (< 0.5)")

    if long:
        name = "bl_test"
        cfg, grid, s0, ffn = cases2_case(name, device)
        s = run(cfg, grid, s0, CASES2_PHYSICS_STEPS[name], ffn, name)
        H = cfg.halo
        hsbl = -s.hsbl[H:-H, H:-H].cpu().numpy()
        vb = s.vbar[H:-H, H:-H].cpu().numpy()
        report(name, cfg, finite(s) and hsbl.mean() > 2.0 and
               vb.max() > 0.2 and vb.mean() > 0.02,
               f"mean boundary layer depth {hsbl.mean():.3f} m (> 2), vbar "
               f"max {vb.max():.4f} (> 0.2), mean {vb.mean():.4f} m/s "
               f"(> 0.02)")

    name = "soliton"
    cfg, grid, fs0 = soliton.build(soliton.make_config(), device=device)

    def run2d(fs, n):
        for i in range(n):
            fs = step2d.step_2d_only(cfg, grid, fs, i == 0)
        return fs

    z = torch.zeros_like(fs0.zeta_n)
    rest = run2d(step2d.make_fast_state(cfg, z, z, z), 10)
    at_rest = all(float(getattr(rest, k).abs().max()) == 0.0
                  for k in step2d.FS_FIELDS)
    area = interior(cfg, grid.omn)
    vol0 = float((interior(cfg, fs0.zeta_n) * area).sum())
    vol = float((interior(cfg, run2d(fs0, 100).zeta_n) * area).sum())
    n = CASES2_PHYSICS_STEPS[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs = run2d(fs0, n)
    torch.cuda.synchronize()
    ms[name] = ((time.perf_counter() - t0) * 1e3 / n, n)
    z0, z1 = inner(cfg, fs0.zeta_n), inner(cfg, fs.zeta_n)
    x0 = np.unravel_index(np.argmax(z0), z0.shape)[1]
    x1 = np.unravel_index(np.argmax(z1), z1.shape)[1]
    expected = n * cfg.dt / 3.0 / 0.5       # cells west (dx = 0.5)
    report(name, cfg, at_rest and abs(vol - vol0) < 1e-10 * max(
        1.0, abs(vol0)) and bool(np.isfinite(z1).all()) and
        z1.max() > 0.5 * z0.max() and -2.0 * expected < x1 - x0 <
        -0.5 * expected,
        f"rest stays at rest: {at_rest}; volume {vol0:.6e} -> {vol:.6e} "
        f"after 100 steps (within 1e-10); the peak {z0.max():.4f} -> "
        f"{z1.max():.4f} moved {x1 - x0} cells (west, expected "
        f"{-expected:g} within a factor of 2)")

    name = "age_mean"
    cfg, grid, st, ffn = upwelling.build(upwelling.make_config(),
                                         device=device)
    cfg, st = cases2_fixture_script().age_pair(cfg, st, torch.cat)
    n = CASES2_PHYSICS_STEPS[name]
    st = run(cfg, grid, st, n, ffn, name)
    C, A = inner(cfg, st.t[2]), inner(cfg, st.t[3])
    # roms_tpu's test: assert_allclose(C, 1, atol=1e-9) with its default
    # rtol of 1e-7, and A/C against n dt at rtol 1e-7
    report(name, cfg, float(np.abs(C - 1.0).max()) <= 1e-9 + 1e-7 and
           float(np.abs(A / C / (n * cfg.dt) - 1.0).max()) <= 1e-7,
           f"4-tracer UPWELLING: max|C - 1| {np.abs(C - 1.0).max():.3e} "
           f"(<= 1e-9 + 1e-7), max|A/C / ({n} dt) - 1| "
           f"{np.abs(A / C / (n * cfg.dt) - 1.0).max():.3e} (< 1e-7)")


def cases2_fixture(device):
    """Phase 16 (c): the small cases with the kernels on against
    tests/data/torch_cases2_small.npz (SOLITON's 2-D steps included), at
    CARD_FACTOR times the CPU test's bounds."""
    import numpy as np
    fx = cases2_fixture_script()
    ref = np.load(fx.OUT)
    for name in fx.CASES:
        cfg, grid, s0, ffn = fx.build_port(name, device=device)
        s = fx.run_port(name, cfg, grid, s0, ffn)
        errors = fx.errors(name, cfg, s0, s, ref, factor=CARD_FACTOR)
        worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
        print(f"[cases2-fixture] {name}: worst against its bound: "
              f"{worst[0]} {worst[1][0]:.3e} (bound {worst[1][1]:g})",
              flush=True)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        check(not bad, f"the small {name} misses its fixture: {bad}")


def soliton_cli(device):
    """Phase 16 (e): `run --case soliton` exits 2, naming step_2d_only."""
    import io
    from roms_tpu_torch.__main__ import main as cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli(["run", "--case", "soliton", "--device", "cuda"])
    print(f"[cases2-cli] python -m roms_tpu_torch run --case soliton: exit "
          f"{rc}; {err.getvalue().strip()}", flush=True)
    check(rc == 2 and "step_2d_only" in err.getvalue(),
          "the 2-D-only case did not exit 2")


def soliton_times(device, smi):
    """Phase 16 (f): SOLITON's ms/step in float64 and float32, 100
    step_2d_only calls after the first."""
    import torch
    from roms_tpu_torch.models import soliton
    from roms_tpu_torch.ops import step2d
    for dtype in ("float64", "float32"):
        cfg, grid, fs = soliton.build(soliton.make_config(dtype=dtype),
                                      device=device)
        fs = step2d.step_2d_only(cfg, grid, fs, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fs = step2d.step_2d_only(cfg, grid, fs, False)
        torch.cuda.synchronize()
        print(f"[cases2-times] soliton {cfg.Lm}x{cfg.Mm} {dtype}: "
              f"{(time.perf_counter() - t0) * 10.0:.3f} ms/step (100 "
              f"step_2d_only calls, no kernel); on {smi}", flush=True)


def cases2_phase(device, smi, long=False):
    """Phase 16: CHANNEL, LMD_TEST, MIXED_LAYER, TEST_CHAN, RIVERPLUME2,
    WEDDELL and BL_TEST at their published sizes and SOLITON: (a) kernels
    against plain on each case's arguments, with the tiles at N = 50 and
    Mm = 4, (b) kernels on against off, (c) the small fixture, (d) the
    physics (CASES2_LONG's only when `long`), (e) LMD_TEST through the CLI
    with restarts and SOLITON's exit, (f) ms/step."""
    def cli():
        cli_restart_check(device, "cases2", "lmd_test", ("hsbl", "hbbl"),
                          "hsbl")
        soliton_cli(device)

    case_family_phase(
        "cases2", 16, smi, CASES2, lambda n, d: cases2_case(n, device, d),
        CASES2_KERNELS, cases2_fixture_script(), CASES2_EQUIV_STEPS,
        [("c", lambda: cases2_fixture(device)),
         ("d", lambda: cases2_physics(device, smi, long)),
         ("e", cli), ("f 2-D", lambda: soliton_times(device, smi))],
        tiles=("lmd_test", "bl_test"))


# phase 17: the sediment family.  MPDATA is not among the tracer kernels'
# schemes (LAKE_SIGNELL keeps rows 8-9 plain); SED_TEST1's bry and
# radiation/clamped ends keep rows 8-11 plain; SED_TOY runs UPWELLING's
# ten with a sediment class among the tracer kernels' three tracers.
SEDIMENT = ("sed_toy", "lake_signell", "sed_test1")
SEDIMENT_KERNELS = {
    "sed_toy": _DIAG3 + ("prsgrd32", "rhs3d", "uv3dmix2") + _COLUMN_ROWS,
    "lake_signell": _DIAG3 + ("prsgrd32", "rhs3d", "uv_corrector",
                              "fast_loop"),
    "sed_test1": _DIAG3 + ("prsgrd32", "rhs3d")}
SEDIMENT_EQUIV_STEPS = 3
# kernels on against off over those steps, relative to max|field|: one
# pass of round-off in the column sums of rows 1, 4, 7 and 10 (measured
# on an NVIDIA H100 80GB HBM3 at 700 W: at most 4.8e-15, LAKE_SIGNELL's
# rufrc0_prev)
SEDIMENT_EQUIV_RTOL = 1e-12
# roms_tpu's physics tests (tests/test_sediment.py, test_bbl.py,
# test_cases_extra.py:63, test_cases3.py:183): their steps
SEDIMENT_PHYSICS_STEPS = {"sed_toy": 30, "sed_toy_waves": 20,
                          "sed_morph": 5, "lake_signell": 120,
                          "sed_test1": 400}


def sediment_case(name, device, dtype="float64", **sizes):
    """(cfg, grid, state0, forcing_fn) of SED_TOY (models/sed_toy.py),
    LAKE_SIGNELL or SED_TEST1, at the published sizes unless `sizes` cut
    them; SED_TOY also takes `params` (SedParams) and `conc`."""
    if name == "sed_toy":
        from roms_tpu_torch.models import sed_toy
        conc = sizes.pop("conc", sed_toy.SED_INI)
        return sed_toy.build(sed_toy.make_config(dtype=dtype, **sizes),
                             device=device, conc=conc)
    return model_case("cases" if name == "lake_signell" else "cases2", name,
                      device, dtype, **sizes)


def _sediment_inventory(cfg, grid, s):
    """(water, bed) kg of sediment over the interior: the suspended classes
    times the layer volumes, and the bed mass times the cell areas."""
    from roms_tpu_torch import vgrid
    from roms_tpu_torch.grid import hc_of
    _, _, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                               grid.Cs_r, grid.sc_w, grid.Cs_w,
                               cfg.vtransform)
    p = cfg.sed_params
    area = interior(cfg, grid.omn)
    wat = sum(float((interior(cfg, s.t[p.ised0 + c] * Hz) * area).sum())
              for c in range(p.NST))
    return wat, float((interior(cfg, s.bed_mass) * area).sum())


def sediment_physics(device, smi, long):
    """Phase 17 (d): roms_tpu's physics checks of the sediment family in
    float64, with ms/step; SED_TEST1's 400 steps only when `long`.  Their
    sizes and parameters are the tests', so (f) times the published cases
    itself."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.ops.sediment import SedParams, bed_thickness_total
    from roms_tpu_torch.state import _initial_bed_mass
    ms = {}

    def run(cfg, grid, s, n, ffn, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = stepping.run(cfg, grid, s, n, ffn)
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3 / n, n)
        return s

    def report(name, cfg, ok, what):
        n = SEDIMENT_PHYSICS_STEPS[name]
        print(f"[sediment-physics] {name} {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} "
              f"float64 steps: {ms[name][0]:.1f} ms/step on {smi}; {what}  "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name}: the physics signature failed")

    def finite(s):
        return all(bool(torch.isfinite(getattr(s, k)).all())
                   for k in ("zeta", "u", "v", "t", "bed_mass"))

    name = "sed_toy"
    cfg, grid, s0, ffn = sediment_case(
        name, device, params=SedParams(Wsed=(0.001,), Erate=(0.0,)),
        conc=0.1)
    wat0, bed0 = _sediment_inventory(cfg, grid, s0)
    s = run(cfg, grid, s0, SEDIMENT_PHYSICS_STEPS[name], ffn, name)
    wat1, bed1 = _sediment_inventory(cfg, grid, s)
    drift = abs(wat1 + bed1 - wat0 - bed0) / (wat0 + bed0)
    report(name, cfg, finite(s) and bed1 > bed0 and wat1 < wat0 and
           drift <= 1e-8, f"water {wat0:.6e} -> {wat1:.6e} kg, bed "
           f"{bed0:.6e} -> {bed1:.6e} kg (deposition), total drift "
           f"{drift:.3e} (<= 1e-8)")

    name = "sed_toy_waves"
    p = SedParams(Wsed=(0.0005,), Erate=(5.0e-5,))
    cfg, grid, s0, ffn = sediment_case("sed_toy", device, Lm=8, Mm=10, N=8,
                                       params=p)

    def wavy(cfg_, grid_, t):
        one = torch.ones_like(grid_.h)
        return {**ffn(cfg_, grid_, t), "Hwave": 1.5 * one,
                "Pwave": 8.0 * one, "Dwave": 0.0 * one}

    from roms_tpu_torch.ops.bbl import BBLParams
    n = SEDIMENT_PHYSICS_STEPS[name]
    s = run(cfg.replace(bbl="ssw", bbl_params=BBLParams()), grid, s0, n,
            wavy, name)
    calm = stepping.run(cfg, grid, s0, n, ffn)
    up, still = float(interior(cfg, s.t[2]).max()), \
        float(interior(cfg, calm.t[2]).max())
    report(name, cfg, finite(s) and up > 1e-6 and still < 1e-8 and
           float(interior(cfg, s.bed_mass).min()) >= 0.0,
           f"SSW under 1.5 m waves: max sand {up:.4e} kg/m3 (> 1e-6); no "
           f"BBL, no waves: {still:.4e} (< 1e-8)")

    name = "sed_morph"
    p = SedParams(Sd50=(0.0001,), Wsed=(1.0e-4,), Erate=(5.0e-3,),
                  tau_ce=(1.0e-6,), tau_cd=(1.0e-6,), sed_morph=True,
                  morph_fac=50.0)
    cfg, grid, s0, ffn = sediment_case("sed_toy", device, params=p)
    s0 = s0.replace(u=torch.full_like(s0.u, 0.5),
                    ubar=torch.full_like(s0.zeta, 0.5))
    s = run(cfg, grid, s0, SEDIMENT_PHYSICS_STEPS[name], ffn, name)
    thick = bed_thickness_total(p, s.bed_mass)
    d_thick = float(interior(cfg, thick - bed_thickness_total(
        p, s0.bed_mass)).min())
    dh = float(interior(cfg, thick - bed_thickness_total(
        p, _initial_bed_mass(cfg, device))).min())
    report(name, cfg, finite(s) and d_thick < -1e-5 and dh < -1e-5,
           f"bed thinned by up to {-d_thick:.4e} m (> 1e-5), h deepened by "
           f"up to {-dh:.4e} m (> 1e-5)")

    name = "lake_signell"
    cfg, grid, s0, ffn = sediment_case(name, device, Lm=50, Mm=10)
    s = run(cfg, grid, s0, SEDIMENT_PHYSICS_STEPS[name], ffn, name)
    umax = float(s.u.abs().max())
    sand = float(interior(cfg, s.t[2]).max())
    report(name, cfg, finite(s) and umax < 1e-4 and sand < 1e-8 and
           bool(torch.isfinite(s.tke).all()),
           f"at rest before the ramp: max|u| {umax:.4e} m/s (< 1e-4), max "
           f"sand {sand:.4e} kg/m3 (< 1e-8), tke finite")

    if long:
        name = "sed_test1"
        cfg, grid, s0, ffn = sediment_case(name, device, Lm=40)
        s = run(cfg, grid, s0, SEDIMENT_PHYSICS_STEPS[name], ffn, name)
        c = interior(cfg, s.t[2]).cpu().numpy()
        mid = c[:, :, 15:25]
        report(name, cfg, finite(s) and c.min() >= -0.2 and
               mid.max() > 1e-4 and mid[0].mean() > 2.0 * mid[-1].mean(),
               f"min sand {c.min():.4e} (>= -0.2), max mid-channel "
               f"{mid.max():.4e} (> 1e-4), bottom {mid[0].mean():.4e} "
               f"against top {mid[-1].mean():.4e} (over 2x)")


def sediment_fixture(device):
    """Phase 17 (c): the small cases with the kernels on against
    tests/data/torch_sediment_small.npz, at CARD_FACTOR times the CPU
    test's bounds."""
    import numpy as np
    fx = sediment_fixture_script()
    ref = np.load(fx.OUT)
    for name in fx.BASE:
        cfg, grid, s0, ffn = fx.build_port(name, device=device)
        s = fx.run_port(name, cfg, grid, s0, ffn)
        errors = fx.errors(name, cfg, s0, s, ref, factor=CARD_FACTOR)
        worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
        print(f"[sediment-fixture] {name}: worst against its bound: "
              f"{worst[0]} {worst[1][0]:.3e} (bound {worst[1][1]:g})",
              flush=True)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        check(not bad, f"the small {name} misses its fixture: {bad}")


def sediment_phase(device, smi, long=False):
    """Phase 17: SED_TOY, LAKE_SIGNELL and SED_TEST1 at their published
    sizes: (a) kernels against plain on each case's arguments, (b) kernels
    on against off, (c) the small fixture, (d) the physics (SED_TEST1's
    only when `long`), (e) LAKE_SIGNELL through the CLI with restarts,
    (f) ms/step."""
    case_family_phase(
        "sediment", 17, smi, SEDIMENT,
        lambda n, d: sediment_case(n, device, d), SEDIMENT_KERNELS,
        sediment_fixture_script(), SEDIMENT_EQUIV_STEPS,
        [("c", lambda: sediment_fixture(device)),
         ("d", lambda: sediment_physics(device, smi, long)),
         ("e", lambda: cli_restart_check(
             device, "sediment", "lake_signell",
             ("bed_mass", "rheight", "rlength", "tau_cwmax", "tke", "gls"),
             "tau_cwmax"))], equiv_rtol=SEDIMENT_EQUIV_RTOL)


# phase 18: biology.  BIO_TOY (10x12x12, NPZD Powell on 6 tracers) and
# seven more models on UPWELLING's 41x80x16 (models/bio_toy.SETUPS; Fennel
# with oxygen and carbon, 14 tracers, for Fennel): every tracer kernel row
# carries the bio tracers beside temperature and salt (22 tracers on
# EcoSim); their tnu2 = 0 keeps row 5 off, as the JAX gates do, so row 5
# is checked at NT = 22 on EcoSim's arguments with tnu2 = 500 m2/s for
# every tracer.
BIOLOGY = ("bio_toy", "npzd_franks", "npzd_iron", "fennel_oxygen_carbon",
           "hypoxia_srm", "nemuro", "red_tide", "ecosim")
BIOLOGY_KERNELS = dict.fromkeys(
    BIOLOGY, _DIAG3 + ("prsgrd32", "rhs3d", "uv3dmix2") + _COLUMN_ROWS)
# kernels on against off: BIO_TOY over 3 float64 steps, the models over 5
BIOLOGY_EQUIV_STEPS = {name: 5 for name in BIOLOGY}
BIOLOGY_EQUIV_STEPS["bio_toy"] = 3
# relative to max|field|, each tracer against its own: the column sums'
# round-off of rows 1, 4, 7 and 10 through the step and the biology
BIOLOGY_EQUIV_RTOL = 1e-12
# roms_tpu's physics tests (tests/test_biology.py): their steps, at
# BIOLOGY_TEST_SIZE
BIOLOGY_PHYSICS_STEPS = {"conservation": 40, "export": 30}
BIOLOGY_TEST_SIZE = dict(Lm=6, Mm=8, N=10)


def biology_case(name, device, dtype="float64", **sizes):
    """(cfg, grid, state0, forcing_fn) of BIO_TOY (models/bio_toy.py) or of
    a biology model of models/bio_toy.SETUPS on UPWELLING, at the published
    sizes unless `sizes` cut them; BIO_TOY also takes `params`."""
    from roms_tpu_torch.models import bio_toy
    if name == "bio_toy":
        return bio_toy.build(bio_toy.make_config(dtype=dtype, **sizes),
                             device=device)
    return bio_toy.build_model(name, bio_toy.model_config(
        name, dtype=dtype, **sizes), device=device)


def _bio_inventory(cfg, grid, s):
    """The interior inventory sum t Hz area of each bio tracer."""
    from roms_tpu_torch import vgrid
    from roms_tpu_torch.grid import hc_of
    _, _, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                               grid.Cs_r, grid.sc_w, grid.Cs_w,
                               cfg.vtransform)
    area = interior(cfg, grid.omn)
    return [float((interior(cfg, s.t[i] * Hz) * area).sum())
            for i in cfg.ibio]


def biology_fixture(device):
    """Phase 18 (c): the small BIO_TOY, Fennel and EcoSim steps with the
    kernels on against tests/data/torch_biology_small.npz, and each model's
    source term on the card against the CPU's (and against roms_tpu's
    stored output where the fixture holds it), at CARD_FACTOR times the
    CPU test's bounds."""
    import numpy as np
    fx = biology_fixture_script()
    ref = np.load(fx.OUT)
    for name in fx.STEP_CASES:
        cfg, grid, s0, ffn = fx.build_port(name, device=device)
        s = fx.run_port(name, cfg, grid, s0, ffn)
        errors = fx.errors(name, cfg, s0, s, ref, factor=CARD_FACTOR)
        worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
        print(f"[biology-fixture] {name}: worst against its bound: "
              f"{worst[0]} {worst[1][0]:.3e} (bound {worst[1][1]:g})",
              flush=True)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        check(not bad, f"the small {name} misses its fixture: {bad}")
    bound = CARD_FACTOR * fx.MODEL_BOUND
    for name in fx.MODELS:
        card = fx.port_model(name, device)
        errs = [fx.model_errors(name, card, fx.port_model(name)).max()]
        if fx.MODELS[name][3]:
            errs.append(fx.model_errors(name, card,
                                        ref[f"{name}/out"]).max())
        print(f"[biology-fixture] model {name}: card against the CPU "
              f"{errs[0]:.3e}" + (f", against roms_tpu's stored output "
                                  f"{errs[1]:.3e}" if len(errs) > 1 else "")
              + f" x max|tracer| (bound {bound:g})", flush=True)
        check(all(e <= bound for e in errs),
              f"the {name} source term on the card misses its bound")


def biology_physics(device, smi, keep):
    """Phase 18 (d): roms_tpu's BIO_TOY checks in float64 at its test size
    (40 steps without sinking conserve nitrogen to rtol 1e-9 while the
    bloom grows; 30 steps with wDet = 80 m/day lose it monotonically),
    with ms/step; and the models' 5 kernels-on steps of (b) (keep): finite,
    EcoSim's small phytoplankton carbon positive (test_bio_models.py)."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import bio_toy
    from roms_tpu_torch.ops.biology import NPZDParams
    ms = {}

    def timed(cfg, grid, s, ffn, n, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        for _ in range(n):
            s = stepping.step(cfg, grid, s, ffn)
            out.append(sum(_bio_inventory(cfg, grid, s)))
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3 / n, n)
        return s, out

    p = NPZDParams(const_par=158.075, wPhy=0.0, wDet=0.0)
    cfg, grid, s0, ffn = biology_case("bio_toy", device, params=p,
                                      **BIOLOGY_TEST_SIZE)
    n = BIOLOGY_PHYSICS_STEPS["conservation"]
    tot0 = sum(_bio_inventory(cfg, grid, s0))
    s, tots = timed(cfg, grid, s0, ffn, n, "conservation")
    H = cfg.halo
    phy = float(s.t[3][-1, H + 4, H + 3])
    no3 = float(s.t[2][-1, H + 4, H + 3])
    drift = abs(tots[-1] - tot0) / tot0
    ok = bool(torch.isfinite(s.t).all()) and drift <= 1e-9 and \
        phy > bio_toy.BIO_INI[1] and no3 < bio_toy.BIO_INI[0]
    print(f"[biology-physics] bio_toy {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} float64 "
          f"steps without sinking: {ms['conservation'][0]:.1f} ms/step on "
          f"{smi}; total N {tot0:.9e} -> {tots[-1]:.9e} (drift {drift:.3e}, "
          f"<= 1e-9), surface P {phy:.5f} (> {bio_toy.BIO_INI[1]}), NO3 "
          f"{no3:.5f} (< {bio_toy.BIO_INI[0]})  {'OK' if ok else 'FAIL'}",
          flush=True)
    check(ok, "BIO_TOY: nitrogen not conserved or no bloom")

    p = NPZDParams(const_par=0.0, wPhy=0.0, wDet=80.0, DetRR=0.0, ZooGR=0.0,
                   PhyMRD=0.0, ZooMRD=0.0)
    cfg, grid, s0, ffn = biology_case("bio_toy", device, params=p,
                                      **BIOLOGY_TEST_SIZE)
    n = BIOLOGY_PHYSICS_STEPS["export"]
    tot0 = sum(_bio_inventory(cfg, grid, s0))
    s, tots = timed(cfg, grid, s0, ffn, n, "export")
    steps = np.diff([tot0] + tots)
    ok = bool(np.isfinite(tots).all()) and tots[-1] < tot0 and \
        (steps <= 1e-9).all()
    print(f"[biology-physics] bio_toy, wDet = 80 m/day, {n} float64 steps: "
          f"{ms['export'][0]:.1f} ms/step; total N {tot0:.9e} -> "
          f"{tots[-1]:.9e}, largest step change {steps.max():.3e} (<= "
          f"1e-9: monotone export)  {'OK' if ok else 'FAIL'}", flush=True)
    check(ok, "BIO_TOY: the seabed export is not monotone")

    for name in BIOLOGY[1:]:
        s = keep[name]
        finite = bool(torch.isfinite(s.t).all())
        H = cfg.halo
        bio = s.t[2:, :, H:-H, H:-H]
        lo = [float(b.min()) for b in bio]
        ok = finite and (name != "ecosim" or lo[5] > 0.0)
        N, ny, nx = s.t.shape[1:]
        print(f"[biology-physics] {name} {nx - 2 * H}x{ny - 2 * H}x{N}, "
              f"{BIOLOGY_EQUIV_STEPS[name]} float64 steps with the kernels "
              f"on: finite={finite}; bio tracer minima "
              + ", ".join(f"{v:.4g}" for v in lo)
              + ("; PhyC1 > 0" if name == "ecosim" else "")
              + f"  {'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name}: the model run is not finite or not positive")


def biology_cli(device):
    """Phase 18 (e): the committed examples/bio_toy.yaml through the CLI
    in a temporary directory (its history file bio_his.nc there): exit 0,
    the NPZD tracers in the record, finite; then BIO_TOY through the CLI
    with restarts (cli_restart_check)."""
    import io
    import tempfile
    import numpy as np
    from roms_tpu_torch.__main__ import main as cli
    from roms_tpu_torch.io.netcdf import read_history
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["run", os.path.join(ROOT, "examples", "bio_toy.yaml"),
                "--device", str(device)]
        out = io.StringIO()
        os.chdir(tmp)
        try:
            with contextlib.redirect_stdout(out):
                rc = cli(argv)
        finally:
            os.chdir(here)
        print(f"[biology-cli] in a temporary directory: python -m "
              f"roms_tpu_torch run examples/bio_toy.yaml --device "
              f"{device}: exit {rc}", flush=True)
        for ln in [ln for ln in out.getvalue().splitlines() if "KE=" in ln]:
            print(f"[biology-cli] | {ln}")
        check(rc == 0, f"the CLI exited {rc}")
        h = read_history(os.path.join(tmp, "bio_his.nc"))
        names = ("NO3", "phytoplankton", "zooplankton", "detritus")
        ok = all(k in h and len(h[k]) == 2 and np.isfinite(h[k]).all()
                 for k in names)
        print(f"[biology-cli] bio_his.nc: {len(h['ocean_time'])} records, "
              f"{', '.join(names)} finite: {ok}; surface phytoplankton max "
              f"{float(h['phytoplankton'][-1].max()):.5f}", flush=True)
        check(ok, "the example's history lacks its NPZD records")
    cli_restart_check(device, "biology", "bio_toy", ("t", "t_prev"), "t")


def biology_nt22(device):
    """Phase 18 (g): rows 8 and 9 on EcoSim's 22-tracer step arguments and
    row 5 on them with tnu2 = 500 m2/s for all 22 tracers, float64 and
    float32 (three plain float64 steps from rest): bitwise their plain
    versions, timed with their bound, and row 5's tile and registers."""
    from roms_tpu_torch import stepping
    from roms_tpu_torch.ops import diag_cuda, mix3d_cuda
    from roms_tpu_torch.state import TENSOR_FIELDS
    import torch
    cfg, grid, s0, ffn = biology_case("ecosim", device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    for dtype in ("float64", "float32"):
        cfg, grid, _, ffn = biology_case("ecosim", device, dtype)
        state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                             for k in TENSOR_FIELDS})
        calls = captured_calls(cfg, grid, state, ffn)
        z_r, _, Hz, *_ = diag_cuda.grid_flux_plain(*calls["grid_flux"][0])
        t = calls["tracer_predictor"][0][3]
        geo = (cfg.replace(tnu2=cfg.ntracers * (500.0,)), grid, t, Hz, z_r,
               t * Hz[None], cfg.dt)
        check_variants("biology-nt22", grid, [
            ("ecosim:tracer_predictor", "tracer_predictor",
             *calls["tracer_predictor"]),
            ("ecosim:tracer_corrector", "tracer_corrector",
             *calls["tracer_corrector"]),
            (f"ecosim:t3dmix2_geo[{cfg.ntracers} tracers]", "t3dmix2_geo",
             geo, {})], dtype, {}, timed=True)
        lay = mix3d_cuda.geo_layout(getattr(torch, dtype))
        print(f"[biology-nt22] t3dmix2_geo {dtype}: {cfg.ntracers} tracers "
              f"(a block row each), tile {lay['tile'][0]}x{lay['tile'][1]}, "
              f"{lay['shared_bytes']} bytes of shared memory, "
              f"{lay['registers']} registers a thread", flush=True)


def biology_phase(device, smi):
    """Phase 18: BIO_TOY and seven more biology models on UPWELLING at
    41x80x16: (a) kernels against plain on each case's arguments (with the
    tracer kernels' tiles at EcoSim's 22 tracers), (b) kernels on against
    off, (c) the small fixture and the models' source terms, (d) roms_tpu's
    BIO_TOY physics and the models' runs, (e) the example through the CLI
    and a restart, (g) rows 5, 8 and 9 at 22 tracers, (f) ms/step."""
    keep = {}
    case_family_phase(
        "biology", 18, smi, BIOLOGY,
        lambda n, d: biology_case(n, device, d), BIOLOGY_KERNELS,
        biology_fixture_script(), BIOLOGY_EQUIV_STEPS,
        [("c", lambda: biology_fixture(device)),
         ("d", lambda: biology_physics(device, smi, keep)),
         ("e", lambda: biology_cli(device)),
         ("g", lambda: biology_nt22(device))], tiles=("ecosim",),
        equiv_rtol=BIOLOGY_EQUIV_RTOL, keep=keep)


# phase 19: the last branches of the forward model.  FLT_TEST (14x12x4,
# the stresses as body forces: row 7's BODYFORCE branch, with every row
# but 4 and 5) with its floats, SHOREFACE (59x7x20: the Mellor05 radiation
# stress with the Stokes drift keeps rows 1 and 3 plain, its bry and
# wet/dry rows 8-11) and the budget diagnostics on UPWELLING (41x80x16:
# rows 7-9 off, the momentum phase staged).
FORWARD = ("flt_test", "shoreface")
FORWARD_KERNELS = {
    "flt_test": _DIAG3 + ("prsgrd32", "rhs3d") + _COLUMN_ROWS,
    "shoreface": ("omega", "prsgrd32", "rhs3d")}
FORWARD_EQUIV_STEPS = 3
FORWARD_EQUIV_RTOL = 1e-12
# roms_tpu's float check (tests/test_cases3.py:52-84), SHOREFACE's short
# run and its wave setup (tests/test_cases3.py:199-215, --forward-long)
FORWARD_PHYSICS_STEPS = {"flt_test": 40, "shoreface": 20,
                         "shoreface_setup": 400, "dia": 3}
# row 7's BODYFORCE level ranges inside UPWELLING's 16 levels
BODYFORCE_LEVELS = (12, 4)


forward_case = functools.partial(model_case, "cases2")


def flt_floats(cfg, grid, s, fl):
    """One float step after a model step: omega from the state's fluxes
    (tests/test_cases3.py:68-74)."""
    from roms_tpu_torch import floats, vgrid
    from roms_tpu_torch.grid import hc_of
    from roms_tpu_torch.ops.omega import omega, set_massflux
    _, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                                 grid.Cs_r, grid.sc_w, grid.Cs_w,
                                 cfg.vtransform)
    Huon, Hvom = set_massflux(cfg, grid, s.u, s.v, Hz)
    W = omega(cfg, grid, Huon, Hvom, z_w)
    return floats.step_floats(cfg, grid, s.u, s.v, W, Hz, fl)


def forward_physics(device, smi, long):
    """Phase 19 (d): roms_tpu's FLT_TEST float check (40 float64 steps, the
    floats stepped after each: inside the basin and moved by the wind),
    SHOREFACE finite over 20 steps, and with `long` its wave setup after
    400 (tests/test_cases3.py:199-215); ms/step."""
    import numpy as np
    import torch
    from roms_tpu_torch import floats, stepping
    ms = {}
    cfg, grid, s, ffn = forward_case("flt_test", device)
    H = cfg.halo
    x0, y0 = np.meshgrid(np.arange(3.0, 6.0), np.arange(4.0, 7.0))
    fl = floats.init_floats(x0.ravel() + H - 0.5, y0.ravel() + H - 0.5,
                            np.full(9, -5.0), device=device)
    n = FORWARD_PHYSICS_STEPS["flt_test"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        s = stepping.step(cfg, grid, s, ffn)
        fl = flt_floats(cfg, grid, s, fl)
    torch.cuda.synchronize()
    ms["flt_test"] = ((time.perf_counter() - t0) * 1e3 / n, n)
    xg, yg = fl.xg[0].cpu().numpy(), fl.yg[0].cpu().numpy()
    moved = float(np.abs(xg - x0.ravel() - H + 0.5).max())
    inside = bool((xg > H - 1).all() and (xg < H + cfg.Lm).all() and
                  (yg > H - 1).all() and (yg < H + cfg.Mm).all())
    finite = all(bool(torch.isfinite(getattr(s, k)).all())
                 for k in ("zeta", "u", "v", "t")) and \
        bool(np.isfinite(xg).all() and np.isfinite(yg).all())
    ok = finite and inside and moved > 1e-3
    print(f"[forward-physics] flt_test {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} "
          f"float64 steps with 9 floats stepped after each: "
          f"{ms['flt_test'][0]:.1f} ms/step on {smi}; floats inside the "
          f"basin: {inside}, moved up to {moved:.4e} cells (> 1e-3), "
          f"finite={finite}  {'OK' if ok else 'FAIL'}", flush=True)
    check(ok, "FLT_TEST: the floats left the basin or did not move")

    runs = [("shoreface", FORWARD_PHYSICS_STEPS["shoreface"])]
    if long:
        runs.append(("shoreface_setup",
                     FORWARD_PHYSICS_STEPS["shoreface_setup"]))
    for name, n in runs:
        cfg, grid, s, ffn = forward_case("shoreface", device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = stepping.run(cfg, grid, s, n, ffn)
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t0) * 1e3 / n, n)
        finite = all(bool(torch.isfinite(getattr(s, k)).all()) for k in
                     ("zeta", "ubar", "vbar", "u", "v", "t", "tke", "gls"))
        what, ok = "", finite
        if name == "shoreface_setup":
            z, h = s.zeta.cpu().numpy(), grid.h.cpu().numpy()
            H = cfg.halo
            jj, shoal = slice(H, H + cfg.Mm), slice(H + 40, H + 50)
            wet = h > 0.5
            inner = float(z[jj, shoal][wet[jj, shoal]].mean())
            outer = float(z[jj, H:H + 10].mean())
            ok = finite and inner > outer + 1e-4
            what = (f"; mean zeta in the shoaling zone {inner:.5f} m, "
                    f"offshore {outer:.5f} m (setup > 1e-4)")
        print(f"[forward-physics] {name} {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} "
              f"float64 steps: {ms[name][0]:.1f} ms/step on {smi}; "
              f"finite={finite}{what}  {'OK' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{name}: not finite or no wave setup")
    return {k: v for k, v in ms.items() if k in FORWARD}


def forward_fixture(device):
    """Phase 19 (c): FLT_TEST with its floats, the small SHOREFACE under
    Mellor05 and Mellor08 and UPWELLING's budget dict with the kernels on
    against tests/data/torch_forward_small.npz, at CARD_FACTOR times the
    CPU test's bounds."""
    import numpy as np
    fx = forward_fixture_script()
    ref = np.load(fx.OUT)
    for name in fx.CASES:
        cfg, grid, s0, ffn = fx.build_port(name, device=device)
        _, outs = fx.run_port(name, cfg, grid, s0, ffn)
        errors = fx.errors(name, cfg, s0, outs, ref, factor=CARD_FACTOR)
        worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
        print(f"[forward-fixture] {name}: worst against its bound: "
              f"{worst[0]} {worst[1][0]:.3e} (bound {worst[1][1]:g})",
              flush=True)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        check(not bad, f"the small {name} misses its fixture: {bad}")


def forward_dia(device):
    """Phase 19 (g): the budgets on UPWELLING 41x80x16 in float64: three
    steps with collect_diags, one launch a step of rows 1-4, 6, 10 and
    11 and none of rows 7-9, rate the sum of the momentum terms, the
    tracer terms integrating to zero; with the kernels off the state
    bitwise the state of the same steps without the budgets; with them
    on, where the budgets keep rows 7-9 plain, the state against the
    steps without the budgets (rows 7-9 on) within FORWARD_EQUIV_RTOL x
    max|field|; and the DIA stream through the CLI (a JSON run file with
    dia_file and ndia: four steps, two records)."""
    import io
    import tempfile
    import torch
    from roms_tpu_torch import stepping, vgrid
    from roms_tpu_torch.__main__ import main as cli
    from roms_tpu_torch.grid import hc_of
    from roms_tpu_torch.io.netcdf import read_history
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(),
                                         device=device)
    n = FORWARD_PHYSICS_STEPS["dia"]

    def dia_run(c):
        s = s0
        for _ in range(n):
            s, dia = stepping.step(c, grid, s, ffn, collect_diags=True)
        return s, dia

    terms = ("prestep", "hvisc", "prsgrd", "cor", "xadv", "yadv", "vadv",
             "vvisc")
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    for w in table.values():
        w.launches = 0
    t0 = time.perf_counter()
    s_on, dia = dia_run(cfg)
    torch.cuda.synchronize()
    ms_dia = (time.perf_counter() - t0) * 1e3 / n
    launches = {k: w.launches / n for k, w in table.items() if w.launches}
    want = {"grid_flux", "eos", "omega", "uv3dmix2", "prsgrd32",
            "uv_corrector", "fast_loop"}
    close = max(float((sum(dia[f"{c}_{k}"] for k in terms) -
                       dia[f"{c}_rate"]).abs().max() /
                      dia[f"{c}_rate"].abs().max()) for c in "uv")
    H = cfg.halo
    jj, ii = slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)
    _, _, Hz = vgrid.set_depth(grid.h, s_on.zeta, hc_of(cfg), grid.sc_r,
                               grid.Cs_r, grid.sc_w, grid.Cs_w,
                               cfg.vtransform)
    vol = Hz[:, jj, ii] * grid.omn[jj, ii]
    net = max(abs(float((dia[k][0][:, jj, ii] * vol).sum())) /
              max(float((dia[k][0][:, jj, ii].abs() * vol).sum()), 1e-300)
              for k in ("yadv", "vadv", "vdiff"))
    off = cfg.replace(pallas2d=False)
    s_off, _ = dia_run(off)
    plain = stepping.run(off, grid, s0, n, ffn)
    bitwise = all(torch.equal(getattr(s_off, k), getattr(plain, k))
                  for k in TENSOR_FIELDS)
    t0 = time.perf_counter()
    kern = stepping.run(cfg, grid, s0, n, ffn)
    torch.cuda.synchronize()
    ms_plain = (time.perf_counter() - t0) * 1e3 / n
    diff = max(float((getattr(s_on, k) - getattr(kern, k)).abs().max()) /
               max(float(getattr(kern, k).abs().max()), 1e-300)
               for k in ("zeta", "ubar", "u", "t"))
    ok = close <= 1e-12 and net <= 1e-9 and bitwise and \
        diff <= FORWARD_EQUIV_RTOL and launches == dict.fromkeys(want, 1.0)
    print(f"[forward-dia] upwelling {cfg.Lm}x{cfg.Mm}x{cfg.N}, {n} float64 "
          f"steps with the budgets: {ms_dia:.1f} ms/step (without: "
          f"{ms_plain:.1f}); kernel launches a step {launches} (rows 7-9 "
          f"off); |rate - sum of terms| / max|rate| {close:.3e} "
          f"(<= 1e-12); worst |net| / gross of yadv, vadv, vdiff "
          f"{net:.3e} (<= 1e-9); kernels off: the state bitwise the one "
          f"without the budgets: {bitwise}; kernels on (rows 7-9 off with "
          f"the budgets) against the steps without them: {diff:.3e} x "
          f"max|field| (<= {FORWARD_EQUIV_RTOL:g})  "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    check(ok, "the budgets do not close or change the state")
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "dia.json")
        path = os.path.join(tmp, "dia.nc")
        with open(run, "w") as f:
            json.dump({"case": "upwelling", "nsteps": 4,
                       "output": {"dia_file": path, "ndia": 2}}, f)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli(["run", run, "--device", str(device), "--ninfo", "0"])
        d = read_history(path) if rc == 0 else {}
        ok = rc == 0 and len(d.get("ocean_time", ())) == 2 and all(
            k in d for k in ("temp_hdiff", "salt_vdiff", "u_vvisc",
                             "v_prsgrd"))
        print(f"[forward-dia] python -m roms_tpu_torch run dia.json (4 "
              f"steps, dia_file and ndia = 2): exit {rc}, "
              f"{len(d.get('ocean_time', ()))} DIA records, "
              f"{len(d)} variables  {'OK' if ok else 'FAIL'}", flush=True)
        check(ok, "the DIA stream through the CLI")


def bodyforce_rows(device):
    """Phase 19 (h): row 7 under BODYFORCE on UPWELLING 41x80x16 with the
    surface levels from BODYFORCE_LEVELS[0] and the bottom levels up to
    BODYFORCE_LEVELS[1] (three plain float64 steps from rest, the step's
    arguments), float64 and float32, against its plain version (ru, rv,
    u_nnew, v_nnew bitwise: the level sums run in k order in both), timed
    with its bound beside the same launch without BODYFORCE; and both
    kernels' registers and stack frames."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.ops import rhs3d_cuda
    from roms_tpu_torch.state import TENSOR_FIELDS
    ks, kb = BODYFORCE_LEVELS
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(),
                                        device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s, 3, ffn)
    for dtype in ("float64", "float32"):
        cfg, grid, _, ffn = upwelling.build(
            upwelling.make_config(dtype=dtype), device=device)
        state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                             for k in TENSOR_FIELDS})
        bf = cfg.replace(bodyforce=True, levsfrc=ks, levbfrc=kb)
        args, kw = captured_calls(bf, grid, state, ffn)["rhs3d"]
        check_variants("forward-rhs3d", grid, [
            (f"rhs3d[bodyforce {ks}..{cfg.N}, 1..{kb}]", "rhs3d", args,
             kw),
            ("rhs3d", "rhs3d", (cfg,) + args[1:], kw)], dtype, {})
        t = getattr(torch, dtype)
        lay = rhs3d_cuda.rhs3d_layout(t)
        body = rhs3d_cuda.rhs3d_layout(t, bodyforce=True)
        plan = rhs3d_cuda.rhs3d_plan(t, cfg.N, cfg.ny_tot, cfg.nx_tot,
                                     bodyforce=True)
        print(f"[forward-rhs3d] rhs3d {dtype}: {lay['registers']} "
              f"registers and {lay['stack_bytes']} bytes of stack frame a "
              f"thread; its BODYFORCE kernel {body['registers']} and "
              f"{body['stack_bytes']}, tile {plan['tile'][0]}x"
              f"{plan['tile'][1]}, {plan['levels']} level slot(s), "
              f"{plan['smem_bytes']} bytes of shared memory", flush=True)


def forward_phase(device, smi, long=False):
    """Phase 19: FLT_TEST and SHOREFACE at their published sizes: (a)
    kernels against plain on each case's arguments (row 7 under
    BODYFORCE on FLT_TEST's), (b) kernels on against off, (c) the small
    fixture, (d) the float check and SHOREFACE's run (its 400-step setup
    only when `long`), (e) FLT_TEST through the CLI with restarts, (g) the
    budgets and the DIA stream on UPWELLING, (h) row 7 under BODYFORCE on
    UPWELLING, timed, (f) ms/step."""
    case_family_phase(
        "forward", 19, smi, FORWARD,
        lambda n, d: forward_case(n, device, d), FORWARD_KERNELS,
        forward_fixture_script(), FORWARD_EQUIV_STEPS,
        [("c", lambda: forward_fixture(device)),
         ("d", lambda: forward_physics(device, smi, long)),
         ("e", lambda: cli_restart_check(device, "forward", "flt_test",
                                         ("t", "u", "ru_prev"), "u")),
         ("g", lambda: forward_dia(device)),
         ("h", lambda: bodyforce_rows(device))],
        equiv_rtol=FORWARD_EQUIV_RTOL,
        # SHOREFACE's zeta and sand at its closed east wall: roms_tpu's own
        # one-ulp spread there, which the column sums' order reaches
        equiv_bounds={"shoreface":
                      forward_fixture_script().WALL_BOUND})


FOURDVAR_FIXTURE = os.path.join(ROOT, "tests", "data",
                                "torch_fourdvar_small.npz")
# the eleven kernel wrappers by their row in PERF.md's table
ROWS = ("grid_flux", "omega", "eos", "uv3dmix2", "t3dmix2_geo", "prsgrd32",
        "rhs3d", "tracer_predictor", "tracer_corrector", "uv_corrector",
        "fast_loop")
# UPWELLING's step: every row but 5 (tnu2 = 0)
UPWELLING_ROWS = tuple(r for r in range(1, 12) if r != 5)
FOURDVAR_SPINUP = 5          # UPWELLING steps before the linearization
FOURDVAR_BIG_INNER = 5       # the 41x80x16 twin's CG iterations
FOURDVAR_TIMED = 2           # calls a TLM / ADM time is the mean of


def fourdvar_fixture_script():
    """scripts/torch_fourdvar_fixture.py as a module."""
    return _script("torch_fourdvar_fixture")


def counted(run):
    """run() with every kernel wrapper's count set to 0 just before; returns
    (its result, {row: launches in that run})."""
    import torch
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    for w in table.values():
        w.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {r: table[k].launches for r, k in enumerate(ROWS, 1)}


def mean_ms(fn, reps=FOURDVAR_TIMED, warm=True) -> float:
    """Host-clock ms of a call of fn, the mean of `reps` (after one unless
    not `warm`)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def fourdvar_tlm_adm(device, smi):
    """Phase 20 (a) and (b): UPWELLING 41x80x16 float64, FOURDVAR_SPINUP
    steps in: the TLM's finite-difference convergence (nonlinear runs with
    the kernels on), the adjoint symmetry, the launches by row of each
    run, the ms of a TLM and an ADM step; then the eos and uv3dmix2
    wrappers under torch.func.vjp, and eos on a tensor that requires
    grad, must raise."""
    import torch
    from roms_tpu_torch import fourdvar, stepping, vgrid
    from roms_tpu_torch.grid import hc_of
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.ops import diag_cuda, mix3d_cuda
    from roms_tpu_torch.state import TENSOR_FIELDS
    fx = fourdvar_fixture_script()
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(),
                                        device=device)
    s, spin = counted(lambda: stepping.run(cfg, grid, s, FOURDVAR_SPINUP,
                                           ffn))
    f, x = fourdvar.step_map(cfg, grid, s, ffn)

    def flat(d):
        return torch.cat([d[k].reshape(-1) for k in TENSOR_FIELDS])

    shapes = fx.shapes_of(s, TENSOR_FIELDS)
    kw = dict(dtype=grid.h.dtype, device=device)
    dx = {k: torch.as_tensor(v, **kw) for k, v in fx.tangent(shapes,
                                                             1).items()}
    dy = flat({k: torch.as_tensor(v, **kw)
               for k, v in fx.tangent(shapes, 2).items()})
    lin, rec = counted(lambda: fourdvar.Linearization(
        lambda d: flat(f(d)), x))
    jdx, n_jvp = counted(lambda: lin.jvp(dx))
    jtdy, n_vjp = counted(lambda: lin.vjp(dy))
    y0, n_nl = counted(lambda: stepping.step(cfg, grid, s, ffn))
    errs, n_fd = [], {}
    for eps in (1e-4, 1e-5):
        y1, n_fd = counted(lambda: stepping.step(
            cfg, grid, s.replace(**{k: x[k] + eps * dx[k] for k in x}),
            ffn))
        num = (flat(vars(y1)) - flat(vars(y0))) / eps
        errs.append(float(torch.linalg.vector_norm(num - jdx) /
                          torch.linalg.vector_norm(jdx)))
    lhs = float(torch.vdot(jdx, dy))
    rhs = sum(float(torch.vdot(dx[k].reshape(-1), jtdy[k].reshape(-1)))
              for k in TENSOR_FIELDS)
    sym = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    for tag, n in (("spin-up (5 nonlinear steps)", spin),
                   ("nonlinear step", n_nl), ("FD nonlinear step", n_fd),
                   ("linearized run (recorded)", rec),
                   ("TLM (jvp)", n_jvp), ("ADM (vjp)", n_vjp)):
        print(f"[fourdvar] UPWELLING {cfg.Lm}x{cfg.Mm}x{cfg.N} launches by "
              f"row, {tag}: {n}", flush=True)
    check(all(spin[r] == FOURDVAR_SPINUP for r in UPWELLING_ROWS) and
          spin[5] == 0, f"the spin-up missed a kernel of rows 1-4, 6-11: "
          f"{spin}")
    for n in (n_nl, n_fd):
        check(all(n[r] == 1 for r in UPWELLING_ROWS) and n[5] == 0,
              f"a nonlinear step missed a kernel of rows 1-4, 6-11: {n}")
    for n in (rec, n_jvp, n_vjp):
        check(not any(n.values()), f"a linearized run launched a kernel: "
              f"{n}")
    print(f"[fourdvar] TLM finite-difference check: |(f(x+eps dx) - f(x))"
          f"/eps - J dx| / |J dx| = {errs[0]:.3e} (eps 1e-4), "
          f"{errs[1]:.3e} (eps 1e-5); adjoint symmetry <J dx, dy> = "
          f"{lhs:.12e}, <dx, J^T dy> = {rhs:.12e}, relative difference "
          f"{sym:.3e} (bound 1e-10)", flush=True)
    check(errs[0] < 1e-2 and errs[1] < errs[0],
          f"the TLM's finite-difference error does not fall: {errs}")
    check(sym <= 1e-10, f"adjoint symmetry {sym:.3e} over 1e-10")
    check(bool(torch.isfinite(jdx).all()) and
          all(bool(torch.isfinite(v).all()) for v in jtdy.values()),
          "a non-finite TLM or ADM output")

    ms_rec = mean_ms(lambda: fourdvar.Linearization(lambda d: flat(f(d)),
                                                    x), warm=False)
    ms_tlm = mean_ms(lambda: lin.jvp(dx))
    ms_adm = mean_ms(lambda: lin.vjp(dy))
    ms_on = mean_ms(lambda: stepping.step(cfg, grid, s, ffn))
    ms_off = mean_ms(lambda: stepping.step(fourdvar.linear_config(cfg),
                                           grid, s, ffn))
    ms_fjvp = mean_ms(lambda: torch.func.jvp(f, (x,), (dx,)), 1, False)
    ms_fvjp = mean_ms(lambda: torch.func.vjp(f, x)[1](
        {k: torch.zeros_like(v) for k, v in x.items()}), 1, False)
    print(f"[fourdvar] UPWELLING {cfg.Lm}x{cfg.Mm}x{cfg.N} float64 ms, "
          f"host clock: nonlinear step kernels on {ms_on:.2f}, plain "
          f"{ms_off:.2f}; the linearized step recorded {ms_rec:.2f}; TLM "
          f"step (Linearization.jvp) {ms_tlm:.2f}; ADM step "
          f"(Linearization.vjp) {ms_adm:.2f}; torch.func.jvp of step_map "
          f"{ms_fjvp:.2f}, torch.func.vjp {ms_fvjp:.2f}; on {smi}",
          flush=True)

    # (b) the wrappers refuse a differentiated tensor on the card
    z_r, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg),
                                   grid.sc_r, grid.Cs_r, grid.sc_w,
                                   grid.Cs_w, cfg.vtransform)
    s2 = torch.zeros_like(s.zeta)

    def mix(u):
        return mix3d_cuda.uv3dmix2(cfg, grid, u, s.v, Hz, s.u.clone(),
                                   s.v.clone(), s2.clone(), s2.clone(),
                                   cfg.dt)[0]

    for name, tag, call in (
            ("eos", "under torch.func.vjp", lambda: torch.func.vjp(
                lambda t: diag_cuda.eos(cfg, t, z_r, z_w, False)[0], s.t)),
            ("eos", "that requires grad", lambda: diag_cuda.eos(
                cfg, s.t.clone().requires_grad_(), z_r, z_w, False)),
            ("uv3dmix2", "under torch.func.vjp",
             lambda: torch.func.vjp(mix, s.u))):
        try:
            _, n = counted(call)
        except RuntimeError as exc:
            ok = f"roms_{name} kernel" in str(exc) and "pallas2d=False" \
                in str(exc)
            print(f"[fourdvar] {name} wrapper on a CUDA tensor {tag}: "
                  f"raised RuntimeError: {exc}", flush=True)
            check(ok, f"the {name} wrapper raised another error: {exc}")
            continue
        check(False, f"the {name} wrapper launched on a tensor {tag}: {n}")
    rho, _ = diag_cuda.eos(cfg, s.t, z_r, z_w, False)
    check(bool(torch.isfinite(rho).all()), "eos without a derivative")


def fourdvar_small(device):
    """Phase 20 (c) and (d): the small twins from roms_tpu's observations
    against tests/data/torch_fourdvar_small.npz at CARD_FACTOR x the CPU
    bounds (the one-step TLM and ADM, the small BENCHMARK's TLM, the six
    driver runs, the bry control, the port's own truth runs), and
    roms_tpu's 4D-Var checks at its tests' sizes on the same runs."""
    import numpy as np
    from roms_tpu_torch import obs as tobs, stepping
    fx = fourdvar_fixture_script()
    ref = np.load(FOURDVAR_FIXTURE)
    errors = {}
    cfg, _, _, _, jdx, jtdy = fx.port_autodiff(ref, device)
    errors.update(fx.autodiff_errors(cfg, jdx, jtdy, ref, CARD_FACTOR))
    cfg, jdx = fx.port_benchmark_tlm(ref, device)
    errors.update(fx.benchmark_errors(cfg, jdx, ref, CARD_FACTOR))
    cfg, d, adj = fx.port_bry(device)
    errors.update(fx.bry_errors(cfg, d, adj, ref, CARD_FACTOR))
    runs = {}
    for part, (setup, driver, n_inner) in fx.DRIVERS.items():
        t0 = time.perf_counter()
        runs[part] = fx.port_driver(part, device, fx.fixture_obs(ref, part))
        errors.update(fx.driver_errors(part, *runs[part], ref,
                                       CARD_FACTOR))
        jo = runs[part][2]["Jo"]
        print(f"[fourdvar-small] {part} ({driver}, n_inner {n_inner}): Jo "
              f"{jo[0]:.6e} -> {jo[-1]:.6e}, {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
    for setup in ("twin", "wind", "fracobs"):
        errors.update(fx.obs_errors(setup, fx.port_twin(setup, device), ref,
                                    CARD_FACTOR))
    worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
    print(f"[fourdvar-small] {len(errors)} outputs against the fixture; "
          f"worst against its bound: {worst[0]} {worst[1][0]:.3e} (bound "
          f"{worst[1][1]:g})", flush=True)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    check(not bad, f"the small 4D-Var runs miss their fixture: {bad}")

    # (d) roms_tpu's own checks (tests/test_fourdvar.py, test_obs.py)
    def jo_ratio(part):
        jo = runs[part][2]["Jo"]
        return jo[-1] / jo[0]

    su, ana, _ = runs["twin"]
    s0, truth = su[2], su[6]
    err_b = float((s0.t[0, -1] - truth.t[0, -1]).abs().max())
    err_a = float((ana.t[0, -1] - truth.t[0, -1]).abs().max())
    pa = (runs["primal8"][1].t[0, -1] - s0.t[0, -1]).cpu().numpy()
    dual = {p: float(np.abs((runs[p][1].t[0, -1] - s0.t[0, -1]).cpu()
                            .numpy() - pa).max() / np.abs(pa).max())
            for p in ("rbl8", "r48")}
    (cfg, grid, _, ffn, _, _, tau), _, wd = runs["wind"]
    H = cfg.halo
    ii = np.s_[H:H + cfg.Mm, H:H + cfg.Lm]
    a = wd["control"]["sustr"][ii].cpu().numpy().ravel()
    b = tau[ii].cpu().numpy().ravel()
    corr = float(np.dot(a - a.mean(), b - b.mean()) /
                 (np.linalg.norm(a - a.mean()) *
                  np.linalg.norm(b - b.mean())))
    amp = float(np.abs(a).max() / b.max())
    (cfg, grid, s0f, ffn, olist, nsteps, _), anaf, _ = runs["fracobs"]
    sb, sa, states_b, states_a = s0f, anaf, {}, {}
    for n in range(1, nsteps + 1):
        sb = stepping.step(cfg, grid, sb, ffn)
        sa = stepping.step(cfg, grid, sa, ffn)
        states_b[n], states_a[n] = sb, sa
    rmse_b = tobs.stats_modobs(cfg, olist, states_b)["temp"]["rmse"]
    rmse_a = tobs.stats_modobs(cfg, olist, states_a)["temp"]["rmse"]
    print(f"[fourdvar-small] roms_tpu's checks: twin Jo ratio "
          f"{jo_ratio('twin'):.3e} (< 0.05), SST error {err_b:.4f} -> "
          f"{err_a:.4f}; duals' Jo ratios {jo_ratio('rbl8'):.3e}, "
          f"{jo_ratio('r48'):.3e}, their increments against the primal's "
          f"{dual['rbl8']:.3e}, {dual['r48']:.3e} of its max (< 0.05); "
          f"wind Jo ratio {jo_ratio('wind'):.3e} (< 1e-3), correlation "
          f"{corr:.6f}, amplitude {amp:.4f}; FracObs Jo ratio "
          f"{jo_ratio('fracobs'):.3e} (< 0.5), RMSE {rmse_b:.4f} -> "
          f"{rmse_a:.4f}", flush=True)
    check(jo_ratio("twin") < 0.05 and err_a < 0.5 * err_b,
          "the I4D-Var twin's checks")
    check(all(jo_ratio(p) < 0.05 for p in ("rbl8", "r48")) and
          all(e <= 0.05 for e in dual.values()), "the duals' checks")
    check(jo_ratio("wind") < 1e-3 and corr > 0.95 and 0.8 < amp < 1.2,
          "the wind-stress twin's checks")
    check(jo_ratio("fracobs") < 0.5 and rmse_a < rmse_b,
          "the FracObs twin's checks")


def fourdvar_big(device, smi):
    """Phase 20 (e): an I4D-Var twin at UPWELLING's published 41x80x16,
    float64: SST over the interior at step 2 from a truth with a smooth
    0.5 degC anomaly, FOURDVAR_BIG_INNER CG iterations."""
    import numpy as np
    import torch
    from roms_tpu_torch import fourdvar, stepping
    from roms_tpu_torch.models import upwelling
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(),
                                         device=device)
    H = cfg.halo
    pert = 0.5 * torch.exp(-(((grid.xr - 20e3) / 3e3) ** 2 +
                             ((grid.yr - 30e3) / 3e3) ** 2))
    t_true = s0.t.clone()
    t_true[0] = t_true[0] + pert
    truth = s0.replace(t=t_true, t_prev=t_true)
    ii = np.s_[0, -1, H:H + cfg.Mm, H:H + cfg.Lm]
    s = stepping.run(cfg, grid, truth, 2, ffn)
    obs = [fourdvar.Obs(step=2, field="t", idx=ii, values=s.t[ii],
                        sigma=0.1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (ana, diags), n = counted(lambda: fourdvar.i4dvar(
        cfg, grid, s0, obs, 2, ffn,
        sigmas={"zeta": 0.0, "u": 0.0, "v": 0.0, "t": 0.5}, b_iters=2,
        n_inner=FOURDVAR_BIG_INNER))
    sec = time.perf_counter() - t0
    jo, res = diags["Jo"], diags["cg_residuals"]
    err_b = float((s0.t[0, -1] - truth.t[0, -1]).abs().max())
    err_a = float((ana.t[0, -1] - truth.t[0, -1]).abs().max())
    print(f"[fourdvar-big] I4D-Var twin UPWELLING {cfg.Lm}x{cfg.Mm}x{cfg.N}"
          f" float64, {obs[0].values.numel()} SST obs at step 2, n_inner "
          f"{FOURDVAR_BIG_INNER}: Jo {jo[0]:.6e} -> {jo[-1]:.6e}, CG "
          f"residuals {[float(f'{r:.4e}') for r in res]}, SST error "
          f"{err_b:.4f} -> {err_a:.4f}, {sec:.2f} s; launches by row (the "
          f"final cost's nonlinear run) {n}; on {smi}", flush=True)
    check(all(np.isfinite(jo)) and all(np.isfinite(res)) and
          all(bool(torch.isfinite(getattr(ana, k)).all())
              for k in ("zeta", "u", "v", "t")), "a non-finite I4D-Var")
    check(jo[-1] < jo[0], f"Jo does not fall at 41x80x16: {jo}")
    check(all(n[r] == 2 for r in UPWELLING_ROWS) and n[5] == 0,
          f"the I4D-Var's nonlinear run missed a kernel: {n}")


def fourdvar_phase(device, smi):
    """Phase 20: the tangent-linear and adjoint step and the 4D-Var
    drivers on the card ((a)-(e) of the module docstring)."""
    t0 = time.perf_counter()
    fourdvar_tlm_adm(device, smi)
    t1 = time.perf_counter()
    fourdvar_small(device)
    t2 = time.perf_counter()
    fourdvar_big(device, smi)
    print(f"[fourdvar] phase 20: (a)-(b) {t1 - t0:.1f} s, (c)-(d) "
          f"{t2 - t1:.1f} s, (e) {time.perf_counter() - t2:.1f} s",
          flush=True)


NESTING_FIXTURE = os.path.join(ROOT, "tests", "data",
                               "torch_nesting_small.npz")
# the refined patch of (a): UPWELLING parent cells 10-19 x 30-39, factor 3
NESTED_PATCH = dict(istr=10, iend=19, jstr=30, jend=39, factor=3)
NESTED_STEPS = 2              # parent steps of (a), kernels on and off
BLOCKED_LAYOUT = (2, 4)       # (c)'s eta x xi blocks, in process
BLOCKED_STEPS = 2
BLOCKED_RTOL = 1e-11          # (c): blocked against one block, x max|field|
NEST_FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")


def _by_row(counts) -> dict:
    """{row: launches} of a {wrapper name: launches}, rows launched only."""
    return {r: counts[k] for r, k in enumerate(ROWS, 1) if counts[k]}


def nested_upwelling(device, smi):
    """Phase 21 (a): UPWELLING 41x80x16 float64 with the refined patch
    NESTED_PATCH (30x30x16, dt 100 s), NESTED_STEPS parent steps of
    make_nested_stepper (two_way, conserve, flux_coupling) with the
    kernels on against cfg.pallas2d=False on both grids, each field of
    each grid within BENCH_EQUIV_RTOL x max|field|; the launches by row of
    the parent's and the fine grid's steps; the ms of a nested step."""
    import torch
    from roms_tpu_torch import nesting, stepping
    from roms_tpu_torch.models import upwelling
    fx = nesting_fixture_script()
    cfg_c, grid_c, s0, ffn = upwelling.build(upwelling.make_config(),
                                             device=device)
    spec = nesting.RefineSpec(**NESTED_PATCH)
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, spec)
    sf0 = nesting.init_refined(cfg_c, grid_c, s0, spec, cfg_f, grid_f)
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    per_grid = {cfg_c.name: dict.fromkeys(table, 0),
                cfg_f.name: dict.fromkeys(table, 0)}
    plain_step = stepping.step

    def counting_step(cfg, *args, **kw):
        before = {k: w.launches for k, w in table.items()}
        out = plain_step(cfg, *args, **kw)
        for k, w in table.items():
            per_grid[cfg.name][k] += w.launches - before[k]
        return out

    def run(on):
        stepn = nesting.make_nested_stepper(
            cfg_c.replace(pallas2d=on), grid_c, cfg_f.replace(pallas2d=on),
            grid_f, spec, forcing_c=ffn, forcing_f=ffn, conserve=True,
            flux_coupling=True)
        sc, sf, ms = s0, sf0, []
        for _ in range(NESTED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc, sf = stepn(sc, sf)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sc, sf, ms

    stepping.step = counting_step
    try:
        for w in table.values():
            w.launches = 0
        sc_on, sf_on, ms_on = run(True)
        parent = _by_row(per_grid[cfg_c.name])
        fine = _by_row(per_grid[cfg_f.name])
        sc_off, sf_off, ms_off = run(False)
    finally:
        stepping.step = plain_step
    print(f"[nesting] UPWELLING {cfg_c.Lm}x{cfg_c.Mm}x{cfg_c.N} f64 with "
          f"the patch {NESTED_PATCH} ({cfg_f.Lm}x{cfg_f.Mm}x{cfg_f.N}, dt "
          f"{cfg_f.dt:g} s): {NESTED_STEPS} nested steps, launches by row "
          f"of the parent's steps {parent}, of the fine grid's "
          f"{3 * NESTED_STEPS} steps {fine}", flush=True)
    print(f"[nesting] ms of a nested step (host clock; {smi}): kernels on "
          f"{', '.join(f'{t:.1f}' for t in ms_on)}; plain "
          f"{', '.join(f'{t:.1f}' for t in ms_off)}", flush=True)
    check(parent == {r: NESTED_STEPS for r in UPWELLING_ROWS},
          f"the parent's steps did not launch rows 1-4, 6-11 once each: "
          f"{parent}")
    check(not any(r in fine for r in (8, 9, 10, 11)),
          f"the fine grid's bry steps launched rows 8-11: {fine}")
    P = fx.port(device)
    worst = 0.0
    for tag, cfg, on, off in (("parent", cfg_c, sc_on, sc_off),
                              ("fine", cfg_f, sf_on, sf_off)):
        errs = fx._compare(fx.interiors(P, {tag: (cfg, on)}),
                           fx.interiors(P, {tag: (cfg, off)}))
        finite = all(bool(torch.isfinite(getattr(s, k)).all())
                     for s in (on, off) for k in NEST_FIELDS)
        key = max(errs, key=errs.get)
        worst = max(worst, errs[key])
        print(f"[nesting] {tag}: kernels on against off, worst "
              f"{key} {errs[key]:.3e} x max|field| (bound "
              f"{BENCH_EQUIV_RTOL:g}), finite={finite}", flush=True)
        check(finite and errs[key] <= BENCH_EQUIV_RTOL,
              f"nested UPWELLING {tag}: kernels on and off disagree")
    return parent, fine


def nesting_small(device, long=False):
    """Phase 21 (b): the small nested and composite runs and the blocked
    UPWELLING runs against tests/data/torch_nesting_small.npz at
    CARD_FACTOR x the CPU bounds, and roms_tpu's nesting checks
    (tests/test_nesting.py) on the card: rest and constancy, the contact
    flux, volume conservation; with --nesting-parallel-long also the
    transparent composite contact (120 steps)."""
    import numpy as np
    import torch
    from roms_tpu_torch import nesting
    fx = nesting_fixture_script()
    ref = np.load(NESTING_FIXTURE)
    errors = {}
    for part in fx.PARTS:
        t0 = time.perf_counter()
        errs = fx.errors(part, fx.port_part(part, device), ref, CARD_FACTOR)
        errors.update({f"{part}/{k}": e for k, e in errs.items()})
        print(f"[nesting-small] {part}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
    print(f"[nesting-small] {len(errors)} outputs against the fixture; "
          f"worst against its bound: {worst[0]} {worst[1][0]:.3e} (bound "
          f"{worst[1][1]:g})", flush=True)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    check(not bad, f"the small nesting runs miss their fixture: {bad}")

    P = fx.port(device)
    spec = nesting.RefineSpec(**fx.SPEC)
    cfg_c, grid_c = fx.nested_parent(P)
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, spec)
    Hc, Hf = cfg_c.halo, cfg_f.halo
    itc = (slice(Hc, Hc + cfg_c.Mm), slice(Hc, Hc + cfg_c.Lm))
    itf = (slice(Hf, Hf + cfg_f.Mm), slice(Hf, Hf + cfg_f.Lm))
    # rest and constancy through three nested cycles
    rest = P.initial_state(cfg_c, t=P.asarray(np.stack(
        [np.full((cfg_c.N, cfg_c.ny_tot, cfg_c.nx_tot), v)
         for v in (17.0, 35.0)])))
    sf = nesting.init_refined(cfg_c, grid_c, rest, spec, cfg_f, grid_f)
    stepn = nesting.make_nested_stepper(cfg_c, grid_c, cfg_f, grid_f, spec)
    sc = rest
    for _ in range(3):
        sc, sf = stepn(sc, sf)
    dev_t = max(float((s.t[0][(slice(None),) + it] - 17.0).abs().max())
                for s, it in ((sc, itc), (sf, itf)))
    dev_u = max(float(s.u[(slice(None),) + it].abs().max())
                for s, it in ((sc, itc), (sf, itf)))
    # the contact flux after conserve_bry_flux, under a sheared ubar
    y = P.numpy(grid_c.yr) - P.numpy(grid_c.yr)[Hc + 10, Hc + 12]
    sheared = fx.nested_state(P, cfg_c, grid_c, width=3.0e3)
    sheared = sheared.replace(ubar=P.fill_halo(cfg_c, P.asarray(
        0.02 * np.cos(y / 4.0e3))))
    bry = nesting.conserve_bry_flux(
        cfg_c, grid_c, sheared, spec, cfg_f, grid_f,
        nesting.extract_bry(cfg_c, grid_c, sheared, spec, cfg_f))
    iu = Hc + spec.istr - 1
    D = sheared.zeta + grid_c.h
    Tc = (sheared.ubar[:, iu] * 0.5 * (D[:, iu - 1] + D[:, iu]) *
          grid_c.on_u[:, iu])[Hc + spec.jstr - 1:Hc + spec.jend]
    hu = 0.5 * (grid_f.h[:, Hf - 1] + grid_f.h[:, Hf])
    Tf = (bry["ubar_west"] * (hu + bry["zeta_west"]) *
          grid_f.on_u[:, Hf])[Hf:Hf + cfg_f.Mm].reshape(-1, spec.factor)
    flux_err = float((Tf.sum(-1) - Tc).abs().max())
    # volume conservation with the flux coupling, 1 + 6 nested steps
    bump = fx.nested_state(P, cfg_c, grid_c)
    area = (1.0 / (grid_c.pm * grid_c.pn))[itc]
    bump_vol = float((bump.zeta[itc].abs() * area).sum())
    sf = nesting.init_refined(cfg_c, grid_c, bump, spec, cfg_f, grid_f)
    stepn = nesting.make_nested_stepper(cfg_c, grid_c, cfg_f, grid_f, spec,
                                        flux_coupling=True)
    sc, sf = stepn(bump, sf)
    vol0 = float((sc.zeta[itc] * area).sum())
    for _ in range(6):
        sc, sf = stepn(sc, sf)
    vol_err = abs(float((sc.zeta[itc] * area).sum()) - vol0) / bump_vol
    t_err = max(float((s.t[0][(slice(None),) + it] - 17.0).abs().max())
                for s, it in ((sc, itc), (sf, itf)))
    print(f"[nesting-small] roms_tpu's checks: at rest after 3 nested "
          f"steps |T - 17| {dev_t:.3e} (< 1e-9), |u| {dev_u:.3e} (< 1e-12); "
          f"contact transport |fine - parent| {flux_err:.3e} m3/s of "
          f"{float(Tc.abs().max()):.3e}; volume drift over 6 nested steps "
          f"{vol_err:.3e} of the bump (< 1e-3), |T - 17| {t_err:.3e} "
          f"(< 2e-4)", flush=True)
    check(dev_t < 1e-9 and dev_u < 1e-12, "the nested rest state moved")
    check(flux_err <= 1e-12 * max(float(Tc.abs().max()), 1e-300),
          "conserve_bry_flux missed the parent transport")
    check(vol_err < 1e-3 and t_err < 2e-4,
          "the flux-coupled nested run lost volume or tracer constancy")
    if long:
        t0 = time.perf_counter()
        olap, la = fx.COMPOSITE["olap"], 32
        cfg_t, grid_t = fx.composite_member(P, 2 * la - olap, "Clo", "Clo",
                                            "mono")
        s_t = fx.pulse(P, cfg_t, grid_t, 12e3)
        for _ in range(120):
            s_t = P.stepping.step(cfg_t, grid_t, s_t)
        out = fx.run_composite(P, steps=120, la=la, lb=la)
        H = cfg_t.halo
        zt = s_t.zeta[H:-H, H:-H]
        zb = out["b"][1].zeta[H:-H, H:-H]
        zc = torch.cat([out["a"][1].zeta[H:-H, H:-H][:, :la - olap], zb],
                       dim=1)
        amp = float(zt.abs().max())
        diff = float((zc - zt).abs().max())
        print(f"[nesting-small] composite contact after 120 steps: pulse "
              f"{amp:.4f} m, |composite - monolithic| {diff:.3e} m (< 1e-3), "
              f"max|zeta| of grid B {float(zb.abs().max()):.4f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(amp > 0.03 and diff < 1e-3 and
              float(zb.abs().max()) > 0.8 * amp,
              "the composite contact is not transparent")


def blocked_benchmark(device, smi):
    """Phase 21 (c) and (d): BENCHMARK1 512x64x30 float64 from the state
    three plain steps from rest, BLOCKED_STEPS steps on BLOCKED_LAYOUT
    blocks in process against one block with the kernels off, each field
    within BLOCKED_RTOL x max|field|, no kernel launched by the blocked
    run, ms/step of both; the blocked run's sharded history assembled
    against the HistoryWriter records of its unblocked states, bitwise."""
    import tempfile
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.io import pio
    from roms_tpu_torch.io.netcdf import HistoryWriter, read_history
    from roms_tpu_torch.parallel import smap
    cfg, grid, s0, ffn = bench_developed(device)
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    plain = cfg.replace(pallas2d=False)
    stepping.step(plain, grid, s0, ffn)             # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_one = stepping.run(plain, grid, s0, BLOCKED_STEPS, ffn)
    torch.cuda.synchronize()
    ms_one = (time.perf_counter() - t0) * 1e3 / BLOCKED_STEPS

    lay = smap.Layout(*BLOCKED_LAYOUT)
    step = smap.make_smap_stepper(cfg, grid, lay, ffn)
    sb = smap.block(cfg, lay, s0)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "bench_pio")
        writer = pio.ShardedHistoryWriter(base, cfg, lay)
        his = HistoryWriter(os.path.join(tmp, "bench_his.nc"), cfg)
        for w in table.values():
            w.launches = 0
        ms_blk = []
        for _ in range(BLOCKED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sb = step(sb)
            torch.cuda.synchronize()
            ms_blk.append((time.perf_counter() - t0) * 1e3)
            s_blk = smap.unblock(cfg, lay, sb)
            writer.write(sb, s_blk.time)
            his.write(s_blk)
        launches = {k: w.launches for k, w in table.items() if w.launches}
        writer.close()
        his.close()
        parts = pio.read_sharded(base)
        rec = read_history(os.path.join(tmp, "bench_his.nc"))
        same = all(np.array_equal(parts[k], rec[k]) for k in
                   ("zeta", "ubar", "vbar", "u", "v")) and \
            np.array_equal(parts["t"][:, 0], rec["temp"]) and \
            np.array_equal(parts["t"][:, 1], rec["salt"]) and \
            np.array_equal(parts["time"], rec["ocean_time"])
    print(f"[blocked] BENCHMARK1 {cfg.Lm}x{cfg.Mm}x{cfg.N} f64 on "
          f"{BLOCKED_LAYOUT[0]}x{BLOCKED_LAYOUT[1]} blocks in process, "
          f"{BLOCKED_STEPS} steps: ms/step blocked "
          f"{', '.join(f'{t:.1f}' for t in ms_blk)}, one block plain "
          f"{ms_one:.1f} (host clock; {smi}); kernel launches in the "
          f"blocked run {launches}", flush=True)
    check(not launches, f"the blocked run launched kernels: {launches}")
    for name in BENCH_FIELDS:
        a, b = getattr(s_blk, name), getattr(s_one, name)
        err = float((a - b).abs().max())
        tol = BLOCKED_RTOL * max(float(b.abs().max()), 1e-300)
        ok = bool(torch.isfinite(a).all()) and err <= tol
        print(f"[blocked] {name:5s}: |blocked - one block| = {err:.3e} "
              f"(bound {tol:.3e}) {'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"BENCHMARK1 {name}: blocked and one block disagree")
    print(f"[blocked] (d) the sharded history of {BLOCKED_STEPS} records "
          f"assembled equals the gathered HistoryWriter's bitwise: {same}",
          flush=True)
    check(same, "the sharded history differs from the gathered one")
    return ms_blk, ms_one


def nesting_phase(device, smi, long=False):
    """Phase 21: refinement and composite nesting, the blocked
    decomposition and sharded output on the card ((a)-(d) of the module
    docstring)."""
    t0 = time.perf_counter()
    nested_upwelling(device, smi)
    t1 = time.perf_counter()
    nesting_small(device, long)
    t2 = time.perf_counter()
    blocked_benchmark(device, smi)
    print(f"[nesting] phase 21: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
          f"(c)-(d) {time.perf_counter() - t2:.1f} s", flush=True)


def column_times(device, names=()):
    """`--column-times TREE [KERNEL ...]`: the time a call of rows 1-4 and
    6-10 (or of the KERNELs named), with the host's time (device_ms) and
    on the device alone (profiled_ms), on the arguments the UPWELLING and
    BENCHMARK1 steps give them, f64 and f32 (uv3dmix2 on fresh copies for
    each call), and rhs3d's registers and stack frame, with
    roms_tpu_torch imported from TREE, so that two trees' kernels can be
    timed in turn in one run."""
    import torch
    import roms_tpu_torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import benchmark, upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS

    from roms_tpu_torch.ops import rhs3d_cuda
    print(f"[column-times] roms_tpu_torch from "
          f"{os.path.dirname(os.path.abspath(roms_tpu_torch.__file__))}",
          flush=True)
    for dtype in ("float64", "float32"):
        lay = rhs3d_cuda.rhs3d_layout(getattr(torch, dtype))
        print(f"[column-times] rhs3d {dtype}: {lay['registers']} "
              f"registers, {lay['stack_bytes']} bytes of stack frame a "
              f"thread", flush=True)
    table = wrappers()
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(),
                                        device=device)
    developed = {
        "upwelling": (upwelling, stepping.run(cfg.replace(pallas2d=False),
                                              grid, s, 3, ffn)),
        "benchmark1": (benchmark, bench_developed(device)[2])}
    for case, (model, s) in developed.items():
        for dtype in ("float64", "float32"):
            cfg, grid, _, ffn = model.build(model.make_config(dtype=dtype),
                                            device=device)
            state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                                 for k in TENSOR_FIELDS})
            calls = captured_calls(cfg, grid, state, ffn)
            for name in names or (
                    "grid_flux", "eos", "omega", "uv3dmix2", "prsgrd32",
                    "rhs3d", "tracer_predictor", "tracer_corrector",
                    "uv_corrector"):
                fn = getattr(*table[name][:2])
                per_call = name in IN_PLACE
                print(f"[column-times] {case} {name} {dtype}: kernel "
                      f"{device_ms(fn, *calls[name], per_call):.4f} ms, "
                      f"device "
                      f"{profiled_ms(fn, *calls[name], per_call):.4f} ms",
                      flush=True)


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable ({exc})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    timing = sys.argv[1:2] == ["--column-times"]
    regional_only = sys.argv[1:2] in (["--regional"], ["--regional-long"])
    regional_long = sys.argv[1:2] == ["--regional-long"]
    coastal_only = sys.argv[1:2] == ["--coastal"]
    operators_only = sys.argv[1:2] == ["--operators"]
    cases2_only = sys.argv[1:2] in (["--cases2"], ["--cases2-long"])
    cases2_long = sys.argv[1:2] == ["--cases2-long"]
    sediment_only = sys.argv[1:2] in (["--sediment"], ["--sediment-long"])
    sediment_long = sys.argv[1:2] == ["--sediment-long"]
    biology_only = sys.argv[1:2] == ["--biology"]
    forward_only = sys.argv[1:2] in (["--forward"], ["--forward-long"])
    forward_long = sys.argv[1:2] == ["--forward-long"]
    fourdvar_only = sys.argv[1:2] == ["--fourdvar"]
    nesting_only = sys.argv[1:2] in (["--nesting-parallel"],
                                     ["--nesting-parallel-long"])
    nesting_long = sys.argv[1:2] == ["--nesting-parallel-long"]
    sys.path.insert(0, os.path.abspath(sys.argv[2]) if timing else ROOT)
    try:
        import roms_tpu_torch  # noqa: F401
        from roms_tpu_torch.ops import _kernels
    except ImportError as exc:
        print(f"chip_smoke: roms_tpu_torch is not importable beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    for path in (ANCHOR, BENCH_FIXTURE, REGIONAL_FIXTURE, COASTAL_FIXTURE,
                 OPERATORS_FIXTURE, CASES2_FIXTURE, SEDIMENT_FIXTURE,
                 BIOLOGY_FIXTURE, FORWARD_FIXTURE, FOURDVAR_FIXTURE,
                 NESTING_FIXTURE):
        if not os.path.exists(path):
            print(f"chip_smoke: missing {path}", file=sys.stderr)
            return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    if timing:
        print(f"[device] {name}; {nvidia_smi()}", flush=True)
        column_times(device, sys.argv[3:])
        return 0
    try:
        smi = nvidia_smi()
        print(f"[device] {name}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
              flush=True)

        t0 = time.perf_counter()
        info = _kernels.build()
        _kernels.library()
        print(f"[build] nvcc {' '.join(_kernels.NVCC_FLAGS)}: "
              f"{time.perf_counter() - t0:.1f} s -> {info['path'].name}",
              flush=True)
        for line in info["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[build] {line.strip()}")

        if regional_only:
            regional_phase(device, smi, long=regional_long)
            return 0
        if coastal_only:
            coastal_phase(device, smi)
            return 0
        if operators_only:
            operators_phase(device, smi)
            return 0
        if cases2_only:
            cases2_phase(device, smi, long=cases2_long)
            return 0
        if sediment_only:
            sediment_phase(device, smi, long=sediment_long)
            return 0
        if biology_only:
            biology_phase(device, smi)
            return 0
        if forward_only:
            forward_phase(device, smi, long=forward_long)
            return 0
        if fourdvar_only:
            fourdvar_phase(device, smi)
            return 0
        if nesting_only:
            nesting_phase(device, smi, long=nesting_long)
            return 0
        results = {}
        kernel_checks(results, device)
        main_path(device)
        long_run(device, name)
        profile(device)
        bench = {}
        cfg64, grid64, s64, ffn = bench_developed(device)
        bench_kernel_checks(bench, device, s64)
        bench_equivalence(device, cfg64, grid64, s64, ffn)
        del cfg64, grid64, s64
        bench_fixture(device)
        launches = bench_long_run(device, name)
        profile(device, "benchmark")
        driver_phase(device, smi)
        regional_phase(device, smi)
        coastal_phase(device, smi)
        operators_phase(device, smi)
        cases2_phase(device, smi)
        sediment_phase(device, smi)
        biology_phase(device, smi)
        forward_phase(device, smi)
        fourdvar_phase(device, smi)
        nesting_phase(device, smi)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for k, (src, rep, _) in KERNELS.items():
        r = bench[k]["float32"]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
