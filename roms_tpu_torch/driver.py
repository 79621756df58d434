"""Run-mode driver: counterpart of ``roms_tpu/driver.py``, the analog of the
reference's driver layer (ROMS/Drivers/nl_roms.h ROMS_initialize /
ROMS_run / ROMS_finalize) and main3d's orchestration of I/O, diagnostics,
and blowup handling.

    sim = Simulation(cfg, grid, state0, forcing_fn,
                     his_file="his.nc", nhis=10, rst_file="rst", nrst=100)
    sim.run(nsteps)
    sim.finalize()

The streams' writers take numpy arrays: a record copies the State to the
host once (``convert.state_to_numpy``).  Each restart is a file of its
own, ``<rst_file>_<step>.pt`` (``Simulation.rst_paths``).  With dia_file
and ndia, every step also returns its budget terms
(``stepping.step(collect_diags=True)``), which are summed on the device
and written as their mean every ndia steps (the DIA file, wrt_diags.F).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .config import Config
from .convert import state_to_numpy
from .grid import Grid
from .state import State, TENSOR_FIELDS
from . import stepping
from .utils import diag as diag_mod
from .utils.timers import Profiler


class BlowupError(RuntimeError):
    pass


class Simulation:
    # mod_average.F accumulator set: prognostic fields + mixing
    # coefficients + boundary-layer depths + fast-time-averaged
    # transports (set_avg.F field list)
    AVG_FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "Akv", "Akt",
                  "hsbl", "hbbl", "tke", "DU_avg1", "DV_avg1")
    AVG_OUT = ("zeta", "ubar", "vbar", "u", "v", "temp", "salt", "AKv",
               "AKt", "hsbl", "hbbl", "tke", "DU_avg1", "DV_avg1",
               "zeta2", "ubar2", "vbar2", "uu", "vv", "uv", "Huon",
               "Hvom", "rho")

    # quadratic / derived accumulators (set_avg.F:2352-3952: squared
    # prognostics for eddy statistics, mass fluxes, in-situ density)
    @staticmethod
    def _avg_derived():
        from . import vgrid
        from .grid import hc_of
        from .ops import eos
        from .ops.omega import set_massflux
        from .ops.stencil import ip1, jp1

        def depth(cfg, grid, s):
            return vgrid.set_depth(
                grid.h, s.zeta, hc_of(cfg), grid.sc_r, grid.Cs_r,
                grid.sc_w, grid.Cs_w, cfg.vtransform, zice=grid.zice)

        def huon(cfg, grid, s):
            Hz = depth(cfg, grid, s)[2]
            return set_massflux(cfg, grid, s.u, s.v, Hz)[0]

        def hvom(cfg, grid, s):
            Hz = depth(cfg, grid, s)[2]
            return set_massflux(cfg, grid, s.u, s.v, Hz)[1]

        def rho(cfg, grid, s):
            return eos.rho_eos(cfg, s.t, depth(cfg, grid, s)[0])

        # A defect copied from roms_tpu, so that the averages agree with
        # it: uu and vv square u and v after averaging them to rho points
        # (set_avg.F averages the squares), and varinfo registers them on
        # the r3 grid code.
        return {
            "zeta2": lambda c, g, s: s.zeta * s.zeta,
            "ubar2": lambda c, g, s: s.ubar * s.ubar,
            "vbar2": lambda c, g, s: s.vbar * s.vbar,
            "uu": lambda c, g, s: (0.5 * (s.u + ip1(s.u))) ** 2,
            "vv": lambda c, g, s: (0.5 * (s.v + jp1(s.v))) ** 2,
            "uv": lambda c, g, s: 0.25 * (s.u + ip1(s.u)) *
                                  (s.v + jp1(s.v)),
            "Huon": huon, "Hvom": hvom, "rho": rho,
        }
    QCK_FIELDS = ("zeta", "ubar", "vbar", "temp_sur", "salt_sur",
                  "u_sur", "v_sur")

    def __init__(self, cfg: Config, grid: Grid, state: State,
                 forcing_fn: Optional[Callable] = None,
                 his_file: Optional[str] = None, nhis: int = 0,
                 rst_file: Optional[str] = None, nrst: int = 0,
                 avg_file: Optional[str] = None, navg: int = 0,
                 dia_file: Optional[str] = None, ndia: int = 0,
                 qck_file: Optional[str] = None, nqck: int = 0,
                 ndef_his: int = 0,
                 ninfo: int = 10, log: Callable = print):
        self.cfg = cfg
        self.grid = grid
        # private copy: the caller's tensors stay as they are
        self.state = state.replace(**{k: getattr(state, k).clone()
                                      for k in TENSOR_FIELDS})
        self.forcing_fn = forcing_fn
        self.ninfo = ninfo
        self.nhis = nhis
        self.nrst = nrst
        self.rst_file = rst_file
        self.rst_paths = []
        self.log = log
        self.profiler = Profiler()
        self.navg = navg
        self.ndia = ndia
        self.avg_writer = None
        self.dia_writer = None
        self._avg_acc = None
        self._dia_acc = None
        self._avg_on = avg_on = bool(avg_file and navg > 0)
        self._dia_on = dia_on = bool(dia_file and ndia > 0)

        if dia_on:
            # the step's budget terms, every step (DIAGNOSTICS_TS/UV)
            self._step = lambda s: stepping.step(cfg, grid, s, forcing_fn,
                                                 collect_diags=True)
        elif avg_on:
            # the averages' sums, on the device, every step
            drv = self._avg_derived()
            self._step = lambda s: stepping.run_accum(
                cfg, grid, s, 1, forcing_fn, fields=self.AVG_FIELDS,
                derived=drv)
        else:
            self._step = stepping.make_stepper(cfg, grid, forcing_fn)

        from .io.netcdf import DiagWriter, HistoryWriter, FileRing
        self.writer = None
        if his_file and nhis > 0:
            if ndef_his > 0:
                self.writer = FileRing(HistoryWriter, his_file,
                                       ndef_his, cfg, grid)
            else:
                self.writer = HistoryWriter(his_file, cfg, grid)
        self.qck_writer = None
        self.nqck = nqck
        if qck_file and nqck > 0:
            self.qck_writer = HistoryWriter(qck_file, cfg, grid,
                                            fields=self.QCK_FIELDS)
        if avg_on:
            self.avg_writer = HistoryWriter(avg_file, cfg, grid,
                                            fields=self.AVG_OUT)
        if dia_on:
            self.dia_writer = DiagWriter(dia_file, cfg)

    # -- ROMS_run ------------------------------------------------------
    def run(self, nsteps: int):
        cfg = self.cfg
        for _ in range(nsteps):
            # wait for the card before a step whose state is read, so that
            # the step's time is not charged to the region that reads it
            with self.profiler.region("3d time stepping",
                                      sync=self._reads(self.state.iic + 1)):
                if self._dia_on:
                    self.state, dia = self._step(self.state)
                    if self._dia_acc is None:
                        self._dia_acc = dia
                    else:
                        for k, v in dia.items():
                            self._dia_acc[k].add_(v)
                elif self._avg_on:
                    self.state, sums = self._step(self.state)
                    if self._avg_acc is None:
                        self._avg_acc = sums
                    else:
                        for k, v in sums.items():
                            self._avg_acc[k].add_(v)
                else:
                    self.state = self._step(self.state)
            iic = int(self.state.iic)
            if self.ninfo and iic % self.ninfo == 0:
                with self.profiler.region("diagnostics"):
                    d = diag_mod.diagnostics(cfg, self.grid, self.state)
                    ke, umax, zmax = torch.stack(
                        [d["ke"], d["umax"], d["zmax"]]).tolist()
                self.log(
                    f" {iic:7d} {float(self.state.time) / 86400.0:10.4f} "
                    f"KE={ke:.6E} umax={umax:.4f} zmax={zmax:.4f}")
                if diag_mod.blowup(cfg, d):
                    # graceful stop with final restart (nl_roms.h:367-375)
                    if self.rst_file:
                        self._write_rst()
                    raise BlowupError(
                        f"blowup detected at step {iic}: "
                        f"umax={umax}, finite={bool(d['finite'])}")
            host = None
            if self.writer and iic % self.nhis == 0:
                with self.profiler.region("output: history"):
                    host = state_to_numpy(self.state)
                    self.writer.write(host)
            if self.qck_writer and iic % self.nqck == 0:
                with self.profiler.region("output: quick"):
                    if host is None:
                        host = state_to_numpy(self.state)
                    self.qck_writer.write(host)
            if self.avg_writer and iic % self.navg == 0 and \
                    self._avg_acc is not None:
                with self.profiler.region("output: averages"):
                    # the means of AVG_FIELDS and of the derived fields
                    mean = {k: (a / self.navg).cpu().numpy()
                            for k, a in self._avg_acc.items()}
                    self.avg_writer.write(
                        mean, time=float(self.state.time) -
                        0.5 * self.navg * self.cfg.dt)
                    self._avg_acc = None
            if self.dia_writer and iic % self.ndia == 0 and \
                    self._dia_acc is not None:
                with self.profiler.region("output: diagnostics"):
                    self.dia_writer.write(
                        {k: a.cpu().numpy()
                         for k, a in self._dia_acc.items()},
                        time=float(self.state.time) -
                        0.5 * self.ndia * self.cfg.dt,
                        scale=1.0 / self.ndia)
                    self._dia_acc = None
            if self.rst_file and self.nrst and iic % self.nrst == 0:
                with self.profiler.region("output: restart"):
                    self._write_rst()
        return self.state

    def _reads(self, iic: int) -> bool:
        """Whether step `iic` ends in a NINFO line, a record or a
        restart."""
        return any(w and n and iic % n == 0 for w, n in (
            (True, self.ninfo), (self.writer, self.nhis),
            (self.qck_writer, self.nqck), (self.avg_writer, self.navg),
            (self.dia_writer, self.ndia), (self.rst_file, self.nrst)))

    def _write_rst(self):
        from .io import checkpoint
        path = f"{self.rst_file}_{int(self.state.iic):07d}.pt"
        checkpoint.save(path, self.state)
        self.rst_paths.append(path)

    # -- ROMS_finalize -------------------------------------------------
    def finalize(self):
        for w in (self.writer, self.avg_writer, self.qck_writer,
                  self.dia_writer):
            if w:
                w.close()
        self.log(self.profiler.report())


def restart(cfg: Config, rst_file: str, template: State) -> State:
    """The State of the restart file `rst_file` (one of
    ``Simulation.rst_paths``) on the device and in the dtype of
    `template`."""
    from .io import checkpoint
    return checkpoint.restore(rst_file, template)
