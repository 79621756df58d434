"""Incremental strong-constraint 4D-Var (I4D-Var) and its duals.

Counterpart of ``roms_tpu/fourdvar.py``: the analog of the reference's
I4D-Var driver stack (ROMS/Drivers/i4dvar.h ROMS_run outer/inner loops,
ROMS/Utility/congrad.F conjugate-gradient minimizer,
convolve.F/normalization.F diffusion-operator background covariance), with
the tangent-linear and adjoint models taken by automatic differentiation
of the nonlinear step instead of the hand-coded ROMS/Tangent +
ROMS/Adjoint mirrors: roms_tpu takes jax.jvp/jax.vjp, this package
torch.autograd over the same step (``Linearization``).

Control vector: initial-condition increments of (zeta, u, v, t), plus
optionally surface-forcing increments ("sustr"/"svstr" - piecewise-
constant over the window, the frc_adjust.F analog) and open-boundary
data increments ("bry:zeta_west", ... - the obc_adjust.F analog); see
_make_ops.  Background covariance: B = Sigma C Sigma with C a
diffusion-operator correlation (iterated Laplacian smoothing, the
reference's convolve.F approach) and Sigma diagonal standard deviations.
Inner loop: CG on the Gauss-Newton normal equations
  (I + B^T/2 M^T H^T R^-1 H M B^1/2) w = -B^T/2 grad Jo,
preconditioned control w with delta_x = B^1/2 w (the reference's
v-space formulation).

The kernels and the linearized runs.  roms_tpu's tangent-linear and
adjoint runs take its XLA path (its Pallas gates are off there), and no
kernel of either package has a derivative: the hand-written CUDA kernels
launch on raw device pointers, and a kernel wrapper handed a tensor that
carries a derivative raises (ops/_kernels.refuse_autodiff).  So every
function differentiated here runs the step with ``linear_config(cfg)``
(pallas2d=False, the plain PyTorch path), and every nonlinear run with no
derivative (the innovations of the duals, the final cost, a twin's truth
run) runs with the caller's cfg, kernels on where it has them.

Nothing is compiled: roms_tpu's @jax.jit closures are plain functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import torch

from .config import Config
from .grid import Grid
from .state import State, TENSOR_FIELDS
from . import stepping
from .ops import bc
from .ops.stencil import ip1, im1, jp1, jm1

CONTROL_FIELDS = ("zeta", "u", "v", "t")
DEFAULT_SIGMAS = {"zeta": 0.1, "u": 0.1, "v": 0.1, "t": 0.5}


@dataclass
class Obs:
    """Observations of one field at one model step.

    field: State field name ("zeta", "t", "u", ...); idx: an index
    (a tuple of ints, slices or index arrays) into the (padded) field
    tensor; values: observed values; sigma: observation error std dev."""
    step: int
    field: str
    idx: tuple
    values: torch.Tensor
    sigma: float = 1.0


def linear_config(cfg: Config) -> Config:
    """The configuration of a run that is differentiated: the plain path
    (pallas2d=False).  roms_tpu's TLM and ADM run its XLA path, and no
    kernel of either package has a derivative."""
    return cfg.replace(pallas2d=False)


def step_map(cfg: Config, grid: Grid, state: State,
             forcing_fn: Callable = None):
    """The step about `state` as a map of dicts of fields, for
    torch.func.jvp / vjp (the analog of jax.jvp / jax.vjp of
    stepping.step over the State pytree):

        f, x = fourdvar.step_map(cfg, grid, state, forcing)
        _, tlm = torch.func.jvp(f, (x,), (dx,))        # TLM
        _, vjp = torch.func.vjp(f, x); (adm,) = vjp(dy)  # ADM

    f maps {field: tensor} (every tensor field of a State,
    TENSOR_FIELDS) to the next step's {field: tensor}; x is the state's.
    The step runs on the plain path (linear_config)."""
    cfg_lin = linear_config(cfg)

    def f(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        s = stepping.step(cfg_lin, grid, state.replace(**d), forcing_fn)
        return {k: getattr(s, k) for k in TENSOR_FIELDS}

    return f, {k: getattr(state, k) for k in TENSOR_FIELDS}


def _smooth(cfg: Config, a, iters: int):
    """Diffusion-operator correlation smoother (convolve.F analog):
    iterated 5-point Laplacian smoothing with halo refresh."""
    for _ in range(iters):
        a = bc.fill_halo(cfg, a)
        a = a + 0.125 * (ip1(a) + im1(a) + jp1(a) + jm1(a) - 4.0 * a)
    return bc.fill_halo(cfg, a)


def make_bsqrt(cfg: Config, sigmas: Dict[str, float], iters: int = 4):
    """B^{1/2}: per-field std dev scaling + horizontal diffusion smoothing
    (self-adjoint, so B^{T/2} = B^{1/2} up to the halo projection)."""

    def bsqrt(incr: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for name, v in incr.items():
            sig = sigmas.get(name, 0.0)
            if v.ndim >= 2:
                out[name] = sig * _smooth(cfg, v, iters)
            else:
                # boundary-data lines (1-D): std-dev scaling only
                out[name] = sig * v
        return out

    return bsqrt


def _apply_B(bsqrt: Callable, v: Dict) -> Dict:
    """B v = B^1/2 B^T/2 v (B^1/2 symmetric)."""
    return bsqrt(bsqrt(v))


def _dot(a: Dict, b: Dict):
    return sum(torch.vdot(a[k].reshape(-1), b[k].reshape(-1)) for k in a)


class Linearization:
    """The tangent-linear and adjoint models of f about x = zeros (f maps
    a dict of increments to a vector): the one primal run of f records
    its graph, M^T y is a backward pass over it (the vjp) and M dx is a
    backward pass over that backward pass at a dummy cotangent u (a jvp
    built from two vjps: <M^T u, dx> is linear in u and its gradient in u
    is M dx).  Both reuse the one primal run for every product, where
    torch.func.jvp and torch.func.vjp would run f again each time, and
    give the same numbers to rounding.

    hx: f(zeros) (no derivative attached)."""

    def __init__(self, f: Callable, zeros: Dict[str, torch.Tensor]):
        self.keys = list(zeros)
        with torch.enable_grad():
            self._x = [zeros[k].detach().clone().requires_grad_()
                       for k in self.keys]
            self._y = f(dict(zip(self.keys, self._x)))
            self._u = torch.zeros_like(self._y, requires_grad=True)
            self._g = None
        self.hx = self._y.detach()

    def vjp(self, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """M^T y."""
        grads = torch.autograd.grad(self._y, self._x, y, retain_graph=True,
                                    allow_unused=True)
        return {k: torch.zeros_like(x) if g is None else g
                for k, x, g in zip(self.keys, self._x, grads)}

    def jvp(self, dx: Dict[str, torch.Tensor]) -> torch.Tensor:
        """M dx."""
        with torch.enable_grad():
            if self._g is None:
                self._g = torch.autograd.grad(
                    self._y, self._x, self._u, create_graph=True,
                    allow_unused=True)
            pairs = [(g, dx[k]) for k, g in zip(self.keys, self._g)
                     if g is not None and g.requires_grad]
            if not pairs:
                return torch.zeros_like(self.hx)
            (out,) = torch.autograd.grad(
                [g for g, _ in pairs], self._u, [d for _, d in pairs],
                retain_graph=True, allow_unused=True)
        return torch.zeros_like(self.hx) if out is None else out.detach()


def _make_ops(cfg: Config, grid: Grid, background: State,
              obs: Sequence[Obs], nsteps: int, forcing_fn: Callable,
              controls: Sequence[str] = CONTROL_FIELDS):
    """Shared 4D-Var building blocks: the sampled trajectory operator
    H∘M, the sigma-scaled observation vector, and increment helpers.

    controls: the control-vector entries.  State field names are
    initial-condition increments; "sustr"/"svstr" (and any other 2-D
    forcing key) are surface-forcing increments applied uniformly over
    the window (frc_adjust.F:1-120 piecewise-constant adjustment with
    one record); "bry:<key>" entries (e.g. "bry:zeta_west") are
    open-boundary data increments (obc_adjust.F).

    traj_obs_ctl(state, dx, run_cfg=cfg): H∘M of the state with the
    forcing increments of dx, stepped under run_cfg (a differentiated
    run passes linear_config(cfg))."""
    state_keys = [k for k in controls if hasattr(background, k)]
    frc_keys = [k for k in controls
                if not hasattr(background, k) and
                not k.startswith("bry:")]
    bry_keys = [k[4:] for k in controls if k.startswith("bry:")]

    def sample(ob, state: State):
        # fractional-coordinate obs (obs.FracObs, the extract_obs.F
        # path) carry their own sampler; integer-index Obs index the
        # padded field directly
        if hasattr(ob, "sample"):
            return ob.sample(cfg, state)
        return getattr(state, ob.field)[ob.idx]

    def _wrap_forcing(dx: Dict):
        """Apply forcing/boundary-data control increments on top of the
        case forcing (the TLM/ADM of these enters through the derivative
        of the wrapped function - the frc_adjust/obc_adjust analogs)."""
        if not frc_keys and not bry_keys:
            return forcing_fn

        def ffn(c, g, t):
            frc = dict(forcing_fn(c, g, t)) if forcing_fn else {}
            for k in frc_keys:
                frc[k] = frc.get(k, 0.0) + dx[k]
            if bry_keys:
                b = dict(frc.get("bry", {}))
                for k in bry_keys:
                    b[k] = b.get(k, 0.0) + dx["bry:" + k]
                frc["bry"] = b
            return frc
        return ffn

    def traj_obs_ctl(state: State, dx: Dict, run_cfg: Config = cfg):
        ffn = _wrap_forcing(dx)
        out = []
        for n in range(nsteps):
            state = stepping.step(run_cfg, grid, state, ffn)
            for ob in obs:
                if ob.step == n + 1:
                    out.append(sample(ob, state) / ob.sigma)
        return torch.cat([o.reshape(-1) for o in out])

    dev = background.zeta.device
    y_scaled = torch.cat(
        [torch.as_tensor(ob.values / ob.sigma, device=dev).reshape(-1)
         for ob in sorted(obs, key=lambda o: o.step)])

    def add_state_incr(state: State, dx: Dict):
        upd = {k: getattr(state, k) + dx[k] for k in state_keys}
        return state.replace(**upd)

    def zeros_incr():
        out = {k: torch.zeros_like(getattr(background, k))
               for k in state_keys}
        for k in frc_keys:
            out[k] = torch.zeros_like(background.zeta)
        for k in bry_keys:
            # boundary lines span the padded axis of their side
            n = (background.zeta.shape[-2] if k.endswith("west")
                 or k.endswith("east") else background.zeta.shape[-1])
            out["bry:" + k] = torch.zeros(
                (n,), dtype=background.zeta.dtype, device=dev)
        return out

    return traj_obs_ctl, y_scaled, add_state_incr, zeros_incr


def _setup(cfg, grid, background, obs, nsteps, forcing_fn, sigmas,
           b_iters, controls):
    """The pieces every driver shares: B^1/2, the ops of _make_ops, the
    control keys, f_about (H∘M of the increments about (x, ctl) under a
    given cfg) and the linearization about (x, ctl)."""
    bsqrt = make_bsqrt(cfg, sigmas or DEFAULT_SIGMAS, b_iters)
    traj_ctl, y_scaled, add_state, zeros_incr = _make_ops(
        cfg, grid, background, obs, nsteps, forcing_fn, controls)
    ctl_keys = [k for k in zeros_incr() if not hasattr(background, k)]
    cfg_lin = linear_config(cfg)

    def f_about(x, ctl, run_cfg):
        def f(dx):
            dxm = {**dx, **{k: dx[k] + ctl[k] for k in ctl}}
            return traj_ctl(add_state(x, dx), dxm, run_cfg)
        return f

    def linearize(x, ctl) -> Linearization:
        # differentiated: the plain path (module docstring)
        return Linearization(f_about(x, ctl, cfg_lin), zeros_incr())

    def innovation(x, ctl):
        # no derivative: the caller's cfg, kernels on where it has them
        with torch.no_grad():
            return y_scaled - f_about(x, ctl, cfg)(zeros_incr())

    return bsqrt, y_scaled, add_state, zeros_incr, ctl_keys, linearize, \
        innovation


def i4dvar(cfg: Config, grid: Grid, background: State,
           obs: Sequence[Obs], nsteps: int,
           forcing_fn: Callable = None,
           sigmas: Dict[str, float] = None,
           b_iters: int = 4, n_inner: int = 10, n_outer: int = 1,
           controls: Sequence[str] = CONTROL_FIELDS):
    """Run incremental 4D-Var; returns (analysis State, diagnostics dict).

    The trajectory operator M maps an initial State to the observed
    quantities at their steps; H samples fields at indices.  controls
    may add surface-forcing ("sustr", "svstr") and boundary-data
    ("bry:zeta_west", ...) entries to the IC control vector (the
    frc_adjust.F / obc_adjust.F adjustable-forcing analogs); their
    accumulated increments are returned in diags["control"].  The
    tensors live on the background's device.
    """
    bsqrt, y_scaled, add_state, zeros_incr, ctl_keys, linearize, \
        innovation = _setup(cfg, grid, background, obs, nsteps, forcing_fn,
                            sigmas, b_iters, controls)
    z0 = zeros_incr()
    diags = {"Jo": [], "cg_residuals": []}
    x = background
    ctl = {k: z0[k] for k in ctl_keys}

    for outer in range(n_outer):
        lin = linearize(x, ctl)
        d = lin.hx - y_scaled
        rhs = {k: -v for k, v in bsqrt(lin.vjp(d)).items()}
        diags["Jo"].append(float(0.5 * torch.vdot(d, d)))

        def hess_mv(w):
            """(I + B^T/2 M^T H^T R^-1 H M B^1/2) w about trajectory x."""
            badj = bsqrt(lin.vjp(lin.jvp(bsqrt(w))))
            return {k: w[k] + badj[k] for k in w}

        # congrad.F-style conjugate gradient in control (v) space
        w = {k: torch.zeros_like(v) for k, v in rhs.items()}
        r = rhs
        p = r
        rr = _dot(r, r)
        for it in range(n_inner):
            Ap = hess_mv(p)
            alpha = rr / torch.clamp(_dot(p, Ap), min=1e-30)
            w = {k: w[k] + alpha * p[k] for k in w}
            r = {k: r[k] - alpha * Ap[k] for k in r}
            rr_new = _dot(r, r)
            diags["cg_residuals"].append(float(torch.sqrt(rr_new)))
            beta = rr_new / torch.clamp(rr, min=1e-30)
            p = {k: r[k] + beta * p[k] for k in p}
            rr = rr_new
        del lin

        incr = bsqrt(w)
        x = add_state(x, incr)
        ctl = {k: ctl[k] + incr[k] for k in ctl}

    # final cost
    df = -innovation(x, ctl)
    diags["Jo"].append(float(0.5 * torch.vdot(df, df)))
    diags["control"] = ctl
    return x, diags


def rbl4dvar(cfg: Config, grid: Grid, background: State,
             obs: Sequence[Obs], nsteps: int,
             forcing_fn: Callable = None,
             sigmas: Dict[str, float] = None,
             b_iters: int = 4, n_inner: int = 10, n_outer: int = 1,
             controls: Sequence[str] = CONTROL_FIELDS):
    """Dual (observation-space) 4D-Var: the RBL4D-Var formulation
    (ROMS/Drivers/rbl4dvar.h + ROMS/Utility/rpcg_lanczos.F).

    Solves (R + G) z = d in observation space, G = H M B M^T H^T the
    stabilized representer matrix, with the restricted preconditioned
    conjugate gradient of Gurol et al. (2014) - inner products taken in
    the G-metric so the iterates reproduce primal (I4D-Var) convergence
    - then maps back with dx = B M^T H^T z.  Strong-constraint control
    vector (IC increments); the reference's weak-constraint model-error
    and boundary controls are a documented gap.  R = I in
    sigma-scaled observation space."""
    bsqrt, y_scaled, add_state, zeros_incr, ctl_keys, linearize, \
        innovation = _setup(cfg, grid, background, obs, nsteps, forcing_fn,
                            sigmas, b_iters, controls)
    z0 = zeros_incr()
    ctl = {k: z0[k] for k in ctl_keys}

    diags = {"Jo": [], "cg_residuals": []}
    x = background

    for outer in range(n_outer):
        d = innovation(x, ctl)
        diags["Jo"].append(float(0.5 * torch.vdot(d, d)))
        lin = linearize(x, ctl)

        def rep_mv(z):
            """G z = H M B M^T H^T z about trajectory x."""
            return lin.jvp(_apply_B(bsqrt, lin.vjp(z)))

        # RPCG: CG on (I + G) z = d with G-metric inner products
        z = torch.zeros_like(d)
        r = d
        Gr = rep_mv(r)
        p, Gp = r, Gr
        rGr = torch.vdot(r, Gr)
        for it in range(n_inner):
            Ap = p + Gp
            # alpha from the G-inner product (rpcg_lanczos.F scaling)
            pGAp = torch.vdot(Gp, Ap)
            alpha = rGr / torch.clamp(pGAp, min=1e-30)
            z = z + alpha * p
            r = r - alpha * Ap
            Gr = rep_mv(r)
            rGr_new = torch.vdot(r, Gr)
            diags["cg_residuals"].append(
                float(torch.sqrt(torch.clamp(rGr_new, min=0.0))))
            beta = rGr_new / torch.clamp(rGr, min=1e-30)
            p = r + beta * p
            Gp = Gr + beta * Gp
            rGr = rGr_new

        # back to state space: dx = B M^T H^T z
        incr = _apply_B(bsqrt, lin.vjp(z))
        del lin
        x = add_state(x, incr)
        ctl = {k: ctl[k] + incr[k] for k in ctl}

    d = innovation(x, ctl)
    diags["Jo"].append(float(0.5 * torch.vdot(d, d)))
    diags["control"] = ctl
    return x, diags


def r4dvar(cfg: Config, grid: Grid, background: State,
           obs: Sequence[Obs], nsteps: int,
           forcing_fn: Callable = None,
           sigmas: Dict[str, float] = None,
           b_iters: int = 4, n_inner: int = 10, n_outer: int = 1,
           controls: Sequence[str] = CONTROL_FIELDS):
    """Indirect-representer 4D-Var (R4D-Var; ROMS/Drivers/r4dvar.h +
    ROMS/Utility/congrad.F in observation space).

    Each outer (Picard) iteration solves the representer system
    (R + G) z = d by plain conjugate gradient in sigma-scaled
    observation space (R = I there), G = H M B M^T H^T, then maps back
    with dx = B M^T H^T z and re-linearizes about the updated
    trajectory.  Documented deltas vs the reference: the finite-
    amplitude representer-tangent model (RPM) is the exact tangent
    linearization, and the control vector is strong-constraint IC
    increments (no model-error/boundary controls)."""
    bsqrt, y_scaled, add_state, zeros_incr, ctl_keys, linearize, \
        innovation = _setup(cfg, grid, background, obs, nsteps, forcing_fn,
                            sigmas, b_iters, controls)
    z0 = zeros_incr()
    ctl = {k: z0[k] for k in ctl_keys}

    diags = {"Jo": [], "cg_residuals": []}
    x = background

    for outer in range(n_outer):
        d = innovation(x, ctl)
        diags["Jo"].append(float(0.5 * torch.vdot(d, d)))
        lin = linearize(x, ctl)

        def rep_mv(z):
            """(R + G) z with G = H M B M^T H^T about trajectory x."""
            return z + lin.jvp(_apply_B(bsqrt, lin.vjp(z)))

        # congrad.F: standard CG on the stabilized representer matrix
        z = torch.zeros_like(d)
        r = d
        p = r
        rr = torch.vdot(r, r)
        for it in range(n_inner):
            Ap = rep_mv(p)
            alpha = rr / torch.clamp(torch.vdot(p, Ap), min=1e-30)
            z = z + alpha * p
            r = r - alpha * Ap
            rr_new = torch.vdot(r, r)
            diags["cg_residuals"].append(float(torch.sqrt(rr_new)))
            beta = rr_new / torch.clamp(rr, min=1e-30)
            p = r + beta * p
            rr = rr_new

        incr = _apply_B(bsqrt, lin.vjp(z))
        del lin
        x = add_state(x, incr)
        ctl = {k: ctl[k] + incr[k] for k in ctl}

    d = innovation(x, ctl)
    diags["Jo"].append(float(0.5 * torch.vdot(d, d)))
    diags["control"] = ctl
    return x, diags
