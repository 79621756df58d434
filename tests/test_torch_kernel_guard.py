"""ops/_kernels.refuse_autodiff on the CPU: the check every kernel wrapper
makes before it reads a pointer or launches (through
_kernels.check_tensors) raises a RuntimeError that names the kernel and
pallas2d=False for a tensor under torch.func.vjp (and jvp), one that
requires grad while grad mode is on, and a forward-AD dual, and lets a
tensor with no derivative pass.  The step never reaches a kernel on the
CPU, so the functions are called directly; chip_smoke.py phase 20 (b)
calls wrappers on the card.
"""

import pytest
import torch
import torch.autograd.forward_ad as fwAD

from roms_tpu_torch.ops import _kernels


def _refuses(t):
    with pytest.raises(RuntimeError, match="roms_eos kernel.*pallas2d=False"):
        _kernels.refuse_autodiff("roms_eos", [None, t])


def test_kernels_refuse_a_tensor_under_torch_func_vjp():
    x = torch.ones(4, dtype=torch.float64)
    torch.func.vjp(lambda a: (_refuses(a), a)[1], x)
    torch.func.jvp(lambda a: (_refuses(a), a)[1], (x,), (x,))


def test_kernels_refuse_a_tensor_that_requires_grad():
    x = torch.ones(4, dtype=torch.float64, requires_grad=True)
    _refuses(x)
    _refuses(x * 2.0)
    # with grad mode off no derivative is recorded: the launch may go on
    with torch.no_grad():
        _kernels.refuse_autodiff("roms_eos", [x])


def test_kernels_refuse_a_forward_ad_dual():
    x = torch.ones(4, dtype=torch.float64)
    with fwAD.dual_level():
        _refuses(fwAD.make_dual(x, torch.ones_like(x)))
    _kernels.refuse_autodiff("roms_eos", [x])



def test_check_tensors_refuses_first():
    """check_tensors, which every wrapper calls before anything reads a
    pointer, refuses a tensor under torch.func.vjp before it checks the
    arguments (here a shape that is wrong as well)."""
    x = torch.ones(4, dtype=torch.float64)

    def wrapper(a):
        with pytest.raises(RuntimeError,
                           match="roms_uv3dmix2 kernel.*pallas2d=False"):
            _kernels.check_tensors("roms_uv3dmix2", {"u": a}, {"u": (5,)},
                                   a.dtype, a.device)
        return a

    torch.func.vjp(wrapper, x)
    assert _kernels.check_tensors("roms_uv3dmix2", {"u": x}, {"u": (4,)},
                                  x.dtype, x.device)
