"""Under a ParCtx every kernel gate of roms_tpu_torch is off, as roms_tpu's
are inside its shard_map region (diag_pallas.py:40, mix3d_pallas.py:51,
prsgrd_pallas.py:41, rhs3d_pallas.py:53, step2d_pallas.py:73,
step3d_pallas.py:66), so a blocked step runs the plain path; on the card
a blocked step launches no kernel (the wrappers' counts)."""

import pytest
import torch

from roms_tpu_torch.models import upwelling
from roms_tpu_torch.ops import bc, diag_cuda, mix3d_cuda, prsgrd_cuda, \
    rhs3d_cuda, step2d_cuda, step3d_cuda
from roms_tpu_torch.parallel import smap

torch.set_num_threads(1)


def _gates(cfg, grid):
    return {
        "diag_cuda.supported": diag_cuda.supported(cfg, grid),
        "diag_cuda.use_omega": diag_cuda.use_omega(cfg),
        "mix3d_cuda.supported": mix3d_cuda.supported(cfg),
        "mix3d_cuda.use_kernels": mix3d_cuda.use_kernels(cfg),
        "prsgrd_cuda.supported": prsgrd_cuda.supported(cfg),
        "rhs3d_cuda.supported": rhs3d_cuda.supported(cfg),
        "rhs3d_cuda.use_kernels": rhs3d_cuda.use_kernels(cfg),
        "step2d_cuda.supported": step2d_cuda.supported(cfg),
        "step3d_cuda.use_tracer": step3d_cuda.use_tracer(cfg),
        "step3d_cuda.use_uv": step3d_cuda.use_uv(cfg),
    }


def test_every_gate_off_under_a_parctx():
    cfg, grid, _, _ = upwelling.build(
        upwelling.make_config(Lm=24, Mm=16, N=4, ndtfast=8), device="cpu")
    assert all(_gates(cfg, grid).values()), _gates(cfg, grid)
    lay = smap.Layout(2, 4)
    for pos in [(0, 0), (1, 3), (0, 2)]:
        bc.push_ctx(smap.make_ctx(lay, pos))
        try:
            on = {k: v for k, v in _gates(cfg, grid).items() if v}
        finally:
            bc.pop_ctx()
        assert not on, (pos, on)
    assert all(_gates(cfg, grid).values())


@pytest.mark.gpu
def test_blocked_step_on_the_card_launches_no_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import wrappers
    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(Lm=24, Mm=16, N=4, ndtfast=8), device="cuda")
    lay = smap.Layout(2, 2)
    step = smap.make_smap_stepper(cfg, grid, lay, ffn)
    sb = smap.block(cfg, lay, s0)
    for w in table.values():
        w.launches = 0
    sb = step(sb)
    torch.cuda.synchronize()
    assert {k: w.launches for k, w in table.items() if w.launches} == {}
    s1 = smap.unblock(cfg, lay, sb)
    assert torch.isfinite(s1.zeta).all()
    # the same step on one block launches rows 1-4 and 6-11 once each
    from roms_tpu_torch import stepping
    stepping.step(cfg, grid, s0, ffn)
    torch.cuda.synchronize()
    assert all(w.launches == 1 for k, w in table.items()
               if k != "t3dmix2_geo"), {k: w.launches for k, w in
                                        table.items()}
