"""roms_tpu_torch: the PyTorch/CUDA port of the roms_tpu ocean dynamical core.

Same layout and module names as ``roms_tpu``: halo-padded ``[..., N, eta,
xi]`` tensors with array index ``a = roms_i + halo - 1``, and the stage
functions under ``ops/``.  The kernels that ``roms_tpu`` wrote in Pallas for
the TPU are hand-written CUDA here (``csrc/``), built with ``nvcc`` at first
use; each sits beside its plain PyTorch version (``ops/*_cuda.py``).

This package imports torch and numpy only, never jax.
"""

from .config import Config, LBC
from .grid import Grid, build_grid, build_weights

__version__ = "0.1.0"
