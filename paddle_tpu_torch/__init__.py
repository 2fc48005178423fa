"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module layout path for path
(``paddle_tpu/X.py`` becomes ``paddle_tpu_torch/X.py``) and keeps its
numerics, but is written in PyTorch.  Every Pallas kernel on a ported
path becomes a kernel written by hand for ``sm_90a`` (``csrc/``), built
with ``nvcc`` at first use and bound through ``ctypes``
(``ops/cuda/_build.py``); beside each kernel sits its plain PyTorch
version, which is what runs for tensors on the CPU.

The port imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``paddle_tpu``.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""

from .framework.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
