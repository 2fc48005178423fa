"""Hand-written CUDA kernels for Hopper (``sm_90a``), one wrapper each.

Sources live in ``paddle_tpu_torch/csrc``; ``_build`` compiles them
with ``nvcc`` at first use.  ``registry.KERNELS`` lists every kernel
with its plain PyTorch version.
"""
