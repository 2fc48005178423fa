"""Dtype registry: Paddle dtype names <-> torch dtypes.

Port of ``paddle_tpu/framework/dtype.py``.  The canonical dtype is a
``torch.dtype``; Paddle dtype strings ("float32", "bfloat16", ...),
numpy dtypes and Python types are accepted wherever a dtype is.  Unlike
the JAX package, which canonicalizes 64-bit integers to 32 bits (the
TPU's integer width), the port keeps Paddle's int64.
"""

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

DTYPE_MAP = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_default_dtype = torch.float32


def convert_dtype(dtype):
    """Normalize a dtype-ish value (str, torch dtype, numpy dtype, Python
    type) to a ``torch.dtype``; ``None`` stays ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype[len("torch."):] if dtype.startswith("torch.") else dtype
        if name not in DTYPE_MAP:
            raise ValueError(f"Unknown dtype string: {dtype!r}")
        return DTYPE_MAP[name]
    name = np.dtype(dtype).name
    if name not in DTYPE_MAP:
        raise ValueError(f"dtype {dtype!r} has no torch counterpart")
    return DTYPE_MAP[name]


def dtype_name(dtype):
    """The Paddle name of a torch dtype ("float32", ...)."""
    return str(dtype)[len("torch."):]


def set_default_dtype(dtype):
    global _default_dtype
    d = convert_dtype(dtype)
    if d not in (torch.float32, torch.float64, torch.float16, torch.bfloat16):
        raise TypeError(f"default dtype must be floating, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype
