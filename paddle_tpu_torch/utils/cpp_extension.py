"""JIT C++ extension loading — paddle.utils.cpp_extension parity (port
of ``paddle_tpu/utils/cpp_extension.py``).

Reference: python/paddle/utils/cpp_extension/ (setup/CppExtension/load —
compile user C++ sources against the framework and register their ops).

A C++ extension is a HOST library: g++ compiles the sources to a shared
object (cached by the hash of the sources and flags, under
``build/extensions/`` of this checkout unless ``build_directory`` names
another place), ctypes binds the exported functions, and
``host_op_from_extension`` lifts one of them into a registered op: it
runs on host copies of its inputs and returns its result on the
caller's device, eagerly and inside a ``to_static`` trace (a
``torch.library`` op whose fake kernel is ``out_shape_fn``).  Use it for
CPU-side logic — tokenizers, samplers, custom data transforms — not for
device math; device kernels go through ``register_pallas_op``.
"""

import ctypes
import hashlib
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import torch

_CTYPE_MAP = {
    "void": None,
    "int": ctypes.c_int,
    "int64": ctypes.c_int64,
    "float": ctypes.c_float,
    "double": ctypes.c_double,
    "char*": ctypes.c_char_p,
    "void*": ctypes.c_void_p,
    "float*": ctypes.POINTER(ctypes.c_float),
    "double*": ctypes.POINTER(ctypes.c_double),
    "int64*": ctypes.POINTER(ctypes.c_int64),
    "int*": ctypes.POINTER(ctypes.c_int),
}

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "extensions")


def _as_ctype(spec):
    if spec is None or isinstance(spec, str):
        return _CTYPE_MAP[spec] if spec is not None else None
    return spec  # already a ctypes type


def load(name, sources, functions=None, extra_cflags=(),
         build_directory=None, verbose=False):
    """Compile ``sources`` (C++ files or inline source strings) into a
    shared library and return a namespace of bound functions.

    ``functions`` maps exported symbol -> (restype, [argtypes...]) where
    types are ctypes types or the string shorthands "int", "float*", ....
    Parity: paddle.utils.cpp_extension.load (JIT path).

    >>> mod = load("my_ext", ["ext.cc"],
    ...            functions={"my_op": ("void", ["float*", "int"])})
    >>> mod.my_op(buf, n)
    """
    build_dir = build_directory or BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)

    src_paths = []
    blob = hashlib.sha1()
    for i, src in enumerate(sources):
        if os.path.exists(src):
            src_paths.append(os.path.abspath(src))
            with open(src, "rb") as f:
                blob.update(f.read())
        else:  # inline source string
            p = os.path.join(build_dir, f"{name}_src{i}.cc")
            with open(p, "w") as f:
                f.write(src)
            src_paths.append(p)
            blob.update(src.encode())
    blob.update(" ".join(extra_cflags).encode())

    so_path = os.path.join(build_dir, f"lib{name}_{blob.hexdigest()[:12]}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = (["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o",
                tmp] + list(extra_cflags) + src_paths)
        if verbose:
            print("[cpp_extension]", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, so_path)   # a concurrent load never sees a partial file

    lib = ctypes.CDLL(so_path)
    ns = SimpleNamespace(_lib=lib, _so_path=so_path)
    for fname, (restype, argtypes) in (functions or {}).items():
        fn = getattr(lib, fname)
        fn.restype = _as_ctype(restype)
        fn.argtypes = [_as_ctype(a) for a in argtypes]
        setattr(ns, fname, fn)
    return ns


_TORCH = {np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64,
          np.dtype(np.float16): torch.float16,
          np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
          np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8,
          np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool}


def _np_dtype(td):
    for k, v in _TORCH.items():
        if v == td:
            return k
    raise TypeError(f"host ops take numpy dtypes; got {td}")


def host_op_from_extension(name, fn, out_shape_fn, backward=None,
                           tags=("custom", "host")):
    """Register a host function (numpy in/out) as an op.

    ``fn(*np_arrays) -> np_array`` runs on host copies of the inputs;
    its result goes back to the first input's device.
    ``out_shape_fn(*avals) -> (shape, dtype)``-like (any object with
    ``.shape`` and a numpy-convertible ``.dtype``, given objects with the
    inputs' ``.shape`` and numpy ``.dtype``) declares the result
    (InferMeta parity — shapes must not depend on input VALUES); it is
    the op's fake kernel, so the op traces under ``to_static``.
    ``backward`` as in ``register_custom_op`` (required for training:
    a host function is opaque to autograd).
    """
    from .custom_op import register_custom_op

    def out_meta(*args):
        out = out_shape_fn(*[SimpleNamespace(shape=tuple(a.shape),
                                             dtype=_np_dtype(a.dtype))
                             for a in args])
        return tuple(int(d) for d in out.shape), _TORCH[np.dtype(out.dtype)]

    qual = f"paddle_tpu_custom::{name}"

    @torch.library.custom_op(qual, mutates_args=())
    def host_op(xs: list[torch.Tensor]) -> torch.Tensor:
        shape, dt = out_meta(*xs)
        host = fn(*[x.detach().cpu().numpy() for x in xs])
        out = torch.from_numpy(np.array(host, dtype=_np_dtype(dt)))
        return out.reshape(shape).to(xs[0].device)

    @host_op.register_fake
    def _(xs):
        shape, dt = out_meta(*xs)
        return xs[0].new_empty(shape, dtype=dt)

    return register_custom_op(name, lambda *xs: host_op(list(xs)),
                              backward=backward, tags=tags)
