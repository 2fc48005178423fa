"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), under ``build/paddle_tpu_torch/`` at the root of
the checkout, named by a hash of the sources and flags — an edited
source builds anew, an unchanged one is reused.  :func:`build` starts
one ``nvcc`` per missing library, all at once, and waits for them.

Nothing here touches CUDA at import time: the CPU tests import every
module of the port, and this one only reaches ``nvcc`` when a kernel
is first launched on a CUDA tensor (or when ``build`` is called).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# register / shared-memory report per kernel, kept in <lib>.log
_REPORT_FLAGS = ("-Xptxas=-v",)

_loaded = {}


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "with the CUDA toolkit on the GPU machine")
    return nvcc


def lib_path(name):
    """Library path for ``csrc/<name>.cu``, keyed by the source, every
    ``csrc/*.cuh`` header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=None):
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` each, started together.  Returns ``{name: (seconds, log)}``
    where ``log`` holds the compiler's register/shared-memory report;
    seconds is 0.0 for a library that was already built.  Raises
    RuntimeError with the compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, result = {}, {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            with open(out + ".log") as f:
                result[name] = (0.0, f.read())
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *_REPORT_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       time.perf_counter(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
        result[name] = (seconds, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return result


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
