"""paddle.version parity (reference python/paddle/version.py, generated
by setup.py at build time)."""

full_version = "0.2.0"
major = "0"
minor = "2"
patch = "0"
rc = "0"
cuda_version = "False"   # no CUDA anywhere — TPU-native build
cudnn_version = "False"
tpu = True
commit = "unknown"
with_pip = True

__all__ = ["full_version", "major", "minor", "patch", "rc", "commit",
           "cuda", "cudnn", "show"]


def cuda():
    return cuda_version


def cudnn():
    return cudnn_version


def show():
    print(f"full_version: {full_version}")
    print(f"commit: {commit}")
    print("tpu: True (jax/XLA compute, no CUDA)")
