"""Device/place management.

The port is built for the CUDA device: a constructor given
``device=None`` runs there, and raises when no CUDA device is visible
instead of carrying on silently on the CPU.  The CPU is reached only
when a caller asks for it by name (the tests do), and there every
kernel wrapper is replaced by its plain PyTorch version because the
tensors it sees lie on the CPU.

The Paddle API's places and ``set_device`` / ``get_device`` (port of
``paddle_tpu/framework/device.py``) follow the same rule: the current
device, where a Tensor built from host data is placed, is ``cuda``
until ``set_device`` names another, and resolving it raises without a
GPU.
"""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda``; anything else -> ``torch.device(device)``.

    Raises RuntimeError for a CUDA device (the default included) when
    CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch path")
    return dev


class Place:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    pass


class TPUPlace(Place):
    """Accepted for source compatibility; maps to a CUDA device."""


_current_device = None


def _torch_device(device):
    """A Paddle device string ("cpu", "gpu:0", "cuda", "tpu") or place
    -> ``torch.device``; gpu, tpu and xpu name CUDA devices."""
    if isinstance(device, torch.device):
        return device
    if isinstance(device, Place):
        return torch.device("cpu") if isinstance(device, CPUPlace) else \
            torch.device("cuda", device.device_id)
    name, _, idx = str(device).partition(":")
    if name == "cpu":
        return torch.device("cpu")
    if name in ("gpu", "cuda", "tpu", "xpu"):
        return torch.device("cuda", int(idx) if idx else 0)
    raise ValueError(f"unknown device {device!r}")


def current_device():
    """The ``torch.device`` new Tensors are placed on: the one last given
    to :func:`set_device`, else ``cuda`` (raising without a GPU)."""
    if _current_device is None:
        return resolve_device(None)
    return _current_device


def get_device():
    dev = current_device()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def set_device(device):
    """Accepts "cpu", "gpu", "gpu:0", "cuda:0", "tpu" etc.  Returns the
    place.  A CUDA device raises when CUDA is not available."""
    global _current_device
    dev = resolve_device(_torch_device(device))
    _current_device = dev
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)


def place_of(device):
    """The Paddle place of a ``torch.device``."""
    return CPUPlace() if device.type == "cpu" else CUDAPlace(device.index or 0)


def device_count():
    return torch.cuda.device_count()


def is_compiled_with_cuda():
    return torch.cuda.is_available()


def is_compiled_with_tpu():
    return False
