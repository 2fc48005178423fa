"""Device resolution for the port's entry points.

The port is built for the CUDA device: a constructor given
``device=None`` runs there, and raises when no CUDA device is visible
instead of carrying on silently on the CPU.  The CPU is reached only
when a caller asks for it by name (the tests do), and there every
kernel wrapper is replaced by its plain PyTorch version because the
tensors it sees lie on the CPU.
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
