"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The port mirrors the JAX package's module layout path for path
(``paddle_tpu/X.py`` becomes ``paddle_tpu_torch/X.py``) and keeps its
numerics, but is written in PyTorch.  Every Pallas kernel on a ported
path becomes a kernel written by hand for ``sm_90a`` (``csrc/``), built
with ``nvcc`` at first use and bound through ``ctypes``
(``ops/cuda/_build.py``); beside each kernel sits its plain PyTorch
version, which is what runs for tensors on the CPU.

The top-level namespace is the Paddle API's eager front end, as far as
it is ported: ``Tensor``/``to_tensor``, dtypes and places, ``seed``,
grad modes, the creation and random functions, every registered op,
``grad``, ``nn``, ``optimizer``, ``amp``, ``jit``, ``save``/``load``,
``io``, ``metric``, ``vision``, ``linalg``, ``fft``, ``signal``, ``audio``,
``text``, ``profiler``, ``incubate``, ``sparse``, ``distribution``,
``geometric``, ``strings``, the tensor-array functions, ``static``,
``quantization``, ``inference``, ``version`` and the high-level
``Model`` (``hapi``) with ``summary`` and ``flops``.

The port imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``paddle_tpu``.  Entry points run on the CUDA device unless
the caller asks for the CPU: ``set_device("cpu")`` for the Paddle API,
``device="cpu"`` for the serving and model constructors.
"""

__version__ = "0.1.0"

from .core.tensor import Tensor, to_tensor  # noqa: F401

from .framework import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    TPUPlace,
    bfloat16,
    bool_ as bool,  # noqa: A001
    complex64,
    complex128,
    device_count,
    float16,
    float32,
    float64,
    get_default_dtype,
    get_device,
    get_flags,
    in_dynamic_mode,
    int8,
    int16,
    int32,
    int64,
    is_compiled_with_cuda,
    is_compiled_with_tpu,
    is_grad_enabled,
    no_grad,
    resolve_device,
    seed,
    set_default_dtype,
    set_device,
    set_flags,
    set_grad_enabled,
    uint8,
)

from . import ops as _ops_pkg  # registry + Tensor patching  # noqa: F401

# creation
from .ops.creation import (  # noqa: F401
    arange,
    assign,
    clone,
    complex,  # noqa: A001
    diag,
    diag_embed,
    diagflat,
    empty,
    empty_like,
    eye,
    full,
    full_like,
    linspace,
    logspace,
    meshgrid,
    numel,
    ones,
    ones_like,
    polar,
    tril,
    tril_indices,
    triu,
    triu_indices,
    zeros,
    zeros_like,
)

# random
from .ops.random import (  # noqa: F401
    bernoulli,
    multinomial,
    normal,
    poisson,
    rand,
    randint,
    randint_like,
    randn,
    randperm,
    standard_normal,
    uniform,
)

from .ops.registry import OPS as _OPS


def _export_registry(globalns):
    for name, opdef in _OPS.items():
        if name not in globalns and not name.startswith("_"):
            globalns[name] = opdef.user_fn


_export_registry(globals())

from .autograd import grad  # noqa: F401, E402
from . import autograd  # noqa: F401, E402
from . import amp  # noqa: F401, E402
from . import nn  # noqa: F401, E402

from .nn.layer_base import ParamAttr  # noqa: F401, E402
from . import optimizer  # noqa: F401, E402
from . import jit  # noqa: F401, E402
from .framework_io import load, save  # noqa: F401, E402
from .ops.registry import coverage as op_coverage  # noqa: F401, E402
from . import inference  # noqa: F401, E402
from . import incubate  # noqa: F401, E402
from . import io  # noqa: F401, E402
from . import distributed  # noqa: F401, E402
from . import metric  # noqa: F401, E402
from . import vision  # noqa: F401, E402
from . import hapi  # noqa: F401, E402
from .hapi import Model, flops, summary  # noqa: F401, E402
from . import linalg  # noqa: F401, E402
from . import fft  # noqa: F401, E402
from . import signal  # noqa: F401, E402
from . import audio  # noqa: F401, E402
from . import text  # noqa: F401, E402
from . import profiler  # noqa: F401, E402
from . import sparse  # noqa: F401, E402
from . import distribution  # noqa: F401, E402
from . import geometric  # noqa: F401, E402
from . import strings  # noqa: F401, E402
from . import static  # noqa: F401, E402
from . import quantization  # noqa: F401, E402
from . import version  # noqa: F401, E402
from . import onnx  # noqa: F401, E402
from . import utils  # noqa: F401, E402
from . import cost_model  # noqa: F401, E402
from .tensor_array import (  # noqa: F401, E402
    TensorArray,
    array_length,
    array_read,
    array_write,
    create_array,
)


def disable_static(place=None):
    return None


def enable_static():
    raise NotImplementedError(
        "paddle_tpu_torch has no ProgramDesc static mode; use "
        "paddle_tpu_torch.jit.to_static to compile functions/Layers.")


def is_tensor(x):
    return isinstance(x, Tensor)
