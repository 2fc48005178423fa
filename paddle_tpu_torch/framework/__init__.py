"""Framework core: dtypes, device management, RNG, flags, execution modes
(port of ``paddle_tpu/framework/__init__.py``; the analysis tools stay
submodules, imported where used)."""

from .device import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    TPUPlace,
    device_count,
    get_device,
    is_compiled_with_cuda,
    is_compiled_with_tpu,
    resolve_device,
    set_device,
)
from .dtype import (  # noqa: F401
    DTYPE_MAP,
    bfloat16,
    bool_,
    complex64,
    complex128,
    convert_dtype,
    float16,
    float32,
    float64,
    get_default_dtype,
    int8,
    int16,
    int32,
    int64,
    set_default_dtype,
    uint8,
)
from .flags import get_flags, set_flags  # noqa: F401
from .mode import (  # noqa: F401
    grad_enabled,
    in_dynamic_mode,
    is_grad_enabled,
    no_grad,
    set_grad_enabled,
)
from .random import seed  # noqa: F401
