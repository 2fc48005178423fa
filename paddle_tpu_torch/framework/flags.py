"""Global flag registry.

Analog of the reference's exported-gflags registry (paddle/phi/core/flags.cc,
``paddle.set_flags``/``get_flags``).  Flags default from ``FLAGS_*`` env vars.
"""

import os

_FLAG_DEFS = {
    # name: (default, parser)
    "FLAGS_check_nan_inf": (False, lambda v: str(v).lower() in ("1", "true")),
    "FLAGS_cudnn_deterministic": (False, lambda v: str(v).lower() in ("1", "true")),
    "FLAGS_low_precision_op_list": (0, int),
    "FLAGS_use_pallas_kernels": (True, lambda v: str(v).lower() not in ("0", "false")),
    # Min seq length for the Pallas flash-attention path; below it the fused
    # XLA attention wins on TPU (profiled: v5e, head_dim 64).
    "FLAGS_flash_min_seqlen": (1024, int),
    "FLAGS_eager_vjp_cache": (True, lambda v: str(v).lower() not in ("0", "false")),
    # Pallas block-size autotune (ops/pallas/autotune.py); off by default —
    # the first sighting of a shape would otherwise pay N compiles.
    "FLAGS_use_autotune": (False, lambda v: str(v).lower() in ("1", "true")),
    "FLAGS_allocator_strategy": ("auto_growth", str),
    "FLAGS_stop_check_timeout": (900, int),
}

_flags = {}
for _name, (_default, _parser) in _FLAG_DEFS.items():
    _flags[_name] = _parser(os.environ[_name]) if _name in os.environ else _default


def set_flags(flags):
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of FLAGS_name -> value")
    for k, v in flags.items():
        if k not in _FLAG_DEFS:
            # open registry: accept unknown flags so user plugins can define their own
            _flags[k] = v
        else:
            _flags[k] = _FLAG_DEFS[k][1](v)
    # Mirror into the native registry (paddle/phi/core/flags.cc parity) so
    # C++ runtime components observe the same values.  Only when the library
    # is already loaded — set_flags must never trigger a compile.
    try:
        from ..core import native as _native
        if _native.loaded():
            for k in flags:
                _native.flags_set(k, _flags[k])
    except Exception:
        pass


def get_flags(flags=None):
    if flags is None:
        return dict(_flags)
    if isinstance(flags, str):
        flags = [flags]
    return {k: _flags[k] for k in flags}
