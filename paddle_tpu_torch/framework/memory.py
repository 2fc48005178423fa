"""Device/host memory statistics (port of ``paddle_tpu/framework/
memory.py``).

Reference: paddle/fluid/memory/stats.cc (Stat{Update,GetCurrent,GetPeak})
exposed as paddle.device.cuda.max_memory_allocated etc.  Device numbers
come from PyTorch's CUDA caching allocator (``torch.cuda.memory_stats``:
``allocated_bytes.all.current`` / ``.peak`` and ``reserved_bytes``);
where there is no such device (the CPU, or an id past the device count)
they come from the host-side counters of the native C++ runtime
(``native/flags_stats.cc`` through ``core/native.py``), as the JAX
package falls back when its device reports no stats.
``reset_peak_memory_stats`` resets both.
"""

import torch

from ..core import native as _native

_ALLOCATED = "Allocated"
_RESERVED = "Reserved"


def _device_stats(device_id=0):
    if not torch.cuda.is_available() or \
            device_id >= torch.cuda.device_count():
        return {}
    return torch.cuda.memory_stats(device_id)


def memory_allocated(device_id=0):
    """Bytes currently allocated on the device."""
    stats = _device_stats(device_id)
    if "allocated_bytes.all.current" in stats:
        return int(stats["allocated_bytes.all.current"])
    return _native.stat_current(_ALLOCATED, device_id)


def max_memory_allocated(device_id=0):
    stats = _device_stats(device_id)
    if "allocated_bytes.all.peak" in stats:
        return int(stats["allocated_bytes.all.peak"])
    return _native.stat_peak(_ALLOCATED, device_id)


def memory_reserved(device_id=0):
    stats = _device_stats(device_id)
    if "reserved_bytes.all.current" in stats:
        return int(stats["reserved_bytes.all.current"])
    return _native.stat_current(_RESERVED, device_id)


def max_memory_reserved(device_id=0):
    stats = _device_stats(device_id)
    if "reserved_bytes.all.peak" in stats:
        return int(stats["reserved_bytes.all.peak"])
    return _native.stat_peak(_RESERVED, device_id)


def reset_peak_memory_stats(device_id=0):
    if _device_stats(device_id):
        torch.cuda.reset_peak_memory_stats(device_id)
    _native.stat_reset_peak(_ALLOCATED, device_id)
    _native.stat_reset_peak(_RESERVED, device_id)


def host_stat_update(kind, delta, device_id=0):
    """Host-side accounting hook (DataLoader pinned buffers etc.)."""
    _native.stat_update(kind, device_id, delta)


def host_stat_current(kind, device_id=0):
    return _native.stat_current(kind, device_id)


def host_stat_peak(kind, device_id=0):
    return _native.stat_peak(kind, device_id)
