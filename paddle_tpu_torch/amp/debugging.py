"""AMP numerics debugging (port of ``paddle_tpu/amp/debugging.py``;
reference python/paddle/amp/debugging.py: TensorCheckerConfig :79,
enable_operator_stats_collection :314).

Both tools ride the op dispatcher's debug hook (``ops/dispatch.py::
set_debug_hook``), which sees every registered op's name and its output
tensors, so enabling a checker needs no model change.  The hook runs on
calls with Paddle Tensors and, while it is installed, on the raw torch
path too (the port's GPT, its engine and ``TrainStep``), where the JAX
hook sees only eager calls.  Each check reads one flag an output on
the host, so a checker syncs every op it checks: a debugging tool, off
by default.
"""

import contextlib

import torch

__all__ = ["TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "DebugMode"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    """Reference debugging.TensorCheckerConfig parity.

    enable: master switch; debug_mode: abort vs report; skipped_op_list:
    op names exempt from checking; checked_op_list, when given, the only
    ones checked.
    """

    def __init__(self, enable=False,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list or [])
        self.skipped_op_list = set(skipped_op_list or [])

    def _should_check(self, op_name):
        if self.checked_op_list:
            return op_name in self.checked_op_list
        return op_name not in self.skipped_op_list


_checker = None
_op_stats = None


def _inexact(o):
    return isinstance(o, torch.Tensor) and (o.is_floating_point()
                                            or o.is_complex())


def _hook(op_name, out_leaves):
    if _op_stats is not None:
        _op_stats.record(op_name, out_leaves)
    if _checker is not None:
        check_outputs(op_name, out_leaves)


def _sync_hook():
    from ..ops import dispatch

    dispatch.set_debug_hook(
        _hook if (_checker is not None or _op_stats is not None) else None)


def current_checker():
    return _checker


def enable_tensor_checker(config):
    """Reference debugging.enable_tensor_checker."""
    global _checker
    _checker = config if config.enable else None
    _sync_hook()


def disable_tensor_checker():
    global _checker
    _checker = None
    _sync_hook()


def check_outputs(op_name, out_leaves):
    """Called from the dispatcher on every op while a checker is active:
    a NaN or an Inf in a floating output raises FloatingPointError
    naming the op (or, with ``CHECK_NAN_INF``, prints the message)."""
    cfg = _checker
    if cfg is None or not cfg._should_check(op_name):
        return
    for o in out_leaves:
        if _inexact(o) and not bool(torch.isfinite(o).all()):
            msg = f"[TensorChecker] NaN/Inf in output of op '{op_name}'"
            if cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                raise FloatingPointError(msg)
            print(msg)


# --------------------------------------------------------------- op stats --

def _dtype_name(o):
    """The JAX package's dtype spelling (``float32``), or ``other``."""
    if isinstance(o, torch.Tensor):
        return str(o.dtype).replace("torch.", "")
    return "other"


class _OpStats:
    def __init__(self):
        # op -> dtype -> [calls, nan_inf_outputs]
        self.table = {}

    def record(self, op_name, out_leaves):
        seen_dtypes = set()
        for o in out_leaves:
            dt = _dtype_name(o)
            row = self.table.setdefault(op_name, {}).setdefault(dt, [0, 0])
            if dt not in seen_dtypes:  # one call per op invocation
                row[0] += 1
                seen_dtypes.add(dt)
            if _inexact(o) and not bool(torch.isfinite(o).all()):
                row[1] += 1

    def summary(self):
        lines = ["op operator stats (calls / nan-inf outputs per dtype):"]
        for op in sorted(self.table):
            for dt, (calls, bad) in sorted(self.table[op].items()):
                lines.append(f"  {op:<32} {dt:<10} {calls:>8} {bad:>6}")
        return "\n".join(lines)


def enable_operator_stats_collection():
    """Reference debugging.enable_operator_stats_collection:314."""
    global _op_stats
    _op_stats = _OpStats()
    _sync_hook()


def disable_operator_stats_collection():
    """Stops collection and prints the table (reference behavior)."""
    global _op_stats
    if _op_stats is not None:
        print(_op_stats.summary())
    stats, _op_stats = _op_stats, None
    _sync_hook()
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    """Reference debugging.collect_operator_stats context manager."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()
