"""ctypes loader for the native C++ runtime core (``native/``).

The reference keeps its host-side runtime (TCPStore rendezvous, flag
registry, memory stats — SURVEY §2.2/§2.6) in C++; so do we.  The library is
built on demand with g++ (toolchain is guaranteed in the image) and cached
next to the sources; if compilation is impossible the Python fallbacks in
``distributed.store`` keep everything working.
"""

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpaddle_native.so")

_lib = None
_lib_lock = threading.Lock()
_build_error = None


def _stale():
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for f in os.listdir(_NATIVE_DIR):
        if f.endswith((".cc", ".h")):
            if os.path.getmtime(os.path.join(_NATIVE_DIR, f)) > lib_mtime:
                return True
    return False


def _bind(lib):
    lib.pd_store_server_start.restype = ctypes.c_void_p
    lib.pd_store_server_start.argtypes = [ctypes.c_int]
    lib.pd_store_server_port.restype = ctypes.c_int
    lib.pd_store_server_port.argtypes = [ctypes.c_void_p]
    lib.pd_store_server_stop.argtypes = [ctypes.c_void_p]
    lib.pd_store_client_connect.restype = ctypes.c_void_p
    lib.pd_store_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                            ctypes.c_int]
    lib.pd_store_client_close.argtypes = [ctypes.c_void_p]
    lib.pd_store_set.restype = ctypes.c_int
    lib.pd_store_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_uint64]
    lib.pd_store_get.restype = ctypes.c_int
    lib.pd_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.POINTER(ctypes.c_uint64)]
    lib.pd_store_add.restype = ctypes.c_int
    lib.pd_store_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.pd_store_wait.restype = ctypes.c_int
    lib.pd_store_wait.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.pd_store_del.restype = ctypes.c_int
    lib.pd_store_del.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pd_store_num_keys.restype = ctypes.c_int
    lib.pd_store_num_keys.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.pd_free.argtypes = [ctypes.c_void_p]
    lib.pd_last_error.restype = ctypes.c_void_p
    lib.pd_flags_set.restype = ctypes.c_int
    lib.pd_flags_set.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.pd_flags_get.restype = ctypes.c_void_p
    lib.pd_flags_get.argtypes = [ctypes.c_char_p]
    lib.pd_flags_dump.restype = ctypes.c_void_p
    lib.pd_stat_update.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64]
    lib.pd_stat_current.restype = ctypes.c_int64
    lib.pd_stat_current.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pd_stat_peak.restype = ctypes.c_int64
    lib.pd_stat_peak.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pd_stat_reset_peak.argtypes = [ctypes.c_char_p, ctypes.c_int]
    return lib


_PKG_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "libpaddle_native.so")


def load():
    """Load the native library; None if unavailable.

    Search order: (1) the wheel-installed copy inside the package
    (``paddle_tpu/native/`` — placed there by setup.py's build_py hook),
    (2) the source checkout's ``native/`` directory, rebuilding on demand
    when sources are newer than the .so.
    """
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if os.path.exists(_PKG_LIB_PATH) and not os.path.isdir(
                    _NATIVE_DIR):
                _lib = _bind(ctypes.CDLL(_PKG_LIB_PATH))
            else:
                if _stale():
                    subprocess.run(["make", "-s"], cwd=_NATIVE_DIR,
                                   check=True, capture_output=True,
                                   timeout=120)
                _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except Exception as e:  # missing toolchain / RO filesystem
            _build_error = e
            return None
    # replay Python-side flags set before the library existed
    try:
        from ..framework import flags as _flags_mod
        for k, v in _flags_mod.get_flags().items():
            _lib.pd_flags_set(str(k).encode(), str(v).encode())
    except Exception:
        pass
    return _lib


def available():
    return load() is not None


def loaded():
    """True only if the library is already loaded (never triggers a build)."""
    return _lib is not None


def last_error(lib):
    ptr = lib.pd_last_error()
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.pd_free(ptr)


def _take_cstr(lib, ptr):
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.pd_free(ptr)


def flags_set(name, value):
    lib = load()
    if lib is None:
        return False
    lib.pd_flags_set(name.encode(), str(value).encode())
    return True


def flags_get(name):
    lib = load()
    if lib is None:
        return None
    return _take_cstr(lib, lib.pd_flags_get(name.encode()))


def stat_update(kind, dev_id, delta):
    lib = load()
    if lib is not None:
        lib.pd_stat_update(kind.encode(), int(dev_id), int(delta))


def stat_current(kind, dev_id):
    lib = load()
    return int(lib.pd_stat_current(kind.encode(), int(dev_id))) if lib else 0


def stat_peak(kind, dev_id):
    lib = load()
    return int(lib.pd_stat_peak(kind.encode(), int(dev_id))) if lib else 0


def stat_reset_peak(kind, dev_id):
    lib = load()
    if lib is not None:
        lib.pd_stat_reset_peak(kind.encode(), int(dev_id))
