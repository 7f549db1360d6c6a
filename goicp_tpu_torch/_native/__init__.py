"""ctypes bindings for the native runtime (``goicp_native.cpp``).

The source is a copy of the JAX package's, so both packages pop frontier
nodes in the same order (``std::nth_element`` breaks ``(lb, ub)`` ties in an
order ``np.lexsort`` does not reproduce).  Built with ``make`` on first use
into ``build/`` beside this file (git-ignored); falls back cleanly
(``lib() is None``) so the numpy frontier keeps working.  Disable with
``GOICP_TPU_NATIVE=0``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD, "libgoicp_native.so")
_lock = threading.Lock()
_lib = None
_tried = False

_f32p = ctypes.POINTER(ctypes.c_float)


def _bind(lib):
    lib.gn_frontier_new.restype = ctypes.c_int64
    lib.gn_frontier_new.argtypes = [ctypes.c_int64]
    lib.gn_frontier_free.argtypes = [ctypes.c_int64]
    lib.gn_frontier_size.restype = ctypes.c_int64
    lib.gn_frontier_size.argtypes = [ctypes.c_int64]
    lib.gn_frontier_push.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _f32p, _f32p, _f32p,
    ]
    lib.gn_frontier_pop_best.restype = ctypes.c_int64
    lib.gn_frontier_pop_best.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _f32p, _f32p, _f32p,
    ]
    lib.gn_frontier_dump.restype = ctypes.c_int64
    lib.gn_frontier_dump.argtypes = [ctypes.c_int64, _f32p, _f32p, _f32p]
    lib.gn_frontier_prune.restype = ctypes.c_int64
    lib.gn_frontier_prune.argtypes = [ctypes.c_int64, ctypes.c_float]
    lib.gn_frontier_min_lb.restype = ctypes.c_float
    lib.gn_frontier_min_lb.argtypes = [ctypes.c_int64]
    lib.gn_read_txt.restype = ctypes.c_int64
    lib.gn_read_txt.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64]
    return lib


def _build():
    """Compile into a private temp name, then rename into place: several
    test workers may race to build the same library."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(
            ["make", "-C", _HERE, "-sB", f"SO={tmp}"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def lib():
    """The loaded native library, or None if unavailable/disabled."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GOICP_TPU_NATIVE", "1") == "0":
            return None
        try:
            src = os.path.join(_HERE, "goicp_native.cpp")
            if not os.path.exists(_SO) or (
                os.path.getmtime(src) > os.path.getmtime(_SO)
            ):
                _build()
            _lib = _bind(ctypes.CDLL(_SO))
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib
