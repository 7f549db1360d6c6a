"""TXT point-cloud reader/writer.

Format identical to the reference's (``src/common.cpp:148-203``): first line
is the point count, then one ``x y z`` line per point
(e.g. ``data/bunny/model_bunny.txt``).
"""

from __future__ import annotations

import numpy as np


def read_txt(path: str) -> np.ndarray:
    native = _read_txt_native(path)
    if native is not None:
        return native
    with open(path, "rb") as f:
        first = f.readline()
        try:
            total = int(first.split()[0])
        except (ValueError, IndexError):
            raise ValueError(f"invalid TXT cloud header in {path!r}: {first!r}")
        if total <= 0:
            raise ValueError(f"invalid number of points in TXT file: {path}")
        data = np.loadtxt(f, dtype=np.float32, max_rows=total, ndmin=2)
    if data.shape[0] != total:
        raise ValueError(
            f"TXT file {path} declares {total} points but has {data.shape[0]}"
        )
    return data[:, :3].astype(np.float32)


def _read_txt_native(path: str):
    """C++ ``from_chars`` single-pass parser (``_native/goicp_native.cpp``,
    ``gn_read_txt``); ~10× ``np.loadtxt`` on the 150k-line artec3d exports.
    Returns None when the native runtime is unavailable (numpy fallback)."""
    try:
        from goicp_tpu_torch import _native

        lib = _native.lib()
        if lib is None:
            return None
        with open(path, "rb") as f:
            total = int(f.readline().split()[0])
        if total <= 0:
            raise ValueError(f"invalid number of points in TXT file: {path}")
        out = np.empty((total, 3), np.float32)
        import ctypes

        got = lib.gn_read_txt(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), total
        )
        if got != total:
            raise ValueError(
                f"TXT file {path} declares {total} points but has {got}"
            )
        return out
    except (OSError, ValueError):
        raise
    except Exception:
        return None


def write_txt(path: str, points: np.ndarray):
    points = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write(f"{points.shape[0]}\n")
        np.savetxt(f, points, fmt="%.6f")
