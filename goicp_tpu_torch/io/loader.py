"""Cloud loading: extension dispatch, Bernoulli subsampling, uniform resize.

Counterpart of ``load_cloud{,_ply,_txt}`` (``src/common.cpp:79-228``).  The
reference subsamples with an *unseeded* ``std::random_device``-seeded
``std::mt19937`` and caps the kept count at ``total*subsample``; here the
sampling is deterministic given ``seed`` (required for reproducible
benchmarks and RMSE comparisons, SURVEY §7 hard-part 6), with the same
semantics: each point kept with probability ``subsample``, at most
``floor(total*subsample)`` points kept, scanning in file order.
"""

from __future__ import annotations

import os

import numpy as np

from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.io.ply import read_ply
from goicp_tpu_torch.io.txt import read_txt


def subsample_cloud(
    points: np.ndarray, subsample: float, seed: int = 0
) -> np.ndarray:
    """Bernoulli(subsample) thinning capped at floor(n*subsample) points."""
    n = points.shape[0]
    if subsample >= 1.0:
        return points
    cap = int(n * subsample)
    rng = np.random.default_rng(seed)
    keep = rng.random(n) <= subsample
    idx = np.nonzero(keep)[0][:cap]
    return points[idx]


def load_cloud(
    path: str,
    subsample: float = 1.0,
    resize: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Load a ``.ply``/``.txt`` cloud, subsample, and scale by ``resize``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        pts = read_ply(path)
    elif ext == ".txt":
        pts = read_txt(path)
    else:
        raise ValueError(f"unsupported file extension: {ext!r} ({path})")
    pts = subsample_cloud(pts, subsample, seed)
    if resize != 1.0:
        pts = pts * np.float32(resize)
    get_logger().info("Point cloud %s loaded with %d points!", path, pts.shape[0])
    return np.ascontiguousarray(pts, np.float32)
