"""Result artifact writers (a copy of the JAX package's ``io/writer.py``;
the file it writes is the same, field for field).

The reference parses ``io.output`` (result TOML) and ``io.visualization``
(viz PLY) but contains no writer for either (``src/common.cpp:48-49``;
SURVEY §2 C2, §5).  This module implements them: the result TOML records the
optimal ``R``/``t``, the final MSE/SSE, node counts and timings.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def write_result_toml(
    path: str,
    R: np.ndarray,
    t: np.ndarray,
    mse: float,
    sse: float,
    *,
    mode: int = 4,
    converged: bool = True,
    rot_nodes: int = 0,
    trans_nodes: int = 0,
    icp_iters: int = 0,
    wall_s: float = 0.0,
    extra: Optional[dict] = None,
):
    R = np.asarray(R, np.float64).tolist()
    t = np.asarray(t, np.float64).tolist()
    lines = [
        "# goicp_tpu registration result",
        f'timestamp = "{time.strftime("%Y-%m-%dT%H:%M:%S")}"',
        f"mode = {int(mode)}",
        f"converged = {str(bool(converged)).lower()}",
        "",
        "[result]",
        "rotation = [",
        *(f"  [{R[i][0]!r}, {R[i][1]!r}, {R[i][2]!r}]," for i in range(3)),
        "]",
        f"translation = [{t[0]!r}, {t[1]!r}, {t[2]!r}]",
        f"mse = {float(mse)!r}",
        f"sse = {float(sse)!r}",
        "",
        "[stats]",
        f"rot_nodes = {int(rot_nodes)}",
        f"trans_nodes = {int(trans_nodes)}",
        f"icp_iters = {int(icp_iters)}",
        f"wall_s = {float(wall_s)!r}",
    ]
    if extra:
        lines += ["", "[extra]"]
        for k, v in extra.items():
            if isinstance(v, str):
                lines.append(f'{k} = "{v}"')
            elif isinstance(v, bool):
                lines.append(f"{k} = {str(v).lower()}")
            else:
                lines.append(f"{k} = {v!r}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
