"""Build and load the Hopper kernels of ``csrc/`` (CUDA C++, plain C ABI).

Each ``.cu`` source compiles to an object with its own ``nvcc`` process, all
started together, and the objects link into one shared library that is
loaded with ctypes.  The build happens at first use, into ``csrc/build/``
(git-ignored), under a name keyed by the sources' content, so an edited
source never loads a stale library.  Nothing here runs at import.

The C entry points launch on the stream they are given and return
``cudaGetLastError()``; the wrappers in :mod:`goicp_tpu_torch.nn.fused`
raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None

_vp = ctypes.c_void_p
_i = ctypes.c_int


def sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build on a machine with the CUDA "
            "toolkit (set CUDA_HOME); CPU tensors use the plain PyTorch path"
        )
    return path


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def _build(so_path: str):
    cu = sources()
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        procs = []
        objs = []
        for src in cu:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )))
        errors = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{os.path.basename(src)}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = os.path.join(tmp, "lib.so")
        subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_so, *objs],
            check=True, capture_output=True,
        )
        os.replace(tmp_so, so_path)


def _bind(lib):
    lib.goicp_nn_min_d2.restype = _i
    lib.goicp_nn_min_d2.argtypes = [_vp, _i, _vp, _i, _vp, _i, _vp, _vp, _vp]
    lib.goicp_min_d2_grouped.restype = _i
    lib.goicp_min_d2_grouped.argtypes = [_vp, _i, _vp, _i, _vp, _i, _vp, _vp]
    lib.goicp_bounds_nodes.restype = _i
    lib.goicp_bounds_nodes.argtypes = [_vp, _i, _vp, _i, _vp, _i, _i, _vp, _vp, _vp]
    return lib


def lib():
    """The loaded kernel library; builds it first if needed (raises when
    the CUDA toolkit is missing or a source does not compile)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            files = sources() + sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
            so = os.path.join(_BUILD, f"libgoicp_kernels_{_digest(files)}.so")
            if not os.path.exists(so):
                _build(so)
            _lib = _bind(ctypes.CDLL(so))
    return _lib


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
