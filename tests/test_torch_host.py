"""The port's host-side copies against the JAX package's originals on the
same numpy inputs: the frontier (native and numpy), the split rule, the
rotation parameters and the cloud readers.  These are numpy code on both
sides, so results must be equal, not close."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu import io as jio  # noqa: E402
from goicp_tpu.bnb import frontier as jfrontier  # noqa: E402
from goicp_tpu.bnb.rotparam import _PARAMS as J_PARAMS  # noqa: E402
from goicp_tpu.bnb.split import classify_split as jclassify  # noqa: E402
from goicp_tpu_torch import io as tio  # noqa: E402
from goicp_tpu_torch.bnb import frontier as tfrontier  # noqa: E402
from goicp_tpu_torch.bnb.rotparam import _PARAMS  # noqa: E402
from goicp_tpu_torch.bnb.split import classify_split  # noqa: E402

torch.set_num_threads(1)

BUNNY = os.path.join(os.path.dirname(__file__), "..", "data_generated", "rotated_bunny.ply")


def _nodes(rng, n):
    """Payloads with many exact (lb, ub) ties, as early BnB rounds have."""
    pay = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    lb = rng.integers(0, 4, n).astype(np.float32) * 0.5
    ub = rng.integers(0, 3, n).astype(np.float32) + 2.0
    return pay, lb, ub


def _drive(frontier, rng):
    """Push, pop, prune and pop again; returns everything popped."""
    out = []
    for _ in range(3):
        frontier.push(*_nodes(rng, 500))
        out.append(frontier.pop_best(77))
    frontier.prune(1.2)
    out.append(frontier.pop_best(10_000))
    assert len(frontier) == 0 and frontier.min_lb() == float("inf")
    return out


@pytest.mark.parametrize("kind", ["NativeFrontier", "PyFrontier"])
def test_frontier_pops_like_jax(kind):
    got = _drive(getattr(tfrontier, kind)(8), np.random.default_rng(5))
    ref = _drive(getattr(jfrontier, kind)(8), np.random.default_rng(5))
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def test_py_frontier_pops_best_first():
    f = tfrontier.PyFrontier(8)
    pay, lb, ub = _nodes(np.random.default_rng(6), 300)
    f.push(pay, lb, ub)
    _, plb, pub = f.pop_best(300)
    order = np.lexsort((ub, lb))
    np.testing.assert_array_equal(plb, lb[order])
    np.testing.assert_array_equal(pub, ub[order])


@pytest.mark.parametrize("param", ["axis_angle", "quaternion"])
def test_rotparam_and_split_match_jax(param):
    rng = np.random.default_rng(8)
    n = 400
    span = np.float32(_PARAMS[param].root_span) / 2.0 ** rng.integers(0, 6, n)
    centers = rng.uniform(-1, 1, (n, 3)).astype(np.float32) * np.float32(_PARAMS[param].root_span)
    pay = np.concatenate([
        centers, span[:, None].astype(np.float32),
        rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        (0.5 / 2.0 ** rng.integers(0, 8, n)).astype(np.float32)[:, None],
    ], axis=1).astype(np.float32)
    tp, jp = _PARAMS[param], J_PARAMS[param]
    assert tp.root_span == jp.root_span
    np.testing.assert_array_equal(tp.rotation(pay[:, :3]), jp.rotation(pay[:, :3]))
    np.testing.assert_array_equal(tp.max_angle(pay[:, :3], pay[:, 3]),
                                  jp.max_angle(pay[:, :3], pay[:, 3]))
    np.testing.assert_array_equal(tp.valid(pay[:, :3], pay[:, 3]),
                                  jp.valid(pay[:, :3], pay[:, 3]))
    for floors in (dict(), dict(rot_floor=0.05, trans_floor=0.01)):
        got = classify_split(pay, 0.3, tp, beta=1.0, **floors)
        ref = jclassify(pay, 0.3, jp, beta=1.0, **floors)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_readers_match_jax(tmp_path):
    np.testing.assert_array_equal(tio.read_ply(BUNNY), jio.read_ply(BUNNY))
    np.testing.assert_array_equal(tio.load_cloud(BUNNY, 0.05, 2.0, seed=3),
                                  jio.load_cloud(BUNNY, 0.05, 2.0, seed=3))
    pts = np.random.default_rng(9).normal(size=(257, 3)).astype(np.float32)
    for ext, write in ((".ply", tio.write_ply), (".txt", tio.write_txt)):
        path = str(tmp_path / f"cloud{ext}")
        write(path, pts)
        np.testing.assert_array_equal(tio.load_cloud(path), jio.load_cloud(path))
        np.testing.assert_allclose(tio.load_cloud(path), pts, rtol=1e-6, atol=1e-6)


ISOLATION = r"""
import pkgutil, runpy, sys
sys.modules["jax"] = None          # any import of them now raises ImportError
sys.modules["goicp_tpu"] = None
import goicp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(goicp_tpu_torch.__path__, "goicp_tpu_torch.")
         if m.name != "goicp_tpu_torch.__main__"]
for name in names:
    __import__(name)
assert {"goicp_tpu_torch.cli", "goicp_tpu_torch.viz", "goicp_tpu_torch.nn.grid",
        "goicp_tpu_torch.geo.normals", "goicp_tpu_torch.core.config",
        "goicp_tpu_torch.io.writer", "goicp_tpu_torch.bnb.fullcert",
        "goicp_tpu_torch.bnb.nested", "goicp_tpu_torch.bnb.device_inner"} <= set(names), names
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "goicp_tpu"))
assert not [m for m in leaked if sys.modules[m] is not None], leaked
print("imported", len(names))
sys.argv = ["goicp_tpu_torch", "--help"]
runpy.run_module("goicp_tpu_torch", run_name="__main__")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (the CLI, viz, full-cloud certification and
    the nested engine included) imports in a
    process where ``jax`` and ``goicp_tpu`` cannot be imported, and
    ``python -m goicp_tpu_torch --help`` runs there."""
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, "-c", ISOLATION], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout and "--device" in out.stdout
