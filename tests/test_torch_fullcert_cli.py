"""The port's full-cloud certification against the JAX package, continued
from ``tests/test_torch_fullcert.py``: the trimmed case of
``tests/test_fullcert.py`` with its oracle, and the CLI's ``[tpu]
full_cert``.

Tolerances: refinements, subset sizes, rounds and node counts equal;
``gap_full`` and the sse to rtol 1e-5 (the ICP's f32 poses, see ROADMAP
queue 3) and atol 1e-9 (a noise-free pair ends at an sse of f32 rounding,
~1e-14).  The trimmed case is pinned to ``bound_backend="exact"``, as the
JAX case is; the CLI case to a grid (below).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.bnb import BnbParams as JBnbParams  # noqa: E402
from goicp_tpu.bnb import register_full_cert as jfullcert  # noqa: E402
from goicp_tpu_torch.bnb import BnbParams, register_full_cert  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402
from tests.oracle_goicp import oracle_min_sse  # noqa: E402

torch.set_num_threads(1)


def _both(src, tgt, jp: JBnbParams, **kw):
    rj = jfullcert(src, tgt, jp, **kw)
    rt = register_full_cert(src, tgt, BnbParams.from_dict(dataclasses.asdict(jp)),
                            device="cpu", **kw)
    for k in ("fullcert_refinements", "fullcert_subset"):
        assert rt.metrics.counters[k] == rj.metrics.counters[k], k
    assert rt.rounds == rj.rounds and rt.rot_nodes == rj.rot_nodes
    assert rt.converged == rj.converged
    np.testing.assert_allclose(rt.sse, rj.sse, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rt.sse_full, rj.sse_full, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rt.gap_full, rj.gap_full, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(rt.transform.R, np.asarray(rj.transform.R), atol=1e-4)
    return rj, rt


def test_fullcert_trimmed_certificate_vs_oracle():
    rng2 = np.random.default_rng(5)
    src = (rng2.random((26, 3)).astype(np.float32) - 0.5) * 0.6
    Q = random_rotation(rng2)
    trim = 0.25
    keep = rng2.choice(26, 20, replace=False)
    tgt = ((src[keep] @ Q.T) + np.float32([0.08, -0.05, 0.1])).astype(np.float32)
    mse = 2e-4
    jp = JBnbParams(mse_threshold=mse, trim_fraction=trim, trans_span=0.5, se3_pop=48,
                    max_rounds=2000, init_multistart=4, bound_points=16,
                    bound_backend="exact", grid_resolution=24)
    _, rt = _both(src, tgt, jp, max_refinements=3)
    h_f = max(1, int(round(src.shape[0] * (1.0 - trim))))
    o_sse, _, _ = oracle_min_sse(src, tgt, trans_span=0.5, mse_threshold=mse,
                                 trim_fraction=trim)
    assert o_sse >= rt.sse_full - rt.gap_full - 2 * mse * h_f


def test_cli_mode4_full_cert_matches_jax(tmp_path, monkeypatch):
    """``[tpu] full_cert = true`` in mode 4 on a 120-point pair, with the
    solves capped at 40 points and 5 rounds (neither is a TOML key): both
    CLIs grow the subset alike and report the same full-cloud gap.  The
    bounds come from a 32³ grid with the nearest lookup, which every
    refinement reuses."""
    import goicp_tpu.cli as jcli
    from goicp_tpu_torch import cli
    from goicp_tpu_torch.io import write_ply, write_txt

    rng = np.random.default_rng(1234)
    src = (rng.random((120, 3)).astype(np.float32) - 0.5) * 0.6
    tgt = (src @ random_rotation(rng).T + np.float32([0.1, -0.08, 0.12])
           + rng.normal(0, 0.005, src.shape)).astype(np.float32)
    write_txt(str(tmp_path / "source.txt"), src)
    write_ply(str(tmp_path / "target.ply"), tgt)
    (tmp_path / "s.toml").write_text("""
[io]
target = "target.ply"
source = "source.txt"
output = "output.toml"
visualization = "viz.ply"

[params]
mode = 4
subsample = 1.0
mse_threshold = 2e-5
resize = 1.0

[params.translation]
xmin = -0.5
xmax = 0.5
ymin = -0.5
ymax = 0.5
zmin = -0.5
zmax = 0.5

[tpu]
bound_backend = "grid"
grid_resolution = 32
lookup = "nearest"
full_cert = true
full_cert_mse = 2e-5
""")
    for mod in (jcli, cli):
        orig = mod.bnb_params_from_config
        monkeypatch.setattr(mod, "bnb_params_from_config", lambda cfg, _o=orig: dataclasses.replace(
            _o(cfg), bound_points=40, max_rounds=5))
    oj = jcli.run_scenario(str(tmp_path / "s.toml"), str(tmp_path / "jax"))
    ot = cli.run_scenario(str(tmp_path / "s.toml"), str(tmp_path / "torch"), device="cpu")
    for k in ("converged", "icp_iters"):
        assert ot[k] == oj[k], k
    for k in ("count/fullcert_subset", "count/fullcert_refinements"):
        assert ot["metrics"][k] == oj["metrics"][k], k
    # the center-aware rotation bound (tight_rot_bound) differs from the
    # jitted JAX one in last bits, which moves a few nodes from the fifth
    # round of a solve on (ROADMAP queue 3)
    np.testing.assert_allclose(ot["rot_nodes"], oj["rot_nodes"], rtol=1e-2)
    assert ot["metrics"]["count/fullcert_subset"] > 40
    np.testing.assert_allclose(ot["gap_full"], oj["gap_full"], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(ot["sse"], oj["sse"], rtol=1e-5)
