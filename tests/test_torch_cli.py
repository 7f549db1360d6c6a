"""The port's CLI against the JAX package's on the same inputs: the TOML
config, the result TOML writer, ``run_scenario`` in all five modes (and the
plane metric) on the CPU path, ``main``, and the options the port refuses.

The scene is ``tests/test_cli.py``'s 300-point synthetic pair
(``default_rng(1234)``, a random rotation and t = (0.1, −0.08, 0.12)) with
N(0, 0.005) noise on the target: a noise-free pair ends at an sse of
~1e-10, which is f32 rounding that no tolerance compares.  Tolerances: poses
to 1e-4, sse to rtol 1e-5; converged, ICP iterations, node counts, the
artifact file names and the trajectory rows equal.
"""

import dataclasses
import glob
import os
import tomllib

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from goicp_tpu.cli import run_scenario as jrun  # noqa: E402
from goicp_tpu.core.config import Config as JConfig  # noqa: E402
from goicp_tpu.io.writer import write_result_toml as jwrite  # noqa: E402
from goicp_tpu_torch import cli  # noqa: E402
from goicp_tpu_torch.core.config import Config  # noqa: E402
from goicp_tpu_torch.io import read_ply, write_ply, write_result_toml, write_txt  # noqa: E402
from tests.conftest import random_rotation  # noqa: E402

torch.set_num_threads(1)

SCENARIOS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "scenarios",
                                          "*.toml")))


@pytest.mark.parametrize("path", SCENARIOS, ids=os.path.basename)
def test_config_matches_jax(path):
    """Every in-repo scenario parses (without its data) to the same config."""
    got, ref = Config.from_toml(path), JConfig.from_toml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.effective_trim_fraction == ref.effective_trim_fraction
    assert got.resolve(got.io.source) == ref.resolve(ref.io.source)
    assert cli.bnb_params_from_config(got).trans_span == ref.translation.span


def test_write_result_toml_round_trips(tmp_path):
    R = np.asarray(random_rotation(np.random.default_rng(3)), np.float32)
    t = np.float32([0.1, -0.2, 0.3])
    kw = dict(mode=3, converged=False, rot_nodes=12, trans_nodes=34, icp_iters=5,
              wall_s=1.25, extra={"scenario": "s.toml", "n_src": 10, "gap": 0.5,
                                  "flag": True})
    write_result_toml(str(tmp_path / "t.toml"), R, t, 1e-4, 3e-3, **kw)
    jwrite(str(tmp_path / "j.toml"), R, t, 1e-4, 3e-3, **kw)
    with open(tmp_path / "t.toml", "rb") as f:
        got = tomllib.load(f)
    with open(tmp_path / "j.toml", "rb") as f:
        ref = tomllib.load(f)
    got.pop("timestamp"), ref.pop("timestamp")
    assert got == ref
    np.testing.assert_array_equal(np.float32(got["result"]["rotation"]), R)
    np.testing.assert_array_equal(np.float32(got["result"]["translation"]), t)
    assert got["extra"]["flag"] is True and got["stats"]["rot_nodes"] == 12


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(1234)
    src = (rng.random((300, 3)).astype(np.float32) - 0.5) * 0.6
    R = random_rotation(rng)
    t = np.array([0.1, -0.08, 0.12], np.float32)
    tgt = (src @ R.T + t + rng.normal(0, 0.005, src.shape)).astype(np.float32)
    write_txt(str(d / "source.txt"), src)
    write_ply(str(d / "target.ply"), tgt)

    def cfg(mode, extra=""):
        path = d / f"scene_m{mode}_{abs(hash(extra))}.toml"
        path.write_text(f"""
[io]
target = "target.ply"
source = "source.txt"
output = "output.toml"
visualization = "viz.ply"

[params]
mode = {mode}
subsample = 1.0
mse_threshold = 1e-4
resize = 1.0

[params.translation]
xmin = -0.5
xmax = 0.5
ymin = -0.5
ymax = 0.5
zmin = -0.5
zmax = 0.5

[tpu]
grid_resolution = 64
rot_batch = 2
bound_backend = "exact"
{extra}
""")
        return str(path)

    return d, cfg, src, tgt


@pytest.mark.parametrize("mode,extra", [(0, ""), (1, ""), (2, ""), (3, ""), (4, ""),
                                        (4, 'icp_metric = "plane"')],
                         ids=["m0", "m1", "m2", "m3", "m4", "m4-plane"])
def test_run_scenario_matches_jax(scene, mode, extra):
    d, cfg, src, tgt = scene
    path = cfg(mode, extra)
    tag = f"{mode}{'p' if extra else ''}"
    oj = jrun(path, str(d / f"jax{tag}"))
    ot = cli.run_scenario(path, str(d / f"torch{tag}"), device="cpu")
    np.testing.assert_allclose(ot["R"], oj["R"], atol=1e-4)
    np.testing.assert_allclose(ot["t"], oj["t"], atol=1e-4)
    np.testing.assert_allclose(ot["sse"], oj["sse"], rtol=1e-5)
    for k in ("converged", "icp_iters", "rot_nodes", "trans_nodes", "n_src", "n_tgt"):
        assert ot[k] == oj[k], k
    dj, dt = d / f"jax{tag}", d / f"torch{tag}"
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    with open(ot["output_toml"], "rb") as f:
        doc = tomllib.load(f)
    assert doc["mode"] == mode and doc["stats"]["icp_iters"] == oj["icp_iters"]
    np.testing.assert_allclose(doc["result"]["rotation"], ot["R"], atol=1e-7)
    assert read_ply(ot["viz_ply"]).shape[0] == src.shape[0] + tgt.shape[0]
    rows = (dt / "trajectory.csv").read_text().splitlines()
    assert len(rows) == len((dj / "trajectory.csv").read_text().splitlines()) > 1
    if mode >= 3:
        assert ot["converged"] and (dt / "metrics.json").exists()


def test_main_on_the_cpu_with_a_profile(scene, capsys):
    d, cfg, _, _ = scene
    out = d / "main_out"
    rc = cli.main([cfg(1), "--output", str(out), "--device", "cpu",
                   "--profile", str(d / "prof")])
    assert rc in (0, 1)
    assert "mse=" in capsys.readouterr().out
    assert (out / "output.toml").exists() and (d / "prof" / "trace.json").exists()


@pytest.mark.parametrize("extra,arg", [
    ("full_cert = true\nfull_cert_mse = 1e-3", None),
    ('engine = "nested"', None),
    ("mesh_cubes = 2", None),
    ('checkpoint_path = "{ck}"', None),
    ("", "{ck}"),
], ids=["full_cert", "nested", "mesh", "checkpoint_path", "--checkpoint"])
def test_unported_options_refused_before_solving(scene, extra, arg, monkeypatch):
    """No option is refused any more: ``full_cert``, the nested engine, a
    device mesh (``mesh_cubes = 2``: two CPU shards) and the checkpoint
    (from the TOML or ``--checkpoint``) solve on the CPU path, and the
    checkpoint is written.  (The full-cloud target is 10× the threshold, so
    the whole-cloud solve keeps its threshold: at the default target it
    would halve it.)"""
    d, cfg, _, _ = scene
    ck = str(d / f"ck_{abs(hash(extra + str(arg)))}.npz")
    extra, arg = extra.replace("{ck}", ck), arg and arg.replace("{ck}", ck)
    out = cli.run_scenario(cfg(4, extra + "\ncheckpoint_every = 1"), str(d / "in_slice"),
                           checkpoint=arg, device="cpu")
    assert np.isfinite(out["sse"]) and out["converged"]
    if "full_cert" in extra:
        assert out["gap_full"] is not None and out["sse_full"] == out["sse"]
    if "nested" in extra:
        assert out["metrics"]["count/rot_nodes"] == out["rot_nodes"]
    if "checkpoint" in extra or arg:
        assert os.path.exists(ck) or out["rot_nodes"] == 0


def test_default_device_is_cuda(scene, monkeypatch):
    _, cfg, _, _ = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run_scenario(cfg(1))
