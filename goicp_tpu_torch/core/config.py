"""TOML scenario configuration (a copy of the JAX package's
``core/config.py``: standard library only, same schema and defaults).

Schema-compatible with the reference's ``Config`` (``src/common.h:133-176``,
``src/common.cpp:11-77``) — the reference's scenario TOMLs and the repo's
``scenarios/*.toml`` parse unchanged.  Differences (all deliberate):

- ``[params.rotation]`` / ``[params.translation]`` (incl. ``search_depth``)
  appear in the reference TOMLs and struct but are *never parsed*
  (``common.cpp:20-77``); here they are parsed and honored.
- ``io.output`` / ``io.visualization`` are parsed but never consumed by the
  reference (no result writer exists); here they are written
  (``goicp_tpu_torch.io.writer``).
- ``trim`` is parsed but never wired in the reference (``jly_goicp.cpp:62``
  hardcodes ``doTrim=true`` with ``trimFraction=0`` — an effective no-op);
  here ``trim`` + ``trim_fraction`` control real trimmed bounds.
- a ``[tpu]`` section adds framework knobs (grid resolution, batch widths,
  mesh shape) with defaults chosen so reference TOMLs need no edits.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import tomllib
from typing import Optional


class Mode(enum.IntEnum):
    """Run modes, numerically identical to ``src/common.h:7-11``."""

    ICP_CPU = 0        # reference: per-frame ICP on CPU
    ICP_GPU = 1        # reference: per-frame ICP, CUDA → here: jitted exact-NN ICP
    ICP_KDTREE_GPU = 2 # reference: flattened k-d tree ICP → here: grid-NN ICP
    GOICP_CPU = 3      # reference: jly Go-ICP on a worker thread → here: axis-angle BnB
    GOICP_GPU = 4      # reference: FastGoICP CUDA BnB → here: quaternion-cube BnB


@dataclasses.dataclass
class AxisBounds:
    """Per-axis search bounds (``src/common.h:150-169``)."""

    xmin: float = -1.0
    xmax: float = 1.0
    ymin: float = -1.0
    ymax: float = 1.0
    zmin: float = -1.0
    zmax: float = 1.0
    search_depth: int = 12

    @property
    def center(self):
        return (
            (self.xmin + self.xmax) / 2,
            (self.ymin + self.ymax) / 2,
            (self.zmin + self.zmax) / 2,
        )

    @property
    def span(self) -> float:
        """Half edge length of the bounding cube (max over axes)."""
        return max(
            self.xmax - self.xmin, self.ymax - self.ymin, self.zmax - self.zmin
        ) / 2.0


@dataclasses.dataclass
class IOConfig:
    target: str = ""          # target (model/reference) cloud path
    source: str = ""          # source (data) cloud path
    output: str = "output.toml"
    visualization: str = "viz.ply"


@dataclasses.dataclass
class VizConfig:
    phi: float = 0.0
    theta: float = 0.0
    spin_after_finish: bool = False


@dataclasses.dataclass
class TpuConfig:
    """Framework-specific knobs (no reference counterpart)."""

    grid_resolution: int = 256      # distance-field resolution (ref LUT n=300, registration.hpp:69)
    grid_expand: float = 1.5        # domain expansion around target bbox (ref dt.expandFactor=2, jly_goicp.cpp:57)
    grid_method: str = "edt"        # "edt" (≙ jly DT3D) | "brute" (≙ buildLUTKernel)
    rot_batch: int = 16             # rotation nodes expanded per outer round (ref: 1)
    se3_pop: int = 0                # SE(3) nodes per fused round (0 = auto)
    engine: str = "se3"             # "se3" (flat product BnB) | "nested" (ref shape)
    bound_backend: str = "auto"     # "exact" | "grid" | "auto" (size cutoff)
    conservative: bool = False      # True: certified lbs (grid/f32 slack deducted)
    checkpoint_path: str = ""       # frontier+incumbent snapshot file ("" = off)
    checkpoint_every: int = 50      # rounds between snapshots
    min_rot_span: float = 0.0      # 0 = no floor; ε-pruning self-limits depth
    min_trans_span: float = 0.0    # 0 = no floor (ref 0.12, fgoicp.cpp:160)
    icp_max_iter: int = 128         # ref: 1000 initial / 500 refine (fgoicp.cpp:11,77)
    icp_rel_tol: float = 1e-3       # ref convergence_threshold (fgoicp.cpp:11)
    icp_metric: str = "point"       # "point" (ref parity) | "plane" (point-to-
                                    # plane upgrade; the reference has no
                                    # normals anywhere — icp3d.cu:140-172)
    normals_k: int = 16             # kNN size for PCA normals (plane metric)
    rotation_param: str = "axis_angle"  # "axis_angle" (jly, uniform bound) | "quaternion" (fgoicp)
    lookup: str = "nearest"         # "nearest" (ref CPU DT) | "trilinear" (ref tex3D)
    seed: int = 0                   # subsampling RNG seed (ref uses random_device)
    max_wall_s: float = 300.0       # BnB wall-clock budget per scenario
    mesh_points: int = 1            # device-mesh extent over the point axis
    mesh_cubes: int = 0             # device-mesh extent over the cube axis
                                    # (0 = all visible devices; 1 = single-chip)
    icp_refine_factor: float = 2.0  # run ICP when ub < factor*best (ref fgoicp.cpp:75)
    snapshot_every_s: float = 0.0   # live PLY snapshots while solving, at most
                                    # one per this many seconds (0 = off) — the
                                    # headless render loop (goicp_kernel.cu:152-206)
    full_cert: bool = False         # drive the FULL-cloud certificate to ε
                                    # by adaptive subset refinement
                                    # (bnb.fullcert.register_full_cert);
                                    # off = one bound_points-capped solve
                                    # with the plain gap transfer
    full_cert_mse: float = 0.0      # full-cloud per-point gap target
                                    # (0 = the scenario's mse_threshold)
    snapshot_png: bool = False      # also render a PNG per snapshot
    snapshot_html: bool = True      # maintain snapshots/live.html — a self-
                                    # reloading live view of the running solve
                                    # (drops the reload on finish)


@dataclasses.dataclass
class Config:
    mode: Mode = Mode.GOICP_GPU
    trim: bool = False
    trim_fraction: float = 0.0      # ref: GoICP::trimFraction (jly_goicp.cpp:55), always 0
    subsample: float = 1.0
    mse_threshold: float = 1e-3
    resize: float = 1.0
    io: IOConfig = dataclasses.field(default_factory=IOConfig)
    viz: VizConfig = dataclasses.field(default_factory=VizConfig)
    rotation: AxisBounds = dataclasses.field(
        default_factory=lambda: AxisBounds(-180, 180, -180, 180, -180, 180)
    )
    translation: AxisBounds = dataclasses.field(default_factory=AxisBounds)
    tpu: TpuConfig = dataclasses.field(default_factory=TpuConfig)
    # Directory against which relative io paths are resolved (the TOML's dir,
    # mirroring the reference's run-from-bin/ relative paths, README.md:39).
    base_dir: str = "."

    @staticmethod
    def from_toml(path: str) -> "Config":
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        return Config.from_dict(doc, base_dir=os.path.dirname(os.path.abspath(path)))

    @staticmethod
    def from_dict(doc: dict, base_dir: str = ".") -> "Config":
        cfg = Config(base_dir=base_dir)
        io = doc.get("io", {})
        cfg.io = IOConfig(
            target=io.get("target", ""),
            source=io.get("source", ""),
            output=io.get("output", "output.toml"),
            visualization=io.get("visualization", "viz.ply"),
        )
        p = doc.get("params", {})
        cfg.mode = Mode(int(p.get("mode", 4)))
        cfg.trim = bool(p.get("trim", False))
        cfg.trim_fraction = float(p.get("trim_fraction", 0.0))
        cfg.subsample = float(p.get("subsample", 1.0))
        cfg.mse_threshold = float(p.get("mse_threshold", 1e-3))
        cfg.resize = float(p.get("resize", 1.0))
        for name in ("rotation", "translation"):
            sec = p.get(name)
            if sec:
                ab = AxisBounds(
                    xmin=float(sec.get("xmin", -1.0)),
                    xmax=float(sec.get("xmax", 1.0)),
                    ymin=float(sec.get("ymin", -1.0)),
                    ymax=float(sec.get("ymax", 1.0)),
                    zmin=float(sec.get("zmin", -1.0)),
                    zmax=float(sec.get("zmax", 1.0)),
                    search_depth=int(sec.get("search_depth", 12)),
                )
                setattr(cfg, name, ab)
        v = doc.get("visualization", {})
        cfg.viz = VizConfig(
            phi=float(v.get("phi", 0.0)),
            theta=float(v.get("theta", 0.0)),
            spin_after_finish=bool(v.get("spin_after_finish", False)),
        )
        t = doc.get("tpu", {})
        tpu = TpuConfig()
        for f in dataclasses.fields(TpuConfig):
            if f.name in t:
                setattr(tpu, f.name, type(getattr(tpu, f.name))(t[f.name]))
        cfg.tpu = tpu
        return cfg

    def resolve(self, path: str) -> str:
        """Resolve an io path relative to the TOML's directory."""
        if not path or os.path.isabs(path):
            return path
        cand = os.path.normpath(os.path.join(self.base_dir, path))
        return cand

    @property
    def effective_trim_fraction(self) -> float:
        return self.trim_fraction if self.trim else 0.0
