"""Solver configuration (:class:`BnbParams`), result record
(:class:`GoIcpResult`) and the auto-backend rule — port of the JAX package's
``bnb/params.py``.  The fields and defaults are the JAX package's, so one
parameter dict drives both packages (:meth:`BnbParams.from_dict`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from goicp_tpu_torch.core.metrics import Metrics
from goicp_tpu_torch.core.types import RigidTransform


@dataclasses.dataclass
class BnbParams:
    mse_threshold: float = 1e-3      # ≙ config mse_threshold (common.cpp:34)
    trim_fraction: float = 0.0
    rotation_param: str = "axis_angle"
                                     # axis-angle (jly) default: the exponential
                                     # map gives the UNIFORM bound angle≤√3·span
                                     # (jly_goicp.cpp:153-157); the quaternion
                                     # cube's uncertainty blows up near the
                                     # |v|=1 boundary (w = sqrt(1-r²) varies
                                     # unboundedly fast), stalling convergence
                                     # for rotations near 180°
    lookup: str = "nearest"       # ≙ jly dt.Distance (no interp); half the
                                     # slack of trilinear and 1 gather not 8
    grid_resolution: int = 256
    grid_expand: float = 1.5         # tighter than jly's 2.0: smaller cells
                                     # (outside queries use escape bounds)
    grid_method: str = "edt"         # "edt" (O(n^4), ≙ jly DT3D) | "brute"
                                     # (exact, O(n^3·Nt), ≙ buildLUTKernel)
    rot_pop: int = 16                # rot cubes popped per outer round (ref: 1)
    min_rot_span: float = 0.0        # 0 ⇒ no depth floor: ε-pruning is
                                     # self-limiting (a node containing the
                                     # optimum splits until its lb reaches
                                     # best−thresh, then prunes) — exactly
                                     # jly's unbounded-depth semantics.
                                     # fgoicp's 0.1 floor (fgoicp.cpp:53)
                                     # only "works" because its bounds are
                                     # invalidly tight (registration.cu:39-43)
    min_trans_span: float = 0.0      # 0 ⇒ ε-rule + inner_levels only
                                     # (fgoicp.cpp:160 uses 0.12 absolute)
    inner_levels: int = 7            # max inner subdivision depth
    inner_cap: int = 32              # translation frontier slots per rot cube
    point_tile: int = 128            # point-axis tile in the device inner BnB
    bound_backend: str = "auto"      # "mxu" (K4/K3 + epilogue; K2 on
                                     # untrimmed R-rounds while screen) |
                                     # "screen" (K2, or K5/K6 when trimmed) |
                                     # "exact" (expansion over target tiles) |
                                     # "grid" (distance-grid lookups) |
                                     # "auto": mxu up to mxu_max targets,
                                     # grid above
    bound_points: int = 8192         # BnB solves on at most this many source
                                     # points (deterministic subset); the
                                     # final pose is ICP-polished on the full
                                     # cloud.  Same spirit as the reference's
                                     # own subsample knob (common.cpp:110-132)
                                     # — the ε-certificate applies to the
                                     # solve subset.
    exact_max: int = 512             # auto-backend target-size cutoff: exact
                                     # bounds lose to O(1) grid lookups once
                                     # node_count×N×Nt dominates (the same
                                     # economics as jly's DT, SURVEY §2 C11)
    mxu_max: int = 32768             # auto-backend cutoff for the fused
                                     # kernels (the JAX package's value, not
                                     # yet derived from H100 measurements)
    icp_exact_max: int = 16384       # use exact-NN ICP (true SSE) below this
    init_multistart: int = 64        # batched multi-start ICP seeds (ref: 1,
                                     # identity only, fgoicp.cpp:11) — a
                                     # batching win; BnB still certifies
    init_coarse_n: int = 512         # coarse-to-fine multistart: all seeds
                                     # first converge on this many points per
                                     # cloud (deterministic subset), only the
                                     # refine_top_k best (+ identity/caller
                                     # seeds) run at full resolution.  0 = off
    refine_top_k: int = 8            # ICP-refine up to k best-ub cands/round
    refine_max_iter: int = 32        # iteration cap for the IN-ROUND refine
                                     # tail only (initial multistart and the
                                     # final full polish keep icp_max_iter).
                                     # In-round refines exist to discover
                                     # incumbents, not to polish
    trans_span: float = 0.5          # root translation half-side (jly_goicp.cpp:50-53)
    trans_center: tuple = (0.0, 0.0, 0.0)
    icp_refine_factor: float = 2.0   # ≙ fgoicp.cpp:75
    icp_max_iter: int = 100
    icp_rel_tol: float = 1e-4
    icp_metric: str = "point"        # "point" (ref parity, icp3d.cu:140-172)
                                     # | "plane" (point-to-plane, on PCA
                                     # target normals)
    normals_k: int = 16              # kNN size for PCA target normals
    icp_cap: int = 64                # max candidates refined per batched ICP
    conservative: bool = False       # True: deflate lbs by the grid
                                     # discretization error → rigorous
                                     # ε-optimality certificates (no
                                     # reference counterpart). False
                                     # (default): reference parity — jly and
                                     # fgoicp both ignore the ~cell-sized DT
                                     # error (jly_3ddt.cpp:925 comment), so
                                     # their ε-guarantee is modulo grid
                                     # accuracy; matching that costs nothing
                                     # in practice and prunes ~2-5× harder
    max_rounds: int = 10_000
    max_wall_s: float = 300.0        # wall-clock budget for the BnB phase;
                                     # on expiry the incumbent is returned
                                     # with converged=False and the true gap
                                     # (the reference can only be ^C'd)
    engine: str = "se3"              # "se3" (flat product-space BnB)
                                     # | "nested" (≙ the reference's outer
                                     # SO(3) / inner R³ structure)
    se3_pop: int = 0                 # SE(3) nodes popped per round (×8
                                     # children); 0 = auto-scale the round's
                                     # point-node pair budget
    pipeline_depth: int = 3          # fused rounds in flight (stale-incumbent
                                     # tolerance buys latency hiding)
    screen: bool = True              # progressive in-kernel screening: skip
                                     # a node's remaining point-blocks once
                                     # its partial lb crosses best−ε (valid:
                                     # partial sums of nonneg terms are lbs;
                                     # ≙ jly's lb-prune, jly_goicp.cpp:554)
    tight_rot_bound: bool = True     # SE(3) engine, axis-angle: use the
                                     # center-aware cube angle bound
                                     # (geo.rotation.axis_angle_cube_max_angle,
                                     # strictly tighter than jly's √3·σ off-
                                     # origin → smaller certification tree);
                                     # computed on device inside each round
    split_beta: float = 1.0          # split-rule bias: r-split only when
                                     # rot radius >= beta * trans radius;
                                     # >1 favors t-splits (grouped kernel
                                     # evaluates them ~3x cheaper per node)
    checkpoint_path: Optional[str] = None   # frontier+incumbent snapshots;
                                     # restart-based recovery (SURVEY §5:
                                     # the reference has none)
    checkpoint_every: int = 50       # rounds between snapshots
    mesh_cubes: int = 1              # devices over the node axis (SE(3)
                                     # engine shards each round's job batch;
                                     # 0 = every visible device)
    mesh_points: int = 1             # devices over the point axis (psum-
                                     # reduced bound sums; composes with
                                     # mesh_cubes as a 2-D mesh)
    mh_exchange_every: int = 4       # multi-process lockstep iterations
                                     # between incumbent exchanges
    escalate_mse: Optional[float] = None
                                     # serving-only tracking-loss threshold
                                     # (the solver ignores it)

    @classmethod
    def from_dict(cls, d: dict) -> "BnbParams":
        """Build from ``dataclasses.asdict`` of a JAX ``BnbParams`` (or any
        dict of these fields); unknown keys raise."""
        names = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - names
        if extra:
            raise TypeError(f"unknown BnbParams fields: {sorted(extra)}")
        d = dict(d)
        if "trans_center" in d:
            d["trans_center"] = tuple(d["trans_center"])
        return cls(**d)


@dataclasses.dataclass
class GoIcpResult:
    transform: RigidTransform        # numpy R [3,3], t [3]
    sse: float                       # final (trimmed) SSE, grid-verified
    mse: float
    converged: bool
    gap: float                       # best_sse − global min lb at exit
    rot_nodes: int
    trans_nodes: int
    icp_iters: int
    rounds: int
    wall_s: float
    metrics: Metrics
    # FULL-CLOUD certificate transfer (bound_points-capped solves only;
    # None when the BnB solved the whole cloud).  ``sse``/``mse``/``gap``
    # above are statements about the solve SUBSET; these carry the same
    # statement to the full source cloud (VERDICT r3 weak #7): the subset
    # is a SUBSET of the full cloud and every per-point term is
    # nonnegative, so for every pose sse_full(T) ≥ sse_sub(T) ≥ the
    # certified subset lower bound — hence
    #   full optimum ≥ best_sub − max(gap, ε)   and
    #   gap_full = sse_full(best) − (best_sub − max(gap, ε))
    # is a valid full-cloud optimality gap.  (The covering-radius
    # deflation d(Tp) ≥ d(Ts(p)) − ‖p−s(p)‖ cannot beat this: each subset
    # point assigns itself with radius 0, so the deflated sum is already
    # ≥ sse_sub.)  Trimmed solves keep gap_full=None: the h_full-smallest
    # full terms need not contain the h_sub-smallest subset terms, so the
    # subset-⊆-full inequality fails between TRIMMED sums.
    sse_full: Optional[float] = None   # (trimmed) SSE of the FULL cloud
    mse_full: Optional[float] = None   # sse_full / h_full
    gap_full: Optional[float] = None   # full-cloud optimality gap
    escalated: bool = False            # serving: tracking query diverged and
                                       # was auto-escalated to this certified
                                       # goicp solve (serve docs)


def auto_backend(params: BnbParams, n_tgt: int) -> str:
    """The "auto" bound backend on this port: the fused kernels ("mxu") up
    to ``mxu_max`` targets, the grid backend above (``params.py:228``).  The
    JAX package's rule is the same on a TPU; on its CPU it picks "exact"
    up to ``exact_max``, a rate this port's CUDA kernels replace."""
    return "mxu" if n_tgt <= params.mxu_max else "grid"
