"""Target-resident registration service on an NVIDIA GPU — the serving
surface of the port (``goicp_tpu/serve.py``).

The reference binary registers exactly one (source, target) pair per process
launch (``src/main.cpp:14-33``: argv[1] TOML, one solve, exit).  Production
re-localization / scan-matching workloads answer MANY queries against one
resident model.  The service keeps everything expensive resident between
queries:

- the **target cloud** and its **distance grid** are built once on the
  card (:class:`RegistrationService`; the per-solver reuse hook is
  ``make_solver(..., grid=...)``), with the target normals and the
  tracking path's ICP closures;
- **micro-batching**: concurrent queries drain into one lockstep Go-ICP
  batch (``multipair_lockstep``, the shared target): each round evaluates
  every live query's bounds (one K4 launch a query) and refines all their
  candidates in one batched ICP (one K1 launch an iteration).

Protocol: line-delimited JSON on stdio or TCP (``python -m goicp_tpu_torch
serve target.ply --port 7345``).  With ``--auth-token`` (or ``$GOICP_AUTH_TOKEN``)
each TCP connection first sends ``{"auth": "<token>"}``; then one request
per line:

    {"id": 1, "source": "scan.ply", "subsample": 0.5}
    {"id": 2, "points": [[x, y, z], ...]}
    {"id": 3, "points": [...], "init": {"R": [[..]x3], "t": [..]}}
                                       # re-localization prior: pinned as a
                                       # multistart seed (still optimal)
    {"id": 4, "points": [...], "mode": "icp", "init": {...}}
                                       # tracking path: local ICP only
    {"id": 5, "points": [...], "mode": "icp", "init": {...},
     "escalate_mse": 1e-3}             # tracking with loss escalation: if
                                       # the refine lands above that mse the
                                       # query re-queues into the certified
                                       # goicp lane ("escalated": true)
    {"batch": [{...}, {...}]}          # explicit batch (icp-mode items share
                                       # one batched refine; goicp items one
                                       # lockstep BnB)
    {"cmd": "info"} | {"cmd": "shutdown"}

Response per request (same order; ``id`` echoed):

    {"id": 1, "ok": true, "R": [[...]x3], "t": [...], "mse": ..,
     "sse": .., "converged": true, "gap": .., "nodes": .., "wall_s": ..}

The implementation lives in the :mod:`goicp_tpu_torch.serving` package
(state / protocol / tcp / cli); this module is the public import path.
"""

from goicp_tpu_torch.serving import (  # noqa: F401  (re-export surface)
    Batcher,
    MultiTargetService,
    RegistrationService,
    handle_request,
    main,
    serve_stdio,
    serve_tcp,
)
from goicp_tpu_torch.serving.protocol import (  # noqa: F401  (test/tool hooks)
    _error_json,
    _load_query_source,
    _mode,
    _overrides,
    _parse_init,
    _result_json,
    _validate_keys,
)
from goicp_tpu_torch.serving.service import _PARAM_KEYS, _QUERY_KEYS  # noqa: F401
from goicp_tpu_torch.serving.tcp import _Pending  # noqa: F401

__all__ = [
    "Batcher",
    "MultiTargetService",
    "RegistrationService",
    "handle_request",
    "main",
    "serve_stdio",
    "serve_tcp",
]

if __name__ == "__main__":
    raise SystemExit(main())
