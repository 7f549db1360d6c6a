"""Wire protocol: line-delimited JSON requests → response records (port of
the JAX package's ``serving/protocol.py``).

Request decoding and encoding plus the single-threaded dispatch
(:func:`handle_request`, :func:`serve_stdio`).  The resident state lives in
:mod:`goicp_tpu_torch.serving.service`; the TCP transport with
cross-connection micro-batching in :mod:`goicp_tpu_torch.serving.tcp`.
Request and response shapes are documented on :mod:`goicp_tpu_torch.serve`.
"""

from __future__ import annotations

import json
from typing import IO, Optional

import numpy as np

from goicp_tpu_torch.bnb import GoIcpResult
from goicp_tpu_torch.core.types import RigidTransform
from goicp_tpu_torch.io import load_cloud
from goicp_tpu_torch.serving.service import (
    _PARAM_KEYS,
    _QUERY_KEYS,
    RegistrationService,
)


def _validate_keys(req: dict):
    unknown = set(req) - set(_QUERY_KEYS) - set(_PARAM_KEYS)
    if unknown:
        raise ValueError(f"unknown request key(s): {sorted(unknown)}")


def _load_query_source(
    req: dict,
    source_root: Optional[str] = None,
    max_points: Optional[int] = None,
) -> np.ndarray:
    if "points" in req:
        if max_points is not None and len(req["points"]) > max_points:
            # reject BEFORE materializing the array (bounded device/host
            # allocation under client control)
            raise ValueError(
                f"query has {len(req['points'])} points; this server caps "
                f"queries at {max_points} (operator: --max-points)"
            )
        pts = np.asarray(req["points"], np.float32)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"points must be [N,3], got {pts.shape}")
        return pts * float(req.get("resize", 1.0))
    if "source" in req:
        import os

        path = str(req["source"])
        if source_root == "":
            raise ValueError(
                "filesystem 'source' queries are disabled on this server; "
                "send inline 'points' (operator: --source-root enables paths)"
            )
        if source_root is not None:
            root = os.path.realpath(source_root)
            real = os.path.realpath(os.path.join(root, path))
            if not (real + os.sep).startswith(root + os.sep):
                raise ValueError("source path escapes the served root")
            path = real
        return load_cloud(
            path,
            subsample=float(req.get("subsample", 1.0)),
            resize=float(req.get("resize", 1.0)),
            seed=int(req.get("seed", 0)),
        )
    raise ValueError("request needs 'source' (path) or 'points'")


def _result_json(req: dict, res: GoIcpResult) -> dict:
    out = {
        "id": req.get("id"),
        "ok": True,
        "R": np.asarray(res.transform.R, np.float64).round(9).tolist(),
        "t": np.asarray(res.transform.t, np.float64).round(9).tolist(),
        "sse": float(res.sse),
        "mse": float(res.mse),
        "converged": bool(res.converged),
        "gap": float(res.gap),
        "nodes": int(res.rot_nodes),
        "icp_iters": int(res.icp_iters),
        "wall_s": round(float(res.wall_s), 4),
    }
    if getattr(res, "escalated", False):
        # tracking query auto-escalated to a certified goicp solve
        out["escalated"] = True
    # full-cloud certificate (bound_points-capped solves only)
    for k in ("sse_full", "mse_full", "gap_full"):
        v = getattr(res, k, None)
        if v is not None:
            out[k] = float(v)
    return out


def _error_json(req, err: Exception) -> dict:
    rid = req.get("id") if isinstance(req, dict) else None
    return {"id": rid, "ok": False, "error": f"{type(err).__name__}: {err}"}


def _overrides(req: dict) -> dict:
    return {k: req[k] for k in _PARAM_KEYS if k in req}


def _parse_init(req: dict) -> Optional[RigidTransform]:
    """Optional ``"init": {"R": [[..]x3], "t": [..]}`` prior pose."""
    obj = req.get("init")
    if obj is None:
        return None
    R = np.asarray(obj["R"], np.float32)
    t = np.asarray(obj.get("t", [0.0, 0.0, 0.0]), np.float32)
    if R.shape != (3, 3) or t.shape != (3,):
        raise ValueError(f"init shapes must be R[3,3], t[3]; got {R.shape}, {t.shape}")
    if (
        not np.allclose(R @ R.T, np.eye(3), atol=1e-3)
        or abs(float(np.linalg.det(R)) - 1.0) > 1e-3
    ):
        raise ValueError("init.R is not a rotation (orthonormal, det=+1)")
    return RigidTransform(R, t)


def _mode(req: dict) -> str:
    m = req.get("mode", "goicp")
    if m not in ("goicp", "icp"):
        raise ValueError(f"mode must be 'goicp' or 'icp', got {m!r}")
    return m


def handle_request(service: RegistrationService, req: dict) -> dict | list:
    """One decoded request → one JSON-serializable response (or a list for
    ``batch`` requests).  Raises nothing: errors come back as records."""
    try:
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
        if req.get("cmd") == "info" or req.get("cmd") == "ping":
            return service.info()
        if "cmd" in req:
            raise ValueError(f"unknown cmd {req['cmd']!r}")
        if "batch" in req:
            unknown = set(req) - {"batch", "id"} - set(_PARAM_KEYS)
            if unknown:
                raise ValueError(
                    f"unknown batch-envelope key(s): {sorted(unknown)}"
                )
            subs = req["batch"]
            ov = _overrides(req)
            # Batch-level overrides apply to every item; a per-item override
            # can't join a lockstep lane (everything in a lane shares one
            # dispatch), so override-bearing items answer solo with their
            # merged overrides — the same contract as the TCP Batcher.
            # Lanes: icp-mode queries share one batched refine;
            # goicp queries — with or without an init prior (per-pair
            # multistart seeds) — share the lockstep BnB.
            out: list = [None] * len(subs)
            # lanes are (kind, target-service): a lockstep lane shares one
            # dispatch, so it must share a target too
            lanes: dict = {}
            parsed = {}
            for i, sub in enumerate(subs):
                try:
                    _validate_keys(sub)
                    svc = service.resolve(sub.get("target"))
                    src = _load_query_source(sub, svc.source_root, svc.max_points)
                    init = _parse_init(sub)
                    m = _mode(sub)
                    iov = {**ov, **_overrides(sub)}
                    parsed[i] = (svc, src, init, m, iov)
                    kind = "solo" if _overrides(sub) else m
                    lanes.setdefault((kind, id(svc)), []).append(i)
                except Exception as e:  # per-item isolation
                    out[i] = _error_json(sub, e)
            for (kind, _), idxs in lanes.items():
                svc = parsed[idxs[0]][0]
                # per-LANE isolation: a lane dispatch that raises (device
                # error, bad batch-level override) must error only its own
                # items — the response stays one record per request, in
                # order, instead of collapsing to a single error dict
                try:
                    if kind == "icp":
                        results = svc.refine_batch(
                            [parsed[i][1] for i in idxs],
                            inits=[parsed[i][2] for i in idxs],
                            **ov,
                        )
                    elif kind == "goicp":
                        results = svc.register_batch(
                            [parsed[i][1] for i in idxs],
                            inits=[parsed[i][2] for i in idxs],
                            **ov,
                        )
                    else:
                        results = []
                        for i in idxs:
                            svc_i, src, init, m, iov = parsed[i]
                            fn = (
                                svc_i.refine if m == "icp" else svc_i.register
                            )
                            try:
                                results.append(fn(src, init, **iov))
                            except Exception as e:
                                results.append(e)
                except Exception as e:
                    results = [e] * len(idxs)
                for i, res in zip(idxs, results):
                    out[i] = (
                        _error_json(subs[i], res)
                        if isinstance(res, Exception)
                        else _result_json(subs[i], res)
                    )
            return out
        _validate_keys(req)
        svc = service.resolve(req.get("target"))
        src = _load_query_source(req, svc.source_root, svc.max_points)
        init = _parse_init(req)
        if _mode(req) == "icp":
            res = svc.refine(src, init, **_overrides(req))
        else:
            res = svc.register(src, init, **_overrides(req))
        return _result_json(req, res)
    except Exception as e:
        return _error_json(req, e)


def serve_stdio(service: RegistrationService, inp: IO, out: IO) -> int:
    """Line-delimited JSON loop on arbitrary text streams (stdio mode).
    Returns the number of requests served.  ``{"cmd": "shutdown"}`` ends.
    No auth: stdio is the trusted local transport (auth lives on TCP)."""
    n = 0
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            out.write(json.dumps(_error_json(None, e)) + "\n")
            out.flush()
            continue
        if isinstance(req, dict) and req.get("cmd") == "shutdown":
            out.write(json.dumps({"ok": True, "shutdown": True}) + "\n")
            out.flush()
            break
        resp = handle_request(service, req)
        if isinstance(resp, list):
            for r in resp:
                out.write(json.dumps(r) + "\n")
        else:
            out.write(json.dumps(resp) + "\n")
        out.flush()
        n += 1
    return n
