"""CLI: ``python -m goicp_tpu_torch serve <target.{ply,txt}> [options]`` (port
of the JAX package's ``serving/cli.py``, with its flags and ``--device``)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional, Sequence

from goicp_tpu_torch.bnb import BnbParams
from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.io import load_cloud
from goicp_tpu_torch.serving.protocol import serve_stdio
from goicp_tpu_torch.serving.service import MultiTargetService, RegistrationService
from goicp_tpu_torch.serving.tcp import serve_tcp


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="goicp_tpu_torch serve",
        description="Target-resident Go-ICP registration service "
                    "(JSON-lines over stdio or TCP) on an NVIDIA GPU.",
    )
    ap.add_argument("target", nargs="+",
                    help="resident target cloud(s) (.ply/.txt); several "
                         "paths serve a model zoo — queries pick one with "
                         "'target': '<basename>' (default: the first)")
    ap.add_argument("--toml", default=None,
                    help="scenario TOML providing solver defaults "
                         "([params] + [tpu] sections)")
    ap.add_argument("--resize", type=float, default=None,
                    help="scale the target (default: TOML resize or 1.0)")
    ap.add_argument("--subsample", type=float, default=None,
                    help="subsample the target (default: TOML or 1.0)")
    ap.add_argument("--port", type=int, default=None,
                    help="TCP port (omit for stdio mode; 0 = ephemeral)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="micro-batch cap for concurrent TCP queries")
    ap.add_argument("--window-ms", type=float, default=50.0,
                    help="micro-batch gather window")
    ap.add_argument("--warmup", type=int, default=0, metavar="N_SRC",
                    help="solve one N_SRC-point query before serving")
    ap.add_argument("--source-root", default=None, metavar="DIR",
                    help="confine {'source': <path>} queries under DIR. "
                         "TCP default: paths DISABLED (inline 'points' "
                         "only); stdio default: any path (trusted local)")
    ap.add_argument("--max-points", type=int, default=1 << 20,
                    help="reject queries with more points than this "
                         "(bounded device allocation; default 1M)")
    ap.add_argument("--max-line-mb", type=int, default=80,
                    help="per-request line cap in MB (TCP mode)")
    ap.add_argument("--auth-token", default=None, metavar="TOKEN",
                    help="require a {'auth': TOKEN} first line on every TCP "
                         "connection (shutdown included); unauthenticated "
                         "peers get one error record and a close.  Default: "
                         "$GOICP_AUTH_TOKEN if set, else no auth (stdio "
                         "mode never authenticates — it is the trusted "
                         "local transport)")
    ap.add_argument("--escalate-mse", type=float, default=None,
                    metavar="MSE",
                    help="tracking-loss auto-escalation: a mode='icp' query "
                         "whose refined mse exceeds MSE is re-queued into "
                         "the prior-seeded goicp lane and answered with the "
                         "certified pose (escalated: true).  Clients may "
                         "override per query with 'escalate_mse'")
    ap.add_argument("--no-shape-bucket", action="store_true",
                    help="disable query-size bucketing (single goicp queries "
                         "then use the single-pair solver instead of the "
                         "lockstep driver)")
    ap.add_argument("--icp-cache-size", type=int, default=16,
                    help="LRU cap on cached tracking-path closures "
                         "(one per distinct param-override combination)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the CUDA device (default) or on the CPU's plain path")
    args = ap.parse_args(argv)

    if args.toml:
        from goicp_tpu_torch.cli import bnb_params_from_config
        from goicp_tpu_torch.core.config import Config

        cfg = Config.from_toml(args.toml)
        params = bnb_params_from_config(cfg)
        resize = args.resize if args.resize is not None else cfg.resize
        subsample = args.subsample if args.subsample is not None else cfg.subsample
    else:
        params = BnbParams()
        resize = args.resize if args.resize is not None else 1.0
        subsample = args.subsample if args.subsample is not None else 1.0

    if args.escalate_mse is not None:
        params = dataclasses.replace(params, escalate_mse=args.escalate_mse)
    auth_token = args.auth_token
    if auth_token is None:
        auth_token = os.environ.get("GOICP_AUTH_TOKEN") or None

    source_root = args.source_root
    if source_root is None and args.port is not None:
        source_root = ""   # network exposure: filesystem queries opt-in only
    services = {}
    for path in args.target:
        name = os.path.splitext(os.path.basename(path))[0]
        if name in services:
            get_logger().warning(
                "duplicate target basename %r: %s is addressable as "
                "'target': %r (full path), not by basename", name, path, path,
            )
            name = path
        tgt = load_cloud(path, subsample=subsample, resize=resize)
        services[name] = RegistrationService(
            tgt, params, name=name, source_root=source_root,
            max_points=args.max_points,
            bucket_shapes=not args.no_shape_bucket,
            icp_cache_size=args.icp_cache_size,
            device=args.device,
        )
        if args.warmup:
            services[name].warmup(args.warmup)
    service = (
        next(iter(services.values()))
        if len(services) == 1
        else MultiTargetService(services)
    )

    if args.port is None:
        serve_stdio(service, sys.stdin, sys.stdout)
    else:
        serve_tcp(service, host=args.host, port=args.port,
                  max_batch=args.max_batch, window_s=args.window_ms / 1e3,
                  max_line=args.max_line_mb << 20, auth_token=auth_token)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
