"""TCP transport: cross-connection micro-batching and authentication (port
of the JAX package's ``serving/tcp.py``).

Concurrent connections queue into one :class:`Batcher` thread that drains
single-register requests into lockstep batches: P queries advance through
one round at a time.  The request/response encoding lives in
:mod:`goicp_tpu_torch.serving.protocol`.
"""

from __future__ import annotations

import hmac
import json
import queue
import threading
import time
from typing import List, Optional

from goicp_tpu_torch.core.logging import get_logger
from goicp_tpu_torch.serving.protocol import (
    _error_json,
    _load_query_source,
    _mode,
    _overrides,
    _parse_init,
    _result_json,
    _validate_keys,
    handle_request,
)
from goicp_tpu_torch.serving.service import RegistrationService


class _Pending:
    __slots__ = ("req", "event", "resp")

    def __init__(self, req):
        self.req = req
        self.event = threading.Event()
        self.resp = None


class Batcher(threading.Thread):
    """Drains queued single-register requests into lockstep batches.

    Waits ``window_s`` after the first request for stragglers, takes up to
    ``max_batch``, loads the sources, and runs ONE
    :meth:`RegistrationService.register_batch`.  Requests with param
    overrides, info commands, or load errors are answered individually.
    """

    def __init__(self, service: RegistrationService, max_batch: int = 8,
                 window_s: float = 0.05):
        super().__init__(daemon=True)
        self.service = service
        self.max_batch = max_batch
        self.window_s = window_s
        self.q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self.batches: List[int] = []     # sizes, for observability/tests

    def submit(self, req: dict) -> _Pending:
        p = _Pending(req)
        self.q.put(p)
        # shutdown race: if stop() already fired, run()'s final drain may
        # have exited before this put — refuse here so the handler thread
        # never blocks forever on an event nothing will set (double-refuse
        # with the drain is idempotent)
        if self._stop.is_set() and not p.event.is_set():
            self._refuse(p)
        return p

    def stop(self):
        self._stop.set()
        self.q.put(None)  # wake the drain loop

    def run(self):
        while not self._stop.is_set():
            first = self.q.get()
            if first is None:
                continue
            if self._stop.is_set():
                self._refuse(first)
                break
            group = [first]
            deadline = time.monotonic() + self.window_s
            while len(group) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                group.append(nxt)
            self._serve_group(group)
        # shutdown: refuse anything still queued so no handler thread
        # waits forever on a _Pending that will never be served
        while True:
            try:
                p = self.q.get_nowait()
            except queue.Empty:
                break
            self._refuse(p)

    def _refuse(self, p: Optional[_Pending]):
        if p is None:
            return
        p.resp = _error_json(
            p.req if isinstance(p.req, dict) else None,
            RuntimeError("server shutting down"),
        )
        p.event.set()

    def _serve_group(self, group: List[_Pending]):
        # anything that can't join a uniform lane answers solo; icp-mode
        # queries share one batched refine, goicp queries — with or
        # without an init prior (per-pair multistart seeds) — share one
        # lockstep BnB.  Lanes are per (kind, target): one dispatch = one
        # target.
        solo: List[_Pending] = []
        lanes: dict = {}   # (kind, id(svc)) -> [(pending, svc, src, init)]
        for p in group:
            req = p.req
            if (
                not isinstance(req, dict)
                or "cmd" in req
                or "batch" in req
                or _overrides(req)
            ):
                solo.append(p)
                continue
            try:
                _validate_keys(req)
                svc = self.service.resolve(req.get("target"))
                src = _load_query_source(req, svc.source_root, svc.max_points)
                init = _parse_init(req)
                m = _mode(req)
                lanes.setdefault((m, id(svc)), []).append((p, svc, src, init))
            except Exception as e:
                p.resp = _error_json(req, e)
                p.event.set()
        for p in solo:
            p.resp = handle_request(self.service, p.req)
            p.event.set()
        for (kind, _), items in lanes.items():
            svc = items[0][1]
            srcs = [it[2] for it in items]
            inits = [it[3] for it in items]
            self.batches.append(len(items))
            try:
                if kind == "icp":
                    results = svc.refine_batch(srcs, inits=inits)
                else:
                    results = svc.register_batch(srcs, inits=inits)
                for (p, _, _, _), res in zip(items, results):
                    p.resp = _result_json(p.req, res)
            except Exception as e:
                for p, _, _, _ in items:
                    p.resp = _error_json(p.req, e)
            for p, _, _, _ in items:
                p.event.set()


def serve_tcp(
    service: RegistrationService,
    host: str = "127.0.0.1",
    port: int = 0,
    max_batch: int = 8,
    window_s: float = 0.05,
    ready: Optional[threading.Event] = None,
    bound: Optional[list] = None,
    max_line: int = 80 << 20,
    auth_token: Optional[str] = None,
):
    """Blocking TCP server: one JSON request per line per connection,
    concurrent connections micro-batched through a :class:`Batcher`.
    ``{"cmd": "shutdown"}`` from any (authenticated) client stops the
    server.  ``ready`` / ``bound`` (a list to receive the actual port)
    support test harnesses.  ``max_line`` caps the per-request payload
    (80 MB comfortably fits the default ``max_points`` of 1M inline points
    even at full float precision ~60 bytes/point; raise both to go bigger).

    ``auth_token``: when set, every connection must authenticate with a
    first line of ``{"auth": "<token>"}`` before anything else — including
    ``shutdown``.  A wrong or missing handshake gets ONE error record and
    the connection closes, so a reachable port alone does not grant solves.
    The token is compared as bytes in constant time (``hmac``)."""
    import socketserver

    batcher = Batcher(service, max_batch=max_batch, window_s=window_s)
    batcher.start()
    log = get_logger()

    class Handler(socketserver.StreamRequestHandler):
        MAX_LINE = max_line

        def handle(self):
            if auth_token is not None and not self._authenticate():
                return
            while True:
                raw = self.rfile.readline(self.MAX_LINE + 3)
                if not raw:
                    break
                if len(raw.rstrip(b"\r\n")) > self.MAX_LINE:
                    # drain the oversized line, then refuse it
                    while raw and not raw.endswith(b"\n"):
                        raw = self.rfile.readline(self.MAX_LINE)
                    self._send(_error_json(
                        None, ValueError(
                            f"request line exceeds {self.MAX_LINE >> 20} MB"
                        )
                    ))
                    continue
                try:
                    req = json.loads(raw.decode())
                except Exception as e:
                    self._send(_error_json(None, e))
                    continue
                if isinstance(req, dict) and req.get("cmd") == "shutdown":
                    self._send({"ok": True, "shutdown": True})
                    threading.Thread(
                        target=server.shutdown, daemon=True
                    ).start()
                    return
                pending = batcher.submit(req)
                pending.event.wait()
                resp = pending.resp
                if isinstance(resp, list):
                    for r in resp:
                        self._send(r)
                else:
                    self._send(resp)

        def _authenticate(self) -> bool:
            """First-line ``{"auth": "<token>"}`` handshake.  The line cap
            is small: a token line has no business being big, and an
            unauthenticated peer must not make the server buffer MBs."""
            raw = self.rfile.readline(4096)
            try:
                req = json.loads(raw.decode())
                supplied = req.get("auth") if isinstance(req, dict) else None
            except Exception:
                supplied = None
            # compare BYTES: compare_digest on str raises TypeError for
            # non-ASCII input, which would break every handshake under a
            # non-ASCII operator token (and close sockets without the
            # promised error record)
            if isinstance(supplied, str) and hmac.compare_digest(
                supplied.encode(), auth_token.encode()
            ):
                self._send({"ok": True, "auth": True})
                return True
            self._send(_error_json(None, PermissionError(
                'authentication required: first line must be '
                '{"auth": "<token>"}'
            )))
            return False

        def _send(self, obj):
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as server:
        actual = server.server_address[1]
        if bound is not None:
            bound.append(actual)
        log.info("serving '%s' on %s:%d (max_batch=%d window=%.0fms auth=%s)",
                 service.name, host, actual, max_batch, window_s * 1e3,
                 "on" if auth_token is not None else "off")
        if ready is not None:
            ready.set()
        server.serve_forever()
    batcher.stop()
    return batcher
