"""Serve data plane: per-node HTTP proxy actors.

Analogue of the reference's managed ``ProxyActor``
(``serve/_private/proxy.py:131,540,761,1130``) and its lifecycle manager
(``proxy_state.py``): the serve controller runs one ProxyActor on every
alive node (node-affinity scheduled), health-checks it, replaces it when
it dies, and drains it before removing a node's ingress. The HTTP server
lives INSIDE the actor's worker process — not in whichever driver called
``serve.run`` — so ingress survives driver exit and scales with the
cluster, and request routing (DeploymentHandle -> router -> replica) runs
in the proxy process too.

Request path: HTTP -> longest-prefix route table (cached from the serve
controller) -> DeploymentHandle -> pow-2 router -> replica. Streaming
responses use chunked transfer with one JSON line per yielded item.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

_STREAM_END = object()


class _ClientDisconnected(Exception):
    """The HTTP client went away mid-response; nothing can be written."""


def _lifecycle_error(e: BaseException):
    """Walk an exception chain (TaskError.cause / RemoteCallError.cause /
    __cause__) for a typed request-lifecycle error so the proxy can map
    it onto the right status code instead of a blanket 500."""
    from ray_tpu_torch.core.errors import (DeadlineExceededError, OverloadedError,
                                     RequestCancelledError)

    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, (OverloadedError, DeadlineExceededError,
                            RequestCancelledError)):
            return cur
        nxt = getattr(cur, "cause", None)
        cur = nxt if isinstance(nxt, BaseException) else cur.__cause__
    return None


class _InFlight:
    """Proxy request accounting for graceful draining."""

    def __init__(self):
        self.count = 0
        self.cond = threading.Condition()

    def __enter__(self):
        with self.cond:
            self.count += 1
        return self

    def __exit__(self, *exc):
        with self.cond:
            self.count -= 1
            self.cond.notify_all()

    def drain(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.count > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.cond.wait(min(remaining, 1.0))
        return True


class _RouteTable:
    """Longest-prefix route lookup against the serve controller's route
    table, cached briefly (the reference's proxy gets pushed route updates
    via LongPollHost; a 2 s pull cache gives the same convergence window
    without a standing subscription per proxy).

    Outage-tolerant by construction: the controller is LOOKED UP, never
    created (a proxy must not spawn a control plane to route a request),
    a failed refresh serves the stale cache and backs off further
    refresh attempts for 2 s — so during a controller outage the data
    plane keeps routing on its last known table, paying at most one
    short probe per backoff window instead of one per request. With no
    cache at all, ``resolve`` returns None and the caller falls back to
    the first path segment — fresh proxies still route the common
    ``/<app>`` shape with the controller down."""

    def __init__(self):
        self._cache: Optional[Tuple[float, Dict[str, str]]] = None
        self._backoff_until = 0.0
        self._lock = threading.Lock()

    def invalidate(self) -> None:
        with self._lock:
            self._cache = None

    def _refresh(self, now: float) -> Optional[Dict[str, str]]:
        import ray_tpu_torch
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        from ray_tpu_torch.serve.api import _controller_alive

        try:
            controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            if not _controller_alive(controller):
                # Mid-restart: degrade WITHOUT parking a blocking call
                # on the request path — stale routes serve meanwhile.
                raise RuntimeError("serve controller not ALIVE")
            try:
                routes = ray_tpu_torch.get(controller.get_routes.remote(),
                                     timeout=5.0)
            except Exception:
                # Same-handle retry, but only against a live record: a
                # restarted controller rejects a fresh handle's first
                # call (stale incarnation hint); a record that just
                # went RESTARTING is an outage — the failed call above
                # already reported it.
                if not _controller_alive(controller):
                    raise
                routes = ray_tpu_torch.get(controller.get_routes.remote(),
                                     timeout=5.0)
        except Exception:
            # Dead/restarting controller. The failed actor call above
            # doubles as the failure report that triggers its restart;
            # meanwhile the stale cache keeps the data plane moving.
            with self._lock:
                self._backoff_until = time.monotonic() + 2.0
            return None
        with self._lock:
            self._cache = (now, routes)
            self._backoff_until = 0.0
        return routes

    def resolve(self, path: str) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            cache = self._cache
            backoff_until = self._backoff_until
        routes = None
        if (cache is None or now - cache[0] > 2.0) \
                and now >= backoff_until:
            routes = self._refresh(now)
        if routes is None:
            routes = {} if cache is None else cache[1]
        path = "/" + path.strip("/")
        best = None
        for prefix, name in routes.items():
            if (prefix == "/" or path == prefix
                    or path.startswith(prefix + "/")):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, name)
        return best[1] if best else None


def make_handler(in_flight: _InFlight, routes: _RouteTable):
    """Build the request-handler class bound to one proxy's state."""
    from ray_tpu_torch.serve.deployment import DeploymentHandle

    class _ProxyHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

        def send_response(self, code, message=None):  # noqa: A003
            self._status = code  # observed by the request metrics below
            super().send_response(code, message)

        def do_POST(self):  # noqa: N802 (stdlib API)
            from contextlib import nullcontext

            from ray_tpu_torch.core.config import config as rt_config
            from ray_tpu_torch.util import tracing

            t0 = time.perf_counter()
            self._status = 0
            self._dep_name = ""
            # Inbound propagation: a client that opened its own span
            # ships it as X-Trace-Id/X-Parent-Span headers and this
            # request's whole tree parents under it — the client
            # process becomes the root of the cross-process trace.
            hdr_t = self.headers.get("X-Trace-Id", "")
            hdr_p = self.headers.get("X-Parent-Span", "")
            inbound = (hdr_t, hdr_p) if hdr_t and hdr_p else None
            with in_flight:
                # The request's ROOT span (or the child of the client's
                # span): everything below it — router span, attempt
                # spans, replica execution, engine queue-wait/prefill/
                # decode — parents back here, so one HTTP request
                # renders as one causally-linked tree across processes
                # in `ray_tpu timeline --serve`.
                if rt_config.serve_trace_spans:
                    with tracing.resume(inbound), \
                            tracing.trace(f"http:{self.path}",
                                          method="POST"):
                        self._handle()
                else:
                    self._handle()
            if rt_config.serve_metrics_enabled:
                from ray_tpu_torch.serve import metrics as smetrics

                tags = {"deployment": self._dep_name or "-"}
                smetrics.HTTP_LATENCY.observe(
                    time.perf_counter() - t0, tags)
                smetrics.HTTP_REQUESTS.inc(
                    1.0, {**tags, "code": str(self._status or 0)})

        def do_GET(self):  # noqa: N802
            # Health endpoint (reference: proxy.py /-/healthz).
            if self.path.rstrip("/") in ("/-/healthz", "/healthz"):
                data = b"ok"
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path.rstrip("/") in ("/metrics", "/-/metrics"):
                self._serve_metrics()
            else:
                self.send_error(404)

        def _serve_metrics(self) -> None:
            """Prometheus exposition text from the cluster controller's
            aggregated registry (reference: the node agent's exporter).
            Serving it from the INGRESS port means a Prometheus scraping
            the proxies sees every deployment's TTFT / inter-token /
            queue-wait histograms — and on disaggregated fleets the
            ``serve_handoff_*`` descriptor-size / lease-latency /
            lease-event series — without reaching the control plane."""
            from ray_tpu_torch.core.runtime import get_core_worker

            try:
                text = get_core_worker().controller.call(
                    "metrics_text", timeout=10.0)
            except Exception as e:  # noqa: BLE001 — head unreachable
                self._send_plain(503, f"metrics unavailable: {e}")
                return
            data = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _request_timeout_s(self) -> Optional[float]:
            """The request's end-to-end budget: client header
            ``X-Request-Timeout-S`` wins; else the
            ``serve_request_timeout_s`` config default (0 = none)."""
            from ray_tpu_torch.core.config import config as rt_config

            raw = self.headers.get("X-Request-Timeout-S", "")
            if raw:
                try:
                    val = float(raw)
                    if val > 0:
                        return val
                except ValueError:
                    pass  # malformed header: fall through to the default
            default = rt_config.serve_request_timeout_s
            return default if default > 0 else None

        def _send_plain(self, code: int, message: str,
                        headers: Tuple[Tuple[str, str], ...] = ()) -> None:
            data = (message + "\n").encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _send_lifecycle_error(self, e: BaseException) -> bool:
            """Typed lifecycle outcomes get real status codes: shed ->
            503 + Retry-After (from the replica's throughput estimate),
            deadline -> 504, client-cancelled -> 499. Returns False when
            ``e`` is not a lifecycle error."""
            from ray_tpu_torch.core.errors import (DeadlineExceededError,
                                             OverloadedError,
                                             RequestCancelledError)

            cause = _lifecycle_error(e)
            if isinstance(cause, OverloadedError):
                retry = max(1, math.ceil(cause.retry_after_s))
                self._send_plain(503, f"overloaded: {cause}",
                                 (("Retry-After", str(retry)),))
            elif isinstance(cause, DeadlineExceededError):
                self._send_plain(504, f"deadline exceeded: {cause}")
            elif isinstance(cause, RequestCancelledError):
                self._send_plain(499, f"request cancelled: {cause}")
            else:
                return False
            return True

        def _handle(self) -> None:
            from concurrent.futures import TimeoutError as FutTimeout

            parts = self.path.strip("/").split("/")
            # Route table first (supports custom route_prefix); fall back
            # to the first path segment as the app name.
            name = routes.resolve(self.path) or parts[0]
            self._dep_name = name  # request-metric deployment label
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b"null"
            model_id = self.headers.get("serve_multiplexed_model_id", "")
            streaming = (self.headers.get("x-serve-stream", "")
                         or self.headers.get("X-Serve-Stream", ""))
            timeout_s = self._request_timeout_s()
            try:
                payload = json.loads(body)
                handle = DeploymentHandle(name,
                                          multiplexed_model_id=model_id,
                                          timeout_s=timeout_s)
                if streaming:
                    self._stream_response(handle, payload, name)
                    return
                # The deadline rides with the request (router retries
                # stop at it; the engine frees the slot at it). The
                # local wait gets a grace window past it so the TYPED
                # DeadlineExceededError from the replica wins the race
                # against this blunt local timeout.
                result = handle.remote(payload).result(
                    timeout=(timeout_s + 10.0) if timeout_s else None)
                data = json.dumps(result).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except _ClientDisconnected:
                self.close_connection = True  # socket is gone; cancel done
            except KeyError:
                self.send_error(404, f"no deployment {name!r}")
            except FutTimeout:
                self._send_plain(504, "deadline exceeded: no reply from "
                                      "the deployment in time")
            except Exception as e:  # noqa: BLE001
                if not self._send_lifecycle_error(e):
                    self.send_error(500, str(e))

        def _stream_response(self, handle, payload, name: str) -> None:
            """Chunked transfer encoding, one JSON line per yielded item
            (reference: proxy.py streaming/chunked responses). The
            generator is pulled incrementally — chunks reach the client as
            the replica produces them.

            Errors BEFORE the first item become real HTTP errors (the
            generator is primed before any header ships); a mid-stream
            error can't rewrite the status line, so it becomes an error
            record in the stream and the connection closes (never a second
            response on a keep-alive socket)."""
            stream = handle.stream(payload)
            try:
                first = next(stream, _STREAM_END)
            except KeyError:
                self.send_error(404, f"no deployment {name!r}")
                return
            except Exception as e:  # noqa: BLE001
                if not self._send_lifecycle_error(e):
                    self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/jsonlines")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("Connection", "close")
            self.end_headers()

            def chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):x}\r\n".encode())
                self.wfile.write(data + b"\r\n")

            try:
                if first is not _STREAM_END:
                    chunk(json.dumps(first).encode() + b"\n")
                    for item in stream:
                        chunk(json.dumps(item).encode() + b"\n")
            except (BrokenPipeError, ConnectionError) as e:
                # Client hung up mid-stream: nothing can be written, but
                # the disconnect must PROPAGATE — the finally's
                # stream.close() cancels the replica stream, which
                # cancels the engine request and frees its slot.
                raise _ClientDisconnected(str(e)) from e
            except Exception as e:  # noqa: BLE001 — headers already sent
                # Mid-stream failures (incl. DeadlineExceeded) can't
                # rewrite the status line; they become an error record in
                # the stream and the connection closes.
                chunk(json.dumps(
                    {"__serve_stream_error__": str(e)}).encode() + b"\n")
            finally:
                # Deterministic cancellation: closing the generator runs
                # the router's finally (cancel_stream -> replica -> engine
                # .cancel) NOW, not at some later GC.
                stream.close()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass
                self.close_connection = True

        def log_message(self, *args):  # silence
            pass

    return _ProxyHandler


class ProxyActor:
    """One per node, supervised by the serve controller. The HTTP server
    runs on threads inside this actor's worker process; the actor's RPC
    surface is control-only (health, drain, address)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._in_flight = _InFlight()
        self._routes = _RouteTable()
        self._draining = False
        self._server = ThreadingHTTPServer(
            (host, port), make_handler(self._in_flight, self._routes))
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="serve-proxy-http",
            daemon=True)
        self._thread.start()

    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def node_hex(self) -> str:
        from ray_tpu_torch.core.runtime import get_core_worker

        return get_core_worker().node_id.hex()

    def healthz(self) -> Dict[str, Any]:
        return {"ok": not self._draining,
                "in_flight": self._in_flight.count,
                "addr": self._server.server_address}

    def invalidate_routes(self) -> None:
        self._routes.invalidate()

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Stop accepting, wait for in-flight requests (reference: proxy
        draining before node removal / serve shutdown)."""
        self._draining = True
        self._server.shutdown()  # accept loop stops; handlers continue
        ok = self._in_flight.drain(timeout_s)
        self._server.server_close()
        return ok
