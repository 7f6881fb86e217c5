"""Deployments + handles + routing (data plane).

Analogue of the reference's Serve data plane: ``DeploymentHandle``
(``serve/handle.py:714``) -> ``Router.assign_request`` (``router.py:312``)
-> power-of-two-choices replica picking
(``replica_scheduler/pow_2_scheduler.py:49``) -> ``ReplicaActor``. Routing
state is pushed, not polled: every handle watches the cluster pubsub for
its deployment's replica snapshot (the reference's LongPollHost pattern,
``long_poll.py:173``), so scale-ups, scale-downs, replica deaths and
multiplexed-model residency changes propagate to all routers without any
controller round-trip on the request path.

In-flight counts are client-side per handle (the sample the reference's
pow-2 scheduler uses is its own probe of its own outstanding requests per
replica); model-aware routing prefers replicas that already have the
requested ``multiplexed_model_id`` loaded (``serve/multiplex.py``).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.errors import (ActorDiedError, ActorUnavailableError,
                                 DeadlineExceededError, GetTimeoutError)
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.serve.controller import SNAPSHOT_CHANNEL
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 5.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "target_ongoing_requests": self.target_ongoing_requests,
            "upscale_delay_s": self.upscale_delay_s,
            "downscale_delay_s": self.downscale_delay_s,
        }


class Deployment:
    """Declarative deployment config (``@serve.deployment``)."""

    ROLES = (None, "colocated", "prefill", "decode")

    def __init__(self, cls, name: Optional[str] = None,
                 num_replicas: int = 1,
                 ray_actor_options: Optional[Dict] = None,
                 autoscaling_config: Optional[AutoscalingConfig] = None,
                 max_ongoing_requests: int = 8,
                 mesh_shape: Optional[Any] = None,
                 role: Optional[str] = None,
                 decode_deployment: Optional[str] = None):
        self.cls = cls
        self.name = name or cls.__name__
        self.num_replicas = num_replicas
        self.actor_options = ray_actor_options or {}
        self.autoscaling = autoscaling_config
        self.max_ongoing_requests = max_ongoing_requests
        # (batch, model) decode-mesh footprint per replica: the serve
        # controller reserves an ICI-contiguous sub-slice of that many
        # chips before spawning each replica, and the replica's engine
        # spans it with GSPMD-sharded weights/KV (single replica, many
        # devices — the model-parallel serving mode).
        self.mesh_shape = tuple(mesh_shape) if mesh_shape else None
        # Disaggregated serving posture (ROADMAP #3). Unset/"colocated"
        # is the legacy path, byte-for-byte: each replica prefills AND
        # decodes. "prefill" replicas run admission + chunked prefill,
        # publish the filled KV pages over the object plane, and the
        # router splices each request to ``decode_deployment`` (a
        # role="decode" deployment of the SAME model/page geometry),
        # which adopts the pages — zero recompute — and decodes.
        if role not in self.ROLES:
            raise ValueError(
                f"role must be one of {self.ROLES}, got {role!r}")
        if role == "prefill" and not decode_deployment:
            raise ValueError(
                "role='prefill' requires decode_deployment (the "
                "role='decode' deployment that adopts its handoffs)")
        self.role = role
        self.decode_deployment = decode_deployment
        self._init_args: tuple = ()
        self._init_kwargs: dict = {}

    def options(self, **overrides) -> "Deployment":
        dep = Deployment(self.cls, self.name, self.num_replicas,
                         dict(self.actor_options), self.autoscaling,
                         self.max_ongoing_requests, self.mesh_shape,
                         self.role, self.decode_deployment)
        dep._init_args = self._init_args
        dep._init_kwargs = self._init_kwargs
        for k, v in overrides.items():
            setattr(dep, "autoscaling" if k == "autoscaling_config"
                    else ("actor_options" if k == "ray_actor_options" else k),
                    v)
        return dep

    def bind(self, *args, **kwargs) -> "Deployment":
        self._init_args = args
        self._init_kwargs = kwargs
        return self

    def config_dict(self) -> Dict[str, Any]:
        mesh = self.mesh_shape or self._init_kwargs.get("mesh_shape")
        return {
            "num_replicas": self.num_replicas,
            "actor_options": dict(self.actor_options),
            "autoscaling": (self.autoscaling.to_dict()
                            if self.autoscaling else None),
            "max_ongoing_requests": self.max_ongoing_requests,
            # Explicit deployment-level mesh wins; a mesh_shape bound
            # into the class's init kwargs (LlamaDecodeDeployment-style)
            # reaches placement the same way.
            "mesh_shape": list(mesh) if mesh else None,
            "role": self.role,
            "decode_deployment": self.decode_deployment,
        }


def deployment(_cls=None, **kwargs):
    """``@serve.deployment`` decorator (reference: ``serve/api.py``)."""

    def wrap(cls):
        return Deployment(cls, **kwargs)

    if _cls is not None:
        return wrap(_cls)
    return wrap


def _affinity_hashes(args: tuple):
    """Candidate prefix hashes for a generation-shaped request (a dict
    with a ``tokens`` sequence as the first positional arg). Returns
    None when affinity is disabled or the request has no token prompt —
    routing then falls through to pure pow-2 least-loaded."""
    from ray_tpu_torch.core.config import config as rt_config

    if not rt_config.prefix_affinity_enabled:
        return None
    req = args[0] if args else None
    if not isinstance(req, dict):
        return None
    tokens = req.get("tokens")
    if tokens is None:
        return None
    try:
        from ray_tpu_torch.serve.prefix_cache import candidate_hashes

        return candidate_hashes(
            tokens, rt_config.prefix_match_min_tokens) or None
    except Exception:
        return None


def _error_chain(e: BaseException):
    """Walk an exception chain (TaskError.cause / __cause__) — replica-
    side typed errors arrive wrapped in the actor-call error shipping,
    and the splice's fallback decisions key on the original type."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        yield cur
        nxt = getattr(cur, "cause", None)
        cur = nxt if isinstance(nxt, BaseException) else cur.__cause__


_local_slice_cache: List[Optional[str]] = []  # memo: [] = not probed yet


def _local_slice_id() -> Optional[str]:
    """The pod slice THIS process's node advertises (None when the node
    carries no topology). One controller round-trip, memoized for the
    process lifetime — slice membership doesn't change under a live
    process. Routers use it to prefer ICI-local replicas."""
    if not _local_slice_cache:
        slice_id = None
        try:
            from ray_tpu_torch.core.runtime import get_core_worker

            from ray_tpu_torch.core.config import config as rt_config

            core = get_core_worker()
            me = core.node_id.hex()
            for n in core.controller.call(
                    "list_nodes", timeout=rt_config.ctrl_call_timeout_s):
                if n["node_id"] == me and n.get("slice"):
                    slice_id = n["slice"]["slice_id"]
                    break
        except Exception:
            slice_id = None
        _local_slice_cache.append(slice_id)
    return _local_slice_cache[0]


class _Router:
    """Per-process router for one deployment: pubsub-fed replica snapshot +
    client-side pow-2 routing with model and prefix-cache affinity."""

    _instances: Dict[str, "_Router"] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get(cls, name: str) -> "_Router":
        with cls._instances_lock:
            router = cls._instances.get(name)
            if router is None:
                router = cls(name)
                cls._instances[name] = router
            return router

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._replicas: List[Dict[str, Any]] = []  # {handle, id, models}
        self._inflight: Dict[str, int] = {}
        self._version = 0
        # Highest controller epoch whose snapshot this router applied:
        # snapshots from an OLDER epoch (a zombie controller racing its
        # replacement) are ignored — client-side belt to the pubsub
        # hub's server-side fencing suspender.
        self._ctrl_epoch = 0
        self._have_snapshot = threading.Event()
        self._max_ongoing = 8
        self._deleted = False
        # Disaggregated posture from the controller snapshot: routers of
        # a role="prefill" deployment splice __call__ requests across
        # the prefill and decode fleets; everything else routes legacy.
        self._role = "colocated"
        self._decode_dep: Optional[str] = None
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=64,
                                        thread_name_prefix="serve-router")
        self._watcher = threading.Thread(target=self._watch_loop,
                                         name=f"serve-watch-{name}",
                                         daemon=True)
        self._watcher.start()

    # -------------------------------------------------------- snapshots

    def _apply(self, version: int, snapshot: Dict[str, Any]) -> None:
        with self._lock:
            epoch = int(snapshot.get("epoch") or 0)
            if epoch and epoch < self._ctrl_epoch:
                # Zombie-epoch snapshot: keep serving the newer view.
                # (The version clock still advances with the poll loop,
                # so the next legitimate publish wakes us normally.)
                self._version = max(self._version, version)
                return
            if epoch:
                self._ctrl_epoch = epoch
            self._version = version
            self._deleted = snapshot.get("deleted", False)
            self._max_ongoing = snapshot.get("max_ongoing_requests", 8)
            self._role = snapshot.get("role") or "colocated"
            self._decode_dep = snapshot.get("decode_deployment")
            self._replicas = [
                {"handle": ActorHandle(ActorID(r["actor_id"])),
                 "id": r["replica_id"],
                 "models": set(r.get("models", [])),
                 "prefixes": set(r.get("prefixes", [])),
                 "slice_id": r.get("slice_id")}
                for r in snapshot.get("replicas", [])]
            live = {r["id"] for r in self._replicas}
            self._inflight = {k: v for k, v in self._inflight.items()
                              if k in live}
            ready = bool(self._replicas) or self._deleted
        if ready:
            self._have_snapshot.set()

    def _watch_loop(self) -> None:
        from ray_tpu_torch.core.runtime import get_core_worker

        while not self._stop.is_set():
            try:
                core = get_core_worker()
                # Single-writer field: _version is only assigned by
                # _apply, and only THIS thread calls _apply — the
                # unlocked read can never observe a torn/foreign write.
                update = core.controller.call(
                    "psub_poll", SNAPSHOT_CHANNEL, self.name,
                    # graftlint: disable=unguarded-field-access
                    self._version, 10.0, timeout=25.0)
            except Exception:
                if self._stop.wait(0.5):
                    return
                continue
            if update is not None:
                self._apply(*update)

    def _known_to_controller(self) -> bool:
        """One cheap existence probe so unknown names fail fast (404), not
        after a 60s wait."""
        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.core.runtime import get_core_worker

        try:
            snap = get_core_worker().controller.call(
                "psub_snapshot", SNAPSHOT_CHANNEL,
                timeout=rt_config.ctrl_call_timeout_s)
            return self.name in snap
        except Exception:
            return True  # can't tell: fall through to the normal wait

    def _evict(self) -> None:
        with _Router._instances_lock:
            if _Router._instances.get(self.name) is self:
                del _Router._instances[self.name]
        self.stop()

    def wait_ready(self, timeout: float = 60.0) -> None:
        if not self._have_snapshot.is_set() and not self._known_to_controller():
            self._evict()
            raise KeyError(f"no deployment {self.name!r}")
        if not self._have_snapshot.wait(timeout):
            # Unknown deployment (or controller gone): evict this router so
            # a probe of a bad name doesn't leak a watcher + pool forever.
            self._evict()
            raise KeyError(
                f"no routing snapshot for deployment {self.name!r} "
                f"(does it exist?)")

    def wait_version(self, version: int, timeout: float = 60.0) -> None:
        """Block until this router has applied snapshot >= version (used by
        serve.run so a redeploy's first request can't route on a stale —
        possibly deleted — snapshot)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                if self._version >= version:
                    return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"router for {self.name!r} never saw snapshot v{version}")
            time.sleep(0.02)

    # ---------------------------------------------------------- routing

    def _pick(self, model_id: str, prefix_hashes=None):
        """Pow-2 choices on local in-flight counts; with a model id,
        replicas that already hold the model win (multiplex affinity);
        with prefix hashes, replicas advertising the request's leading
        token bucket win (prefix-cache affinity) — a hot system prompt
        stays resident on ONE replica's prefix pool instead of being
        re-prefilled on every replica."""
        from ray_tpu_torch.core.config import config as rt_config

        # Resolved BEFORE taking the router lock: the first call is a
        # controller round-trip (memoized after), and an RPC under this
        # lock would head-of-line-block every concurrent pick (the
        # dial-under-lock class graftlint polices).
        here = (_local_slice_id() if rt_config.slice_affinity_enabled
                else None)
        with self._lock:
            replicas = self._replicas
            if not replicas:
                return None
            pool = replicas
            if model_id:
                warm = [r for r in replicas if model_id in r["models"]]
                # Warm replicas win unless saturated (then let a cold one
                # load the model rather than queueing behind the hot set).
                warm = [r for r in warm
                        if self._inflight.get(r["id"], 0) < self._max_ongoing]
                if warm:
                    pool = warm
            if prefix_hashes:
                # Longest advertised bucket wins; same saturation escape
                # valve as model affinity (least-loaded beats affinity
                # once the warm replica is at max_ongoing).
                for h in prefix_hashes:
                    warm = [r for r in pool if h in r["prefixes"]
                            and self._inflight.get(r["id"], 0)
                            < self._max_ongoing]
                    if warm:
                        pool = warm
                        break
            # ICI locality, weakest preference (model residency and a
            # prefix hit both save real compute; same-slice only saves
            # network): among the remaining candidates, stay on the
            # caller's own pod slice when an unsaturated replica lives
            # there — controller snapshots carry each replica's slice.
            if here is not None:
                near = [r for r in pool if r.get("slice_id") == here
                        and self._inflight.get(r["id"], 0)
                        < self._max_ongoing]
                if near:
                    pool = near
            if len(pool) == 1:
                chosen = pool[0]
            else:
                a, b = random.sample(range(len(pool)), 2)
                ca = self._inflight.get(pool[a]["id"], 0)
                cb = self._inflight.get(pool[b]["id"], 0)
                chosen = pool[a if ca <= cb else b]
            self._inflight[chosen["id"]] = (
                self._inflight.get(chosen["id"], 0) + 1)
            return chosen

    def _release(self, replica) -> None:
        with self._lock:
            rid = replica["id"]
            if rid in self._inflight:
                self._inflight[rid] = max(0, self._inflight[rid] - 1)

    def submit(self, method: str, args: tuple, kwargs: dict,
               model_id: str = "", timeout_s: Optional[float] = None
               ) -> Future:
        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.util import tracing

        fut: Future = Future()
        # The caller's span context is captured HERE: contextvars don't
        # follow work onto pool threads, and the request's whole trace
        # (router span -> attempt spans -> replica -> engine) must hang
        # under the span that submitted it (e.g. the proxy's http span).
        ctx = tracing.current() if rt_config.serve_trace_spans else None
        self._pool.submit(self._run_one, fut, method, args, kwargs,
                          model_id, timeout_s, ctx)
        return fut

    @staticmethod
    def _backoff_s(attempt: int) -> float:
        """Exponential backoff with +/-50% jitter: base * 2^attempt,
        decorrelated so N handles retrying the same replica death don't
        synchronize into a retry storm against the survivors."""
        from ray_tpu_torch.core.config import config as rt_config

        base = rt_config.handle_retry_backoff_ms / 1e3
        return base * (2 ** attempt) * (0.5 + random.random())

    def _run_one(self, fut: Future, method, args, kwargs, model_id,
                 timeout_s: Optional[float] = None,
                 trace_ctx: Optional[tuple] = None) -> None:
        from contextlib import nullcontext

        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.util import tracing

        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        spans = rt_config.serve_trace_spans
        try:
            # One router span per request; each attempt gets a child
            # span tagged with the attempt ordinal and replica, and the
            # actor call made INSIDE it ships that span's context — so a
            # retried request's replica-side work stays parented under
            # the same request across attempts.
            with tracing.resume(trace_ctx), \
                    (tracing.trace(f"router:{self.name}", method=method)
                     if spans else nullcontext()):
                self.wait_ready()
                if self._splice_eligible(method, args):
                    fut.set_result(self._run_spliced(
                        args[0], model_id, deadline))
                else:
                    fut.set_result(self._call_with_retries(
                        method, args, kwargs, model_id, deadline,
                        _affinity_hashes(args)))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    def _call_with_retries(self, method, args, kwargs, model_id,
                           deadline: Optional[float],
                           prefix_hashes=None) -> Any:
        """One routed unary call: pick -> call -> return, retrying a
        dead replica within the handle budget (backoff, never past the
        absolute monotonic ``deadline``)."""
        from contextlib import nullcontext

        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.util import tracing

        budget = max(1, rt_config.handle_retry_budget)
        spans = rt_config.serve_trace_spans
        last_err: Optional[BaseException] = None
        for attempt in range(budget):
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceededError(
                    f"deadline expired before attempt "
                    f"{attempt + 1} to {self.name!r}") from last_err
            replica = self._pick(model_id, prefix_hashes)
            if replica is None:
                # Advisory read: worst case a request that raced
                # the delete gets the "no replicas" message
                # instead of "was deleted" — both terminate it
                # identically.
                # graftlint: disable=unguarded-field-access
                if self._deleted:
                    raise RuntimeError(
                        f"deployment {self.name!r} was deleted")
                raise RuntimeError(
                    f"deployment {self.name!r} has no replicas")
            try:
                # The deadline ships as a RELATIVE duration; the
                # replica re-anchors it to its own clock. get()'s
                # grace past it only covers transit — the replica
                # enforces the deadline itself.
                with (tracing.trace("attempt", attempt=attempt,
                                    replica=replica["id"])
                      if spans else nullcontext()):
                    ref = replica["handle"].handle_request.remote(
                        method, args, kwargs, model_id, remaining)
                    return ray_tpu_torch.get(
                        ref, timeout=(None if remaining is None
                                      else remaining + 10.0))
            except GetTimeoutError as e:
                raise DeadlineExceededError(
                    f"no reply from {self.name!r} within the "
                    f"request deadline") from e
            except (ActorDiedError, ActorUnavailableError) as e:
                # Replica died: forget it locally; the
                # controller's next snapshot heals the set.
                # Retry elsewhere — within the per-request
                # budget, with backoff, and never past the
                # deadline.
                last_err = e
                with self._lock:
                    self._replicas = [r for r in self._replicas
                                      if r["id"] != replica["id"]]
                if attempt + 1 >= budget:
                    break
                pause = self._backoff_s(attempt)
                if (deadline is not None
                        and time.monotonic() + pause >= deadline):
                    break  # the retry could not finish in time
                self._count_retry()
                time.sleep(pause)
            finally:
                self._release(replica)
        raise last_err

    # --------------------------------------- disaggregated splice

    def _splice_eligible(self, method: str, args: tuple,
                         stream: bool = False) -> bool:
        """Should this request split across the prefill/decode fleets?
        Only a role="prefill" deployment splices, only for generation-
        shaped requests, and only while the decode fleet has routable
        replicas — otherwise fall through to the legacy colocated path
        (prefill replicas run the full engine; role is routing posture,
        not capability)."""
        # a stale posture routes one request the legacy way, harmlessly
        if self._role != "prefill" or not self._decode_dep:
            return False
        if method not in (("__call__", "stream") if stream
                          else ("__call__",)):
            return False
        req = args[0] if args else None
        if not isinstance(req, dict) or req.get("tokens") is None:
            return False
        if not stream and req.get("stream"):
            return False  # generator path: _Router.stream splices it
        decode = _Router.get(self._decode_dep)
        if not decode._have_snapshot.is_set():
            return False  # decode fleet not routable yet: don't publish
        with decode._lock:
            return bool(decode._replicas)

    def _notify_handoff(self, replica, verb: str, desc) -> None:
        """Fire-and-forget lease notify back to the prefill replica
        (adopt-ack or abort). Best-effort by design: an unreachable
        prefill replica is a dead one, whose refs died with it, and the
        ledger's TTL sweep backstops a lost notify."""
        try:
            replica["handle"].handle_request.remote(
                verb, (desc["handoff_id"],), {}, "", None)
        except Exception:
            log_every("router.handoff_notify", 10.0, logger,
                      "handoff lease notify failed", exc_info=True)

    def _run_spliced(self, request, model_id,
                     deadline: Optional[float]) -> Any:
        """Disaggregated splice, unary: prefill on this fleet publishes
        the prompt's KV pages (``prefill_handoff``), the decode fleet
        adopts them (``decode_adopted``). The published lease is
        discharged on EVERY path: adopt-ack on success, abort on any
        decode-side failure; a prefill replica that dies mid-handoff
        needs nothing (its refs died with the owner process) and the
        request re-prefills within the retry budget."""
        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.core.errors import (HandoffAdoptError,
                                         RequestCancelledError)

        decode = _Router.get(self._decode_dep)
        prefix_hashes = _affinity_hashes((request,))
        budget = max(1, rt_config.handle_retry_budget)
        last_err: Optional[BaseException] = None
        for attempt in range(budget):
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceededError(
                    f"deadline expired before splice attempt "
                    f"{attempt + 1} via {self.name!r}") from last_err
            replica = self._pick(model_id, prefix_hashes)
            if replica is None:
                raise RuntimeError(
                    f"deployment {self.name!r} has no replicas")
            try:
                ref = replica["handle"].handle_request.remote(
                    "prefill_handoff", (request,), {}, model_id,
                    remaining)
                desc = ray_tpu_torch.get(
                    ref, timeout=(None if remaining is None
                                  else remaining + 10.0))
            except GetTimeoutError as e:
                raise DeadlineExceededError(
                    f"no prefill handoff from {self.name!r} within "
                    f"the request deadline") from e
            except (ActorDiedError, ActorUnavailableError) as e:
                # Prefill replica death mid-handoff: its object-plane
                # refs died with the owner process, so nothing strands
                # — forget it and re-prefill elsewhere.
                last_err = e
                with self._lock:
                    self._replicas = [r for r in self._replicas
                                      if r["id"] != replica["id"]]
                if attempt + 1 >= budget:
                    break
                pause = self._backoff_s(attempt)
                if (deadline is not None
                        and time.monotonic() + pause >= deadline):
                    break
                self._count_retry()
                time.sleep(pause)
                continue
            finally:
                self._release(replica)
            # Published: the lease is this router's to discharge. The
            # decode router retries a dead decode replica internally —
            # the descriptor stays valid (the prefill replica holds the
            # refs until we notify).
            try:
                result = decode._call_with_retries(
                    "decode_adopted", (request, desc), {}, model_id,
                    deadline, prefix_hashes)
            except BaseException as e:
                self._notify_handoff(replica, "abort_handoff", desc)
                for cause in _error_chain(e):
                    if isinstance(cause, (DeadlineExceededError,
                                          RequestCancelledError)):
                        raise  # terminal by contract: never fall back
                    if isinstance(cause, HandoffAdoptError):
                        # The decode fleet cannot splice these pages
                        # (geometry mismatch / payload gone with a dead
                        # owner): serve the request colocated, once.
                        logger.warning(
                            "handoff adopt failed (%s); falling back "
                            "to colocated on %r", cause, self.name)
                        return self._call_with_retries(
                            "__call__", (request,), {}, model_id,
                            deadline, prefix_hashes)
                raise
            self._notify_handoff(replica, "discharge_handoff", desc)
            return result
        raise last_err

    def _count_retry(self) -> None:
        from ray_tpu_torch.core.config import config as rt_config

        if rt_config.serve_metrics_enabled:
            from ray_tpu_torch.serve import metrics as smetrics

            smetrics.RETRIES.inc(1.0, {"deployment": self.name})

    def stream(self, method: str, args: tuple, kwargs: dict,
               model_id: str = "", chunk_items: int = 16,
               timeout_s: Optional[float] = None):
        """Generator of streamed items from one replica (or, for a
        role="prefill" deployment, spliced across the prefill and
        decode fleets): see ``_stream_plain`` / ``_stream_spliced``."""
        self.wait_ready()
        if self._splice_eligible(method, args, stream=True):
            yield from self._stream_spliced(
                method, args[0], model_id, chunk_items,
                (time.monotonic() + timeout_s
                 if timeout_s is not None else None))
            return
        yield from self._stream_plain(method, args, kwargs, model_id,
                                      chunk_items, timeout_s)

    def _stream_spliced(self, method, request, model_id,
                        chunk_items: int, deadline: Optional[float]):
        """Disaggregated splice, streaming: publish the prefill handoff
        here, then delegate to the decode router's stream (which adopts
        EAGERLY inside start_stream, so pre-first-item failures are
        visible before any token reaches the client). The lease is
        discharged at the first streamed item (adoption observably
        complete) and aborted on any pre-first-item failure."""
        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.core.errors import (HandoffAdoptError,
                                         RequestCancelledError)

        decode = _Router.get(self._decode_dep)
        prefix_hashes = _affinity_hashes((request,))
        budget = max(1, rt_config.handle_retry_budget)
        last_err: Optional[BaseException] = None
        for attempt in range(budget):
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceededError(
                    f"deadline expired before the spliced stream via "
                    f"{self.name!r} started") from last_err
            replica = self._pick(model_id, prefix_hashes)
            if replica is None:
                raise RuntimeError(
                    f"deployment {self.name!r} has no replicas")
            try:
                desc = ray_tpu_torch.get(
                    replica["handle"].handle_request.remote(
                        "prefill_handoff", (request,), {}, model_id,
                        remaining),
                    timeout=(None if remaining is None
                             else remaining + 10.0))
            except GetTimeoutError as e:
                raise DeadlineExceededError(
                    f"no prefill handoff from {self.name!r} within "
                    f"the request deadline") from e
            except (ActorDiedError, ActorUnavailableError) as e:
                last_err = e
                with self._lock:
                    self._replicas = [r for r in self._replicas
                                      if r["id"] != replica["id"]]
                if attempt + 1 >= budget:
                    break
                pause = self._backoff_s(attempt)
                if (deadline is not None
                        and time.monotonic() + pause >= deadline):
                    break
                self._count_retry()
                time.sleep(pause)
                continue
            finally:
                self._release(replica)
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            inner = decode.stream(
                "stream_adopted", (request, desc), {}, model_id,
                chunk_items=chunk_items, timeout_s=remaining)
            discharged = False
            try:
                for item in inner:
                    if not discharged:
                        discharged = True
                        self._notify_handoff(replica,
                                             "discharge_handoff", desc)
                    yield item
                if not discharged:  # empty stream still adopted
                    discharged = True
                    self._notify_handoff(replica,
                                         "discharge_handoff", desc)
                return
            except BaseException as e:
                if not discharged:
                    self._notify_handoff(replica, "abort_handoff", desc)
                for cause in _error_chain(e):
                    if isinstance(cause, (DeadlineExceededError,
                                          RequestCancelledError)):
                        raise
                    if isinstance(cause, HandoffAdoptError):
                        if discharged:
                            raise  # mid-stream: never replay tokens
                        logger.warning(
                            "handoff adopt failed (%s); falling back "
                            "to colocated stream on %r", cause,
                            self.name)
                        yield from self._stream_plain(
                            method, (request,), {}, model_id,
                            chunk_items,
                            (None if deadline is None
                             else deadline - time.monotonic()))
                        return
                raise
            finally:
                inner.close()
        raise last_err

    def _stream_plain(self, method: str, args: tuple, kwargs: dict,
                      model_id: str = "", chunk_items: int = 16,
                      timeout_s: Optional[float] = None):
        """Generator of streamed items from one replica: the replica's
        generator suspends between pulls (consumer-paced). The replica's
        in-flight slot and this router's count are held for the stream's
        lifetime (autoscaling sees streams as load).

        Replica death is retried (budget + backoff) only BEFORE the
        first item: once any token has been yielded the stream has
        observable state on the client, so a mid-stream retry would
        replay or corrupt it — the error propagates instead."""
        from contextlib import nullcontext

        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.util import tracing

        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        budget = max(1, rt_config.handle_retry_budget)
        spans = rt_config.serve_trace_spans
        self.wait_ready()
        prefix_hashes = _affinity_hashes(args)
        last_err: Optional[BaseException] = None
        for attempt in range(budget):
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceededError(
                    f"deadline expired before the stream to "
                    f"{self.name!r} started") from last_err
            replica = self._pick(model_id, prefix_hashes)
            if replica is None:
                raise RuntimeError(
                    f"deployment {self.name!r} has no replicas")
            handle = replica["handle"]
            sid = None
            try:
                try:
                    # The attempt span wraps only start_stream: the
                    # engine captures its trace context at submit (which
                    # runs inside this actor call), so a pre-first-item
                    # retry re-parents the replica-side work under the
                    # new attempt while the stream stays one trace.
                    with (tracing.trace("stream-attempt", attempt=attempt,
                                        replica=replica["id"])
                          if spans else nullcontext()):
                        sid = ray_tpu_torch.get(handle.start_stream.remote(
                            method, args, kwargs, model_id, remaining),
                            timeout=70.0)
                except (ActorDiedError, ActorUnavailableError) as e:
                    last_err = e
                    with self._lock:
                        self._replicas = [r for r in self._replicas
                                          if r["id"] != replica["id"]]
                    if attempt + 1 >= budget:
                        raise
                    pause = self._backoff_s(attempt)
                    if (deadline is not None
                            and time.monotonic() + pause >= deadline):
                        raise
                    self._count_retry()
                    time.sleep(pause)
                    continue
                while True:
                    items, done = ray_tpu_torch.get(handle.next_chunks.remote(
                        sid, chunk_items), timeout=70.0)
                    yield from items
                    if done:
                        sid = None
                        return
            finally:
                if sid is not None:  # consumer bailed early: free the
                    try:             # slot + cancel the engine request
                        handle.cancel_stream.remote(sid)
                    except Exception:
                        # Cancel undeliverable: the replica frees the
                        # slot at its deadline instead — slower, and a
                        # systematic failure here is a capacity leak.
                        log_every("router.cancel_stream", 10.0, logger,
                                  "stream cancel to replica failed",
                                  exc_info=True)
                self._release(replica)

    def stop(self) -> None:
        self._stop.set()
        self._pool.shutdown(wait=False)

    @classmethod
    def reset_all(cls) -> None:
        with cls._instances_lock:
            routers, cls._instances = dict(cls._instances), {}
        for router in routers.values():
            router.stop()


class DeploymentHandle:
    """Serializable handle: any process holding it (or just the deployment
    name) can route requests (reference: ``serve/handle.py:714``)."""

    def __init__(self, name: str, method: str = "__call__",
                 multiplexed_model_id: str = "",
                 timeout_s: Optional[float] = None):
        self._name = name
        self._method = method
        self._model_id = multiplexed_model_id
        self._timeout_s = timeout_s

    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                timeout_s: Optional[float] = None
                ) -> "DeploymentHandle":
        """Per-request options; ``timeout_s`` sets the end-to-end
        deadline propagated with every request made through the returned
        handle (router retries stop at it, the replica re-anchors it,
        and a DecodeEngine finishes the slot at it)."""
        return DeploymentHandle(
            self._name,
            method_name if method_name is not None else self._method,
            (multiplexed_model_id if multiplexed_model_id is not None
             else self._model_id),
            timeout_s if timeout_s is not None else self._timeout_s)

    def remote(self, *args, **kwargs) -> Future:
        return _Router.get(self._name).submit(
            self._method, args, kwargs, self._model_id,
            timeout_s=self._timeout_s)

    def stream(self, *args, **kwargs):
        """Iterate a generator-returning deployment method incrementally
        (reference: handle streaming / chunked HTTP responses)."""
        return _Router.get(self._name).stream(
            self._method, args, kwargs, self._model_id,
            timeout_s=self._timeout_s)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self._name, name, self._model_id,
                                self._timeout_s)

    def __reduce__(self):
        return (DeploymentHandle, (self._name, self._method, self._model_id,
                                   self._timeout_s))

    def __repr__(self):
        return f"DeploymentHandle({self._name!r}, {self._method!r})"
