"""Request-lifecycle fault tolerance in the port's serve plane: the 10
cases of ``tests/test_serve_lifecycle.py`` under the same names and
settings, the ``slow`` marks of its two cluster cases included.

Deadlines, cooperative cancellation, bounded admission and retry
budgets, on the reference's tiny config with the JAX package's weights
carried in (``torch_parity.tiny_pair``) and ``device="cpu"``. Where the
reference slows its jitted ``engine._decode``, these wrap the port
engine's one decode call a step, ``engine._decode_logits``.
"""

import json
import os
import signal
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core.errors import (DeadlineExceededError,
                                       OverloadedError,
                                       RequestCancelledError)
from torch_parity import one_torch_thread, tiny_pair  # noqa: F401
from torch_fixtures import ray_start_regular  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tiny():
    """The reference's tiny config with the JAX package's
    ``init_params(key(0))`` weights carried into the port, on the CPU."""
    _jcfg, _jp, cfg, params = tiny_pair()
    return cfg, params


@pytest.fixture
def serve_cluster(ray_start_regular):
    yield ray_start_regular
    try:
        serve.shutdown()
    except Exception:
        pass


# ------------------------------------------------------------- deadlines


def test_deadline_expired_at_submit_rejected():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=1, capacity=64,
                       prefix_pool_entries=0, device="cpu")
    with pytest.raises(DeadlineExceededError):
        eng.submit([1, 2], max_new_tokens=2, deadline_s=0.0)
    assert eng.stats()["deadline_exceeded"] == 1
    eng.shutdown()


def test_deadline_at_admission_never_touches_device():
    """A queued request whose deadline passes before a slot frees is
    retired at admission — no prefill is spent on it."""
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=1, capacity=64,
                       prefix_pool_entries=0, device="cpu")
    hog = eng.submit([1, 2, 3], max_new_tokens=40)
    eng.step()  # hog takes the only slot
    late = eng.submit([4, 5], max_new_tokens=5, deadline_s=0.05)
    time.sleep(0.6)  # expire while queued (past the purge throttle too)
    tokens_before = eng.tokens_out
    eng.step()
    assert late.done.is_set()
    assert late.status == "deadline_exceeded"
    assert late.slot == -1 and late.generated == 0
    with pytest.raises(DeadlineExceededError):
        late.raise_for_status()
    # The step decoded ONLY the hog's token: no device work for `late`.
    assert eng.tokens_out == tokens_before + 1
    assert eng.stats()["deadline_exceeded"] == 1
    assert not hog.done.is_set()
    eng.shutdown()


def test_deadline_mid_decode_frees_slot_healthy_unaffected():
    """An active request whose deadline passes mid-generation is finished
    with deadline_exceeded at the next step boundary; a healthy request
    decoding alongside completes bit-exactly."""
    from ray_tpu_torch.models import llama_decode
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=2, capacity=64,
                       prefix_pool_entries=0, device="cpu")
    doomed = eng.submit([6, 7], max_new_tokens=50, deadline_s=0.15)
    healthy = eng.submit([1, 2], max_new_tokens=20)
    while not doomed.done.is_set():
        eng.step()
        time.sleep(0.02)  # slow "device" so the deadline lands mid-decode
    assert doomed.status == "deadline_exceeded"
    assert 0 < doomed.generated < 50
    while not healthy.done.is_set():
        eng.step()
    assert healthy.status == "completed"
    solo = llama_decode.generate(
        params, __import__("numpy").array([[1, 2]], dtype="int32"), cfg,
        max_new_tokens=20, device="cpu")
    assert healthy.output == solo[0].tolist()
    s = eng.stats()
    assert s["free_slots"] == 2 and s["deadline_exceeded"] == 1
    eng.shutdown()


# ----------------------------------------------------------- cancellation


def test_cancel_queued_request_never_touches_device():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=1, capacity=64,
                       prefix_pool_entries=0, device="cpu")
    hog = eng.submit([1, 2, 3], max_new_tokens=30)
    eng.step()
    queued = eng.submit([4, 5], max_new_tokens=5)
    assert eng.cancel(queued.request_id)
    # Load drops IMMEDIATELY (autoscaler must not scale for dead queue
    # entries), before the loop even runs.
    assert eng.stats()["load"] == 1
    tokens_before = eng.tokens_out
    eng.step()
    assert queued.done.is_set() and queued.status == "cancelled"
    assert queued.slot == -1 and queued.generated == 0
    assert eng.tokens_out == tokens_before + 1  # only the hog stepped
    with pytest.raises(RequestCancelledError):
        queued.raise_for_status()
    assert not eng.cancel(queued.request_id)  # idempotent on finished
    eng.shutdown()


def test_cancel_active_frees_slot_within_one_step_and_prefix_pins():
    """Cancelling an active request frees its slot at the next step and
    leaves every prefix-pool row unpinned (refcounts back to zero)."""
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=2, capacity=64,
                       prefix_pool_entries=4, prefix_match_min_tokens=4,
                       device="cpu")
    # Seed the prefix pool with a long prompt, then hit it.
    seed = eng.submit(list(range(1, 25)), max_new_tokens=2)
    while not seed.done.is_set():
        eng.step()
    victim = eng.submit(list(range(1, 25)) + [30, 31], max_new_tokens=30)
    eng.step()  # admitted via the prefix-hit path
    assert victim.slot >= 0 and victim.prefix_len > 0
    assert eng.cancel(victim.request_id)
    eng.step()  # ONE step boundary frees the slot
    assert victim.done.is_set() and victim.status == "cancelled"
    assert eng.stats()["free_slots"] == 2
    assert eng.stats()["cancelled"] == 1
    # Every pool row's splice pin has been released.
    refcounts = [e.refcount for e in eng.prefix._entries.values()]
    assert refcounts and all(rc == 0 for rc in refcounts), refcounts
    eng.shutdown()


def test_stream_generator_close_cancels_engine_request():
    """Closing the deployment's streaming generator (what every client
    disconnect reduces to) cancels the engine request: the slot frees
    within one step of the running decode loop."""
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    cfg, _ = _tiny()
    dep = LlamaDecodeDeployment(config=cfg, slots=2, capacity=64,
                                prefix_pool_entries=0, device="cpu")
    # Slow the decode loop (~20 ms/token) so the stream cannot complete
    # before the close lands — the test is about cancellation, not speed.
    orig_decode = dep.engine._decode_logits

    def slow(*a, **k):
        time.sleep(0.02)
        return orig_decode(*a, **k)

    dep.engine._decode_logits = slow
    try:
        gen = dep.stream({"tokens": [5, 9, 2], "max_new_tokens": 60})
        first = next(gen)
        assert isinstance(first, int)
        gen.close()  # client went away
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s = dep.engine.stats()
            if s["active"] == 0 and s["cancelled"] == 1:
                break
            time.sleep(0.02)
        s = dep.engine.stats()
        assert s["active"] == 0 and s["free_slots"] == 2, s
        assert s["cancelled"] == 1, s
    finally:
        dep.engine.shutdown()


# ---------------------------------------------------------- load shedding


def test_queue_cap_sheds_fast_with_retry_after():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=1, capacity=64, queue_max=2,
                       prefix_pool_entries=0, device="cpu")
    hog = eng.submit([1, 2, 3], max_new_tokens=40)
    eng.step()
    eng.submit([4], max_new_tokens=4)
    eng.submit([5], max_new_tokens=4)
    t0 = time.perf_counter()
    with pytest.raises(OverloadedError) as ei:
        eng.submit([6], max_new_tokens=4)
    shed_latency = time.perf_counter() - t0
    # Acceptance bar is p99 < 50 ms; a single sample gets the same bound
    # (typical is ~microseconds — the check is qsize + raise, no device).
    assert shed_latency < 0.05, f"shed took {shed_latency * 1e3:.1f} ms"
    assert ei.value.retry_after_s > 0
    s = eng.stats()
    assert s["shed"] == 1
    assert s["queued"] <= s["queue_max"] == 2
    eng.shutdown()


def test_queue_default_cap_is_slots_x8():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=2, capacity=64,
                       prefix_pool_entries=0, device="cpu")
    assert eng.queue_max == 16
    eng.shutdown()


# ------------------------------------------------- through the serve stack


@pytest.mark.slow  # 18.5s: full proxy+handle sweep
@pytest.mark.timeout_s(240)
def test_deadline_and_overload_through_handle_and_proxy(serve_cluster):
    """Deadline + shedding end to end: handle timeout_s propagates into
    the engine (typed DeadlineExceededError back out), the queue cap
    maps to HTTP 503 + Retry-After, and a header deadline maps to 504."""
    import urllib.error
    import urllib.request

    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment
    from ray_tpu_torch.serve.proxy import _lifecycle_error

    cfg, _ = _tiny()

    class SlowDecode(LlamaDecodeDeployment):
        """The tiny model decodes at ~0.3 ms/step — too fast for wall-
        clock deadline/overload scenarios. Slow each decode step to
        20 ms so generations hold slots for seconds."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            orig = self.engine._decode_logits

            def slow(*args, **kwargs):
                time.sleep(0.02)
                return orig(*args, **kwargs)

            self.engine._decode_logits = slow

    serve.run(
        serve.deployment(SlowDecode).options(
            max_concurrency=8, max_ongoing_requests=64).bind(
            config=cfg, slots=1, capacity=128, queue_max=1,
            device="cpu"),
        name="llm_fault")
    handle = serve.get_deployment_handle("llm_fault")

    # Warm one request through (replica up, programs compiled).
    out = handle.remote({"tokens": [5, 9, 2],
                         "max_new_tokens": 2}).result(timeout=120)
    assert len(out["tokens"]) == 2

    # Deadline through the handle: a ~2.4 s generation against a 0.5 s
    # timeout_s comes back as a typed DeadlineExceededError, promptly.
    fut = handle.options(timeout_s=0.5).remote(
        {"tokens": [5, 9, 2], "max_new_tokens": 120})
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:
        fut.result(timeout=60)
    assert isinstance(_lifecycle_error(ei.value), DeadlineExceededError), \
        repr(ei.value)
    assert time.monotonic() - t0 < 30

    # Overload through the proxy: saturate the single slot + queue_max=1,
    # then a burst must see at least one 503 with Retry-After.
    host, port = serve.start_http()

    def post(payload, headers=None, timeout=60):
        req = urllib.request.Request(
            f"http://{host}:{port}/llm_fault",
            data=json.dumps(payload).encode(), headers=headers or {})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()

    # Stagger the hogs: hog1 must be ADMITTED (slot busy) before hog2 is
    # submitted, or hog2 itself gets shed by the queue_max=1 cap and the
    # burst below finds an empty queue.
    hogs = [threading.Thread(
        target=lambda: post({"tokens": [5, 9, 2], "max_new_tokens": 120},
                            timeout=120)) for _ in range(2)]
    hogs[0].start()
    time.sleep(0.6)  # hog1 admitted (decode loop idle-wait is 50 ms)
    hogs[1].start()
    time.sleep(0.6)  # hog2 parked in the pending queue (cap reached)
    saw_503 = None
    for _ in range(10):
        try:
            post({"tokens": [1, 2], "max_new_tokens": 2}, timeout=30)
        except urllib.error.HTTPError as e:
            if e.code == 503:
                saw_503 = e
                break
        time.sleep(0.1)
    assert saw_503 is not None, "no 503 under overload"
    assert int(saw_503.headers["Retry-After"]) >= 1
    for t in hogs:
        t.join()

    # Header deadline through the proxy: queue a long generation behind
    # a fresh hog with a 0.4 s budget -> 504 (the engine's typed
    # DeadlineExceeded mapped by the proxy).
    hog = threading.Thread(
        target=lambda: post({"tokens": [5, 9, 2], "max_new_tokens": 120},
                            timeout=120))
    hog.start()
    time.sleep(0.5)  # hog holds the slot for ~2.4 s
    with pytest.raises(urllib.error.HTTPError) as he:
        post({"tokens": [5, 9, 2], "max_new_tokens": 120},
             headers={"X-Request-Timeout-S": "0.4"}, timeout=60)
    assert he.value.code == 504
    hog.join()


# ------------------------------------------------------------------ chaos


@pytest.mark.chaos
@pytest.mark.slow  # 24 s: replica kill + reroute + heal
@pytest.mark.timeout_s(300)
def test_kill_replica_mid_decode_requests_reroute_and_heal(serve_cluster):
    """SIGKILL one of two decode replicas while non-streaming requests
    are in flight: (a) queued/in-flight requests re-route to the
    survivor within the handle retry budget and complete transparently,
    (b) the survivor ends with no wedged slots and zero prefix-pool
    pins, (c) the controller replaces the dead replica."""
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    cfg, _ = _tiny()

    class KillableDecode(LlamaDecodeDeployment):
        STEP_DELAY_S = 0.03  # ~1 s per 30-token generation

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            orig = self.engine._decode_logits

            def slow(*args, **kwargs):
                time.sleep(self.STEP_DELAY_S)
                return orig(*args, **kwargs)

            self.engine._decode_logits = slow

        def __call__(self, request):
            out = super().__call__(request)
            if isinstance(out, dict):
                out["pid"] = os.getpid()
            return out

        def pid(self, _=None):
            return os.getpid()

        def probe(self, _=None):
            s = self.engine.stats()
            refs = ([e.refcount for e in
                     self.engine.prefix._entries.values()]
                    if self.engine.prefix is not None else [])
            return {"free_slots": s["free_slots"], "active": s["active"],
                    "pid": os.getpid(), "refcounts": refs}

    serve.run(
        serve.deployment(KillableDecode, num_replicas=2).options(
            max_concurrency=8, max_ongoing_requests=32).bind(
            config=cfg, slots=2, capacity=128,
            prefix_pool_entries=4, prefix_match_min_tokens=4,
            device="cpu"),
        name="llm_chaos")
    handle = serve.get_deployment_handle("llm_chaos")

    # Find both replica pids (routing is load-balanced; poke until 2).
    pids = set()
    deadline = time.monotonic() + 120
    while len(pids) < 2 and time.monotonic() < deadline:
        pids.add(handle.options(method_name="pid").remote(None)
                 .result(timeout=60))
    assert len(pids) == 2, f"never saw both replicas: {pids}"

    # Seed the shared prefix: the victim is the replica that served it —
    # prefix-affinity steers the client wave there, so the SIGKILL lands
    # on a replica with decode work in flight.
    prompt = list(range(1, 21))
    warm = handle.remote({"tokens": prompt + [39],
                          "max_new_tokens": 2}).result(timeout=120)
    victim = warm["pid"]

    results = {}
    errors = []

    def client(i):
        try:
            out = handle.remote(
                {"tokens": prompt + [40 + i],
                 "max_new_tokens": 30}).result(timeout=180)
            results[i] = out["tokens"]
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.5)  # requests admitted and mid-decode
    os.kill(victim, signal.SIGKILL)
    for t in threads:
        t.join()

    # (a) every non-streaming request completed via retry.
    assert not errors, f"requests failed despite retry budget: {errors}"
    assert len(results) == 8
    assert all(len(v) == 30 for v in results.values())

    # (b) survivor: no wedged slots, prefix pins back to zero.
    deadline = time.monotonic() + 60
    probe = None
    while time.monotonic() < deadline:
        probe = handle.options(method_name="probe").remote(None).result(
            timeout=60)
        if probe["active"] == 0 and probe["free_slots"] == 2:
            break
        time.sleep(0.5)
    assert probe is not None and probe["active"] == 0, probe
    assert probe["free_slots"] == 2, probe
    assert all(rc == 0 for rc in probe["refcounts"]), probe

    # (c) the controller replaces the dead replica.
    deadline = time.monotonic() + 120
    while serve.status()["llm_chaos"]["replicas"] < 2:
        assert time.monotonic() < deadline, "replica never replaced"
        time.sleep(0.5)
