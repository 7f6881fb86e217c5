"""The port's disaggregated prefill/decode handoff on the CPU (tiny
models): the lease ledger against ``ray_tpu.serve.handoff``, the
runtime's object plane (one cluster for the module, as
``tests/test_disagg_serve.py`` runs under one), the engine's ``prefill_only`` capture and ``adopt``
scatter within the port, payloads carried between the port and the JAX
package's engine in both directions, and the deployment's two halves
(``tests/test_disagg_serve.py`` on the port).

Within the port a handoff stream equals the colocated stream exactly:
the same process runs the same computation at the same shapes, and the
adopt is a copy, so adopted pages equal the payload bit for bit. Across
packages the payload's K/V compare at rtol = atol = 1e-4 in float32 (the
same math summed in another order) and atol = 5e-2 in bf16 (activations
rounded to bf16 between layers on both sides), positions past the prompt
excluded (pad rows); streams after a cross-package adopt compare under the
margin rule (``torch_parity.assert_greedy_agrees``) at the same
tolerances. bf16 payloads cross bit for bit through a 16-bit view."""

import pickle
import time

import numpy as np
import pytest
import torch

from ray_tpu.serve import handoff as jhandoff
from ray_tpu.serve.decode import DecodeEngine as JaxEngine
from ray_tpu_torch.core import api
from ray_tpu_torch.core.config import config as tconfig
from ray_tpu_torch.core.errors import (DeadlineExceededError,
                                       HandoffAdoptError, ObjectFreedError,
                                       ObjectLostError,
                                       RequestCancelledError)
from ray_tpu_torch.serve import handoff as thandoff
from ray_tpu_torch.serve.decode import DecodeEngine, LlamaDecodeDeployment
from ray_tpu_torch.serve.metrics import slo_summary
from ray_tpu_torch.util.metrics import _Registry
from torch_parity import (assert_greedy_agrees, greedy_with_margins,
                          kv_from_numpy, kv_to_numpy, one_torch_thread,
                          tiny_pair)  # noqa: F401

VOCAB = 61
TOL = {"f32": 1e-4, "bf16": 5e-2}
pytestmark = pytest.mark.usefixtures("one_torch_thread", "runtime")


@pytest.fixture(scope="module")
def runtime():
    """The port's runtime for the module: ``put`` / ``get`` / ``free`` of
    the handoff's payloads go through its object store."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=2)
    yield
    rt.shutdown()


def _lost_ref():
    """A ref whose owner is gone (nothing listens at its address): the
    runtime's ``get`` raises ``ObjectLostError``."""
    import socket

    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.object_ref import ObjectRef

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return ObjectRef(ObjectID.from_random(), owner_addr=("127.0.0.1", port))


def _live_objects() -> int:
    """Objects the driver's store holds a value for (freed ones leave a
    tombstone, not a value)."""
    from ray_tpu_torch.core.runtime import get_core_worker

    store = get_core_worker().store
    with store._lock:
        return sum(1 for e in store._entries.values() if not e.freed
                   and (e.data is not None or e.shm_ref is not None))


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair("f32", max_seq_len=256)


def _engine(tp, tcfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("capacity", 128)
    kw.setdefault("page_tokens", 16)
    kw.setdefault("prefix_pool_entries", 0)
    return DecodeEngine(tp, tcfg, device="cpu", **kw)


def _drive(eng, reqs, budget=500):
    for _ in range(budget):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError(f"requests not done in {budget} steps: "
                         f"{[r.status for r in reqs]}")


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).tolist() for n in lengths]


def _adopt_payload(req):
    """The engine-level payload shaped as ``submit(adopt=...)`` takes it,
    as the deployment's ``_fetch_adopt`` builds it."""
    assert req.handoff is not None, "prefill_only request captured nothing"
    return {k: req.handoff[k] for k in ("k", "v", "committed_len",
                                        "first_token", "page_tokens")}


def _run(eng, prompt, n, **kw):
    req = eng.submit(prompt, max_new_tokens=n, **kw)
    _drive(eng, [req])
    return req


def _handoff(pre, dec, prompt, n, **kw):
    """prefill_only on ``pre``, adopt on ``dec``: (prefill req, adopted
    req)."""
    r1 = _run(pre, prompt, n, prefill_only=True)
    assert r1.status == "completed" and r1.output == []
    return r1, _run(dec, prompt, n, adopt=_adopt_payload(r1), **kw)


def _drained(eng):
    s = eng.stats()
    assert s["active"] == s["prefilling"] == s["queued"] == 0, s
    assert s["pages_free"] + s["pages_pinned"] == s["pages_total"], s
    assert s["free_slots"] == s["slots"], s


# ------------------------------------------------------------ the ledger


def _lease_script(mod):
    """``test_disagg_serve.py``'s lease test as a trace of results."""
    led = mod.HandoffLedger(ttl_s=30.0)
    desc = {"handoff_id": "h1", "nbytes": 4096, "page_tokens": 16}
    trace = [led.publish_handoff(desc) is desc, led.live(),
             led.live_bytes(), mod.descriptor_nbytes(desc),
             mod.HANDOFF_DESC_BYTE_BUDGET, mod.HandoffLedger()._ttl_s]
    entry = led.discharge_handoff("h1")
    trace += [entry["desc"] is desc, entry["age_s"] >= 0,
              led.discharge_handoff("h1"), led.live()]
    led.publish_handoff({"handoff_id": "h2", "nbytes": 1})
    led.publish_handoff({"handoff_id": "h3"})
    trace += [led.live(), led.live_bytes(), led.sweep()]
    expired = led.sweep(now=time.monotonic() + 31.0)
    trace += [sorted(e["desc"]["handoff_id"] for e in expired),
              all(e["age_s"] > 30.0 for e in expired), led.live(),
              led.live_bytes(), led.sweep(now=time.monotonic() + 99.0)]
    return trace


def test_ledger_matches_jax():
    """Publish, idempotent discharge, the TTL sweep, ``live`` and
    ``live_bytes``: the same results as the JAX ledger, step by step."""
    t = _lease_script(thandoff)
    assert t == _lease_script(jhandoff)
    assert t[1:3] == [1, 4096] and t[4:6] == [8192, 60.0]
    assert t[-5:] == [["h2", "h3"], True, 0, 0, []]


# ---------------------------------------------------- the object plane


def test_object_plane_stand_in():
    """put / get / free on the runtime's object store: ``get`` returns an
    equal value (a tensor read back from the store), a ref pickles to its
    id and owner, a descriptor of two refs stays far under the budget
    whatever the payload, a freed ref raises ``ObjectFreedError`` and a
    ref whose owner is gone ``ObjectLostError``."""
    big = torch.randn(1 << 18)  # 1 MiB: the shared-memory path
    k, v = api.put(big), api.put("v")
    got = api.get(k)
    assert got is not big and torch.equal(got, big)
    assert got.dtype == big.dtype and got.shape == big.shape
    both = api.get([k, v])
    assert torch.equal(both[0], big) and both[1] == "v"
    again = pickle.loads(pickle.dumps(k))
    assert again == k and hash(again) == hash(k)
    assert torch.equal(api.get(again), big)
    desc = {"handoff_id": "0123456789abcdef", "k_ref": k, "v_ref": v,
            "committed_len": 1500, "first_token": 7, "page_tokens": 64,
            "nbytes": 805306368, "prefill_ttft_s": 0.25}
    assert thandoff.descriptor_nbytes(desc) < 512
    api.free([k, None])
    api.free(k)  # twice: a no-op
    with pytest.raises(ObjectFreedError):
        api.get(k, timeout=10)
    with pytest.raises(ObjectFreedError):
        api.get([v, k], timeout=10)
    with pytest.raises(ObjectLostError):
        api.get(_lost_ref(), timeout=10)
    api.free(v)


# ------------------------------------------------ handoff in the port


def test_handoff_streams_equal_colocated(tiny):
    """Prompts of 3, 18 and 40 tokens on 16-token pages (1, 2 and 3
    pages): the first token rides the payload, and the adopted stream is
    the colocated stream, first token included. The decode engine runs
    no prefill of its own."""
    _, _, tcfg, tp = tiny
    pre, dec, col = (_engine(tp, tcfg) for _ in range(3))
    for prompt in _prompts(1, 3, 18, 40):
        want = _run(col, prompt, 8).output
        r1, r2 = _handoff(pre, dec, prompt, 8)
        payload = r1.handoff
        assert payload["committed_len"] == len(prompt)
        assert payload["first_token"] == want[0]
        assert payload["page_tokens"] == 16
        assert tuple(payload["k"].shape) == (
            tcfg.n_layers, -(-len(prompt) // 16), 16, tcfg.n_kv_heads,
            tcfg.head_dim)
        assert payload["nbytes"] == 2 * payload["k"].nbytes
        assert r2.output == want, (r2.output, want)
    ps, ds = pre.stats(), dec.stats()
    assert ps["handoffs_published"] == ds["handoffs_adopted"] == 3
    assert ds["prefill_waves"] == ds["suffix_waves"] == 0
    assert ds["prefill_chunks"] == 0 and ds["tokens_out"] == 24
    assert ps["tokens_out"] == 0
    for eng in (pre, dec, col):
        _drained(eng)


def test_handoff_with_chunked_prefill_and_prefix_hits(tiny):
    """The prefill side chunks a 40-token prompt (16-token chunks), then
    hits its prefix index on the same prompt; both adopted streams equal
    a colocated engine's on the same sequence. A later prompt sharing
    the prefix hits the decode side's index on the ADOPTED pages."""
    _, _, tcfg, tp = tiny
    kw = dict(prefill_chunk_tokens=16, prefix_pool_entries=4,
              prefix_match_min_tokens=4)
    pre, col = _engine(tp, tcfg, **kw), _engine(tp, tcfg, **kw)
    dec = _engine(tp, tcfg, prefix_pool_entries=4, prefix_match_min_tokens=4)
    (prompt,) = _prompts(2, 40)
    for _ in range(2):  # a miss (chunked), then a prefix hit
        want = _run(col, prompt, 6).output
        _, r2 = _handoff(pre, dec, prompt, 6)
        assert r2.output == want
    assert pre.prefill_chunks >= 2 and pre.prefix.stats()["hits"] == 1
    assert col.prefix.stats()["hits"] == 1
    longer = prompt + [44, 45]
    got = _run(dec, longer, 6).output
    assert dec.prefix.stats()["hits"] == 1
    assert got == _run(col, longer, 6).output
    for eng in (pre, dec, col):
        _drained(eng)


def test_adopted_pages_equal_payload(tiny):
    """Right after the adopt, the slot's pages hold the payload bit for
    bit (every position of every page, pad rows included) and its cursor
    sits at the committed length."""
    _, _, tcfg, tp = tiny
    pre, dec = _engine(tp, tcfg), _engine(tp, tcfg, pool_pages=12)
    seen = []
    seat = dec._seat_adopted

    def checked(req):
        payload = req.adopt
        ok = seat(req)
        ids = torch.as_tensor(dec._slot_pages[req.slot])
        seen.append((ok, all(torch.equal(dec.cache[n][:, ids], payload[n])
                             for n in ("k", "v")),
                     int(dec.cache["length"][req.slot])))
        return ok

    dec._seat_adopted = checked
    (prompt,) = _prompts(3, 40)
    _handoff(pre, dec, prompt, 4)
    assert seen == [(True, True, 40)]


def test_payload_owns_its_bytes(tiny):
    """The captured payload is a tensor of its own, not a view of the
    pool: later in-place pool writes (another request on the freed
    pages) leave a published payload unchanged."""
    _, _, tcfg, tp = tiny
    pre = _engine(tp, tcfg)
    (p1, p2) = _prompts(4, 18, 18)
    r1 = _run(pre, p1, 4, prefill_only=True)
    for key in ("k", "v"):
        t = r1.handoff[key]
        assert t.device.type == "cpu" and t.is_contiguous() and t._base is None
        assert (t.untyped_storage().data_ptr()
                != pre.cache[key].untyped_storage().data_ptr())
    k0, v0 = r1.handoff["k"].clone(), r1.handoff["v"].clone()
    r2 = _run(pre, p2, 4)
    assert r2.status == "completed"
    assert torch.equal(k0, r1.handoff["k"])
    assert torch.equal(v0, r1.handoff["v"])


def test_adopt_validation_rejects_before_enqueue(tiny):
    """A payload this pool cannot splice raises ``HandoffAdoptError`` at
    submit (never a wrong-K/V decode), and nothing is enqueued."""
    _, _, tcfg, tp = tiny
    pre = _engine(tp, tcfg)
    (prompt,) = _prompts(5, 18)
    good = _adopt_payload(_run(pre, prompt, 4, prefill_only=True))
    dec = _engine(tp, tcfg)
    bad = {
        "page_tokens": ({"page_tokens": 32}, prompt),
        "committed_len": ({}, prompt + [3]),
        "does not fit": ({"k": good["k"][:, :1]}, prompt),
        "pool": ({"v": good["v"].double()}, prompt),
    }
    for match, (change, tokens) in bad.items():
        with pytest.raises(HandoffAdoptError, match=match):
            dec.submit(tokens, max_new_tokens=4, adopt={**good, **change})
    with pytest.raises(HandoffAdoptError, match="does not fit"):
        dec.submit(prompt, max_new_tokens=4,
                   adopt={**good, "k": good["k"].numpy()})
    with pytest.raises(HandoffAdoptError, match="page_tokens"):
        _engine(tp, tcfg, page_tokens=32).submit(prompt, max_new_tokens=4,
                                                 adopt=good)
    unpaged = _engine(tp, tcfg, page_tokens=0)
    with pytest.raises(HandoffAdoptError, match="paged"):
        unpaged.submit(prompt, max_new_tokens=4, adopt=good)
    with pytest.raises(ValueError, match="paged"):
        unpaged.submit(prompt, max_new_tokens=4, prefill_only=True)
    for eng in (dec, unpaged):
        assert eng.stats()["queued"] == 0 and not eng._requests


def test_dry_pool_requeues_adopt_in_order(tiny):
    """An adopt the pool cannot seat goes back to the front of the queue
    with everything behind it, in order, and is seated first once the
    pages free; the active request is not preempted for it."""
    _, _, tcfg, tp = tiny
    kw = dict(slots=3, capacity=64, page_tokens=8)
    pre, dec = _engine(tp, tcfg, **kw), _engine(tp, tcfg, pool_pages=6, **kw)
    x_prompt, a_prompt, b_prompt = _prompts(6, 30, 20, 5)
    x = dec.submit(x_prompt, max_new_tokens=16)
    dec.step()  # x holds 4 of the 6 pages
    r1 = _run(pre, a_prompt, 6, prefill_only=True)
    a = dec.submit(a_prompt, max_new_tokens=6, adopt=_adopt_payload(r1))
    b = dec.submit(b_prompt, max_new_tokens=6)
    dec.step()  # a needs 3 pages: dry, so a and b wait, in order
    assert dec._requeue == [a, b] and a.slot == b.slot == -1
    assert a.adopt is not None and not a.admitted
    _drive(dec, [x, a, b])
    assert dec.preempted == 0 and dec.handoffs_adopted == 1
    assert x.finished_at <= a.admitted_at <= b.admitted_at
    for prompt, req in ((a_prompt, a), (b_prompt, b), (x_prompt, x)):
        want, margins = greedy_with_margins(tcfg, tp, prompt,
                                            req.max_new_tokens)
        assert_greedy_agrees(req.output, want, margins, TOL["f32"])
    _drained(dec)


def test_cancel_and_deadline_mid_handoff_free_pages_both_sides(tiny):
    """Prefill-only and adopted requests cancelled or expired at each
    point of their life leave both pools drained."""
    _, _, tcfg, tp = tiny
    pre, dec = _engine(tp, tcfg), _engine(tp, tcfg)
    (prompt,) = _prompts(7, 34)
    for _ in range(3):
        # (a) prefill_only cancelled while queued: never seated.
        ra = pre.submit(prompt, max_new_tokens=4, prefill_only=True)
        assert pre.cancel(ra.request_id)
        # (b) a handoff that completes; its adopted request is cancelled
        # mid-decode on the far side.
        rb = pre.submit(prompt, max_new_tokens=20, prefill_only=True)
        _drive(pre, [ra, rb])
        with pytest.raises(RequestCancelledError):
            ra.raise_for_status()
        assert ra.handoff is None
        rc = dec.submit(prompt, max_new_tokens=20, adopt=_adopt_payload(rb))
        dec.step()
        assert rc.generated >= 1 and dec.cancel(rc.request_id)
        # (c) an adopted request whose deadline passes while it waits.
        rd = dec.submit(prompt, max_new_tokens=50, adopt=_adopt_payload(rb),
                        deadline_s=0.05)
        time.sleep(0.06)
        _drive(dec, [rc, rd])
        with pytest.raises(RequestCancelledError):
            rc.raise_for_status()
        with pytest.raises(DeadlineExceededError):
            rd.raise_for_status()
    for eng in (pre, dec):
        s = eng.stats()
        assert s["pages_in_use"] == 0 and s["pages_free"] == s["pages_total"]
        _drained(eng)


def test_spec_engine_seats_the_draft_on_adoption(tiny):
    """A speculative decode engine (the target as its own draft, k = 2)
    seats an adopted request's draft: a draft prefill of the prompt,
    then rounds that accept every proposal, and both pools drain."""
    _, _, tcfg, tp = tiny
    pre = _engine(tp, tcfg)
    dec = _engine(tp, tcfg, spec_draft_params=tp, spec_draft_config=tcfg,
                  spec_k=2, step_timeline=64)
    seated = []
    seat = dec._draft_seat

    def recorded(reqs):
        seated.extend(r.request_id for r in reqs)
        return seat(reqs)

    dec._draft_seat = recorded
    (prompt,) = _prompts(8, 21)
    _, r2 = _handoff(pre, dec, prompt, 12)
    assert seated == [r2.request_id]
    spec = dec.stats()["spec"]
    assert spec["rounds"] > 0 and spec["accept_rate"] == 1.0
    assert spec["draft_pages_free"] == spec["draft_pages_total"]
    phases = [p["phase"] for row in dec.timeline()["rows"]
              for p in row["phases"]]
    assert phases.index("handoff") < phases.index("draft-prefill")
    want, margins = greedy_with_margins(tcfg, tp, prompt, 12)
    assert_greedy_agrees(r2.output, want, margins, TOL["f32"])
    _drained(dec)


def test_handoff_timeline_phase_and_events(tiny):
    """Both sides record a ``handoff`` phase in the step's row, with the
    capture's ``handoff`` event (pages, bytes) and the adopt's
    ``handoff-adopt`` event (pages, committed length)."""
    _, _, tcfg, tp = tiny
    pre = _engine(tp, tcfg, step_timeline=64)
    dec = _engine(tp, tcfg, step_timeline=64)
    (prompt,) = _prompts(9, 40)
    r1, _ = _handoff(pre, dec, prompt, 4)
    for eng, event, want in (
            (pre, "handoff", {"pages": 3, "nbytes": r1.handoff["nbytes"]}),
            (dec, "handoff-adopt", {"pages": 3, "committed": 40})):
        rows = eng.timeline()["rows"]
        phases = [p for r in rows for p in r["phases"]
                  if p["phase"] == "handoff"]
        assert len(phases) == 1 and phases[0]["pages"] == 3
        assert phases[0]["t1"] >= phases[0]["t0"]
        events = [e for r in rows for e in r.get("events", [])
                  if e["kind"] == event]
        assert len(events) == 1, rows
        assert all(events[0][k] == v for k, v in want.items()), events


# ------------------------------------------------- across the packages


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_payload_bits_cross_packages(dtype):
    """A payload tensor crosses to the JAX package's array and back bit
    for bit, and the other way round."""
    rng = np.random.default_rng(10)
    t = torch.from_numpy(rng.standard_normal((2, 3, 4, 2, 8)).astype(
        np.float32))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    a = kv_to_numpy(t)
    assert a.dtype.name == ("bfloat16" if dtype == "bf16" else "float32")
    back = kv_from_numpy(a)
    assert back.dtype == t.dtype and torch.equal(
        back.view(torch.int16 if dtype == "bf16" else torch.int32),
        t.view(torch.int16 if dtype == "bf16" else torch.int32))
    assert np.array_equal(kv_to_numpy(back).view(np.uint8), a.view(np.uint8))


def _tokens(a, clen):
    """(L, pages, T, KV, D) -> the prompt's positions, as float32."""
    a = np.asarray(a, np.float32)
    return a.reshape(a.shape[0], -1, *a.shape[3:])[:, :clen]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_handoff_across_packages(dtype):
    """Same tiny weights and prompt on both packages: the port's captured
    payload matches the JAX engine's; a JAX payload adopted by the port
    and a port payload adopted by the JAX engine each decode, under the
    margin rule, as the other package's colocated stream."""
    jcfg, jp, tcfg, tp = tiny_pair(dtype, max_seq_len=256)
    tol = TOL[dtype]
    kw = dict(slots=2, capacity=128, page_tokens=16, prefix_pool_entries=0)
    jeng, teng = JaxEngine(jp, jcfg, **kw), _engine(tp, tcfg)
    (prompt,) = _prompts(11, 40)
    n = 8
    jr = jeng.submit(prompt, max_new_tokens=n, prefill_only=True)
    _drive(jeng, [jr])
    tr = _run(teng, prompt, n, prefill_only=True)
    jpay, tpay = jr.handoff, tr.handoff
    for key in ("committed_len", "page_tokens", "nbytes"):
        assert tpay[key] == jpay[key], key
    for key in ("k", "v"):
        assert tuple(tpay[key].shape) == jpay[key].shape
        np.testing.assert_allclose(
            _tokens(kv_to_numpy(tpay[key]), len(prompt)),
            _tokens(jpay[key], len(prompt)), rtol=tol, atol=tol)
    _, margins = greedy_with_margins(tcfg, tp, prompt, n)
    if margins[0] > tol:
        assert tpay["first_token"] == jpay["first_token"]
    # Colocated streams of both packages.
    jcol = jeng.submit(prompt, max_new_tokens=n)
    _drive(jeng, [jcol])
    tcol = _run(teng, prompt, n)
    # The JAX payload into the port, the port's into the JAX engine.
    t_from_j = _run(teng, prompt, n, adopt={
        **{k: jpay[k] for k in ("committed_len", "first_token",
                                "page_tokens")},
        "k": kv_from_numpy(jpay["k"]), "v": kv_from_numpy(jpay["v"])})
    j_from_t = jeng.submit(prompt, max_new_tokens=n, adopt={
        **{k: tpay[k] for k in ("committed_len", "first_token",
                                "page_tokens")},
        "k": kv_to_numpy(tpay["k"]), "v": kv_to_numpy(tpay["v"])})
    _drive(jeng, [j_from_t])
    assert t_from_j.output[0] == jpay["first_token"]
    assert j_from_t.output[0] == tpay["first_token"]
    assert_greedy_agrees(t_from_j.output, jcol.output, margins, tol)
    assert_greedy_agrees(j_from_t.output, tcol.output, margins, tol)
    assert teng.stats()["handoffs_adopted"] == 1
    assert jeng.stats()["handoffs_adopted"] == 1


# ------------------------------------------------------ the deployment


@pytest.fixture
def handoff_ttl():
    """Set ``serve_handoff_ttl_s`` for deployments built in the test."""
    old = tconfig.serve_handoff_ttl_s
    yield lambda s: tconfig.update({"serve_handoff_ttl_s": s})
    tconfig.update({"serve_handoff_ttl_s": old})


def _deployments(tcfg, tag, n=3):
    return [LlamaDecodeDeployment(config=tcfg, slots=2, capacity=128,
                                  kv_page_tokens=16, prefix_pool_entries=0,
                                  metrics_deployment=f"{tag}-{i}",
                                  device="cpu") for i in range(n)]


def _slo(tag):
    return slo_summary({"local": _Registry.get().snapshot()}).get(tag, {})


def test_deployment_unary_and_stream_adopt(tiny):
    """The two halves on the runtime's object plane: a descriptor of a
    few hundred bytes, a unary and a streaming adopt equal to the
    colocated answers, the leases discharged, and ``replica_metrics``
    with the handoff fields and the lease metrics."""
    _, _, tcfg, _ = tiny
    tag = f"dep-{time.monotonic_ns()}"
    pre, dec, col = _deployments(tcfg, tag)
    objects = _live_objects()
    try:
        p1, p2 = _prompts(12, 18, 33)
        req = {"tokens": p1, "max_new_tokens": 6}
        desc = pre.prefill_handoff(req)
        assert thandoff.descriptor_nbytes(desc) < 512
        assert desc["nbytes"] == 2 * api.get(desc["k_ref"]).nbytes
        assert _live_objects() == objects + 2
        out = dec.decode_adopted(req, desc)
        pre.discharge_handoff(desc["handoff_id"])
        assert out == {"tokens": col(req)["tokens"],
                       "ttft_s": desc["prefill_ttft_s"]}
        assert out["tokens"][0] == desc["first_token"]
        req2 = {"tokens": p2, "max_new_tokens": 5, "stream": True}
        desc2 = pre.prefill_handoff(req2)
        stream = dec.stream_adopted(req2, desc2)
        got = [next(stream)]
        pre.discharge_handoff(desc2["handoff_id"])  # adopted: ack now
        got += list(stream)
        assert got == list(col(req2))
        assert _live_objects() == objects
        pre.set_topology({"slice_id": "s0", "hosts": 1})
        rm, dm = pre.replica_metrics(), dec.replica_metrics()
        assert rm["handoffs_published"] == 2 and rm["handoffs_live"] == 0
        assert rm["handoff_live_bytes"] == 0 and rm["slice_id"] == "s0"
        assert dm["handoffs_adopted"] == 2 and dm["handoffs_published"] == 0
        assert (dm["chips"], dm["mesh_shape"]) == (1, None)
        for key in ("pages_total", "pages_free", "pages_in_use",
                    "pages_pinned", "kv_fragmentation", "preempted",
                    "load", "queued", "shed", "prefill_backlog_tokens"):
            assert key in dm, key
        s = _slo(f"{tag}-0")
        assert s["handoffs"] == {"published": 2, "adopted": 2}
        assert s["handoff_latency_s"]["count"] == 2
        assert s["handoff_bytes"]["count"] == 2
        assert s["handoff_bytes"]["p99"] <= 512
        assert _slo(f"{tag}-1")["outcomes"] == {"completed": 2}
    finally:
        for d in (pre, dec, col):
            d.shutdown()


def test_deployment_dead_leases(tiny, handoff_ttl):
    """A freed or unknown ref fails the adopt with ``HandoffAdoptError``;
    a refused adopt is aborted; a lease nobody discharges expires in the
    sweep ``replica_metrics`` runs; abort and expiry free the refs, and
    a late discharge counts nothing twice."""
    _, _, tcfg, _ = tiny
    tag = f"dead-{time.monotonic_ns()}"
    handoff_ttl(0.05)
    pre, dec = _deployments(tcfg, tag, n=2)
    try:
        (prompt,) = _prompts(13, 18)
        req = {"tokens": prompt, "max_new_tokens": 4}
        desc = pre.prefill_handoff(req)
        with pytest.raises(HandoffAdoptError, match="page_tokens"):
            dec.decode_adopted(req, {**desc, "page_tokens": 8})
        pre.abort_handoff(desc["handoff_id"])
        with pytest.raises(ObjectFreedError):
            api.get(desc["k_ref"])
        with pytest.raises(HandoffAdoptError, match="unavailable") as e:
            dec.decode_adopted(req, desc)
        assert isinstance(e.value.__cause__, ObjectFreedError)
        with pytest.raises(HandoffAdoptError) as e:
            dec.decode_adopted(req, {**desc,
                                     "k_ref": _lost_ref()})
        assert isinstance(e.value.__cause__, ObjectLostError)
        expiring = pre.prefill_handoff(req)
        assert pre.replica_metrics()["handoffs_live"] == 1
        time.sleep(0.1)
        rm = pre.replica_metrics()
        assert rm["handoffs_live"] == 0 and rm["handoff_live_bytes"] == 0
        with pytest.raises(ObjectFreedError):
            api.get(expiring["v_ref"])
        pre.discharge_handoff(expiring["handoff_id"])  # late: a no-op
        pre.abort_handoff(desc["handoff_id"])
        assert _slo(f"{tag}-0")["handoffs"] == {
            "published": 2, "aborted": 1, "expired": 1}
        assert dec.engine.stats()["queued"] == 0
        assert "outcomes" not in _slo(f"{tag}-1")
    finally:
        pre.shutdown()
        dec.shutdown()
