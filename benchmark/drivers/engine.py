"""Serving cells: ``DecodeEngine`` under an open loop of requests.

Set-up makes the weights on the card from the seed (in the type they are
served in), builds the engine as the mix's ``engine`` block says, starts
``serve_forever`` on its own thread and warms up: ``warmup()``, then one
request per prompt length of the mix's ``warmup`` list (every prefill
bucket and the chunked path this cell's prompts take), then seats the
requests already in progress when the window opens (the mix's
``residents``) and waits for their first tokens. The window then opens:
a client thread submits each request when it is due, and the
engine's ``on_token`` callback stamps every token on the host's clock as
it reaches the client.

After the window the run waits (at most ``drain_s``) until every
request sent has its first token, stops the engine, reads the memory
peak, frees the program, and checks a sample of the finished requests
against the plain reference.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import serving, weights
from benchmark.harness.spec import Cell
from benchmark.harness.trace import LEAD_S, Tracer, attention_shapes, wrap
from benchmark.harness.traffic import (Request, mix_seed, residents,
                                       serve_schedule)
from benchmark.drivers.common import (DTYPES, free_device, llama_config,
                                      memory_peak, setup_parts)


def _submit(engine, req: Request, due: float) -> None:
    req.due = due

    def on_token(tok, r=req):
        r.times.append(time.monotonic())
        r.tokens.append(int(tok))

    try:
        req.handle = engine.submit(req.prompt,
                                   max_new_tokens=req.max_new_tokens,
                                   temperature=0.0, on_token=on_token)
    except Exception as e:  # noqa: BLE001 - a refused request is a result
        req.error = f"{type(e).__name__}: {e}"
    req.sent = time.monotonic()


class _Clock:
    """The open loop's clock: a request is due ``due_s`` after the window
    opened, plus the time the loop was held (:meth:`hold` to
    :meth:`release`), until :meth:`halt`."""

    def __init__(self, t0: float):
        self.t0, self.held = t0, 0.0
        self._cv = threading.Condition()
        self._since = None
        self._halted = False

    def hold(self) -> None:
        with self._cv:
            self._since = time.monotonic()

    def release(self) -> None:
        with self._cv:
            self.held += time.monotonic() - self._since
            self._since = None
            self._cv.notify_all()

    def halt(self) -> None:
        with self._cv:
            self._halted = True
            self._cv.notify_all()

    def wait_due(self, due_s: float) -> Optional[float]:
        """Wait until ``due_s`` is due; its host time, or ``None`` once
        halted."""
        with self._cv:
            while not self._halted:
                due = self.t0 + self.held + due_s
                if self._since is None and due <= time.monotonic():
                    return due
                self._cv.wait(None if self._since is not None
                              else max(0.0, due - time.monotonic()))
            return None


def _client(engine, reqs: List[Request], clock: _Clock) -> None:
    """The open loop: each request when it is due, however late the
    engine runs, until the clock is halted."""
    for req in reqs:
        due = clock.wait_due(req.due_s)
        if due is None:
            return
        _submit(engine, req, due)


# How far past the window a traced run's open loop reaches, beyond the
# profiler's lead and counted part.
TRACE_SLACK_S = 10.0


class _PoolWatch:
    """Peaks of the engine's page pool over the window, read every
    ``every`` seconds while the window waits: pages in use (``stats()``;
    they include the prefix index's cache of finished prompts), the pages
    that the keys and values of the requests being decoded fill (from
    the client's side: prompt and tokens so far of each request that has
    its first token and is not done), and requests decoding."""

    def __init__(self, engine, reqs: List[Request], page_tokens: int,
                 every: float = 0.5):
        self.engine, self.reqs, self.every = engine, reqs, every
        self.page_tokens = page_tokens
        self.peaks = {"pages_in_use": 0, "live_pages": 0, "active": 0}
        self.pages_total = None

    def sleep_until(self, t: float) -> None:
        while (left := t - time.monotonic()) > 0:
            time.sleep(min(left, self.every))
            self.sample()

    def sample(self) -> None:
        try:
            st = self.engine.stats()
        except RuntimeError:  # a table resized under the read: skip it
            return
        if "pages_in_use" not in st:
            return
        self.pages_total = st["pages_total"]
        t = self.page_tokens
        live = sum(-(-(len(r.prompt) + len(r.tokens)) // t)
                   for r in list(self.reqs) if r.times
                   and not r.handle.done.is_set())
        now = {"pages_in_use": st["pages_in_use"], "live_pages": live,
               "active": st["active"]}
        for k, v in now.items():
            self.peaks[k] = max(self.peaks[k], v)


def _answered(req: Request) -> bool:
    return bool(req.times) or req.error is not None or (
        req.handle is not None and req.handle.done.is_set())


def _warm(engine, mix, seed: int, vocab: int) -> None:
    rng = np.random.default_rng(mix_seed(seed, 4))
    spec = mix["warmup"]
    reqs = [Request(i, 0.0, rng.integers(0, vocab, n).astype(np.int32),
                    int(spec["output_tokens"]))
            for i, n in enumerate(spec["prompt_tokens"])]
    for r in reqs:
        _submit(engine, r, time.monotonic())
        if r.error:
            raise RuntimeError(f"warm-up request refused: {r.error}")
    for r in reqs:
        r.handle.done.wait()
        r.handle.raise_for_status()


def start(cell: Cell, seed: int, device: str, marks=None):
    """Set-up: the weights, the engine, its loop thread, the warm-up.
    Returns ``(engine, loop, tree, vocab)``. ``marks``, if given, gets
    the host time at the end of each part of it."""
    marks = {} if marks is None else marks
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, mix = cell.config, cell.traffic
    eng_kw = dict(mix["engine"])
    capacity = int(eng_kw.pop("capacity"))
    lcfg = llama_config(cfg, mix["model"], capacity)
    tree = weights.make(cfg, seed, lcfg.dtype, device)
    if device != "cpu":
        torch.cuda.synchronize()
    marks["weights"] = time.monotonic()
    engine = DecodeEngine(tree, lcfg, capacity=capacity,
                          step_timeline=1 << 20, device=device, **eng_kw)
    engine.warmup()
    marks["engine_warmup"] = time.monotonic()
    loop = threading.Thread(target=engine.serve_forever, name="engine",
                            daemon=True)
    loop.start()
    _warm(engine, mix, seed, lcfg.vocab_size)
    marks["warm_requests"] = time.monotonic()
    return engine, loop, tree, lcfg.vocab_size


def seat_residents(engine, reqs: List[Request], limit_s: float = 600.0
                   ) -> None:
    """Submit the requests already in progress when the window opens and
    wait until each has its first token."""
    for r in reqs:
        _submit(engine, r, time.monotonic())
    deadline = time.monotonic() + limit_s
    while not all(_answered(r) for r in reqs):
        if time.monotonic() > deadline:
            raise RuntimeError("resident requests were not all seated")
        time.sleep(0.02)


def window(engine, loop, reqs: List[Request], seconds: float,
           tracer: Tracer, trace_s: float, drain_s: float,
           device: str, held: List[Request] = (),
           lead_s: float = LEAD_S) -> Dict[str, float]:
    """Open the window, send ``reqs`` as they fall due, close it after
    ``seconds``, then wait up to ``drain_s`` for every first token of a
    request sent. With a trace, the window runs its ``seconds``
    unprofiled; then the profiler starts, which holds the interpreter
    for 10-25 s on an H100 host: the open loop is held meanwhile (its
    requests fall due that much later), so no burst of late requests
    follows. The profiler counts ``trace_s`` from ``lead_s`` after it
    has started, while the open loop goes on (``reqs`` must reach that
    far: :data:`TRACE_SLACK_S`); the client stops as the profiler
    does (stopping it holds the interpreter too). Without a trace the client sends every request, however late.
    Returns the window's clocks, its decode steps, the length and steps
    of its unprofiled part, and the page pool's peaks over the window
    (``pool``)."""
    if device != "cpu":
        torch.cuda.synchronize()
    steps0 = engine.stats()["steps"]
    t0, wall0 = time.monotonic(), time.time()
    clock = _Clock(t0)
    client = threading.Thread(target=_client, args=(engine, reqs, clock),
                              name="client", daemon=True)
    client.start()
    t_end = t0 + seconds
    watch = _PoolWatch(engine, list(held) + reqs, engine.page_tokens)
    watch.sleep_until(t_end)
    plain_steps = engine.stats()["steps"] - steps0
    if tracer.enabled:
        clock.hold()
        tracer.start()
        clock.release()
        watch.sleep_until(time.monotonic() + lead_s)
        tracer.count()
        watch.sleep_until(time.monotonic() + trace_s)
    steps1 = engine.stats()["steps"]
    if tracer.enabled:
        clock.halt()
        tracer.stop()
    client.join()
    deadline = time.monotonic() + drain_s
    while (time.monotonic() < deadline and loop.is_alive()
           and not all(_answered(r) for r in reqs if r.sent is not None)):
        time.sleep(0.02)
    return {"t0": t0, "wall0": wall0, "t_wait": time.monotonic(),
            "steps": steps1 - steps0, "plain_s": seconds,
            "plain_steps": plain_steps,
            "pool": dict(watch.peaks, pages_total=watch.pages_total)}


def pool_info(cfg, mix, pool) -> Dict[str, Any]:
    """The page pool's size and its peaks over the window, in pages and
    in bytes of keys and values: the pool is reserved whole at set-up
    (and counts whole in ``memory_peak_bytes``); the peaks say how much
    of it the traffic filled."""
    if pool["pages_total"] is None:
        return {}
    heads = int(cfg["num_attention_heads"])
    page = (int(mix["engine"]["page_tokens"]) * 2
            * int(cfg["num_hidden_layers"])
            * int(cfg["num_key_value_heads"])
            * (int(cfg["hidden_size"]) // heads)
            * DTYPES[mix["model"]["dtype"]].itemsize)
    return {"kv_pool_pages": pool["pages_total"],
            "kv_pool_bytes": pool["pages_total"] * page,
            "kv_pages_peak": pool["pages_in_use"],
            "kv_live_pages_peak": pool["live_pages"],
            "kv_live_bytes_peak": pool["live_pages"] * page,
            "active_peak": pool["active"]}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float, control: bool = False
        ) -> Tuple[Dict[str, Any], List[Tuple[str, float, float]],
                   Dict[str, Any]]:
    """One run of a serving cell: ``(result, compared numbers, obs)``.
    ``obs`` is what the per-layer readers read. With ``control`` the
    check also reads the control (the reference in float8) on the same
    sample, into ``info``."""
    import ray_tpu_torch.ops.flash_attention as fa

    cfg, mix = cell.config, cell.traffic
    marks = {"imports": time.monotonic()}
    engine, loop, tree, vocab = start(cell, seed, device, marks)
    held = residents(mix, seed, vocab)
    seat_residents(engine, held)
    marks["residents"] = time.monotonic()
    trace_s = float(mix.get("trace_seconds", seconds))
    lead_s = float(mix.get("trace_lead_seconds", LEAD_S))
    reqs = serve_schedule(mix, seconds + (lead_s + trace_s + TRACE_SLACK_S
                                          if trace else 0.0), seed, vocab)
    tracer = Tracer(trace)
    undo = wrap(tracer, fa, "flash_attention", "flash_fwd", attention_shapes)
    w = window(engine, loop, reqs, seconds, tracer, trace_s,
               float(mix.get("drain_s", 60.0)), device, held, lead_s)
    undo()
    # A traced run's open loop stops with the profiler: what it had not
    # sent by then was never due.
    reqs = [r for r in reqs if r.sent is not None]
    t0, wall0, t_wait = w["t0"], w["wall0"], w["t_wait"]
    setup_s = t0 - t_proc
    engine.shutdown()
    loop.join(timeout=120)
    rows = [r for r in engine.timeline()["rows"]
            if r["t1"] >= wall0 and r["t0"] <= wall0 + seconds]
    peak_bytes = memory_peak(device)
    finished = [r for r in reqs + held if r.handle is not None
                and r.handle.status == "completed"
                and len(r.tokens) == r.max_new_tokens]
    del engine, tree, loop
    free_device()

    # ----------------------------------------------------------- metrics
    sm = serving.summarize(reqs, t0, seconds, t_wait, held)
    failed = sm["failed"]
    e2e = {"setup_s": setup_s,
           **{k: sm[k] for k in ("itl_p95_ms", "serve_tokens_per_s")}}
    info = {"requests": len(reqs), "residents": len(held),
            "finished": len(finished),
            "steps": w["steps"],
            **{k: v for k, v in sm.items() if k not in e2e},
            **pool_info(cfg, mix, w["pool"]),
            "setup_parts_s": setup_parts(t_proc, marks, t0)}
    # Host-clock readings: over the window, which no profiler slows.
    obs = {"cell": cell, "window_s": w["plain_s"],
           "steps": w["plain_steps"],
           "trace": tracer.reduce(["flash_fwd"]) if trace else None,
           "requests": [{"prompt": len(r.prompt),
                         "times": [t - t0 for t in r.times]}
                        for r in reqs + held],
           "step_rows": [(r["t0"] - wall0, r["t1"] - wall0) for r in rows]}

    # --------------------------------------------------------- correct
    from benchmark.reference import llama as ref

    ref.exact_matmuls()
    rng = np.random.default_rng(mix_seed(seed, 3))
    gap, ctrl, sampled, served = 0.0, 0.0, 0, 0
    if finished:
        order = [finished[i] for i in rng.permutation(len(finished))]
        longest = max(finished, key=lambda r: len(r.prompt) + len(r.tokens))
        pick = [longest] + [r for r in order if r is not longest]
        rtree = weights.make(cfg, seed, DTYPES[mix["model"]["dtype"]],
                             device)
        want = int(mix["check"]["served_tokens"])
        for r in pick:
            if served >= want:
                break
            g = ref.served_gaps(rtree, cfg, r.prompt.tolist(), r.tokens,
                                device)
            gap = max(gap, float(g.max()))
            if control:
                ctrl = max(ctrl, float(ref.served_gaps(
                    rtree, cfg, r.prompt.tolist(), r.tokens, device,
                    prec="fp8", control=True).max()))
            sampled += 1
            served += len(r.tokens)
        del rtree
        free_device()
    info.update(checked_requests=sampled, checked_tokens=served)
    if control:
        info["control_logit_gap"] = ctrl
    checks = [("logit_gap", gap, float(cell.limits["logit_gap"])),
              ("unanswered", float(failed), 0.0)]
    correct = sampled > 0 and gap <= checks[0][2] and failed == 0
    result = {"correct": correct, "attempted": len(reqs), "failed": failed,
              "e2e": e2e, "info": info, "memory_peak_bytes": peak_bytes}
    return result, checks, obs
