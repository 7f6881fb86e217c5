"""Continuous-batching decode engine (port of ``ray_tpu/serve/decode.py``:
the contiguous and the paged KV engine, chunked prefill, recompute
preemption, the device sampler, speculative decoding, warmup, the step
timeline, the serve SLO metrics and the disaggregated prefill/decode
handoff).

* Contiguous mode: one KV cache of ``slots`` rows x ``capacity`` tokens,
  allocated once. Requests join and leave the running batch between
  decode steps: admission prefills a wave of prompts into free slots,
  then one ``decode_step`` advances every slot together.
* Paged mode (``page_tokens > 0``): one pool of ``pool_pages`` pages
  shared by all slots, addressed through per-slot block tables
  (``serve.paging.PageAllocator``). A slot holds only the pages its
  sequence covers, so the pool may be overcommitted; when it runs dry the
  engine unpins prefix pages, then preempts the youngest request, whose
  prompt plus emitted tokens re-enter the queue as one prefill
  (recompute preemption). Prompts longer than ``prefill_chunk_tokens``
  prefill one chunk per step between decode steps.
* Prefix cache: contiguous mode keeps a device pool of cached prompt
  prefixes indexed by a host-side trie (``serve.prefix_cache``); paged
  mode pins the pages themselves (``serve.paging.PagedPrefixIndex``), so
  an insert and a hit are block-table edits with no device copy. A miss
  is a full prefill, whose attention is the config's impl (the Hopper
  flash kernel with ``attention_impl="flash"``); a hit prefills only the
  suffix, with plain masked attention.
* Every cache update is in place: admission writes its slots' rows or
  pages, decode writes one position per slot. The JAX engine gets the
  same effect by donating the cache to each program.
* Prompts pad to power-of-two length buckets, as in the JAX engine (the
  flash kernel's block checks want them). Wave sizes are not padded: the
  JAX engine pads them to bound its compiled-program set, which eager
  PyTorch does not have, so no pad row is ever scattered. Paged decode
  gathers only the block-table columns the live slots reach, the
  counterpart of the contiguous path's ``lim``.
* The device sampler (``device_sampler=True``) samples inside the step
  (``llama_decode.sample_batch``) from a ``torch.Generator`` seeded from
  the step counter, so runs repeat; only (slots,) token ids reach the
  host.
* Speculative decoding (paged mode, ``spec_k > 0`` and a draft model): a
  draft model with its own page pool and block tables proposes ``spec_k``
  tokens a slot, the target scores all ``spec_k + 1`` positions in one
  ``paged_verify`` forward, the host accepts the longest prefix that
  equals the target's argmaxes plus the target's next token, and both
  pools' cursors and tail pages roll back over the rejected rest.
* The step timeline (``serve.steplog``) keeps one row a step: its phases
  and batch occupancy, with page, preemption, demotion, handoff and
  first-dispatch events.
* SLO metrics (``serve.metrics``) are observed per REQUEST only: the
  shed and expired-deadline outcomes at submit, queue wait at first
  admission, preemptions, and at the terminal step the outcome, TTFT,
  inter-token time and the speculative counters. Nothing is observed per
  token or per step.
* Disaggregated handoff (paged mode): a ``prefill_only`` request ends at
  its first token with its pages copied to the host as the handoff
  payload (``_capture_handoff``); another engine ``adopt``s the payload,
  scattering it into fresh pages with no model math (``_seat_adopted``),
  and decodes from the handed-off first token. ``LlamaDecodeDeployment``
  publishes payloads as leases on the runtime's object store
  (``core.api``) and the ledger of ``serve.handoff``; the router splices
  the two halves across fleets (``serve.deployment``).

* Decode mesh (``mesh_shape`` / ``mesh``, or the ``decode_mesh_shape``
  knob): one replica over a ``(batch, model)`` mesh of ranks, one process
  a card, each running this engine on its local shards of the weights
  and the KV state (``llama_decode.shard_decode_state``); logits come
  back whole on every rank. Rank 0 alone takes ``submit`` and
  ``cancel`` and reads the clock; every step it broadcasts the step's
  intake, cancels, expired deadlines and stop (``serve.spmd.Lockstep``),
  so all ranks take the same decisions and issue the same collectives.
  Requests, outputs and metrics live on rank 0.
* Request traces (``trace_spans`` or the ``serve_trace_spans`` knob): a
  request submitted under an active trace context (``util.tracing``)
  gets the JAX engine's engine-side spans recorded into it: queue-wait,
  the device waves it rode (prefill, suffix-prefill, prefill-chunk,
  adopt, draft-prefill), preempt and engine-shed markers, its decode
  slice and the whole engine-request.

Single-threaded by design: ``serve_forever`` is the only consumer; intake
(``submit``/``cancel``) is thread-safe, and an adopt payload rides its
request into the loop thread, which alone touches the pool. Not ported
yet (ROADMAP.md queue 1, item 4): the mesh replica, which spawns a mesh
deployment's ranks as actors and routes to rank 0.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.core import api
from ray_tpu_torch.core.config import config as rt_config
from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.core.topology import parse_topology
from ray_tpu_torch.core.errors import (DeadlineExceededError,
                                       HandoffAdoptError, OverloadedError,
                                       RequestCancelledError)
from ray_tpu_torch.models import llama
from ray_tpu_torch.models import llama_decode as ld
from ray_tpu_torch.parallel.mesh import axis_sizes, decode_mesh
from ray_tpu_torch.parallel.sharding import local_shards
from ray_tpu_torch.serve import metrics as smetrics
from ray_tpu_torch.serve.handoff import HandoffLedger, descriptor_nbytes
from ray_tpu_torch.serve.paging import PageAllocator, PagedPrefixIndex
from ray_tpu_torch.serve.prefix_cache import PrefixCache
from ray_tpu_torch.serve.replica import replica_ident, request_deadline_s
from ray_tpu_torch.serve.spmd import Lockstep
from ray_tpu_torch.serve.steplog import StepTimeline
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

_req_ids = itertools.count(1)


@dataclass(eq=False)  # identity semantics: numpy token arrays inside
class _Request:
    tokens: np.ndarray                     # prompt ids, (S,)
    max_new_tokens: int
    temperature: float
    eos_id: Optional[int]
    on_token: Optional[Callable[[int], None]]
    done: threading.Event = field(default_factory=threading.Event)
    output: List[int] = field(default_factory=list)
    slot: int = -1
    generated: int = 0
    error: Optional[str] = None
    on_token_error: Optional[str] = None   # first on_token callback failure
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    prefix_entry: int = -1                 # prefix-pool row spliced in
    prefix_len: int = 0                    # cached tokens NOT re-prefilled
    # ------------------------------------------------------- paged mode
    prefix_pages: List[int] = field(default_factory=list)  # spliced pages
    prompt_len: int = 0       # ORIGINAL prompt length (tokens grows when
    #   a preempted request re-queues with its emitted tokens absorbed)
    prefilled: int = 0        # prompt tokens prefilled so far (chunked)
    preemptions: int = 0      # times requeued by page pressure
    # ------------------------------------------- disaggregated handoff
    prefill_only: bool = False  # terminal = filled pages, not tokens: the
    #   request ends at its first token with its KV pages copied to the
    #   host as the handoff payload instead of entering the decode loop
    handoff: Optional[Dict[str, Any]] = None  # prefill_only result: k/v
    #   page payloads + committed_len + first_token + page geometry
    adopt: Optional[Dict[str, Any]] = None    # decode-side twin: payload
    #   to scatter into this engine's pool at admission (no recompute)
    admitted_at: Optional[float] = None  # first admission (queue wait)
    request_id: str = ""
    deadline: Optional[float] = None       # absolute monotonic; None = none
    cancelled: bool = False                # cooperative-cancel flag
    admitted: bool = False                 # left the pending queue
    status: str = "pending"                # terminal: completed |
    #   cancelled | deadline_exceeded | error
    spec_proposed: int = 0                 # draft tokens proposed for this
    #   request across its spec rounds
    spec_accepted: int = 0                 # of those, verified-accepted
    expired: bool = False                  # a mesh replica's rank 0 found
    #   its deadline passed (the only deadline decision on a mesh)
    trace: Optional[tuple] = None          # submitter's span context: the
    #   engine-side spans of this request attach there

    def raise_for_status(self) -> None:
        """Re-raise this request's terminal outcome as its typed error."""
        if self.status == "cancelled":
            raise RequestCancelledError(
                f"request {self.request_id} cancelled after "
                f"{self.generated} tokens")
        if self.status == "deadline_exceeded":
            raise DeadlineExceededError(
                f"request {self.request_id} exceeded its deadline after "
                f"{self.generated} tokens")
        if self.error:
            raise RuntimeError(self.error)


class DecodeEngine:
    """Continuous batcher over ``llama_decode``.

    ``slots`` concurrent sequences share one KV cache of ``capacity``
    tokens per slot, or, with ``page_tokens > 0``, a pool of
    ``pool_pages`` pages of ``page_tokens`` tokens (default: enough for
    every slot's full capacity). ``step()`` admits waiting requests, runs
    at most one chunk of a chunked prefill, and advances every active slot
    one token (or ``decode_chunk`` greedy tokens); ``submit()`` enqueues a
    request. Run ``serve_forever`` in a thread, or drive ``step()`` by
    hand in tests. Runs on ``device`` (``cuda`` unless the caller passes
    another), where ``params`` must live.

    With ``spec_k > 0`` and ``spec_draft_params``/``spec_draft_config``
    (paged mode only) every all-greedy step is a speculative round; the
    draft's pool holds ``spec_draft_pool_pages`` pages (default: as many
    as the target's). ``step_timeline`` sizes the step-timeline ring (0
    turns it off). ``metrics_enabled`` (default ``serve_metrics_enabled``)
    observes the serve SLO metrics under the tag ``{"deployment":
    metrics_deployment or "-"}``.

    ``mesh_shape`` (``(batch, model)``; default the ``decode_mesh_shape``
    knob) or ``mesh`` (a ``parallel.mesh.decode_mesh``) makes the engine
    one replica over a mesh that spans every rank of the default process
    group: build it on every rank from the same full ``params``; drive it
    with ``serve_forever`` on every rank, or with ``step()`` on every rank
    the same number of times. Only rank 0 takes ``submit``/``cancel``;
    its ``shutdown()`` stops every rank's loop (outside ``serve_forever``,
    at once)."""

    def __init__(self, params, config, slots: int = 4,
                 capacity: int = 1024, prefill_bucket: int = 128,
                 decode_chunk: int = 1,
                 prefix_pool_entries: Optional[int] = None,
                 prefix_capacity: Optional[int] = None,
                 prefix_match_min_tokens: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 page_tokens: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_max_pages: Optional[int] = None,
                 mesh_shape=None, mesh=None,
                 spec_draft_params=None, spec_draft_config=None,
                 spec_k: Optional[int] = None,
                 spec_draft_pool_pages: Optional[int] = None,
                 device_sampler: Optional[bool] = None,
                 step_timeline: Optional[int] = None,
                 metrics_enabled: Optional[bool] = None,
                 trace_spans: Optional[bool] = None,
                 metrics_deployment: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        pdev = params["tok_embed"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params are on {pdev}, the engine was asked "
                             f"to run on {self.device}")
        self.params = params
        self.config = config
        self._init_mesh(mesh, mesh_shape, slots)
        self.slots = slots
        self.capacity = capacity
        self.prefill_bucket = prefill_bucket
        # -------------------------------------------------- paged KV pool
        pt = rt_config.kv_page_tokens if page_tokens is None else page_tokens
        self.page_tokens = int(pt)
        self.paged = self.page_tokens > 0
        chunk_tok = (rt_config.prefill_chunk_tokens
                     if prefill_chunk_tokens is None
                     else prefill_chunk_tokens)
        # Chunked prefill rides on the paged suffix prefill (a chunk IS a
        # suffix prefill from pos = prefilled); contiguous engines keep
        # monolithic admission. Rounded down to a power of two, as in the
        # JAX engine, so chunk buckets stay on the prompt-bucket grid.
        self.prefill_chunk_tokens = int(chunk_tok) if self.paged else 0
        if self.prefill_chunk_tokens:
            c = 1
            while c * 2 <= self.prefill_chunk_tokens:
                c *= 2
            self.prefill_chunk_tokens = c
        self._pages: Optional[PageAllocator] = None
        if self.paged:
            if capacity % self.page_tokens:
                raise ValueError(
                    f"capacity ({capacity}) must be a multiple of "
                    f"kv_page_tokens ({self.page_tokens})")
            self.slot_pages_max = capacity // self.page_tokens
            pp = (rt_config.kv_pool_pages if pool_pages is None
                  else pool_pages)
            self.pool_pages = int(pp) or slots * self.slot_pages_max
            self._pages = PageAllocator(self.pool_pages)
            with local_shards(self._shards):
                pool = ld.init_page_pool(config, self.pool_pages,
                                         self.page_tokens,
                                         device=self.device)
            self.cache = {"k": pool["k"], "v": pool["v"],
                          "length": torch.zeros((slots,), dtype=torch.int32,
                                                device=self.device)}
            self._block_tables = np.zeros((slots, self.slot_pages_max),
                                          np.int32)
            self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
        else:
            with local_shards(self._shards):
                self.cache = ld.init_cache(config, slots, capacity,
                                           device=self.device)
        self._free = list(range(slots))
        self._active: Dict[int, _Request] = {}
        self._prefilling: Dict[int, _Request] = {}  # chunked, mid-prefill
        self._requeue: List[_Request] = []  # preempted / pushed back, FIFO
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        # On a mesh, rank 0's intake waits here for the next control
        # message, which enqueues it on every rank at the same point.
        self._intake: List[_Request] = []
        self._intake_cancels: List[str] = []
        self._purge_due = False  # rank 0's purge decision, broadcast
        self._halted = False     # a control message said stop
        self._looping = False    # serve_forever is running
        self._sync_lock = threading.RLock()  # one control exchange at a
        #   time: shutdown's, or the loop's
        self._tokens = np.zeros((slots,), np.int32)
        self._rng = np.random.default_rng(0)
        self._stop = threading.Event()
        self._work = threading.Event()
        # Bounded admission: past queue_max pending requests, submit()
        # sheds with OverloadedError at enqueue.
        if queue_max is None:
            queue_max = rt_config.decode_queue_max
        self.queue_max = int(queue_max) if queue_max else slots * 8
        # request_id -> live request, for cancel(); guarded by _reqs_lock
        # (intake/cancel threads vs the decode loop).
        self._requests: Dict[str, _Request] = {}
        self._reqs_lock = threading.Lock()
        self._queued_cancelled = 0  # cancelled but not yet dequeued
        self._queued_tokens = 0     # prompt tokens waiting for prefill
        #   (pending queue + requeue)
        self.shed = 0
        self.cancelled = 0
        self.deadline_exceeded = 0
        self.preempted = 0          # requests requeued by page pressure
        self._ema_request_s = 0.0   # EMA of completed-request service time
        self._last_purge = 0.0
        self.prefill_waves = 0      # full-prefill (miss) waves dispatched
        self.suffix_waves = 0       # suffix-prefill (hit) waves dispatched
        self.prefill_chunks = 0     # chunked-prefill chunks dispatched
        # Prefix KV cache. Contiguous mode: a device pool of P entries x
        # C_prefix tokens. Paged mode: the index pins pool pages.
        entries = (rt_config.prefix_pool_entries
                   if prefix_pool_entries is None else prefix_pool_entries)
        min_tokens = (rt_config.prefix_match_min_tokens
                      if prefix_match_min_tokens is None
                      else prefix_match_min_tokens)
        if prefix_capacity is None:
            prefix_capacity = 1
            while prefix_capacity * 2 <= capacity // 2:
                prefix_capacity *= 2
        self.prefix = None
        self._pool: Optional[Dict[str, torch.Tensor]] = None
        if self.paged:
            if entries > 0:
                pmax = (rt_config.kv_prefix_max_pages
                        if prefix_max_pages is None else prefix_max_pages)
                self.prefix = PagedPrefixIndex(
                    self._pages, self.page_tokens,
                    max_pages=int(pmax) or max(1, self.pool_pages // 4),
                    min_tokens=min_tokens)
        elif entries > 0 and prefix_capacity >= max(2, min_tokens):
            self.prefix = PrefixCache(entries, prefix_capacity,
                                      min_tokens=min_tokens)
            with local_shards(self._shards):
                self._pool = ld.init_prefix_pool(
                    config, entries, prefix_capacity, device=self.device)
        # Device sampler: the step samples on the device and only (slots,)
        # token ids reach the host. Greedy rows equal the host sampler's;
        # sampled rows draw from this generator, re-seeded from the step
        # counter every step (the JAX engine's fold_in(key(0), step)) so a
        # run repeats.
        self._device_sampler = bool(
            rt_config.decode_device_sampler if device_sampler is None
            else device_sampler)
        self._generator = (torch.Generator(device=self.device)
                           if self._device_sampler else None)
        self._tokens_dev: Optional[torch.Tensor] = None  # the last sampled
        #   step's token ids, fed to the next sampled step without an
        #   upload; any host-side token write drops it.
        # Suffix prefills bucket on a finer grid than full prefills: the
        # suffix is short, and padding it back up to prefill_bucket would
        # refund most of the win.
        self._suffix_bucket_min = max(8, min(16, prefill_bucket))
        # K greedy steps per decode call; chunking engages only when no
        # admission is waiting and every active request is greedy.
        self.decode_chunk = max(1, int(decode_chunk))
        self.steps = 0
        self.tokens_out = 0
        self.steplog = StepTimeline(
            rt_config.decode_step_timeline
            if step_timeline is None else step_timeline)
        self._step_phases: List[Dict[str, Any]] = []  # this step's phases
        self._compiled: set = set()  # program keys dispatched once
        # SLO metrics are per REQUEST (submit, admission, preemption,
        # terminal): nothing here touches the per-token or per-step path.
        # On a mesh only rank 0 observes: the other ranks' requests are
        # mirrors of its own.
        self._obs_metrics = self._lead and bool(
            rt_config.serve_metrics_enabled if metrics_enabled is None
            else metrics_enabled)
        ident = replica_ident()
        self._mtags = {"deployment": (metrics_deployment
                                      or ident["deployment"] or "-")}
        self._replica_id = ident["replica_id"]
        self._obs_spans = self._lead and bool(
            rt_config.serve_trace_spans if trace_spans is None
            else trace_spans)
        # Disaggregated handoff accounting (engine side; the lease ledger
        # lives on the deployment).
        self.handoffs_published = 0  # prefill_only captures completed
        self.handoffs_adopted = 0    # adopted seats completed
        self._init_spec(spec_draft_params, spec_draft_config, spec_k,
                        spec_draft_pool_pages)

    def _init_mesh(self, mesh, mesh_shape, slots: int) -> None:
        """The decode mesh, if any: this rank's shards of the weights, the
        kv heads its KV state holds, and the lockstep. The mesh must span
        exactly the default process group's ranks: a replica never runs
        on fewer devices than asked."""
        if mesh is None:
            shape = mesh_shape
            if shape is None and rt_config.decode_mesh_shape:
                shape = parse_topology(rt_config.decode_mesh_shape)
            if shape is not None:
                import torch.distributed as dist

                n = int(shape[0]) * int(shape[1])
                if dist.is_initialized() and dist.get_world_size() != n:
                    raise ValueError(
                        f"decode mesh {tuple(shape)} needs {n} ranks, the "
                        f"process group has {dist.get_world_size()}")
                mesh = decode_mesh(tuple(shape),
                                   device_type=self.device.type)
        self.mesh = mesh
        self._shards = None
        self._ctl: Optional[Lockstep] = None
        if mesh is None:
            self._lead = True
            return
        import torch.distributed as dist

        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"engine runs on {self.device}")
        if dist.get_world_size() != mesh.size():
            raise ValueError(
                f"the decode mesh spans {mesh.size()} ranks, the process "
                f"group {dist.get_world_size()}: a replica spans them all")
        batch = axis_sizes(mesh).get("batch", 1)
        if slots % batch:
            raise ValueError(
                f"slots ({slots}) must be a multiple of the mesh batch "
                f"axis ({batch}): per-slot cache rows shard over it")
        self.params, bundle = ld.shard_decode_state(self.params,
                                                    self.config, mesh)
        self._shards = bundle["local"]
        self._ctl = Lockstep(mesh.mesh.flatten().tolist())
        self._lead = self._ctl.lead

    def _init_spec(self, draft_params, draft_config, spec_k,
                   draft_pool_pages) -> None:
        """Speculative state. The draft keeps its K/V in its OWN page pool
        (same page size, draft width) with its own allocator and block
        tables and no prefix index; its cursors roll back with the
        target's after each round."""
        sk = rt_config.spec_k if spec_k is None else spec_k
        self.spec_k = int(sk)
        self.spec = self.spec_k > 0 and draft_params is not None
        if not self.spec:
            return
        if not self.paged:
            raise ValueError(
                "speculative decoding requires paged KV (kv_page_tokens "
                "> 0): the verify forward and the rollback cursor are "
                "page-table operations")
        if draft_config is None:
            raise ValueError("spec_draft_params needs spec_draft_config")
        ddev = draft_params["tok_embed"].device
        if ddev.type != self.device.type:
            raise ValueError(f"draft params are on {ddev}, the engine runs "
                             f"on {self.device}")
        self._draft_params = draft_params
        self._draft_config = draft_config
        self._draft_shards = None
        if self.mesh is not None:
            # The draft shards under its own config's rules (its head
            # counts may divide the model axis where the target's do not).
            self._draft_params, dsh = ld.shard_decode_state(
                draft_params, draft_config, self.mesh)
            self._draft_shards = dsh["local"]
        dpp = (rt_config.spec_draft_pool_pages if draft_pool_pages is None
               else draft_pool_pages)
        self.draft_pool_pages = int(dpp) or self.pool_pages
        self._draft_pages = PageAllocator(self.draft_pool_pages)
        with local_shards(self._draft_shards):
            dpool = ld.init_page_pool(draft_config, self.draft_pool_pages,
                                      self.page_tokens, device=self.device)
        self._draft_cache = {
            "k": dpool["k"], "v": dpool["v"],
            "length": torch.zeros((self.slots,), dtype=torch.int32,
                                  device=self.device)}
        self._draft_bt = np.zeros((self.slots, self.slot_pages_max),
                                  np.int32)
        self._draft_slot_pages: List[List[int]] = [
            [] for _ in range(self.slots)]
        # Host-side committed draft length per slot; -1 = draftless (the
        # draft pool could not seat it: the slot rides spec rounds with
        # junk proposals that verification rejects).
        self._draft_committed = [0] * self.slots
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_demotions = 0

    # --------------------------------------------- paged page accounting

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """``n`` pool pages, reclaiming prefix-index pins under pressure.
        None = genuinely dry (caller preempts or backs off)."""
        if self._pages.free_count < n and self.prefix is not None:
            self.prefix.reclaim(n - self._pages.free_count)
        got = self._pages.alloc(n)
        if got is None:
            return None
        try:
            if self.steplog.enabled:
                self.steplog.event("page-alloc", n=n,
                                   free=self._pages.free_count)
        except BaseException:
            # An event-recording failure hands the pages back: the
            # caller never saw them, so nothing else would free them.
            self._pages.free(got)
            raise
        return got

    def _set_slot_pages(self, slot: int, pages: List[int]) -> None:
        self._block_tables[slot, :] = 0
        self._block_tables[slot, :len(pages)] = pages
        self._slot_pages[slot] = pages

    def _grow_slot(self, slot: int, pages: List[int]) -> None:
        have = self._slot_pages[slot]
        self._block_tables[slot, len(have):len(have) + len(pages)] = pages
        self._slot_pages[slot] = have + pages

    def _seq_pages(self, tokens: int) -> int:
        return -(-tokens // self.page_tokens)

    def _round_pages(self, req: _Request, k: int) -> int:
        """Pages covering ``req``'s next ``k`` writes, at most a slot's
        worth: a spec round near the capacity edge writes positions past
        it, whose tokens are never emitted, to the scratch page."""
        return min(self._seq_pages(req.prompt_len + req.generated - 1 + k),
                   self.slot_pages_max)

    def _ensure_decode_pages(self, k: int) -> None:
        """Every active slot can write its next ``k`` tokens. Oldest slots
        are served first; when the pool is dry even after reclaiming
        prefix pins, the YOUNGEST admitted request is preempted
        (recompute-style requeue). The oldest request always makes
        progress, so this terminates."""
        for slot in sorted(self._active,
                           key=lambda s: self._active[s].submitted_at):
            while True:
                req = self._active.get(slot)
                if req is None:
                    break  # preempted while serving an older slot
                need = self._round_pages(req, k) \
                    - len(self._slot_pages[slot])
                if need <= 0:
                    break
                got = self._alloc_pages(need)
                if got is not None:
                    self._grow_slot(slot, got)
                    break
                if not self._preempt_one():
                    break  # nothing left to preempt

    # ------------------------------------------- draft-pool accounting
    #
    # The draft pool mirrors the target's block-table discipline at the
    # draft model's width: same page size, its own allocator and tables,
    # no prefix index. Freeing a slot frees both pools. Draft-pool
    # pressure never touches the target: a draft seat only buys speed, so
    # a dry draft pool evicts the youngest other DRAFT seat or leaves the
    # slot draftless, and never preempts a request.

    def _draft_grow_slot(self, slot: int, pages: List[int]) -> None:
        have = self._draft_slot_pages[slot]
        self._draft_bt[slot, len(have):len(have) + len(pages)] = pages
        self._draft_slot_pages[slot] = have + pages

    def _ensure_draft_pages(self, k: int) -> None:
        """Every drafted active slot's draft can write its catch-up row and
        ``k - 1`` proposals (through ``L + k - 1``, ``L`` the target's
        length). Draftless slots (-1) are skipped: their rows write to the
        scratch page and verification rejects their junk proposals. A slot
        the pool cannot cover even after evicting younger draft seats is
        demoted to draftless the same way."""
        for slot in sorted(self._active,
                           key=lambda s: self._active[s].submitted_at):
            req = self._active[slot]
            while self._draft_committed[slot] >= 0:
                need = self._round_pages(req, k) \
                    - len(self._draft_slot_pages[slot])
                if need <= 0:
                    break
                got = self._draft_pages.alloc(need)
                if got is not None:
                    self._draft_grow_slot(slot, got)
                    break
                if not self._draft_evict_one(slot):
                    self._draft_demote(slot, req)

    def _draft_demote(self, slot: int, req: _Request) -> None:
        """Drop a slot's draft seat and its draft pages: it keeps riding
        spec rounds with junk proposals that verification rejects, so its
        output is unchanged; it stops adding speed until re-admission
        seats it again."""
        self._draft_pages.free(self._draft_slot_pages[slot])
        self._draft_slot_pages[slot] = []
        self._draft_bt[slot, :] = 0
        self._draft_committed[slot] = -1
        self.spec_demotions += 1
        if self.steplog.enabled:
            self.steplog.event("spec-draftless", request=req.request_id)

    def _draft_evict_one(self, keep: int) -> bool:
        """Make room in the draft pool by demoting the youngest OTHER
        drafted slot. Never preempts a request over draft pressure."""
        cands = [s for s in self._active
                 if s != keep and self._draft_committed[s] >= 0
                 and self._draft_slot_pages[s]]
        if not cands:
            return False
        victim = max(cands, key=lambda s: self._active[s].submitted_at)
        self._draft_demote(victim, self._active[victim])
        return True

    def _rollback_pages(self, slot: int, committed: int) -> None:
        """Roll a slot's pages back to ``committed`` tokens after a spec
        round: tail pages past the accepted run go back to the allocator
        in BOTH pools. Their junk K/V is dead: nothing attends past the
        rolled-back ``length``, and a later owner's write precedes its
        gather on the same stream. Leading pages, shared prefix pages
        among them, stay: ``committed >= prefix_len`` always."""
        keep = self._seq_pages(committed)
        tail = self._slot_pages[slot][keep:]
        if tail:
            self._block_tables[slot, keep:keep + len(tail)] = 0
            self._slot_pages[slot] = self._slot_pages[slot][:keep]
            self._pages.free(tail)
        keep_d = self._seq_pages(min(committed,
                                     self._draft_committed[slot]))
        dtail = self._draft_slot_pages[slot][keep_d:]
        if dtail:
            self._draft_bt[slot, keep_d:keep_d + len(dtail)] = 0
            self._draft_slot_pages[slot] = \
                self._draft_slot_pages[slot][:keep_d]
            self._draft_pages.free(dtail)

    def _preempt_one(self) -> bool:
        """Requeue the youngest admitted request to free its pages
        (vLLM-style recompute preemption): its prompt plus every token
        emitted so far re-enters the queue as one prefill, so the stream
        continues where it left off after re-admission."""
        cands = list(self._active.items()) + list(self._prefilling.items())
        if not cands:
            return False
        slot, req = max(cands, key=lambda it: it[1].submitted_at)
        self._active.pop(slot, None)
        self._prefilling.pop(slot, None)
        self._release_slot(slot)
        absorbed = len(req.tokens) - req.prompt_len
        tail = np.asarray(req.output[absorbed:], np.int32)
        if len(tail):
            req.tokens = np.concatenate([req.tokens, tail])
        req.slot = -1
        req.prefix_pages = []
        req.prefix_len = 0
        req.prefilled = 0
        self.preempted += 1
        req.preemptions += 1
        if self._obs_metrics:
            smetrics.PREEMPTIONS.inc(1.0, self._mtags)
        if self.steplog.enabled:
            self.steplog.event("preempt", request=req.request_id,
                               tokens=req.generated)
        if self._obs_spans and req.trace is not None:
            now = time.time()
            tracing.record_span("preempt", now, now, ctx=req.trace,
                                request=req.request_id,
                                tokens=req.generated)
        self._requeue.insert(0, req)
        self._queued_tokens += len(req.tokens)
        with self._reqs_lock:
            req.admitted = False  # cancel-while-requeued counts as queued
        self._work.set()
        return True

    # ------------------------------------------------------------ intake

    def submit(self, prompt_tokens, max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               prefill_only: bool = False,
               adopt: Optional[Dict[str, Any]] = None) -> _Request:
        """Enqueue a request. ``prefill_only`` (paged engines) ends it at
        its first token with ``req.handoff`` holding its pages on the
        host; ``adopt`` (such a payload, shaped as ``_fetch_adopt``
        returns it) seats it from those pages with no prefill. On a mesh,
        only rank 0 takes requests."""
        self._check_lead("submit")
        req = _Request(np.asarray(prompt_tokens, np.int32).reshape(-1),
                       int(max_new_tokens), float(temperature), eos_id,
                       on_token)
        req.request_id = request_id or f"req-{next(_req_ids)}"
        req.prompt_len = len(req.tokens)
        if prefill_only and not self.paged:
            raise ValueError("prefill_only handoff requires a paged "
                             "engine (kv_page_tokens > 0)")
        req.prefill_only = bool(prefill_only)
        if adopt is not None:
            self._validate_adopt(req, adopt)
            req.adopt = dict(adopt)
        if self.paged and self._seq_pages(
                len(req.tokens) + req.max_new_tokens) > self.pool_pages:
            # A request no amount of preemption can seat must fail fast,
            # not live forever in the requeue list.
            raise ValueError(
                f"prompt ({len(req.tokens)}) + max_new_tokens "
                f"({req.max_new_tokens}) needs more pages than the pool "
                f"holds ({self.pool_pages} x {self.page_tokens} tokens)")
        if len(req.tokens) >= self.capacity:
            raise ValueError(
                f"prompt ({len(req.tokens)}) must be shorter than the "
                f"cache capacity ({self.capacity})")
        if len(req.tokens) + req.max_new_tokens > self.capacity:
            raise ValueError(
                f"prompt ({len(req.tokens)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the cache capacity "
                f"({self.capacity})")
        if deadline_s is not None:
            if deadline_s <= 0:
                self.deadline_exceeded += 1
                if self._obs_metrics:
                    smetrics.REQUESTS.inc(1.0, {
                        **self._mtags, "outcome": "deadline_exceeded"})
                raise DeadlineExceededError(
                    f"request {req.request_id} arrived with an already-"
                    f"expired deadline ({deadline_s:.3f}s)")
            req.deadline = time.monotonic() + float(deadline_s)
        if self._obs_spans:
            req.trace = tracing.current()  # loop-thread spans attach here
        # Load shedding happens HERE, at enqueue.
        if (self._pending.qsize() + len(self._intake)
                - self._queued_cancelled >= self.queue_max):
            self.shed += 1
            if self._obs_metrics:
                smetrics.REQUESTS.inc(1.0, {**self._mtags,
                                            "outcome": "shed"})
            if req.trace is not None:
                now = time.time()
                tracing.record_span("engine-shed", now, now,
                                    ctx=req.trace,
                                    request=req.request_id)
            raise OverloadedError(
                f"decode queue at capacity ({self.queue_max} pending, "
                f"{self.slots} slots)",
                retry_after_s=self.retry_after_estimate_s())
        with self._reqs_lock:
            self._requests[req.request_id] = req
            if self._ctl is not None:
                # Enqueued on every rank by the next control message.
                self._intake.append(req)
        if self._ctl is None:
            self._queued_tokens += len(req.tokens)
            self._pending.put(req)
        self._work.set()
        return req

    def _check_lead(self, what: str) -> None:
        if not self._lead:
            raise RuntimeError(
                f"{what} goes to rank 0 of the mesh replica; this is rank "
                f"{self._ctl.rank}, which follows rank 0's control messages")

    def _validate_adopt(self, req: _Request,
                        adopt: Dict[str, Any]) -> None:
        """Reject a handoff this pool cannot splice BEFORE enqueue, as the
        typed error the router maps to its colocated fallback. The payload
        must come from a pool with the same page geometry, head layout and
        dtype, and must cover exactly the prompt."""
        if not self.paged:
            raise HandoffAdoptError(
                "adopt requires a paged engine (kv_page_tokens > 0)")
        if int(adopt["page_tokens"]) != self.page_tokens:
            raise HandoffAdoptError(
                f"handoff page_tokens ({adopt['page_tokens']}) != this "
                f"engine's ({self.page_tokens}); pages cannot splice")
        if int(adopt["committed_len"]) != len(req.tokens):
            raise HandoffAdoptError(
                f"handoff committed_len ({adopt['committed_len']}) != "
                f"prompt length ({len(req.tokens)})")
        pool = self._pool_shape()  # (L, pages + 1, T, KV, D)
        for name in ("k", "v"):
            t = adopt[name]
            if (not isinstance(t, torch.Tensor) or t.ndim != 5
                    or t.shape[0] != pool[0]
                    or tuple(t.shape[2:]) != pool[2:]
                    or t.shape[1] != self._seq_pages(len(req.tokens))):
                raise HandoffAdoptError(
                    f"handoff payload {name} "
                    f"{tuple(getattr(t, 'shape', ()))} "
                    f"({type(t).__name__}) does not fit this engine's "
                    f"pool {pool}")
            if t.dtype != self.cache["k"].dtype:
                raise HandoffAdoptError(
                    f"handoff payload {name} is {t.dtype}, this engine's "
                    f"pool {self.cache['k'].dtype}")

    def retry_after_estimate_s(self) -> float:
        """How long a shed caller should wait before retrying: the queue
        drains ``slots`` requests per observed service interval. Clamped
        to [0.5 s, 30 s]; 1 s before any request has completed."""
        if self._ema_request_s <= 0:
            return 1.0
        depth = max(0, self._pending.qsize() - self._queued_cancelled)
        est = (depth / max(1, self.slots) + 1.0) * self._ema_request_s
        return min(30.0, max(0.5, est))

    def cancel(self, request_id: str) -> bool:
        """Cooperative cancellation: a queued request is dropped before
        prefill, an active one frees its slot at the next ``step()``.
        Returns False for unknown or finished requests (idempotent). On a
        mesh, only rank 0 takes cancels, and every rank applies them at
        the next control message."""
        self._check_lead("cancel")
        with self._reqs_lock:
            req = self._requests.get(request_id)
            if (req is None or req.done.is_set() or req.cancelled
                    or request_id in self._intake_cancels):
                return False
            if self._ctl is not None:
                self._intake_cancels.append(request_id)
            else:
                self._mark_cancelled(req)
        self._work.set()
        return True

    def _mark_cancelled(self, req: _Request) -> None:
        """Under ``_reqs_lock``."""
        req.cancelled = True
        if not req.admitted:
            self._queued_cancelled += 1

    def _expired(self, req: _Request, now: float) -> bool:
        """Past its deadline: on a mesh, as rank 0's clock found it."""
        if self._ctl is not None:
            return req.expired
        return req.deadline is not None and now > req.deadline

    # ------------------------------------------------- the SPMD lockstep

    def _sync(self) -> bool:
        """Exchange this step's control message (rank 0 sends, the others
        receive) and apply it on every rank at the same point: the new
        requests enqueue in order, then the cancels, then the expired
        deadlines. False when it says stop (and from then on)."""
        with self._sync_lock:
            return not self._halted and self._sync_locked()

    def _sync_locked(self) -> bool:
        msg = None
        if self._lead:
            with self._reqs_lock:
                new, self._intake = self._intake, []
                cancels, self._intake_cancels = self._intake_cancels, []
                now = time.monotonic()
                expired = [rid for rid, r in self._requests.items()
                           if r.deadline is not None and now > r.deadline
                           and not r.expired]
            msg = {"new": [self._wire(r) for r in new], "cancel": cancels,
                   "expired": expired,
                   "purge": now - self._last_purge > 0.5,
                   "stop": self._stop.is_set()}
        msg = self._ctl.exchange(msg)
        for i, wire in enumerate(msg["new"]):
            req = new[i] if self._lead else self._mirror(wire)
            self._queued_tokens += len(req.tokens)
            self._pending.put(req)
        with self._reqs_lock:
            for rid in msg["cancel"]:
                req = self._requests.get(rid)
                if req is not None and not req.done.is_set() \
                        and not req.cancelled:
                    self._mark_cancelled(req)
            for rid in msg["expired"]:
                req = self._requests.get(rid)
                if req is not None:
                    req.expired = True
        self._purge_due = msg["purge"]
        self._halted = msg["stop"]
        return not self._halted

    @staticmethod
    def _wire(req: _Request) -> Dict[str, Any]:
        """What the other ranks need of a new request: its tokens,
        sampling, its place in the age order and its handoff payload."""
        return {"tokens": req.tokens, "max_new_tokens": req.max_new_tokens,
                "temperature": req.temperature, "eos_id": req.eos_id,
                "request_id": req.request_id,
                "submitted_at": req.submitted_at,
                "prefill_only": req.prefill_only, "adopt": req.adopt}

    def _mirror(self, wire: Dict[str, Any]) -> _Request:
        """A follower's copy of rank 0's request: no callback, no
        deadline (rank 0 decides expiry), rank 0's submit time (the age
        order preemption and chunking follow)."""
        req = _Request(wire["tokens"], wire["max_new_tokens"],
                       wire["temperature"], wire["eos_id"], None,
                       submitted_at=wire["submitted_at"])
        req.request_id = wire["request_id"]
        req.prompt_len = len(req.tokens)
        req.prefill_only = wire["prefill_only"]
        req.adopt = wire["adopt"]
        with self._reqs_lock:
            self._requests[req.request_id] = req
        return req


    # ------------------------------------------------- observability hooks
    #
    # All per request: admission (queue wait), preemption, terminal
    # outcomes. The per-token and per-step paths never touch the metrics
    # registry.

    def _mark_admitted(self, reqs: List[_Request]) -> None:
        """Queue wait ends: the wave is about to dispatch device work.
        First admission only: a preemption requeue keeps its original
        admission time (queue wait measures admission latency, not
        lifetime)."""
        fresh = [r for r in reqs if r.admitted_at is None]
        if not fresh:
            return
        now = time.monotonic()
        for req in fresh:
            req.admitted_at = now
        if self._obs_metrics:
            smetrics.QUEUE_WAIT.observe_many(
                [now - r.submitted_at for r in fresh], self._mtags)
        if self._obs_spans:
            wall = time.time()
            for req in fresh:
                if req.trace is not None:
                    tracing.record_span(
                        "queue-wait", wall - (now - req.submitted_at),
                        wall, ctx=req.trace, request=req.request_id)

    def _wave_span(self, name: str, t0_wall: float,
                   reqs: List[_Request], **attrs: Any) -> None:
        """One span per request of a batched device call (the wave is
        one call; each request's trace gets its own slice of it)."""
        if not self._obs_spans:
            return
        t1 = time.time()
        for req in reqs:
            if req.trace is not None:
                tracing.record_span(name, t0_wall, t1, ctx=req.trace,
                                    request=req.request_id, **attrs)

    def _observe_terminal(self, req: _Request, status: str) -> None:
        """Terminal bookkeeping shared by _finish and _retire: the outcome
        counter, TTFT and inter-token histograms, the speculative counters
        and accept-rate histogram, and the request's engine-side spans
        (decode slice and whole-request outcome), once per request."""
        if self._obs_spans and req.trace is not None:
            off = time.time() - time.monotonic()  # mono -> wall
            if (req.first_token_at is not None
                    and req.finished_at > req.first_token_at):
                tracing.record_span(
                    "decode", req.first_token_at + off,
                    req.finished_at + off, ctx=req.trace,
                    request=req.request_id, tokens=req.generated)
            tracing.record_span(
                "engine-request", req.submitted_at + off,
                req.finished_at + off, ctx=req.trace,
                request=req.request_id, outcome=status,
                tokens=req.generated, preemptions=req.preemptions)
        if not self._obs_metrics:
            return
        smetrics.REQUESTS.inc(1.0, {**self._mtags, "outcome": status})
        if req.first_token_at is not None:
            smetrics.TTFT.observe(req.first_token_at - req.submitted_at,
                                  self._mtags)
            if status == "completed" and req.generated > 1:
                # Stream duration a token, once per request: robust to
                # chunked emission's bursty gaps, never a per-token hit.
                smetrics.INTER_TOKEN.observe(
                    (req.finished_at - req.first_token_at)
                    / (req.generated - 1), self._mtags)
        if req.spec_proposed > 0:
            smetrics.SPEC_PROPOSED.inc(float(req.spec_proposed),
                                       self._mtags)
            smetrics.SPEC_ACCEPTED.inc(float(req.spec_accepted),
                                       self._mtags)
            smetrics.SPEC_ACCEPT.observe(
                req.spec_accepted / req.spec_proposed, self._mtags)

    # -------------------------------------------------------- admission

    def _admit(self) -> None:
        while self._free and (self._requeue or not self._pending.empty()):
            # Preempted and pushed-back requests go first: they were
            # admitted before anything still queued.
            wave: List[_Request] = []
            while len(wave) < len(self._free):
                if self._requeue:
                    wave.append(self._requeue.pop(0))
                    self._queued_tokens -= len(wave[-1].tokens)
                    continue
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                self._queued_tokens -= len(req.tokens)
                wave.append(req)
            if not wave:
                return
            # Dead-on-arrival requests retire before any device work.
            live: List[_Request] = []
            now = time.monotonic()
            for req in wave:
                with self._reqs_lock:
                    req.admitted = True
                    if req.cancelled:
                        self._queued_cancelled -= 1
                if req.cancelled:
                    self._retire(req, "cancelled")
                elif self._expired(req, now):
                    self._retire(req, "deadline_exceeded")
                else:
                    live.append(req)
            if not live:
                continue
            if self.paged:
                if not self._admit_paged(live):
                    return  # pool dry: stop admitting this step
                continue
            hits: List[_Request] = []
            misses: List[_Request] = []
            for req in live:
                m = (self.prefix.match(req.tokens)
                     if self.prefix is not None else None)
                if m is not None:
                    req.prefix_entry, req.prefix_len = m
                    hits.append(req)
                else:
                    misses.append(req)
            self._mark_admitted(live)
            self._admit_full(misses)
            self._admit_suffix(hits)

    def _admit_paged(self, live: List[_Request]) -> bool:
        """Seat a wave in paged mode: an adopted handoff scatters its
        payload into fresh pages (``_seat_adopted``), prefix pages splice
        into the slot's block table with no device copy, fresh pages come
        from the allocator, and prompts longer than a chunk go to the
        chunked prefill (``_prefill_tick``). Returns False when the pool
        ran dry mid-wave (the unseated requests are pushed back in order
        and admission pauses until pages free)."""
        chunk = self.prefill_chunk_tokens
        full_group: List[_Request] = []
        suffix_group: List[_Request] = []
        seated: List[_Request] = []
        for i, req in enumerate(live):
            if req.adopt is not None:
                # The prompt's K/V exists as a handed-off payload: no
                # prefix match and no model math. The adopted pages go
                # into the prefix index in _post_adopt.
                if not self._seat_adopted(req):
                    self._push_back(live[i:])
                    break
                continue
            m = (self.prefix.match(req.tokens)
                 if self.prefix is not None else None)
            if m is not None:
                req.prefix_pages, req.prefix_len = m
            else:
                req.prefix_pages, req.prefix_len = [], 0
            if chunk > 0 and len(req.tokens) - req.prefix_len > chunk:
                # Chunked prefill: take the slot and the spliced prefix
                # now; _prefill_tick runs the chunks between decode steps
                # and allocates pages chunk by chunk.
                slot = self._free.pop()
                req.slot = slot
                self._set_slot_pages(slot, req.prefix_pages)
                req.prefilled = req.prefix_len
                # Park the device cursor at the spliced length NOW: the
                # slot may wait several steps for its chunks, and every
                # decode step writes an idle row's junk at pos = length.
                # At 0 that would land INSIDE a shared prefix page and
                # corrupt it for every borrower; at prefix_len it lands in
                # the slot's own (or the scratch) page, which the first
                # chunk overwrites.
                self.cache["length"][slot] = req.prefix_len
                self._prefilling[slot] = req
                seated.append(req)
                continue
            need = self._seq_pages(len(req.tokens)) - len(req.prefix_pages)
            pages = self._alloc_pages(need)
            if pages is None:
                # Dry: drop the splice pins, push this and the rest of
                # the wave back (front, original order) and pause.
                self._pages.free(req.prefix_pages)
                req.prefix_pages = []
                req.prefix_len = 0
                self._push_back(live[i:])
                break
            slot = self._free.pop()
            req.slot = slot
            self._set_slot_pages(slot, req.prefix_pages + pages)
            seated.append(req)
            (suffix_group if req.prefix_len else full_group).append(req)
        self._mark_admitted(seated)
        self._admit_paged_full(full_group)
        self._admit_paged_suffix(suffix_group)
        return not self._requeue

    def _push_back(self, reqs: List[_Request]) -> None:
        """Return unseated requests to the front of the requeue, in
        order, as still queued."""
        for r in reversed(reqs):
            with self._reqs_lock:
                r.admitted = False
            self._requeue.insert(0, r)
            self._queued_tokens += len(r.tokens)

    def _seat_adopted(self, req: _Request) -> bool:
        """Seat one adopted handoff: pages for the committed prompt, the
        payload scattered into them (pure data movement, so the adopted
        state equals having prefilled here), the slot's cursor at the
        committed length, then the handoff's first token. Scatters exactly
        ``len(pages)`` pages: the JAX engine pads the page count to a
        power of two for its compiled-program cache, which eager PyTorch
        does not have. Returns False when the pool is dry (the caller
        requeues; the payload stays on the request for the retry)."""
        adopt = req.adopt
        clen = int(adopt["committed_len"])
        pages = self._alloc_pages(self._seq_pages(clen))
        if pages is None:
            return False
        slot = self._free.pop()
        req.slot = slot  # ownership on the request before any fallible
        #   call: a raise must not strand the pages
        self._set_slot_pages(slot, pages)
        req.prefix_pages, req.prefix_len = [], 0
        req.prefilled = clen
        t0 = time.time()
        self._mark_compile(("adopt_pages", len(pages)))
        ids = self._dev(pages)
        for name in ("k", "v"):
            # One payload tensor on the card at a time; index_copy_ writes
            # the pool in place (no pool-sized temporary). On a mesh each
            # rank takes its kv heads of the payload.
            part = (adopt[name] if self._shards is None
                    else self._shards.take(adopt[name], 3, "kv_heads"))
            self.cache[name].index_copy_(1, ids, part.to(self.device))
        self.cache["length"][slot] = clen
        if self.steplog.enabled:
            self.steplog.event("handoff-adopt", slot=slot,
                               pages=len(pages), committed=clen)
        self._phase("handoff", t0, slot=slot, pages=len(pages))
        self._wave_span("adopt", t0, [req], pages=len(pages))
        self._mark_admitted([req])
        self._post_adopt(req, slot)
        return True

    def _post_adopt(self, req: _Request, slot: int) -> None:
        """Adopted twin of _post_admit's per-request tail: the prefix-index
        insert first (the adopted pages hold the whole prompt, so later
        prompts sharing it splice against this engine), then the
        handoff's first token, which enters the request into the decode
        loop, and its draft seat on a speculative engine."""
        if self.prefix is not None:
            self.prefix.insert(req.tokens, self._slot_pages[slot],
                               matched_len=0)
        self._tokens_dev = None  # host token write in _advance
        tok = int(req.adopt["first_token"])
        req.first_token_at = time.monotonic()
        self._active[slot] = req
        self.handoffs_adopted += 1
        req.adopt = None  # drop the payload promptly
        if not self._advance(slot, tok) and self.spec:
            self._draft_seat([req])

    def _admit_paged_full(self, reqs: List[_Request]) -> None:
        """Prefix misses: one batched prefill per prompt bucket (its
        attention the config's impl), K/V scattered into the wave's
        pages."""
        T = self.page_tokens
        for bucket, group in self._by_bucket(
                reqs, lambda r: len(r.tokens), self.prefill_bucket).items():
            wp = -(-bucket // T)  # block-table columns covering the bucket
            rows = np.zeros((len(group), bucket), np.int32)
            for i, req in enumerate(group):
                rows[i, :len(req.tokens)] = req.tokens
            slots = [r.slot for r in group]
            lengths = self._dev([len(r.tokens) for r in group])
            self.prefill_waves += 1
            t0 = time.time()
            self._mark_compile(("paged_prefill", len(group), bucket))
            logits, _ = ld.paged_prefill(
                self.params, self._dev(rows), self.cache,
                self._dev(self._block_tables[slots, :wp]), self.config,
                lengths=lengths)
            self.cache["length"][self._dev(slots)] = lengths.to(torch.int32)
            logits = logits.cpu().numpy()
            self._phase("prefill", t0, n=len(group), bucket=bucket)
            self._wave_span("prefill", t0, group, n=len(group),
                            bucket=bucket)
            self._post_admit(group, slots, logits)

    def _admit_paged_suffix(self, reqs: List[_Request]) -> None:
        """Prefix hits: the shared pages are already in the slots' block
        tables (the splice in _admit_paged); prefill only the uncached
        suffixes, over the block-table columns prefix + suffix reach."""
        for bucket, group in self._by_bucket(
                reqs, lambda r: len(r.tokens) - r.prefix_len,
                self._suffix_bucket_min).items():
            width = min(max(self._seq_pages(r.prefix_len + bucket)
                            for r in group), self.slot_pages_max)
            rows = np.zeros((len(group), bucket), np.int32)
            for i, req in enumerate(group):
                suffix = req.tokens[req.prefix_len:]
                rows[i, :len(suffix)] = suffix
            slots = [r.slot for r in group]
            lengths = self._dev([len(r.tokens) for r in group])
            self.suffix_waves += 1
            t0 = time.time()
            self._mark_compile(("paged_suffix", len(group), bucket, width))
            logits, _ = ld.paged_prefill_suffix(
                self.params, self._dev(rows), self.cache,
                self._dev(self._block_tables[slots, :width]), self.config,
                self._dev([r.prefix_len for r in group]), lengths)
            self.cache["length"][self._dev(slots)] = lengths.to(torch.int32)
            logits = logits.cpu().numpy()
            self._phase("suffix-prefill", t0, n=len(group), bucket=bucket)
            self._wave_span("suffix-prefill", t0, group, n=len(group),
                            bucket=bucket)
            self._post_admit(group, slots, logits)

    def _prefill_tick(self) -> None:
        """Chunked prefill: advance the OLDEST mid-prefill slot by at most
        ONE ``prefill_chunk_tokens`` chunk, then return so the decode step
        runs: a long admission costs active streams one chunk a step,
        never its whole prefill. Pages are allocated chunk by chunk; a dry
        pool skips the tick (decode keeps draining, the chunk retries next
        step)."""
        if not self._prefilling:
            return
        slot = min(self._prefilling,
                   key=lambda s: self._prefilling[s].submitted_at)
        req = self._prefilling[slot]
        step_tok = min(self.prefill_chunk_tokens,
                       len(req.tokens) - req.prefilled)
        bucket = min(ld.cache_bucket(step_tok, self._suffix_bucket_min),
                     self.prefill_chunk_tokens)
        need = self._seq_pages(req.prefilled + step_tok) \
            - len(self._slot_pages[slot])
        if need > 0:
            got = self._alloc_pages(need)
            if got is None:
                return
            self._grow_slot(slot, got)
        width = min(self._seq_pages(req.prefilled + bucket),
                    self.slot_pages_max)
        rows = np.zeros((1, bucket), np.int32)
        rows[0, :step_tok] = req.tokens[req.prefilled:
                                        req.prefilled + step_tok]
        end = req.prefilled + step_tok
        t0 = time.time()
        self._mark_compile(("paged_suffix", 1, bucket, width))
        logits, _ = ld.paged_prefill_suffix(
            self.params, self._dev(rows), self.cache,
            self._dev(self._block_tables[slot:slot + 1, :width]),
            self.config, self._dev([req.prefilled]), self._dev([end]))
        self.cache["length"][slot] = end
        self.prefill_chunks += 1
        req.prefilled = end
        self._phase("prefill-chunk", t0, tokens=step_tok, prefilled=end,
                    prompt=len(req.tokens))
        self._wave_span("prefill-chunk", t0, [req], tokens=step_tok,
                        prefilled=end, prompt=len(req.tokens))
        if req.prefilled >= len(req.tokens):
            self._prefilling.pop(slot)
            self._post_admit([req], [slot], logits.cpu().numpy())

    def _by_bucket(self, reqs: List[_Request], length, minimum: int
                   ) -> Dict[int, List[_Request]]:
        groups: Dict[int, List[_Request]] = {}
        for req in reqs:
            bucket = min(ld.cache_bucket(length(req), minimum),
                         self.capacity)
            groups.setdefault(bucket, []).append(req)
        return groups

    def _admit_full(self, reqs: List[_Request]) -> None:
        """Prefix-cache misses: one batched prefill per prompt bucket,
        written straight into the wave's slots."""
        for bucket, group in self._by_bucket(
                reqs, lambda r: len(r.tokens), self.prefill_bucket).items():
            slots = [self._free.pop() for _ in group]
            rows = np.zeros((len(group), bucket), np.int32)
            for i, req in enumerate(group):
                rows[i, :len(req.tokens)] = req.tokens
            lengths = [len(r.tokens) for r in group]
            self.prefill_waves += 1
            t0 = time.time()
            self._mark_compile(("prefill", len(group), bucket))
            logits, self.cache = ld.prefill(
                self.params, self._dev(rows), self.cache, self.config,
                lengths=self._dev(lengths), rows=self._dev(slots))
            logits = logits.cpu().numpy()
            self._phase("prefill", t0, n=len(group), bucket=bucket)
            self._wave_span("prefill", t0, group, n=len(group),
                            bucket=bucket)
            self._post_admit(group, slots, logits)

    def _admit_suffix(self, reqs: List[_Request]) -> None:
        """Prefix-cache hits: splice each matched pool entry into its
        request's slot (in place) and prefill only the uncached suffix."""
        for bucket, group in self._by_bucket(
                reqs, lambda r: len(r.tokens) - r.prefix_len,
                self._suffix_bucket_min).items():
            slots = [self._free.pop() for _ in group]
            rows = np.zeros((len(group), bucket), np.int32)
            for i, req in enumerate(group):
                suffix = req.tokens[req.prefix_len:]
                rows[i, :len(suffix)] = suffix
            slot_ids = self._dev(slots)
            # The splice copies the WHOLE entry region: positions past
            # the match are overwritten by the suffix or causally masked.
            ld.prefix_splice(self.cache, self._pool, slot_ids,
                             self._dev([r.prefix_entry for r in group]))
            self.suffix_waves += 1
            t0 = time.time()
            self._mark_compile(("suffix", len(group), bucket))
            logits, self.cache = ld.prefill_suffix(
                self.params, self._dev(rows), self.cache, self.config,
                self._dev([r.prefix_len for r in group]),
                self._dev([len(r.tokens) for r in group]), rows=slot_ids)
            logits = logits.cpu().numpy()
            self._phase("suffix-prefill", t0, n=len(group), bucket=bucket)
            self._wave_span("suffix-prefill", t0, group, n=len(group),
                            bucket=bucket)
            for req in group:
                # Stream order makes the splice read precede any later
                # write to the entry, so the row may now be recycled.
                self.prefix.release(req.prefix_entry)
            self._post_admit(group, slots, logits)

    def _post_admit(self, group: List[_Request], slots: List[int],
                    logits: np.ndarray) -> None:
        # The paged insert runs BEFORE the emit loop: a request that
        # completes on its first token is _finish-ed inside that loop,
        # which frees its pages; pinning them afterwards would pin
        # recycled pages. Inserting first pins the slot's pages while the
        # slot still owns them (zero copy); _finish then drops only the
        # slot's own references.
        if self.prefix is not None and self.paged:
            for req, slot in zip(group, slots):
                self.prefix.insert(req.tokens, self._slot_pages[slot],
                                   matched_len=req.prefix_len)
        now = time.monotonic()
        self._tokens_dev = None  # host token writes below
        for i, req in enumerate(group):
            req.slot = slots[i]
            if req.first_token_at is None:  # a preempted request keeps
                req.first_token_at = now    # its first token's time
            self._active[slots[i]] = req
            tok = self._sample_host(logits[i], req)
            if req.prefill_only:
                # Disaggregated prefill's terminal: the deliverable is the
                # slot's filled pages and the sampled first token, which
                # rides the descriptor (the decode side emits it). The
                # slot's pages free at once; the insert above pinned the
                # shareable ones.
                self._capture_handoff(req, slots[i], tok)
                self._finish(slots[i])
                continue
            self._advance(slots[i], tok)
        # The contiguous insert stays AFTER: it copies the slot's leading
        # positions into a pool row, and the rows still hold the prompt
        # K/V (a _finish only parks ``length``). Inserts run before any
        # later admission can recycle these slots.
        if self.prefix is not None and not self.paged:
            for req, slot in zip(group, slots):
                ins = self.prefix.insert(req.tokens,
                                         matched_len=req.prefix_len)
                if ins is not None:
                    row, _ins_len = ins
                    self._mark_compile(("pool_insert",))
                    ld.prefix_insert(self.cache, self._pool, slot, row)
        if self.spec:
            self._draft_seat([r for r in group if not r.done.is_set()])

    def _capture_handoff(self, req: _Request, slot: int,
                         first_token: int) -> None:
        """Copy the slot's filled pages to the host as the handoff payload:
        a gather of page payloads (no model math), so an adopting engine's
        state equals having prefilled there. The payload must own its
        bytes, or later in-place pool writes would reach a published
        payload: the gather makes a new tensor, and ``copy=True`` copies
        on every device (on a CPU engine ``.to("cpu")`` alone returns its
        input). The copy to pageable host memory returns once the bytes
        are there. On a mesh every rank gathers the kv heads over "model"
        and rank 0 alone copies them to the host."""
        t0 = time.time()
        ids = self._dev(self._slot_pages[slot])
        k, v = (self._whole_heads(self.cache[name][:, ids])
                for name in ("k", "v"))
        nbytes = int(k.nbytes + v.nbytes)
        # The payload lives on rank 0 only.
        k, v = ((k.to("cpu", copy=True), v.to("cpu", copy=True))
                if self._lead else (None, None))
        req.handoff = {
            "k": k, "v": v,
            "committed_len": int(req.prompt_len),
            "first_token": int(first_token),
            "page_tokens": self.page_tokens,
            "nbytes": nbytes,
        }
        self.handoffs_published += 1
        if self.steplog.enabled:
            self.steplog.event("handoff", slot=slot, pages=len(ids),
                               nbytes=req.handoff["nbytes"])
        self._phase("handoff", t0, slot=slot, pages=len(ids))

    def _pool_shape(self) -> Tuple[int, ...]:
        """The page pool's shape with all kv heads (a mesh rank holds its
        block of them)."""
        shape = list(self.cache["k"].shape)
        shape[3] = self.config.n_kv_heads
        return tuple(shape)

    def _whole_heads(self, pages: torch.Tensor) -> torch.Tensor:
        """(L, n, T, KV, D) pages with every kv head: this rank's gathered
        over "model" on a mesh."""
        if self._shards is None:
            return pages
        return self._shards.gather(pages, 3, "kv_heads")

    # ------------------------------------------------------ draft seats

    def _draft_seat(self, reqs: List[_Request]) -> None:
        """Give each newly seated slot its draft state: draft pages for the
        whole prompt and a full draft prefill (a target prefix hit still
        draft-prefills everything: the draft pool has no prefix index, and
        the draft is cheap by construction). A slot the draft pool cannot
        seat even after evicting younger draft seats becomes draftless."""
        for req in reqs:
            self._draft_prefill_slot(req.slot, req,
                                     np.asarray(req.tokens, np.int32))

    def _draft_prefill_slot(self, slot: int, req: _Request, seq: np.ndarray,
                            reserve: int = 0) -> bool:
        """Allocate draft pages covering ``seq`` plus ``reserve`` more
        positions and prefill ``seq`` into the slot's draft state; ``seq``
        is the true committed stream (the prompt at admission, prompt +
        output on resync). False when the slot no longer holds ``req``
        (it finished or was preempted in this admission) or the pool is
        dry even after evictions (the slot is demoted to draftless)."""
        if self._active.get(slot) is not req:
            return False
        n = min(self._seq_pages(len(seq) + reserve), self.slot_pages_max)
        got = self._draft_pages.alloc(n)
        while got is None and self._draft_evict_one(slot):
            got = self._draft_pages.alloc(n)
        if got is None:
            self._draft_demote(slot, req)
            return False
        self._draft_bt[slot, :] = 0
        self._draft_bt[slot, :len(got)] = got
        self._draft_slot_pages[slot] = got
        bucket = min(ld.cache_bucket(len(seq), self.prefill_bucket),
                     self.capacity)
        rows = np.zeros((1, bucket), np.int32)
        rows[0, :len(seq)] = seq
        t0 = time.time()
        self._mark_compile(("draft_prefill", 1, bucket))
        with local_shards(self._draft_shards):
            ld.paged_prefill(
                self._draft_params, self._dev(rows), self._draft_cache,
                self._dev(self._draft_bt[slot:slot + 1,
                                         :self._seq_pages(bucket)]),
                self._draft_config, lengths=self._dev([len(seq)]))
        self._draft_cache["length"][slot] = len(seq)
        self._draft_committed[slot] = len(seq)
        self._phase("draft-prefill", t0, tokens=len(seq))
        self._wave_span("draft-prefill", t0, [req], tokens=len(seq))
        return True

    def _draft_resync(self, slot: int, req: _Request) -> bool:
        """Plain-step interludes (a sampled request in the batch, a
        draftless neighbour, decode chunks) advance the target while the
        draft idles; once the draft is more than one round behind, its
        catch-up row cannot close the gap, so the slot's draft state is
        rebuilt by one draft prefill of the true sequence, with pages for
        this round's writes too."""
        L = req.prompt_len + req.generated - 1
        self._draft_pages.free(self._draft_slot_pages[slot])
        self._draft_slot_pages[slot] = []
        self._draft_bt[slot, :] = 0
        seq = np.asarray([self._token_at(req, p) for p in range(L)],
                         np.int32)
        return self._draft_prefill_slot(slot, req, seq, reserve=self.spec_k)

    @staticmethod
    def _token_at(req: _Request, p: int) -> int:
        """True committed token at absolute position ``p``: the prompt,
        then the output (also for a re-admitted preempted request, whose
        ``prompt_len`` stays the ORIGINAL prompt's length)."""
        return (int(req.tokens[p]) if p < req.prompt_len
                else int(req.output[p - req.prompt_len]))

    def _dev(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), device=self.device)

    # ----------------------------------------------------- token output

    def _sample_host(self, logits: np.ndarray, req: _Request) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        z = logits / req.temperature
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    _last_cb_log = 0.0  # class-wide rate limit for callback-failure logs

    def _emit(self, req: _Request, tok: int) -> None:
        req.output.append(tok)
        req.generated += 1
        self.tokens_out += 1
        if req.on_token is None:
            return
        try:
            req.on_token(tok)
        except Exception as e:  # noqa: BLE001 — the decode loop must
            # survive a broken streaming consumer; record the FIRST
            # failure on the request and log it (rate-limited).
            if req.on_token_error is None:
                req.on_token_error = f"{type(e).__name__}: {e}"
                now = time.monotonic()
                if now - DecodeEngine._last_cb_log > 1.0:
                    DecodeEngine._last_cb_log = now
                    logger.warning(
                        "on_token callback failed (slot %d, %d tokens "
                        "emitted): %s", req.slot, req.generated,
                        req.on_token_error, exc_info=True)

    # -------------------------------------------------- slot lifecycle

    def _release_slot(self, slot: int) -> None:
        """Slot teardown shared by _finish and preemption. Paged mode drops
        the slot's page references (shared prefix pages survive on the
        index's pins; pages it owns alone recycle at once) and points its
        block-table row at the scratch page."""
        if self.paged:
            pages = self._slot_pages[slot]
            self._slot_pages[slot] = []
            self._block_tables[slot, :] = 0
            self._pages.free(pages)
            if pages and self.steplog.enabled:
                self.steplog.event("page-free", n=len(pages),
                                   free=self._pages.free_count)
        if self.spec:
            self._draft_pages.free(self._draft_slot_pages[slot])
            self._draft_slot_pages[slot] = []
            self._draft_bt[slot, :] = 0
            self._draft_committed[slot] = 0
            self._draft_cache["length"][slot] = 0
        self._free.append(slot)
        # Park the freed slot at length 0 so idle slots don't walk their
        # cursor toward the capacity edge while others decode.
        self.cache["length"][slot] = 0
        self._tokens[slot] = 0
        self._tokens_dev = None

    def _finish(self, slot: int, status: str = "completed") -> None:
        req = self._active.pop(slot, None)
        if req is None:
            req = self._prefilling.pop(slot)  # died mid-chunked-prefill
        # Return the slot right after the pop: stats() reads both sides
        # from other threads.
        self._release_slot(slot)
        req.status = status
        req.finished_at = time.monotonic()
        if status == "completed":
            service = req.finished_at - req.submitted_at
            self._ema_request_s = (service if self._ema_request_s <= 0
                                   else 0.7 * self._ema_request_s
                                   + 0.3 * service)
        elif status == "cancelled":
            self.cancelled += 1
        elif status == "deadline_exceeded":
            self.deadline_exceeded += 1
        self._observe_terminal(req, status)
        with self._reqs_lock:
            self._requests.pop(req.request_id, None)
        req.done.set()

    def _retire(self, req: _Request, status: str) -> None:
        """Terminal exit for a request that never held a slot."""
        req.status = status
        req.finished_at = time.monotonic()
        if status == "cancelled":
            self.cancelled += 1
        elif status == "deadline_exceeded":
            self.deadline_exceeded += 1
        self._observe_terminal(req, status)
        with self._reqs_lock:
            self._requests.pop(req.request_id, None)
        req.done.set()

    def _purge_pending(self) -> None:
        """Drop dead entries (cancelled / deadline-expired) from the
        pending queue without waiting for a slot to free. One
        FIFO-preserving rotation."""
        now = time.monotonic()
        for _ in range(self._pending.qsize()):
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            with self._reqs_lock:
                dead = req.cancelled
                if dead:
                    self._queued_cancelled -= 1
                    req.admitted = True
            if dead:
                self._queued_tokens -= len(req.tokens)
                self._retire(req, "cancelled")
            elif self._expired(req, now):
                with self._reqs_lock:
                    req.admitted = True
                self._queued_tokens -= len(req.tokens)
                self._retire(req, "deadline_exceeded")
            else:
                self._pending.put(req)
        # Preempted and pushed-back requests wait in _requeue, not the
        # queue: their cancels and deadlines take the same prompt exit.
        for req in list(self._requeue):
            with self._reqs_lock:
                dead = req.cancelled
                if dead:
                    self._queued_cancelled -= 1
                    req.admitted = True
            expired = not dead and self._expired(req, now)
            if dead or expired:
                self._requeue.remove(req)
                self._queued_tokens -= len(req.tokens)
                if expired:
                    with self._reqs_lock:
                        req.admitted = True
                self._retire(req, "cancelled" if dead
                             else "deadline_exceeded")

    def _reap(self) -> None:
        """Free slots whose requests are dead (cancelled, or past their
        deadline): a dead request costs at most ONE more decode step."""
        now = time.monotonic()
        due = (self._purge_due if self._ctl is not None
               else now - self._last_purge > 0.5)
        if (self._queued_cancelled > 0
                or (due and (self._requeue or not self._pending.empty()))):
            self._last_purge = now
            self._purge_pending()
        # Mid-chunked-prefill slots die the same way as active ones: their
        # pages (all but shared ones) free within one step boundary.
        for slots in (self._active, self._prefilling):
            for slot in list(slots):
                req = slots[slot]
                if req.cancelled:
                    self._finish(slot, "cancelled")
                elif self._expired(req, now):
                    self._finish(slot, "deadline_exceeded")

    # --------------------------------------------------------- the loop

    def _pick_chunk(self) -> int:
        """Greedy decode steps fusable into one call right now: only when
        the batch cannot change mid-chunk, every request is greedy and no
        chunked prefill is in flight (its point is a chunk between EVERY
        two steps). Rounded down to a power of two, as in the JAX
        engine."""
        if (self.decode_chunk > 1
                and (self._pending.empty() or not self._free)
                and not self._requeue and not self._prefilling
                and all(r.temperature <= 0.0
                        for r in self._active.values())):
            chunk = min(self.decode_chunk,
                        min(r.max_new_tokens - r.generated
                            for r in self._active.values()))
            while chunk & (chunk - 1):
                chunk &= chunk - 1
            return chunk
        return 1

    def _decode_tables(self, k: int,
                       tables: Optional[np.ndarray] = None) -> torch.Tensor:
        """The columns of ``tables`` (default: the target's block tables)
        the active slots reach over their next ``k`` writes, uploaded once
        for the call. Rows of idle and mid-prefill slots whose cursor lies
        past them write to the scratch page."""
        top = max(r.prompt_len + r.generated - 1
                  for r in self._active.values())
        width = min(self._seq_pages(top + k), self.slot_pages_max)
        tables = self._block_tables if tables is None else tables
        return self._dev(tables[:, :width])

    def _decode_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot on the device: (slots, V) fp32
        logits."""
        if self.paged:
            logits, _, self.cache["length"] = ld.paged_decode_step(
                self.params, self.cache, self._decode_tables(1),
                self.cache["length"], tokens, self.config)
            return logits
        logits, self.cache = ld.decode_step(self.params, self.cache, tokens,
                                            self.config)
        return logits

    def _advance(self, slot: int, tok: int) -> bool:
        """Emit ``tok`` for the active request in ``slot``; finish it at
        its token budget or EOS. Returns True when it finished."""
        req = self._active[slot]
        self._emit(req, tok)
        self._tokens[slot] = tok
        if req.generated >= req.max_new_tokens or (
                req.eos_id is not None and tok == req.eos_id):
            self._finish(slot)
            return True
        return False

    @torch.no_grad()
    def step(self) -> int:
        """Admit pending prefills, run at most one chunk of a chunked
        prefill, then advance every active slot: one speculative round
        when spec mode is on and every request is greedy, else one token
        (or one greedy chunk). Returns the number of slots stepped. With
        the step timeline on, the step's phases and events land as one
        ring row. On a mesh every rank first takes rank 0's control
        message; after a stop it returns 0 and does nothing."""
        if self._ctl is not None and not self._sync():
            return 0
        return self._step_logged()

    def _step_logged(self) -> int:
        t0 = time.time()
        self._step_phases = []
        with local_shards(self._shards):
            stepped = self._step()
        self._steplog_row(t0)
        return stepped

    def _step(self) -> int:
        self._reap()
        self._admit()
        if self.paged:
            self._prefill_tick()
        if not self._active:
            return 0
        if self._spec_ready():
            # Page both pools for the round first: the block tables are
            # fixed across the draft and verify calls. The target side may
            # preempt the youngest request; the draft side only evicts or
            # demotes draft seats.
            self._ensure_decode_pages(self.spec_k + 1)
            if not self._active:
                return 0
            self._ensure_draft_pages(self.spec_k)
            if self._spec_ready():
                return self._spec_step()
        chunk = self._pick_chunk()
        if self.paged:
            # Page the next k tokens in BEFORE the step: the block tables
            # are fixed across it. May preempt the youngest request.
            self._ensure_decode_pages(chunk)
            if not self._active:
                return 0
            chunk = min(chunk, self._pick_chunk())
        stepped = len(self._active)
        t0 = time.time()
        if chunk > 1:
            tokens = self._dev(self._tokens)
            self._mark_compile(("decode_k", chunk))
            if self.paged:
                toks, _, self.cache["length"] = ld.paged_decode_chunk(
                    self.params, self.cache, self._decode_tables(chunk),
                    self.cache["length"], tokens, self.config, chunk)
            else:
                toks, self.cache = ld.decode_chunk(
                    self.params, self.cache, tokens, self.config, chunk)
            toks = toks.cpu().numpy()  # (chunk, slots)
            self._phase("decode", t0, batch=stepped, k=chunk)
            self.steps += chunk
            self._tokens_dev = None
            for slot in list(self._active):
                for i in range(chunk):
                    if self._advance(slot, int(toks[i, slot])):
                        break
            return stepped
        if self._device_sampler:
            return self._sampled_step()
        self._mark_compile(("decode",))
        logits = self._decode_logits(self._dev(self._tokens)).cpu().numpy()
        self._phase("decode", t0, batch=stepped, k=1)
        self.steps += 1
        for slot in list(self._active):
            self._advance(slot, self._sample_host(logits[slot],
                                                  self._active[slot]))
        return stepped

    def _sampled_step(self) -> int:
        """One decode step with sampling on the device: only (slots,)
        token ids cross to the host, and the next sampled step takes them
        back without an upload. Greedy rows equal the host sampler's;
        sampled rows draw from the step-seeded generator."""
        stepped = len(self._active)
        temps = np.zeros((self.slots,), np.float32)
        for slot, req in self._active.items():
            temps[slot] = max(0.0, req.temperature)
        tokens = (self._tokens_dev if self._tokens_dev is not None
                  else self._dev(self._tokens))
        t0 = time.time()
        self._mark_compile(("decode_sampled",))
        logits = self._decode_logits(tokens)
        self._generator.manual_seed(self.steps)
        toks_dev = ld.sample_batch(logits, self._dev(temps), self._generator)
        toks = toks_dev.cpu().numpy()
        self._phase("decode", t0, batch=stepped, k=1, sampler="device")
        self.steps += 1
        self._tokens_dev = toks_dev  # _finish drops it below
        for slot in list(self._active):
            self._advance(slot, int(toks[slot]))
        return stepped

    # ----------------------------------------------- speculative rounds

    def _spec_ready(self) -> bool:
        """Spec rounds run only when every active request is greedy (the
        acceptance rule compares argmax tokens; a sampled request takes
        the plain path to keep its sampler's stream) and at least one
        active slot holds a draft seat (an all-draftless batch would pay
        the k+1-wide verify for proposals that are all rejected)."""
        return (self.spec and bool(self._active)
                and all(r.temperature <= 0.0
                        for r in self._active.values())
                and any(self._draft_committed[s] >= 0
                        for s in self._active))

    def _spec_step(self) -> int:
        """One speculative round: the draft catches up on last round's
        accepted tokens and proposes ``k`` a slot, the target verifies all
        ``k + 1`` positions in ONE batched forward, the longest proposal
        prefix equal to the target's own argmaxes is emitted with the
        target's next token, and both pools' cursors and tail pages roll
        back over the rejected rest. Emits 1..k+1 tokens a slot; each is
        the target's argmax at its position, given the tokens before it."""
        k = self.spec_k
        stepped = len(self._active)
        # ---- draft: the catch-up rows, then k proposals a slot
        catchup = np.zeros((self.slots, 2), np.int32)
        clens = np.ones((self.slots,), np.int32)
        for slot, req in list(self._active.items()):
            D = self._draft_committed[slot]
            if D < 0:
                continue  # draftless: junk proposals, still verified
            L = req.prompt_len + req.generated - 1
            if L - D + 1 > 2:
                # The resync may evict younger draft seats or demote this
                # slot; either leaves the round correct.
                if not self._draft_resync(slot, req):
                    continue
                D = self._draft_committed[slot]
            cl = L - D + 1
            for j in range(cl):
                catchup[slot, j] = self._token_at(req, D + j)
            clens[slot] = cl
        t0 = time.time()
        self._mark_compile(("spec_draft", k))
        with local_shards(self._draft_shards):
            toks_d, _ = ld.paged_spec_draft(
                self._draft_params, self._draft_cache,
                self._decode_tables(k, self._draft_bt),
                self._draft_cache["length"], self._dev(catchup),
                self._dev(clens), self._draft_config, k)
        # Copies: on the CPU a .numpy() view aliases the tensor.
        toks_d = toks_d.cpu().numpy().copy()               # (slots, k)
        self._phase("draft", t0, batch=stepped, k=k)
        # ---- target: all k+1 positions in one batched forward
        rows = np.zeros((self.slots, k + 1), np.int32)
        for slot in self._active:
            rows[slot, 0] = self._tokens[slot]
            rows[slot, 1:] = toks_d[slot]
        t0 = time.time()
        self._mark_compile(("spec_verify", k))
        logits, _ = ld.paged_verify(
            self.params, self._dev(rows), self.cache,
            self._decode_tables(k + 1), self.config, self.cache["length"])
        toks_v = torch.argmax(logits, dim=-1).to(
            torch.int32).cpu().numpy().copy()              # (slots, k+1)
        # ---- host: longest matching prefix, emission, rollback
        self.steps += 1
        self.spec_rounds += 1
        self._tokens_dev = None  # host token writes below
        accepted = 0
        upd: List[Tuple[int, int, int]] = []   # (slot, L', D')
        for slot in list(self._active):
            req = self._active[slot]
            g = toks_v[slot]
            n_acc = 0
            while n_acc < k and rows[slot, n_acc + 1] == g[n_acc]:
                n_acc += 1
            if self._draft_committed[slot] >= 0:
                req.spec_proposed += k
                req.spec_accepted += n_acc
                self.spec_proposed += k
                self.spec_accepted += n_acc
                accepted += n_acc
            L = req.prompt_len + req.generated - 1
            emitted = 0
            for j in range(n_acc + 1):
                emitted += 1
                if self._advance(slot, int(g[j])):
                    break  # EOS or max_new_tokens: both pools freed
            if slot not in self._active:
                continue
            committed = L + emitted
            if self._draft_committed[slot] >= 0:
                # The draft's K/V is true through L + min(n_acc, k - 1):
                # its catch-up row and its accepted proposals.
                self._draft_committed[slot] = L + min(emitted, k)
            self._rollback_pages(slot, committed)
            upd.append((slot, committed,
                        max(0, self._draft_committed[slot])))
        if upd:
            ids = self._dev([u[0] for u in upd])
            self.cache["length"][ids] = self._dev(
                [u[1] for u in upd]).to(torch.int32)
            self._draft_cache["length"][ids] = self._dev(
                [u[2] for u in upd]).to(torch.int32)
        self._phase("verify", t0, batch=stepped, k=k, accepted=accepted)
        return stepped

    # ----------------------------------------------------- step timeline

    def _mark_compile(self, key: tuple) -> None:
        """The first dispatch of a program key: the JAX engine compiles a
        program there; here it is the first call of that shape (on a card,
        the flash kernel's build and cuBLAS's first call)."""
        if key not in self._compiled:
            self._compiled.add(key)
            if self.steplog.enabled:
                self.steplog.event("jit-compile", key="/".join(
                    str(k) for k in key))

    def _phase(self, name: str, t0: float, **attrs: Any) -> None:
        """Close one timed phase of the current step (host wall clock)."""
        if self.steplog.enabled:
            self._step_phases.append(
                {"phase": name, "t0": t0, "t1": time.time(), **attrs})

    def _steplog_row(self, t0: float) -> None:
        """Close the step's timeline row; an idle step with no phases and
        no pending events records nothing (an idle engine must not churn
        useful rows out of the bounded ring)."""
        phases, self._step_phases = self._step_phases, []
        if not self.steplog.enabled or not (phases
                                            or self.steplog.pending_events):
            return
        self.steplog.record(
            self.steps, t0, time.time(), phases,
            active=len(self._active), prefilling=len(self._prefilling),
            queued=max(0, self._pending.qsize() + len(self._requeue)
                       - self._queued_cancelled),
            pages_free=self._pages.free_count if self.paged else None)

    def timeline(self) -> Dict[str, Any]:
        """The step-timeline dump with the engine's shape."""
        out = self.steplog.dump()
        out["deployment"] = self._mtags["deployment"]
        out["replica_id"] = self._replica_id
        out["paged"] = self.paged
        out["slots"] = self.slots
        out["spec_k"] = self.spec_k if self.spec else 0
        return out

    # ------------------------------------------------------------ warmup

    @torch.no_grad()
    def warmup(self) -> None:
        """Run one of each step call on the idle engine (paged: one
        ``prefill_bucket`` prefill, decode, every power-of-two decode
        chunk up to ``decode_chunk``, the device sampler, the spec draft
        and verify; contiguous: decode, the chunks, the sampler), so the
        first requests do not pay their first calls: on a card the flash
        kernel's build and cuBLAS's first call of each shape. Paged writes
        go to the scratch page (idle block tables are all zeros),
        contiguous ones to idle rows the next admission overwrites; the
        KV lengths are zeroed after."""
        if self._active or self._prefilling:
            raise RuntimeError("warmup needs an idle engine")
        with local_shards(self._shards):
            self._warmup()

    def _warmup(self) -> None:
        toks = self._dev(self._tokens)
        temps = torch.zeros((self.slots,), device=self.device)
        if self.paged:
            bucket = self.prefill_bucket
            self._mark_compile(("paged_prefill", 1, bucket))
            ld.paged_prefill(
                self.params, torch.zeros((1, bucket), dtype=torch.long,
                                         device=self.device),
                self.cache, self._dev(
                    self._block_tables[:1, :self._seq_pages(bucket)]),
                self.config, lengths=self._dev([1]))
            bt = self._dev(self._block_tables[:, :1])
            lens = self.cache["length"]
            self._mark_compile(("decode",))
            ld.paged_decode_step(self.params, self.cache, bt, lens, toks,
                                 self.config)
            c = 2
            while c <= self.decode_chunk:
                self._mark_compile(("decode_k", c))
                ld.paged_decode_chunk(self.params, self.cache, bt, lens,
                                      toks, self.config, c)
                c *= 2
            if self._device_sampler:
                self._mark_compile(("decode_sampled",))
                logits, _, _ = ld.paged_decode_step(
                    self.params, self.cache, bt, lens, toks, self.config)
                ld.sample_batch(logits, temps, self._generator)
            if self.spec:
                k = self.spec_k
                self._mark_compile(("spec_draft", k))
                with local_shards(self._draft_shards):
                    ld.paged_spec_draft(
                        self._draft_params, self._draft_cache,
                        self._dev(self._draft_bt[:, :1]),
                        self._draft_cache["length"],
                        torch.zeros((self.slots, 2), dtype=torch.int32,
                                    device=self.device),
                        torch.ones((self.slots,), dtype=torch.int32,
                                   device=self.device),
                        self._draft_config, k)
                self._mark_compile(("spec_verify", k))
                ld.paged_verify(
                    self.params, torch.zeros((self.slots, k + 1),
                                             dtype=torch.int32,
                                             device=self.device),
                    self.cache, bt, self.config, lens)
                self._draft_cache["length"].zero_()
        else:
            self._mark_compile(("decode",))
            ld.decode_step(self.params, self.cache, toks, self.config)
            c = 2
            while c <= self.decode_chunk:
                self._mark_compile(("decode_k", c))
                ld.decode_chunk(self.params, self.cache, toks, self.config,
                                c)
                c *= 2
            if self._device_sampler:
                self._mark_compile(("decode_sampled",))
                logits, _ = ld.decode_step(self.params, self.cache, toks,
                                           self.config)
                ld.sample_batch(logits, temps, self._generator)
        self.cache["length"].zero_()
        self._tokens_dev = None

    def serve_forever(self, idle_wait_s: float = 0.05) -> None:
        """Decode loop for a serving thread: steps while work exists,
        parks on an event while idle. If a step raises, every live
        request ends with the error (instead of waiting forever) and the
        loop stops. On a mesh it runs on every rank: each iteration takes
        rank 0's control message first (rank 0 sends one at least every
        ``idle_wait_s`` while idle), and every rank stops at rank 0's
        stop."""
        with self._sync_lock:
            self._looping = True
        try:
            while not self._stop.is_set() or self._ctl is not None:
                if self._ctl is not None and not self._sync():
                    return
                if self._has_work():
                    self._step_logged()
                elif self._lead:
                    self._work.clear()
                    if not (self._intake or self._intake_cancels
                            or self._stop.is_set()):
                        self._work.wait(timeout=idle_wait_s)
        except Exception as e:
            logger.exception("decode loop failed")
            self._fail_all(f"decode loop failed: {type(e).__name__}: {e}")
            raise
        finally:
            # Under the lock: ``shutdown`` decides under it whether a
            # loop is left to send rank 0's stop.
            with self._sync_lock:
                self._looping = False

    def _has_work(self) -> bool:
        return bool(self._active or self._prefilling or self._requeue
                    or not self._pending.empty())

    def _fail_all(self, message: str) -> None:
        with self._reqs_lock:
            live = list(self._requests.values())
            self._requests.clear()
        for req in live:
            req.error = message
            req.status = "error"
            req.done.set()

    def shutdown(self) -> None:
        """Stop the decode loop. On a mesh rank 0 stops every rank: its
        next control message says stop, sent at once when no loop is
        running (the other ranks' ``shutdown`` only wakes their loop)."""
        self._stop.set()
        self._work.set()
        if self._ctl is not None and self._lead:
            with self._sync_lock:
                if not self._looping:
                    self._sync()

    # ------------------------------------------------------------ stats

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens accepted but not yet prefilled: the queue, the
        requeue and the remainder of mid-prefill slots."""
        backlog = max(0, self._queued_tokens)
        for req in list(self._prefilling.values()):
            backlog += max(0, len(req.tokens) - req.prefilled)
        return backlog

    def stats(self) -> Dict[str, Any]:
        active = len(self._active)
        prefilling = len(self._prefilling)
        queued = max(0, self._pending.qsize() + len(self._requeue)
                     - self._queued_cancelled)
        backlog = self.prefill_backlog_tokens()
        # Backlog tokens -> load units: one prefill chunk (or one prompt
        # bucket, unchunked) is about one step's work.
        denom = self.prefill_chunk_tokens or self.prefill_bucket
        out = {
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            # Chips this engine spans, and its (batch, model) mesh.
            "chips": self.mesh.size() if self.mesh is not None else 1,
            "mesh_shape": (list(self.mesh.shape) if self.mesh is not None
                           else None),
            "active": active,
            "prefilling": prefilling,
            "slots": self.slots,
            "free_slots": len(self._free),
            "queued": queued,
            "queue_max": self.queue_max,
            "shed": self.shed,
            "cancelled": self.cancelled,
            "deadline_exceeded": self.deadline_exceeded,
            "preempted": self.preempted,
            "prefill_waves": self.prefill_waves,
            "suffix_waves": self.suffix_waves,
            "prefill_chunks": self.prefill_chunks,
            "prefill_backlog_tokens": backlog,
            "load": active + prefilling + queued + backlog // max(1, denom),
        }
        if self.paged:
            out.update(self._pages.stats())
            out["page_tokens"] = self.page_tokens
            out["pages_pinned"] = (self.prefix.pinned_pages
                                   if self.prefix is not None else 0)
            out["kv_fragmentation"] = self._fragmentation()
            out["handoffs_published"] = self.handoffs_published
            out["handoffs_adopted"] = self.handoffs_adopted
        if self.spec:
            out["spec"] = {
                "k": self.spec_k,
                "rounds": self.spec_rounds,
                "proposed_tokens": self.spec_proposed,
                "accepted_tokens": self.spec_accepted,
                "accept_rate": (
                    round(self.spec_accepted / self.spec_proposed, 4)
                    if self.spec_proposed else None),
                "draft_pages_total": self._draft_pages.pages,
                "draft_pages_free": self._draft_pages.free_count,
                "draft_demotions": self.spec_demotions,
            }
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        if self.steplog.enabled:
            out["step_timeline_rows"] = len(self.steplog._rows)
            out["step_timeline_dropped"] = self.steplog.dropped
        return out

    def set_metrics_deployment(self, name: str) -> None:
        """Re-label this engine's SLO metrics (a caller separates its
        warmup from the measured run this way; requests observe under the
        label current at their terminal step)."""
        self._mtags = {"deployment": name}

    def _fragmentation(self) -> float:
        """Internal fragmentation of the page pool: the share of allocated
        page-token capacity that backs no live token. Pages are
        interchangeable, so external fragmentation is zero by
        construction: the waste is partial tail pages."""
        valid: Dict[int, int] = {}
        T = self.page_tokens
        rows = ([(s, r.prompt_len + r.generated)
                 for s, r in list(self._active.items())]
                + [(s, r.prefilled)
                   for s, r in list(self._prefilling.items())])
        for slot, length in rows:
            for i, page in enumerate(self._slot_pages[slot]):
                end = min(T, length - i * T)
                if end > 0:
                    valid[page] = max(valid.get(page, 0), end)
        if self.prefix is not None:
            # Prefix-pinned pages are always full by construction.
            for page in self.prefix.pinned_page_ids():
                valid[page] = T
        in_use = self._pages.in_use
        if not in_use:
            return 0.0
        used_tokens = sum(valid.values())
        return round(max(0.0, 1.0 - used_tokens / (in_use * T)), 4)


class LlamaDecodeDeployment:
    """Deployment wrapping a DecodeEngine: ``{"tokens": [...],
    "max_new_tokens": N}`` -> ``{"tokens": [...], "ttft_s": ...}``, or a
    token generator with ``"stream": true``. Random weights from ``seed``
    on ``device`` (``cuda`` unless the caller passes another); with
    ``spec_draft_model`` (a preset over the target's vocab) and
    ``spec_k``, a draft model with random weights from ``seed + 1``.
    ``warmup`` runs ``DecodeEngine.warmup`` before the decode loop
    starts. ``metrics_deployment`` labels the engine's SLO metrics
    (default: the hosting replica's deployment name, as the JAX
    deployment labels them). As a serve replica, schedule it with
    ``ray_actor_options={"num_gpus": 1}``: the node spawns it a fresh
    worker that sees the card.
    ``mesh_shape`` serves one replica over a decode mesh of every rank of
    the default process group: build the deployment on every rank (same
    ``seed``); rank 0 answers calls, and its ``shutdown`` stops them all.

    Disaggregated serving: ``prefill_handoff`` prefills a request and
    publishes its pages as a lease (refs on the runtime's object store,
    ``core.api``, plus a small descriptor); ``decode_adopted`` /
    ``stream_adopted`` on another deployment adopt the pages and decode;
    the caller then ``discharge_handoff``s or ``abort_handoff``s the
    lease, and ``replica_metrics`` sweeps leases past
    ``serve_handoff_ttl_s``. Under ``serve.run`` with ``role="prefill"``
    the router does all of that: it splices the two halves across the
    prefill and decode fleets."""

    def __init__(self, preset: str = "debug", slots: int = 4,
                 capacity: int = 1024, seed: int = 0,
                 config=None, decode_chunk: int = 1,
                 prefix_pool_entries: Optional[int] = None,
                 prefix_capacity: Optional[int] = None,
                 prefix_match_min_tokens: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 kv_page_tokens: Optional[int] = None,
                 kv_pool_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 mesh_shape=None,
                 spec_draft_model: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 spec_draft_pool_pages: Optional[int] = None,
                 device_sampler: Optional[bool] = None,
                 warmup: Optional[bool] = None,
                 metrics_deployment: Optional[str] = None,
                 device=None):
        cfg = config or llama.PRESETS[preset]
        self.cfg = cfg
        self._sub_slice: Optional[Dict[str, Any]] = None
        draft_name = (rt_config.spec_draft_model if spec_draft_model is None
                      else spec_draft_model)
        sk = rt_config.spec_k if spec_k is None else int(spec_k)
        draft_cfg = None
        if draft_name and sk > 0:
            draft_cfg = llama.PRESETS[draft_name]
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"spec_draft_model {draft_name!r} vocab "
                    f"({draft_cfg.vocab_size}) != target vocab "
                    f"({cfg.vocab_size}): proposals must share the token "
                    f"space the target verifies")
        dev = resolve_device(device)
        params = llama.init_params(cfg, device=dev, seed=seed)
        draft_params = (None if draft_cfg is None else
                        llama.init_params(draft_cfg, device=dev,
                                          seed=seed + 1))
        self.engine = DecodeEngine(
            params, cfg, slots=slots, capacity=capacity,
            decode_chunk=decode_chunk,
            prefix_pool_entries=prefix_pool_entries,
            prefix_capacity=prefix_capacity,
            prefix_match_min_tokens=prefix_match_min_tokens,
            queue_max=queue_max, page_tokens=kv_page_tokens,
            pool_pages=kv_pool_pages,
            prefill_chunk_tokens=prefill_chunk_tokens,
            mesh_shape=mesh_shape,
            spec_draft_params=draft_params, spec_draft_config=draft_cfg,
            spec_k=sk if draft_params is not None else 0,
            spec_draft_pool_pages=spec_draft_pool_pages,
            device_sampler=device_sampler,
            metrics_deployment=metrics_deployment, device=dev)
        if rt_config.decode_warmup if warmup is None else warmup:
            self.engine.warmup()
        # Prefill->decode handoff lease ledger: published but undischarged
        # handoffs, so the TTL sweep (riding replica_metrics) can free
        # refs nobody claimed.
        self._handoffs = HandoffLedger()
        self._thread = threading.Thread(target=self.engine.serve_forever,
                                        name="decode-loop", daemon=True)
        self._thread.start()

    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Stop the decode loop and join its thread."""
        self.engine.shutdown()
        self._thread.join(timeout_s)

    def set_topology(self, assignment: Dict[str, Any]) -> None:
        """Sub-slice assignment pushed by the serve controller; reported
        back through ``replica_metrics``."""
        self._sub_slice = dict(assignment)

    def replica_metrics(self) -> Dict[str, Any]:
        """Load, degradation counters, page-pool health, speculative and
        prefix state and the handoff ledger, as the JAX replica reports
        them to its controller. Also the handoff-lease backstop: leases
        past their TTL expire here and their refs are freed."""
        s = self.engine.stats()
        out: Dict[str, Any] = {"load": s["load"], "queued": s["queued"],
                               "shed": s["shed"],
                               "cancelled": s["cancelled"],
                               "deadline_exceeded": s["deadline_exceeded"],
                               "prefill_backlog_tokens":
                               s["prefill_backlog_tokens"],
                               "chips": s["chips"],
                               "mesh_shape": s["mesh_shape"]}
        if self._sub_slice is not None:
            out["sub_slice"] = dict(self._sub_slice)
            out["slice_id"] = self._sub_slice.get("slice_id")
        if self.engine.paged:
            for key in ("pages_total", "pages_free", "pages_in_use",
                        "pages_pinned", "kv_fragmentation", "preempted"):
                out[key] = s[key]
        if self.engine.spec:
            out["spec"] = s["spec"]
        if self.engine.prefix is not None:
            out["prefix"] = s.get("prefix", {})
            out["prefixes"] = self.engine.prefix.hashes()
        self._sweep_handoffs()
        out["handoffs_live"] = self._handoffs.live()
        out["handoff_live_bytes"] = self._handoffs.live_bytes()
        out["handoffs_published"] = s.get("handoffs_published", 0)
        out["handoffs_adopted"] = s.get("handoffs_adopted", 0)
        return out

    def _submit(self, request: Dict[str, Any], on_token=None,
                prefill_only: bool = False,
                adopt: Optional[Dict[str, Any]] = None) -> _Request:
        """Admission with the request's deadline attached: an explicit
        ``deadline_s`` in the payload wins, else the deadline the serve
        stack propagated with this call (proxy header, handle
        ``timeout_s`` or ``serve_request_timeout_s``)."""
        deadline_s = request.get("deadline_s")
        if deadline_s is None:
            deadline_s = request_deadline_s()
        return self.engine.submit(
            request["tokens"],
            max_new_tokens=int(request.get("max_new_tokens", 32)),
            temperature=float(request.get("temperature", 0.0)),
            eos_id=request.get("eos_id"),
            on_token=on_token,
            deadline_s=deadline_s,
            request_id=request.get("request_id"),
            prefill_only=prefill_only,
            adopt=adopt)

    def _wait_done(self, req: _Request) -> None:
        """Block until the engine finishes the request; with a deadline, a
        wedged loop turns into a cancel + deadline error instead of a
        hang."""
        if req.deadline is not None:
            if not req.done.wait(
                    max(0.1, req.deadline - time.monotonic()) + 10.0):
                self.engine.cancel(req.request_id)
                raise DeadlineExceededError(
                    f"request {req.request_id} not finished by the decode "
                    f"loop within its deadline")
        else:
            req.done.wait()

    def __call__(self, request: Dict[str, Any]):
        if request.get("stream"):
            return self.stream(request)
        req = self._submit(request)
        self._wait_done(req)
        req.raise_for_status()
        return {"tokens": req.output,
                "ttft_s": round(req.first_token_at - req.submitted_at, 4)}

    def stream(self, request: Dict[str, Any]):
        """Streaming generator: yields tokens as the engine emits them.
        Closing the generator cancels the engine request."""
        q: "queue.Queue" = queue.Queue()
        req = self._submit(request, on_token=q.put)
        yield from self._drain(req, q)

    def _drain(self, req: _Request, q: "queue.Queue"):
        """Yield ``req``'s tokens from ``q`` until it ends; re-raise its
        terminal error; cancel it if the consumer closes early."""
        try:
            while True:
                try:
                    yield q.get(timeout=0.5)
                    continue
                except queue.Empty:
                    pass
                if req.done.is_set():
                    while not q.empty():
                        yield q.get()
                    req.raise_for_status()
                    break
        finally:
            if not req.done.is_set():
                self.engine.cancel(req.request_id)

    # --------------------------------------- disaggregated prefill/decode

    def prefill_handoff(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Disaggregated prefill half: run admission and (chunked) prefill
        into this engine's paged pool, then publish the filled pages as
        object-plane refs plus a descriptor small enough to ride with the
        request (``HANDOFF_DESC_BYTE_BUDGET``).

        The descriptor is a LEASE: the caller must adopt-ack it
        (``discharge_handoff``) or abort it (``abort_handoff``) on every
        path; the ledger's TTL sweep is the backstop for a caller that
        died mid-splice."""
        req = self._submit(request, prefill_only=True)
        self._wait_done(req)
        req.raise_for_status()
        payload = req.handoff
        if payload is None:  # the engine retired the request pre-capture
            raise RuntimeError(
                f"prefill request {req.request_id} completed without a "
                f"handoff payload")
        desc = {
            "handoff_id": uuid.uuid4().hex[:16],
            "k_ref": api.put(payload["k"]),
            "v_ref": api.put(payload["v"]),
            "committed_len": payload["committed_len"],
            "first_token": payload["first_token"],
            "page_tokens": payload["page_tokens"],
            "nbytes": payload["nbytes"],
            "prefill_ttft_s": round(
                req.first_token_at - req.submitted_at, 4),
        }
        req.handoff = None  # the object plane owns the payload now
        self._handoffs.publish_handoff(desc)
        try:
            self._observe_handoff_published(desc)
        except BaseException:
            # The lease must not outlive a failed publish tail: hand the
            # refs back before the error escapes.
            self._drop_handoff(desc["handoff_id"], "aborted")
            raise
        return desc

    def discharge_handoff(self, handoff_id: str) -> None:
        """Adopt-ack: the decode side fetched the payload, so free the
        refs now. Idempotent."""
        self._drop_handoff(handoff_id, "adopted")

    def abort_handoff(self, handoff_id: str) -> None:
        """Splice failure (the decode side cannot adopt, or the request
        was cancelled): free the refs now. Idempotent, like discharge."""
        self._drop_handoff(handoff_id, "aborted")

    def _drop_handoff(self, handoff_id: str, event: str) -> None:
        """Discharge one published handoff and free its payload refs. The
        ledger referees a double discharge (abort racing the sweep)."""
        entry = self._handoffs.discharge_handoff(handoff_id)
        if entry is not None:
            self._discharge_entry(entry, event)

    def _sweep_handoffs(self) -> None:
        for entry in self._handoffs.sweep():
            self._discharge_entry(entry, "expired")

    def _discharge_entry(self, entry: Dict[str, Any], event: str) -> None:
        desc = entry["desc"]
        api.free([desc.get("k_ref"), desc.get("v_ref")])
        if self.engine._obs_metrics:
            tags = dict(self.engine._mtags)
            smetrics.HANDOFFS.inc(1.0, {**tags, "event": event})
            if event == "adopted":
                # publish -> adopt: the window the pages spent as host
                # objects between the two deployments.
                smetrics.HANDOFF_LATENCY.observe(entry["age_s"], tags)

    def _observe_handoff_published(self, desc: Dict[str, Any]) -> None:
        if not self.engine._obs_metrics:
            return
        tags = dict(self.engine._mtags)
        smetrics.HANDOFF_BYTES.observe(float(descriptor_nbytes(desc)), tags)
        smetrics.HANDOFFS.inc(1.0, {**tags, "event": "published"})

    def _fetch_adopt(self, desc: Dict[str, Any]) -> Dict[str, Any]:
        """Pull the handed-off payload off the object plane, shaped as the
        engine's adopt argument. Refs that are gone (freed, expired, or
        never in this process) raise the typed adopt error the router
        maps to re-prefill."""
        timeout = request_deadline_s() or 30.0
        try:
            k, v = api.get([desc["k_ref"], desc["v_ref"]],
                           timeout=max(1.0, timeout))
        except Exception as e:
            raise HandoffAdoptError(
                f"handoff {desc.get('handoff_id')} page payload "
                f"unavailable: {e!r}") from e
        return {"k": k, "v": v,
                "committed_len": desc["committed_len"],
                "first_token": desc["first_token"],
                "page_tokens": desc["page_tokens"]}

    def decode_adopted(self, request: Dict[str, Any],
                       desc: Dict[str, Any]) -> Dict[str, Any]:
        """Disaggregated decode half (unary): adopt the published pages
        into this engine's pool, with no recompute, and decode to the
        end."""
        req = self._submit(request, adopt=self._fetch_adopt(desc))
        self._wait_done(req)
        req.raise_for_status()
        return {"tokens": req.output,
                "ttft_s": desc.get("prefill_ttft_s", 0.0)}

    def stream_adopted(self, request: Dict[str, Any],
                       desc: Dict[str, Any]):
        """Streaming twin of ``decode_adopted``. The adoption (fetch and
        submit) runs in this call, not in the returned generator, so adopt
        failures raise here and the caller can discharge the prefill
        lease as soon as this returns."""
        q: "queue.Queue" = queue.Queue()
        req = self._submit(request, on_token=q.put,
                           adopt=self._fetch_adopt(desc))
        return self._drain(req, q)

    def health(self) -> Dict[str, Any]:
        return self.engine.stats()

    def timeline(self) -> Dict[str, Any]:
        """The engine's step-timeline dump."""
        return self.engine.timeline()
