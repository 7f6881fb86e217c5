"""Process-wide typed configuration flags (copy of
``ray_tpu/core/config.py``).

Analogue of the reference's ``RAY_CONFIG`` system (reference:
``src/ray/common/ray_config_def.h:18-22``). Every flag is declared once in
``_FLAG_DEFS`` with a type and default, under the JAX package's names and
defaults; ``RAY_TPU_<NAME>`` env vars override at import time and
``init(_system_config={...})`` overrides at runtime.

Where the port differs: the on-disk paths it owns (worker logs, spill,
flight recorder) live under their own ``ray_tpu_torch_*`` names in the
temp directory, so a JAX runtime and the port's can share a host, and
``accel_env_vars`` hides the card from CPU-leased workers instead of
stripping TPU attach hooks.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

_TMP = tempfile.gettempdir()

_FLAG_DEFS: Dict[str, tuple] = {
    # (type, default, doc)
    "inline_object_max_bytes": (int, 100 * 1024,
        "Task returns at or below this size are returned in-band to the owner's "
        "in-process store instead of the shared-memory store (reference: "
        "max_direct_call_object_size, ray_config_def.h)."),
    "object_store_memory_bytes": (int, 2 * 1024**3,
        "Default size of the per-node shared-memory object store segment."),
    "object_store_fallback_dir": (str, "/dev/shm",
        "Directory backing the shared-memory store files."),
    "worker_lease_timeout_s": (float, 30.0,
        "How long a task submission waits for a worker lease before erroring."),
    "worker_start_timeout_s": (float, 60.0,
        "How long the worker pool waits for a forked worker to register."),
    "worker_forkserver_enabled": (bool, True,
        "Fork default-env CPU workers from a pre-imported per-node template "
        "process (~10 ms) instead of spawning a fresh interpreter (~150 ms+) "
        "(reference: prestarted worker pool, worker_pool.h:357)."),
    "lease_undelivered_timeout_s": (float, 10.0,
        "A pooled worker that self-reports IDLE for this long while its "
        "lease is held had its grant reply or lease return lost on the "
        "network: the lease is credited back and the worker re-pooled. "
        "Dedicated (actor) forks whose actor runtime never started get "
        "3x this window before being killed (their creation was retried "
        "elsewhere). The lease GENERATION token keeps any straggler "
        "return/push from corrupting accounting. 0 disables."),
    "idle_worker_keep_s": (float, 300.0,
        "Idle workers beyond the soft pool limit are reaped after this long."),
    "heartbeat_period_s": (float, 1.0,
        "Node -> controller liveness heartbeat period (reference: raylet "
        "report period / GcsHealthCheckManager)."),
    "heartbeat_full_refresh_beats": (int, 10,
        "Delta heartbeats: unchanged availability ships as a liveness-only "
        "beat, with a full payload at least every this many beats "
        "(reference: RaySyncer versioned deltas, ray_syncer.h:88)."),
    "health_check_failure_threshold": (int, 60,
        "Missed heartbeats before the controller declares a node dead. "
        "Reference parity: ~60s of failed checks before death (period 3s "
        "x timeout 10s x threshold 5, ray_config_def.h:842-846). The old "
        "5s default proved trigger-happy — a 1000-actor surge starves "
        "heartbeat threads past it and a LIVE node's actors get reaped. "
        "Chaos tests that want fast detection override this."),
    "scheduler_spread_threshold": (float, 0.5,
        "Hybrid policy: prefer the local/first node until its utilization "
        "crosses this fraction, then spread (reference: "
        "scheduler_spread_threshold, hybrid_scheduling_policy.cc)."),
    "max_pending_lease_requests_per_key": (int, 10,
        "Max in-flight worker-lease requests per scheduling key (reference: "
        "ClusterSizeBasedLeaseRequestRateLimiter, core_worker.h:1963)."),
    "task_retry_delay_ms": (int, 100,
        "Delay before retrying a failed-but-retriable task."),
    "actor_restart_delay_ms": (int, 200,
        "Delay before restarting a dead actor with restarts remaining."),
    "get_poll_interval_s": (float, 0.01,
        "Polling interval for blocking get on remote objects."),
    "rpc_connect_retries": (int, 20,
        "TCP connect attempts (50ms apart) before an RPC endpoint is dead."),
    "rpc_outbound_cap_bytes": (int, 64 * 1024 * 1024,
        "Per-connection cap on bytes queued for send by an RpcServer's "
        "non-blocking write path. A peer that stops reading accumulates "
        "its replies here; past the cap the connection is dropped "
        "(backpressure — the reactor must never block on one slow peer)."),
    "log_to_driver": (bool, True,
        "Forward worker stdout/stderr lines to the driver process."),
    "dag_channels_enabled": (bool, True,
        "Upgrade same-host compiled-DAG edges to mutable shared-memory "
        "channels (reference: experimental_mutable_object_manager.h); "
        "disabled, every edge uses the RPC push path."),
    "dag_channel_capacity_bytes": (int, 8 * 1024 * 1024,
        "Per-slot size of one compiled-DAG channel edge; larger items "
        "fall back to the RPC push for that item."),
    "dag_channel_slots": (int, 3,
        "Ring depth of compiled-DAG channels (1-4): the writer may run "
        "this many items ahead of the reader's ack, overlapping stage "
        "compute with handoff (reference: buffered shared-memory "
        "channels, shared_memory_channel.py:169)."),
    "runtime_env_cache_bytes": (int, 2 * 1024**3,
        "Size budget for materialized runtime envs: "
        "past it, least-recently-used env dirs not pinned by live workers "
        "are evicted (reference: the runtime-env agent's URI cache GC, "
        "runtime_env/plugin.py). 0 disables eviction."),
    "object_broadcast_min_bytes": (int, 8 * 1024 * 1024,
        "Objects at least this big use tree broadcast: the owner caps "
        "concurrent pulls per source and pullers re-register their copy "
        "as a new source (reference: push dedup, push_manager.h:30 — "
        "here generalized to a binomial distribution tree)."),
    "object_broadcast_fanout": (int, 0,
        "Max concurrent pulls served per source copy of a broadcast "
        "object; further pullers wait for a replica to come up. 0 "
        "(default) disables the tree: on a SINGLE host (incl. the "
        "multi-node-in-one-machine fixture) every source shares one "
        "CPU/NIC, so gating adds rounds without adding bandwidth — set "
        "to 2 on real multi-host clusters where each replica node "
        "contributes its own NIC."),
    "object_pull_slot_lease_s": (float, 300.0,
        "A broadcast pull slot auto-expires after this long (crashed "
        "puller must not wedge the object's distribution tree)."),
    "event_buffer_max": (int, 10000,
        "Max buffered task state-transition events per worker (reference: "
        "TaskEventBuffer, task_event_buffer.h:206)."),
    "object_transfer_chunk_bytes": (int, 8 * 1024 * 1024,
        "Node-to-node object pulls move in chunks of this size (reference: "
        "object_manager_default_chunk_size, object_manager.h:117)."),
    "max_pull_bytes_in_flight": (int, 256 * 1024 * 1024,
        "Admission control: per-process cap on chunk bytes concurrently in "
        "flight for remote object pulls (reference: PullManager's "
        "num_bytes_available budget, pull_manager.h:52)."),
    "object_spill_dir": (str, os.path.join(_TMP, "ray_tpu_torch_spill"),
        "Directory for objects spilled to disk when the shared-memory store "
        "is full (reference: local_object_manager.h:110 spill-to-fs)."),
    "ref_counting_enabled": (bool, True,
        "Automatic object lifetimes: ObjectRef handles are tracked per "
        "process and reported to owners; objects free when the cluster-wide "
        "handle count drops to zero (reference: reference_count.h:61)."),
    "ref_free_grace_s": (float, 2.0,
        "An owner frees a zero-refcount object only after it has stayed at "
        "zero this long (absorbs in-flight handle registrations)."),
    "ref_flush_interval_s": (float, 0.2,
        "Batched ref-count updates flush to owners at this period."),
    "max_lineage_entries": (int, 10000,
        "Owner-kept task lineage entries for object reconstruction "
        "(reference: max_lineage_bytes, task_manager.h:215)."),
    "reconstruction_max_attempts": (int, 3,
        "How many times a lost object's producing task is re-executed "
        "(reference: object_recovery_manager.h:41)."),
    "accel_env_vars": (str, "CUDA_VISIBLE_DEVICES",
        "Comma-separated env vars set to the empty string in CPU-only "
        "workers (and the forkserver template they fork from): with "
        "CUDA_VISIBLE_DEVICES empty a CPU-leased worker sees no card, so "
        "it can never create a CUDA context or hold device memory. Leases "
        "holding a GPU resource keep the node's values."),
    "worker_log_dir": (str, os.path.join(_TMP,
                                         f"ray_tpu_torch_logs_{os.getuid()}"),
        "Per-node worker stdout/stderr log files live under "
        "<dir>/<node_hex>/ (reference: session_latest/logs); per-uid "
        "default so multi-user hosts don't collide."),
    "log_monitor_scan_s": (float, 0.5,
        "Log monitor tail period (reference: log_monitor.py scan loop)."),
    "log_rotation_max_bytes": (int, 64 * 1024 * 1024,
        "A worker log file past this size is truncated after its tail is "
        "consumed (reference: log_rotation_max_bytes)."),
    "log_window_lines": (int, 500,
        "Published log window size per node; drivers diff end counters so "
        "bursts up to this size are never lost between polls."),
    "memory_usage_threshold": (float, 0.95,
        "Node memory fraction above which the memory monitor starts killing "
        "workers (reference: memory_usage_threshold, ray_config_def.h:65)."),
    "memory_monitor_refresh_s": (float, 1.0,
        "Memory monitor check period; 0 disables the monitor (reference: "
        "memory_monitor_refresh_ms)."),
    "memory_kill_interval_s": (float, 2.0,
        "Minimum spacing between memory-monitor worker kills (reference: "
        "memory_monitor_min_wait_between_kills)."),
    "worker_killing_policy": (str, "retriable_fifo",
        "OOM victim selection: 'retriable_fifo' (newest retriable task "
        "first) or 'group_by_owner' (largest owner's newest task first) "
        "(reference: worker_killing_policy*.cc)."),
    "lease_spillback_queue_depth": (int, 32,
        "A node whose lease queue is deeper than this immediately rejects "
        "new general-pool leases ('spillback') so submitters re-pick "
        "another node from the controller's fresher view instead of "
        "queueing behind a stale choice (reference: hybrid policy "
        "spillback redirects, hybrid_scheduling_policy.cc). 0 disables."),
    "client_session_timeout_s": (float, 60.0,
        "Thin-client sessions with no RPC (incl. keepalive pings) for this "
        "long are reaped server-side — their refs released and unnamed "
        "actors killed, as if the client driver exited (reference: Ray "
        "Client proxied-driver lifetime)."),
    "dead_actor_cache_count": (int, 1000,
        "Dead actor records (and their pubsub entries) retained for late "
        "callers before being reaped (reference: "
        "maximum_gcs_destroyed_actor_cached_count, ray_config_def.h)."),
    "prefix_pool_entries": (int, 8,
        "Entries in a DecodeEngine's device-resident prefix KV pool: cached "
        "prompt prefixes spliced into a request's slot at admission so only "
        "the uncached suffix is prefilled. Each entry costs "
        "2 * L * C_prefix * KV * D cache bytes. 0 disables the prefix cache."),
    "prefix_match_min_tokens": (int, 16,
        "Minimum shared-prefix length (tokens) for a prefix-cache hit; "
        "prompts shorter than this are neither matched nor inserted."),
    "serve_request_timeout_s": (float, 70.0,
        "Default end-to-end deadline for a serve request when the client "
        "sets none (HTTP header X-Request-Timeout-S or "
        "DeploymentHandle.options(timeout_s=...) override per request). "
        "Propagated proxy -> handle -> replica -> DecodeEngine, which "
        "finishes the slot with DeadlineExceededError instead of decoding "
        "for a caller that already gave up. 0 disables the default (no "
        "deadline unless the client sends one)."),
    "decode_queue_max": (int, 0,
        "Cap on a DecodeEngine's pending (unadmitted) request queue. Past "
        "it, submit() sheds the request with OverloadedError. "
        "0 = slots * 8."),
    "handle_retry_budget": (int, 3,
        "Per-request attempts a DeploymentHandle router makes when a "
        "replica dies mid-call (ActorDiedError/ActorUnavailableError). "
        "Streaming requests never retry after the first item, and no "
        "retry is attempted past the request deadline."),
    "handle_retry_backoff_ms": (int, 50,
        "Base backoff before a handle retry; doubles each attempt with "
        "+/-50% jitter so a replica death under load heals instead of "
        "amplifying into a synchronized retry storm on the survivors."),
    "kv_page_tokens": (int, 0,
        "Page size (tokens) of a DecodeEngine's paged KV pool. >0 switches "
        "the engine from per-slot monolithic cache rows to a shared device "
        "pool of fixed-size pages addressed through per-slot block tables "
        "(vLLM-style paged attention on static shapes): slots consume only "
        "the pages their sequence actually covers, prefix sharing splices "
        "block-table entries with zero device copies, and eviction frees "
        "page-granular tail segments. Must divide the engine capacity. "
        "0 = contiguous whole-row cache (pre-paging behavior)."),
    "kv_pool_pages": (int, 0,
        "Pages in a paged DecodeEngine's device KV pool. The pool may be "
        "OVERCOMMITTED (pages < slots * capacity / kv_page_tokens): more "
        "concurrent sequences fit the same HBM bytes, and when the pool "
        "truly runs dry the engine reclaims prefix-cache pins first and "
        "then preempts the youngest request (recompute-style requeue). "
        "0 = slots * capacity / kv_page_tokens (no overcommit)."),
    "kv_prefix_max_pages": (int, 0,
        "Cap on pool pages pinned by the paged prefix index (cached "
        "prompt prefixes kept resident after their request completes). "
        "Past it, least-recently-used tail pages unpin first. "
        "0 = kv_pool_pages // 4."),
    "prefill_chunk_tokens": (int, 0,
        "Chunked-prefill interleaving for paged DecodeEngines: prompt "
        "prefills longer than this run as a sequence of at most one "
        "chunk-sized prefill program per decode step, scheduled between "
        "decode steps — a long admission can stall active streams for at "
        "most ONE chunk instead of its whole prefill. 0 disables "
        "(monolithic prefill at admission, pre-chunking behavior)."),
    "spec_k": (int, 0,
        "Speculative-decoding depth for DecodeEngines given a draft "
        "model: a small draft model proposes k tokens per active slot "
        "per step and the target model verifies all k+1 positions in "
        "ONE batched forward (the paged ragged-position gather), so a "
        "step emits 1..k+1 tokens per slot. Each emitted token is the "
        "target's argmax at its position (longest-matching-prefix "
        "acceptance); sampled (temperature > 0) requests fall back to "
        "per-token decode. Requires paged KV (kv_page_tokens > 0). "
        "0 disables."),
    "spec_draft_model": (str, "",
        "Draft-model preset name (models/llama.PRESETS) for "
        "LlamaDecodeDeployment's speculative mode, a model a few times "
        "smaller than the target preset over the same vocab. Empty "
        "disables spec mode at the deployment level; engines constructed "
        "directly take draft params/config explicitly."),
    "spec_draft_pool_pages": (int, 0,
        "Pages in the draft model's OWN paged KV pool (spec mode). The "
        "draft tracks the same sequence positions as the target but at "
        "draft-model width, so its pool is the same page count at a "
        "fraction of the bytes. A dry draft pool evicts younger draft "
        "seats or leaves a slot draftless; it never preempts a request. "
        "0 = match kv_pool_pages."),
    "decode_device_sampler": (bool, False,
        "Fold sampling into the decode step on the device (argmax, or a "
        "per-row categorical draw at the row's temperature) so each step "
        "returns token ids instead of copying (slots, vocab) logits to "
        "the host sampler. Greedy rows are identical to the host "
        "sampler's; temperature > 0 rows draw from a torch.Generator "
        "seeded from the step (a different stream than the host "
        "sampler's numpy generator and than the JAX package's device "
        "stream), which is why this is opt-in."),
    "decode_warmup": (bool, False,
        "Pre-dispatch a DecodeEngine's steady-state step set (decode, "
        "decode-chunk grid, spec draft/verify, device sampler, one "
        "prefill bucket) at deployment construction, so the first "
        "requests do not pay the first call of each (on a card: the "
        "flash kernel's build, cuBLAS's first call of each shape). The "
        "steplog's jit-compile events then show only the prefill "
        "buckets the live prompt mix reaches."),
    "decode_mesh_shape": (str, "",
        "Default (batch, model) decode mesh. Empty = one device."),    "slice_affinity_enabled": (bool, True,
        "Serve routers prefer replicas on the caller's own pod slice "
        "(ICI-local) over cross-slice replicas when both can take the "
        "request; load still wins past saturation. No-op when nodes "
        "advertise no slice topology."),
    "prefix_affinity_enabled": (bool, True,
        "Serve routers hash a request's leading token buckets and prefer "
        "the replica advertising that prefix in its cache (falling back "
        "to pow-2 least-loaded), so hot system prompts stay resident on "
        "one replica's prefix pool instead of re-prefilling on every "
        "replica."),
    "serve_metrics_enabled": (bool, True,
        "Serve SLO instruments (serve/metrics.py): TTFT, inter-token and "
        "queue-wait histograms plus request-outcome, preemption, "
        "speculative and handoff counters, labeled by deployment, read "
        "from the process's registry (util/metrics.py snapshot()). All "
        "observations are per-REQUEST (never per token), so the decode "
        "step loop pays nothing per step."),
    "serve_trace_spans": (bool, True,
        "Request tracing through the serve plane: the HTTP proxy, router "
        "and DecodeEngine record spans (admission/queue wait, prefill "
        "chunks, decode, retries, preemption, outcome) into the task-event "
        "buffer so `python -m ray_tpu timeline --serve` renders one "
        "causally-linked Chrome trace across processes. Spans are "
        "per-request/per-chunk, never per token or per step."),
    "decode_step_timeline": (int, 256,
        "Entries in a DecodeEngine's step-timeline ring "
        "(serve/steplog.py): per-step phases (prefill waves, prefill "
        "chunk, decode, draft, verify), batch occupancy and page "
        "alloc/free, preempt, spec-draftless and jit-compile events, "
        "read through engine.timeline() and stats(). 0 disables the "
        "recorder. A phase's host times end where the host got past it: "
        "prefill, suffix-prefill, decode and draft end in a copy to the "
        "host and so wait for the card; prefill-chunk, draft-prefill, "
        "an adopted handoff and verify's closing cursor writes end at a "
        "launch (the enqueue). With trace_device_spans on, every phase "
        "also carries dev_ms, its device time."),
    "trace_device_spans": (bool, False,
        "Device-timed spans (util/tracing.py device_span): CUDA event "
        "pairs, from a pool, around the engine's step phases, the decode "
        "and verify attention of each layer, the train step's forward, "
        "backward and optimizer and its LM head with cross entropy, read "
        "back as dev_ms, attn_ms and lm_head_ce_ms in the step timelines "
        "once the events have completed (no span synchronises). Off, a "
        "span site costs one module-global read and makes no CUDA call. "
        "util.tracing.set_device_spans() switches it at run time."),
    "metrics_flush_interval_s": (float, 5.0,
        "Period of the per-process metrics flusher pushing registry "
        "snapshots to the cluster controller. Snapshots are CUMULATIVE, "
        "so a missed push (controller restart) never double-counts — the "
        "next successful push supersedes it."),
    "core_metrics_enabled": (bool, True,
        "Core-plane instrumentation (core/coremetrics.py): RPC write-path "
        "and dial counters, object put/get/transfer instruments, pubsub "
        "deliver latency + subscriber lag, controller scheduling/heartbeat "
        "instruments. Hot paths pay plain attribute increments only; the "
        "registry is touched at snapshot time by collectors. Off = the "
        "pre-instrumentation fast path (bench_obs.py measures the delta)."),
    "metrics_max_series": (int, 2000,
        "Per-process cap on metric series included in one registry "
        "snapshot. Past it, overflow series are dropped from the snapshot "
        "(insertion order keeps established series flowing) and a "
        "metrics_series_dropped gauge reports the overflow: a runaway "
        "label-cardinality producer degrades visibly instead of growing "
        "every snapshot without bound."),
    "faultinject_path": (str, "",
        "Path of a JSON fault-rules file activating util/faultinject.py "
        "injection points (kill-process, drop/delay/error a named RPC "
        "endpoint, pause heartbeats, partition a peer). Empty (default) "
        "disables every injection point at the cost of one attribute "
        "read. Set via RAY_TPU_FAULTINJECT_PATH before ray_tpu.init so "
        "worker processes inherit it; chaos tests drive faults by "
        "editing the file (re-read on mtime change)."),
    "mh_member_beat_period_s": (float, 0.25,
        "Period of a host-group member's membership heartbeat to the "
        "group registry (core/multihost.py). The beat carries the "
        "member's group epoch; a 'fenced' reply is how a zombie member "
        "of a deposed gang incarnation learns to stop touching group "
        "state."),
    "ctrl_call_timeout_s": (float, 30.0,
        "Transport bound on one-shot control-plane RPCs (gang registry "
        "reads/writes, lease release, taints, serve controller state "
        "saves, autopilot actions). The client treats timeout=None as "
        "park-forever, so every such call carries this instead: a "
        "dropped reply becomes a typed TimeoutError the caller's "
        "retry/refusal logic handles, never a silent distributed hang "
        "(graftlint rpc-call-no-timeout). Long-polls (barriers, pubsub "
        "watches) are NOT governed by this — they carry their own "
        "window-derived bounds."),
    "mh_monitor_period_s": (float, 0.3,
        "Period of the HostGroup driver-side monitor pinging every gang "
        "member. One failed member reconciles the WHOLE group (kill all, "
        "release the sub-slice exactly once, optional restart under a "
        "bumped epoch)."),
    "mh_ping_timeout_s": (float, 5.0,
        "Timeout on each monitor ping before a gang member is declared "
        "dead (the push to a SIGKILLed worker fails fast; this bounds "
        "the wedged-but-listening case)."),
    "mh_barrier_timeout_s": (float, 30.0,
        "Default timeout for group rendezvous barriers (program-hash "
        "checks, jax bootstrap alignment). A timeout is a typed refusal "
        "naming the absent members — never a silent hang."),
    "mh_form_timeout_s": (float, 60.0,
        "How long gang formation waits for every member actor to come "
        "up before declaring the spawn failed (all-or-nothing: a "
        "partial gang is torn down and the sub-slice released)."),
    "rpc_reconnect_backoff_base_ms": (int, 50,
        "First-retry pause of a ReconnectingClient after a transport "
        "failure. Doubles per consecutive failure (with +/-50% jitter) "
        "up to rpc_reconnect_backoff_cap_ms — the first retry stays "
        "fast (a controller blip heals in ~one beat) while a DEAD "
        "controller costs a capped trickle of dials instead of the "
        "tight 0.2 s loop ray_tpu doctor flags as a reconnect storm."),
    "rpc_reconnect_backoff_cap_ms": (int, 2000,
        "Ceiling on the ReconnectingClient retry backoff. Bounds the "
        "extra latency a client adds on top of controller recovery: "
        "after the controller returns, the next retry lands within at "
        "most this long (x1.5 jitter)."),
    "pipe_step_timeout_s": (float, 120.0,
        "Wall-clock bound on one pipeline-parallel optimizer step "
        "(train/pipeline_plane.py): past it the driver raises a typed "
        "PipelineError naming the per-stage schedule state instead of "
        "hanging — a wedged stage becomes a diagnosis, not a stall "
        "(see ray_tpu doctor's pipeline-stall signature)."),
    "pipe_setup_timeout_s": (float, 120.0,
        "How long PipelinePlane waits for every stage actor to pull "
        "its params/optimizer state and compile its programs during "
        "(re)formation before declaring the setup failed."),
    "pipe_snapshot_every": (int, 1,
        "PipelinePlane pulls a driver-owned snapshot of every stage's "
        "params/optimizer state every N completed optimizer steps — "
        "the resume point after a whole-gang restart (a snapshot owned "
        "by a stage actor would die with it). 0 disables snapshots "
        "(a gang death then restarts training from step 0)."),
    "pipe_trace_spans": (bool, True,
        "Train-plane tracing (train/pipeline_plane.py): the pipeline "
        "driver opens one root span per optimizer step and every stage "
        "actor records fwd/bwd/apply spans with {step, mb, stage} attrs "
        "into the task-event buffer, so `python -m ray_tpu timeline "
        "--train` renders per-stage process rows whose gaps ARE the "
        "1F1B bubble. Spans are per stage-RPC, never per tensor "
        "element; stage-side emission is additionally gated on an "
        "active trace context, so an untraced step pays one contextvar "
        "read per call."),
    "pipe_trace_sample_every": (int, 4,
        "Head-sampling period of the train-plane tracer: every Nth "
        "optimizer step opens the pipe:step root span (stage/cell "
        "spans follow the propagated context, so a sampled step is "
        "traced END TO END and an unsampled one records nothing). A "
        "fully-traced 1F1B step emits ~180 span events (per-cell "
        "driver+stage spans, object put/get, actor exec) — ~5% of a "
        "200 ms debug step on the CPU box — so sampling keeps the "
        "always-on cost under the 2% bar while every timeline still "
        "shows complete representative steps. 1 traces every step."),
    "flightrec_enabled": (bool, True,
        "Cluster flight recorder (util/flightrec.py): a bounded "
        "per-process ring of structured control-plane events (gang "
        "epochs/reconciles, barrier entries, pipeline stage clocks, "
        "snapshot push/pull, faultinject fires, actor death causes) "
        "persisted for `ray_tpu doctor --post-mortem`. Off = every "
        "record() is one attribute read."),
    "flightrec_ring": (int, 512,
        "Events kept per process by the flight recorder (deque maxlen; "
        "oldest evicted first). The ring records control-plane facts, "
        "not data-plane traffic — 512 covers minutes of gang/pipeline "
        "lifecycle at production cadences."),
    "flightrec_dir": (str, os.path.join(
        _TMP, f"ray_tpu_torch_flightrec_{os.getuid()}"),
        "Per-HOST directory the flight recorder persists per-process "
        "rings into (fr-<pid>.json, atomic replace). fr_dump / doctor "
        "--post-mortem merge every file here; on multi-host rigs "
        "collect each host's dir. Per-uid default so shared dev hosts "
        "don't collide."),
    "flightrec_flush_s": (float, 0.5,
        "Period of the flight recorder's background flush to "
        "flightrec_dir while events keep arriving. A SIGKILL keeps "
        "everything up to the last flush (faultinject die rules flush "
        "synchronously first, so injected crashes are fully recorded)."),
    "pipe_peak_tflops": (float, 0.0,
        "Aggregate peak TFLOP/s of a training gang, for the pipeline "
        "plane's MFU estimate gauge (pipeline_mfu_pct = achieved model "
        "TFLOP/s / peak x 100; achieved is always exported as "
        "pipeline_model_tflops). 0 (default) disables the MFU gauge — "
        "there is no honest peak number for a time-sliced CPU host; "
        "set it to chips x per-chip peak on a real rig."),
    "serve_adopt_timeout_s": (float, 5.0,
        "How long a restarted serve controller pings the replica/proxy "
        "handles from its checkpoint before declaring the stragglers "
        "dead. Alive replicas are ADOPTED (same actor, same sub-slice "
        "reservation — no respawn, no cold prefill); dead ones are "
        "replaced and their reservations queued for release. Bounds "
        "control-plane MTTR: snapshots republish right after this "
        "window at the latest."),
    "serve_handoff_ttl_s": (float, 60.0,
        "How long a prefill deployment's handoff ledger keeps a published "
        "KV-page handoff (object-plane refs + descriptor) that nobody "
        "discharged. The caller discharges on adopt-ack or abort; this "
        "TTL only catches a caller that died mid-splice: the sweep "
        "(driven by replica_metrics) frees the expired refs so an "
        "orphaned handoff can never pin its page payload past the window. "
        "Must exceed the worst-case publish->adopt gap (seconds); expiry "
        "after a successful adopt is harmless (the decode side already "
        "fetched the bytes)."),
    "serve_mttr_bound_s": (float, 30.0,
        "Acceptance bound on serve control-plane MTTR: controller "
        "death -> routing snapshots flowing again (epoch-bumped "
        "republish observed by routers). The chaos suite and "
        "bench_chaos.py assert/record against this; it is a TEST bound, "
        "not a runtime knob — nothing throttles recovery to it."),
    "controller_metrics_http_port": (int, -1,
        "Port for the controller-side Prometheus /metrics HTTP endpoint "
        "(whole-cluster exposition text, series labeled by node/role/pid). "
        "-1 disables; 0 binds an ephemeral port (Controller."
        "metrics_http_addr reports it). The dashboard serves the same "
        "text at its own /metrics route."),
    "autopilot_enabled": (bool, False,
        "Global kill switch for closed-loop remediation (autopilot.py). "
        "OFF (default) = the reconciler observes and records what it "
        "WOULD do but takes no action — byte-identical legacy behavior. "
        "ON = doctor signatures that persist across the hysteresis "
        "window become fenced, rate-limited control actions (taint host, "
        "reschedule gang, shed tenant, resize deployment)."),
    "autopilot_dry_run": (bool, False,
        "Autopilot evaluates the full pipeline (hysteresis, rate "
        "limits, fencing) and writes audit records with outcome "
        "'dry-run', but never mutates the cluster. Subordinate to "
        "autopilot_enabled: with the kill switch OFF nothing runs at "
        "all; with it ON, dry-run is the safe observe-only mode the "
        "CLI's --dry-run uses."),
    "autopilot_poll_s": (float, 5.0,
        "Autopilot reconcile cadence: each tick collects a doctor "
        "window (two metrics snapshots interval_s apart is the "
        "caller's job — the loop just spaces ticks) and steps the "
        "remediation pipeline. Also the denominator of 'windows' in "
        "autopilot_hysteresis_windows."),
    "autopilot_hysteresis_windows": (int, 2,
        "Consecutive doctor windows a (signature, source) pair must "
        "persist before autopilot may act on it. 2 (default) means a "
        "one-window transient — a single slow heartbeat, one queue "
        "spike — NEVER triggers remediation. 1 disables hysteresis "
        "(test/bench use)."),
    "autopilot_rate_per_min": (float, 2.0,
        "Token-bucket refill rate, actions per minute PER ACTION CLASS "
        "(taint-host, reschedule-gang, shed-tenant, resize-deployment "
        "each get their own bucket). Actions past the budget are "
        "suppressed (autopilot_suppressed_total{reason='rate-limit'}) "
        "and retried on a later tick if the signature persists."),
    "autopilot_burst": (int, 2,
        "Token-bucket capacity per action class: how many actions of "
        "one class may fire back-to-back before the per-minute refill "
        "gates further ones. Bounds blast radius when a correlated "
        "fault (rack loss) lights up many signatures at once."),
    "autopilot_taint_ttl_s": (float, 120.0,
        "How long a taint-host demotion keeps a node out of new "
        "gang/replica placement. After the TTL the taint lapses and "
        "the host is re-admitted IF its recent heartbeats look healthy "
        "(probe-based re-admission: the controller checks the node's "
        "last-heartbeat freshness before lifting the taint; a host "
        "still wedged keeps its taint another TTL)."),
}


class _Config:
    def __init__(self):
        self._values: Dict[str, Any] = {}
        for name, (typ, default, _doc) in _FLAG_DEFS.items():
            env = os.environ.get(f"RAY_TPU_{name.upper()}")
            if env is not None:
                if typ is bool:
                    self._values[name] = env.lower() in ("1", "true", "yes")
                else:
                    self._values[name] = typ(env)
            else:
                self._values[name] = default

    def __getattr__(self, name: str):
        try:
            return self.__dict__["_values"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value) -> None:
        """Direct assignment writes the flag store. Without this, a
        ``config.flag = x`` would create an instance attribute that
        permanently SHADOWS the store — later ``update()`` calls would
        write values no reader ever sees (a real cross-test corruption)."""
        if name.startswith("_"):
            super().__setattr__(name, value)
            return
        values = self.__dict__.get("_values")
        if values is None or name not in values:
            raise AttributeError(f"unknown config flag {name!r}")
        typ = _FLAG_DEFS[name][0]
        if typ is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes")
        values[name] = typ(value)

    def update(self, overrides: Dict[str, Any]) -> None:
        """Apply ``_system_config`` style overrides (validated by name/type)."""
        for name, value in overrides.items():
            if name not in _FLAG_DEFS:
                raise ValueError(f"Unknown config flag: {name}")
            typ = _FLAG_DEFS[name][0]
            self._values[name] = typ(value)

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._values)


config = _Config()
