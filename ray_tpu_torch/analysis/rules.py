"""graftlint rule configuration: the tables the checkers consult.

Everything fitted to THIS codebase's conventions lives here (reactor
roots, blocking-API tables, jit decorator spellings, acquire/release
pairs), so tuning the analyzer never means editing checker logic.
"""

from __future__ import annotations

# --------------------------------------------------------------- rule ids

REACTOR_BLOCKING = "reactor-blocking-call"
TRACE_HOST_SYNC = "trace-host-sync"
TRACE_PY_BRANCH = "trace-python-branch"
TRACE_RETRACE = "trace-retrace-hazard"
LOCK_ORDER_CYCLE = "lock-order-cycle"
LOCK_HELD_BLOCKING = "lock-held-blocking"
SWALLOWED_EXCEPTION = "swallowed-exception"
MISSING_FINALLY = "missing-finally-release"
UNGUARDED_FIELD = "unguarded-field-access"
RESOURCE_LEAK = "resource-leak-path"
RPC_UNKNOWN = "rpc-unknown-method"
RPC_ARITY = "rpc-arity-mismatch"
RPC_DEAD = "rpc-dead-endpoint"
SHARDING_CONTRACTION = "sharding-partitioned-contraction"
SHARDING_ANCHOR = "sharding-missing-anchor"
SHARDING_UNPINNED = "sharding-unpinned-mesh-call"
SHARDING_UNSCOPED = "sharding-unscoped-trace"
RPC_STUB_DRIFT = "rpc-stub-drift"
METRICS_COLLISION = "metrics-name-collision"
METRICS_CARDINALITY = "metrics-label-cardinality"
CHECKPOINT_MISSING = "checkpoint-missing-save"
AUTOPILOT_UNPAIRED = "autopilot-unpaired-action"
FENCE_RESULT_IGNORED = "fence-result-ignored"
FENCE_UNFENCED_MUTATION = "unfenced-mutation-in-fenced-class"
FENCE_COMPARE_DIRECTION = "epoch-compare-direction"
FENCE_EPOCH_NOT_THREADED = "epoch-not-threaded"
DONATION_UNGUARDED = "donation-unguarded-dispatch"
DONATION_ASARRAY_ALIAS = "donation-asarray-alias"
DONATION_READ_AFTER_DONATE = "donation-read-after-donate"
DEADLINE_UNBOUNDED = "unbounded-blocking-call"
DEADLINE_RPC_NO_TIMEOUT = "rpc-call-no-timeout"
DEADLINE_NOT_PROPAGATED = "deadline-not-propagated"
DEADLINE_RETRY_UNBOUNDED = "retry-unbounded"
DEADLINE_KNOB_DEAD = "timeout-knob-dead"
# Not a family rule: emitted centrally by run_analysis on full runs
# (pragma liveness needs EVERY family's raw findings).
STALE_PRAGMA = "stale-pragma"

ALL_RULES = (
    REACTOR_BLOCKING,
    TRACE_HOST_SYNC, TRACE_PY_BRANCH, TRACE_RETRACE,
    LOCK_ORDER_CYCLE, LOCK_HELD_BLOCKING,
    SWALLOWED_EXCEPTION, MISSING_FINALLY,
    UNGUARDED_FIELD,
    RESOURCE_LEAK,
    RPC_UNKNOWN, RPC_ARITY, RPC_DEAD,
    SHARDING_CONTRACTION, SHARDING_ANCHOR,
    SHARDING_UNPINNED, SHARDING_UNSCOPED,
    RPC_STUB_DRIFT,
    METRICS_COLLISION, METRICS_CARDINALITY,
    CHECKPOINT_MISSING,
    AUTOPILOT_UNPAIRED,
    FENCE_RESULT_IGNORED, FENCE_UNFENCED_MUTATION,
    FENCE_COMPARE_DIRECTION, FENCE_EPOCH_NOT_THREADED,
    DONATION_UNGUARDED, DONATION_ASARRAY_ALIAS,
    DONATION_READ_AFTER_DONATE,
    DEADLINE_UNBOUNDED, DEADLINE_RPC_NO_TIMEOUT,
    DEADLINE_NOT_PROPAGATED, DEADLINE_RETRY_UNBOUNDED,
    DEADLINE_KNOB_DEAD,
    STALE_PRAGMA,
)

# The fourteen checker families, for ``--jobs`` scheduling and
# per-family stats: family name -> tuple of rule ids it emits.
# (STALE_PRAGMA is absent by design: pragma liveness is computed in
# run_analysis itself, over every family's pre-suppression findings.)
FAMILIES = {
    "reactor-safety": (REACTOR_BLOCKING,),
    "trace-safety": (TRACE_HOST_SYNC, TRACE_PY_BRANCH, TRACE_RETRACE),
    "lock-discipline": (LOCK_ORDER_CYCLE, LOCK_HELD_BLOCKING),
    "lifecycle-hygiene": (SWALLOWED_EXCEPTION, MISSING_FINALLY),
    "guarded-by": (UNGUARDED_FIELD,),
    "lifetime": (RESOURCE_LEAK, CHECKPOINT_MISSING),
    "rpc-contract": (RPC_UNKNOWN, RPC_ARITY, RPC_DEAD),
    "sharding-safety": (SHARDING_CONTRACTION, SHARDING_ANCHOR,
                        SHARDING_UNPINNED, SHARDING_UNSCOPED),
    "rpc-stubs": (RPC_STUB_DRIFT,),
    "metrics": (METRICS_COLLISION, METRICS_CARDINALITY),
    "autopilot": (AUTOPILOT_UNPAIRED,),
    "fence-safety": (FENCE_RESULT_IGNORED, FENCE_UNFENCED_MUTATION,
                     FENCE_COMPARE_DIRECTION, FENCE_EPOCH_NOT_THREADED),
    "donation-aliasing": (DONATION_UNGUARDED, DONATION_ASARRAY_ALIAS,
                          DONATION_READ_AFTER_DONATE),
    "deadline-safety": (DEADLINE_UNBOUNDED, DEADLINE_RPC_NO_TIMEOUT,
                        DEADLINE_NOT_PROPAGATED,
                        DEADLINE_RETRY_UNBOUNDED, DEADLINE_KNOB_DEAD),
}

# ------------------------------------------------- blocking-API tables

# Dotted call targets that always block the calling thread. Matched
# against the best-effort resolved dotted name at the call site.
BLOCKING_DOTTED = {
    "time.sleep": "time.sleep",
    "socket.create_connection": "blocking connect",
    "subprocess.run": "subprocess",
    "subprocess.call": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.check_output": "subprocess",
    "subprocess.Popen": "subprocess",
    "os.system": "subprocess",
    "os.waitpid": "process wait",
    "shutil.rmtree": "filesystem walk",
}

# Method names that always block regardless of receiver. The reactor's
# own non-blocking socket verbs (recv/send/sendmsg/accept on sockets in
# O_NONBLOCK) are deliberately absent: the analyzer cannot see
# setblocking(False), so it only flags verbs with no non-blocking mode.
BLOCKING_METHODS_ALWAYS = {
    "sendall": "blocking socket send",
    "connect": "blocking connect",
    "recv_into": "blocking socket read",
    "makefile": "socket file I/O",
}

# Method names that block only when called with no bounding argument
# (lock.acquire(), event.wait(), thread.join(), future.result()).
# Any positional or keyword argument is treated as a bound.
BLOCKING_METHODS_UNBOUNDED = {
    "acquire": "unbounded lock acquire",
    "wait": "unbounded wait",
    "join": "unbounded join",
    "result": "unbounded future wait",
}

# Extra table for the LOCK checker only: an RPC issued while holding a
# lock serializes every other path through that lock behind the peer's
# latency. ``.call``/``.notify`` are this runtime's RPC verbs.
RPC_METHODS = {
    "call": "RPC round-trip",
    "notify": "RPC send",
}
RPC_DOTTED = {
    "ray_tpu_torch.get": "blocking object get",
    "ray_tpu_torch.wait": "blocking wait",
    "ray_tpu_torch.kill": "actor-kill RPC",
    "api.get": "blocking object get",
}

# The reactor checker additionally treats file I/O as blocking (a disk
# stall wedges every connection); the lock checker does not (file writes
# under a lock are often the point — e.g. checkpoint serialization).
REACTOR_EXTRA_DOTTED = {
    "open": "file I/O",
}

# ------------------------------------------------------ reactor roots

# (module suffix, function qualname) pairs that run on a reactor /
# selector thread. Name patterns catch conventional callback names in
# future modules without a table edit.
REACTOR_ROOT_FUNCS = {
    ("ray_tpu_torch.core.rpc", "RpcServer._reactor"),
    ("ray_tpu_torch.core.rpc", "RpcServer._accept"),
    ("ray_tpu_torch.core.rpc", "RpcServer._read"),
    ("ray_tpu_torch.core.rpc", "RpcServer._pump"),
    ("ray_tpu_torch.core.rpc", "RpcServer._drop"),
    ("ray_tpu_torch.core.rpc", "RpcServer._drain_ops"),
    ("ray_tpu_torch.core.rpc", "RpcServer._flush"),
    ("ray_tpu_torch.core.rpc", "RpcServer._flush_locked"),
    ("ray_tpu_torch.core.rpc", "RpcServer._set_writing"),
    ("ray_tpu_torch.core.rpc", "RpcServer._send_reply"),
    # _handle runs on the pool for most methods but ON the reactor for
    # inline_methods — it must satisfy reactor discipline.
    ("ray_tpu_torch.core.rpc", "RpcServer._handle"),
}
REACTOR_ROOT_NAME_PATTERNS = ("_on_readable", "_on_writable")

# ------------------------------------------ compiled / captured regions

# The port's counterparts of a ``jax.jit`` trace scope (trace family):
# callables that compile, script or graph a function — as a decorator
# (bare or called) or as a wrapping call whose first argument is a
# package function. Matched by the import-resolved dotted name.
TRACE_SCOPE_DOTTED = frozenset({
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
})
# Context managers whose body is captured for replay: a host sync there
# fails the capture, a tensor branch is frozen into the graph.
TRACE_CAPTURE_CTXS = frozenset({"torch.cuda.graph"})

# Host-sync method calls that are always wrong in a compiled region.
TRACE_SYNC_METHODS = {
    "item": "host sync (.item())",
    "tolist": "host sync (.tolist())",
    "cpu": "host copy (.cpu())",
    "numpy": "host copy (.numpy())",
}
# Dotted host-sync calls (receiver-resolved). ``np``/``numpy`` aliases
# are detected per-module from the import table. (``jax.device_get``
# has no counterpart in the port.)
TRACE_SYNC_DOTTED = {
    "torch.cuda.synchronize": "device sync (torch.cuda.synchronize)",
}
NUMPY_SYNC_FUNCS = {"asarray", "array"}

# torch constructors whose first (or ``size=``) argument must not be a
# tensor's value.
SHAPE_POSITION_FUNCS = {"zeros", "ones", "full", "empty", "arange",
                        "broadcast_to"}

# ------------------------------------------------- JAX jit spellings

# The sharding and donation families key on ``jax.jit``-family calls.
# The port compiles nothing with sharding or donation arguments, so
# their jit-keyed rules read no site in it; the spellings stay so that
# code written that way would still be read.
JIT_DOTTED_SUFFIXES = ("jit", "pjit", "shard_map")
# A wrapping call carrying these kwargs is a trace scope regardless of
# what the wrapper is NAMED (aliased imports, partial-built helpers,
# mesh-context jit factories).
JIT_SHARDING_KWARGS = frozenset({"in_shardings", "out_shardings"})

# -------------------------------------------- lifecycle acquire/release

# (acquire method name, release method name) — flagged when both appear
# in one function with the release NOT in a ``finally`` block. Lock
# discipline only; resource idioms (sockets, files, selector
# registrations, slots, pins, refcounts) moved to the path-sensitive
# ``resource-leak-path`` rule (lifetime.py).
ACQUIRE_RELEASE_METHODS = (
    ("acquire", "release"),
)
# Dotted acquire constructors -> release method on the result (still
# consulted by the v1 rule for same-function pairing; the v2 lifetime
# rule uses the richer tables below).
ACQUIRE_RELEASE_DOTTED = ()

# ------------------------------------------ v2: guarded-by inference

# Thread-construction call targets -> where the entry callable lives:
# a keyword name, with a positional-index fallback.
THREAD_CTORS = {
    "threading.Thread": ("target", 1),
    "threading.Timer": ("function", 1),
}
# ``X.submit(fn, ...)`` hands fn to a pool thread (and pools run it
# concurrently with itself — self-concurrent, like RPC handlers).
EXECUTOR_SUBMIT_METHODS = ("submit",)

# Methods whose field accesses are construction/teardown-time, excluded
# from guarded-by inference and from flagging.
GUARDED_BY_EXCLUDED_METHODS = ("__init__", "__del__", "__repr__",
                               "__reduce__")
# Methods named ``*_locked`` are called with their lock already held
# (repo convention, e.g. RpcServer._flush_locked): their accesses are
# neither inference evidence nor flaggable.
LOCKED_BY_CONVENTION_SUFFIX = "_locked"

# A field is inferred guarded-by L when L is held at a strict majority
# of its eligible access sites AND at at least this many sites.
GUARDED_BY_MIN_LOCKED_SITES = 2

# ---------------------------------------- v2: resource-lifetime pairing

# Dotted constructors that acquire a releasable resource when assigned
# to a local: ``sock = socket.socket()`` ... ``sock.close()``.
RESOURCE_CTOR_DOTTED = {
    "socket.socket": "close",
    "socket.create_connection": "close",
    "open": "close",
}
# Receiver-keyed acquire/release method pairs: ``sel.register(fd, ...)``
# pairs with ``sel.unregister(fd)`` (possibly in a callee — release-
# through-call is resolved over the call graph), ``cache.pin(h)`` with
# ``cache.unpin(h)``.
RESOURCE_METHOD_PAIRS = {
    "register": "unregister",
    "pin": "unpin",
    # Page-allocator refcount sharing (serve/paging.py): an incref pins
    # a pool page a later decref/free must release.
    "incref": "decref",
    # Pipeline-plane activation-ref ownership (train/pipeline_plane.py
    # RefLedger): ``ledger.borrow_ref(desc)`` registers an in-flight
    # ObjectRef the process keeps alive; ``ledger.drop_ref(desc)`` must
    # run on every exception path (and on stage death, via the
    # _drop_inflight self-callee) — a desc surviving a raise pins its
    # activation tensor cluster-wide, the serve ``_add_replica`` leak
    # shape for ObjectRefs.
    "borrow_ref": "drop_ref",
    # Disaggregated-serving KV-page handoff (serve/handoff.py
    # HandoffLedger): ``self._handoffs.publish_handoff(desc)`` opens a
    # lease over the prefill replica's filled KV pages (pinned in the
    # object store by the descriptor's refs); every escaping exception
    # must discharge it (``discharge_handoff`` — reached via the
    # _drop_handoff self-callee on the adopt-ack/abort/expiry paths) or
    # the pages stay pinned until the TTL sweep. A lease surviving a
    # NORMAL exit is the design: the returned descriptor transfers the
    # discharge obligation to the router splice.
    "publish_handoff": "discharge_handoff",
}
# Slot-pool attributes: ``self._free.pop()`` leases a slot that
# ``self._free.append(slot)`` returns (DecodeEngine slot discipline);
# ``pages = self._pages.alloc(n)`` leases KV pool pages that
# ``self._pages.free(pages)`` returns (the paged-KV allocator — a block
# leak on a cancel/deadline/retire path pins HBM forever, the exact
# failure mode the decode engine's _release_slot centralizes against).
RESOURCE_POOL_ATTRS = {
    "_free": ("pop", "append"),
    "_pages": ("alloc", "free"),
}
# Refcount attributes: ``ent.refcount += 1`` pins, ``-= 1`` unpins
# (prefix-cache row pinning).
RESOURCE_REFCOUNT_ATTRS = ("refcount",)

# --------------------------------------- v3: topology-lease pairing

# RPC-name-keyed lease pairs: ``client.call("reserve_subslice", ...)``
# acquires a topology lease that some ``client.call("release_subslice",
# id)`` (possibly in a self.-callee — the serve controller's
# ``_release_subslice``/``_kill_replica`` chain) must discharge on every
# exception path. Unlike receiver-keyed pairs, leases are GLOBAL (keyed
# by reservation id on the head), so any release call discharges them
# regardless of which client object carries it. A lease surviving a
# normal exit is the design (the replica record owns it); only an
# escaping exception between reserve and release/handoff is a leak —
# a leaked reservation strands its chips until the hosting node dies.
RPC_LEASE_PAIRS = {
    "reserve_subslice": "release_subslice",
    # A host-group registration is a controller-side resource exactly
    # like a sub-slice lease, at GANG granularity: HostGroup._form
    # acquires the group record (and the gang epoch) before spawning
    # members, and a partial-spawn failure must drop it on every
    # exception path alongside the sub-slice release — a leaked record
    # strands the group id and its fencing epoch (the _add_replica
    # leak shape, one level up).
    "mh_register_group": "mh_drop_group",
    # A pipeline record (core/pipereg.py) is the same shape at the
    # training plane: PipelinePlane._form_record acquires the record
    # (and its fencing epoch) before pushing stage state, and a partial
    # formation must drop it on every exception path (discharge lives
    # in the _abort_formation self-callee) — a leaked record strands
    # the pipeline id and fences nothing.
    "pipe_register": "pipe_drop",
}
# The RPC verbs lease acquire/release ride on (client.call today;
# notify releases would also discharge).
RPC_LEASE_VERBS = ("call", "notify")

# The CHECKPOINT idiom (the durable-controller twin of the lease
# rule): a control-plane class whose state checkpoints through the
# core KV must reach its save method on EVERY normal exit of its
# state-mutating handlers — a handler that returns without saving
# makes the mutation invisible to the restarted controller (a
# controller death right after it silently reverts the op, orphaning
# replicas / resurrecting deleted apps / losing queued releases).
# class name -> (save method, handlers that must reach it). The save
# may be reached through a self.-callee chain (shutdown -> delete ->
# _save_state counts), resolved over the same summary fixpoint as
# release-through-call. Escaping exceptions are exempt: the handler
# failed, so there may be nothing durable to record.
CHECKPOINT_CLASSES = {
    "ServeController": ("_save_state",
                        ("deploy", "delete", "set_route", "enable_http",
                         "disable_http", "shutdown",
                         "_apply_resize", "_apply_shed")),
}

# ---------------------------------------- autopilot action discipline

# The closed-loop remediator's handler idiom (the RPC_LEASE_PAIRS shape
# applied to control actions): in these modules, every action handler —
# a method whose name carries the action prefix — must PAIR an
# epoch-fence check with a durable audit record. An action that cannot
# show its fence can double-kill a gang the cluster already healed; one
# that cannot show its audit trail is an unaccountable mutation. Both
# calls must appear in the handler body itself (not a transitive
# callee): the pairing is the readable contract.
AUTOPILOT_MODULES = ("ray_tpu_torch/autopilot.py",)
AUTOPILOT_ACTION_PREFIX = "_act_"
AUTOPILOT_FENCE_CALL = "_fence_ok"
AUTOPILOT_AUDIT_CALL = "_audit"

# ------------------------------------------ v3: sharding/mesh safety

# Module holding the logical-axis rule tables, and the names of the
# tables whose contract is BIT-EXACTNESS (no contraction dim ever
# partitions — the GSPMD serving invariant). DEFAULT_RULES (train) is
# also parsed: train tables may shard contraction dims (psum is fine
# for training), but they identify which logical axes CAN shard, which
# is how the row-parallel weights are derived.
SHARDING_RULES_MODULE = "ray_tpu_torch.parallel.sharding"
# ZERO1_STATE_RULES is bit-exact-contracted for a different reason
# than DECODE_RULES: optimizer-state sharding annotations touch only
# elementwise update math, which is safe precisely BECAUSE the table
# never names an axis that sits in contraction position — the moment a
# model axis (embed/heads/mlp/...) is added, the same annotations
# would split reductions of the traced step.
SHARDING_BITEXACT_TABLES = ("DECODE_RULES", "ZERO1_STATE_RULES")
SHARDING_TRAIN_TABLE = "DEFAULT_RULES"
# Module + function names the weight logical-axes tables live in: the
# train table plus the decode overrides (``decode_param_axes`` re-binds
# the row-parallel weights to fully-replicated tuples).
SHARDING_PARAM_AXES_MODULE = "ray_tpu_torch.models.llama"
SHARDING_PARAM_AXES_FUNCS = ("param_axes",)
SHARDING_DECODE_AXES_FUNCS = ("decode_param_axes",)
# Files whose einsum/dot/matmul sites are checked against the tables
# (path prefixes; the sharded model + parallelism code).
SHARDING_SCOPE_PREFIXES = ("ray_tpu_torch/models/", "ray_tpu_torch/parallel/")
# The logical-axis anchor call (``constrain(x, (...axes...))``) —
# matched by trailing name so aliased imports still count.
SHARDING_CONSTRAIN_FUNCS = ("constrain",)
# Mesh-scope spellings: a ``with axis_rules(mesh, rules):`` block, or a
# jit passed through a ``*_mesh_scoped``-style wrapper, marks the
# region where sharded programs are traced.
SHARDING_SCOPE_CTXS = ("axis_rules",)
MESH_SCOPE_WRAPPERS = ("_mesh_scoped",)
# The port's spellings: weights are read through an accessor
# (``_w(layer, "wo", x)``, the weight's name at this argument index) and
# reshaped to 2-D for a ``@``; a local-shards gather (``gather_local``)
# replicates the contracted dim before a row-parallel product, as the
# ``constrain`` anchor does on a DTensor mesh.
SHARDING_WEIGHT_ACCESSORS = {"_w": 1}
SHARDING_GATHER_FUNCS = ("gather_local",)
SHARDING_RESHAPE_METHODS = ("reshape", "view")
SHARDING_AXIS_KEEPING_METHODS = ("astype", "to", "float", "contiguous")
# einsum/dot/matmul trailing names checked for contraction hazards.
SHARDING_CONTRACT_FUNCS = ("einsum",)
SHARDING_MATMUL_FUNCS = ("matmul", "dot")

# ------------------------------------------- v3: generated RPC stubs

# The generated typed-stub module (``--gen-stubs``): one ``<Cls>Stub``
# class per RpcServer owner, methods mirroring handler signatures.
# Stub-method call sites count as literal RPC uses (dead-endpoint +
# arity checking); the module itself is gated against drift by the
# ``rpc-stub-drift`` rule and ``make lint-stubs-check``.
RPC_STUBS_MODULE = "ray_tpu_torch.core.rpc_stubs"
RPC_STUBS_PATH = "ray_tpu_torch/core/rpc_stubs.py"

# ------------------------------------------- v2: RPC contract checking

# Handler maps are declared as RpcServer(handlers={...}) dict literals
# (this keyword) or via server.register("name", fn).
RPC_HANDLERS_KWARG = "handlers"
RPC_INLINE_KWARG = "inline_methods"
RPC_REGISTER_METHOD = "register"
# Client-side kwargs consumed by the transport, never forwarded to the
# handler.
RPC_CLIENT_KWARGS = ("timeout",)
# Wrapper methods that prepend implicit positional args before
# forwarding to ``.call`` (ClientCore._call prepends the session id).
# Scoped to the module defining the wrapper: an unrelated ``_call``
# (tpu_vm_api's HTTP helper) must not be read as an RPC site.
RPC_CALL_WRAPPERS = {
    "_call": (1, "ray_tpu_torch.client"),
}
# Endpoints reached only through dynamic dispatch the AST cannot see
# (dashboard proxy forwards ?method=... query strings; CLI tools) or
# from outside the package (tests, external health probes).
# Registered-but-never-literally-called names listed here are not dead.
RPC_DYNAMIC_ENDPOINTS: frozenset = frozenset({
    # liveness probe on every server: exercised by tests, health
    # monitors, and the dashboard's generic proxy
    "ping",
})

# ------------------------------------- metrics label cardinality

# Metric-record method names whose tags dict is inspected for unbounded
# label values (tags= kwarg, the post-value positional, or the sole
# argument of set_default_tags).
METRICS_RECORD_METHODS = frozenset({"inc", "set", "observe",
                                    "observe_many", "set_default_tags"})
# Terminal identifier names that denote a per-request/object/task id —
# unbounded label cardinality (one registry series per request never
# merges and eventually evicts bounded series from the snapshot cap).
# Matched against the LAST attribute/name segment of any sub-expression
# of a label value; names merely ENDING in "_id" also match.
METRICS_ID_NAMES = frozenset({"oid", "uuid", "request", "req_id"})
METRICS_ID_SUFFIX = "_id"
# Calls whose result is id-shaped regardless of receiver (oid.hex(),
# uuid.uuid4()): flagged as label values.
METRICS_ID_CALLS = frozenset({"hex", "uuid4", "uuid1"})

# ------------------------------- flight-recorder event names

# Flight-recorder record() sites (import-resolved to this module) go
# through the same literal-name discipline as metric constructors: one
# event name, one attr-key schema (the post-mortem merges events by
# name — a site recording the same name with different keys silently
# breaks every downstream grouping), and id-shaped attr VALUES flagged
# exactly like metric label values (the ring is bounded, but an event
# whose attrs are per-request ids is a metric trying to be born).
FLIGHTREC_MODULE = "ray_tpu_torch.util.flightrec"
FLIGHTREC_RECORD_FUNC = "record"
# audit() is record()+flush_now() (the durable variant): an audit
# site defines an event schema exactly like a record site does.
FLIGHTREC_RECORD_FUNCS = (FLIGHTREC_RECORD_FUNC, "audit")
# Attr keys whose values are bounded schedule/geometry integers by
# construction ({step, mb, stage} and friends): exempt from the
# id-shaped check — `step=self._step` is a clock, not a cardinality
# hazard.
FLIGHTREC_BOUNDED_ATTRS = frozenset({
    "step", "mb", "stage", "epoch", "asked", "mbs", "attempt", "hosts",
    "stages", "chips", "current", "n"})

# ------------------------------------ v4: epoch-fence protocol

# Fenced write APIs whose RESULT is the stale-epoch verdict: a caller
# that discards it keeps acting as the owner after being deposed (the
# split-brain the fencing exists to prevent). Matched by call tail
# (stub methods and direct handler calls) and by the string form
# ``client.call("<name>", ...)``. The autopilot's fenced actions ride
# mh_group_put, so its handlers are covered by this same table (the
# _fence_ok/_audit PAIRING is family #11's job).
FENCED_WRITE_APIS = {
    "kv_put_fenced": "False == stale epoch: the writer was deposed",
    "mh_group_put": '{"ok": False, "reason": "stale_epoch"} == deposed',
    "pipe_step_complete": '{"ok": False} == stale incarnation',
}
# Publish-shaped APIs are fenced ONLY when an epoch rides the call
# (the hub treats epoch=None as an unfenced write — there is no stale
# verdict to consume): name -> (epoch kwarg, its positional index).
FENCED_WRITE_EPOCH_ARG = {
    "publish": ("epoch", 4),
    "psub_publish": ("epoch", 4),
}
# RPC verbs carrying the string form of a fenced write; ``notify`` is
# fire-and-forget by design, so only result-returning verbs count.
FENCED_RPC_VERBS = ("call",)

# Classes whose controller-KV / pubsub state is epoch-fenced: every
# mutating write from these classes must go through the fenced API
# (kv_put_fenced / an epoch-carrying publish) — the raw spellings
# listed here bypass the fence and re-open the split-brain.
# The core Controller itself (the KV owner) is deliberately absent:
# it IS the fence.
FENCED_STATE_CLASSES = {
    "ServeController": ("kv_put", "kv_del"),
    "Autopilot": ("kv_put", "kv_del"),
}

# Epoch/version comparison sites: (path, dotted suffix of the STORED
# clock, mode). mode "equal-ok" = stale iff STRICTLY older (the
# serve-snapshot rule: a same-epoch republish must be accepted — a
# normalized ``incoming <= stored`` / ``incoming > stored`` guard
# drops legitimate same-epoch writes); mode "strict" = strictly-newer
# -wins (the WeightFanout/receiver rule: an equal version is a replay
# — a normalized ``incoming < stored`` / ``incoming >= stored`` guard
# re-applies it). Comparisons against literal constants are not
# protocol checks and are ignored.
EPOCH_COMPARE_TABLE = (
    ("ray_tpu_torch/core/controller.py", "current", "equal-ok"),
    ("ray_tpu_torch/core/multihost.py", "rec.epoch", "equal-ok"),
    ("ray_tpu_torch/core/pipereg.py", "rec.epoch", "equal-ok"),
    ("ray_tpu_torch/core/pubsub.py", "cur_epoch", "equal-ok"),
    ("ray_tpu_torch/serve/deployment.py", "self._ctrl_epoch", "equal-ok"),
    ("ray_tpu_torch/serve/controller.py", "self._epoch", "equal-ok"),
    ("ray_tpu_torch/rl/distributed/fanout.py", "self._version", "strict"),
    ("ray_tpu_torch/rl/distributed/fanout.py", "self._weights_version",
     "strict"),
    ("ray_tpu_torch/rl/distributed/learner.py", "self._last_version",
     "equal-ok"),
)

# Fenced publishes whose PAYLOAD must carry the clock: (class, call
# tail) -> (payload positional index, required literal key). A
# subscriber that cannot read the epoch/version out of the payload
# cannot run its own staleness check (the router-snapshot idiom).
# Only dict-literal payloads (direct or via a same-function local)
# are checked — an opaque payload expression is not evidence.
FENCED_PAYLOAD_RULES = {
    ("ServeController", "psub_publish"): (2, "epoch"),
    ("HostGroup", "mh_group_put"): (2, "epoch"),
    ("WeightFanout", "psub_publish"): (2, "version"),
}

# --------------------------------- v4: donated-buffer aliasing

# No counterpart in the port: it builds no program with donated buffers
# (the JAX engine's ``_dispatch_fresh`` was not carried), so these rules
# read no site in ray_tpu_torch. The tables keep the JAX spellings, so a
# donating program written that way would still be read.
# Guard wrappers a donated program's dispatch must flow through:
# ``self._dispatch_fresh(key, lambda: self._prog(...))`` detaches the
# persistent XLA cache on the FIRST dispatch (jaxlib 0.4.37: a
# donated executable reloaded from the disk cache segfaults or
# returns wrong numbers). Dispatch inside the guard's own body is the
# guard working, not a violation.
DONATED_DISPATCH_GUARDS = ("_dispatch_fresh",)
# Keyword spellings that mark a jit construction as donating.
DONATION_JIT_KWARGS = ("donate_argnums", "donate")

# -------------------------------------- v5: deadline safety

# Wait verbs the unbounded-blocking-call rule polices, with where their
# finite bound lives: verb -> (timeout kwarg name, its positional
# index, label). Bounded = that argument is present and is not the
# literal ``None`` (a Name/attribute/call expression counts as a bound
# — config knobs are floats and ``Deadline.remaining()`` never returns
# a forever value for a bounded deadline). ``get`` is checked only on
# stdlib-queue-typed receivers (DEADLINE_QUEUE_CTORS): bare ``.get``
# is dict/contextvar territory.
DEADLINE_WAIT_VERBS = {
    "wait": ("timeout", 0, "unbounded wait"),
    "join": ("timeout", 0, "unbounded join"),
    "result": ("timeout", 0, "unbounded future wait"),
    "get": ("timeout", 1, "unbounded queue get"),
}
# For ``get`` only: a literal-False first positional / ``block=False``
# makes the call non-blocking, which is as bounded as it gets.
DEADLINE_NONBLOCK_KWARG = "block"
# Queue constructors that type a local / self-attribute as a blocking
# queue for the ``get`` verb (dotted, import-resolved). The in-repo
# util.queue twins keep the stdlib signature, so the same timeout
# position applies.
DEADLINE_QUEUE_CTORS = {
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "multiprocessing.Queue",
    "ray_tpu_torch.util.queue.Queue", "ray_tpu_torch.util.queue.ShardedQueue",
}
# Socket read verbs: no timeout argument exists — the bound is
# ``settimeout``/``setblocking`` on the socket. A module that calls
# either anywhere manages its own socket modes (the reactor's
# nonblocking fds, _connect's bounded dial); flagged only when the
# enclosing MODULE shows neither.
DEADLINE_SOCKET_VERBS = ("recv", "recv_into")
DEADLINE_SOCKET_MODE_CALLS = ("settimeout", "setblocking")

# rpc-call-no-timeout scope: control-plane modules where every literal
# ``.call("name", ...)`` / typed-stub call must carry ``timeout=`` (or
# the documented config default below). Data-plane and long-poll
# surfaces (pubsub subscribe parks, object-plane streams) are
# deliberately out of scope: their unbounded waits are the design, and
# rule 1 still covers their thread entries.
DEADLINE_RPC_SCOPE_PREFIXES = (
    "ray_tpu_torch/core/multihost.py",
    "ray_tpu_torch/core/pipereg.py",
    "ray_tpu_torch/serve/controller.py",
    "ray_tpu_torch/serve/proxy.py",
    "ray_tpu_torch/serve/deployment.py",
    "ray_tpu_torch/serve/handoff.py",
    "ray_tpu_torch/train/pipeline_plane.py",
    "ray_tpu_torch/autopilot.py",
)
# Parameters NAMED as stubs are stub-typed receivers too: helpers that
# take the constructed stub (``def _abort_formation(self, stub, ...)``)
# make the same control-plane calls as their caller.
DEADLINE_STUB_PARAM_NAMES = ("stub",)
DEADLINE_STUB_PARAM_SUFFIX = "_stub"
# Timeout-default documentation: config knob -> the wait sites it is
# expected to bound (module path prefix, call tail). Doubles as the
# dead-knob cross-check's allowlist of intent — a ``*_timeout_s`` knob
# in core/config.py that no package code ever READS (no
# ``config.<knob>`` attribute access) is flagged timeout-knob-dead,
# mirroring rpc-dead-endpoint.
DEADLINE_KNOB_SUFFIX = "_timeout_s"
DEADLINE_CONFIG_MODULE_PATH = "ray_tpu_torch/core/config.py"
DEADLINE_CONFIG_FLAGS_NAME = "_FLAG_DEFS"

# deadline-not-propagated: parameter names that carry a caller's time
# budget. A function taking one and making 2+ deadline-relevant calls
# (wait verbs / scoped RPC) must show a remaining-time idiom —
# ``Deadline`` usage (DEADLINE_IDIOM_ATTRS / the helper module) or raw
# ``time.monotonic()`` arithmetic. Exactly ONE downstream site
# consuming the budget is a pass-through, not a violation
# (RpcClient.call -> pending.wait(timeout) is the exemplar).
DEADLINE_PARAM_NAMES = ("timeout_s", "timeout", "deadline",
                        "deadline_s", "timeout_seconds")
DEADLINE_IDIOM_ATTRS = ("remaining", "expired", "sub")
DEADLINE_IDIOM_DOTTED = ("time.monotonic",)
DEADLINE_HELPER_MODULE = "ray_tpu_torch.util.deadline"

# retry-unbounded: an unconditionally-true loop (``while True`` /
# ``itertools.count``) re-issuing dial/RPC verbs with no bounding
# signal in the body. Bounding signals (any one suffices): a backoff
# sleep, an attempt counter compared in body or loop test, a deadline
# check (DEADLINE_IDIOM_ATTRS / time.monotonic), or a non-constant
# loop test. The reconnect storm, caught statically.
DEADLINE_RETRY_VERBS = ("call", "notify", "create_connection",
                        "connect", "dial")
DEADLINE_BACKOFF_CALLS = ("sleep", "backoff", "uniform")
