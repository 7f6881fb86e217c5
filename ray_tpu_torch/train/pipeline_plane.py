"""Pipeline-parallel training plane: MPMD stage actors on a HostGroup
(port of ``ray_tpu/train/pipeline_plane.py``).

The training half of pipeline parallelism ("Scaling Deep Learning
Training with MPMD Pipeline Parallelism", PAPERS.md), built on three
planes that already exist:

* **Stages are actors** (:class:`StageActor`, one per host of a
  contiguous sub-slice) gang-placed through
  :class:`~ray_tpu_torch.core.multihost.HostGroup` — placement is
  all-or-nothing (a refusal feeds the autoscaler's pending demand and
  no stage ever spawns), membership beats fence deposed epochs, and ONE
  stage dying reconciles the WHOLE gang under a bumped epoch. A stage
  that computes on a card holds the node's ``GPU`` lease
  (``worker_options``, ``{"num_gpus": 1}`` by default there; a smaller
  share lets stages share one card).
* **Tensors ride the object plane, RPCs carry descriptors** (the
  ``TrajectoryShard`` idiom): a stage ``put()``s its output activation
  (or input-gradient) and ships only ``{ref, mb, nbytes, ...}`` — a few
  hundred bytes against :data:`PIPE_DESC_BYTE_BUDGET`, pinned by the
  ``pipeline_desc_bytes`` histogram — while the actual tensor bytes
  move through the object store on the consumer's pull.
* **The schedule is driver-side 1F1B**: the plane dispatches at most
  one compute call per stage (a stage IS one compute unit), prefers
  backward over forward when both are ready (the 1F1B rule that bounds
  stashed activations), and admits new microbatches only while fewer
  than ``window`` are in flight. Each stage's backward residual is its
  INPUT activation — the backward recomputes the stage forward under
  autograd (``parallel.pipeline.make_stage_train_fns``) — so a stage
  stashes at most ``window`` microbatch inputs, never per-layer
  activations.

Data contract (loss parity): per-stage gradients accumulate in fp32 in
microbatch order and divide by the microbatch count before ONE Adam
update per stage per step — the same math as the single-process
accumulation loop (:func:`single_process_baseline`), so the plane is
bit-exact against the local chain of the same stage functions, and
matches the full-model baseline within relative-tolerance bounds
(reduction-order drift between the two CE paths).

Failure model: a stage death is a WHOLE-GANG event (HostGroup
reconciles: kill all, release the sub-slice exactly once, re-form
under epoch+1). The plane detects the epoch bump (or the failed call),
drops every in-flight activation ref (:class:`RefLedger` — zero leaked
refs is a ``stop()`` contract, not a hope), re-registers the pipeline
(``pipe_register`` bumps the registry epoch, fencing any straggler
``pipe_step_complete`` from the dead incarnation), re-pushes the last
driver-owned snapshot to the fresh gang and REPLAYS the interrupted
step — training resumes from the last completed optimizer step. A
TRANSIENT disruption (every member still answers ping — nothing died,
no reconcile) replays on the surviving gang: each step opens with a
``begin_step`` fan-out that clears the stages' per-step accumulator
state (the aborted attempt's completed backwards must not be counted
again) and cross-checks the stage clocks against the plane's — drifted
clocks (an apply reply lost AFTER stages applied) rewind the whole
gang from the snapshot instead of double-applying. A snapshot holds the
port's own Adam state (``format`` ``"ray_tpu_torch"``); a stage refuses
any other optimizer state.

Fault-injection sites: ``pipeline.stage.<pipeline>.<stage>.fwd``
(stage-side forward entry — a ``delay`` rule makes that stage the
straggler the pipeline-stall signature must name; a one-shot
``error`` rule manufactures the transient mid-step disruption);
``pipeline.stage.<pipeline>.<stage>.snap`` (stage-side snapshot entry
— an ``error`` rule makes the post-apply snapshot pull fail while the
gang stays alive); stage SIGKILL rides the inherited member beat site
(``multihost.member.<group>.<member>.beat``).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.core.config import config as _cfg
from ray_tpu_torch.core.errors import RayTpuError
from ray_tpu_torch.core.multihost import HostGroup, HostWorker
from ray_tpu_torch.util import faultinject, flightrec, tracing
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

_NULL_CTX = nullcontext()


def _stage_span(name: str, **attrs):
    """A stage-side tracing span for one 1F1B cell (fwd/bwd/apply with
    ``{step, mb, stage}`` attrs). Emitted only when the driver's step
    span was propagated into this call (``tracing.traced()``) AND the
    train-plane knob is on — an untraced step pays one contextvar read
    plus one config attribute read per stage call. Each stage actor is
    its own process, so these spans ARE the per-stage rows of the
    train timeline: the gaps between them are the 1F1B bubble, visible
    instead of inferred."""
    if not (_cfg.pipe_trace_spans and tracing.traced()):
        return _NULL_CTX
    return tracing.trace(name, **attrs)

# A stage RPC is metadata-only by contract; anything close to this many
# serialized bytes means tensor bytes leaked into the control path
# (pinned by tests/test_torch_pipeline_plane.py off the
# pipeline_desc_bytes histogram).
PIPE_DESC_BYTE_BUDGET = 8192


class PipelineError(RayTpuError):
    """Typed pipeline-plane failure: formation refused twice, the gang
    exhausted its restart budget, or a step exceeded
    ``pipe_step_timeout_s`` (the schedule state is in the message — a
    deadlock surfaces as a diagnosis, never a hang)."""


class _GangDisrupted(Exception):
    """Internal: a stage call failed / the gang epoch moved mid-step —
    drop in-flight refs and replay the step on the re-formed gang."""


# =====================================================================
# Activation-ref ownership ledger
# =====================================================================


class RefLedger:
    """Tracks every in-flight activation/gradient descriptor this
    process holds a live ObjectRef through. ``borrow_ref`` on receipt,
    ``drop_ref`` when the consuming stage's reply lands — and on EVERY
    exception path and on stage death (the serve ``_add_replica`` leak
    shape, for ObjectRefs: graftlint's resource-leak-path rule pairs
    the two verbs, ``rules.RESOURCE_METHOD_PAIRS``). A ref that stays
    in the ledger pins tensor bytes cluster-wide; the ledger count is
    the ``pipeline_activation_bytes``/``inflight`` gauge source and
    must be zero after ``stop()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[int, Dict[str, Any]] = {}

    def borrow_ref(self, desc: Dict[str, Any]):
        """Register a descriptor whose ``ref`` this process now keeps
        alive; returns the ref for immediate use."""
        with self._lock:
            self._live[id(desc)] = desc
        return desc.get("ref")

    def drop_ref(self, desc: Dict[str, Any]) -> bool:
        """Forget a descriptor (idempotent). The ObjectRef handle dies
        with the ledger entry, so the owner may free the tensor."""
        with self._lock:
            return self._live.pop(id(desc), None) is not None

    def live(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._live.values())

    def count(self) -> int:
        with self._lock:
            return len(self._live)

    def live_bytes(self) -> int:
        with self._lock:
            return sum(int(d.get("nbytes", 0))
                       for d in self._live.values())


# =====================================================================
# The stage actor
# =====================================================================


class StageActor(HostWorker):
    """One pipeline stage: a gang member (inherits the HostGroup beat
    loop, epoch fencing and barrier entry) that owns its layer slice's
    params + optimizer state and two stage functions (stage forward,
    stage backward-with-recompute). Compute calls are driver-serialized
    (the scheduler dispatches at most one per stage) and additionally
    guarded by ``_compute_lock`` so gang-control traffic (ping/beat)
    can stay concurrent."""

    def __init__(self, ctx: Dict[str, Any]):
        super().__init__(ctx)
        self._compute_lock = threading.Lock()
        self._ledger = RefLedger()
        self._spec: Optional[Dict[str, Any]] = None
        self._stash: Dict[int, Any] = {}
        self._g_acc = None
        self._losses: Dict[int, float] = {}
        self._step = 0
        self._device: Optional[torch.device] = None

    # ------------------------------------------------------- formation

    def setup_stage(self, spec: Dict[str, Any],
                    state_desc: Dict[str, Any]) -> Dict[str, Any]:
        """Configure this member as pipeline stage ``spec['stage']``:
        pull the state blob (params / optimizer state / step) from the
        object plane, move it to the stage's device (``spec['device']``:
        a stage on ``cuda`` raises without a card, never falls back to
        the CPU), build the stage functions, reset schedule state.
        Idempotent per (re)formation — a fresh gang member starts
        unconfigured and the plane pushes the resume snapshot here."""
        from ray_tpu_torch.core.device import resolve_device
        from ray_tpu_torch.ops.optim import AdamWState, adamw, tree_map
        from ray_tpu_torch.parallel.pipeline import make_stage_train_fns

        ref = self._ledger.borrow_ref(state_desc)
        try:
            import ray_tpu_torch as rt

            state = rt.get(ref, timeout=60.0)
        finally:
            self._ledger.drop_ref(state_desc)
        opt = state.get("opt_state")
        if opt is not None and (not isinstance(opt, dict)
                                or opt.get("format") != _STATE_FORMAT):
            raise PipelineError(
                "stage state was not written by ray_tpu_torch (a ray_tpu "
                "snapshot holds optax state as numpy trees, which the "
                "port does not load)")
        with self._compute_lock:
            dev = resolve_device(spec["device"])
            if dev.type == "cpu":
                # The driver's intra-op thread count: CPU reductions then
                # split as the driver's own chain splits them.
                torch.set_num_threads(int(spec["threads"]))
            cfg = spec["config"]
            stage, n_stages = int(spec["stage"]), int(spec["n_stages"])
            self._fwd, self._bwd = make_stage_train_fns(cfg, stage,
                                                        n_stages)
            self._optimizer = adamw(float(spec["lr"]), weight_decay=0.0)
            # Owned copies on the stage's device: the store's tensors are
            # read-only views, and the update writes in place.
            self._params = tree_map(lambda t: _owned(t, dev),
                                    state["params"])
            if opt is not None:
                self._opt_state = AdamWState(
                    count=int(opt["count"]),
                    mu=tree_map(lambda t: _owned(t, dev), opt["mu"]),
                    nu=tree_map(lambda t: _owned(t, dev), opt["nu"]))
            else:
                self._opt_state = self._optimizer.init(self._params)
            self._device = dev
            self._spec = dict(spec)
            self._stash.clear()
            self._losses.clear()
            self._g_acc = None
            self._step = int(state.get("step", 0))
            flightrec.record("pipe.stage.setup",
                             pipeline=str(spec["pipeline"]), stage=stage,
                             step=self._step, epoch=int(spec["epoch"]))
            return {"stage": stage, "step": self._step}

    # -------------------------------------------------------- schedule

    def begin_step(self, step: int) -> Dict[str, Any]:
        """Reset per-step schedule state (``_g_acc``/``_stash``/
        ``_losses``) before the driver (re)runs an optimizer step. A
        replay on a SURVIVING gang (transient disruption: every member
        still answered ping, so no reconcile rebuilt the stages) would
        otherwise accumulate into gradients left by the aborted attempt
        and silently double-count its completed backwards. Returns the
        stage clock; the DRIVER compares it against ``step`` — a
        mismatch means this stage already applied the step about to be
        replayed (its apply reply was lost, not its update), which is
        snapshot-re-push territory, not an error here."""
        with self._compute_lock:
            if self._spec is None:
                raise PipelineError("stage not configured (setup_stage "
                                    "first)")
            self._stash.clear()
            self._losses.clear()
            self._g_acc = None
            # The stage CLOCK, on the record: the post-mortem's "which
            # stage's clock stopped / drifted" evidence survives this
            # process (``asked`` is the driver's step — a mismatch here
            # is the double-apply guard's trigger).
            flightrec.record("pipe.stage.begin",
                             pipeline=str(self._spec["pipeline"]),
                             stage=int(self._spec["stage"]),
                             step=self._step, asked=int(step))
            return {"stage": int(self._spec["stage"]),
                    "step": self._step}

    def _pull(self, desc: Dict[str, Any]):
        """Resolve a descriptor's tensor from the object plane; the
        local borrow is net-zero (dropped in the finally) — the
        DRIVER's ledger owns the in-flight ref. The tensor is copied
        onto the stage's device, so the stash never pins a store
        object."""
        import ray_tpu_torch as rt

        ref = self._ledger.borrow_ref(desc)
        try:
            return _owned(rt.get(ref, timeout=60.0), self._device)
        finally:
            self._ledger.drop_ref(desc)

    def _ship(self, kind: str, mb: int, value) -> Dict[str, Any]:
        """Put a tensor into the object plane and build the descriptor
        that rides the RPC reply instead of it."""
        import ray_tpu_torch as rt

        t = value.detach()
        ref = rt.put(t)
        return {"kind": kind, "mb": int(mb),
                "stage": int(self._spec["stage"]), "ref": ref,
                "nbytes": int(t.nbytes), "shape": tuple(t.shape),
                "dtype": str(t.dtype).removeprefix("torch.")}

    def forward(self, mb: int, in_desc: Dict[str, Any],
                tgt_desc: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """One microbatch forward. Stage 0 receives token ids, later
        stages hidden states; the LAST stage also receives targets and
        returns the scalar loss (no tensor ships). The input is stashed
        as this microbatch's backward residual."""
        from ray_tpu_torch.core.config import config

        spec = self._spec
        if spec is None:
            raise PipelineError("stage not configured (setup_stage "
                                "first)")
        if config.faultinject_path:
            faultinject.check(
                f"pipeline.stage.{spec['pipeline']}.{spec['stage']}.fwd")
        last = int(spec["stage"]) == int(spec["n_stages"]) - 1
        # One span per 1F1B forward cell; the object-plane pulls inside
        # nest their object:get spans under it (flow arrows in the
        # timeline show the activation handoff between stage rows).
        with _stage_span("fwd", step=self._step, mb=int(mb),
                         stage=int(spec["stage"])):
            # Pulls stay OUTSIDE the compute lock: the object-plane
            # read must never serialize behind a running stage function
            # (or vice versa — gang control traffic shares this actor).
            x = self._pull(in_desc)
            targets = self._pull(tgt_desc) if last else None
            with self._compute_lock:
                if last:
                    self._stash[int(mb)] = (x, targets)
                    loss = self._fwd(self._params, x, targets)
                    self._losses[int(mb)] = float(loss)
                    return {"kind": "loss", "mb": int(mb),
                            "stage": int(spec["stage"]),
                            "loss": float(loss)}
                self._stash[int(mb)] = x
                out = self._fwd(self._params, x)
                return self._ship("act", mb, out)

    def backward(self, mb: int,
                 g_desc: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """One microbatch backward: consume the stashed residual,
        recompute the stage forward under autograd, accumulate the
        fp32 param gradient (microbatch order — the driver dispatches
        backwards in order), ship the input gradient upstream (stage 0
        ships nothing: token ids have no cotangent)."""
        from ray_tpu_torch.ops.optim import tree_map

        spec = self._spec
        first = int(spec["stage"]) == 0
        last = int(spec["stage"]) == int(spec["n_stages"]) - 1
        with _stage_span("bwd", step=self._step, mb=int(mb),
                         stage=int(spec["stage"])):
            g_out = None if last else self._pull(g_desc)
            with self._compute_lock:
                residual = self._stash.pop(int(mb))
                if last:
                    x, targets = residual
                    _loss, g_params, g_x = self._bwd(self._params, x,
                                                     targets)
                else:
                    g_params, g_x = self._bwd(self._params, residual,
                                              g_out)
                if self._g_acc is None:
                    self._g_acc = tree_map(lambda g: g.float(), g_params)
                else:
                    tree_map(lambda a, g: a.add_(g.to(a.dtype)),
                             self._g_acc, g_params)
                del g_params, residual
                if first:
                    return {"kind": "bwd0", "mb": int(mb), "stage": 0}
                return self._ship("grad", mb, g_x)

    def apply_update(self, n_micro: int, step: int) -> Dict[str, Any]:
        """One optimizer update from the accumulated gradients (mean
        over microbatches). ``step`` must match this stage's clock —
        a re-formed gang resuming from a snapshot must never double-
        apply."""
        with _stage_span("apply", step=int(step),
                         stage=(None if self._spec is None
                                else int(self._spec["stage"]))), \
                self._compute_lock:
            if step != self._step:
                raise PipelineError(
                    f"stage {self._spec['stage']} asked to apply step "
                    f"{step} but its clock is {self._step} (snapshot "
                    f"resume drift)")
            if self._stash:
                raise PipelineError(
                    f"apply_update with {len(self._stash)} residuals "
                    f"still stashed (schedule bug)")
            from ray_tpu_torch.ops.optim import tree_leaves
            from ray_tpu_torch.parallel.train_step import global_norm

            grads = self._g_acc
            for g in tree_leaves(grads):
                g.div_(float(n_micro))
            gnorm = global_norm(grads)
            # Writes params, mu and nu in place.
            self._opt_state = self._optimizer.update(grads, self._opt_state,
                                                     self._params)
            self._g_acc = grads = None
            losses, self._losses = self._losses, {}
            self._step += 1
            # The clock ADVANCED: with this on the record, a lost apply
            # reply is distinguishable post-mortem from an apply that
            # never ran (the double-apply guard's two cases).
            flightrec.record("pipe.stage.apply",
                             pipeline=str(self._spec["pipeline"]),
                             stage=int(self._spec["stage"]),
                             step=self._step)
            return {"stage": int(self._spec["stage"]),
                    "step": self._step, "grad_norm": float(gnorm),
                    "losses": losses}

    def snapshot(self) -> Dict[str, Any]:
        """Host copies of this stage's state, returned BY VALUE so the
        driver owns the bytes (an object-plane ref owned by this actor
        would die with it — the whole point of the snapshot is to
        outlive the gang)."""
        from ray_tpu_torch.core.config import config

        spec = self._spec
        if config.faultinject_path and spec is not None:
            faultinject.check(
                f"pipeline.stage.{spec['pipeline']}.{spec['stage']}"
                f".snap")
        with _stage_span("snap",
                         stage=(None if spec is None
                                else int(spec["stage"])),
                         step=self._step), self._compute_lock:
            if spec is not None:
                flightrec.record("pipe.stage.snap",
                                 pipeline=str(spec["pipeline"]),
                                 stage=int(spec["stage"]),
                                 step=self._step)
            return {
                "stage": int(self._spec["stage"]),
                "step": self._step,
                "params": host_copies(self._params),
                "opt_state": {"format": _STATE_FORMAT,
                              "count": int(self._opt_state.count),
                              "mu": host_copies(self._opt_state.mu),
                              "nu": host_copies(self._opt_state.nu)},
            }

    def stage_stats(self) -> Dict[str, Any]:
        with self._compute_lock:
            return {"stage": (None if self._spec is None
                              else int(self._spec["stage"])),
                    "step": self._step,
                    "stashed": len(self._stash),
                    "ledger": self._ledger.count()}


# =====================================================================
# Single-process baselines (parity + bench)
# =====================================================================


def microbatches(batch: Dict[str, np.ndarray],
                 n_micro: int) -> List[Dict[str, np.ndarray]]:
    """Split a ``{"tokens": (B, S+1)}`` batch into ``n_micro``
    inputs/targets microbatches along the batch dim."""
    toks = np.asarray(batch["tokens"])
    if toks.shape[0] % n_micro:
        raise ValueError(f"batch {toks.shape[0]} not divisible into "
                         f"{n_micro} microbatches")
    out = []
    for part in np.split(toks, n_micro):
        out.append({"inputs": part[:, :-1].astype(np.int32),
                    "targets": part[:, 1:].astype(np.int32)})
    return out


def single_process_baseline(config, params, lr: float,
                            step_batches: List[List[Dict[str, Any]]],
                            n_stages: Optional[int] = None,
                            device=None) -> Tuple[List[float], Any]:
    """The in-process reference the pipeline's loss curve is checked
    against: per-microbatch grads accumulated fp32 in order, divided by
    the count, one Adam update per step — the pipeline's exact data
    contract. ``n_stages=None`` runs the full model through
    ``llama.loss_fn`` (independent math; relative-tolerance parity);
    ``n_stages=k`` chains the SAME stage functions the actors run
    (bit-exactness reference for the plane). Runs on ``device``
    (``cuda`` unless the caller passes another) on copies of ``params``,
    which it leaves untouched; returns the step losses and the final
    params (one tree, or one per stage)."""
    from ray_tpu_torch.core.device import resolve_device
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw, tree_leaves, tree_map
    from ray_tpu_torch.parallel.pipeline import (make_stage_train_fns,
                                                 split_llama_stages)
    from ray_tpu_torch.parallel.train_step import value_and_grad

    dev = resolve_device(device)
    optimizer = adamw(lr, weight_decay=0.0)

    def on_dev(x):
        return torch.as_tensor(x).to(dev)

    def accumulate(acc, g):
        if acc is None:
            return tree_map(lambda x: x.float(), g)
        tree_map(lambda a, b: a.add_(b.to(a.dtype)), acc, g)
        return acc

    def apply(p, s, g, n):
        for x in tree_leaves(g):
            x.div_(n)
        return optimizer.update(g, s, p)

    if n_stages is None:
        params = tree_map(lambda t: _owned(t, dev), params)
        opt_state = optimizer.init(params)
        losses = []
        for mbs in step_batches:
            g_acc, step_losses = None, []
            for mb in mbs:
                loss, g = value_and_grad(
                    lambda p, b: llama.loss_fn(p, b, config), params,
                    {"inputs": on_dev(mb["inputs"]),
                     "targets": on_dev(mb["targets"])})
                step_losses.append(float(loss))
                g_acc = accumulate(g_acc, g)
                del g
            opt_state = apply(params, opt_state, g_acc, float(len(mbs)))
            del g_acc
            losses.append(float(np.mean(np.asarray(step_losses,
                                                   np.float32))))
        return losses, params

    stages = split_llama_stages(params, config, n_stages)
    stage_params = [tree_map(lambda t: _owned(t, dev), p)
                    for p, _fn in stages]
    del stages
    fns = [make_stage_train_fns(config, i, n_stages)
           for i in range(n_stages)]
    fwds = [f for f, _b in fns]
    bwds = [b for _f, b in fns]
    opt_states = [optimizer.init(p) for p in stage_params]

    losses = []
    for mbs in step_batches:
        g_accs = [None] * n_stages
        step_losses = []
        for mb in mbs:
            acts = [on_dev(mb["inputs"])]
            for i in range(n_stages - 1):
                acts.append(fwds[i](stage_params[i], acts[i]))
            targets = on_dev(mb["targets"])
            loss = fwds[-1](stage_params[-1], acts[-1], targets)
            step_losses.append(float(loss))
            _loss, gp, gx = bwds[-1](stage_params[-1], acts[-1],
                                     targets)
            g_accs[-1] = accumulate(g_accs[-1], gp)
            for i in range(n_stages - 2, -1, -1):
                gp, gx = bwds[i](stage_params[i], acts[i], gx)
                g_accs[i] = accumulate(g_accs[i], gp)
            del acts, gp, gx
        for i in range(n_stages):
            opt_states[i] = apply(stage_params[i], opt_states[i],
                                  g_accs[i], float(len(mbs)))
        del g_accs
        losses.append(float(np.mean(np.asarray(step_losses,
                                               np.float32))))
    return losses, stage_params


# =====================================================================
# The driver-side plane
# =====================================================================

# pid-scoped unique names, the rl.distributed.new_plane_key idiom.
_pipe_counter = itertools.count(1)


def _new_pipe_name() -> str:
    return f"pipe-{os.getpid()}-{next(_pipe_counter)}"


class PipelinePlane:
    """Driver-side pipeline: gang placement, 1F1B scheduling, ref
    ownership, metrics, snapshots and whole-gang restart recovery. See
    the module docstring for the contract.

    ``device`` is where every stage computes (``cuda`` unless the caller
    passes another; without a card the constructor raises, before any
    sub-slice is reserved). ``worker_options`` go to the ``HostGroup``'s
    members: ``{"num_gpus": 1}`` on a card and ``{}`` on the CPU unless
    given (``{"num_gpus": 0.5}`` lets two stages share one card)."""

    def __init__(self, config, params, *, n_stages: int,
                 n_microbatches: int, lr: float = 1e-3,
                 window: Optional[int] = None,
                 name: Optional[str] = None,
                 chips_per_host: Optional[int] = None,
                 max_group_restarts: int = 2,
                 snapshot_every: Optional[int] = None,
                 device=None,
                 worker_options: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.core.device import resolve_device

        self.device = resolve_device(device)
        if worker_options is None:
            worker_options = ({"num_gpus": 1}
                              if self.device.type == "cuda" else {})
        self._worker_options = dict(worker_options)
        if n_stages < 1:
            raise ValueError("n_stages must be >= 1")
        if config.n_layers < n_stages:
            raise ValueError(f"{config.n_layers} layers cannot split "
                             f"into {n_stages} stages")
        self.config = config
        self.n_stages = int(n_stages)
        self.n_microbatches = int(n_microbatches)
        self.lr = float(lr)
        self.window = int(window) if window else self.n_stages
        self.name = name or _new_pipe_name()
        self._chips_per_host = chips_per_host
        self._max_group_restarts = int(max_group_restarts)
        self._snapshot_every = (rt_config.pipe_snapshot_every
                                if snapshot_every is None
                                else int(snapshot_every))
        self._init_params = params
        self._group: Optional[HostGroup] = None
        self._lock = threading.Lock()
        self._ledger = RefLedger()
        self._epoch = 0             # pipe-registry epoch (fencing)
        self._gang_epoch = 0        # group epoch the stages were set up under
        self._step = 0              # next optimizer step to run
        # Stage clocks diverged from the plane on a LIVE gang (an apply
        # reply lost after some stages applied): force a snapshot
        # re-push before the replay. Driver-thread only.
        self._need_resetup = False
        self._snapshot: Optional[Dict[str, Any]] = None
        self._losses: List[float] = []
        self._stage_last_event = [time.monotonic()] * self.n_stages
        self._stage_busy: List[Optional[Any]] = [None] * self.n_stages
        self._stage_busy_since: List[float] = [0.0] * self.n_stages
        # Cumulative dispatch->reply occupancy per stage (bench reads
        # deltas: bubble fraction = 1 - sum(busy)/(stages * wall)).
        self._stage_busy_s: List[float] = [0.0] * self.n_stages
        # Cumulative inter-stage tensor bytes (activations forward +
        # input-gradients backward) moved through the object plane.
        self._tensor_bytes_moved = 0
        self._inflight_mbs = 0
        # Last completed step's phase split (driver-observed stage-
        # seconds: fwd/bwd summed over dispatch->reply, apply = fan-out
        # wall x stages, idle = the remainder of stages x step wall) +
        # the achieved-FLOPs estimate behind the MFU gauge.
        self._last_breakdown: Optional[Dict[str, float]] = None
        self._n_params = int(sum(
            t.numel() for t in _tree_leaves(self._init_params)))
        from ray_tpu_torch.util import metrics as um

        um.add_collector(self._collect)

    # ------------------------------------------------------- formation

    def start(self) -> "PipelinePlane":
        """Gang-place the stages (all-or-nothing through the HostGroup
        sub-slice reservation) and register the pipeline record. Both
        acquisitions are discharged on every exception path between
        acquire and the handoff to ``self`` — a partial formation
        strands neither a gang nor a fenced pipeline record."""
        group = HostGroup(
            self.n_stages, name=f"{self.name}-gang",
            chips_per_host=self._chips_per_host,
            max_group_restarts=self._max_group_restarts,
            worker_options=self._worker_options,
            worker_cls=StageActor,
            owner=f"pipeline:{self.name}").start()
        self._form_record(group)
        return self

    def _form_record(self, group: HostGroup) -> None:
        """Register the pipeline record, set the fresh gang up, hand
        both to ``self`` (the lease local ``reg`` stays a subscript
        borrow through the fallible region; discharge lives in the
        ``_abort_formation`` self-callee). The register RPC is itself
        fallible (a head blip is a failure mode this codebase handles
        everywhere else): a raise BEFORE the record exists still tears
        the already-started gang down — there is just no record to
        drop yet — so ``start()``'s both-acquisitions-discharged
        contract holds on every path."""
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        try:
            stub = ControllerStub(_controller_client())
            reg = stub.pipe_register(self.name, self.n_stages,
                                     group.group_id,
                                     f"pid:{os.getpid()}",
                                     timeout=_cfg.ctrl_call_timeout_s)
        except BaseException:
            try:
                group.shutdown()
            except Exception:
                log_every("pipeline.abort_gang", 10.0, logger,
                          "tearing down gang of pipeline %s after a "
                          "failed pipe_register failed", self.name,
                          exc_info=True)
            raise
        try:
            self._setup_stages(group, int(reg["epoch"]))
        except BaseException:
            self._abort_formation(stub, group)
            raise
        self._commit_formation(group, reg)

    def _abort_formation(self, stub, group: HostGroup) -> None:
        """Partial-formation cleanup: drop the pipeline record and tear
        the gang down — each best-effort in its own guard, so a head
        blip during one cannot strand the other."""
        try:
            stub.pipe_drop(self.name, timeout=_cfg.ctrl_call_timeout_s)
        except Exception:
            log_every("pipeline.abort_drop", 10.0, logger,
                      "dropping pipeline %s during formation abort "
                      "failed", self.name, exc_info=True)
        try:
            group.shutdown()
        except Exception:
            log_every("pipeline.abort_gang", 10.0, logger,
                      "tearing down gang of pipeline %s during "
                      "formation abort failed", self.name,
                      exc_info=True)

    def _commit_formation(self, group: HostGroup, reg) -> None:
        with self._lock:
            self._group = group
            self._epoch = int(reg["epoch"])

    def _adopt_epoch(self, reg) -> None:
        with self._lock:
            self._epoch = int(reg["epoch"])

    def _setup_stages(self, group: HostGroup, epoch: int) -> None:
        """Push per-stage state to a fresh gang: the resume snapshot if
        one exists, else the initial split. Stage state rides the
        object plane (driver-owned refs, dropped once every stage has
        pulled its blob)."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.parallel.pipeline import split_llama_stages

        if self._snapshot is not None:
            states = [
                {"params": s["params"], "opt_state": s["opt_state"],
                 "step": s["step"]}
                for s in self._snapshot["stages"]]
            resume_step = int(self._snapshot["step"])
        else:
            stages = split_llama_stages(self._init_params, self.config,
                                        self.n_stages)
            states = [{"params": host_copies(p), "opt_state": None,
                       "step": 0} for p, _fn in stages]
            resume_step = 0
        members = group.members
        descs, refs = [], []
        try:
            for i, state in enumerate(states):
                desc = {"kind": "state", "stage": i,
                        "ref": rt.put(state)}
                self._ledger.borrow_ref(desc)
                descs.append(desc)
                spec = {"pipeline": self.name, "stage": i,
                        "n_stages": self.n_stages, "config": self.config,
                        "lr": self.lr, "epoch": epoch,
                        "device": str(self.device),
                        "threads": torch.get_num_threads()}
                refs.append(members[i].setup_stage.remote(spec, desc))
            replies = rt.get(refs, timeout=rt_config.pipe_setup_timeout_s)
        finally:
            for desc in descs:
                self._ledger.drop_ref(desc)
        for i, rep in enumerate(replies):
            if int(rep["step"]) != resume_step:
                raise PipelineError(
                    f"stage {i} resumed at step {rep['step']}, plane "
                    f"expected {resume_step}")
        flightrec.record("pipe.snapshot.push", pipeline=self.name,
                         step=resume_step, stages=self.n_stages,
                         epoch=epoch)
        with self._lock:
            self._step = resume_step
            self._gang_epoch = group.epoch
            self._stage_busy = [None] * self.n_stages
            now = time.monotonic()
            self._stage_last_event = [now] * self.n_stages
            self._inflight_mbs = 0

    # -------------------------------------------------------- recovery

    def _ensure_gang(self) -> None:
        """Before (re)running a step: if the gang was reconciled under
        a new epoch since the stages were set up, wait for it to be
        ALIVE, re-register the pipeline (epoch bump fences the dead
        incarnation's step reports) and re-push the snapshot. The
        ``_need_resetup`` drift flag (stage clocks diverged from the
        plane on the SAME live incarnation) forces the same snapshot
        re-push without a re-register — nothing died, so there is no
        deposed incarnation to fence."""
        group = self._group
        if group is None:
            raise PipelineError(f"pipeline {self.name} not started")
        deadline = time.monotonic() + 60.0
        while True:
            state, epoch = group.state, group.epoch
            if state == "ALIVE" and epoch == self._gang_epoch:
                if not self._need_resetup:
                    return
                break  # same gang, drifted stages: re-push snapshot
            if state == "ALIVE":
                break  # re-formed gang: needs a fresh setup
            if state in ("DEAD", "SHUTDOWN"):
                raise PipelineError(
                    f"pipeline {self.name}: gang is {state} "
                    f"({group.status()['death_cause']})")
            if time.monotonic() > deadline:
                raise PipelineError(
                    f"pipeline {self.name}: gang stuck in {state}")
            time.sleep(0.05)
        if group.epoch != self._gang_epoch:
            from ray_tpu_torch.core.rpc_stubs import ControllerStub

            stub = ControllerStub(_controller_client())
            # Re-registration bumps the record's epoch (fencing the
            # dead incarnation's in-flight reports); the record itself
            # already belongs to this plane, so ownership hands off to
            # self BEFORE the fallible setup — a failed setup keeps the
            # registration (the next attempt re-registers and bumps
            # again).
            reg = stub.pipe_register(self.name, self.n_stages,
                                     group.group_id,
                                     f"pid:{os.getpid()}",
                                     timeout=_cfg.ctrl_call_timeout_s)
            self._adopt_epoch(reg)
        flightrec.record("pipe.resetup", pipeline=self.name,
                         step=self._step, epoch=self._epoch,
                         drift=self._need_resetup)
        self._setup_stages(group, self._epoch)
        self._need_resetup = False
        logger.info(
            "pipeline %s: gang state re-pushed (gang epoch %d, "
            "pipeline epoch %d), resuming from step %d", self.name,
            self._gang_epoch, self._epoch, self._step)

    def _await_reconcile(self) -> None:
        """After a mid-step disruption: the gang monitor needs a beat
        to notice a dead member and reconcile — replaying against the
        old incarnation's corpses just burns attempts. Park until the
        group epoch moves (reconciliation happened; _ensure_gang will
        re-push the snapshot), the group leaves ALIVE (reconciling/
        dead), or every member answers a ping (the disruption was
        transient — replay on the live gang)."""
        import ray_tpu_torch as rt

        group = self._group
        if group is None:
            return
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if group.epoch != self._gang_epoch \
                    or group.state != "ALIVE":
                return
            members = group.members
            try:
                rt.get([m.ping.remote() for m in members], timeout=2.0)
                return  # whole gang answers: transient, replay now
            except Exception:
                time.sleep(0.2)  # dead member: wait for the monitor

    def _drop_inflight(self) -> int:
        """Drop every in-flight activation/gradient ref — the abort
        path (stage death, step failure). Refs whose owner died with
        its stage free on the owner side; the driver's handles must not
        pin the rest."""
        dropped = 0
        for desc in self._ledger.live():
            if self._ledger.drop_ref(desc):
                dropped += 1
        with self._lock:
            self._stage_busy = [None] * self.n_stages
            self._inflight_mbs = 0
        return dropped

    # -------------------------------------------------------- training

    def train_step(self, mbs: List[Dict[str, Any]]) -> float:
        """Run ONE optimizer step over ``mbs`` microbatches with the
        1F1B schedule; returns the mean microbatch loss. A whole-gang
        disruption mid-step drops the in-flight window and REPLAYS the
        step on the re-formed gang (same data — the resume contract)."""
        if len(mbs) != self.n_microbatches:
            raise ValueError(f"expected {self.n_microbatches} "
                             f"microbatches, got {len(mbs)}")
        from contextlib import nullcontext

        from ray_tpu_torch.core.config import config as rt_config

        attempts = self._max_group_restarts + 1
        for attempt in range(attempts):
            self._ensure_gang()
            try:
                # The root span of the train-plane trace: every stage's
                # fwd/bwd/apply span parents under it through the task
                # specs, so one optimizer step is one causally-linked
                # tree across the stage processes. Head-sampled: only
                # every pipe_trace_sample_every'th step opens the root,
                # and the ~180 downstream span events of an unsampled
                # step never exist (stage/cell emission gates on the
                # propagated context).
                sample = max(1, rt_config.pipe_trace_sample_every)
                span = (tracing.trace("pipe:step", pipeline=self.name,
                                      step=self._step, mbs=len(mbs),
                                      attempt=attempt)
                        if (rt_config.pipe_trace_spans
                            and self._step % sample == 0)
                        else nullcontext())
                with span:
                    return self._run_step_once(mbs)
            except _GangDisrupted as e:
                flightrec.record("pipe.disrupted", pipeline=self.name,
                                 step=self._step, reason=str(e),
                                 attempt=attempt)
                dropped = self._drop_inflight()
                logger.warning(
                    "pipeline %s: step %d disrupted (%s); dropped %d "
                    "in-flight refs, replaying on the re-formed gang "
                    "(attempt %d/%d)", self.name, self._step, e,
                    dropped, attempt + 1, attempts)
                self._await_reconcile()
        raise PipelineError(
            f"pipeline {self.name}: step {self._step} failed after "
            f"{attempts} gang incarnations")

    def run(self, step_batches: List[List[Dict[str, Any]]]
            ) -> List[float]:
        """Convenience loop: one ``train_step`` per entry."""
        return [self.train_step(mbs) for mbs in step_batches]

    # The 1F1B scheduler. One dispatch per stage (a stage is one
    # compute unit); backward preferred over forward (bounds the
    # stash); admission gated by the in-flight window.
    def _run_step_once(self, mbs: List[Dict[str, Any]]) -> float:
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.config import config as rt_config
        from ray_tpu_torch.core.serialization import serialized_size

        group = self._group
        members = group.members
        if len(members) != self.n_stages:
            raise _GangDisrupted("gang re-forming (member list short)")
        # Per-step stage reset + clock check. A replay on a SURVIVING
        # gang (transient disruption — no reconcile rebuilt the stages)
        # otherwise runs against the _g_acc/_stash the aborted attempt
        # left behind and double-counts its completed backwards.
        try:
            begun = rt.get(
                [a.begin_step.remote(self._step) for a in members],
                timeout=30.0)
        except Exception as e:
            raise _GangDisrupted(
                f"begin_step failed: {type(e).__name__}") from e
        clocks = [int(r["step"]) for r in begun]
        if any(c != self._step for c in clocks):
            # A stage already applied the step this driver is about to
            # (re)run — its apply REPLY was lost, not its update.
            # Running against drifted (possibly mixed) clocks would
            # double-apply; rewind every stage to a consistent step
            # from the snapshot first. On the record: this is the
            # replay DOUBLE-APPLY GUARD firing — the post-mortem
            # reports it so a resumed-run loss curve can be trusted
            # (or not) from evidence.
            flightrec.record("pipe.clock.drift", pipeline=self.name,
                             step=self._step,
                             clocks=",".join(str(c) for c in clocks))
            self._need_resetup = True
            raise _GangDisrupted(
                f"stage clocks {clocks} drifted from plane step "
                f"{self._step}; re-pushing the snapshot")
        flightrec.record("pipe.step.start", pipeline=self.name,
                         step=self._step, mbs=len(mbs))
        t_step0 = time.monotonic()
        phase_s = {"fwd": 0.0, "bwd": 0.0}
        tokens = int(sum(np.asarray(mb["inputs"]).size for mb in mbs))
        S, n = self.n_stages, len(mbs)
        last = S - 1
        ready_fwd: List[deque] = [deque() for _ in range(S)]
        ready_bwd: List[deque] = [deque() for _ in range(S)]
        task_by_ref: Dict[Any, Tuple[str, int, int,
                                     Optional[Dict[str, Any]]]] = {}
        tgt_descs: Dict[int, Dict[str, Any]] = {}
        losses: Dict[int, float] = {}
        admitted = retired = 0
        deadline = time.monotonic() + rt_config.pipe_step_timeout_s

        try:
            def admit() -> None:
                nonlocal admitted
                while (admitted < n
                       and admitted - retired < self.window):
                    m = admitted
                    tok = {"kind": "tok", "mb": m,
                           "ref": rt.put(mbs[m]["inputs"]),
                           "nbytes": int(mbs[m]["inputs"].nbytes)}
                    self._ledger.borrow_ref(tok)
                    tgt = {"kind": "tgt", "mb": m,
                           "ref": rt.put(mbs[m]["targets"]),
                           "nbytes": int(mbs[m]["targets"].nbytes)}
                    self._ledger.borrow_ref(tgt)
                    tgt_descs[m] = tgt
                    ready_fwd[0].append((m, tok))
                    admitted += 1
                with self._lock:
                    self._inflight_mbs = admitted - retired

            def dispatch(s: int) -> None:
                if self._stage_busy[s] is not None:
                    return
                if ready_bwd[s]:
                    m, gdesc = ready_bwd[s].popleft()
                    ref = members[s].backward.remote(m, gdesc)
                    task_by_ref[ref] = ("bwd", m, s, gdesc,
                                        time.time())
                elif ready_fwd[s]:
                    m, in_desc = ready_fwd[s].popleft()
                    tgt = tgt_descs[m] if s == last else None
                    ref = members[s].forward.remote(m, in_desc, tgt)
                    task_by_ref[ref] = ("fwd", m, s, in_desc,
                                        time.time())
                else:
                    return
                with self._lock:
                    self._stage_busy[s] = ref
                    self._stage_busy_since[s] = time.monotonic()

            admit()
            for s in range(S):
                dispatch(s)

            while retired < n:
                busy = [r for r in self._stage_busy if r is not None]
                if not busy:
                    raise PipelineError(
                        f"pipeline {self.name}: scheduler wedged at "
                        f"step {self._step} (admitted {admitted}, "
                        f"retired {retired}, window {self.window})")
                if time.monotonic() > deadline:
                    raise PipelineError(
                        f"pipeline {self.name}: step {self._step} "
                        f"exceeded pipe_step_timeout_s "
                        f"({rt_config.pipe_step_timeout_s:.0f}s); "
                        f"stage state: "
                        f"{[bool(r) for r in self._stage_busy]}")
                done, _ = rt.wait(busy, num_returns=1, timeout=1.0)
                if not done:
                    if group.epoch != self._gang_epoch \
                            or group.state != "ALIVE":
                        raise _GangDisrupted("gang epoch moved")
                    continue
                for ref in done:
                    kind, m, s, consumed, t_disp = task_by_ref.pop(ref)
                    try:
                        reply = rt.get(ref, timeout=30.0)
                    except Exception as e:
                        raise _GangDisrupted(
                            f"stage {s} {kind}(mb={m}) failed: "
                            f"{type(e).__name__}") from e
                    self._observe_desc(serialized_size(reply))
                    now = time.monotonic()
                    if rt_config.pipe_trace_spans and tracing.traced():
                        # The DRIVER's view of the same cell
                        # (dispatch -> reply) — exactly the clocks the
                        # bench's bubble fraction is computed from, so
                        # the trace-derived bubble matches it by
                        # construction (the stage-side fwd/bwd spans
                        # show pure compute occupancy, which on a
                        # time-sliced host is much smaller).
                        tracing.record_span(f"cell:{kind}", t_disp,
                                            time.time(), step=self._step,
                                            mb=m, stage=s)
                    phase_s[kind] += now - self._stage_busy_since[s]
                    with self._lock:
                        self._stage_busy[s] = None
                        self._stage_busy_s[s] += \
                            now - self._stage_busy_since[s]
                        self._stage_last_event[s] = now
                    if consumed is not None:
                        self._ledger.drop_ref(consumed)
                    if kind == "fwd":
                        if s < last:
                            self._ledger.borrow_ref(reply)
                            with self._lock:
                                self._tensor_bytes_moved += \
                                    int(reply.get("nbytes", 0))
                            ready_fwd[s + 1].append((m, reply))
                        else:
                            losses[m] = float(reply["loss"])
                            self._ledger.drop_ref(tgt_descs.pop(m))
                            ready_bwd[last].append((m, None))
                    else:
                        if s > 0:
                            self._ledger.borrow_ref(reply)
                            with self._lock:
                                self._tensor_bytes_moved += \
                                    int(reply.get("nbytes", 0))
                            ready_bwd[s - 1].append((m, reply))
                        else:
                            retired += 1
                    admit()
                    for st in range(S):
                        dispatch(st)

            # ---- all microbatches backpropagated: one update per stage
            t_apply0 = time.monotonic()
            refs = [a.apply_update.remote(n, self._step)
                    for a in members]
            try:
                rt.get(refs, timeout=60.0)
            except Exception as e:
                raise _GangDisrupted(
                    f"apply_update failed: {type(e).__name__}") from e
            apply_wall = time.monotonic() - t_apply0
            # Snapshot BEFORE any driver bookkeeping: if the gang DIES
            # during the pull, this step's effects are lost with it and
            # the replay (from the previous snapshot, with the same
            # data) is exactly right — nothing must remember a step
            # whose state evaporated. A transient pull failure on a
            # LIVE gang is _take_snapshot's own problem (retry, else
            # keep the stale snapshot): the stages DID apply, so a
            # replay would double-count the step.
            completed = self._step
            if self._snapshot_every \
                    and (completed + 1) % self._snapshot_every == 0:
                self._take_snapshot(members)
        except BaseException:
            # Every in-flight activation/gradient ref is dropped on the
            # way out — the abort path must strand nothing (graftlint
            # resource-leak-path, ObjectRef shape).
            self._drop_inflight()
            raise

        if self._ledger.count():
            # Accounting bug, not a transient: every desc has exactly
            # one consumer whose reply drops it.
            leaked = self._ledger.count()
            self._drop_inflight()
            raise PipelineError(
                f"pipeline {self.name}: {leaked} refs still in the "
                f"ledger after a completed step (scheduler accounting "
                f"bug)")
        step_loss = float(np.mean(np.asarray(
            [losses[m] for m in range(n)], np.float32)))
        wall = time.monotonic() - t_step0
        # Per-step phase split in STAGE-SECONDS (the MFU
        # accounting discipline: know where every stage-second of the
        # step went). fwd/bwd sum driver-observed dispatch->reply
        # occupancy; apply is the concurrent fan-out charged to every
        # stage; idle is the remainder — the measured 1F1B bubble plus
        # control-plane overhead. allgather stays 0 here: ZeRO-1
        # composed inside a pipelined stage's data mesh is a real-rig
        # item for more cards; the zero1 data-parallel step exports its
        # own span instead.
        apply_s = apply_wall * S
        idle_s = max(0.0, S * wall - phase_s["fwd"] - phase_s["bwd"]
                     - apply_s)
        # Achieved model FLOP/s: ~8 * params * tokens per step (2 fwd
        # + 4 bwd + 2 recompute-fwd — the stage backward recomputes its
        # forward under autograd).
        tflops = (8.0 * self._n_params * tokens) / max(wall, 1e-9) / 1e12
        with self._lock:
            self._step = completed + 1
            self._losses.append(step_loss)
            self._inflight_mbs = 0
            self._last_breakdown = {
                "fwd_s": phase_s["fwd"], "bwd_s": phase_s["bwd"],
                "apply_s": apply_s, "allgather_s": 0.0,
                "idle_s": idle_s, "wall_s": wall,
                "tokens": float(tokens), "model_tflops": tflops,
            }
        flightrec.record("pipe.step.commit", pipeline=self.name,
                         step=completed)
        self._report_step(completed)
        return step_loss

    def _observe_desc(self, nbytes: int) -> None:
        from ray_tpu_torch.core.config import config as rt_config

        if not rt_config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cm

        cm.PIPE_DESC_BYTES.observe(float(nbytes),
                                   tags={"pipeline": self.name})

    def _report_step(self, completed: int) -> None:
        """Record the completed step on the controller's pipeline
        registry, fenced by the pipeline epoch: a deposed incarnation's
        late report is rejected, never applied."""
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        try:
            reply = ControllerStub(_controller_client())\
                .pipe_step_complete(self.name, completed, self._epoch,
                                    timeout=_cfg.ctrl_call_timeout_s)
        except Exception:
            log_every("pipeline.step_report", 10.0, logger,
                      "reporting step %d of pipeline %s failed",
                      completed, self.name, exc_info=True)
            return
        if not reply.get("ok"):
            logger.warning(
                "pipeline %s: step report fenced (%s) — a newer "
                "incarnation owns the record", self.name, reply)

    def _take_snapshot(self, members) -> None:
        """Pull the per-stage state the driver owns across gang deaths.
        Gang death mid-pull raises ``_GangDisrupted`` — the applied
        step's effects died with the gang, so replaying it (previous
        snapshot, same data) is exactly right. A TRANSIENT pull failure
        on a live gang must NOT replay (the stages already applied; the
        stage clock guard would fail every attempt and a healthy gang
        would die a fatal PipelineError): retry, and if it persists,
        forfeit this snapshot — the step still commits, the previous
        snapshot stays the recovery point."""
        import ray_tpu_torch as rt

        group = self._group
        for attempt in range(3):
            try:
                snaps = rt.get(
                    [a.snapshot.remote() for a in members],
                    timeout=60.0)
            except Exception as e:
                if group.epoch != self._gang_epoch \
                        or group.state != "ALIVE":
                    raise _GangDisrupted(
                        f"snapshot failed: {type(e).__name__}") from e
                if attempt == 2:
                    flightrec.record("pipe.snapshot.forfeit",
                                     pipeline=self.name,
                                     step=self._step)
                    log_every(
                        "pipeline.snapshot", 10.0, logger,
                        "pipeline %s: snapshot at step %d failed %d "
                        "times on a live gang; keeping the previous "
                        "snapshot (the step still commits)", self.name,
                        self._step, attempt + 1, exc_info=True)
                    return
                time.sleep(0.2)
                continue
            # Copied out of the store: the tensors read back are views
            # of the reply's object, which would stay pinned as long as
            # the driver keeps the snapshot.
            snaps = [{**s, "params": host_copies(s["params"]),
                      "opt_state": {**s["opt_state"],
                                    "mu": host_copies(s["opt_state"]["mu"]),
                                    "nu": host_copies(
                                        s["opt_state"]["nu"])}}
                     for s in snaps]
            with self._lock:
                # The stage clocks are authoritative (they already
                # applied the update this snapshot captures).
                self._snapshot = {"step": int(snaps[0]["step"]),
                                  "stages": snaps}
            flightrec.record("pipe.snapshot.pull", pipeline=self.name,
                             step=int(snaps[0]["step"]))
            return

    # --------------------------------------------------------- surface

    def losses(self) -> List[float]:
        with self._lock:
            return list(self._losses)

    @property
    def group(self) -> Optional[HostGroup]:
        """The stage gang (None before ``start`` and after ``stop``):
        ``group.broadcast`` runs a function in every stage's process."""
        return self._group

    def snapshot_params(self):
        """The last snapshot's per-stage params (CPU tensors), for parity
        checks."""
        with self._lock:
            if self._snapshot is None:
                return None
            return [s["params"] for s in self._snapshot["stages"]]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            busy = [r is not None for r in self._stage_busy]
            out = {
                "pipeline": self.name,
                "n_stages": self.n_stages,
                "window": self.window,
                "step": self._step,
                "epoch": self._epoch,
                "gang_epoch": self._gang_epoch,
                "inflight_microbatches": self._inflight_mbs,
                "ledger_refs": self._ledger.count(),
                "ledger_bytes": self._ledger.live_bytes(),
                "stage_busy": busy,
                "stage_busy_s": list(self._stage_busy_s),
                "tensor_bytes_moved": self._tensor_bytes_moved,
                "step_breakdown": (dict(self._last_breakdown)
                                   if self._last_breakdown else None),
            }
        out["group"] = None if self._group is None \
            else self._group.status()
        return out

    def registry_state(self) -> Optional[Dict[str, Any]]:
        """The controller's record of this pipeline (``pipe_state``)."""
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        return ControllerStub(_controller_client()).pipe_state(
            self.name, timeout=_cfg.ctrl_call_timeout_s)

    def _collect(self) -> None:
        """Snapshot-time collector: the doctor's pipeline-stall signal.
        A stage with a dispatched call is BUSY (idle 0); a stage with
        nothing outstanding has been idle since its last event — one
        stage busy while the rest idle for a whole window names the
        straggler."""
        from ray_tpu_torch.core.config import config as rt_config

        if not rt_config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cm

        now = time.monotonic()
        with self._lock:
            rows = [(f"s{i}",
                     0.0 if self._stage_busy[i] is not None
                     else max(0.0, now - self._stage_last_event[i]))
                    for i in range(self.n_stages)]
            inflight = float(self._inflight_mbs)
            act_bytes = float(self._ledger.live_bytes())
            breakdown = (dict(self._last_breakdown)
                         if self._last_breakdown else None)
        # Pipeline names and stage indexes are bounded by live planes
        # (a handful per driver), not request volume.
        cm.PIPE_INFLIGHT.set(inflight, tags={"pipeline": self.name})
        cm.PIPE_ACTIVATION_BYTES.set(act_bytes,
                                     tags={"pipeline": self.name})
        for stage, idle in rows:
            cm.PIPE_STAGE_IDLE_S.set(idle, tags={"pipeline": self.name,
                                                 "stage": stage})
        if breakdown is not None:
            for phase in ("fwd", "bwd", "apply", "allgather", "idle"):
                cm.PIPE_STEP_PHASE_S.set(
                    breakdown[f"{phase}_s"],
                    tags={"pipeline": self.name, "phase": phase})
            cm.PIPE_MODEL_TFLOPS.set(breakdown["model_tflops"],
                                     tags={"pipeline": self.name})
            peak = rt_config.pipe_peak_tflops
            if peak > 0:
                cm.PIPE_MFU.set(
                    100.0 * breakdown["model_tflops"] / peak,
                    tags={"pipeline": self.name})

    def stop(self) -> Dict[str, Any]:
        """Deterministic teardown: drop every in-flight ref, flatten
        the gauges, drop the pipeline record, shut the gang down.
        Returns the leak-accounting report the shutdown test pins —
        ``inflight_refs_dropped`` is 0 on any clean between-steps
        stop."""
        dropped = self._drop_inflight()
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        try:
            ControllerStub(_controller_client()).pipe_drop(
                self.name, timeout=_cfg.ctrl_call_timeout_s)
        except Exception:
            log_every("pipeline.stop_drop", 10.0, logger,
                      "dropping pipeline record %s failed", self.name,
                      exc_info=True)
        group, self._group = self._group, None
        if group is not None:
            group.shutdown()
        self._zero_gauges()
        from ray_tpu_torch.core.object_ref import _RefTracker

        _RefTracker.get().flush()
        return {"inflight_refs_dropped": dropped,
                "ledger_refs": self._ledger.count(),
                "steps_completed": self._step}

    def _zero_gauges(self) -> None:
        from ray_tpu_torch.core.config import config as rt_config

        if not rt_config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cm

        cm.PIPE_INFLIGHT.set(0.0, tags={"pipeline": self.name})
        cm.PIPE_ACTIVATION_BYTES.set(0.0, tags={"pipeline": self.name})
        for i in range(self.n_stages):
            cm.PIPE_STAGE_IDLE_S.set(0.0, tags={"pipeline": self.name,
                                                "stage": f"s{i}"})
        for phase in ("fwd", "bwd", "apply", "allgather", "idle"):
            cm.PIPE_STEP_PHASE_S.set(0.0, tags={"pipeline": self.name,
                                                "phase": phase})
        cm.PIPE_MODEL_TFLOPS.set(0.0, tags={"pipeline": self.name})
        if rt_config.pipe_peak_tflops > 0:
            cm.PIPE_MFU.set(0.0, tags={"pipeline": self.name})


# ---------------------------------------------------------------- misc


def _controller_client():
    from ray_tpu_torch.core.runtime import get_core_worker

    return get_core_worker().controller


# The tag a snapshot's optimizer state carries: the port's Adam state
# (count, mu, nu as tensors), never optax state from the JAX package.
_STATE_FORMAT = "ray_tpu_torch"


def host_copies(tree):
    """CPU copies of a nested dict of tensors (snapshot/setup payloads);
    the JAX package's ``jax_to_numpy``. Copies, never views: the stage
    writes its params and Adam state in place."""
    from ray_tpu_torch.ops.optim import tree_map

    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _owned(x, device: "torch.device") -> "torch.Tensor":
    """``x`` (a tensor, or a numpy array) as a tensor on ``device`` that
    owns its memory: a tensor read from the store is a read-only view of
    the store's bytes."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(device)
    return x.detach().to(device, copy=True)


def _tree_leaves(tree):
    from ray_tpu_torch.ops.optim import tree_leaves

    return tree_leaves(tree)
