"""resource-leak-path: path-sensitive acquire/release pairing.

Walks each function as a structured control-flow interpreter (if/else
splits, loop bodies, try/except/finally with exception edges) carrying
the set of live resources, and flags any path that exits the function —
by return, fall-through, or an escaping exception — while a resource is
still live and unowned. Resource idioms are fitted to this codebase
(rules.py tables):

* local constructors — ``sock = socket.socket()`` / ``open()`` paired
  with ``.close()`` (a ``with`` form is never tracked: the context
  manager releases);
* receiver-keyed pairs — ``sel.register(...)``/``sel.unregister(...)``,
  ``cache.pin(...)``/``unpin``; release may happen in a self.-callee
  (``_drop``-style teardown helpers), resolved over the call graph.
  Tracked only in functions that DO release the pair somewhere —
  a function that never releases owns the registration by design
  (``__init__`` registering the listening socket);
* slot pools — ``self._free.pop()`` leases, ``self._free.append(s)``
  returns (DecodeEngine slots); ``pages = self._pages.alloc(n)``
  leases KV pool pages, ``self._pages.free(...)`` returns them — the
  leased local matches anywhere inside a release argument expression
  (``free(shared + fresh)``), since the paged-KV allocator frees
  collections;
* refcounts — ``ent.refcount += 1`` pins, ``-= 1`` unpins (prefix-cache
  rows); ``alloc.incref(p)``/``decref(p)`` pin/unpin pool pages
  (method-pair form);
* topology leases — ``sub = client.call("reserve_subslice", ...)``
  acquires a lease that ``client.call("release_subslice", id)`` (on ANY
  client object — leases are keyed by reservation id on the head, not
  by the receiver; release may live in a self.-callee like the serve
  controller's ``_release_subslice``/``_kill_replica`` chain) must
  discharge on every exception path. Like receiver-keyed pairs, a lease
  surviving a *normal* exit is the design (the replica record owns it);
  only an escaping exception between reserve and release/handoff leaks
  — the stranded reservation pins its chips until the hosting node
  dies. Handoff is recognized when the lease local is passed as a BARE
  argument to any call (``ReplicaRecord(handle, rid, sub)``) — nested
  reads (``chip_resources(sub["chips"], ...)``) stay borrows.

Ownership transfer kills liveness: storing the resource (assignment
value — including wrapping constructors like ``_Conn(sock)``),
returning or yielding it, or raising with it. Passing it as a bare
call argument is a *borrow* (the callee is not assumed to close it).
Generator functions are skipped (suspension makes path-exit analysis
meaningless).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo, dotted,
                                        _walk_no_nested)
from ray_tpu_torch.analysis.core import Finding

State = FrozenSet[int]
Outcomes = Dict[str, Set[Tuple[State, int]]]
_EXITS = ("fall", "return", "raise", "break", "continue")


@dataclass
class Resource:
    rid: int
    kind: str            # ctor | pair | pool | ref | lease | ckpt
    name: Optional[str]  # local var holding it (ctor/pool/lease)
    recv_key: Optional[str]   # receiver dotted key (pair/ref/pool),
    #                           "rpc:<release name>" (lease), or
    #                           "ckpt:<save method>" (ckpt)
    release_verb: str
    label: str
    line: int
    node_id: int         # id() of the acquire AST node


_LEASE_NAMES = frozenset(rules.RPC_LEASE_PAIRS) \
    | frozenset(rules.RPC_LEASE_PAIRS.values())
# Save-method names of the checkpoint idiom (checkpoint-missing-save):
# a state-mutating handler "acquires" dirty state at entry and must
# discharge it by reaching the class's save method on every normal exit.
_CKPT_SAVES = frozenset(save for save, _methods
                        in rules.CHECKPOINT_CLASSES.values())


def _ckpt_entry(info: FunctionInfo):
    """(save_method, label) when ``info`` is a handler the checkpoint
    table obliges to save, else None."""
    if info.cls is None:
        return None
    entry = rules.CHECKPOINT_CLASSES.get(info.cls)
    if entry is None:
        return None
    save, methods = entry
    name = getattr(info.node, "name", "")
    if name in methods:
        return save, f"state mutation in {info.cls}.{name}"
    return None


def _lease_rpc_name(node: ast.AST) -> Optional[str]:
    """The RPC name of a lease-pair site, in either spelling: the raw
    ``.call("reserve_subslice", ...)`` verb form, or the generated-stub
    method form (``stub.reserve_subslice(...)`` — the method name IS
    the endpoint name, core/rpc_stubs.py)."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return None
    if node.func.attr in rules.RPC_LEASE_VERBS and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        name = node.args[0].value
        return name if name in _LEASE_NAMES else None
    if node.func.attr in _LEASE_NAMES:
        return node.func.attr
    return None


def _release_summaries(graph: CallGraph) -> Dict[str, Set[Tuple[str, str]]]:
    """fqn -> {(recv dotted, verb)} released directly or via self-call
    chains (one fixpoint): lets ``self._drop(st)`` count as the
    ``self._selector.unregister`` it performs."""
    verbs = set(rules.RESOURCE_METHOD_PAIRS.values())
    graph.edges()  # ensure the side indexes are built
    direct: Dict[str, Set[Tuple[str, str]]] = {
        fqn: set() for fqn in graph.functions}
    for verb in verbs:
        for node, info in graph.calls_by_tail.get(verb, ()):
            if isinstance(node.func, ast.Attribute):
                d = dotted(node.func.value)
                if d is not None:
                    direct[info.fqn].add((d, verb))
    for node, info in graph.attr_augassigns:
        if node.target.attr in rules.RESOURCE_REFCOUNT_ATTRS \
                and isinstance(node.op, ast.Sub):
            d = dotted(node.target.value)
            if d is not None:
                direct[info.fqn].add((d, "refdec"))
    lease_releases = set(rules.RPC_LEASE_PAIRS.values())
    for tail in tuple(rules.RPC_LEASE_VERBS) + tuple(lease_releases):
        for node, info in graph.calls_by_tail.get(tail, ()):
            name = _lease_rpc_name(node)
            if name in lease_releases:
                direct[info.fqn].add((f"rpc:{name}", name))
    # checkpoint saves: ``self._save_state()`` on a method's NORMAL
    # path counts, and propagates through self-call chains below
    # (delete -> _save_state discharges a caller's obligation). Saves
    # lexically inside an ``except`` handler are excluded from the
    # summary: a callee that only checkpoints on its failure path
    # (_release_reservation queueing a failed release) does not
    # discharge its caller — summaries are path-insensitive, so
    # without this exclusion every handler that can reach
    # _kill_replica would count as checkpointed.
    for save in _CKPT_SAVES:
        except_ids: Dict[str, Set[int]] = {}
        for node, info in graph.calls_by_tail.get(save, ()):
            if not (isinstance(node.func, ast.Attribute)
                    and dotted(node.func.value) == "self"):
                continue
            ids = except_ids.get(info.fqn)
            if ids is None:
                ids = set()
                for n in _walk_no_nested(info.node):
                    if isinstance(n, ast.Try):
                        for handler in n.handlers:
                            ids.update(id(sub) for sub
                                       in ast.walk(handler))
                except_ids[info.fqn] = ids
            if id(node) in ids:
                continue
            direct[info.fqn].add((f"ckpt:{save}", save))

    closure = {fqn: set(rel) for fqn, rel in direct.items()}
    changed = True
    iters = 0
    while changed and iters < 10:
        changed = False
        iters += 1
        for fqn, rows in graph.edges().items():
            cur = closure.get(fqn)
            if cur is None:
                continue
            before = len(cur)
            for callee, _line, via_self in rows:
                if via_self and callee in closure:
                    # only self.-keyed releases survive the hop (the
                    # callee's ``self`` is the caller's ``self``); lease
                    # releases are global (reservation-id keyed on the
                    # head) and checkpoint saves are self-keyed by
                    # construction, so they survive too
                    cur.update(k for k in closure[callee]
                               if k[0].startswith(("self.", "rpc:",
                                                   "ckpt:")))
            if len(cur) != before:
                changed = True
    return closure


def _collect_resources(graph: CallGraph, info: FunctionInfo,
                       summaries: Dict[str, Set[Tuple[str, str]]]
                       ) -> List[Resource]:
    """Acquire sites in this function, per the rules tables."""
    out: List[Resource] = []
    with_ctx_ids: Set[int] = set()
    for node in _walk_no_nested(info.node):
        if isinstance(node, ast.With):
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    with_ctx_ids.add(id(sub))

    # does this function release (recv_key, verb) anywhere, directly or
    # through a self-call? precondition for pair tracking.
    def releases_somewhere(recv_key: str, verb: str) -> bool:
        for node in _walk_no_nested(info.node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                if node.func.attr == verb \
                        and dotted(node.func.value) == recv_key:
                    return True
                callee, _vs = graph.resolve_call_cached(node, info)
                if callee is not None and recv_key.startswith("self.") \
                        and (recv_key, verb) in summaries.get(callee,
                                                              ()):
                    return True
            elif verb == "refdec" and isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Attribute) \
                    and node.target.attr in rules.RESOURCE_REFCOUNT_ATTRS \
                    and isinstance(node.op, ast.Sub) \
                    and dotted(node.target.value) == recv_key:
                return True
        return False

    rid = 0
    # checkpoint obligation: "acquired" at function ENTRY (the handler
    # is about to mutate durable state), discharged only by reaching
    # the save method (directly or via a self-callee). Seeded into the
    # interpreter's initial state by _FnAnalysis.run.
    ckpt = _ckpt_entry(info)
    if ckpt is not None:
        save, label = ckpt
        out.append(Resource(rid, "ckpt", None, f"ckpt:{save}", save,
                            label, info.node.lineno, id(info.node)))
        rid += 1
    for node in _walk_no_nested(info.node):
        # ctor acquires: x = socket.socket(...) / open(...)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call) \
                and id(node.value) not in with_ctx_ids:
            rd = graph.resolved_dotted(node.value, info)
            if rd in rules.RESOURCE_CTOR_DOTTED:
                out.append(Resource(
                    rid, "ctor", node.targets[0].id, None,
                    rules.RESOURCE_CTOR_DOTTED[rd], rd, node.lineno,
                    id(node)))
                rid += 1
                continue
            # topology lease: sub = client.call("reserve_subslice", ...)
            rpc_name = _lease_rpc_name(node.value)
            if rpc_name in rules.RPC_LEASE_PAIRS:
                release = rules.RPC_LEASE_PAIRS[rpc_name]
                out.append(Resource(
                    rid, "lease", node.targets[0].id, f"rpc:{release}",
                    release, f'call("{rpc_name}") lease', node.lineno,
                    id(node)))
                rid += 1
                continue
            # pool lease: slot = self._free.pop()
            vfunc = node.value.func
            if isinstance(vfunc, ast.Attribute) \
                    and isinstance(vfunc.value, ast.Attribute):
                pool_attr = vfunc.value.attr
                pair = rules.RESOURCE_POOL_ATTRS.get(pool_attr)
                if pair is not None and vfunc.attr == pair[0]:
                    recv = dotted(vfunc.value)
                    out.append(Resource(
                        rid, "pool", node.targets[0].id, recv, pair[1],
                        f"{recv}.{pair[0]}() slot", node.lineno,
                        id(node)))
                    rid += 1
                    continue
        # receiver-keyed pair acquires: sel.register(...) / cache.pin(..)
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in rules.RESOURCE_METHOD_PAIRS \
                and id(node) not in with_ctx_ids:
            recv = dotted(node.func.value)
            verb = rules.RESOURCE_METHOD_PAIRS[node.func.attr]
            if recv is not None and releases_somewhere(recv, verb):
                out.append(Resource(
                    rid, "pair", None, recv, verb,
                    f"{recv}.{node.func.attr}()", node.lineno, id(node)))
                rid += 1
        # refcount pin: ent.refcount += 1
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Attribute) \
                and node.target.attr in rules.RESOURCE_REFCOUNT_ATTRS \
                and isinstance(node.op, ast.Add):
            recv = dotted(node.target.value)
            if recv is not None and releases_somewhere(recv, "refdec"):
                out.append(Resource(
                    rid, "ref", None if recv.startswith("self.")
                    else recv.split(".")[0], recv, "refdec",
                    f"{recv}.refcount += 1", node.lineno, id(node)))
                rid += 1
    return out


class _FnAnalysis:
    def __init__(self, graph: CallGraph, info: FunctionInfo,
                 resources: List[Resource],
                 summaries: Dict[str, Set[Tuple[str, str]]]):
        self.graph = graph
        self.info = info
        self.resources = resources
        self.summaries = summaries
        self.by_node: Dict[int, Resource] = {
            r.node_id: r for r in resources}
        self.by_name: Dict[str, List[Resource]] = {}
        for r in resources:
            if r.name is not None:
                self.by_name.setdefault(r.name, []).append(r)

    # ---------------------------------------------- per-stmt classifiers

    def _released_in(self, stmt: ast.stmt, state: State) -> Set[int]:
        out: Set[int] = set()
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                verb, recv_node = node.func.attr, node.func.value
                recv_d = dotted(recv_node)
                for r in self.resources:
                    if r.rid not in state:
                        continue
                    if r.kind == "ctor" and verb == r.release_verb \
                            and isinstance(recv_node, ast.Name) \
                            and recv_node.id == r.name:
                        out.add(r.rid)
                    elif r.kind == "pair" and verb == r.release_verb \
                            and recv_d == r.recv_key:
                        out.add(r.rid)
                    elif r.kind == "pool" and verb == r.release_verb \
                            and recv_d == r.recv_key \
                            and any(isinstance(sub, ast.Name)
                                    and sub.id == r.name
                                    for a in node.args
                                    for sub in ast.walk(a)):
                        # the leased value anywhere in an argument
                        # expression counts: the page-allocator idiom
                        # frees collections (``free(shared + fresh)``),
                        # not just the bare local
                        out.add(r.rid)
                    elif r.kind == "lease" \
                            and _lease_rpc_name(node) == r.release_verb:
                        # any client object discharges a lease: the
                        # reservation id, not the receiver, keys it
                        out.add(r.rid)
                    elif r.kind == "ckpt" and verb == r.release_verb \
                            and recv_d == "self":
                        # ``self._save_state()``: obligation discharged
                        out.add(r.rid)
                # release-through-self-call (``self._drop(st)``)
                callee, _vs = self.graph.resolve_call_cached(
                    node, self.info)
                if callee is not None:
                    rel = self.summaries.get(callee, ())
                    for r in self.resources:
                        if r.rid in state \
                                and r.kind in ("pair", "ref", "lease",
                                               "ckpt") \
                                and r.recv_key is not None \
                                and r.recv_key.startswith(("self.",
                                                           "rpc:",
                                                           "ckpt:")) \
                                and (r.recv_key, r.release_verb) in rel:
                            out.add(r.rid)
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Attribute) \
                    and node.target.attr in rules.RESOURCE_REFCOUNT_ATTRS \
                    and isinstance(node.op, ast.Sub):
                recv_d = dotted(node.target.value)
                for r in self.resources:
                    if r.rid in state and r.kind == "ref" \
                            and recv_d == r.recv_key:
                        out.add(r.rid)
        return out

    def _transferred_in(self, stmt: ast.stmt, state: State) -> Set[int]:
        """Ownership transfers: the resource local stored via an
        assignment value, returned, yielded, or raised."""
        exprs: List[ast.AST] = []
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if stmt.value is not None:
                exprs.append(stmt.value)
        elif isinstance(stmt, ast.Return) and stmt.value is not None:
            exprs.append(stmt.value)
        elif isinstance(stmt, ast.Raise) and stmt.exc is not None:
            exprs.append(stmt.exc)
        elif isinstance(stmt, ast.Expr) \
                and isinstance(stmt.value, (ast.Yield, ast.YieldFrom)):
            exprs.append(stmt.value)
        out: Set[int] = set()
        for expr in exprs:
            for node in ast.walk(expr):
                if isinstance(node, ast.Name):
                    for r in self.by_name.get(node.id, ()):
                        if r.rid in state:
                            out.add(r.rid)
                elif isinstance(node, ast.Attribute):
                    d = dotted(node)
                    for r in self.resources:
                        if r.rid in state and r.recv_key is not None \
                                and d == r.recv_key:
                            out.add(r.rid)
        # Lease handoff: the lease local passed as a BARE argument to
        # any call transfers ownership (``ReplicaRecord(h, rid, sub)``
        # — the record now owns the reservation); a nested read
        # (``f(sub["chips"])``) stays a borrow.
        lease_names = {r.name: r for r in self.resources
                       if r.kind == "lease" and r.name is not None}
        if lease_names:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                args = list(node.args) + [kw.value
                                          for kw in node.keywords]
                for a in args:
                    if isinstance(a, ast.Name) and a.id in lease_names:
                        r = lease_names[a.id]
                        if r.rid in state:
                            out.add(r.rid)
        return out

    def _acquired_in(self, stmt: ast.stmt) -> Set[int]:
        out: Set[int] = set()
        for node in ast.walk(stmt):
            r = self.by_node.get(id(node))
            if r is not None:
                out.add(r.rid)
        return out

    @staticmethod
    def _may_raise(stmt: ast.stmt) -> bool:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Call, ast.Subscript, ast.BinOp,
                                 ast.Raise, ast.Assert)):
                return True
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load):
                # attribute LOADS can raise (missing attr); a plain
                # store target (``self.sock = sock``) cannot, short of
                # a property — treating it as raising would turn every
                # ownership-transferring assignment into a leak edge
                return True
        return False

    # ------------------------------------------------------ interpreter

    def run(self) -> Outcomes:
        # Checkpoint obligations are live from the first statement; all
        # other resources enter the state at their acquire site.
        entry = frozenset(r.rid for r in self.resources
                          if r.kind == "ckpt")
        return self._block(list(self.info.node.body), entry)

    def _block(self, stmts: List[ast.stmt], state: State) -> Outcomes:
        out: Outcomes = {k: set() for k in _EXITS}
        for stmt in stmts:
            res = self._stmt(stmt, state)
            for kind in ("return", "raise", "break", "continue"):
                out[kind] |= res[kind]
            falls = res["fall"]
            if not falls:
                return out  # unreachable continuation
            # merge fall states (sets of live-resource sets)
            state = frozenset().union(*[s for s, _ in falls]) \
                if len(falls) > 1 else next(iter(falls))[0]
            # keep path distinction cheap: union over-approximates
            # "live on some path", which is what leak detection needs
        out["fall"].add((state, stmts[-1].lineno if stmts else 0))
        return out

    def _stmt(self, stmt: ast.stmt, state: State) -> Outcomes:
        out: Outcomes = {k: set() for k in _EXITS}
        line = stmt.lineno

        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out["fall"].add((state, line))
            return out

        if isinstance(stmt, ast.If):
            if self._may_raise_expr(stmt.test):
                out["raise"].add((state, line))
            # ``if x is None:`` / ``if x is not None:`` — the branch in
            # which x is None cannot hold the resource bound to x (the
            # failed-acquire guard idiom: ``sub = reserve(); if sub is
            # None: return False``), so prune it there.
            none_name, when_none = self._none_test(stmt.test)
            branch_states = [state, state]
            if none_name is not None:
                dead = frozenset(r.rid for r in self.resources
                                 if r.name == none_name)
                branch_states[0 if when_none else 1] = state - dead
            for branch, bstate in zip((stmt.body, stmt.orelse),
                                      branch_states):
                res = self._block(branch, bstate) if branch else \
                    {k: (set() if k != "fall" else {(bstate, line)})
                     for k in _EXITS}
                for k in _EXITS:
                    out[k] |= res[k]
            return out

        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            test = stmt.test if isinstance(stmt, ast.While) else stmt.iter
            if self._may_raise_expr(test):
                out["raise"].add((state, line))
            body = self._block(stmt.body, state)
            # zero iterations: fall with entry state; >=1: body outcomes
            out["return"] |= body["return"]
            out["raise"] |= body["raise"]
            # A receiver-keyed registration that survives a whole loop
            # iteration is settled object state (the reactor accept loop
            # registering conn after conn), not a leak-in-flight: scope
            # it to the iteration. Mid-iteration raises (the PR-1 bug
            # class) were already recorded above with it live.
            iter_pairs = frozenset(
                r.rid for r in self.resources
                if r.kind == "pair" and any(
                    id(n) == r.node_id for n in ast.walk(stmt)))
            falls = {(state, line)}
            falls |= {(s - iter_pairs, ln) for s, ln in body["fall"]}
            falls |= {(s - iter_pairs, ln) for s, ln in body["break"]}
            falls |= {(s - iter_pairs, ln) for s, ln in body["continue"]}
            if stmt.orelse:
                merged: Set[Tuple[State, int]] = set()
                for s, _ln in falls:
                    res = self._block(stmt.orelse, s)
                    for k in ("return", "raise", "break", "continue"):
                        out[k] |= res[k]
                    merged |= res["fall"]
                falls = merged
            out["fall"] |= falls
            return out

        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            if any(self._may_raise_expr(i.context_expr)
                   for i in stmt.items):
                out["raise"].add((state, line))
            res = self._block(stmt.body, state)
            for k in _EXITS:
                out[k] |= res[k]
            return out

        if isinstance(stmt, ast.Try):
            body = self._block(stmt.body, state)
            out["return"] |= body["return"]
            out["break"] |= body["break"]
            out["continue"] |= body["continue"]
            falls = set(body["fall"])
            raises = set(body["raise"])
            for h in stmt.handlers:
                for s, _ln in raises or {(state, line)}:
                    res = self._block(h.body, s)
                    for k in ("return", "break", "continue"):
                        out[k] |= res[k]
                    falls |= res["fall"]
                    out["raise"] |= res["raise"]
            # Handlers are assumed to catch (optimistic): a handler that
            # neither releases nor re-raises still leaves the resource
            # live in its fall state, so the leak is reported at the
            # function's real exits instead of at a hypothetical
            # uncaught-exception edge. Pure try/finally keeps the edge.
            if not stmt.handlers:
                out["raise"] |= raises
            if stmt.orelse:
                merged: Set[Tuple[State, int]] = set()
                for s, _ln in set(body["fall"]) or {(state, line)}:
                    res = self._block(stmt.orelse, s)
                    for k in ("return", "raise", "break", "continue"):
                        out[k] |= res[k]
                    merged |= res["fall"]
                falls = (falls - set(body["fall"])) | merged
            if stmt.finalbody:
                kills = self._finally_kills(stmt.finalbody)
                fres = self._block(stmt.finalbody,
                                   frozenset().union(
                                       *[s for s, _ in falls])
                                   if falls else state)
                out["raise"] |= fres["raise"]
                out["return"] |= fres["return"]

                def k(pairs):
                    return {(s - kills, ln) for s, ln in pairs}
                for kind in _EXITS:
                    out[kind] = k(out[kind])
                falls = k(falls)
            out["fall"] |= falls
            return out

        if isinstance(stmt, ast.Return):
            # transfer BEFORE the raise edge: ``return Wrap(res)`` whose
            # constructor raises is assumed to have taken the resource,
            # same optimism as the assignment form below
            s = state - self._transferred_in(stmt, state)
            if stmt.value is not None and self._may_raise_expr(stmt.value):
                out["raise"].add((s, line))
            out["return"].add((s, line))
            return out

        if isinstance(stmt, ast.Raise):
            s = state - self._transferred_in(stmt, state)
            out["raise"].add((s, line))
            return out

        if isinstance(stmt, ast.Break):
            out["break"].add((state, line))
            return out

        if isinstance(stmt, ast.Continue):
            out["continue"].add((state, line))
            return out

        # simple statement: releases AND transfers happen "before" the
        # raise edge (a close() that itself raises has still torn the
        # resource down; a wrapping constructor that raises is assumed
        # to have taken the resource — optimistic, but the noisy
        # alternative flags every ``st = _Conn(sock)``). Acquires land
        # only on the fall edge: an acquire that raises acquired
        # nothing.
        s = state - self._released_in(stmt, state)
        s = s - self._transferred_in(stmt, s)
        if self._may_raise(stmt):
            out["raise"].add((s, line))
        s = s | self._acquired_in(stmt)
        out["fall"].add((s, line))
        return out

    def _finally_kills(self, finalbody: List[ast.stmt]) -> Set[int]:
        all_ids: State = frozenset(r.rid for r in self.resources)
        kills: Set[int] = set()
        for stmt in finalbody:
            kills |= self._released_in(stmt, all_ids)
            kills |= self._transferred_in(stmt, all_ids)
            # ``for f in (stdout, stderr): f.close()`` — a loop variable
            # ranging over resource locals releases each of them.
            for node in ast.walk(stmt):
                if not (isinstance(node, ast.For)
                        and isinstance(node.target, ast.Name)
                        and isinstance(node.iter, (ast.Tuple, ast.List))):
                    continue
                names = {el.id for el in node.iter.elts
                         if isinstance(el, ast.Name)}
                verbs = {sub.func.attr for sub in ast.walk(node)
                         if isinstance(sub, ast.Call)
                         and isinstance(sub.func, ast.Attribute)
                         and isinstance(sub.func.value, ast.Name)
                         and sub.func.value.id == node.target.id}
                for r in self.resources:
                    if r.name in names and r.release_verb in verbs:
                        kills.add(r.rid)
        return kills

    @staticmethod
    def _none_test(test: ast.AST) -> Tuple[Optional[str], bool]:
        """-> (name, True) for ``name is None``, (name, False) for
        ``name is not None``, else (None, False)."""
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.left, ast.Name) \
                and len(test.comparators) == 1 \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            if isinstance(test.ops[0], ast.Is):
                return test.left.id, True
            if isinstance(test.ops[0], ast.IsNot):
                return test.left.id, False
        return None, False

    def _may_raise_expr(self, expr: Optional[ast.AST]) -> bool:
        if expr is None:
            return False
        for node in ast.walk(expr):
            if isinstance(node, (ast.Call, ast.Subscript, ast.BinOp,
                                 ast.Attribute)):
                return True
        return False


def _candidate_fqns(graph: CallGraph) -> Set[str]:
    """Functions that can possibly acquire a tracked resource, from the
    calls-by-tail side index — every other function is skipped whole."""
    cands: Set[str] = set()
    ctor_tails = {d.split(".")[-1] for d in rules.RESOURCE_CTOR_DOTTED}
    for tail in ctor_tails | set(rules.RESOURCE_METHOD_PAIRS):
        for _node, info in graph.calls_by_tail.get(tail, ()):
            cands.add(info.fqn)
    for pool_attr, (acq_verb, _rel) in rules.RESOURCE_POOL_ATTRS.items():
        for node, info in graph.calls_by_tail.get(acq_verb, ()):
            if isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Attribute) \
                    and node.func.value.attr == pool_attr:
                cands.add(info.fqn)
    for node, info in graph.attr_augassigns:
        if node.target.attr in rules.RESOURCE_REFCOUNT_ATTRS \
                and isinstance(node.op, ast.Add):
            cands.add(info.fqn)
    for tail in tuple(rules.RPC_LEASE_VERBS) + tuple(
            rules.RPC_LEASE_PAIRS):
        for node, info in graph.calls_by_tail.get(tail, ()):
            if _lease_rpc_name(node) in rules.RPC_LEASE_PAIRS:
                cands.add(info.fqn)
    for info in graph.functions.values():
        if _ckpt_entry(info) is not None:
            cands.add(info.fqn)
    return cands


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    summaries = _release_summaries(graph)
    findings: List[Finding] = []
    for fqn in sorted(_candidate_fqns(graph)):
        info = graph.functions[fqn]
        if emit_files is not None \
                and info.file.relpath not in emit_files:
            continue  # per-function analysis; summaries stay global
        if any(isinstance(n, (ast.Yield, ast.YieldFrom))
               for n in _walk_no_nested(info.node)):
            continue  # generators suspend: path exits are meaningless
        resources = _collect_resources(graph, info, summaries)
        if not resources:
            continue
        analysis = _FnAnalysis(graph, info, resources, summaries)
        outcomes = analysis.run()
        by_rid = {r.rid: r for r in resources}
        leaks: Dict[int, Tuple[str, int]] = {}
        for kind in ("fall", "return", "raise"):
            for s, ln in outcomes[kind]:
                for rid in s:
                    # receiver-keyed registrations (and topology leases)
                    # live at a NORMAL exit are the design (a long-lived
                    # registration / record-owned reservation); only an
                    # exception escaping between acquire and release is
                    # a leak for those.
                    if by_rid[rid].kind in ("pair", "lease") \
                            and kind != "raise":
                        continue
                    # checkpoint obligations are the INVERSE: normal
                    # exits must have saved; an escaping exception is
                    # exempt (the handler failed — there may be nothing
                    # durable to record).
                    if by_rid[rid].kind == "ckpt" and kind == "raise":
                        continue
                    prev = leaks.get(rid)
                    if prev is None or ln < prev[1]:
                        label = {"fall": "fall-through",
                                 "return": "return",
                                 "raise": "escaping exception"}[kind]
                        leaks[rid] = (label, ln)
        for r in resources:
            hit = leaks.get(r.rid)
            if hit is None:
                continue
            kind_label, ln = hit
            if r.kind == "ckpt":
                findings.append(Finding(
                    rule=rules.CHECKPOINT_MISSING,
                    path=info.file.relpath, line=r.line,
                    symbol=info.qualname,
                    message=f"{r.label}: this state-mutating handler "
                            f"can exit via {kind_label} (line {ln}) "
                            f"without reaching {r.release_verb}() — "
                            f"the mutation is invisible to a restarted "
                            f"controller (it would replay the previous "
                            f"checkpoint)"))
                continue
            findings.append(Finding(
                rule=rules.RESOURCE_LEAK, path=info.file.relpath,
                line=r.line, symbol=info.qualname,
                message=f"{r.label} acquired here is still live when "
                        f"the function exits via {kind_label} "
                        f"(line {ln}) — release it "
                        f"({r.release_verb}) in a finally, or transfer "
                        f"ownership"))
    return findings


def sites(graph: CallGraph) -> int:
    """Functions that acquire a tracked resource, plus the handlers of
    the checkpointed classes."""
    graph.edges()
    n = len(_candidate_fqns(graph))
    for cls, (_save, handlers) in rules.CHECKPOINT_CLASSES.items():
        n += sum(1 for info in graph.functions.values()
                 if info.cls == cls
                 and info.qualname.rsplit(".", 1)[-1] in handlers)
    return n
