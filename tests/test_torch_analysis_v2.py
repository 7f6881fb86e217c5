"""graftlint v2 tests: guarded-by inference, resource lifetime, RPC
contract, and the callgraph fidelity upgrades they ride on.

Same layering as tests/test_analysis.py:

1. Per-rule TP/TN fixtures — synthetic modules fed straight to the
   checkers (no jax, no cluster, no sockets).
2. Callgraph fidelity fixtures: bound-method aliasing, decorated
   functions, functools.partial targets, self-attribute typing.
3. CLI plumbing: --jobs, --diff, --stats-json.
4. Per-family repo-stays-clean gates (the broad gate lives in
   test_analysis.py; these pin each NEW family individually so a
   regression names the family that rotted).
"""

import json
import subprocess
import sys
import textwrap
import time

import pytest

from ray_tpu_torch.analysis import repo_root, run_analysis
from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis import guarded_by, lifetime, rpc_contract
from ray_tpu_torch.analysis.callgraph import CallGraph
from ray_tpu_torch.analysis.core import Project, SourceFile


def project_of(**modules) -> Project:
    files = []
    for name, src in modules.items():
        rel = f"ray_tpu_torch/{name}.py"
        files.append(SourceFile(f"/fixture/{rel}", rel,
                                textwrap.dedent(src)))
    return Project("/fixture", files)


def run_checker(check, project):
    graph = CallGraph(project)
    findings = check(graph)
    by_rel = {f.relpath: f for f in project.files}
    return [f for f in findings
            if not by_rel[f.path].suppressed(f.rule, f.line)]


# ---------------------------------------------------- guarded-by inference

GUARDED_TP = """
    import threading

    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0
            self._stop = False

        def start(self):
            self._t = threading.Thread(target=self._loop, daemon=True)
            self._t.start()

        def _loop(self):
            while True:
                with self._lock:
                    self._n += 1

        def snapshot(self):
            with self._lock:
                return self._n

        def racy_reset(self):
            self._n = 0
"""


def test_guarded_by_flags_unguarded_write():
    found = run_checker(guarded_by.check, project_of(mod=GUARDED_TP))
    assert [f.rule for f in found] == [rules.UNGUARDED_FIELD]
    f = found[0]
    assert f.symbol == "Counter.racy_reset"
    assert "_n" in f.message and "_lock" in f.message
    # the message names where the concurrency comes from
    assert "thread:" in f.message or "caller" in f.message


def test_guarded_by_majority_and_init_exemption():
    # 2 locked sites vs 1 unlocked -> guarded; __init__ writes exempt.
    found = run_checker(guarded_by.check, project_of(mod=GUARDED_TP))
    assert all(f.symbol != "Counter.__init__" for f in found)


GUARDED_TIE = """
    import threading

    class Tie:
        def __init__(self):
            self._lock = threading.Lock()
            self._x = 0

        def start(self):
            threading.Thread(target=self._loop).start()

        def _loop(self):
            with self._lock:
                self._x += 1

        def unlocked_bump(self):
            self._x += 1
"""


def test_guarded_by_exact_tie_infers_nothing():
    # 1 locked site vs 1 unlocked: no strict majority -> no findings
    # (and the locked-site minimum of 2 is not met either).
    found = run_checker(guarded_by.check, project_of(mod=GUARDED_TIE))
    assert found == []


GUARDED_SINGLE_THREAD = """
    import threading

    class NoThreads:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

        def locked_a(self):
            with self._lock:
                self._n += 1

        def locked_b(self):
            with self._lock:
                self._n -= 1

        def unlocked(self):
            self._n = 0
"""


def test_guarded_by_requires_thread_reachability():
    # Same inconsistent locking, but no thread entry points anywhere:
    # nothing is concurrent, nothing is flagged.
    found = run_checker(guarded_by.check,
                        project_of(mod=GUARDED_SINGLE_THREAD))
    assert found == []


def test_guarded_by_immutable_field_skipped():
    src = """
        import threading

        class ReadMostly:
            def __init__(self):
                self._lock = threading.Lock()
                self._cfg = {"a": 1}

            def start(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                with self._lock:
                    use(self._cfg)
                with self._lock:
                    use2(self._cfg)

            def read_unlocked(self):
                return self._cfg
    """
    # _cfg is never written outside __init__ -> effectively immutable
    found = run_checker(guarded_by.check, project_of(mod=src))
    assert found == []


def test_guarded_by_locked_suffix_convention_exempt():
    src = """
        import threading

        class Conv:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = 0

            def start(self):
                threading.Thread(target=self._loop).start()

            def _loop(self):
                with self._lock:
                    self._q += 1
                with self._lock:
                    self._q += 2
                with self._lock:
                    self._flush_locked()

            def _flush_locked(self):
                self._q = 0
    """
    found = run_checker(guarded_by.check, project_of(mod=src))
    assert found == []


def test_guarded_by_rpc_handlers_are_pool_concurrent():
    src = """
        import threading

        class Server:
            def __init__(self):
                self._lock = threading.Lock()
                self._hits = 0
                self._srv = RpcServer(handlers={"bump": self.bump,
                                                "peek": self.peek})

            def bump(self):
                with self._lock:
                    self._hits += 1
                with self._lock:
                    self._hits += 1

            def peek(self):
                return self._hits

        class RpcServer:
            def __init__(self, handlers):
                self.handlers = handlers
    """
    found = run_checker(guarded_by.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["Server.peek"]
    assert "rpc:" in found[0].message


# -------------------------------------------------- resource lifetime

def test_lifetime_socket_leak_on_exception_path():
    src = """
        import socket

        def leaky(addr):
            sock = socket.socket()
            handshake(sock, addr)
            sock.close()

        def protected(addr):
            sock = socket.socket()
            try:
                handshake(sock, addr)
            finally:
                sock.close()

        def with_ok(addr):
            with socket.socket() as sock:
                handshake(sock, addr)
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["leaky"]
    assert found[0].rule == rules.RESOURCE_LEAK
    assert "escaping exception" in found[0].message


def test_lifetime_early_return_leak():
    src = """
        import socket

        def early_return(addr):
            sock = socket.socket()
            if bad(addr):
                return None
            sock.close()
            return True
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert len(found) == 1 and found[0].symbol == "early_return"


def test_lifetime_ownership_transfers():
    src = """
        import socket

        def returned(addr):
            sock = socket.socket()
            return sock

        def stored(self, addr):
            sock = socket.socket()
            self.sock = sock

        def wrapped(addr):
            sock = socket.socket()
            conn = Conn(sock)
            register(conn)

        class Conn:
            def __init__(self, sock):
                self.sock = sock
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    # return / attribute store / constructor wrap all transfer ownership
    assert found == [], [f.render() for f in found]


def test_lifetime_setup_call_between_acquire_and_return_leaks():
    """The _connect bug class: post-connect setup raising between the
    acquire and the ownership-transferring return orphans the fd."""
    src = """
        import socket

        def dial(addr):
            sock = socket.socket()
            sock.connect(addr)
            return sock
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["dial"]
    assert "escaping exception" in found[0].message


def test_lifetime_close_in_typed_handler_ok():
    src = """
        import socket

        def dial(addr):
            sock = socket.socket()
            try:
                sock.connect(addr)
                return sock
            except OSError:
                sock.close()
                raise
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert found == [], [f.render() for f in found]


def test_lifetime_handler_without_release_still_leaks():
    src = """
        import socket

        def swallow_and_leak(addr):
            sock = socket.socket()
            try:
                sock.connect(addr)
            except OSError:
                log("boom")
            return None
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["swallow_and_leak"]


def test_lifetime_selector_register_pair_and_drop_helper():
    src = """
        class Reactor:
            def risky(self, sock, st):
                self._selector.register(sock, 1, st)
                arm(st)
                self._selector.unregister(sock)

            def via_drop(self, sock, st):
                self._selector.register(sock, 1, st)
                arm(st)
                self._drop(st)

            def _drop(self, st):
                self._selector.unregister(st.sock)
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    # both paths leak only if arm() raises: register/unregister pairing
    # with the release OUTSIDE a finally -> exception-path finding; the
    # _drop release resolves through the call graph, so via_drop pairs
    # exactly like the direct unregister
    assert sorted(f.symbol for f in found) == ["Reactor.risky",
                                               "Reactor.via_drop"]
    assert all("escaping exception" in f.message for f in found)


def test_lifetime_register_without_any_release_is_ownership():
    src = """
        class Server:
            def __init__(self, sock):
                self._selector.register(sock, 1, None)
                self.more_setup()
    """
    # never unregisters anywhere: the registration IS the object state
    found = run_checker(lifetime.check, project_of(mod=src))
    assert found == []


def test_lifetime_loop_scoped_registration_not_leaked_across_iters():
    src = """
        class Acceptor:
            def accept_loop(self):
                while True:
                    sock = self.sock_accept()
                    self._selector.register(sock, 1, None)
                    self.might_raise()
                    self._maybe_drop(sock)

            def _maybe_drop(self, sock):
                self._selector.unregister(sock)
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    # might_raise() mid-iteration with the registration live IS a leak
    assert [f.symbol for f in found] == ["Acceptor.accept_loop"]

    src_ok = """
        class Acceptor:
            def accept_loop(self):
                while True:
                    sock = self.sock_accept()
                    try:
                        self._selector.register(sock, 1, None)
                    except OSError:
                        self._drop(sock)
                    # iteration completes: the registration is settled
                    # object state, not a leak in flight

            def _drop(self, sock):
                self._selector.unregister(sock)
    """
    found = run_checker(lifetime.check, project_of(mod=src_ok))
    assert found == [], [f.render() for f in found]


def test_lifetime_slot_pool_and_refcount_pairs():
    src = """
        class Engine:
            def leaky_slot(self):
                slot = self._free.pop()
                self.prefill(slot)
                self._free.append(slot)

            def safe_slot(self):
                slot = self._free.pop()
                try:
                    self.prefill(slot)
                finally:
                    self._free.append(slot)

        class Cache:
            def leaky_pin(self, ent):
                ent.refcount += 1
                self.splice(ent)
                ent.refcount -= 1
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert sorted(f.symbol for f in found) == ["Cache.leaky_pin",
                                               "Engine.leaky_slot"]


def test_lifetime_page_allocator_leaks():
    """The paged-KV allocator idiom (serve/paging.py): pages leased with
    ``self._pages.alloc(n)`` must be freed or ownership-transferred on
    every path — a block leak on a cancel/deadline/retire path pins HBM
    forever."""
    src = """
        class Engine:
            def leaky_admit(self, req):
                pages = self._pages.alloc(4)
                self.prefill(req, pages)      # raises -> pages stranded
                self._pages.free(pages)

            def early_return_leak(self, req):
                pages = self._pages.alloc(4)
                if req.cancelled:
                    return None               # retire path drops pages
                self._pages.free(pages)
                return True
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert sorted(f.symbol for f in found) == ["Engine.early_return_leak",
                                               "Engine.leaky_admit"]
    assert all(f.rule == rules.RESOURCE_LEAK for f in found)


def test_lifetime_page_allocator_clean_idioms():
    """Release-in-finally, ownership transfer into engine state, and
    freeing a collection CONTAINING the lease (``free(shared + fresh)``)
    all discharge the page lease."""
    src = """
        class Engine:
            def finally_frees(self, req):
                pages = self._pages.alloc(4)
                try:
                    self.prefill(req, pages)
                finally:
                    self._pages.free(pages)

            def transfers(self, slot):
                pages = self._pages.alloc(4)
                self._slot_pages[slot] = pages

            def frees_collection(self, shared):
                pages = self._pages.alloc(4)
                self._pages.free(shared + pages)
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert found == [], [f.render() for f in found]


def test_lifetime_page_incref_pair():
    """allocator.incref/decref is a method pair: an escaping exception
    between pin and unpin leaks the reference."""
    src = """
        class Index:
            def leaky_pin(self, alloc, page):
                alloc.incref(page)
                self.splice(page)
                alloc.decref(page)
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["Index.leaky_pin"]


def test_lifetime_finally_loop_release_recognized():
    src = """
        def fork(a_path, b_path):
            a = b = None
            try:
                a = open(a_path, "ab")
                b = open(b_path, "ab")
                spawn(a, b)
            finally:
                for f in (a, b):
                    if f is not None:
                        f.close()
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert found == [], [f.render() for f in found]


def test_lifetime_generators_skipped():
    src = """
        import socket

        def gen(addr):
            sock = socket.socket()
            yield sock.recv(1)
            sock.close()
    """
    found = run_checker(lifetime.check, project_of(mod=src))
    assert found == []


# ----------------------------------------------------- RPC contract

RPC_BASE = """
    class Server:
        def __init__(self):
            self._srv = RpcServer(handlers={
                "echo": self.echo,
                "sum2": self.sum2,
                "varargs": self.varargs,
                "never_called": self.echo,
            }, inline_methods={"echo", "ghost"})
            self._srv.register("late", self.late)

        def echo(self, x):
            return x

        def sum2(self, a, b, scale=1):
            return (a + b) * scale

        def varargs(self, *args, **kwargs):
            return args

        def late(self):
            return None

    class RpcServer:
        def __init__(self, handlers, inline_methods=()):
            self.handlers = handlers

        def register(self, name, fn):
            self.handlers[name] = fn

    def caller(client):
        client.call("echo", 1)
        client.call("sum2", 1, 2, timeout=5.0)
        client.call("sum2", 1, 2, scale=3)
        client.call("varargs", 1, 2, 3, 4, anything="x")
        client.notify("late")
"""


def test_rpc_contract_clean_base():
    found = run_checker(rpc_contract.check, project_of(mod=RPC_BASE))
    by_rule = {}
    for f in found:
        by_rule.setdefault(f.rule, []).append(f)
    # "never_called" is dead; "ghost" inline entry names no handler
    assert [f.message.split('"')[1] for f in
            by_rule.get(rules.RPC_DEAD, [])] == ["never_called"]
    assert len(by_rule.get(rules.RPC_UNKNOWN, [])) == 1
    assert "ghost" in by_rule[rules.RPC_UNKNOWN][0].message
    assert rules.RPC_ARITY not in by_rule


def test_rpc_contract_unknown_and_arity():
    src = RPC_BASE + """
    def bad_callers(client):
        client.call("no_such_method")
        client.call("echo", 1, 2)
        client.call("sum2", 1)
        client.call("sum2", 1, 2, wrong_kw=4)
    """
    found = run_checker(rpc_contract.check, project_of(mod=src))
    msgs = {f.line: f for f in found}
    unknown = [f for f in found if f.rule == rules.RPC_UNKNOWN
               and "no_such_method" in f.message]
    assert len(unknown) == 1
    arity = [f for f in found if f.rule == rules.RPC_ARITY]
    labels = sorted(f.message.split('"')[1] for f in arity)
    # echo rejects 2 args; sum2 rejects 1 arg and the unknown keyword
    assert labels == ["echo", "sum2", "sum2"]


def test_rpc_contract_dynamic_name_and_splat_unchecked():
    src = RPC_BASE + """
    def dynamic(client, method, args):
        client.call(method, 1, 2, 3)
        client.call("varargs", *args)
    """
    found = run_checker(rpc_contract.check, project_of(mod=src))
    assert not any(f.rule == rules.RPC_ARITY for f in found)


def test_rpc_contract_timeout_kwarg_is_client_side():
    found = run_checker(rpc_contract.check, project_of(mod=RPC_BASE))
    # call("sum2", 1, 2, timeout=5.0) must NOT be an arity finding:
    # timeout is consumed by the transport
    assert not any(f.rule == rules.RPC_ARITY and "timeout" in f.message
                   for f in found)


# ------------------------------------------------- callgraph fidelity

def test_callgraph_bound_method_alias_resolves():
    src = """
        import time

        class C:
            def _on_readable(self):
                f = self._drain
                f()

            def _drain(self):
                time.sleep(1.0)
    """
    from ray_tpu_torch.analysis import reactor_safety

    found = run_checker(reactor_safety.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["C._drain"]
    assert "_on_readable" in found[0].message


def test_callgraph_partial_thread_target_resolves():
    src = """
        import functools
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def start(self):
                t = threading.Thread(
                    target=functools.partial(self._loop, 3))
                t.start()

            def _loop(self, k):
                with self._lock:
                    self._n += k
                with self._lock:
                    self._n -= k

            def racy(self):
                self._n = 0
    """
    found = run_checker(guarded_by.check, project_of(mod=src))
    # the thread entry is only discoverable through the partial
    assert [f.symbol for f in found] == ["C.racy"]


def test_callgraph_decorated_functions_still_resolve():
    src = """
        import time

        def deco(fn):
            return fn

        class C:
            def _on_readable(self):
                self._helper()

            @deco
            def _helper(self):
                time.sleep(1.0)
    """
    from ray_tpu_torch.analysis import reactor_safety

    found = run_checker(reactor_safety.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["C._helper"]


def test_callgraph_self_attr_type_resolution():
    project = project_of(
        pub="""
            class Hub:
                def poll(self, key, cursor):
                    return cursor
        """,
        srv="""
            from ray_tpu_torch.pub import Hub

            class S:
                def __init__(self):
                    self.hub = Hub()

                def go(self):
                    return self.hub.poll("k", 0)
        """)
    graph = CallGraph(project)
    info = graph.functions["ray_tpu_torch.srv:S.go"]
    import ast as _ast

    call = next(n for n in _ast.walk(info.node)
                if isinstance(n, _ast.Call))
    callee, via_self = graph.resolve_call(call, info)
    assert callee == "ray_tpu_torch.pub:Hub.poll"
    assert via_self is False  # different object: not self-chain evidence


# ------------------------------------------------------- CLI plumbing

@pytest.mark.slow  # 18s: two full repo runs; serial CLI runs stay in
# tier-1
def test_cli_jobs_parallel_matches_serial():
    serial, _ = run_analysis(jobs=1)
    parallel, _ = run_analysis(jobs=4)
    assert [f.to_json() for f in serial] == [f.to_json() for f in parallel]


@pytest.mark.slow  # 7s: full-repo diff run; diff-mode coverage stays
# via v3's diff_mode_covers_new_families + diff_one_file_stays_fast
def test_cli_diff_mode(tmp_path, capsys):
    from ray_tpu_torch.analysis.__main__ import main

    # vs HEAD with a committed tree the diff may be empty or not; both
    # exits are clean because the repo is clean under strict
    rc = main(["--strict", "--diff", "HEAD"])
    assert rc == 0
    capsys.readouterr()
    # a ref that cannot be resolved is a usage error
    rc = main(["--strict", "--diff", "definitely-not-a-ref"])
    assert rc == 2


@pytest.mark.slow  # 7s: full-repo stats run
def test_cli_stats_json_artifact(tmp_path, capsys):
    from ray_tpu_torch.analysis.__main__ import main

    out = tmp_path / "stats.json"
    assert main(["--stats-json", str(out)]) == 0
    capsys.readouterr()
    data = json.loads(out.read_text())
    assert set(data["rules"]) == set(rules.ALL_RULES)
    for rule, row in data["rules"].items():
        assert set(row) == {"raw", "pragma_suppressed",
                            "reported_unbaselined", "baselined"}
    # v2 rules ran over the repo
    assert data["files"] > 100
    assert data["rules"][rules.RESOURCE_LEAK]["raw"] >= 0


# --------------------------------------- per-family repo-clean gates

def _clean_under(select, paths=None):
    findings, _ = run_analysis(select=select, paths=paths)
    from ray_tpu_torch.analysis import Baseline, DEFAULT_BASELINE

    baseline = Baseline.load(DEFAULT_BASELINE)
    new, _baselined, _stale = baseline.split(findings)
    return new


def test_repo_clean_guarded_by():
    new = _clean_under([rules.UNGUARDED_FIELD])
    assert new == [], "\n".join(f.render() for f in new)


def test_repo_clean_lifetime():
    new = _clean_under([rules.RESOURCE_LEAK])
    assert new == [], "\n".join(f.render() for f in new)


def test_repo_clean_rpc_contract():
    new = _clean_under([rules.RPC_UNKNOWN, rules.RPC_ARITY,
                        rules.RPC_DEAD])
    assert new == [], "\n".join(f.render() for f in new)


def test_rpc_registrations_actually_collected():
    """Guards the collector itself: if registration parsing silently
    broke, the dead-endpoint rule would go quiet instead of loud."""
    project = Project.load(repo_root())
    graph = CallGraph(project)
    regs, inline, handler_fqns = rpc_contract.collect_registrations(graph)
    names = {r.name for r in regs}
    # the four known servers' marquee endpoints
    assert {"heartbeat", "get_object", "lease_worker",
            "client_connect"} <= names
    assert len(regs) >= 60
    assert "heartbeat" in {n for n, *_ in inline}
    assert handler_fqns["heartbeat"].endswith("Controller.heartbeat")


def test_guarded_by_thread_entries_found_in_repo():
    project = Project.load(repo_root())
    graph = CallGraph(project)
    entries, self_concurrent = guarded_by.thread_entries(graph)
    # reactor + caller + a healthy population of real thread/pool/rpc
    # entries (55+ Thread()/submit() sites package-wide)
    assert "reactor" in entries and "caller" in entries
    assert sum(1 for k in entries if k.startswith("thread:")) >= 10
    assert any(k.startswith("rpc:") for k in entries)
    assert any(k in self_concurrent for k in entries)
