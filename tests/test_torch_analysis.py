"""graftlint (ray_tpu_torch.analysis) tests.

Three layers:

1. Per-rule true-positive / true-negative fixtures — synthetic modules
   fed straight to the checkers (pure AST; no jax, no cluster).
2. The machinery: pragmas, fingerprints, baseline split/write, CLI.
3. The tier-1 gate: the repo itself must be CLEAN (zero unbaselined
   findings), plus targeted regression tests for the real bugs the first
   full run found (dial-under-lock in rpc.py, kill-under-record-lock in
   serve/controller.py — a downscale's kills and a failed mesh spawn's
   rollback — kv_put under the export lock).

Everything here is CPU-only and fast; the fixtures never import the
modules they describe.
"""

import textwrap
import threading
import time

import pytest

from ray_tpu_torch.analysis import DEFAULT_BASELINE, repo_root, run_analysis
from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis import (lifecycle_hygiene, lock_discipline,
                              reactor_safety, trace_safety)
from ray_tpu_torch.analysis.callgraph import CallGraph
from ray_tpu_torch.analysis.core import (Baseline, Project, SourceFile,
                                   assign_fingerprints)


# --------------------------------------------------------------- helpers

def project_of(**modules) -> Project:
    """Build a Project from {"name": source} fixtures (module
    ``ray_tpu_torch.name``, path ``ray_tpu_torch/name.py``)."""
    files = []
    for name, src in modules.items():
        rel = f"ray_tpu_torch/{name}.py"
        files.append(SourceFile(f"/fixture/{rel}", rel,
                                textwrap.dedent(src)))
    return Project("/fixture", files)


def run_checker(check, project, needs_graph=True):
    """Run one checker with the same pragma filtering run_analysis does."""
    arg = CallGraph(project) if needs_graph else project
    findings = check(arg)
    by_rel = {f.relpath: f for f in project.files}
    return [f for f in findings
            if not by_rel[f.path].suppressed(f.rule, f.line)]


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------- reactor-safety

REACTOR_TP = """
    import time

    class Conn:
        def _on_readable(self):
            self._drain()

        def _drain(self):
            time.sleep(0.5)
"""

REACTOR_TN = """
    import time

    class Conn:
        def _on_readable(self):
            self.buf.append(1)
            if not self._lock.acquire(False):
                return

        def elsewhere(self):
            # blocking, but not reachable from a reactor callback
            time.sleep(0.5)
"""


def test_reactor_blocking_true_positive():
    found = run_checker(reactor_safety.check, project_of(mod=REACTOR_TP))
    assert rules_of(found) == [rules.REACTOR_BLOCKING]
    # flagged at the blocking site, with the call chain in the message
    f = found[0]
    assert f.symbol == "Conn._drain"
    assert "time.sleep" in f.message and "_on_readable" in f.message


def test_reactor_blocking_true_negative():
    found = run_checker(reactor_safety.check, project_of(mod=REACTOR_TN))
    assert found == []


def test_reactor_unbounded_wait_flagged_bounded_exempt():
    src = """
        class Conn:
            def _on_writable(self):
                self._cv.wait()

            def _on_readable(self):
                self._cv.wait(0.1)
    """
    found = run_checker(reactor_safety.check, project_of(mod=src))
    assert len(found) == 1 and found[0].symbol == "Conn._on_writable"


# --------------------------------------------------------- trace-safety

TRACE_TP = """
    import torch

    @torch.compile
    def host_sync(x):
        return x.item()

    @torch.compile(fullgraph=True)
    def tracer_branch(x):
        if x > 0:
            return x
        return -x

    @torch.jit.script
    def shape_retrace(n):
        return torch.zeros(n)

    @torch.compile
    def set_iter(x):
        acc = x
        for k in {"a", "b"}:
            acc = acc + 1
        return acc
"""

TRACE_TN = """
    import torch

    @torch.compile
    def static_shape_ok(x):
        n = x.shape[0]
        if x.shape[0] > 2:
            pass
        return torch.zeros(n)

    @torch.compile
    def static_argnum_ok(x, n: int):
        if n > 4:
            return torch.zeros(n)
        return torch.zeros((2, n))

    def not_jitted(x):
        return x.item()
"""


def test_trace_safety_true_positives():
    found = run_checker(trace_safety.check, project_of(mod=TRACE_TP))
    by_symbol = {f.symbol: f.rule for f in found}
    assert by_symbol["host_sync"] == rules.TRACE_HOST_SYNC
    assert by_symbol["tracer_branch"] == rules.TRACE_PY_BRANCH
    assert by_symbol["shape_retrace"] == rules.TRACE_RETRACE
    assert by_symbol["set_iter"] == rules.TRACE_RETRACE


def test_trace_safety_true_negatives():
    found = run_checker(trace_safety.check, project_of(mod=TRACE_TN))
    assert found == []


def test_trace_sync_in_jit_called_helper():
    src = """
        import torch

        @torch.compile
        def outer(x):
            return helper(x)

        def helper(x):
            return x.item()
    """
    found = run_checker(trace_safety.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["helper"]
    assert found[0].rule == rules.TRACE_HOST_SYNC


def test_sharded_jit_wrappers_are_trace_scopes():
    """The port's regions whatever their spelling: a function compiled
    through an ALIASED import, and the body of a CUDA-graph capture
    (with the package functions it calls), carry the same hazards as a
    decorated one."""
    src = """
        import torch
        from torch import compile as compile_fast

        def body(x):
            if x > 0:          # tensor branch
                return x
            return float(x)    # host sync

        def build():
            return compile_fast(body, dynamic=False)

        def mesh_scoped_body(x):
            return x.item()    # host sync

        def wire(g, x):
            with torch.cuda.graph(g):
                y = mesh_scoped_body(x)
                torch.cuda.synchronize()
            return y
    """
    found = run_checker(trace_safety.check, project_of(mod=src))
    got = {(f.symbol, f.rule) for f in found}
    assert ("body", rules.TRACE_PY_BRANCH) in got
    assert ("body", rules.TRACE_HOST_SYNC) in got
    assert ("mesh_scoped_body", rules.TRACE_HOST_SYNC) in got
    assert ("wire", rules.TRACE_HOST_SYNC) in got


def test_sharding_kwargs_on_non_function_args_are_ignored():
    """A compile call whose first arg is data (not a package function)
    marks nothing: no false positives on helpers that compile whatever
    they are handed."""
    src = """
        import torch

        def place(arr):
            return torch.compile(arr["fn"], dynamic=False)

        def innocent(x):
            return x.item()  # never compiled, never called from one
    """
    found = run_checker(trace_safety.check, project_of(mod=src))
    assert found == []


# ------------------------------------------------------ lock-discipline

LOCK_CYCLE_TP = """
    import threading

    class S:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def ab(self):
            with self._a:
                with self._b:
                    pass

        def ba(self):
            with self._b:
                with self._a:
                    pass
"""

LOCK_CYCLE_TN = """
    import threading

    class S:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def f(self):
            with self._a:
                with self._b:
                    pass

        def g(self):
            with self._a:
                with self._b:
                    pass
"""


def test_lock_order_cycle_true_positive():
    found = run_checker(lock_discipline.check,
                        project_of(mod=LOCK_CYCLE_TP))
    assert rules.LOCK_ORDER_CYCLE in rules_of(found)


def test_lock_order_cycle_true_negative():
    found = run_checker(lock_discipline.check,
                        project_of(mod=LOCK_CYCLE_TN))
    assert found == []


def test_self_deadlock_via_self_call_chain():
    src = """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()

            def outer(self):
                with self._a:
                    self.inner()

            def inner(self):
                with self._a:
                    pass
    """
    found = run_checker(lock_discipline.check, project_of(mod=src))
    assert [f.rule for f in found] == [rules.LOCK_ORDER_CYCLE]
    assert "self-deadlock" in found[0].message


def test_lock_held_blocking_true_positive_and_negative():
    src = """
        import threading
        import time

        class S:
            def __init__(self):
                self._a = threading.Lock()

            def bad_sleep(self):
                with self._a:
                    time.sleep(1.0)

            def bad_rpc(self, client):
                with self._a:
                    client.call("ping")

            def ok(self):
                with self._a:
                    x = 1
                time.sleep(1.0)
                return x
    """
    found = run_checker(lock_discipline.check, project_of(mod=src))
    assert {f.symbol for f in found} == {"S.bad_sleep", "S.bad_rpc"}
    assert rules_of(found) == [rules.LOCK_HELD_BLOCKING]


def test_lock_held_blocking_through_called_function():
    src = """
        import threading
        import time

        class S:
            def __init__(self):
                self._a = threading.Lock()

            def caller(self):
                with self._a:
                    self.helper()

            def helper(self):
                time.sleep(1.0)
    """
    found = run_checker(lock_discipline.check, project_of(mod=src))
    assert [f.symbol for f in found] == ["S.caller"]
    assert "helper" in found[0].message


# ---------------------------------------------------- lifecycle-hygiene

def test_swallowed_exception_tp_tn():
    src = """
        def swallowed():
            try:
                work()
            except Exception:
                pass

        def typed_ok():
            try:
                work()
            except OSError:
                pass

        def logged_ok(log):
            try:
                work()
            except Exception:
                log.warning("failed")
    """
    found = run_checker(lifecycle_hygiene.check_project,
                        project_of(mod=src), needs_graph=False)
    assert [f.symbol for f in found] == ["swallowed"]
    assert found[0].rule == rules.SWALLOWED_EXCEPTION


def test_missing_finally_release_tp_tn():
    src = """
        def leaky(self):
            self._lock.acquire()
            work_that_can_raise()
            more_work()
            self._lock.release()

        def protected(self):
            self._lock.acquire()
            try:
                work_that_can_raise()
            finally:
                self._lock.release()

        def ownership_handed_off(self):
            self._lock.acquire()
            return self._lock
    """
    found = run_checker(lifecycle_hygiene.check_project,
                        project_of(mod=src), needs_graph=False)
    assert [f.symbol for f in found] == ["leaky"]
    assert found[0].rule == rules.MISSING_FINALLY


def test_missing_finally_scoped_to_locks_only():
    """Socket/file/registration pairing moved to the path-sensitive
    resource-leak-path rule (tests/test_analysis_v2.py); the v1 rule
    keeps lock acquire/release discipline only."""
    src = """
        import socket

        def lock_leak(self):
            self._lock.acquire()
            work_that_can_raise()
            more_work()
            self._lock.release()

        def socket_not_v1s_business(addr):
            sock = socket.socket()
            handshake(sock, addr)
            sock.close()
    """
    found = run_checker(lifecycle_hygiene.check_project,
                        project_of(mod=src), needs_graph=False)
    assert [f.symbol for f in found] == ["lock_leak"]


# ----------------------------------------------------- pragmas/baseline

def test_pragma_same_line_and_line_above():
    src = """
        def a():
            try:
                work()
            except Exception:  # graftlint: disable=swallowed-exception (x)
                pass

        def b():
            try:
                work()
            # graftlint: disable=swallowed-exception
            except Exception:
                pass

        def c():
            try:
                work()
            except Exception:
                pass
    """
    found = run_checker(lifecycle_hygiene.check_project,
                        project_of(mod=src), needs_graph=False)
    assert [f.symbol for f in found] == ["c"]


def test_pragma_all_and_unrelated_rule():
    src = """
        def a():
            try:
                work()
            except Exception:  # graftlint: disable=all
                pass

        def b():
            try:
                work()
            except Exception:  # graftlint: disable=lock-order-cycle
                pass
    """
    found = run_checker(lifecycle_hygiene.check_project,
                        project_of(mod=src), needs_graph=False)
    assert [f.symbol for f in found] == ["b"]


def test_fingerprints_stable_under_line_drift():
    src_v1 = """
        def f():
            try:
                work()
            except Exception:
                pass
    """
    # same function, pushed down by unrelated code above it
    src_v2 = """
        NEW_CONSTANT = 1


        def added():
            return 2


        def f():
            try:
                work()
            except Exception:
                pass
    """
    outs = []
    for src in (src_v1, src_v2):
        found = run_checker(lifecycle_hygiene.check_project,
                            project_of(mod=src), needs_graph=False)
        assign_fingerprints(found)
        outs.append(found)
    (f1,), (f2,) = outs
    assert f1.line != f2.line
    assert f1.fingerprint == f2.fingerprint


def test_baseline_split_and_stale(tmp_path):
    src = """
        def f():
            try:
                work()
            except Exception:
                pass
    """
    found = run_checker(lifecycle_hygiene.check_project,
                        project_of(mod=src), needs_graph=False)
    assign_fingerprints(found)
    path = str(tmp_path / "baseline.json")

    # write-baseline then split: everything baselined, nothing stale
    Baseline().write(path, found, default_reason="fixture")
    bl = Baseline.load(path)
    new, baselined, stale = bl.split(found)
    assert (new, len(baselined), stale) == ([], 1, [])
    assert bl.entries[found[0].fingerprint]["reason"] == "fixture"

    # fixed finding -> its entry is reported stale
    new, baselined, stale = bl.split([])
    assert new == [] and baselined == [] and len(stale) == 1

    # missing/corrupt baseline file loads empty instead of crashing
    assert Baseline.load(str(tmp_path / "nope.json")).entries == {}


# ------------------------------------------------------------------ CLI

@pytest.mark.slow  # 9s: full-repo CLI run; the repo-clean property
# stays via test_repo_is_clean_under_strict
def test_cli_strict_clean_repo_and_list_rules(capsys):
    from ray_tpu_torch.analysis.__main__ import main

    assert main(["--list-rules"]) == 0
    assert set(capsys.readouterr().out.split()) == set(rules.ALL_RULES)
    assert main(["--strict"]) == 0
    assert main(["--rules", "no-such-rule"]) == 2


@pytest.mark.slow  # 10s: full-repo CLI run; JSON shape stays via the
# diff-mode CLI tests, repo-clean via the strict gate
def test_cli_json_output(capsys):
    import json

    from ray_tpu_torch.analysis.__main__ import main

    assert main(["--format", "json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["findings"] == []
    assert "stats" in data


# ------------------------------------------------------ the tier-1 gate

@pytest.fixture(scope="module")
def full_run():
    """One full serial run shared by the gate and its budget."""
    return run_analysis()


def test_repo_is_clean_under_strict(full_run):
    """THE gate: zero unbaselined findings in the whole package. A new
    finding means: fix it, pragma it with a reason, or baseline it with
    a reason (the README's analyzer section)."""
    findings, stats = full_run
    baseline = Baseline.load(DEFAULT_BASELINE)
    new, _baselined, stale = baseline.split(findings)
    assert not new, "unbaselined graftlint findings:\n" + \
        "\n".join(f.render() for f in new)
    assert not stale, f"stale baseline entries (finding fixed? " \
        f"remove them): {stale}"


def test_full_run_is_fast(full_run):
    _, stats = full_run
    # Budget: the run's CPU seconds (this process and any workers it
    # reaped), which a loaded host's wall clock cannot inflate.
    assert stats["cpu_s"] < 15.0, stats


def test_lock_rules_stay_clean_on_fixed_files():
    """Targeted regression for the real lock bugs fixed by the
    first full run: re-introducing a dial/RPC/kill under these locks
    must fail THIS test, not just the broad gate."""
    findings, _ = run_analysis(
        select=[rules.LOCK_HELD_BLOCKING, rules.LOCK_ORDER_CYCLE],
        paths=["ray_tpu_torch/core/rpc.py", "ray_tpu_torch/core/controller.py",
               "ray_tpu_torch/core/remote_function.py",
               "ray_tpu_torch/serve/controller.py"])
    assert findings == [], "\n".join(f.render() for f in findings)


# ------------------------------------- regression tests for real fixes

def test_reconnecting_client_close_not_blocked_by_dial(monkeypatch):
    """rpc.py fix: ReconnectingClient._get dials OUTSIDE _lock, so a
    stuck dial to a dead peer cannot wedge close() (or any other caller)
    behind it."""
    from ray_tpu_torch.core import rpc as rpc_mod

    dial_started = threading.Event()
    release_dial = threading.Event()
    real_connect = rpc_mod._connect

    def slow_connect(addr, timeout, role="peer"):
        dial_started.set()
        release_dial.wait(10.0)
        raise rpc_mod.RpcError(f"no peer at {addr}")

    monkeypatch.setattr(rpc_mod, "_connect", slow_connect)
    client = rpc_mod.ReconnectingClient(("127.0.0.1", 1), retry_window_s=0.1)
    caller = threading.Thread(
        target=lambda: pytest.raises(Exception, client.call, "ping"),
        daemon=True)
    caller.start()
    assert dial_started.wait(5.0)
    t0 = time.monotonic()
    client.close()  # takes _lock; pre-fix this blocked on the dial
    closed_in = time.monotonic() - t0
    release_dial.set()
    caller.join(timeout=5.0)
    monkeypatch.setattr(rpc_mod, "_connect", real_connect)
    assert closed_in < 1.0, f"close() blocked {closed_in:.2f}s behind dial"


def test_export_callable_kv_put_outside_lock(monkeypatch):
    """remote_function.py fix: the kv_put RPC runs outside _export_lock,
    so one slow controller round-trip cannot serialize every other
    function's first export behind it."""
    from ray_tpu_torch.core import remote_function as rf

    blocked = threading.Event()
    release = threading.Event()
    puts = []

    class FakeController:
        def call(self, method, key, blob, overwrite):
            puts.append(key)
            if len(puts) == 1:
                blocked.set()
                assert release.wait(10.0)

    class FakeCore:
        controller = FakeController()

    monkeypatch.setattr(rf, "get_core_worker", lambda: FakeCore())
    monkeypatch.setattr(rf, "_exported_keys", set())

    def fn_a():
        return "a"

    def fn_b():
        return "b"

    t = threading.Thread(target=rf.export_callable, args=(fn_a,),
                         daemon=True)
    t.start()
    assert blocked.wait(5.0)
    # first export is parked inside its kv_put; a second export of a
    # DIFFERENT function must still get through
    done = threading.Event()
    t2 = threading.Thread(
        target=lambda: (rf.export_callable(fn_b), done.set()), daemon=True)
    t2.start()
    assert done.wait(5.0), "second export serialized behind slow kv_put"
    release.set()
    t.join(timeout=5.0)
    t2.join(timeout=5.0)
    assert len(puts) == 2


def test_serve_controller_kills_replicas_outside_record_lock(monkeypatch):
    """serve/controller.py fix: replica kills (an RPC) happen after
    rec.lock is released, in _settle/_reconcile_one/_drain alike."""
    import ray_tpu_torch
    from ray_tpu_torch.serve import controller as sc

    rec = sc.DeploymentRecord("d", b"", (), {}, {"num_replicas": 0})
    rec.replicas = [sc.ReplicaRecord(object(), "d#0"),
                    sc.ReplicaRecord(object(), "d#1")]

    ctrl = sc.ServeController.__new__(sc.ServeController)  # no threads
    lock_state_at_kill = []

    def fake_kill(handle):
        lock_state_at_kill.append(rec.lock.locked())

    monkeypatch.setattr(ray_tpu_torch, "kill", fake_kill)

    # the deploy tail: settle under the lock, kill after
    orphans = []
    with rec.lock:
        doomed = ctrl._settle(rec, orphans)
    assert len(doomed) == 2 and rec.replicas == [] and orphans == []
    assert lock_state_at_kill == []  # _settle itself must not kill
    for replica in doomed:
        ctrl._kill_replica(replica)
    assert lock_state_at_kill == [False, False]

    # _drain (no lock held) still kills every replica
    lock_state_at_kill.clear()
    rec.replicas = [sc.ReplicaRecord(object(), "d#2")]
    ctrl._drain(rec)
    assert rec.replicas == [] and lock_state_at_kill == [False]


def test_mesh_spawn_rollback_kills_outside_record_lock(monkeypatch):
    """A mesh spawn whose second rank fails: the first rank's kill (a
    controller RPC) runs after rec.lock is released, so another thread
    takes the record lock while that kill is still parked."""
    import ray_tpu_torch
    from ray_tpu_torch.core import runtime
    from ray_tpu_torch.serve import controller as sc

    rec = sc.DeploymentRecord("d", b"", (), {},
                              {"num_replicas": 1, "mesh_shape": [1, 2]})
    ctrl = sc.ServeController.__new__(sc.ServeController)  # no threads
    ctrl._lock = threading.Lock()
    ctrl._deployments = {"d": rec}
    ctrl._epoch = 0
    released = []

    class Stub:
        def __init__(self, _addr):
            pass

        def reserve_subslice(self, owner, chips, shape, timeout=None):
            return {"reservation_id": "r0", "slice_id": "s0",
                    "nodes": ["n0"]}

        def release_subslice(self, reservation_id, timeout=None):
            released.append(reservation_id)

    class Worker:
        controller = ("localhost", 0)

    spawned = []

    class Remote:
        def __init__(self, cls):
            self.cls = cls

        def options(self, **_opts):
            return self

        def remote(self, *args, **kwargs):
            if spawned:
                raise RuntimeError("rank 1 failed to start")
            spawned.append(object())
            return spawned[-1]

    parked = threading.Event()
    resume = threading.Event()
    held_at_kill = []

    def parked_kill(handle):
        held_at_kill.append(rec.lock.locked())
        parked.set()
        resume.wait(10.0)

    monkeypatch.setattr(sc, "ControllerStub", Stub)
    monkeypatch.setattr(runtime, "get_core_worker", lambda: Worker())
    monkeypatch.setattr(ray_tpu_torch, "remote", Remote)
    monkeypatch.setattr(ray_tpu_torch, "kill", parked_kill)

    errors = []

    def reconcile():
        try:
            ctrl._reconcile_one(rec)
        except Exception as e:  # the spawn failure, re-raised
            errors.append(e)

    t = threading.Thread(target=reconcile, daemon=True)
    t.start()
    try:
        assert parked.wait(10.0), "the spawned rank was never killed"
        took = rec.lock.acquire(timeout=2.0)
        if took:
            rec.lock.release()
    finally:
        resume.set()
        t.join(10.0)
    assert not t.is_alive()
    assert took, "rec.lock held across the rollback's kill RPC"
    assert held_at_kill == [False]
    assert [str(e) for e in errors] == ["rank 1 failed to start"]
    assert released == ["r0"] and rec.replicas == []


def test_alloc_pages_hands_pages_back_when_the_event_raises():
    """serve/decode.py fix (resource-leak-path): a page-alloc event that
    raises frees the pages it was about to hand out, so the pool keeps
    every page."""
    from ray_tpu_torch.serve.decode import DecodeEngine
    from ray_tpu_torch.serve.paging import PageAllocator

    class FailingLog:
        enabled = True

        def event(self, *args, **kwargs):
            raise RuntimeError("timeline full")

    engine = DecodeEngine.__new__(DecodeEngine)  # no model, no threads
    engine._pages = PageAllocator(8)
    engine.prefix = None
    engine.steplog = FailingLog()
    free = engine._pages.free_count
    with pytest.raises(RuntimeError, match="timeline full"):
        engine._alloc_pages(3)
    assert engine._pages.free_count == free


def test_decode_loop_clears_looping_under_the_sync_lock():
    """serve/decode.py fix (unguarded-field-access): the loop clears
    ``_looping`` under ``_sync_lock``, where ``shutdown`` reads it to
    decide whether a loop is left to send rank 0's stop. While another
    thread holds the lock, the exiting loop waits for it."""
    from ray_tpu_torch.serve.decode import DecodeEngine

    engine = DecodeEngine.__new__(DecodeEngine)  # no model, no threads
    engine._sync_lock = threading.RLock()
    engine._looping = False
    engine._stop = threading.Event()
    engine._work = threading.Event()
    engine._ctl = None
    engine._lead = False
    inside = threading.Event()
    leave = threading.Event()

    def has_work():
        inside.set()
        leave.wait(10.0)
        return False

    engine._has_work = has_work
    loop = threading.Thread(target=engine.serve_forever, daemon=True)
    loop.start()
    try:
        assert inside.wait(10.0)
        with engine._sync_lock:
            engine._stop.set()
            leave.set()
            time.sleep(0.3)  # the loop runs to its finally meanwhile
            looping_while_held = engine._looping
    finally:
        leave.set()
        engine._stop.set()
        loop.join(10.0)
    assert not loop.is_alive()
    assert looping_while_held, "_looping cleared without _sync_lock"
    assert engine._looping is False
