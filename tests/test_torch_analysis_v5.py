"""graftlint v5 tests: the deadline-safety family and the
central stale-pragma hygiene check.

Same layering as tests/test_analysis{,_v2,_v3,_v4}.py:

1. Per-rule TP/TN fixtures — synthetic modules fed straight to the
   checker (no jax, no cluster): unbounded waits reachable from thread
   entries, scope-gated RPC timeout kwargs, budget-propagation passes
   vs the Deadline idiom, infinite retry loops, dead timeout knobs,
   and pragma-staleness verdicts.
2. Mutation fixtures on the REAL repo sources: reverting each class of
   the true-positive fixes (the gang-formation Deadline thread,
   a serve-controller bound, a pipeline-plane bound, an autopilot
   bound, the serve.status budget thread) — or deleting a reasoned
   pragma — is caught statically, by finding name. retry-unbounded has
   no repo occurrence by design (ReconnectingClient's loop is
   window-bounded), so it is synthetic-only.
3. Collector-liveness guards: the wait-site / rpc-site / thread-root
   inventories still see the real repo (an idiom drift that silently
   empties a collector would otherwise read as "clean").
4. Per-family repo-clean gates + strict-path coverage, and the
   stale-pragma full-run-only contract.

Budget note: shares ONE parsed base project and ONE repo call graph
across all repo-level tests (same lru_cache idiom as v4).
"""

import functools
import textwrap

import pytest

from ray_tpu_torch.analysis import (_stale_pragma_findings, deadline_safety,
                              repo_root, rules, run_analysis)
from ray_tpu_torch.analysis.callgraph import CallGraph
from ray_tpu_torch.analysis.core import Finding, Project, SourceFile

DEADLINE_RULES = set(rules.FAMILIES["deadline-safety"])


def project_at(modules) -> Project:
    files = []
    for sub, src in modules.items():
        rel = f"ray_tpu_torch/{sub}.py"
        files.append(SourceFile(f"/fixture/{rel}", rel,
                                textwrap.dedent(src)))
    return Project("/fixture", files)


def run_checker(project):
    graph = CallGraph(project)
    findings = deadline_safety.check(graph)
    by_rel = {f.relpath: f for f in project.files}
    return [f for f in findings
            if not by_rel[f.path].suppressed(f.rule, f.line)]


def by_rule(findings, rule):
    return [f for f in findings if f.rule == rule]


@functools.lru_cache(maxsize=1)
def _base_project() -> Project:
    return Project.load(repo_root())


@functools.lru_cache(maxsize=1)
def _repo_graph() -> CallGraph:
    graph = CallGraph(_base_project())
    graph.edges()
    return graph


def repo_mutant(path, subs) -> Project:
    """The real repo with ONE file's text patched (nothing on disk);
    ``subs`` is a list of (old, new) applied in order."""
    base = _base_project()
    files = []
    hit = False
    for f in base.files:
        if f.relpath == path:
            text = f.text
            for old, new in subs:
                assert old in text, f"mutation no-op in {path}: {old!r}"
                text = text.replace(old, new)
            files.append(SourceFile(f.abspath, f.relpath, text))
            hit = True
        else:
            files.append(f)
    assert hit, path
    return Project(base.root, files)


def _pragma_filtered(findings, project):
    by_rel = {f.relpath: f for f in project.files}
    return [f for f in findings
            if not (f.path in by_rel
                    and by_rel[f.path].suppressed(f.rule, f.line))]


def mutant_findings(path, subs):
    project = repo_mutant(path, subs)
    graph = CallGraph(project)
    return _pragma_filtered(deadline_safety.check(graph), project)


# ============================================ unbounded-blocking-call


def test_unbounded_wait_from_thread_entry_tp_tn():
    project = project_at({"fix/pump": """
        import threading

        class Pump:
            def __init__(self):
                self._ev = threading.Event()
                self._t = threading.Thread(target=self._loop)

            def _loop(self):
                self._helper()

            def _helper(self):
                self._ev.wait()          # TP: unbounded, thread entry

            def _bounded_loop(self):
                self._ev.wait(5.0)       # TN: finite
    """})
    found = by_rule(run_checker(project), rules.DEADLINE_UNBOUNDED)
    assert len(found) == 1
    f = found[0]
    assert f.symbol == "Pump._helper"
    assert "thread:" in f.message and "_loop" in f.message


def test_unbounded_wait_none_timeout_and_join_tp():
    project = project_at({"fix/joiner": """
        import threading

        class J:
            def __init__(self):
                threading.Thread(target=self._run)

            def _run(self):
                self._ev.wait(timeout=None)   # TP: literal None
                self._t.join()                # TP: unbounded join
                self._t.join(2.0)             # TN
    """})
    found = by_rule(run_checker(project), rules.DEADLINE_UNBOUNDED)
    assert len(found) == 2
    assert {"unbounded wait", "unbounded join"} == {
        f.message.split(" on ")[0] for f in found}


def test_queue_get_requires_ctor_typing():
    """dict.get / contextvar.get never match; a ctor-typed queue's
    bare get() does; block=False is non-blocking (TN)."""
    project = project_at({"fix/queues": """
        import queue
        import threading

        class Q:
            def __init__(self):
                self.q = queue.Queue()
                threading.Thread(target=self._drain)

            def _drain(self):
                d = {}
                d.get("k")                 # TN: not a queue
                local_q = queue.Queue()
                local_q.get(block=False)   # TN: non-blocking
                local_q.get(timeout=1.0)   # TN: bounded
                self.q.get()               # TP
    """})
    found = by_rule(run_checker(project), rules.DEADLINE_UNBOUNDED)
    assert len(found) == 1
    assert "queue get" in found[0].message


def test_socket_recv_bounded_by_module_mode_management():
    tp = project_at({"fix/raw": """
        import threading

        class R:
            def __init__(self):
                threading.Thread(target=self._rx)

            def _rx(self):
                self.sock.recv(4096)      # TP: no settimeout anywhere
    """})
    found = by_rule(run_checker(tp), rules.DEADLINE_UNBOUNDED)
    assert len(found) == 1 and "socket recv" in found[0].message
    tn = project_at({"fix/raw": """
        import threading

        class R:
            def __init__(self):
                threading.Thread(target=self._rx)
                self.sock.settimeout(5.0)

            def _rx(self):
                self.sock.recv(4096)      # TN: module manages modes
    """})
    assert by_rule(run_checker(tn), rules.DEADLINE_UNBOUNDED) == []


# =============================================== rpc-call-no-timeout


def test_rpc_timeout_scope_and_stub_typing_tp_tn():
    src = """
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        class Plane:
            def bad_literal(self, client):
                return client.call("list_nodes")          # TP

            def bad_stub(self, client):
                stub = ControllerStub(client)
                return stub.taint_state()                 # TP

            def bad_stub_param(self, stub):
                return stub.release_subslice("r1")        # TP

            def bad_none(self, client):
                return client.call("kv_get", timeout=None)  # TP

            def good(self, client):
                return client.call("list_nodes", timeout=5.0)  # TN

            def good_stub(self, client):
                return ControllerStub(client).kv_get(
                    "k", timeout=1.0)                     # TN
    """
    in_scope = project_at({"serve/controller": src})
    found = by_rule(run_checker(in_scope),
                    rules.DEADLINE_RPC_NO_TIMEOUT)
    assert len(found) == 4
    assert {f.symbol.split(".")[-1] for f in found} == {
        "bad_literal", "bad_stub", "bad_stub_param", "bad_none"}
    # same code OUTSIDE the control-plane scope: the rule stays quiet
    out_scope = project_at({"util/whatever": src})
    assert by_rule(run_checker(out_scope),
                   rules.DEADLINE_RPC_NO_TIMEOUT) == []


# ============================================ deadline-not-propagated


def test_propagation_nx_budget_tp_and_deadline_idiom_tn():
    project = project_at({"fix/budget": """
        class W:
            def bad(self, client, timeout):
                a = client.call("step_one", timeout=timeout)
                b = client.call("step_two", timeout=timeout)  # 2x
                return a, b

            def good(self, client, timeout):
                from ray_tpu_torch.util.deadline import Deadline
                dl = Deadline.after(timeout)
                a = client.call("step_one", timeout=dl.remaining())
                b = client.call("step_two", timeout=dl.remaining())
                return a, b

            def pass_through(self, client, timeout):
                return client.call("only_one", timeout=timeout)
    """})
    found = by_rule(run_checker(project),
                    rules.DEADLINE_NOT_PROPAGATED)
    assert len(found) == 1
    assert found[0].symbol == "W.bad"
    assert "2 downstream calls" in found[0].message


def test_propagation_budget_dropped_tp():
    project = project_at({"fix/dropper": """
        class D:
            def bad(self, client, timeout_s):
                return client.call("poll")   # budget never threaded
    """})
    found = by_rule(run_checker(project),
                    rules.DEADLINE_NOT_PROPAGATED)
    assert len(found) == 1
    assert "dropped" in found[0].message


def test_propagation_raise_and_return_positions_are_not_passes():
    """Error messages quoting the budget and alternative return exits
    must not count as extra budget consumers (the object_store.wait /
    core.api.wait false-positive shapes)."""
    project = project_at({"fix/shapes": """
        class S:
            def alt_returns(self, a, b, timeout):
                if a:
                    return a.call("x", timeout=timeout)
                return b.call("x", timeout=timeout)

            def raising(self, client, timeout):
                got = client.call("x", timeout=timeout)
                if not got:
                    raise TimeoutError(f"timed out after {timeout}s")
                return got
    """})
    assert by_rule(run_checker(project),
                   rules.DEADLINE_NOT_PROPAGATED) == []


# ==================================================== retry-unbounded


def test_retry_unbounded_tp_and_bounded_tn():
    project = project_at({"fix/retry": """
        import itertools
        import time

        class R:
            def bad(self, client):
                while True:
                    try:
                        client.call("ping")        # TP: no bound
                    except Exception:
                        continue

            def bad_count(self, client):
                for _ in itertools.count():
                    client.dial("peer")            # TP

            def good_backoff(self, client):
                while True:
                    try:
                        client.call("ping")
                    except Exception:
                        time.sleep(0.5)            # TN: backoff

            def good_attempts(self, client):
                attempts = 0
                while True:
                    client.call("ping")
                    attempts += 1                  # TN: counter

            def good_deadline(self, client, dl):
                while True:
                    client.call("ping", timeout=dl.remaining())  # TN
    """})
    found = by_rule(run_checker(project),
                    rules.DEADLINE_RETRY_UNBOUNDED)
    assert {f.symbol.split(".")[-1] for f in found} == {
        "bad", "bad_count"}


# ================================================== timeout-knob-dead


def test_dead_knob_tp_tn():
    project = project_at({
        "core/config": """
            _FLAG_DEFS = {
                "dead_timeout_s": (float, 1.0, "never read"),
                "live_timeout_s": (float, 2.0, "read below"),
                "not_a_timeout": (int, 3, "suffix-gated: ignored"),
            }
        """,
        "core/user": """
            def use(config):
                return config.live_timeout_s
        """,
    })
    found = by_rule(run_checker(project), rules.DEADLINE_KNOB_DEAD)
    assert len(found) == 1
    assert found[0].symbol == "dead_timeout_s"


# ======================================================= stale-pragma


def _sf(rel, src):
    return SourceFile(f"/fixture/{rel}", rel, textwrap.dedent(src))


def test_stale_pragma_verdicts():
    rel = "ray_tpu_torch/fix/mod.py"
    sf = _sf(rel, """\
        def f():
            # graftlint: disable=swallowed-exception
            covered_line()
            pass  # graftlint: disable=lock-held-blocking
    """)
    project = Project("/fixture", [sf])
    # no raw findings: both pragmas are stale
    stale = _stale_pragma_findings(project, [])
    assert len(stale) == 2
    assert all(f.rule == rules.STALE_PRAGMA for f in stale)
    # a live finding on the COVERED line keeps the standalone pragma
    live = Finding(rule="swallowed-exception", path=rel, line=3,
                   symbol="f", message="x")
    stale = _stale_pragma_findings(project, [live])
    assert [f.line for f in stale] == [4]  # only the inline one left


def test_stale_pragma_unknown_rule_is_stale_by_definition():
    rel = "ray_tpu_torch/fix/unknown.py"
    project = Project("/fixture", [_sf(rel, """\
        def f():
            pass  # graftlint: disable=no-such-rule-ever
    """)])
    stale = _stale_pragma_findings(project, [])
    assert len(stale) == 1
    assert "unknown rule" in stale[0].message


def test_stale_pragma_cannot_suppress_itself():
    """A pragma naming stale-pragma covers no live finding and must
    itself be reported (run_analysis appends stale findings AFTER
    pragma suppression, so the self-suppression can never engage)."""
    rel = "ray_tpu_torch/fix/selfref.py"
    project = Project("/fixture", [_sf(rel, """\
        def f():
            pass  # graftlint: disable=stale-pragma
    """)])
    stale = _stale_pragma_findings(project, [])
    assert len(stale) == 1 and stale[0].rule == rules.STALE_PRAGMA


def test_stale_pragma_only_on_full_runs():
    """--select / --paths slices skip the staleness sweep: a sliced run
    cannot see every finding, so every pragma would look stale."""
    findings, _ = run_analysis(
        select=[rules.DEADLINE_RPC_NO_TIMEOUT])
    assert by_rule(findings, rules.STALE_PRAGMA) == []


# ================================================== repo mutation TPs


def test_mutation_gang_formation_deadline_dropped():
    """Reverting the _form Deadline thread (mh_register_group loses its
    timeout) refires rpc-call-no-timeout on multihost.py."""
    found = mutant_findings("ray_tpu_torch/core/multihost.py", [(
        """                reg = stub.mh_register_group(self.group_id,
                                             self.num_hosts,
                                             None, self._owner,
                                             timeout=dl.remaining())""",
        """                reg = stub.mh_register_group(self.group_id,
                                             self.num_hosts,
                                             None, self._owner)""")])
    hits = by_rule(found, rules.DEADLINE_RPC_NO_TIMEOUT)
    assert len(hits) == 1
    assert hits[0].path == "ray_tpu_torch/core/multihost.py"
    assert "'mh_register_group'" in hits[0].message


def test_mutation_serve_controller_unbounded_list_nodes():
    found = mutant_findings("ray_tpu_torch/serve/controller.py", [(
        """list_nodes(
                    timeout=config.ctrl_call_timeout_s)""",
        "list_nodes()")])
    hits = by_rule(found, rules.DEADLINE_RPC_NO_TIMEOUT)
    assert [h.symbol for h in hits] == ["ServeController._alive_nodes"]


def test_mutation_pipeline_plane_unbounded_pipe_state():
    found = mutant_findings("ray_tpu_torch/train/pipeline_plane.py", [(
        """pipe_state(
            self.name, timeout=_cfg.ctrl_call_timeout_s)""",
        "pipe_state(self.name)")])
    hits = by_rule(found, rules.DEADLINE_RPC_NO_TIMEOUT)
    assert len(hits) == 1 and "'pipe_state'" in hits[0].message


def test_mutation_autopilot_unbounded_taint_state():
    found = mutant_findings("ray_tpu_torch/autopilot.py", [(
        """taint_state(
                timeout=config.ctrl_call_timeout_s)""",
        "taint_state()")])
    hits = by_rule(found, rules.DEADLINE_RPC_NO_TIMEOUT)
    assert len(hits) == 1 and hits[0].path == "ray_tpu_torch/autopilot.py"


def test_mutation_serve_status_budget_unthreaded():
    """Reverting serve.status's Deadline (both attempts back on the
    full budget) refires deadline-not-propagated."""
    found = mutant_findings("ray_tpu_torch/serve/api.py", [
        ("dl = Deadline.after(timeout)", "_ = timeout"),
        ("timeout=dl.remaining())", "timeout=timeout)"),
    ])
    hits = by_rule(found, rules.DEADLINE_NOT_PROPAGATED)
    assert [h.symbol for h in hits] == ["status"]
    assert "downstream calls" in hits[0].message


def test_mutation_state_pragma_deletion_refires():
    """node_infos' per-node-bound design rides on a reasoned pragma;
    deleting it must resurface the finding (liveness the stale-pragma
    check depends on)."""
    pragma = ("# graftlint: disable=deadline-not-propagated (PER-NODE "
              "bound by design")
    base = _base_project()
    text = next(f.text for f in base.files
                if f.relpath == "ray_tpu_torch/util/state.py")
    line = next(l for l in text.splitlines() if pragma in l)
    found = mutant_findings("ray_tpu_torch/util/state.py",
                            [(line + "\n", "")])
    hits = by_rule(found, rules.DEADLINE_NOT_PROPAGATED)
    assert [h.symbol for h in hits] == ["node_infos"]


def test_mutation_runtime_pragma_deletion_refires():
    pragma = ("# graftlint: disable=unbounded-blocking-call (same "
              "contract as the pool branch")
    base = _base_project()
    text = next(f.text for f in base.files
                if f.relpath == "ray_tpu_torch/core/runtime.py")
    line = next(l for l in text.splitlines() if pragma in l)
    found = mutant_findings("ray_tpu_torch/core/runtime.py",
                            [(line + "\n", "")])
    hits = by_rule(found, rules.DEADLINE_UNBOUNDED)
    assert len(hits) == 1
    assert "unbounded future wait" in hits[0].message


def test_mutation_orphan_knob_is_dead():
    found = mutant_findings("ray_tpu_torch/core/config.py", [(
        '"ctrl_call_timeout_s": (float, 30.0,',
        '"orphan_probe_timeout_s": (float, 1.0, "never read"),\n'
        '    "ctrl_call_timeout_s": (float, 30.0,')])
    hits = by_rule(found, rules.DEADLINE_KNOB_DEAD)
    assert [h.symbol for h in hits] == ["orphan_probe_timeout_s"]


# ============================================ collector liveness, gates


def test_wait_site_inventory_sees_the_repo():
    waits = deadline_safety.wait_sites(_repo_graph())
    sites = [s for ss in waits.values() for s in ss]
    assert len(sites) > 20
    assert any(b for _, _, b in sites)      # bounded waits exist
    assert any(not b for _, _, b in sites)  # and pragma'd unbounded ones


def test_rpc_site_inventory_sees_the_repo_and_scope_is_bounded():
    all_rpc = deadline_safety.rpc_sites(_repo_graph())
    graph = _repo_graph()
    in_scope = [(fqn, s) for fqn, ss in all_rpc.items() for s in ss
                if graph.functions[fqn].file.relpath.startswith(
                    rules.DEADLINE_RPC_SCOPE_PREFIXES)]
    assert len(in_scope) > 30
    unbounded = [(f, s) for f, s in in_scope if not s[2]]
    assert unbounded == [], unbounded  # THE acceptance invariant


def test_thread_roots_nonempty_and_exclude_caller_reactor():
    roots = deadline_safety._thread_roots(_repo_graph())
    assert roots
    assert all(k not in ("caller", "reactor") for k in roots.values())


def test_ctrl_call_knob_is_live():
    found = by_rule(deadline_safety.check(_repo_graph()),
                    rules.DEADLINE_KNOB_DEAD)
    assert found == [], "\n".join(f.render() for f in found)


def test_deadline_family_repo_clean():
    found = _pragma_filtered(deadline_safety.check(_repo_graph()),
                             _base_project())
    assert found == [], "\n".join(f.render() for f in found)


def test_full_run_clean_including_stale_pragmas():
    """The whole-repo gate: 14 families plus the
    staleness sweep, zero findings, EMPTY baseline. One full run serves
    as both the family gate and the strict-path stats check (a separate
    ``select=`` run would re-parse the repo for the same assertions —
    tier-1 budget; the select plumbing itself is covered by the v2/v3
    CLI tests, and the rule->family registration is asserted below
    without a second run)."""
    assert DEADLINE_RULES <= set(rules.ALL_RULES)
    findings, stats = run_analysis()
    assert findings == [], "\n".join(f.render() for f in findings)
    assert "deadline-safety_s" in stats
