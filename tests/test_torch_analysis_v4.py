"""graftlint v4 tests: the epoch-fence protocol checker
and donated-buffer aliasing safety.

Same layering as tests/test_analysis{,_v2,_v3}.py:

1. Per-rule TP/TN fixtures — synthetic modules fed straight to the
   checkers (no jax, no cluster), including the fence-carrier
   transitive propagation and the same-line-rebind donation idiom.
2. Mutation fixtures on the REAL repo sources: reverting each of the
   true-positive fixes (the multihost reservation-write verdict
   check, the serve-controller fenced save, the snapshot epoch key,
   a _dispatch_fresh wrap and an np.array copy grafted onto the
   port's decode engine, which compiles no donated program) or flipping
   a protocol comparison is caught statically, by finding name — the
   acceptance criterion that the strict CLI run fails on any revert.
   donation-read-after-donate has no repo occurrence by design (every
   donated dispatch rebinds its result), so it is synthetic-only.
3. Collector-liveness guards: the site/index collectors still see the
   real repo's fenced writes and donated programs (an idiom drift that
   silently empties a collector would otherwise read as "clean").
4. Per-family repo-clean gates + --diff (emit_files) slice coverage.

Budget note: the module shares ONE parsed base project and ONE repo
call graph across all repo-level tests; each mutation fixture re-parses
only the mutated file and rebuilds just the graph (~1.5 s apiece).
"""

import functools
import textwrap

import pytest

from ray_tpu_torch.analysis import repo_root, rules, run_analysis
from ray_tpu_torch.analysis import donation_safety, fence_safety
from ray_tpu_torch.analysis.callgraph import CallGraph
from ray_tpu_torch.analysis.core import Project, SourceFile

FENCE_RULES = set(rules.FAMILIES["fence-safety"])
DONATION_RULES = set(rules.FAMILIES["donation-aliasing"])


def project_at(modules) -> Project:
    """Synthetic project keyed by repo-relative subpath (so fixtures
    can land on the paths the rules tables point at)."""
    files = []
    for sub, src in modules.items():
        rel = f"ray_tpu_torch/{sub}.py"
        files.append(SourceFile(f"/fixture/{rel}", rel,
                                textwrap.dedent(src)))
    return Project("/fixture", files)


def run_checker(check, project):
    graph = CallGraph(project)
    findings = check(graph)
    by_rel = {f.relpath: f for f in project.files}
    return [f for f in findings
            if not by_rel[f.path].suppressed(f.rule, f.line)]


@functools.lru_cache(maxsize=1)
def _base_project() -> Project:
    return Project.load(repo_root())


@functools.lru_cache(maxsize=1)
def _repo_graph() -> CallGraph:
    graph = CallGraph(_base_project())
    graph.edges()
    return graph


def repo_mutant(path, old, new) -> Project:
    """The real repo with ONE file's text patched (nothing touches
    disk; unmutated files reuse the shared parsed base project)."""
    base = _base_project()
    files = []
    hit = False
    for f in base.files:
        if f.relpath == path:
            text = f.text.replace(old, new)
            assert text != f.text, f"mutation no-op in {path}: {old!r}"
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


def mutant_findings(check, path, old, new):
    project = repo_mutant(path, old, new)
    graph = CallGraph(project)
    return _pragma_filtered(check(graph), project), graph


# ===================================================== fence-safety
# ------------------------------------- fence-result-ignored (TP/TN)


def test_fence_result_ignored_tp_tn():
    project = project_at({"fix/gangs": """
        class Gang:
            def bad(self, stub, epoch):
                stub.mh_group_put("g", "k", "v", epoch)

            def bad_assign(self, stub):
                put = stub.kv_put_fenced("k", b"v", 1, "e")

            def good(self, stub, epoch):
                res = stub.mh_group_put("g", "k", "v", epoch)
                if not (res or {}).get("ok"):
                    raise RuntimeError("deposed")
    """})
    found = run_checker(fence_safety.check, project)
    assert {f.rule for f in found} == {rules.FENCE_RESULT_IGNORED}
    assert {f.symbol for f in found} == {"Gang.bad", "Gang.bad_assign"}


def test_fence_carrier_chain_charges_the_discarding_caller():
    """A function that just forwards the verdict (bare return) is a
    fence CARRIER: the finding lands at ITS call sites, transitively,
    and a consuming caller stays clean."""
    project = project_at({"fix/carrier": """
        class Gang:
            def _put(self, stub):
                return stub.kv_put_fenced("k", b"v", 1, "e")

            def bad(self, stub):
                self._put(stub)

            def good(self, stub):
                out = self._put(stub)
                return bool(out)
    """})
    found = run_checker(fence_safety.check, project)
    assert len(found) == 1
    f = found[0]
    assert f.rule == rules.FENCE_RESULT_IGNORED
    assert f.symbol == "Gang.bad"
    assert "fence carrier" in f.message and "Gang._put" in f.message


def test_fenced_rpc_string_form_is_covered():
    project = project_at({"fix/stringform": """
        class Gang:
            def bad(self, client):
                client.call("kv_put_fenced", "k", b"v", 1, "e")

            def good(self, client):
                ok = client.call("kv_put_fenced", "k", b"v", 1, "e")
                return {"ok": bool(ok)}
    """})
    found = run_checker(fence_safety.check, project)
    assert [f.symbol for f in found] == ["Gang.bad"]


# ---------------------------- unfenced-mutation-in-fenced-class


def test_unfenced_mutation_tp_tn():
    project = project_at({"fix/fenced_cls": """
        class ServeController:
            def bad_raw(self, stub):
                ok = stub.kv_put("k", b"v")
                return ok

            def bad_string(self, client):
                out = client.call("kv_put", "k", b"v")
                return out

            def bad_epochless_publish(self, stub, snap, v):
                r = stub.psub_publish("ch", "key", snap, v)
                return r

        class Bystander:
            def fine(self, stub):
                ok = stub.kv_put("k", b"v")
                return ok
    """})
    found = run_checker(fence_safety.check, project)
    assert {f.rule for f in found} == {rules.FENCE_UNFENCED_MUTATION}
    assert {f.symbol for f in found} == {
        "ServeController.bad_raw", "ServeController.bad_string",
        "ServeController.bad_epochless_publish"}


# ----------------------------------- epoch-compare-direction


def test_compare_direction_equal_ok_tp_tn_and_mirror():
    """equal-ok clocks reject only STRICTLY older; <= drops a
    legitimate same-epoch republish. The mirrored spelling (stored on
    the left) normalizes to the same verdict; constant comparands are
    sentinel checks, not protocol."""
    project = project_at({"core/multihost": """
        class Registry:
            def bad(self, epoch, rec):
                if epoch <= rec.epoch:
                    return {"ok": False, "reason": "stale_epoch"}
                return {"ok": True}

            def bad_mirrored(self, epoch, rec):
                if rec.epoch >= epoch:
                    return {"ok": False}
                return {"ok": True}

            def good(self, epoch, rec):
                if epoch < rec.epoch:
                    return {"ok": False, "reason": "stale_epoch"}
                return {"ok": True}

            def sentinel(self, rec):
                return rec.epoch > 0
    """})
    found = run_checker(fence_safety.check, project)
    assert {f.rule for f in found} == {rules.FENCE_COMPARE_DIRECTION}
    assert {f.symbol for f in found} == {"Registry.bad",
                                         "Registry.bad_mirrored"}
    assert all("equal must be ACCEPTED" in f.message for f in found)


def test_compare_direction_strict_tp_tn():
    """strict clocks (weight versions) must reject EQUAL: < lets a
    replayed version re-apply."""
    project = project_at({"rl/distributed/fanout": """
        class WeightFanout:
            def bad(self, version):
                if version < self._version:
                    raise ValueError("stale")
                self._version = version

            def good(self, version):
                if version <= self._version:
                    raise ValueError("stale or replayed")
                self._version = version
    """})
    found = run_checker(fence_safety.check, project)
    assert [f.symbol for f in found] == ["WeightFanout.bad"]
    assert "equal must be REJECTED" in found[0].message


# ----------------------------------------- epoch-not-threaded


def test_epoch_not_threaded_tp_tn():
    project = project_at({"fix/snapshots": """
        class ServeController:
            def bad(self, stub, v):
                snap = {"replicas": []}
                r = stub.psub_publish("ch", "k", snap, v, self._epoch)
                return r

            def good(self, stub, v):
                snap = {"epoch": self._epoch, "replicas": []}
                r = stub.psub_publish("ch", "k", snap, v, self._epoch)
                return r

            def opaque(self, stub, v, snap):
                # non-literal payloads are not evidence either way
                r = stub.psub_publish("ch", "k", snap, v, self._epoch)
                return r
    """})
    found = run_checker(fence_safety.check, project)
    assert [(f.rule, f.symbol) for f in found] == [
        (rules.FENCE_EPOCH_NOT_THREADED, "ServeController.bad")]


# ================================================= donation-aliasing


DONATED_ENGINE = """
    import numpy as np
    import jax.numpy as jnp
    from jax import jit

    def step_fn(params, cache, toks):
        return toks, cache

    class Eng:
        def __init__(self):
            self._decode = jit(step_fn, donate_argnums=(1,))
            self._compiled = set()

        def _dispatch_fresh(self, key, call):
            self._compiled.add(key)
            return call()

        def bad(self, toks):
            logits, self.cache = self._decode(self.params, self.cache,
                                              toks)
            return logits

        def good(self, toks):
            logits, self.cache = self._dispatch_fresh(
                ("decode",),
                lambda: self._decode(self.params, self.cache, toks))
            return logits
"""


def test_donation_unguarded_dispatch_tp_tn():
    project = project_at({"fix/engine": DONATED_ENGINE})
    found = run_checker(donation_safety.check, project)
    assert [(f.rule, f.symbol) for f in found] == [
        (rules.DONATION_UNGUARDED, "Eng.bad")]
    assert "_dispatch_fresh" in found[0].message


def test_donation_asarray_alias_tp_tn():
    """np.asarray over a dispatch-result local or donated device state
    is a host VIEW the next donated dispatch clobbers; np.array (copy)
    and device-side jnp.asarray are both fine."""
    project = project_at({"fix/engine2": DONATED_ENGINE + """
        def alias_local(self):
            out, self.cache = self._dispatch_fresh(
                ("d",),
                lambda: self._decode(self.params, self.cache, 0))
            return np.asarray(out)

        def alias_attr(self):
            return np.asarray(self.cache["k"])

        def copies(self):
            out, self.cache = self._dispatch_fresh(
                ("d",),
                lambda: self._decode(self.params, self.cache, 0))
            host = np.array(out)
            dev = jnp.asarray(out)
            return host, dev
    """})
    found = [f for f in run_checker(donation_safety.check, project)
             if f.rule == rules.DONATION_ASARRAY_ALIAS]
    assert {f.symbol for f in found} == {"Eng.alias_local",
                                         "Eng.alias_attr"}


def test_donation_read_after_donate_tp_tn():
    """No repo occurrence by design (every donated dispatch rebinds its
    result), so the rule is pinned synthetically: a local read again
    after riding a donated argument position fires; the same-line
    rebind ``x, c = f(c)`` is the safe idiom and stays clean."""
    project = project_at({"fix/engine3": DONATED_ENGINE + """
        def bad_read(self, cache, toks):
            logits, fresh = self._decode(self.params, cache, toks)
            return logits, cache[0]

        def good_rebind(self, cache, toks):
            logits, cache = self._decode(self.params, cache, toks)
            return logits, cache[0]
    """})
    found = [f for f in run_checker(donation_safety.check, project)
             if f.rule == rules.DONATION_READ_AFTER_DONATE]
    assert [f.symbol for f in found] == ["Eng.bad_read"]
    assert "donated argument position 1" in found[0].message


# ==================================== repo mutation fixtures
# (reverting any of the true-positive fixes fails the strict CLI run
# with the new family's finding name)


def test_mutation_multihost_discarded_reservation_put():
    """Revert the _form fix: drop the reservation-write verdict check
    back to a bare fenced-write statement -> fence-result-ignored."""
    found, graph = mutant_findings(
        fence_safety.check, "ray_tpu_torch/core/multihost.py",
        """                if not (stub.mh_group_put(self.group_id, "reservation",
                                          sub["reservation_id"],
                                          int(reg["epoch"]),
                                          timeout=dl.remaining())
                        or {}).get("ok"):
                    raise GroupEpochFenced(
                        f"reservation write for group {self.group_id} "
                        "rejected: a newer registration owns the epoch")""",
        """                stub.mh_group_put(self.group_id, "reservation",
                                  sub["reservation_id"],
                                  int(reg["epoch"]))""")
    hits = [f for f in found if f.rule == rules.FENCE_RESULT_IGNORED
            and f.path == "ray_tpu_torch/core/multihost.py"]
    assert hits and hits[0].symbol == "HostGroup._form"
    # --diff slice coverage: the finding is in the changed file's
    # slice, and absent from an unrelated file's slice.
    sliced = fence_safety.check(
        graph, emit_files={"ray_tpu_torch/core/multihost.py"})
    assert any(f.rule == rules.FENCE_RESULT_IGNORED for f in sliced)
    assert _pragma_filtered(
        fence_safety.check(graph, emit_files={"ray_tpu_torch/autopilot.py"}),
        graph.project) == []


def test_mutation_multihost_compare_flip():
    """Flip the registry's strictly-older-loses guards to <= -> every
    flipped site is an epoch-compare-direction finding."""
    found, _ = mutant_findings(
        fence_safety.check, "ray_tpu_torch/core/multihost.py",
        "if epoch < rec.epoch:", "if epoch <= rec.epoch:")
    hits = [f for f in found
            if f.rule == rules.FENCE_COMPARE_DIRECTION]
    assert len(hits) >= 1
    assert all(f.path == "ray_tpu_torch/core/multihost.py" for f in hits)


def test_mutation_controller_unfenced_save():
    """Revert the fenced checkpoint write to raw kv_put ->
    unfenced-mutation-in-fenced-class at _save_state."""
    found, _ = mutant_findings(
        fence_safety.check, "ray_tpu_torch/serve/controller.py",
        "kv_put_fenced(", "kv_put(")
    hits = [f for f in found
            if f.rule == rules.FENCE_UNFENCED_MUTATION]
    assert hits and hits[0].path == "ray_tpu_torch/serve/controller.py"
    assert "ServeController" in hits[0].message


def test_mutation_controller_snapshot_epoch_dropped():
    """Drop the routing snapshot's epoch stamp -> epoch-not-threaded
    at the _publish psub_publish site (routers would fence blind)."""
    found, _ = mutant_findings(
        fence_safety.check, "ray_tpu_torch/serve/controller.py",
        '"epoch": self._epoch,', "")
    hits = [f for f in found
            if f.rule == rules.FENCE_EPOCH_NOT_THREADED]
    assert hits and hits[0].symbol == "ServeController._publish"


# The port's engine compiles no donated program (the JAX engine's
# ``_dispatch_fresh`` was not carried), so these cases graft one onto
# the real DecodeEngine: the family must read it there, in the port's
# own file, exactly as it read the JAX engine's.
_SHUTDOWN = "    def shutdown(self) -> None:"
_DONATED_METHODS = """    def _build_donated(self, step):
        self._decode_sampled = _mesh_scoped(
            jax.jit(step, donate_argnums=(1,)))

    def _step_donated(self, tin):
        toks_dev, self.cache = self._dispatch_fresh(
            ("decode_sampled",),
            lambda: self._decode_sampled(self.params, self.cache, tin))
        toks_d = np.array(toks_dev)
        return toks_d

"""


def test_mutation_decode_unwrapped_dispatch():
    """Unwrap a donated program from its _dispatch_fresh guard ->
    donation-unguarded-dispatch (the reload footgun reopened)."""
    unguarded = _DONATED_METHODS.replace(
        """self._dispatch_fresh(
            ("decode_sampled",),
            lambda: self._decode_sampled(self.params, self.cache, tin))""",
        "self._decode_sampled(self.params, self.cache, tin)")
    guarded, _ = mutant_findings(
        donation_safety.check, "ray_tpu_torch/serve/decode.py",
        _SHUTDOWN, _DONATED_METHODS + _SHUTDOWN)
    assert [f for f in guarded if f.rule == rules.DONATION_UNGUARDED] == []
    found, graph = mutant_findings(
        donation_safety.check, "ray_tpu_torch/serve/decode.py",
        _SHUTDOWN, unguarded + _SHUTDOWN)
    hits = [f for f in found if f.rule == rules.DONATION_UNGUARDED]
    assert hits and hits[0].path == "ray_tpu_torch/serve/decode.py"
    assert "_decode_sampled" in hits[0].message
    # --diff slice coverage for the donation family
    sliced = donation_safety.check(
        graph, emit_files={"ray_tpu_torch/serve/decode.py"})
    assert any(f.rule == rules.DONATION_UNGUARDED for f in sliced)
    assert donation_safety.check(
        graph, emit_files={"ray_tpu_torch/core/multihost.py"}) == []


def test_mutation_decode_asarray_flip():
    """Flip a draft-token copy back to np.asarray ->
    donation-asarray-alias (the clobbered-tokens bug)."""
    found, _ = mutant_findings(
        donation_safety.check, "ray_tpu_torch/serve/decode.py",
        _SHUTDOWN, _DONATED_METHODS.replace(
            "toks_d = np.array(toks_dev)",
            "toks_d = np.asarray(toks_dev)") + _SHUTDOWN)
    hits = [f for f in found
            if f.rule == rules.DONATION_ASARRAY_ALIAS]
    assert hits and hits[0].path == "ray_tpu_torch/serve/decode.py"
    assert "np.array" in hits[0].message


# ======================================= collector-liveness guards


def test_fenced_site_collector_sees_the_repo():
    """The fenced-write site collector still finds the real protocol
    sites — if an API rename emptied it, the family would read clean
    while checking nothing."""
    sites = fence_safety._fenced_call_sites(_repo_graph())
    apis = {api for _c, _i, api in sites}
    assert {"kv_put_fenced", "mh_group_put", "psub_publish"} <= apis
    paths = {info.file.relpath for _c, info, _a in sites}
    assert "ray_tpu_torch/serve/controller.py" in paths
    assert "ray_tpu_torch/core/multihost.py" in paths


def test_donation_index_sees_the_repo():
    """The donation index reads the port and finds no donated program
    (the port compiles none, so the family reads no site); grafted onto
    the real decode engine, one is mapped through a _mesh_scoped-style
    wrapper."""
    index = donation_safety._Index(_repo_graph())
    assert index.owner_classes == set() and index.donated_locals == {}
    assert donation_safety.sites(_repo_graph()) == 0
    grafted = donation_safety._Index(CallGraph(repo_mutant(
        "ray_tpu_torch/serve/decode.py", _SHUTDOWN,
        _DONATED_METHODS + _SHUTDOWN)))
    assert ("ray_tpu_torch.serve.decode", "DecodeEngine") \
        in grafted.owner_classes
    attrs = {attr for (mod, cls, attr) in grafted.donated_attrs
             if mod == "ray_tpu_torch.serve.decode"}
    assert attrs == {"_decode_sampled"}


# ============================= repo-clean gates + strict-path wiring


def test_fence_family_repo_clean():
    found = _pragma_filtered(fence_safety.check(_repo_graph()),
                             _base_project())
    assert found == [], "\n".join(f.render() for f in found)


def test_donation_family_repo_clean():
    found = _pragma_filtered(donation_safety.check(_repo_graph()),
                             _base_project())
    assert found == [], "\n".join(f.render() for f in found)


def test_strict_path_covers_new_families():
    """run_analysis (the the strict CLI run path) runs both new families:
    their timings land in stats and the repo is clean through the
    full pragma/fingerprint pipeline under the EMPTY baseline."""
    findings, stats = run_analysis(
        select=sorted(FENCE_RULES | DONATION_RULES))
    assert findings == [], "\n".join(f.render() for f in findings)
    assert "fence-safety_s" in stats
    assert "donation-aliasing_s" in stats
