"""graftlint v3 tests: static sharding/mesh safety, topology-lease
pairing, and the generated typed RPC stubs + drift gate.

Same layering as tests/test_analysis.py / test_analysis_v2.py:

1. Per-rule TP/TN fixtures — synthetic modules fed straight to the
   checkers (no jax, no cluster).
2. Mutation fixtures on the REAL repo sources: a contraction-dim
   partition injected into DECODE_RULES, a dropped constrain anchor,
   a dropped release on _add_replica's exception path, and a handler
   signature change without stub regeneration are each caught
   statically (the acceptance criteria — no jax import anywhere here).
3. Stub generation: determinism, the checked-in module is current, and
   stub call sites feed dead-endpoint/arity checking.
4. --diff coverage + speed for the new families; per-family repo-clean
   gates.
"""

import functools
import textwrap

import pytest

from ray_tpu_torch.analysis import repo_root, run_analysis
from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis import lifetime, rpc_contract, sharding_safety, stubgen
from ray_tpu_torch.analysis.callgraph import CallGraph
from ray_tpu_torch.analysis.core import Project, SourceFile


def project_at(modules) -> Project:
    """Like test_analysis_v2.project_of, but keyed by repo-relative
    subpath ("parallel/sharding") so fixtures can land on the module
    names the rules tables point at."""
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
    """The repo parsed once for the file: mutants and clean-repo checks
    share its unmutated files (checkers never change a SourceFile)."""
    return Project.load(repo_root())


def repo_project_with(path, old, new) -> Project:
    """The real repo with ONE file's text patched — the mutation-fixture
    harness (nothing touches disk)."""
    project = _base_project()
    files = []
    hit = False
    for f in project.files:
        if f.relpath == path:
            text = f.text.replace(old, new)
            assert text != f.text, f"mutation no-op in {path}: {old!r}"
            files.append(SourceFile(f.abspath, f.relpath, text))
            hit = True
        else:
            files.append(f)
    assert hit, path
    return Project(project.root, files)


# ------------------------------------------------- sharding fixtures

SHARD_RULES = """
    DECODE_RULES = {
        "batch": "batch",
        "length": None,
        "act_embed": None,
        "embed": None,
        "heads": "model",
        "head_dim": None,
        "mlp": "model",
        "attn_heads": None,
        "mlp_hidden": None,
    }
    DEFAULT_RULES = {
        "batch": ("data", "fsdp"),
        "length": "seq",
        "act_embed": None,
        "embed": "fsdp",
        "heads": "tensor",
        "head_dim": None,
        "mlp": "tensor",
        "attn_heads": "tensor",
        "mlp_hidden": "tensor",
    }
"""

SHARD_MODEL = """
    def param_axes():
        layers = {
            "wo": ("layers", "heads", "head_dim", "embed"),
            "w_down": ("layers", "mlp", "embed"),
            "wq": ("layers", "embed", "heads", "head_dim"),
        }
        return {"layers": layers}

    def decode_param_axes():
        axes = param_axes()
        layers = axes["layers"]
        layers["wo"] = ("layers", None, None, None)
        layers["w_down"] = ("layers", None, None)
        return axes

    def anchored_layer(x, layer, att):
        att = constrain(att, ("batch", "length", "attn_heads",
                              "head_dim"))
        out = jnp.einsum("bshd,hde->bse", att, layer["wo"])
        ffn = constrain(x, ("batch", "length", "mlp_hidden"))
        down = jnp.einsum("bsm,me->bse", ffn, layer["w_down"])
        return out + down

    def projection(h, layer):
        h = constrain(h, ("batch", "length", "act_embed"))
        return jnp.einsum("bse,ehd->bshd", h, layer["wq"])
"""


def shard_project(rules_src=SHARD_RULES, extra=None):
    mods = {"parallel/sharding": rules_src, "models/llama": SHARD_MODEL}
    if extra:
        mods.update(extra)
    return project_at(mods)


def test_sharding_clean_fixture():
    found = run_checker(sharding_safety.check, shard_project())
    assert found == [], [f.render() for f in found]


def test_sharding_partitioned_contraction_tp():
    # the anchor axis now maps to a mesh axis: the w_down reduction
    # splits across the mesh -> flagged at the einsum site
    bad = SHARD_RULES.replace('"mlp_hidden": None,\n    }',
                              '"mlp_hidden": "model",\n    }', 1)
    found = run_checker(sharding_safety.check, shard_project(bad))
    assert [f.rule for f in found] == [rules.SHARDING_CONTRACTION]
    assert "mlp_hidden" in found[0].message
    assert found[0].symbol == "anchored_layer"


def test_sharding_weight_side_contraction_tp():
    # dropping the decode override leaves wo sharded over heads — the
    # WEIGHT operand itself carries the partitioned contraction dim
    model = SHARD_MODEL.replace(
        '        layers["wo"] = ("layers", None, None, None)\n', "")
    found = run_checker(
        sharding_safety.check,
        project_at({"parallel/sharding": SHARD_RULES,
                    "models/llama": model}))
    assert any(f.rule == rules.SHARDING_CONTRACTION
               and "heads" in f.message for f in found), \
        [f.render() for f in found]


def test_sharding_missing_anchor_tp():
    model = SHARD_MODEL.replace(
        '        att = constrain(att, ("batch", "length", "attn_heads",\n'
        '                              "head_dim"))\n', "")
    found = run_checker(
        sharding_safety.check,
        project_at({"parallel/sharding": SHARD_RULES,
                    "models/llama": model}))
    assert [f.rule for f in found] == [rules.SHARDING_ANCHOR]
    assert "'wo'" in found[0].message


def test_sharding_output_dim_projection_is_tn():
    # wq shards its OUTPUT dims (heads over model) — contraction is
    # embed (replicated): no finding, sharding outputs is the point
    found = run_checker(sharding_safety.check, shard_project())
    assert not any(f.symbol == "projection" for f in found)


RULE3_SRC = """
    import jax
    from ray_tpu_torch.parallel.sharding import axis_rules

    class Engine:
        def _mesh_scoped(self, fn):
            return fn

        def build(self, sh, kw):
            bad = self._mesh_scoped(jax.jit(self._impl))
            good = self._mesh_scoped(jax.jit(self._impl,
                                             out_shardings=sh))
            unknown = self._mesh_scoped(jax.jit(self._impl, **kw))
            return bad, good, unknown

        def commit(self, sh):
            with axis_rules(None, None):
                bad = jax.device_put(self.params)
                good = jax.device_put(self.params, sh)
            off_scope = jax.device_put(self.params)
            return bad, good, off_scope

        def _impl(self, x):
            return x
"""


def test_sharding_unpinned_mesh_call():
    found = run_checker(sharding_safety.check,
                        project_at({"serve/engine": RULE3_SRC}))
    by_rule = [f for f in found if f.rule == rules.SHARDING_UNPINNED]
    msgs = sorted(f.message.split(" ")[0] for f in by_rule)
    # exactly the unpinned jit in the wrapper and the placement-less
    # device_put INSIDE the scope; the **kw splat and off-scope
    # device_put are not flagged
    assert msgs == ["device_put", "jit"], [f.render() for f in found]


RULE4_SRC = """
    import jax
    from ray_tpu_torch.parallel.sharding import axis_rules

    def sharded_body(x):
        return constrain(x, ("batch",))

    def plain_body(x):
        return x + 1

    def scoped_step(x):
        with axis_rules(None, None):
            return sharded_body(x)

    def build_bad(sh):
        return jax.jit(sharded_body, out_shardings=sh)

    def build_scoped(sh):
        with axis_rules(None, None):
            return jax.jit(sharded_body, out_shardings=sh)

    def build_selfscoped(sh):
        return jax.jit(scoped_step, out_shardings=sh)

    def build_plain(sh):
        return jax.jit(plain_body, out_shardings=sh)
"""


def test_sharding_unscoped_trace():
    found = run_checker(sharding_safety.check,
                        project_at({"parallel/builders": RULE4_SRC}))
    hits = [f for f in found if f.rule == rules.SHARDING_UNSCOPED]
    # only build_bad: jit-with-shardings of a constrain-reaching body,
    # outside any scope, body does not open the scope itself
    assert [f.symbol for f in hits] == ["build_bad"], \
        [f.render() for f in found]


# ------------------------------------------------- topology leases

LEASE_SRC = """
    class Controller:
        def leaky(self, client, rid):
            sub = client.call("reserve_subslice", rid, 4)
            self.spawn(sub["nodes"])
            self.record(sub)

        def guarded(self, client, rid):
            sub = client.call("reserve_subslice", rid, 4)
            if sub is None:
                self.log_refusal(rid)
                return False
            try:
                self.spawn(sub["nodes"])
            except Exception:
                client.call("release_subslice", sub["reservation_id"])
                raise
            self.record(sub)
            return True

        def released_via_helper(self, client, rid):
            sub = client.call("reserve_subslice", rid, 4)
            try:
                self.spawn(sub["nodes"])
            except Exception:
                self._drop_lease(sub["reservation_id"])
                raise
            self.record(sub)

        def settled_normally(self, client, rid):
            sub = client.call("reserve_subslice", rid, 4)
            self.record(sub)
            return True

        def _drop_lease(self, reservation_id):
            self.client.call("release_subslice", reservation_id)
"""


def test_lease_leak_on_exception_path():
    found = run_checker(lifetime.check,
                        project_at({"serve/ctl": LEASE_SRC}))
    assert [f.symbol for f in found] == ["Controller.leaky"]
    assert found[0].rule == rules.RESOURCE_LEAK
    assert "reserve_subslice" in found[0].message
    assert "escaping exception" in found[0].message


def test_lease_clean_idioms():
    """None-guard pruning, release in the handler (direct or through a
    self.-callee resolved over the call graph), bare-arg handoff, and
    a lease surviving a NORMAL exit (record-owned) are all clean."""
    found = run_checker(lifetime.check,
                        project_at({"serve/ctl": LEASE_SRC}))
    assert all(f.symbol == "Controller.leaky" for f in found), \
        [f.render() for f in found]


def test_lease_stub_spelling_recognized():
    src = """
        class Controller:
            def leaky(self, stub, rid):
                sub = stub.reserve_subslice(rid, 4)
                self.spawn(sub["nodes"])
                self.record(sub)

            def clean(self, stub, rid):
                sub = stub.reserve_subslice(rid, 4)
                try:
                    self.spawn(sub["nodes"])
                except Exception:
                    stub.release_subslice(sub["reservation_id"])
                    raise
                self.record(sub)
    """
    found = run_checker(lifetime.check, project_at({"serve/ctl": src}))
    assert [f.symbol for f in found] == ["Controller.leaky"]


# ------------------------------------------- mutation fixtures (repo)

def test_mutation_decode_rules_partition_caught():
    """Acceptance: a contraction-dim partition injected into the REAL
    DECODE_RULES is caught statically, no torch import."""
    project = repo_project_with(
        "ray_tpu_torch/parallel/sharding.py",
        '"vocab": "model",\n    "embed": None,',
        '"vocab": "model",\n    "embed": "model",')
    found = run_checker(sharding_safety.check, project)
    hits = [f for f in found if f.rule == rules.SHARDING_CONTRACTION]
    assert hits, [f.render() for f in found]
    # fires at the real projections the decode programs run (the port's
    # llama_decode calls llama.py's qkv / mlp_hidden / logits_f32)
    assert {"qkv", "mlp_hidden", "logits_f32"} <= {f.symbol for f in hits}
    assert all(f.path == "ray_tpu_torch/models/llama.py" for f in hits)


def test_mutation_dropped_anchor_caught():
    project = repo_project_with(
        "ray_tpu_torch/models/llama.py",
        '    attn = gather_local(attn, 2, "heads")\n',
        '')
    found = run_checker(sharding_safety.check, project)
    hits = [f for f in found if f.rule == rules.SHARDING_ANCHOR]
    # out_proj is shared by the contiguous and paged decode steps: its
    # wo reduction loses its pre-contraction gather
    assert sorted({f.symbol for f in hits}) == ["out_proj"], \
        [f.render() for f in found]


def test_mutation_verify_rules_partition_caught():
    """Acceptance: sharding the wo-contraction axis in the REAL decode
    tables is caught at the projection the speculative verify forward
    shares with the decode steps — the spec-mode verify program sits
    under the same bit-exactness contract."""
    project = repo_project_with(
        "ray_tpu_torch/models/llama.py",
        'layers["wo"] = ("layers", None, None, None)',
        'layers["wo"] = ("layers", "heads", None, None)')
    found = run_checker(sharding_safety.check, project)
    hits = [f for f in found if f.rule == rules.SHARDING_CONTRACTION]
    assert hits, [f.render() for f in found]
    assert any(f.symbol == "out_proj" for f in hits), \
        sorted({f.symbol for f in hits})


def test_mutation_verify_dropped_anchor_caught():
    """The mlp gather before w_down is shared by the contiguous suffix,
    paged suffix and spec verify forwards: dropping it loses the pre-
    w_down anchor in all three (one site, ``_down``)."""
    project = repo_project_with(
        "ray_tpu_torch/models/llama.py",
        '    ffn = gather_local(ffn, -1, "mlp")'
        '  # ``w_down`` contracts the mlp dim\n',
        '')
    found = run_checker(sharding_safety.check, project)
    hits = [f for f in found if f.rule == rules.SHARDING_ANCHOR]
    assert sorted({f.symbol for f in hits}) == ["_down"], \
        [f.render() for f in found]


def test_spec_programs_clean_under_decode_rules():
    """TN: the unmutated verify / draft / device-sampler programs carry
    their anchors and contract only unsharded axes — no sharding
    findings anywhere in the decode model module."""
    found = run_checker(sharding_safety.check,
                        _base_project())
    bad = [f for f in found
           if f.path == "ray_tpu_torch/models/llama_decode.py"
           and f.rule in (rules.SHARDING_CONTRACTION,
                          rules.SHARDING_ANCHOR)]
    assert bad == [], "\n".join(f.render() for f in bad)


def test_mutation_dropped_lease_release_caught():
    """Acceptance: removing _add_replica's exception-path release is a
    repo-blocking finding (the reserve-then-spawn leak)."""
    project = repo_project_with(
        "ray_tpu_torch/serve/controller.py",
        """        except Exception:
            if sub is not None:
                self._release_reservation(sub["reservation_id"],
                                          replica_id)
            raise""",
        """        except Exception:
            raise""")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.RESOURCE_LEAK
            and f.symbol == "ServeController._add_replica"]
    assert len(hits) == 1, [f.render() for f in found]
    assert "reserve_subslice" in hits[0].message


def test_mutation_gang_dropped_subslice_release_caught():
    """Acceptance: HostGroup._form's partial-spawn cleanup
    must hand the sub-slice back on every exception path — removing
    the release from _abort_formation is the _add_replica leak shape
    at GANG granularity, and a repo-blocking finding."""
    project = repo_project_with(
        "ray_tpu_torch/core/multihost.py",
        "            stub.release_subslice(reservation_id,\n"
        "                                  timeout=config.ctrl_call_timeout_s)\n",
        "            pass\n")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.RESOURCE_LEAK
            and f.symbol == "HostGroup._form"]
    assert len(hits) == 1, [f.render() for f in found]
    assert "reserve_subslice" in hits[0].message


def test_mutation_gang_dropped_group_drop_caught():
    """The mh_register_group -> mh_drop_group lease pair (rules
    extension): a partial spawn that stops dropping the half-created
    group record leaks it (and its fencing epoch) — caught statically
    through the _abort_formation self-callee chain."""
    project = repo_project_with(
        "ray_tpu_torch/core/multihost.py",
        """            stub.mh_drop_group(self.group_id,
                               timeout=config.ctrl_call_timeout_s)
        except Exception:
            log_every("multihost.abort_drop\"""",
        """            pass
        except Exception:
            log_every("multihost.abort_drop\"""")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.RESOURCE_LEAK
            and f.symbol == "HostGroup._form"]
    assert len(hits) == 1, [f.render() for f in found]
    assert "mh_register_group" in hits[0].message


def test_gang_lease_repo_clean():
    """TN: the real multihost module discharges both gang leases on
    every exception path (release through the _abort_formation
    self-callee, ownership handoff via _commit_formation)."""
    found = run_checker(lifetime.check, _base_project())
    assert [f for f in found
            if f.path == "ray_tpu_torch/core/multihost.py"] == []


def test_mutation_dropped_checkpoint_save_caught():
    """Acceptance: a state-mutating ServeController handler
    that stops reaching _save_state before returning is a repo-blocking
    finding — the mutation would be invisible to a restarted
    controller."""
    project = repo_project_with(
        "ray_tpu_torch/serve/controller.py",
        """            self._routes[prefix] = name
        self._save_state()""",
        """            self._routes[prefix] = name""")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.CHECKPOINT_MISSING]
    assert [f.symbol for f in hits] == ["ServeController.set_route"], \
        [f.render() for f in found]
    assert "_save_state" in hits[0].message


def test_mutation_deploy_checkpoint_not_discharged_by_callees():
    """deploy reaches _kill_replica, whose transitive _save_state lives
    on an EXCEPTION path (queued-release checkpoint) — that must not
    count as deploy having checkpointed: drop deploy's own save and the
    rule still fires."""
    project = repo_project_with(
        "ray_tpu_torch/serve/controller.py",
        """        version = self._publish(rec)
        self._save_state()
        return version""",
        """        version = self._publish(rec)
        return version""")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.CHECKPOINT_MISSING]
    assert [f.symbol for f in hits] == ["ServeController.deploy"], \
        [f.render() for f in found]


def test_checkpoint_discharged_via_self_callee_wrapper():
    """TN: routing the save through a self.-callee wrapper (the
    summary fixpoint's via-self hop) discharges the obligation."""
    project = repo_project_with(
        "ray_tpu_torch/serve/controller.py",
        """            self._routes[prefix] = name
        self._save_state()""",
        """            self._routes[prefix] = name
        self._checkpoint_now()

    def _checkpoint_now(self):
        self._save_state()""")
    found = run_checker(lifetime.check, project)
    assert not [f for f in found if f.rule == rules.CHECKPOINT_MISSING
                and f.symbol == "ServeController.set_route"], \
        [f.render() for f in found]


def test_repo_clean_checkpoint_rule():
    """Every listed ServeController handler reaches _save_state today."""
    project = _base_project()
    found = run_checker(lifetime.check, project)
    assert not [f for f in found
                if f.rule == rules.CHECKPOINT_MISSING], \
        [f.render() for f in found]


def test_mutation_handler_signature_drift_caught():
    """Acceptance: a handler signature change without --gen-stubs fails
    the drift gate."""
    project = repo_project_with(
        "ray_tpu_torch/core/controller.py",
        "    def topology_state(self) -> Dict[str, Any]:",
        "    def topology_state(self, verbose: bool = False"
        ") -> Dict[str, Any]:")
    graph = CallGraph(project)
    found = stubgen.check(graph)
    assert [f.rule for f in found] == [rules.RPC_STUB_DRIFT]
    assert found[0].path == "ray_tpu_torch/core/rpc_stubs.py"


# ------------------------------------------------- generated stubs

@pytest.mark.slow  # 9s: double full-repo stub gen; drift stays gated
# via test_repo_clean_rpc_stubs + the CLI's strict run
def test_stub_generation_deterministic_and_current():
    project = Project.load(repo_root())
    a = stubgen.generate(CallGraph(project))
    b = stubgen.generate(CallGraph(Project.load(repo_root())))
    assert a == b
    on_disk = project.by_module["ray_tpu_torch.core.rpc_stubs"].text
    assert a == on_disk, "stubs drifted: run --gen-stubs"


def test_stub_module_importable_and_trims_unset():
    from ray_tpu_torch.core.rpc_stubs import ControllerStub, NodeStub, _UNSET

    calls = []

    class FakeClient:
        def call(self, method, *args, **kwargs):
            calls.append((method, args, kwargs))
            return "ok"

    stub = ControllerStub(FakeClient())
    assert stub.reserve_subslice("owner", 4) == "ok"
    method, args, kwargs = calls[-1]
    assert method == "reserve_subslice"
    assert args == ("owner", 4)
    assert kwargs == {}  # omitted optionals never hit the wire
    stub.reserve_subslice("owner", 4, [2, 2], timeout=5.0)
    method, args, kwargs = calls[-1]
    assert kwargs == {"shape": [2, 2], "timeout": 5.0}
    # required-arity errors fail AT THE CALL SITE, in Python
    with pytest.raises(TypeError):
        stub.reserve_subslice("owner")
    NodeStub(FakeClient()).kill_worker(b"wid", True, timeout=2.0)
    method, args, kwargs = calls[-1]
    assert (method, args) == ("kill_worker", (b"wid",))
    assert kwargs == {"force": True, "timeout": 2.0}
    assert _UNSET is not None


STUB_CONTRACT_FIXTURE = {
    "core/rpc_stubs": """
        _UNSET = object()

        class _StubBase:
            def __init__(self, client):
                self._client = client

            def _call(self, method, *args, timeout=_UNSET, **kwargs):
                return self._client.call(method, *args, **kwargs)

        class ControllerStub(_StubBase):
            def echo(self, x, *, timeout=_UNSET):
                return self._call('echo', x, timeout=timeout)

            def dead_one(self, *, timeout=_UNSET):
                return self._call('dead_one', timeout=timeout)
    """,
    "core/ctl": """
        class Controller:
            def __init__(self):
                self._srv = RpcServer(handlers={
                    "echo": self.echo,
                    "dead_one": self.dead,
                })

            def echo(self, x):
                return x

            def dead(self):
                return None

        class RpcServer:
            def __init__(self, handlers):
                self.handlers = handlers
    """,
    "user": """
        from ray_tpu_torch.core.rpc_stubs import ControllerStub

        def chained(client):
            return ControllerStub(client).echo(1)

        def aliased(client):
            st = ControllerStub(client)
            return st.echo(1, 2)
    """,
}


def test_stub_sites_feed_contract_checking():
    found = run_checker(rpc_contract.check,
                        project_at(STUB_CONTRACT_FIXTURE))
    # echo is alive through stub sites (chained + aliased receivers);
    # dead_one's only literal spelling is the stub's own forwarding,
    # which must NOT count — it stays dead
    dead = [f for f in found if f.rule == rules.RPC_DEAD]
    assert [f.message.split('"')[1] for f in dead] == ["dead_one"]
    # the aliased site passes 2 args to a 1-arg handler: arity finding
    # AT the stub call site
    arity = [f for f in found if f.rule == rules.RPC_ARITY]
    assert len(arity) == 1 and arity[0].symbol == "aliased"


def test_gen_stubs_cli(tmp_path, capsys):
    from ray_tpu_torch.analysis.__main__ import main

    out = tmp_path / "stubs.py"
    assert main(["--gen-stubs", str(out)]) == 0
    capsys.readouterr()
    disk = open(repo_root() + "/ray_tpu_torch/core/rpc_stubs.py").read()
    assert out.read_text() == disk


# ------------------------------------------- --diff + speed coverage

def test_diff_mode_covers_new_families():
    """emit_files-restricted runs keep whole-program indexes (the rule
    tables and handler index span the package) and still surface
    findings in the changed file."""
    project = repo_project_with(
        "ray_tpu_torch/parallel/sharding.py",
        '"vocab": "model",\n    "embed": None,',
        '"vocab": "model",\n    "embed": "model",')
    graph = CallGraph(project)
    # the mutation is in sharding.py but fires at model call sites:
    # a diff slice containing the MODEL file reports it
    found = sharding_safety.check(
        graph, emit_files={"ray_tpu_torch/models/llama.py"})
    assert found and all(f.path == "ray_tpu_torch/models/llama.py"
                         for f in found)
    # stub drift emits only when the stub module is in the slice
    drift_project = repo_project_with(
        "ray_tpu_torch/core/controller.py",
        "    def topology_state(self) -> Dict[str, Any]:",
        "    def topology_state(self, verbose: bool = False"
        ") -> Dict[str, Any]:")
    g2 = CallGraph(drift_project)
    assert stubgen.check(g2, emit_files={"ray_tpu_torch/core/rpc.py"}) == []
    assert stubgen.check(
        g2, emit_files={"ray_tpu_torch/core/rpc_stubs.py"}) != []


def test_diff_one_file_stays_fast():
    """Speed gate extension: a one-file --diff run with ALL families
    (indexes still whole-program) stays fast. Budgeted, like
    test_full_run_is_fast, on the run's CPU seconds: the tier-1 suite
    runs this gate mid-suite under heavy contention, where a wall-clock
    budget measures the neighbours."""
    findings, stats = run_analysis(
        emit_files={"ray_tpu_torch/serve/controller.py"})
    assert findings == [], "\n".join(f.render() for f in findings)
    assert stats["cpu_s"] < 12.0, stats


# --------------------------------------- per-family repo-clean gates

def _clean_under(select):
    from ray_tpu_torch.analysis import Baseline, DEFAULT_BASELINE

    findings, _ = run_analysis(select=select)
    baseline = Baseline.load(DEFAULT_BASELINE)
    new, _baselined, _stale = baseline.split(findings)
    return new


def test_repo_clean_sharding_safety():
    new = _clean_under([rules.SHARDING_CONTRACTION,
                        rules.SHARDING_ANCHOR,
                        rules.SHARDING_UNPINNED,
                        rules.SHARDING_UNSCOPED])
    assert new == [], "\n".join(f.render() for f in new)


def test_repo_clean_rpc_stubs():
    new = _clean_under([rules.RPC_STUB_DRIFT])
    assert new == [], "\n".join(f.render() for f in new)


def test_sharding_tables_actually_parsed():
    """Collector-liveness guard: if table parsing silently broke, the
    contraction rule would go quiet instead of loud."""
    project = _base_project()
    tables = sharding_safety.load_rule_tables(project)
    assert set(rules.SHARDING_BITEXACT_TABLES) <= set(tables)
    decode = tables["DECODE_RULES"][0]
    assert decode["attn_heads"] is None and decode["mlp_hidden"] is None
    train, dec = sharding_safety.load_param_axes(project)
    row_par = sharding_safety.row_parallel_weights(
        train, dec, tables[rules.SHARDING_TRAIN_TABLE][0])
    assert row_par == {"wo", "w_down"}


def test_stub_groups_cover_all_servers():
    graph = CallGraph(_base_project())
    groups = stubgen.stub_groups(graph)
    assert {"Controller", "Node", "CoreWorker",
            "ClientServer"} <= set(groups)
    ctl = dict(groups["Controller"])
    assert "reserve_subslice" in ctl and "release_subslice" in ctl


# ---------------------------------------- pipeline-plane idioms


def test_borrow_ref_pair_tp_tn():
    """The RESOURCE_METHOD_PAIRS borrow_ref -> drop_ref extension: a
    borrowed activation descriptor surviving an escaping exception is
    flagged; the finally-discharged twin is clean."""
    src = """
        class Stage:
            def leaky(self, desc):
                self._ledger.borrow_ref(desc)
                value = self.pull(desc)
                self._ledger.drop_ref(desc)
                return value

            def clean(self, desc):
                self._ledger.borrow_ref(desc)
                try:
                    return self.pull(desc)
                finally:
                    self._ledger.drop_ref(desc)
    """
    found = run_checker(lifetime.check,
                        project_at({"train/pipe_fix": src}))
    assert [f.symbol for f in found] == ["Stage.leaky"]
    assert "borrow_ref" in found[0].message


def test_mutation_stage_pull_dropped_release_caught():
    """Acceptance: turning StageActor._pull's finally-drop
    into a straight-line drop leaves the activation ref live across
    the fallible object-plane get — the _add_replica leak shape for
    ObjectRefs, caught statically."""
    project = repo_project_with(
        "ray_tpu_torch/train/pipeline_plane.py",
        """        ref = self._ledger.borrow_ref(desc)
        try:
            return _owned(rt.get(ref, timeout=60.0), self._device)
        finally:
            self._ledger.drop_ref(desc)""",
        """        ref = self._ledger.borrow_ref(desc)
        out = _owned(rt.get(ref, timeout=60.0), self._device)
        self._ledger.drop_ref(desc)
        return out""")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.RESOURCE_LEAK
            and f.symbol == "StageActor._pull"]
    assert len(hits) == 1, [f.render() for f in found]
    assert "borrow_ref" in hits[0].message


def test_mutation_pipeline_record_drop_caught():
    """The pipe_register -> pipe_drop lease pair: a formation abort
    that stops dropping the half-created pipeline record leaks it (and
    its fencing epoch) — caught through the _abort_formation
    self-callee chain."""
    project = repo_project_with(
        "ray_tpu_torch/train/pipeline_plane.py",
        """            stub.pipe_drop(self.name, timeout=_cfg.ctrl_call_timeout_s)
        except Exception:
            log_every("pipeline.abort_drop\"""",
        """            pass
        except Exception:
            log_every("pipeline.abort_drop\"""")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.RESOURCE_LEAK
            and f.symbol == "PipelinePlane._form_record"]
    assert len(hits) == 1, [f.render() for f in found]
    assert "pipe_register" in hits[0].message


def test_pipeline_plane_lifetime_repo_clean():
    """TN: the real pipeline plane discharges every activation ref and
    the pipeline record on every exception path."""
    found = run_checker(lifetime.check, _base_project())
    assert [f for f in found
            if f.path == "ray_tpu_torch/train/pipeline_plane.py"] == []


def test_mutation_zero1_rules_partition_caught():
    """Acceptance: editing ZERO1_STATE_RULES to shard a
    MODEL axis over the data axis would partition contraction dims of
    the traced step — caught statically at the real einsum sites, no
    jax import."""
    project = repo_project_with(
        "ray_tpu_torch/parallel/sharding.py",
        """ZERO1_STATE_RULES: Rules = {
    "zero1_shard": "data",
}""",
        """ZERO1_STATE_RULES: Rules = {
    "zero1_shard": "data",
    "embed": "data",
}""")
    found = run_checker(sharding_safety.check, project)
    hits = [f for f in found if f.rule == rules.SHARDING_CONTRACTION
            and "ZERO1_STATE_RULES" in f.message]
    assert hits, [f.render() for f in found]
    assert any(f.path == "ray_tpu_torch/models/llama.py" for f in hits)


def test_zero1_table_parsed_and_state_only():
    """Collector-liveness guard for the ZeRO-1 table: it parses, maps
    the state-only axis to the data mesh axis, and names NO model
    axis (the property the mutation above breaks)."""
    project = _base_project()
    tables = sharding_safety.load_rule_tables(project)
    z1 = tables["ZERO1_STATE_RULES"][0]
    assert z1 == {"zero1_shard": "data"}


# ----------------------------- KV-page handoff lease (disagg)


def test_publish_handoff_pair_tp_tn():
    """The RESOURCE_METHOD_PAIRS publish_handoff -> discharge_handoff
    extension: a published handoff surviving an escaping exception is
    flagged; the guarded twin is clean — INCLUDING its normal exit,
    where the live lease is the design (the returned descriptor
    transfers the discharge obligation to the router splice)."""
    src = """
        class Prefill:
            def leaky(self, desc):
                self._handoffs.publish_handoff(desc)
                self.observe(desc)
                self._handoffs.discharge_handoff(desc["handoff_id"])

            def clean(self, desc):
                self._handoffs.publish_handoff(desc)
                try:
                    self.observe(desc)
                except BaseException:
                    self._handoffs.discharge_handoff(
                        desc["handoff_id"])
                    raise
                return desc
    """
    found = run_checker(lifetime.check,
                        project_at({"serve/handoff_fix": src}))
    assert [f.symbol for f in found] == ["Prefill.leaky"]
    assert "publish_handoff" in found[0].message


def test_mutation_prefill_handoff_dropped_discharge_caught():
    """Acceptance: un-guarding prefill_handoff's publish
    tail leaves the lease live across the fallible metrics observation
    — the refs (and the pinned KV pages behind them) leak on a raise
    until the TTL sweep. Caught statically through the _drop_handoff
    self-callee chain."""
    project = repo_project_with(
        "ray_tpu_torch/serve/decode.py",
        """        self._handoffs.publish_handoff(desc)
        try:
            self._observe_handoff_published(desc)
        except BaseException:
            # The lease must not outlive a failed publish tail: hand the
            # refs back before the error escapes.
            self._drop_handoff(desc["handoff_id"], "aborted")
            raise
        return desc""",
        """        self._handoffs.publish_handoff(desc)
        self._observe_handoff_published(desc)
        self._drop_handoff(desc["handoff_id"], "aborted")
        return desc""")
    found = run_checker(lifetime.check, project)
    hits = [f for f in found if f.rule == rules.RESOURCE_LEAK
            and f.symbol == "LlamaDecodeDeployment.prefill_handoff"]
    assert len(hits) == 1, [f.render() for f in found]
    assert "publish_handoff" in hits[0].message


def test_handoff_lifetime_repo_clean():
    """TN: the real handoff plumbing (publish/adopt/abort/sweep across
    decode.py and deployment.py) discharges the lease on every
    exception path."""
    found = run_checker(lifetime.check, _base_project())
    assert [f for f in found
            if f.path in ("ray_tpu_torch/serve/decode.py",
                          "ray_tpu_torch/serve/deployment.py",
                          "ray_tpu_torch/serve/handoff.py")] == []


# ------------------------------------- autopilot action idiom


def _run_autopilot_lint(project):
    from ray_tpu_torch.analysis import autopilot_lint

    findings = autopilot_lint.check_project(project)
    by_rel = {f.relpath: f for f in project.files}
    return [f for f in findings
            if not by_rel[f.path].suppressed(f.rule, f.line)]


def test_autopilot_unpaired_action_tp():
    """TP: an _act_* handler missing the fence, the audit, or both is
    flagged with the missing call(s) named."""
    project = project_at({"autopilot": """
        class Autopilot:
            def _act_no_audit(self, finding, epoch):
                if not self._fence_ok("taint-host", True):
                    return None
                return self._do_it(finding)

            def _act_no_fence(self, finding, epoch):
                return self._audit(finding, "shed-tenant", "d",
                                   "applied")

            def _act_neither(self, finding, epoch):
                return self._do_it(finding)
        """})
    findings = _run_autopilot_lint(project)
    assert len(findings) == 3
    assert all(f.rule == rules.AUTOPILOT_UNPAIRED for f in findings)
    by_sym = {f.symbol.rsplit(".", 1)[-1]: f.message for f in findings}
    assert "_audit" in by_sym["_act_no_audit"]
    assert "_fence_ok" in by_sym["_act_no_fence"]
    assert "_fence_ok" in by_sym["_act_neither"] \
        and "_audit" in by_sym["_act_neither"]


def test_autopilot_unpaired_action_tn():
    """TN: paired handlers pass; helper methods without the action
    prefix, module-level _act_-named functions (no class = not a
    handler), other modules, and a pragma'd site are all quiet."""
    project = project_at({"autopilot": """
        class Autopilot:
            def _act_good(self, finding, epoch):
                if not self._fence_ok("reschedule-gang", True):
                    return self._audit(finding, "reschedule-gang",
                                       "g", "stale-epoch")
                return self._audit(finding, "reschedule-gang", "g",
                                   "applied")

            def _decide(self, finding):
                return self._handlers["taint-host"](finding)

            # graftlint: disable=autopilot-unpaired-action (test fixture)
            def _act_pragma(self, finding, epoch):
                return None

        def _act_free_function(finding):
            return None
        """, "other_module": """
        class NotTheAutopilot:
            def _act_elsewhere(self, finding):
                return None
        """})
    assert _run_autopilot_lint(project) == []


def test_mutation_autopilot_dropped_fence_caught():
    """Mutation fixture: neutering the resize handler's fence check in
    the REAL autopilot.py is caught statically."""
    project = repo_project_with(
        "ray_tpu_torch/autopilot.py",
        'if not self._fence_ok("resize-deployment",',
        'if not (lambda *_a: True)("resize-deployment",')
    findings = _run_autopilot_lint(project)
    hits = [f for f in findings
            if f.symbol.endswith("_act_resize_deployment")]
    assert len(hits) == 1, [f.render() for f in findings]
    assert "_fence_ok" in hits[0].message


def test_repo_clean_autopilot():
    new = _clean_under([rules.AUTOPILOT_UNPAIRED])
    assert new == [], "\n".join(f.render() for f in new)
