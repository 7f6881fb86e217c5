"""``tests/test_trace_demo.py`` on the port's trace demo
(``ray_tpu_torch/serve/trace_demo.py``), under the same name and with its
``slow`` mark: a tiny serve session through the real HTTP proxy emits a
Chrome trace that loads as JSON and is causally linked — spans from >=3
processes (client driver, proxy with its router, replica engines) with
>=1 cross-process parent/child span pair, plus engine step-timeline
slices merged into the same trace. The debug replicas run on CPU
workers (``device="cpu"``)."""

import json
import os

import pytest

from torch_fixtures import ray_start_regular  # noqa: F401


@pytest.mark.slow  # end-to-end trace demo, slow as in the reference
@pytest.mark.timeout_s(300)
def test_trace_demo_emits_causally_linked_trace(ray_start_regular,
                                                tmp_path):
    from ray_tpu_torch.serve.trace_demo import run_demo

    out = os.path.join(str(tmp_path), "serve_trace.json")
    report = run_demo(output=out, init=False, replicas=2, requests=3,
                      device="cpu")

    # run_demo already raised on any validation failure; pin the
    # acceptance specifics here too so a weakened validator can't
    # silently pass.
    assert report["spans"] >= 5
    assert len(report["span_pids"]) >= 3, report["span_pids"]
    assert report["cross_process_links"], report
    assert report["engine_slices"] >= 1
    with open(out) as f:
        trace = json.load(f)
    names = {t["name"] for t in trace if t.get("cat") == "span"}
    # The request-path span vocabulary is present end to end.
    assert any(n.startswith("http:/trace_demo") for n in names), names
    assert any(n.startswith("router:") for n in names), names
    assert "attempt" in names
    assert {"queue-wait", "decode", "engine-request"} <= names, names
    # Cross-process causality includes the proxy->replica hop.
    assert any(child.startswith("actor:")
               or parent.startswith("attempt")
               for parent, child in report["cross_process_links"]), report
