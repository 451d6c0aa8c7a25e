"""Port parity: request tracing and the phase histogram
(``llm_d_tpu_torch.utils.tracing``, the engine's ``_trace_phase`` and
``engine.step`` spans, the server's ``server.request`` span and
``/debug/traces``) against the JAX package, on the CPU.

* The same requests through the JAX engine and the port's (``tiny``, the
  JAX engine's weights and drafter carried across) under one root trace
  context: through the classic step, 4-step async decode blocks and the
  everything-on dispatch (spec K = 4, N = 4 rounds, async), the engines
  record the same spans (names, phases, parents, attributes), the same
  tokens, and the same ``llmd_tpu:request_phase_seconds`` counts per
  (phase, criticality).  A traced request's tokens equal an untraced
  one's on the same prompt, and the untraced one records no span.
* ``LLMD_TRACE=0``: nothing is recorded and the tokens are unchanged.
* The paired servers (``test_torch_server._Pair``): each request's
  ``/debug/traces`` JSONL holds one connected trace (no orphans by
  ``scripts/trace_report.py``'s ``find_orphans``) with the JAX server's
  span names; a ``traceparent`` header parents the port's spans;
  ``?drain=1`` empties the rings.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import requests

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu.utils import tracing as jtracing
from llm_d_tpu.utils.metrics import parse_prometheus_text
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.utils import tracing as ttracing
from test_torch_server import TIMEOUT, _Pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_KW = dict(model="tiny", block_size=4, num_blocks=64, max_num_seqs=8,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4)
MODES = {
    "classic": {},
    "blocks": dict(num_scheduler_steps=4, async_scheduling=True),
    "everything_on": dict(spec_k=4, num_scheduler_steps=4,
                          async_scheduling=True),
}
PHASE = "llmd_tpu:request_phase_seconds_count"


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_report = _load_script("trace_report")


@pytest.fixture(autouse=True)
def _fresh_tracers(monkeypatch):
    """Both packages' tracer registries empty, tracing fully on."""
    for name in ("LLMD_TRACE", "LLMD_TRACE_SAMPLE", "LLMD_TRACE_BUFFER"):
        monkeypatch.delenv(name, raising=False)
    jtracing.reset()
    ttracing.reset()
    yield
    jtracing.reset()
    ttracing.reset()


def _tree(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _requests(R, SP, tracing):
    """A traced request, an untraced one on the same prompt, and a traced
    critical one; the traced ones under one root context."""
    root = tracing.TraceContext("a" * 32, "b" * 16, True)

    def req(rid, prompt, n, **kw):
        return R(request_id=rid, prompt_token_ids=list(prompt),
                 sampling=SP(temperature=0.0, max_tokens=n,
                             ignore_eos=True), **kw)

    reqs = [req("traced", [1, 5, 9, 200, 3], 9),
            req("plain", [1, 5, 9, 200, 3], 9),
            req("crit", list(range(40, 51)), 6, criticality="critical")]
    reqs[0].trace_ctx = reqs[2].trace_ctx = root
    return reqs


def _spans(tracing):
    """The engine's spans without their timing and own ids, sorted."""
    out = []
    for s in tracing.get_tracer("engine").snapshot():
        out.append(repr((s["name"], s["trace"], s["parent"],
                         sorted((s.get("attrs") or {}).items()))))
    return sorted(out)


def _phase_counts(text):
    return {k: v for k, v in parse_prometheus_text(text).items()
            if k.startswith(PHASE + "{")}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_spans_and_phases_equal_the_jax_engine(mode):
    kw = dict(ENGINE_KW, **MODES[mode])
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=_tree(jeng.params),
                      draft_params=(_tree(jeng.draft_params)
                                    if jeng.draft_params is not None
                                    else None))
    want = jeng.generate(_requests(JRequest, JSamplingParams, jtracing))
    got = teng.generate(_requests(Request, SamplingParams, ttracing))
    assert got == want
    assert got["traced"] == got["plain"] and len(got["traced"]) == 9
    tspans, jspans = _spans(ttracing), _spans(jtracing)
    assert tspans == jspans
    names = {eval(s)[0] for s in tspans}
    assert names == {"engine.queue", "engine.prefill", "engine.decode",
                     "engine.step"}
    # Every span joins the root trace; the untraced request has none.
    assert all(eval(s)[1:3] == ("a" * 32, "b" * 16) for s in tspans)
    assert not any(("request_id", "plain") in eval(s)[3] for s in tspans)
    steps = [dict(eval(s)[3]) for s in tspans if "engine.step" in s]
    if mode == "blocks":
        assert any(st["fused"] == 4 and st["kind"] == "decode"
                   for st in steps)
    if mode == "everything_on":
        assert any(st.get("spec") and st["fused"] == 4 for st in steps)
    # The phase histogram counts traced and untraced requests alike.
    tc = _phase_counts(teng.metrics.render().decode())
    assert tc == _phase_counts(jeng.metrics.render().decode())

    def count(phase, criticality):
        return sum(v for k, v in tc.items() if f'phase="{phase}"' in k
                   and f'criticality="{criticality}"' in k)

    assert count("decode", "standard") == 2
    assert count("prefill", "critical") == count("queue", "critical") == 1


def test_tracing_off_records_nothing_and_keeps_the_tokens(monkeypatch):
    reqs = _requests(Request, SamplingParams, ttracing)
    eng = EngineCore(EngineConfig(device="cpu", **ENGINE_KW))
    on = eng.generate(reqs)
    assert ttracing.get_tracer("engine").snapshot()
    monkeypatch.setenv("LLMD_TRACE", "0")
    ttracing.reset()
    eng = EngineCore(EngineConfig(device="cpu", **ENGINE_KW),
                     params=eng.params)
    off = eng.generate(_requests(Request, SamplingParams, ttracing))
    assert off == on
    assert ttracing.get_tracer("engine").snapshot() == []


def _traces(text):
    by_trace = {}
    for s in trace_report.load_trace_lines(text.splitlines()):
        by_trace.setdefault(s["trace"], []).append(s)
    return by_trace


def test_debug_traces_of_paired_servers_are_connected():
    pair = _Pair("tiny")
    try:
        body = dict(model="m", prompt=[3, 1, 4, 1, 5], max_tokens=5,
                    temperature=0.0, ignore_eos=True)
        for stream in (False, True):
            pair.both("POST", "/v1/completions",
                      json=dict(body, stream=stream))
        j, t = pair.both("GET", "/debug/traces")
        assert t.status_code == j.status_code == 200
        assert t.headers["Content-Type"].startswith("application/jsonl")
        jt, tt = _traces(j.text), _traces(t.text)
        assert len(tt) == len(jt) == 2
        for spans in tt.values():
            assert trace_report.find_orphans(spans) == []
            roots = [s for s in spans if not s.get("parent")]
            assert [s["name"] for s in roots] == ["server.request"]
            assert roots[0]["attrs"]["finish"] == "length"
        assert sorted(sorted(s["name"] for s in v) for v in tt.values()) \
            == sorted(sorted(s["name"] for s in v) for v in jt.values())
        # A traceparent header parents the server's span, and so the
        # engine's, on the caller's trace.
        caller = ttracing.get_tracer("client").start_span("client.call")
        header = "traceparent"
        r = requests.post(pair.port.url + "/v1/completions", json=body,
                          headers={header: caller.ctx().to_headers()[header]},
                          timeout=TIMEOUT)
        assert r.status_code == 200
        caller.end()
        r = requests.get(pair.port.url + "/debug/traces?drain=1",
                         timeout=TIMEOUT)
        mine = _traces(r.text)[caller.trace_id]
        assert {s["name"] for s in mine} >= {
            "client.call", "server.request", "engine.queue",
            "engine.prefill", "engine.decode", "engine.step"}
        assert trace_report.find_orphans(mine) == []
        assert requests.get(pair.port.url + "/debug/traces",
                            timeout=TIMEOUT).text == ""
    finally:
        pair.close()
