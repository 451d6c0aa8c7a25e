"""Port parity: mid-stream resume, the replica's half
(``llm_d_tpu_torch.server.stream_resume``, the server's ``resume`` body and
the engine's resume admission) against the JAX package, on the CPU.

* The engine (port of ``tests/test_stream_recovery.py``'s engine cases):
  a request resumed at offset 4 with the journal of an uninterrupted run
  continues with the JAX engine's tokens, through the classic step,
  4-step async decode blocks, the fused round (spec K = 4) and N-round
  dispatches (K = 4, N = 4, async): recomputed on a replica that has
  nothing cached; restored from a shared-tier peer (the generated region
  counted in ``resume_restored_tokens``); a ``kv.restore`` fault degrades
  to recompute; int8 caches (``tiny`` and ``tiny-mla``) both ways; seeded
  sampling draws the same continuation (positions and ``gen_idx`` go on
  from the offset).
* The paired servers: a streamed ``resume`` body gives the JAX server's
  chunks, its ``src`` verdict, and continuous ``llmd`` offsets.
* Failover: the JAX gateway (``epp.service.build_gateway``) in front of
  two port servers, one killed mid-stream by an ``engine.step`` fault,
  delivers a continuous stream (``verify_continuity``) whose text equals
  an uninterrupted run; the killed replica's ``/health`` is 500.
"""

import time

import jax
import numpy as np
import pytest
import requests

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.epp.datastore import EndpointState
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu.server import stream_resume as jresume
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.server import openai as TServer
from llm_d_tpu_torch.server import stream_resume as tresume
from llm_d_tpu_torch.utils import faultinject
from llm_d_tpu_torch.utils.faultinject import FaultInjected, FaultInjector
from test_torch_server import TIMEOUT, _Pair, _serve_jax, _serve_port, _sse

ENGINE_KW = dict(model="tiny", block_size=4, num_blocks=64, max_num_seqs=8,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4)
TIER_KW = dict(num_blocks=32, kv_offload_blocks=64)
PATHS = {
    "classic": {},
    "blocks": dict(num_scheduler_steps=4, async_scheduling=True),
    "fused": dict(spec_k=4),
    "fused_n4": dict(spec_k=4, num_scheduler_steps=4, async_scheduling=True),
}
PROMPT = [3, 1, 4, 1, 5, 9]          # 6 tokens; block size 4
NEW = 8
OFFSET = 4


@pytest.fixture()
def inject():
    def make() -> FaultInjector:
        return faultinject.install(FaultInjector())
    yield make
    faultinject.reset()


def _tree(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _sampling(SP, seed=None):
    if seed is None:
        return SP(temperature=0.0, max_tokens=NEW, ignore_eos=True)
    return SP(temperature=1.0, top_k=0, max_tokens=NEW, ignore_eos=True,
              seed=seed)


def _resume_req(rid, journal, seed=None):
    req = Request(request_id=rid, prompt_token_ids=list(PROMPT),
                  sampling=_sampling(SamplingParams, seed))
    req.output_token_ids = list(journal)
    req.resume_offset = len(journal)
    return req


_BASE = {}


def _jax_base(model="tiny", kv=None, seed=None, spec=False):
    """The JAX engine of a configuration (its weights, and with ``spec``
    its drafter, serve the port's engines) and its uninterrupted
    tokens."""
    key = (model, kv, seed, spec)
    if key not in _BASE:
        kw = dict(ENGINE_KW, model=model, spec_k=4 if spec else 0)
        if kv:
            kw.update(kv_cache_dtype=kv,
                      quantization="int8" if model == "tiny-mla" else None)
        jeng = JEngineCore(JEngineConfig(**kw))
        want = jeng.generate([JRequest(
            request_id="base", prompt_token_ids=list(PROMPT),
            sampling=_sampling(JSamplingParams, seed))])["base"]
        _BASE[key] = (jeng, want, kw)
    return _BASE[key]


def _port(jeng, kw, **over):
    kw = {**kw, "spec_k": 0, **over}
    return EngineCore(EngineConfig(device="cpu", **kw),
                      params=_tree(jeng.params),
                      draft_params=(_tree(jeng.draft_params)
                                    if kw["spec_k"] else None))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_resume_recomputes_to_the_jax_tokens(path):
    jeng, want, kw = _jax_base(spec=True)
    eng = _port(jeng, kw, **PATHS[path])
    req = _resume_req("res", want[:OFFSET])
    assert eng.generate([req])["res"] == want
    assert req.resume_offset == OFFSET
    assert req.resume_restored_tokens == 0       # nothing cached here


@pytest.mark.parametrize("path", ["classic", "blocks"])
def test_resume_restores_from_the_shared_tier(path):
    jeng, want, kw = _jax_base()
    a = _port(jeng, kw, **TIER_KW, kv_shared_tier_port=0)
    b = None
    try:
        base = Request(request_id="base", prompt_token_ids=list(PROMPT),
                       sampling=_sampling(SamplingParams))
        assert a.generate([base])["base"] == want
        assert a.host_tier.saves > 0
        b = _port(jeng, kw, **TIER_KW, **PATHS[path],
                  kv_shared_tier_peers=(f"127.0.0.1:{a.host_tier.port}",))
        req = _resume_req("res", want[:OFFSET])
        assert b.generate([req])["res"] == want
        # Prompt (6) + journal (4) = 10 tokens: two full blocks restored,
        # past the prompt into the generated region.
        assert req.resume_restored_tokens > 0
        assert b.host_tier.remote_hits > 0
    finally:
        for e in (a, b):
            if e is not None:
                e.host_tier.close()


def test_a_kv_restore_fault_degrades_to_recompute(inject):
    jeng, want, kw = _jax_base()
    a = _port(jeng, kw, **TIER_KW, kv_shared_tier_port=0)
    inj = inject()
    inj.add_rule("kv.restore")               # every restore fails
    b = None
    try:
        a.generate([Request(request_id="base", prompt_token_ids=list(PROMPT),
                            sampling=_sampling(SamplingParams))])
        b = _port(jeng, kw, **TIER_KW,
                  kv_shared_tier_peers=(f"127.0.0.1:{a.host_tier.port}",))
        req = _resume_req("res", want[:OFFSET])
        assert b.generate([req])["res"] == want
        assert req.resume_restored_tokens == 0
        assert b.host_tier.remote_hits == 0
        assert inj.stats()["kv.restore"]["fired"] >= 1
    finally:
        for e in (a, b):
            if e is not None:
                e.host_tier.close()


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_resume_on_int8_caches(model):
    jeng, want, kw = _jax_base(model, kv="int8")
    a = _port(jeng, kw, **TIER_KW, kv_shared_tier_port=0)
    b = None
    try:
        a.generate([Request(request_id="base", prompt_token_ids=list(PROMPT),
                            sampling=_sampling(SamplingParams))])
        b = _port(jeng, kw, **TIER_KW, **PATHS["blocks"],
                  kv_shared_tier_peers=(f"127.0.0.1:{a.host_tier.port}",))
        req = _resume_req("res", want[:OFFSET])
        assert b.generate([req])["res"] == want
        assert req.resume_restored_tokens > 0
        c = _port(jeng, kw)
        req = _resume_req("res2", want[:OFFSET])
        assert c.generate([req])["res2"] == want
        assert req.resume_restored_tokens == 0
    finally:
        for e in (a, b):
            if e is not None:
                e.host_tier.close()


@pytest.mark.parametrize("path", ["classic", "blocks"])
def test_seeded_sampling_continues_from_the_offset(path):
    jeng, want, kw = _jax_base(seed=1234)
    eng = _port(jeng, kw, **PATHS[path])
    req = _resume_req("res", want[:OFFSET], seed=1234)
    assert eng.generate([req])["res"] == want


def test_an_engine_step_fault_kills_the_step(inject):
    """The ``engine.step`` fault point, keyed by model name."""
    eng = EngineCore(EngineConfig(device="cpu", **ENGINE_KW))
    inj = inject()
    inj.add_rule("engine.step", match="tiny-mla")
    eng.step()                                   # another model's rule
    inj.add_rule("engine.step", match="tiny")
    with pytest.raises(FaultInjected):
        eng.step()


def _stream(url, body, headers=None):
    r = requests.post(url + "/v1/completions", json=body, stream=True,
                      headers=headers or {}, timeout=TIMEOUT)
    assert r.status_code == 200
    return _sse(r)


def test_a_resumed_stream_equals_the_jax_server():
    pair = _Pair("tiny")
    try:
        body = dict(model="m", prompt=PROMPT, max_tokens=NEW,
                    temperature=0.0, ignore_eos=True, stream=True)
        frames = _stream(pair.port.url, body)
        toks = [t for f in frames[:-1] for t in f["llmd"]["tok"]]
        assert len(toks) == NEW
        resumed = dict(body, resume={"offset": OFFSET,
                                     "token_ids": toks[:OFFSET]})
        hdr = {"x-llmd-resume-offset": str(OFFSET)}
        got = [_stream(s.url, resumed, hdr) for s in (pair.jax, pair.port)]
        for frames in got:
            assert frames[-1] == "DONE"
            metas = [f["llmd"] for f in frames[:-1]]
            assert [t for m in metas for t in m["tok"]] == toks[OFFSET:]
            assert metas[0]["off"] == OFFSET
            assert metas[0]["src"] == tresume.OUTCOME_RECOMPUTED
        j, t = ([(f["llmd"]["tok"], f["llmd"].get("src"),
                  f["choices"][0]["finish_reason"]) for f in fr[:-1]]
                for fr in got)
        assert t == j
        # Journal and continuation, checked by both packages' oracle.
        metas = [{"off": 0, "tok": toks[:OFFSET]}] + [
            f["llmd"] for f in got[1][:-1]]
        assert tresume.verify_continuity(metas, NEW) == []
        assert jresume.verify_continuity(metas, NEW) == []
    finally:
        pair.close()


def _gateway(urls):
    """The JAX gateway in front of ``urls``, once it sees them ready."""
    from llm_d_tpu.epp.service import build_gateway
    gw = build_gateway(
        [EndpointState(address=u.split("//")[1]) for u in urls],
        scrape_interval_s=0.05, retry_attempts=3)
    served = _serve_jax(gw, ready_path="/health")
    for _ in range(200):
        if all(e.ready for e in gw.datastore.candidates()):
            break
        time.sleep(0.05)
    assert all(e.ready for e in gw.datastore.candidates())
    return served


def test_the_gateway_resumes_a_stream_across_a_port_replica_death(inject):
    eng = EngineCore(EngineConfig(device="cpu", **ENGINE_KW))
    servers = [TServer.build_server(None, engine=e, model_name="m")
               for e in (eng, EngineCore(EngineConfig(device="cpu",
                                                      **ENGINE_KW),
                                         params=eng.params))]
    served = [_serve_port(s) for s in servers]
    gw = None
    try:
        body = dict(model="m", prompt="recover me mid stream", max_tokens=12,
                    temperature=0.0, ignore_eos=True, stream=True)
        want = requests.post(served[0].url + "/v1/completions",
                             json=dict(body, stream=False),
                             timeout=TIMEOUT).json()["choices"][0]["text"]
        gw = _gateway([s.url for s in served])
        inj = inject()
        # The serving replica's engine dies at its 4th step (its prefill
        # and two decode steps went out), whichever replica that is.
        inj.add_rule("engine.step", after=3, count=1)
        r = requests.post(gw.url + "/v1/completions", json=body,
                          stream=True, timeout=TIMEOUT)
        assert r.status_code == 200
        text, metas, done = tresume.parse_stream_payload(r.content)
        assert done, "the stream did not reach [DONE]"
        assert tresume.verify_continuity(metas, expect_total=12) == []
        assert text == want
        assert inj.stats()["engine.step"]["fired"] == 1
        dead = [s for s in servers if s.async_engine.dead is not None]
        assert len(dead) == 1
        srcs = [m["src"] for m in metas if m.get("src")]
        assert len(srcs) == 1 and srcs[0] in (tresume.OUTCOME_RECOMPUTED,
                                              tresume.OUTCOME_RESTORED)
        health = [requests.get(s.url + "/health", timeout=TIMEOUT).status_code
                  for s in served]
        assert sorted(health) == [200, 500]
    finally:
        if gw is not None:
            gw.close()
        for s in served:
            s.close()
