"""Port parity: the fused mixed round (prefill chunks, plain decodes and
draft-verify rows in one forward) in the port's EngineCore against the
JAX engine, on the CPU (after ``tests/test_mixed_fusion.py``).

* Simultaneous adds (pure-prefill, then pure-decode rounds) and
  staggered adds (mixed rounds), greedy and seeded: the port's tokens
  equal the JAX spec engine's run of the same schedule, step for step,
  and the port's non-spec engine's solo runs.  ``tiny`` runs the port's
  own forward; ``tiny-mla`` (int8 experts and latent) continues on the
  JAX steps' hidden states (``test_torch_spec.HiddenReplay``: its
  forward is held to the JAX forward at atol = rtol = 2e-2 each step).
* Spec decode stays armed across prefill joins (mixed rounds schedule
  drafts, a joiner drafts and accepts); rejected drafts in mixed rounds
  leak no blocks.
* Chunk budgeting: ``LLMD_PREFILL_CHUNK`` caps every chunk (tokens
  unchanged), an invalid value falls back to "auto"; the port's
  ``StepTimeModel`` learns the JAX one's law and sizes chunks alike, and
  ``LLMD_STEP_TIME_TARGET_MS`` engages the engine's cap once trained.
* A logprobs row decoding beside spec rows stays in the fused round;
  its tokens equal the JAX engine's and its logprobs (chosen and top-5)
  match at atol = rtol = 2e-2 (the forwards differ by one bf16 ulp in a
  few hidden elements, ROADMAP §3).
"""

import numpy as np
import pytest

from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu.predictor.model import StepTimeModel as JStepTimeModel
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.utils.predictor import StepTimeModel

from test_torch_spec import (
    K, MODELS, PROMPTS, greedy_req, jax_pair, kw_of, port_engine,
    seeded_req, step_log)

import torch

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)


def _free_blocks(engine):
    return engine.kv_manager.num_free_blocks


def run_staggered(engine, first, rest, warm_steps=4):
    """Add ``first``, let it reach decode, then add ``rest`` one per
    step: every joiner's prefill chunks share rounds with decodes.
    Returns each pass's scheduler stats and the tokens each request got
    in each step."""
    stats, log = [], []

    def step():
        log.append(sorted((o.request_id, len(o.new_token_ids))
                          for o in engine.step() if o.new_token_ids))
        stats.append(dict(engine.scheduler.last_schedule_stats))

    engine.add_request(first)
    for _ in range(warm_steps):
        step()
    pending = list(rest)
    while engine.has_work() or pending:
        if pending:
            engine.add_request(pending.pop(0))
        step()
    return stats, log


@pytest.fixture(scope="module")
def engines():
    out = {}
    for model in sorted(MODELS):
        real = jax_pair(model, replay=model == "tiny-mla")
        out[model] = dict(real=real, plain=port_engine(kw_of(model), real[0]),
                          own=port_engine(kw_of(model), real[0], spec_k=K))
    out["fixed"] = jax_pair("tiny", spec_fixed_accept=0.8)
    return out


def _solo(plain, req, make):
    """The non-spec engine's tokens for ``req``'s prompt alone."""
    rid = req.request_id + "w"
    return plain.generate([make(rid, req.prompt_token_ids,
                                req.sampling.max_tokens)])[rid]


def test_fused_parity_simultaneous_greedy(engines):
    """Simultaneous adds: pure-prefill rounds, then pure-decode rounds,
    token for token with the JAX spec engine and the non-spec engine."""
    jeng, teng, _ = engines["tiny"]["real"]
    jreqs = [greedy_req(r, p, R=JRequest, SP=JSamplingParams)
             for r, p in PROMPTS.items()]
    treqs = [greedy_req(r, p) for r, p in PROMPTS.items()]
    assert step_log(teng, treqs) == step_log(jeng, jreqs)
    got = {r.request_id: list(r.output_token_ids) for r in treqs}
    assert got == {r.request_id: list(r.output_token_ids) for r in jreqs}
    assert got == engines["tiny"]["plain"].generate(
        [greedy_req(r, p) for r, p in PROMPTS.items()])


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_fused_parity_mixed_rounds(model, seeded, engines, monkeypatch):
    """Staggered adds force mixed rounds (prefill chunks and spec rows in
    one forward): the JAX spec engine's tokens step for step, and each
    request's solo non-spec tokens (fold_in(seed, gen_idx) continuity for
    seeded rows, including a prefill-completing row's first token)."""
    jeng, teng, replay = engines[model]["real"]

    def make(R, SP, tag):
        if seeded:
            return (seeded_req(tag + "a", PROMPTS["a"], 10, 7, R=R, SP=SP),
                    [seeded_req(tag + "b", PROMPTS["b"], 8, 99, R=R, SP=SP)])
        return (greedy_req(tag + "a", PROMPTS["a"], 14, R=R, SP=SP),
                [greedy_req(tag + "b", PROMPTS["b"], 10, R=R, SP=SP),
                 greedy_req(tag + "c", PROMPTS["c"], 10, R=R, SP=SP)])

    if replay is not None:
        replay.steps.clear()
    jfirst, jrest = make(JRequest, JSamplingParams, "m")
    _, jlog = run_staggered(jeng, jfirst, jrest)
    if replay is not None:
        replay.serve(teng, monkeypatch)
    first, rest = make(Request, SamplingParams, "m")
    stats, log = run_staggered(teng, first, rest)
    assert any(s["prefill_tokens"] > 0 and s["decode_tokens"] > 0
               for s in stats), "no mixed round was ever scheduled"
    assert log == jlog
    for req, jreq in zip([first] + rest, [jfirst] + jrest):
        assert list(req.output_token_ids) == list(jreq.output_token_ids)
    if replay is not None:
        # Against the non-spec engine, the port runs on its own forward
        # (an engine of its own: the pair's two engines keep one history).
        monkeypatch.undo()
        first, rest = make(Request, SamplingParams, "own")
        run_staggered(engines[model]["own"], first, rest)
    plain = engines[model]["plain"]
    for req in [first] + rest:
        solo = ((lambda rid, p, n, sd=req.sampling.seed:
                 seeded_req(rid, p, n, sd)) if seeded else greedy_req)
        assert list(req.output_token_ids) == _solo(plain, req, solo)


def test_spec_stays_on_across_prefill_joins(engines):
    """Mixed rounds carry draft tokens, and a joiner that finished its
    prefill mid-decode drafts and accepts too (its first decode step was
    primed by the fused prefill row); every step equals the JAX
    engine's."""
    jeng, teng, _ = engines["fixed"]

    def make(R, SP):
        return (greedy_req("j0", [1, 2, 3, 4, 5], 20, R=R, SP=SP),
                [greedy_req("j1", [9, 8, 7, 6, 5, 4, 3, 2, 1], 16,
                            R=R, SP=SP)])

    jfirst, jrest = make(JRequest, JSamplingParams)
    jstats, jlog = run_staggered(jeng, jfirst, jrest)
    first, rest = make(Request, SamplingParams)
    stats, log = run_staggered(teng, first, rest)
    assert stats == jstats and log == jlog
    assert [s for s in stats
            if s["prefill_tokens"] > 0 and s["spec_tokens"] > 0]
    assert len(first.output_token_ids) == 20
    assert len(rest[0].output_token_ids) == 16
    assert first.spec_accepted > 0
    assert rest[0].spec_drafted > 0 and rest[0].spec_accepted > 0
    assert [(r.spec_drafted, r.spec_accepted) for r in [first] + rest] == \
        [(r.spec_drafted, r.spec_accepted) for r in [jfirst] + jrest]


def test_rejected_drafts_leak_free_in_mixed_rounds(engines):
    """Every draft rejected in every mixed round: output unchanged and
    every block back in the pool."""
    eng = port_engine(kw_of("tiny"), engines["tiny"]["real"][0], spec_k=K,
                      spec_fixed_accept=0.0)
    free0 = _free_blocks(eng)
    first = greedy_req("z0", [1, 5, 9, 200, 3], 12)
    rest = [greedy_req(f"z{i}", [i + 1, 7, 9, 2, 5], 8) for i in range(1, 4)]
    run_staggered(eng, first, rest)
    assert _free_blocks(eng) == free0
    assert eng.kv_manager._ref == {}
    assert first.spec_drafted > 0 and first.spec_accepted == 0
    plain = engines["tiny"]["plain"]
    for req in [first] + rest:
        assert list(req.output_token_ids) == _solo(plain, req, greedy_req)


# ---------------------------------------------------------------------------
# chunk budgeting
# ---------------------------------------------------------------------------

def test_fixed_chunk_cap_keeps_tokens(monkeypatch, engines):
    """LLMD_PREFILL_CHUNK=8: every prefill chunk is capped at 8 tokens
    (the scheduler's stats say so) and the tokens are unchanged."""
    monkeypatch.setenv("LLMD_PREFILL_CHUNK", "8")
    eng = port_engine(kw_of("tiny"), engines["tiny"]["real"][0], spec_k=K)
    assert eng._prefill_chunk_fixed == 8
    req = greedy_req("k", list(range(100, 130)), 6)
    eng.add_request(req)
    max_chunk = 0
    while eng.has_work():
        eng.step()
        s = eng.scheduler.last_schedule_stats
        if s["prefill_tokens"] > 0:
            assert s["chunk_cap"] == 8
            max_chunk = max(max_chunk, s["prefill_tokens"])
    assert max_chunk == 8
    assert list(req.output_token_ids) == _solo(engines["tiny"]["plain"], req,
                                               greedy_req)


@pytest.mark.parametrize("raw", ["banana", "auto", "-3"])
def test_chunk_env_resolution(monkeypatch, raw):
    """An invalid LLMD_PREFILL_CHUNK falls back to "auto" (no cap without
    a target or a trained model); a value below 1 pins 1."""
    monkeypatch.setenv("LLMD_PREFILL_CHUNK", raw)
    monkeypatch.delenv("LLMD_STEP_TIME_TARGET_MS", raising=False)
    eng = port_engine(kw_of("tiny"))
    want = 1 if raw == "-3" else None
    assert eng._prefill_chunk_fixed == want
    assert eng._prefill_chunk_cap(0) == want


def test_step_time_model_learns_and_sizes_chunks():
    """The online ridge model recovers a linear step-latency law, and
    ``chunk_for`` binary-searches the largest chunk under the target,
    monotone in the decode load; the port's model answers as the JAX
    package's does on the same samples."""
    ms = StepTimeModel(min_samples=16), JStepTimeModel(min_samples=16)
    for m in ms:
        assert not m.trained and m.predict(100, 100) == 0.0
    for p in range(0, 160, 10):
        for d in (0, 64, 128):
            for m in ms:
                m.observe(p, d, 2.0 + 0.01 * p + 0.05 * d)
    m, jm = ms
    assert m.trained
    assert abs(m.predict(100, 64) - (2.0 + 1.0 + 3.2)) < 0.1
    assert m.chunk_for(128, 5.0, lo=16, hi=512) == 16
    c = m.chunk_for(0, 5.0, lo=16, hi=512)
    assert 16 < c < 512
    assert m.predict(c, 0) <= 5.0 < m.predict(c + 8, 0)
    assert c >= m.chunk_for(64, 5.0, lo=16, hi=512)
    for d in (0, 8, 64, 128):
        assert m.chunk_for(d, 5.0, 16, 512) == jm.chunk_for(d, 5.0, 16, 512)
        assert m.predict(77, d) == pytest.approx(jm.predict(77, d), rel=1e-9)
    assert StepTimeModel().chunk_for(0, 5.0, 16, 512) == 512
    assert m.chunk_for(0, 0.0, 16, 512) == 512
    assert m.chunk_for(0, 5.0, 512, 512) == 512


def test_engine_adaptive_cap_engages_when_model_trains(monkeypatch):
    """LLMD_STEP_TIME_TARGET_MS: no cap until the step-latency model has
    its samples, then a cap between min_token_bucket and
    max_num_batched_tokens; a fixed chunk wins over the model.  Every
    step feeds the model (classic and fused)."""
    monkeypatch.setenv("LLMD_STEP_TIME_TARGET_MS", "5.0")
    monkeypatch.delenv("LLMD_PREFILL_CHUNK", raising=False)
    eng = port_engine(kw_of("tiny"))
    assert eng._step_time_target_ms == 5.0
    assert eng._prefill_chunk_cap(8) is None
    eng.generate([greedy_req("x", [1, 2, 3], 3)])
    assert eng.step_time_model.num_observed == 3
    for p in range(0, 160, 10):
        for d in (0, 8):
            eng.step_time_model.observe(p, d, 2.0 + 0.05 * p + 0.1 * d)
    cap = eng._prefill_chunk_cap(8)
    assert cap is not None
    assert eng.config.min_token_bucket <= cap \
        <= eng.config.max_num_batched_tokens
    monkeypatch.setenv("LLMD_PREFILL_CHUNK", "8")
    eng2 = port_engine(kw_of("tiny"), spec_k=K)
    eng2.step_time_model = eng.step_time_model
    assert eng2._prefill_chunk_cap(8) == 8
    eng2.generate([greedy_req("y", [1, 2, 3], 3)])
    assert eng2.step_time_model.num_observed > eng.step_time_model.min_samples


# ---------------------------------------------------------------------------
# logprobs rows ride the fused round
# ---------------------------------------------------------------------------

def test_logprobs_rows_fused_match_jax(engines):
    """A logprobs request (top 5) decoding beside a plain spec row: the
    rounds that serve it still schedule drafts, every token has one
    logprob and one top-5 dict, and tokens, logprobs and alternatives
    match the JAX spec engine's serving the same schedule (values at
    atol = rtol = 2e-2)."""
    jeng, teng, _ = engines["tiny"]["real"]

    def run(eng, R, SP):
        plain = greedy_req("pl", [1, 5, 9, 200, 3], 10, R=R, SP=SP)
        lp = greedy_req("lp", [5, 6, 7], 6, R=R, SP=SP, logprobs=5)
        eng.add_request(plain)
        outs = []
        for _ in range(3):
            outs.extend(eng.step())
        eng.add_request(lp)
        spec_rounds = 0
        while eng.has_work():
            outs.extend(eng.step())
            spec_rounds += eng.scheduler.last_schedule_stats["spec_tokens"] > 0
        mine = [o for o in outs if o.request_id == "lp"]
        return (plain, spec_rounds,
                [t for o in mine for t in o.new_token_ids],
                [v for o in mine for v in (o.logprobs or [])],
                [t for o in mine for t in (o.top_logprobs or [])])

    plain, rounds, toks, lps, tops = run(teng, Request, SamplingParams)
    _, jrounds, jtoks, jlps, jtops = run(jeng, JRequest, JSamplingParams)
    assert rounds > 0 and rounds == jrounds
    assert plain.spec_drafted > 0
    assert len(toks) == len(lps) == len(tops) == 6
    assert toks == jtoks
    np.testing.assert_allclose(lps, jlps, atol=2e-2, rtol=2e-2)
    assert all(v <= 0 for v in lps)
    for tok, got, want in zip(toks, tops, jtops):
        assert list(got) == list(want)         # same ids, same order
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   atol=2e-2, rtol=2e-2)
        assert max(got, key=got.get) == tok    # greedy: the top-1 entry
