"""Port parity: speculative decode (MTP draft-and-verify) in the port's
EngineCore against the JAX engine, on the CPU (after
``tests/test_spec_decode.py``).

* ``spec_verify`` and ``verify_logprobs`` against the JAX functions on
  random logits: greedy, seeded, unseeded and top-k/top-p rows, live
  draft counts 0..K; ids and accepted counts exact, logprobs at atol
  1e-5.  The fixed-acceptance coin is bit-equal to ``jax.random.uniform``
  over steps 0-63.
* ``init_draft_params`` has the JAX tree's shapes; ``draft_propose``
  gives the JAX drafter's ids exactly on converted ``tiny`` and
  ``tiny-mla`` parameters.
* The acceptance tracker backs off to K = 1 and recovers; its table is
  bounded.
* The spec engine (``spec_k`` = 4) on ``tiny`` (bf16 cache) and
  ``tiny-mla`` (int8 experts and latent): greedy and seeded tokens equal
  to the JAX spec engine's and to the port's own non-spec engine's; at a
  fixed acceptance (0.8) the tokens emitted per request per step and the
  drafted/accepted counts equal the JAX engine's.  On ``tiny-mla`` the
  two forwards differ by one bf16 ulp in a few hidden elements (ROADMAP
  §3), which flips near ties, so the port's forward is held to the JAX
  forward at atol = rtol = 2e-2 step by step, from the JAX step's cache,
  and the engine then continues on the JAX step's hidden states
  (``HiddenReplay``): its batches must equal the JAX engine's array for
  array.
* Rollback is leak-free (free blocks restored, ``_ref`` empty), also
  mid-stream; ``max_tokens`` and ``max_model_len`` are respected; a
  perfect drafter is accepted whole with unchanged output; adaptive K
  backs off.
* Knobs: ``LLMD_SPEC_DECODE=off`` is today's engine, ``LLMD_SPEC_K``
  resolves with its invalid-value fallback, spec with
  ``num_scheduler_steps`` > 1 builds with spec armed, and
  ``LLMD_KV_CACHE_DTYPE`` / ``LLMD_MLA_LATENT_DTYPE`` resolve as in the
  JAX engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.models import llama as JLlama
from llm_d_tpu.models import moe as JMoE
from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops import sampling as JSampling
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu.predictor.model import (
    SpecAcceptanceTracker as JSpecAcceptanceTracker)
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models import llama as TLlama
from llm_d_tpu_torch.models import moe as TMoE
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import (
    params_from_numpy, tensor_from_numpy)
from llm_d_tpu_torch.ops import prng
from llm_d_tpu_torch.ops import sampling as TSampling
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.utils.predictor import SpecAcceptanceTracker

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

K = 4
ENGINE_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4)
MODELS = {
    "tiny": dict(model="tiny", kv_cache_dtype="bf16"),
    "tiny-mla": dict(model="tiny-mla", quantization="int8",
                     kv_cache_dtype="int8"),
}
PROMPTS = {"a": [1, 5, 9, 200, 3, 17, 42], "b": [4, 4, 4, 8],
           "c": list(range(40, 55))}


def kw_of(model, **over):
    return dict(ENGINE_KW, **MODELS[model], **over)


def greedy_req(rid, prompt, n=12, R=Request, SP=SamplingParams, **kw):
    return R(request_id=rid, prompt_token_ids=list(prompt),
             sampling=SP(temperature=0.0, max_tokens=n, ignore_eos=True,
                         **kw))


def seeded_req(rid, prompt, n=12, seed=7, R=Request, SP=SamplingParams):
    return R(request_id=rid, prompt_token_ids=list(prompt),
             sampling=SP(temperature=0.9, top_p=0.95, top_k=20,
                         max_tokens=n, seed=seed, ignore_eos=True))


def port_engine(kw, jeng=None, **over):
    """The port's engine on ``kw``; with ``jeng``, on its weights and
    drafter (bit-identical through ``params_from_numpy``)."""
    if jeng is None:
        return EngineCore(EngineConfig(device="cpu", **kw, **over))
    dp = (params_from_numpy(jax.tree.map(np.asarray, jeng.draft_params),
                            "cpu") if jeng.draft_params is not None else None)
    return EngineCore(EngineConfig(device="cpu", **kw, **over),
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jeng.params), "cpu"),
                      draft_params=dp)


def jax_pair(model, replay=False, **over):
    jeng = JEngineCore(JEngineConfig(spec_k=K, **kw_of(model, **over)))
    teng = port_engine(kw_of(model, **over), jeng, spec_k=K)
    assert jeng.spec_k == teng.spec_k == K
    return jeng, teng, (HiddenReplay(jeng) if replay else None)


class HiddenReplay:
    """Splits the JAX engine's fused program at the model forward (its
    body otherwise as ``EngineCore._build_fused_fn`` writes it) and
    records each step's batch, cache and hidden states; ``serve`` then
    feeds them to the port's engine in step order.  The port's batch
    must equal the JAX engine's, array for array, and its forward still
    runs, from the JAX step's cache, held to the JAX hidden states at
    atol = rtol = 2e-2 (as in test_forward_matches_jax).  Under EPLB the
    JAX step also hands its engine the routed ids (as its own fused
    program does), and the port's forward answers with the JAX step's
    routed ids too, so both trackers see one routing."""

    def __init__(self, jeng) -> None:
        self.jeng = jeng
        self.steps = []
        fns = {}
        replay = self

        class Fns(dict):
            def get(self, key, default=None):
                if key not in fns:
                    fns[key] = replay._split_fn(*key)
                return fns[key]

        jeng._fused_fns = Fns()

    def _split_fn(self, want_lp, want_top):
        e = self.jeng
        jm, jc, bs = e.model, e.model_config, e.config.block_size
        fixed, mesh, opts = e.config.spec_fixed_accept, e.mesh, e._moe_opts()
        collect = dict(collect_routed=True) if e.eplb is not None else {}

        @jax.jit
        def fwd(params, kv, batch):
            return jm.forward(params, kv, batch, jc, bs, e.config.attn_backend,
                              mesh=mesh, moe_opts=opts, **collect)

        @jax.jit
        def rest(params, dparams, hidden, batch, rng):
            logits = jm.compute_logits(params, hidden, jc)
            ids, accepted = JSampling.spec_verify(
                logits, batch["draft_tokens"], batch["spec_n"],
                batch["temperature"], batch["top_k"], batch["top_p"], rng,
                seeds=batch["seeds"], gen0=batch["gen0"],
                fixed_accept=fixed, step=batch["spec_step"])
            S = accepted.shape[0]
            h = hidden.reshape(S, K + 1, hidden.shape[-1])
            h_a = jnp.take_along_axis(h, accepted[:, None, None], axis=1)[:, 0]
            bonus = jnp.take_along_axis(ids, accepted[:, None], axis=1)[:, 0]
            drafts = jm.draft_propose(params, dparams, h_a, bonus, K, jc)
            lp = top = None
            if want_top:
                lp, ti, tl = JSampling.verify_logprobs(logits, ids, top_n=20)
                top = (ti, tl)
            elif want_lp:
                lp = JSampling.verify_logprobs(logits, ids)
            return ids, accepted, drafts, lp, top

        def fn(params, dparams, kv, batch, rng):
            cache = jax.tree.map(np.asarray, kv)
            hidden, kv, *routed = fwd(params, kv, batch)
            self.steps.append((jax.tree.map(np.asarray, batch), cache,
                               np.asarray(hidden),
                               *(np.asarray(r) for r in routed)))
            return (*rest(params, dparams, hidden, batch, rng),
                    routed[0] if routed else None, kv)

        return fn

    def serve(self, teng, monkeypatch) -> None:
        """Patch ``teng``'s model forward to replay the recorded steps."""
        steps = iter(self.steps)
        real = teng.model.forward

        def forward(params, kv, batch, *a, **kw):
            jbatch, jcache, jhidden, *routed = next(steps)
            for k, v in kv.items():
                v.copy_(tensor_from_numpy(jcache[k], "cpu"))
            got = real(params, kv, batch, *a, **kw)
            if kw.get("collect_routed"):
                got = got[0]
            for k, v in batch.items():
                np.testing.assert_array_equal(v.numpy(), jbatch[k], err_msg=k)
            np.testing.assert_allclose(got.float().numpy(),
                                       jhidden.astype(np.float32),
                                       atol=2e-2, rtol=2e-2)
            hidden = tensor_from_numpy(jhidden, "cpu")
            if kw.get("collect_routed"):
                return hidden, torch.from_numpy(routed[0].astype(np.int32))
            return hidden

        monkeypatch.setattr(teng.model, "forward", forward)
        self.left = steps


def step_log(engine, reqs):
    """Run ``reqs`` to completion step by step: the tokens each request
    got in each step, step by step."""
    for r in reqs:
        engine.add_request(r)
    log = []
    while engine.has_work():
        log.append(sorted((o.request_id, len(o.new_token_ids))
                          for o in engine.step() if o.new_token_ids))
    return log


def _free_blocks(engine):
    return engine.kv_manager.num_free_blocks


# ---------------------------------------------------------------------------
# units: the verifier, its coin, logprobs, the drafter, the tracker
# ---------------------------------------------------------------------------

def _verify_inputs(case, S=6, V=96, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((S * (K + 1), V)) * 3).astype(np.float32)
    target = logits.reshape(S, K + 1, V).argmax(-1)
    drafts = rng.integers(0, V, (S, K)).astype(np.int32)
    # Rows 0-2 draft the greedy target's prefix of 4, 2 and 0 tokens.
    for s, m in enumerate((4, 2, 0)):
        drafts[s, :m] = target[s, :m]
    spec_n = np.array([4, 4, 3, 0, 2, 4][:S], np.int32)
    temp = np.zeros(S, np.float32)
    top_k = np.zeros(S, np.int32)
    top_p = np.ones(S, np.float32)
    seeds = np.full(S, -1, np.int32)
    if case != "greedy":
        temp[:] = 0.8
        temp[0] = 0.0                     # a greedy row in every batch
    if case == "seeded":
        seeds[1::2] = [7, 2**31 - 1, 123][:len(seeds[1::2])]
    if case == "top_k_top_p":
        top_k[:] = [0, 5, 20, 1, 0, 3][:S]
        top_p[:] = [1.0, 0.9, 0.5, 1.0, 0.7, 0.95][:S]
        seeds[2] = 99
    gen0 = rng.integers(0, 50, S).astype(np.int32)
    return dict(logits=logits, drafts=drafts, spec_n=spec_n, temp=temp,
                top_k=top_k, top_p=top_p, seeds=seeds, gen0=gen0)


@pytest.mark.parametrize("case", ["greedy", "seeded", "unseeded",
                                  "top_k_top_p"])
def test_spec_verify_and_logprobs_match_jax(case):
    x = _verify_inputs(case)
    jkey = jax.random.PRNGKey(11)
    jids, jacc = JSampling.spec_verify(
        jnp.asarray(x["logits"]), jnp.asarray(x["drafts"]),
        jnp.asarray(x["spec_n"]), jnp.asarray(x["temp"]),
        jnp.asarray(x["top_k"]), jnp.asarray(x["top_p"]), jkey,
        seeds=jnp.asarray(x["seeds"]), gen0=jnp.asarray(x["gen0"]))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ids, acc = TSampling.spec_verify(
        t["logits"], t["drafts"], t["spec_n"], t["temp"], t["top_k"],
        t["top_p"], prng.prng_key(11), seeds=t["seeds"], gen0=t["gen0"])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    if case == "greedy":
        assert acc.tolist()[:4] == [4, 2, 0, 0]
    jlp = JSampling.verify_logprobs(jnp.asarray(x["logits"]), jids)
    np.testing.assert_allclose(
        TSampling.verify_logprobs(t["logits"], ids).numpy(),
        np.asarray(jlp), atol=1e-5, rtol=0)
    jtop = JSampling.verify_logprobs(jnp.asarray(x["logits"]), jids, top_n=5)
    ttop = TSampling.verify_logprobs(t["logits"], ids, top_n=5)
    np.testing.assert_allclose(ttop[0].numpy(), np.asarray(jtop[0]),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ttop[1].numpy(), np.asarray(jtop[1]))
    np.testing.assert_allclose(ttop[2].numpy(), np.asarray(jtop[2]),
                               atol=1e-5, rtol=0)


def test_accept_coin_is_jax_uniform_bit_for_bit():
    """Steps 0-63 at the bench's (256, 4) and a small (3, 4): the coin's
    f32 bits equal ``jax.random.uniform``'s, and ``spec_verify`` at a
    fixed acceptance accepts what the JAX one accepts."""
    for S in (3, 256):
        for step in range(64):
            want = np.asarray(jax.random.uniform(jax.random.fold_in(
                jax.random.PRNGKey(0x5BEC), step), (S, K)))
            got = TSampling.accept_coin(step, S, K, "cpu").numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
    x = _verify_inputs("greedy")
    S = x["spec_n"].shape[0]
    for step in (0, 5, 63):
        _, jacc = JSampling.spec_verify(
            jnp.asarray(x["logits"]), jnp.asarray(x["drafts"]),
            jnp.asarray(x["spec_n"]), jnp.zeros(S), jnp.zeros(S, jnp.int32),
            jnp.ones(S), jax.random.PRNGKey(0),
            seeds=jnp.full(S, -1, jnp.int32), gen0=jnp.zeros(S, jnp.int32),
            fixed_accept=0.7, step=jnp.int32(step))
        _, acc = TSampling.spec_verify(
            torch.from_numpy(x["logits"]), torch.from_numpy(x["drafts"]),
            torch.from_numpy(x["spec_n"]), torch.zeros(S),
            torch.zeros(S, dtype=torch.int32), torch.ones(S),
            prng.prng_key(0), seeds=torch.full((S,), -1, dtype=torch.int32),
            gen0=torch.zeros(S, dtype=torch.int32),
            coin=TSampling.accept_coin(step, S, K, "cpu"),
            fixed_accept=torch.tensor(0.7))
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_draft_propose_matches_jax(model):
    """Converted target and draft parameters, hidden states and last ids
    from a seed: the port's K = 4 greedy drafts equal the JAX
    drafter's; the port's own init has the JAX tree's shapes, and the
    MoE model re-exports the drafter."""
    jc, tc = jget_config(model), tget_config(model)
    jm, tm = (JMoE, TMoE) if jc.is_moe else (JLlama, TLlama)
    jparams = jm.init_params(jc, jax.random.PRNGKey(0))
    jdraft = jm.init_draft_params(jc, jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((12, jc.hidden_size)).astype(np.float32)
    hidden = jnp.asarray(hidden, jc.jax_dtype)
    last = jnp.asarray(rng.integers(0, jc.vocab_size, 12), jnp.int32)
    want = np.asarray(jax.jit(lambda p, d, h, t: jm.draft_propose(
        p, d, h, t, K, jc))(jparams, jdraft, hidden, last))
    got = tm.draft_propose(
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        params_from_numpy(jax.tree.map(np.asarray, jdraft), "cpu"),
        tensor_from_numpy(np.asarray(hidden), "cpu"),
        torch.from_numpy(np.array(last)), K, tc)
    assert got.shape == (12, K)
    np.testing.assert_array_equal(got.numpy(), want)
    mine = tm.init_draft_params(tc, torch.Generator().manual_seed(1), "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in jdraft.items()}
    assert all(v.dtype == torch.bfloat16 for v in mine.values())


def test_acceptance_tracker_backoff_and_recovery():
    for Tr in (SpecAcceptanceTracker, JSpecAcceptanceTracker):
        tr = Tr(k_max=4, low=0.35, alpha=0.5)
        assert tr.suggest_k("r") == 4            # optimistic start
        for _ in range(6):
            tr.observe("r", 4, 0)                # nothing accepted
        assert tr.suggest_k("r") == 1            # backed off
        for _ in range(8):
            tr.observe("r", 1, 1)                # K=1 keeps measuring
        assert tr.suggest_k("r") == 4            # recovered
        tr.forget("r")
        assert tr.rate("r") is None
    port, ref = SpecAcceptanceTracker(4), JSpecAcceptanceTracker(4)
    rng = np.random.default_rng(0)
    for _ in range(40):
        rid, d = f"r{rng.integers(3)}", int(rng.integers(0, 5))
        a = int(rng.integers(0, d + 1))
        port.observe(rid, d, a)
        ref.observe(rid, d, a)
        assert port.suggest_k(rid) == ref.suggest_k(rid)
        assert port.rate(rid) == ref.rate(rid)


def test_acceptance_tracker_table_is_bounded():
    tr = SpecAcceptanceTracker(k_max=4, cap=8)
    for i in range(50):
        tr.observe(f"r{i}", 4, 2)
    assert len(tr._rate) <= 8


# ---------------------------------------------------------------------------
# engine: parity with the JAX spec engine and the non-spec engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """Per model: (JAX spec engine, port spec engine, replay or None) with
    real verification, the same at fixed acceptance 0.8, and the port's
    non-spec and spec engines on the same weights.  The engines of a
    pair serve the same requests in the same order, so that their block
    pools and prefix caches keep one history."""
    out = {}
    for model in sorted(MODELS):
        replay = model == "tiny-mla"
        real = jax_pair(model, replay)
        fixed = jax_pair(model, replay, spec_fixed_accept=0.8)
        plain = port_engine(kw_of(model), real[0])
        own = port_engine(kw_of(model), real[0], spec_k=K)
        out[model] = dict(real=real, fixed=fixed, plain=plain, own=own)
    return out


def _mixed_requests(R, SP, tag=""):
    reqs = [greedy_req(tag + r, p, 14, R=R, SP=SP)
            for r, p in PROMPTS.items()]
    reqs.append(seeded_req(tag + "s", [3, 1, 4, 1, 5], 12, R=R, SP=SP))
    reqs.append(seeded_req(tag + "t", [9, 9, 2], 10, seed=99, R=R, SP=SP))
    return reqs


def _run_pair(pair, make, monkeypatch):
    """The same requests through the JAX and the port engine of ``pair``:
    (JAX step log, port step log, JAX requests, port requests)."""
    jeng, teng, replay = pair
    jreqs, treqs = make(JRequest, JSamplingParams), make(Request,
                                                         SamplingParams)
    if replay is not None:
        replay.steps.clear()
    jlog = step_log(jeng, jreqs)
    if replay is not None:
        replay.serve(teng, monkeypatch)
    tlog = step_log(teng, treqs)
    if replay is not None:
        assert next(replay.left, None) is None
    return jlog, tlog, jreqs, treqs


@pytest.mark.parametrize("model", sorted(MODELS))
def test_spec_tokens_equal_jax_spec_engine_and_non_spec(model, pairs,
                                                        monkeypatch):
    """Greedy and seeded rows across block boundaries (block size 4, up
    to 14 tokens): the port's spec engine gives the JAX spec engine's
    tokens, step for step, and its own non-spec engine's tokens."""
    p = pairs[model]
    jlog, tlog, jreqs, treqs = _run_pair(p["real"], _mixed_requests,
                                         monkeypatch)
    assert tlog == jlog
    got = {r.request_id: list(r.output_token_ids) for r in treqs}
    assert got == {r.request_id: list(r.output_token_ids) for r in jreqs}
    monkeypatch.undo()
    want = p["plain"].generate(_mixed_requests(Request, SamplingParams))
    assert p["own"].generate(_mixed_requests(Request, SamplingParams)) == want
    assert sum(r.spec_drafted for r in treqs) > 0


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fixed_acceptance_steps_equal_jax(model, pairs, monkeypatch):
    """At fixed acceptance 0.8 the coin decides acceptance: each step's
    emitted tokens per request, the tokens themselves (accepted drafts
    are emitted verbatim, so the drafter is in the loop; a seeded row's
    bonus token is drawn at gen_idx = gen0 + accepted) and the
    drafted/accepted counts equal the JAX engine's."""
    jlog, tlog, jreqs, treqs = _run_pair(
        pairs[model]["fixed"],
        lambda R, SP: [greedy_req(f"f{i}", [3 * i + 1, 2, 9], 24, R=R, SP=SP)
                       for i in range(3)]
        + [seeded_req("fs", [8, 6, 4], 20, seed=5, R=R, SP=SP)], monkeypatch)
    assert tlog == jlog
    assert max(n for step in tlog for _, n in step) > 1
    assert [(r.spec_drafted, r.spec_accepted, list(r.output_token_ids))
            for r in treqs] == [(r.spec_drafted, r.spec_accepted,
                                 list(r.output_token_ids)) for r in jreqs]
    assert sum(r.spec_accepted for r in treqs) > 0
    m = pairs[model]["fixed"][1].metrics.render().decode()
    assert f'llmd_tpu:spec_accepted_tokens_total{{model_name="{model}"}}' in m


def test_rollback_is_leak_free(pairs):
    """After the requests finish every block is back in the pool and no
    reference counts linger; during decode no request holds more blocks
    than its accepted tokens need (the rejected tail went back the same
    step)."""
    eng = port_engine(kw_of("tiny"), pairs["tiny"]["real"][0], spec_k=K,
                      spec_fixed_accept=0.8)
    free0 = _free_blocks(eng)
    reqs = [greedy_req(f"lk{i}", [i + 1, 7, 9, 2, 5], 13) for i in range(5)]
    mid = greedy_req("mid", [1, 2, 3], 20)
    for r in reqs + [mid]:
        eng.add_request(r)
    bs = eng.config.block_size
    while eng.has_work():
        eng.step()
        if mid.state.value == "running":
            assert len(mid.block_ids) <= -(-mid.num_tokens // bs)
            assert len(mid.block_ids) >= -(-mid.num_computed_tokens // bs)
    assert _free_blocks(eng) == free0
    assert eng.kv_manager._ref == {}
    assert all(r.block_ids == [] for r in reqs + [mid])


def test_max_tokens_and_model_len_are_respected():
    """Every draft accepted: max_tokens not a multiple of the emitted
    run lengths is never exceeded, nor is max_model_len (a 60-token
    budget on a 64-token context)."""
    eng = port_engine(kw_of("tiny"), spec_k=K, spec_fixed_accept=1.0)
    for n in (1, 2, 5, 7):
        out = eng.generate([greedy_req(f"n{n}", [1, 2, 3], n)])
        assert len(out[f"n{n}"]) == n
    short = dataclasses.replace(tget_config("tiny"), max_model_len=64)
    eng = EngineCore(EngineConfig(device="cpu", model_config=short,
                                  spec_k=K, spec_fixed_accept=1.0,
                                  **ENGINE_KW))
    req = greedy_req("len", [1, 2, 3, 4], 200)
    eng.generate([req])
    assert req.num_tokens == 64 and req.state.value == "length"
    assert req.spec_accepted > 0


@pytest.mark.parametrize("seeded", [False, True])
def test_perfect_drafts_are_accepted_whole(pairs, seeded):
    """Drafts fed from the non-spec engine's own output: the real
    verifier accepts every one (a seeded row samples position q at
    gen_idx = gen0 + q, as the non-spec engine does), multi-token steps,
    unchanged output."""
    plain, spec = pairs["tiny"]["plain"], pairs["tiny"]["own"]
    prompt = [2, 5, 9, 201, 3, 17, 42]
    make = seeded_req if seeded else greedy_req
    want = plain.generate([make("ow", prompt, 12)])["ow"]
    req = make("o", prompt, 12)
    spec.add_request(req)
    while spec.has_work():
        j = len(req.output_token_ids)
        if (req.state.value == "running"
                and req.num_computed_tokens == req.num_tokens - 1
                and j < len(want)):
            req.spec_drafts = list(want[j:j + K])
            req.spec_drafts_at = req.num_tokens
        spec.step()
    assert list(req.output_token_ids) == want
    assert req.spec_accepted > 0 and req.spec_accepted == req.spec_drafted


def test_adaptive_k_backs_off_on_rejection():
    eng = port_engine(kw_of("tiny"), spec_k=K, spec_fixed_accept=0.0)
    req = greedy_req("r", [1, 2, 3], 16)
    assert len(eng.generate([req])["r"]) == 16
    assert req.spec_drafted < K * 15         # not every step paid depth 4
    assert eng.spec_tracker.rate("r") is None      # forgotten at finish


# ---------------------------------------------------------------------------
# knobs: env resolution, kill switch, refusal
# ---------------------------------------------------------------------------

def test_env_off_is_todays_engine(monkeypatch, pairs):
    monkeypatch.setenv("LLMD_SPEC_DECODE", "off")
    eng = port_engine(kw_of("tiny"), pairs["tiny"]["real"][0], spec_k=K)
    assert eng.spec_k == 0 and eng.draft_params is None
    assert eng.scheduler.spec_lookahead is None
    got = eng.generate([greedy_req("a", PROMPTS["a"])])
    assert got == pairs["tiny"]["plain"].generate(
        [greedy_req("a", PROMPTS["a"])])


@pytest.mark.parametrize("raw,want", [("3", 3), ("banana", 0), (None, 0)])
def test_env_k_resolution_and_invalid_fallback(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("LLMD_SPEC_K", raising=False)
    else:
        monkeypatch.setenv("LLMD_SPEC_K", raw)
    eng = port_engine(kw_of("tiny"))
    jeng = JEngineCore(JEngineConfig(**kw_of("tiny")))
    assert eng.spec_k == jeng.spec_k == want
    assert (eng.scheduler.spec_lookahead is None) == (want == 0)


def test_spec_with_multistep_is_refused_by_name():
    """No longer refused: spec decode over multistep (and async) builds
    with spec armed, as the JAX engine does, and serves through the
    fused multistep pipeline (tests/test_torch_everything_on.py)."""
    for over in (dict(num_scheduler_steps=4),
                 dict(num_scheduler_steps=2, async_scheduling=True)):
        eng = port_engine(kw_of("tiny"), spec_k=K, **over)
        jeng = JEngineCore(JEngineConfig(spec_k=K, **kw_of("tiny"), **over))
        assert eng.spec_k == jeng.spec_k == K
        assert eng.draft_params is not None
        assert eng.scheduler.spec_lookahead is not None
    # spec_k 0 (or spec decode off) with multistep is today's engine.
    assert port_engine(kw_of("tiny"), spec_k=0,
                       num_scheduler_steps=4).spec_k == 0


@pytest.mark.parametrize("env,model", [
    ({"LLMD_KV_CACHE_DTYPE": "int8"}, "tiny"),
    ({"LLMD_KV_CACHE_DTYPE": "int8"}, "tiny-mla"),
    ({"LLMD_KV_CACHE_DTYPE": "int8", "LLMD_MLA_LATENT_DTYPE": "bf16"},
     "tiny-mla"),
    ({"LLMD_MLA_LATENT_DTYPE": "int8"}, "tiny-mla"),
    ({"LLMD_MLA_LATENT_DTYPE": "int8"}, "tiny"),
    ({"LLMD_KV_CACHE_DTYPE": "fp4", "LLMD_MLA_LATENT_DTYPE": "banana"},
     "tiny-mla"),
])
def test_cache_dtype_env_knobs_resolve_as_in_jax(monkeypatch, env, model):
    """``kv_cache_dtype=None`` / ``mla_latent_dtype=None`` resolve the
    environment knobs as the JAX engine does (an invalid value falls
    back to the default); an explicit value wins."""
    for k in ("LLMD_KV_CACHE_DTYPE", "LLMD_MLA_LATENT_DTYPE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(ENGINE_KW, model=model, num_blocks=16)
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = EngineCore(EngineConfig(device="cpu", **kw))
    assert (teng.kv_cache_dtype, teng.kv_quantized, teng.kv_scale_width) == \
        (jeng.kv_cache_dtype, jeng.kv_quantized, jeng.kv_scale_width)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in teng.kv_cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jeng.kv_cache.items()}
    explicit = EngineCore(EngineConfig(device="cpu", kv_cache_dtype="bf16",
                                       mla_latent_dtype="auto", **kw))
    assert explicit.kv_cache_dtype == "bf16"
