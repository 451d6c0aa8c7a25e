"""Port parity: the last one-device engine fields against the JAX
package, on the CPU.

* ``stub_components`` (the attribution sweep's stubs): for each of
  ``attn``, ``moe_ffn`` and ``shared_expert`` the port's ``tiny-mla``
  forward (int8 experts, int8 latent) equals the JAX forward with the
  same stub at the tolerance of ``test_forward_matches_jax``
  (atol = rtol = 2e-2), prefill then decode; the ``attn`` stub leaves
  the KV cache bit-equal to its input; a stubbed engine's greedy tokens
  equal the JAX engine's with the same stub.
* ``kv_cache_hbm_bytes``: ``kv_block_bytes`` and the derived block count
  equal the JAX package's for ``tiny``, ``tiny-mla``, ``llama3-1b`` and
  ``deepseek-v3-bench`` on bf16, int8-token and int8-head caches (the
  MLA latent has one scale a row); an engine built from a budget holds
  the JAX engine's ``num_blocks`` and allocates exactly ``num_blocks x
  kv_block_bytes`` of cache.
* ``spec_strict``: resolved from the field or ``LLMD_SPEC_STRICT`` as in
  JAX; a startup demotion refuses to start with the JAX engine's message,
  a runtime one is counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.engine import engine as JEngine
from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.models import get_model as jget_model
from llm_d_tpu.models import moe as JMoE
from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops.quant import kv_scale_width as jkv_scale_width
from llm_d_tpu.ops.quant import quantize_moe_experts as jquantize
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine import engine as TEngine
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models import get_model as tget_model
from llm_d_tpu_torch.models import moe as TMoE
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.quant import kv_scale_width as tkv_scale_width
from llm_d_tpu_torch.ops.sampling import SamplingParams

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

STUBS = ("attn", "moe_ffn", "shared_expert")
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("stub", STUBS)
def test_stubbed_forward_matches_jax(stub):
    """Three prompts, then one decode step, through the whole ``tiny-mla``
    model with ``stub`` dropped, each step against the JAX forward with
    the same stub; the port continues on the JAX tokens."""
    jc, tc, bs = jget_config("tiny-mla"), tget_config("tiny-mla"), 32
    jparams = jquantize(JMoE.init_params(jc, jax.random.PRNGKey(0)))
    eng = EngineCore(EngineConfig(
        model_config=tc, block_size=bs, num_blocks=16, max_num_seqs=4,
        max_num_batched_tokens=128, quantization="int8",
        kv_cache_dtype="int8", enable_prefix_caching=False,
        attn_backend="reference", stub_components=(stub,), device="cpu"),
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    assert eng._moe_opts() == {"dbo_decode_min_tokens": -1,
                               "dbo_prefill_min_tokens": -1,
                               "stub_components": (stub,)}
    rng = np.random.default_rng(1)
    for i, n in enumerate((5, 40, 17)):
        eng.add_request(Request(f"r{i}", rng.integers(
            1, tc.vocab_size, n).tolist(), SamplingParams(
                temperature=0.0, max_tokens=4, ignore_eos=True)))
    jcache = {k: jnp.zeros(v.shape, jnp.int8 if v.dtype == torch.int8
                           else jnp.float32)
              for k, v in eng.kv_cache.items()}
    opts = {"stub_components": (stub,)}
    jfwd = jax.jit(lambda p, kv, b: JMoE.forward(p, kv, b, jc, bs, "auto",
                                                 moe_opts=opts))
    for _ in range(2):                        # prefill, then one decode
        sched = eng.scheduler.schedule()
        batch, _ = eng._build_batch(sched)
        before = {k: v.clone() for k, v in eng.kv_cache.items()}
        want, jcache = jfwd(jparams, jcache,
                            {k: jnp.asarray(v.numpy())
                             for k, v in batch.items()})
        got = TMoE.forward(eng.params, eng.kv_cache, batch, tc, bs,
                           "reference", moe_opts=opts)
        S = len(sched.scheduled)
        np.testing.assert_allclose(got.float().numpy()[:S],
                                   np.asarray(want, np.float32)[:S], **TOL)
        if stub == "attn":
            # No cache row is written, in either package.
            for k, v in eng.kv_cache.items():
                assert torch.equal(v, before[k]), k
                assert not np.asarray(jcache[k]).any(), k
        else:
            assert any(not torch.equal(v, before[k])
                       for k, v in eng.kv_cache.items())
        toks = np.asarray(JMoE.compute_logits(jparams, want, jc)).argmax(-1)
        for sr, tok in zip(sched.scheduled, toks[:S].tolist()):
            sr.request.num_computed_tokens += sr.num_new_tokens
            sr.request.output_token_ids.append(tok)


@pytest.mark.parametrize("stub", STUBS)
def test_stubbed_engine_tokens_equal_jax(stub):
    """``tiny-mla`` (int8 experts, int8 latent) with ``stub_components``:
    three requests, ten greedy tokens each, token for token with the JAX
    engine (the same stub in its step program)."""
    kw = dict(model="tiny-mla", block_size=32, num_blocks=64,
              max_num_seqs=8, max_num_batched_tokens=128,
              quantization="int8", kv_cache_dtype="int8",
              enable_prefix_caching=False, stub_components=(stub,))
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jeng.params), "cpu"))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (5, 40, 17)]
    want = jeng.generate([JRequest(f"r{i}", p, JSamplingParams(
        temperature=0.0, max_tokens=10, ignore_eos=True))
        for i, p in enumerate(prompts)])
    got = teng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=10, ignore_eos=True))
        for i, p in enumerate(prompts)])
    assert got == want


# ---------------------------------------------------------------------------
# pool sizing
# ---------------------------------------------------------------------------

CACHE_MODES = [("bf16", "token"), ("int8", "token"), ("int8", "head")]


def _scale_width(c, dtype, gran, kvsw):
    if dtype != "int8":
        return 0
    return 1 if c.use_mla else kvsw(c.num_kv_heads, gran)


@pytest.mark.parametrize("model", ["tiny", "tiny-mla", "llama3-1b",
                                   "deepseek-v3-bench"])
@pytest.mark.parametrize("dtype,gran", CACHE_MODES)
def test_kv_block_bytes_and_derived_blocks_match_jax(model, dtype, gran):
    jc, tc = jget_config(model), tget_config(model)
    jl = jget_model(jc).kv_cache_layout(jc)
    tl = tget_model(tc).kv_cache_layout(tc)
    assert tl == jl
    jsw = _scale_width(jc, dtype, gran, jkv_scale_width)
    tsw = _scale_width(tc, dtype, gran, tkv_scale_width)
    assert tsw == jsw
    for bs in (16, 64):
        want = JEngine.kv_block_bytes(jl, jc.num_layers, bs, dtype, jsw)
        assert TEngine.kv_block_bytes(tl, tc.num_layers, bs, dtype,
                                      tsw) == want
        for budget in (4 << 30, 80 << 30, 3 * want + 1, 1):
            assert TEngine.derive_num_blocks(
                budget, tl, tc.num_layers, bs, dtype, tsw) == \
                JEngine.derive_num_blocks(budget, jl, jc.num_layers, bs,
                                          dtype, jsw)


@pytest.mark.parametrize("model,dtype,gran", [
    ("tiny", "bf16", "token"), ("tiny", "int8", "token"),
    ("tiny", "int8", "head"), ("tiny-mla", "int8", "token"),
    ("tiny-mla", "bf16", "token")])
def test_engine_pool_from_a_budget_matches_jax(model, dtype, gran):
    """An engine built from ``kv_cache_hbm_bytes`` (0.37 MiB, a non-round
    budget) holds the JAX engine's derived ``num_blocks`` and allocates
    exactly ``num_blocks x kv_block_bytes`` of cache."""
    budget = 388_097
    kw = dict(model=model, block_size=8, num_blocks=4,
              kv_cache_dtype=dtype, kv_scale_granularity=gran,
              kv_cache_hbm_bytes=budget)
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = EngineCore(EngineConfig(device="cpu", **kw))
    assert teng.config.num_blocks == jeng.config.num_blocks > 4
    assert teng.kv_manager.num_free_blocks == \
        jeng.kv_manager.num_free_blocks
    c = teng.model_config
    per_block = TEngine.kv_block_bytes(
        teng.model.kv_cache_layout(c), c.num_layers, 8, teng.kv_cache_dtype,
        max(teng.kv_scale_width, 1))
    allocated = sum(v.numel() * v.element_size()
                    for v in teng.kv_cache.values())
    assert allocated == teng.config.num_blocks * per_block <= budget
    jbytes = sum(np.asarray(v).nbytes for v in jax.tree.leaves(
        jeng.kv_cache))
    assert allocated == jbytes


# ---------------------------------------------------------------------------
# spec_strict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,env,want", [
    (None, None, False), (True, None, True), (None, "1", True),
    (False, "1", False)])
def test_spec_strict_refuses_where_jax_does(field, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("LLMD_SPEC_STRICT", raising=False)
    else:
        monkeypatch.setenv("LLMD_SPEC_STRICT", env)
    kw = dict(model="tiny", block_size=8, num_blocks=32, spec_k=2,
              spec_strict=field)
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = EngineCore(EngineConfig(device="cpu", **kw))
    assert teng.spec_strict is jeng.spec_strict is want
    # Nothing demotes spec decode at startup in either engine.
    assert teng.spec_k == jeng.spec_k == 2
    assert teng._spec_blockers() == jeng._spec_blockers() == []
    for startup in (True, False):
        outcome = []
        for eng in (jeng, teng):
            try:
                eng._disable_feature("spec_decode", "probe", startup=startup)
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
        assert (outcome[1] is not None) is (want and startup)
    text = teng.metrics.render().decode()
    assert 'blocker="probe"' in text and 'feature="spec_decode"' in text


def test_new_fields_default_as_in_jax():
    t, j = EngineConfig(), JEngineConfig()
    for name in ("enable_eplb", "eplb_config", "kv_cache_hbm_bytes",
                 "stub_components", "spec_strict"):
        assert getattr(t, name) == getattr(j, name), name
    assert dataclasses.replace(t, stub_components=("attn",)).stub_components \
        == ("attn",)
