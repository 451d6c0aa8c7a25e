"""Port parity: MoE models with GQA attention (the Qwen3-MoE / Mixtral
family of ``models.moe``), the streamed int8 weight build, and the
engine on ``tiny-moe``.

* ``models.moe.forward`` against the JAX forward on its CPU path, weights
  from the JAX init through ``params_from_numpy`` (int8 experts), on three
  configurations built with equal fields in both packages: ``tiny-moe``
  (a shared expert, one dense layer), a tiny Qwen3-MoE shape (``qk_norm``,
  ``head_dim`` set, no dense layer, no shared expert, softmax top-2 of 8
  renormalized) and a tiny Mixtral shape (no dense layer, no ``qk_norm``),
  each on a bf16 and an int8 cache.  A prefill step and two decode steps:
  final hidden states within atol = rtol = 2e-2 on the port's reference
  path and 6e-2 on its kernel path (the tolerances of the MLA forward
  tests; 6e-2 on both where an int8 cache is written past a first MoE
  layer), the first layer's cache rows bit-equal and the deeper ones
  within 2e-2 (bf16) or two quantization steps (int8), outside the trash
  block 0, and the routed expert ids of every MoE layer equal but at near
  ties: the
  forwards differ by one bf16 ulp in a few hidden elements (XLA fuses
  some round trips away), which can swap the k-th and (k+1)-th expert
  (or two chosen ones) where their router logits lie within
  ``NEAR_TIE``, the forward's own tolerance.  A stubbed ``attn`` writes
  no cache row, as in JAX.
* ``EngineCore`` greedy tokens equal the JAX engine's on ``tiny-moe``
  (int8 experts): the classic loop, 4-step blocks with async scheduling,
  and EPLB at ep = 1, whose trackers must equal the JAX engine's.
* The engine's own int8 build (each expert plane drawn and quantized at
  once) equals ``init_params`` then ``quantize_moe_experts`` with the same
  generator bit for bit, on ``tiny-mla``, ``tiny-moe`` and the Qwen3-MoE
  shape, so the random weights of every earlier configuration are
  unchanged; handed-in bf16 experts are quantized from the caller's tree,
  each stack popped from it.
* ``get_model`` serves every preset as the JAX package dispatches it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.models import moe as JMoE
from llm_d_tpu.models.config import ModelConfig as JConfig
from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops.quant import quantize_moe_experts as jquantize
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models import get_model
from llm_d_tpu_torch.models import moe as TMoE
from llm_d_tpu_torch.models.config import ModelConfig as TConfig
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops import moe as TMoeOps
from llm_d_tpu_torch.ops.quant import quantize_moe_experts
from llm_d_tpu_torch.ops.sampling import SamplingParams

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
TOL_KERNEL = dict(atol=6e-2, rtol=6e-2)
BS = 16
NEAR_TIE = TOL["atol"]

_TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, max_model_len=512,
             num_experts=8, num_experts_per_tok=2)
CONFIGS = {
    "tiny-moe": None,
    # Qwen3-MoE's structure (qwen3-30b-a3b): q/k norms, a head_dim apart
    # from hidden / heads, every layer MoE, no shared expert.
    "tiny-qwen3-moe": dict(_TINY, name="tiny-qwen3-moe", head_dim=32,
                           rope_theta=1000000.0, qk_norm=True,
                           moe_intermediate_size=48),
    # Mixtral's (mixtral-8x22b): every layer MoE, experts as wide as the
    # dense MLP, no q/k norms.
    "tiny-mixtral": dict(_TINY, name="tiny-mixtral", rope_theta=1000000.0,
                         moe_intermediate_size=128),
}


def _configs(name):
    kw = CONFIGS[name]
    if kw is None:
        return jget_config(name), tget_config(name)
    return JConfig(**kw), TConfig(**kw)


def _engine(tc, tree, kv, backend, **over):
    return EngineCore(EngineConfig(
        model_config=tc, block_size=BS, num_blocks=16, max_num_seqs=4,
        max_num_batched_tokens=64, quantization="int8", kv_cache_dtype=kv,
        enable_prefix_caching=False, attn_backend=backend, device="cpu",
        **over), params=params_from_numpy(tree, "cpu"))


def _jcache(engine):
    dt = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16,
          torch.float32: jnp.float32}
    return {k: jnp.zeros(v.shape, dt[v.dtype])
            for k, v in engine.kv_cache.items()}


def _add(engine, vocab):
    rng = np.random.default_rng(1)
    for i, n in enumerate((5, 23, 12)):
        engine.add_request(Request(f"r{i}", rng.integers(
            1, vocab, n).tolist(), SamplingParams(
                temperature=0.0, max_tokens=4, ignore_eos=True)))


def _router_spy(monkeypatch):
    """Records the port's router logits of every MoE layer call."""
    seen = []
    route = TMoeOps.route

    def spy(logits, config, e_bias=None):
        seen.append((logits.detach().clone(), config, e_bias))
        return route(logits, config, e_bias)

    monkeypatch.setattr(TMoeOps, "route", spy)
    return seen


def _assert_routed_equal(got, want, calls, T):
    """Routed ids ``[Lm, T, k]`` equal, but at near ties: where a token's
    ids first differ at rank r, the port's router scores of ranks r and
    r + 1 must lie within ``NEAR_TIE`` (softmax: in logits, whose order
    is the probabilities' order), and at most one token a layer may
    differ."""
    got, want = got[:, :T], want[:, :T]
    for li, t in np.argwhere((got != want).any(axis=-1)):
        logits, c, e_bias = calls[li]
        _, choice = TMoeOps.route_scores(logits, c, e_bias)
        score = logits.float() if c.scoring_func == "softmax" else choice
        top = torch.sort(score[t], descending=True).values
        r = int(np.argmax(got[li, t] != want[li, t]))
        gap = float(top[r] - top[r + 1])
        assert gap < NEAR_TIE, (li, t, r, gap)


def _assert_cache_equal(cache, jcache):
    """The cache rows outside the trash block 0 (pad tokens write there):
    the first layer's bit-equal; deeper layers' rows follow the hidden
    states, which differ from JAX's by a bf16 ulp after the first MoE
    layer (no dense layer: from layer 1), so there bf16 rows are held to
    ``TOL``, int8 rows to two quantization steps and their scales to
    ``TOL``'s rtol."""
    for k, v in cache.items():
        got = v.float().numpy()[:, BS:]
        want = np.asarray(jcache[k], np.float32)[:, BS:]
        np.testing.assert_array_equal(got[0], want[0], err_msg=k)
        if v.dtype == torch.int8:
            assert np.abs(got - want).max() <= 2, k
        elif k.endswith("_scale"):
            np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=k)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, kv, monkeypatch):
    """A prefill of three sequences and two decode steps through the whole
    model, each held to the JAX forward: hidden states, routed ids and the
    cache rows written."""
    calls = _router_spy(monkeypatch)
    jc, tc = _configs(name)
    assert get_model(tc) is TMoE
    assert TMoE.kv_cache_layout(tc) == JMoE.kv_cache_layout(jc)
    jparams = jquantize(JMoE.init_params(jc, jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    # An int8 row written from hidden states an ulp apart can land one
    # quantization step (1/127 of its row's max) apart; with no dense
    # layer first, every layer past the first reads such rows, and the
    # reference path is held to the kernel path's 6e-2 there.
    exact_rows = kv == "bf16" or jc.first_dense_layers > 0
    engines = {be: _engine(tc, tree, kv, be)
               for be in ("reference", "kernel")}
    for eng in engines.values():
        _add(eng, tc.vocab_size)
    ref = engines["reference"]
    jcache = _jcache(ref)
    jfwd = jax.jit(lambda p, c, b: JMoE.forward(p, c, b, jc, BS, "auto",
                                                collect_routed=True))
    for _ in range(3):                        # prefill, then two decodes
        steps = {be: e.scheduler.schedule() for be, e in engines.items()}
        batch, _ = ref._build_batch(steps["reference"])
        T = int(steps["reference"].total_tokens)
        want, jcache, jrouted = jfwd(
            jparams, jcache, {k: jnp.asarray(v.numpy())
                              for k, v in batch.items()})
        S = len(steps["reference"].scheduled)
        toks = np.asarray(JMoE.compute_logits(jparams, want, jc)).argmax(-1)
        for backend, eng in engines.items():
            b, _ = eng._build_batch(steps[backend])
            calls.clear()
            got, routed = TMoE.forward(eng.params, eng.kv_cache, b, tc, BS,
                                       backend, collect_routed=True)
            np.testing.assert_allclose(
                got.float().numpy()[:S], np.asarray(want, np.float32)[:S],
                **(TOL if backend == "reference" and exact_rows
                   else TOL_KERNEL))
            if backend == "reference":
                _assert_routed_equal(routed.numpy(), np.asarray(jrouted),
                                     calls, T)
            for sr, tok in zip(steps[backend].scheduled, toks[:S].tolist()):
                sr.request.num_computed_tokens += sr.num_new_tokens
                sr.request.output_token_ids.append(tok)
        _assert_cache_equal(ref.kv_cache, jcache)


def test_stubbed_attention_writes_no_cache_row(monkeypatch):
    """``stub_components=("attn",)`` on the Qwen3-MoE shape: the hidden
    states and routed ids of the JAX forward with the same stub, and the
    int8 cache stays zero."""
    jc, tc = _configs("tiny-qwen3-moe")
    jparams = jquantize(JMoE.init_params(jc, jax.random.PRNGKey(1)))
    eng = _engine(tc, jax.tree.map(np.asarray, jparams), "int8",
                  "reference", stub_components=("attn",))
    _add(eng, tc.vocab_size)
    sched = eng.scheduler.schedule()
    batch, _ = eng._build_batch(sched)
    opts = dict(stub_components=("attn",))
    calls = _router_spy(monkeypatch)
    want, jcache, jrouted = jax.jit(lambda p, c, b: JMoE.forward(
        p, c, b, jc, BS, "auto", collect_routed=True, moe_opts=opts))(
        jparams, _jcache(eng), {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
    got, routed = TMoE.forward(eng.params, eng.kv_cache, batch, tc, BS,
                               "reference", collect_routed=True,
                               moe_opts=opts)
    S, T = len(sched.scheduled), sched.total_tokens
    np.testing.assert_allclose(got.float().numpy()[:S],
                               np.asarray(want, np.float32)[:S], **TOL)
    _assert_routed_equal(routed.numpy(), np.asarray(jrouted), calls, T)
    for k, v in eng.kv_cache.items():
        assert not v.any(), k
        assert not np.asarray(jcache[k]).any(), k


def _greedy(R, SP, tag="g"):
    """Three greedy rows of 5, 11 and 20 prompt tokens."""
    rng = np.random.default_rng(0)
    return [R(f"{tag}{i}", rng.integers(1, 512, size=n).tolist(),
              SP(temperature=0.0, max_tokens=m, ignore_eos=True))
            for i, (n, m) in enumerate(((5, 9), (11, 6), (20, 7)))]


EPLB = dict(enable_eplb=True,
            eplb_config={"window_size": 64, "step_interval": 8})
PATHS = {"classic": {},
         "blocks": dict(num_scheduler_steps=4, async_scheduling=True),
         "eplb": EPLB}


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_tokens_equal_jax_on_tiny_moe(path):
    """tiny-moe with int8 experts, block 16: greedy tokens equal the JAX
    engine's through the classic loop, 4-step async blocks and EPLB at
    ep = 1 (its trackers equal the JAX engine's, the physical table the
    identity)."""
    kw = dict(model="tiny-moe", block_size=BS, num_blocks=32,
              max_num_seqs=4, max_num_batched_tokens=64,
              quantization="int8", enable_prefix_caching=False,
              **PATHS[path])
    jeng = JEngineCore(JEngineConfig(**kw))
    params = jax.tree.map(np.asarray, jeng.params)
    if jeng.eplb is not None:
        # Serve the logical weights: the port installs its own table.
        params = dict(params, moe_layers={
            k: v for k, v in params["moe_layers"].items()
            if k not in ("replica_table", "num_replicas")})
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=params_from_numpy(params, "cpu"))
    want = jeng.generate(_greedy(JRequest, JSamplingParams))
    got = teng.generate(_greedy(Request, SamplingParams))
    assert got == want
    if path == "blocks":
        assert teng._dispatch_count < teng._step_count
    if path == "eplb":
        t, j = teng.eplb, jeng.eplb
        assert teng.params["moe_layers"]["replica_table"][0, :, 0].tolist() \
            == list(range(8))
        assert t.tracker.load.sum() > 0
        np.testing.assert_array_equal(t.tracker.load, j.tracker.load)
        np.testing.assert_array_equal(t.tracker.layer_load,
                                      j.tracker.layer_load)
        assert t.num_rebalances == j.num_rebalances == 0


@pytest.mark.parametrize("name", ["tiny-mla", "tiny-moe", "tiny-qwen3-moe"])
def test_streamed_int8_build_equals_quantize_after_init(name):
    """``init_params(..., quantize_experts=True)`` (what an int8 engine
    builds) against ``init_params`` then ``quantize_moe_experts`` from the
    same seed: every tensor bit-equal, no bf16 expert stack left; and an
    int8 engine built from its seed holds those weights."""
    tc = tget_config(name) if name != "tiny-qwen3-moe" \
        else _configs(name)[1]
    want = quantize_moe_experts(TMoE.init_params(
        tc, torch.Generator().manual_seed(3), "cpu"))
    got = TMoE.init_params(tc, torch.Generator().manual_seed(3), "cpu",
                           quantize_experts=True)
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        assert torch.equal(flat_g[path], w), path
    assert "w_gate" not in got["moe_layers"]
    eng = EngineCore(EngineConfig(
        model_config=tc, block_size=BS, num_blocks=8, quantization="int8",
        device="cpu", seed=3))
    for k, v in want["moe_layers"].items():
        assert torch.equal(eng.params["moe_layers"][k], v), k


def test_quantize_moe_experts_drops_the_callers_bf16_stacks():
    """Params handed to an int8 engine are quantized from the caller's
    tree, each bf16 stack popped from it as it goes."""
    tc = tget_config("tiny-moe")
    params = TMoE.init_params(tc, torch.Generator().manual_seed(2), "cpu")
    ml = params["moe_layers"]
    w_gate = ml["w_gate"].clone()
    eng = EngineCore(EngineConfig(model_config=tc, block_size=BS,
                                  num_blocks=8, quantization="int8",
                                  device="cpu"), params=params)
    assert eng.params["moe_layers"] is ml
    assert not {"w_gate", "w_up", "w_down"} & set(ml)
    want = quantize_moe_experts({"moe_layers": {"w_gate": w_gate}})
    assert torch.equal(ml["w_gate_q"], want["moe_layers"]["w_gate_q"])
    assert torch.equal(ml["w_gate_s"], want["moe_layers"]["w_gate_s"])


def test_every_preset_has_a_model():
    """``get_model`` serves every preset: the MoE ones (MLA or GQA) through
    ``models.moe``, as the JAX package dispatches them, and the GQA ones
    carry K/V row layouts equal to JAX's."""
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.models.config import PRESETS as JPRESETS
    from llm_d_tpu_torch.models.config import PRESETS
    assert set(PRESETS) == set(JPRESETS)
    for name, tc in PRESETS.items():
        jm, tm = jget_model(JPRESETS[name]), get_model(tc)
        assert tm.__name__.rsplit(".", 1)[1] == jm.__name__.rsplit(".", 1)[1]
        assert tm.kv_cache_layout(tc) == jm.kv_cache_layout(JPRESETS[name])
