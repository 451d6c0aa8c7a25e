"""Port parity, end to end on the slice: model forward, EngineCore, and
the package's isolation from JAX.

* ``models.moe.forward`` (int8 experts, int8 latent, weights from the JAX
  init through ``params_from_numpy``) against the JAX forward on its CPU
  path, for ``tiny-mla`` and a narrowed ``deepseek-v3-bench`` that keeps
  its routing (64 experts, top-8, 8 groups keep 4, sigmoid), 16 heads and
  latent widths (kv_lora 512, rope 64).  Tolerance atol = rtol = 2e-2 on
  the final hidden states: the port matches the JAX program's rounding
  points, but XLA fuses some f32 -> bf16 -> f32 round trips away, so a
  minority of elements differ by one bf16 ulp.  Through the kernel path
  (the kernels' plain versions on CPU tensors) q * scale and p are also
  rounded to bf16 before the attention dots, as the TPU kernels do, which
  the JAX CPU path does not: atol = rtol = 6e-2 there.
* ``models.llama.forward`` (bf16 and int8 caches) the same way, for
  ``tiny`` and a narrowed ``llama3-1b`` (32 heads, 8 KV heads, D = 64).
* ``EngineCore.generate`` greedy tokens identical to the JAX EngineCore:
  tiny-mla with int8 experts (at steps of up to 128 and of 1024 tokens)
  and tiny with a bf16, int8-per-token and int8-per-head cache, and on
  the 'chunked' attention backend; sampled tokens (seeded and unseeded,
  top-k and top-p) identical too, on tiny-mla and tiny.
* ``params_from_numpy`` carries the dense tree bit for bit.
* No module of the port, and not chip_smoke.py, imports jax, the JAX
  package, ml_dtypes, aiohttp or safetensors; the engine raises instead
  of serving on a GPU-less box.

The kernels themselves are held to their plain versions on the card in
tests/test_torch_gpu.py.
"""

import ast
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine import engine as JEngine
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.models import llama as JLlama
from llm_d_tpu.models import moe as JMoE
from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops.quant import quantize_moe_experts as jquantize
from llm_d_tpu.ops import sampling as JSampling
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine import engine as TEngine
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models import llama as TLlama
from llm_d_tpu_torch.models import moe as TMoE
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops import attention as TA
from llm_d_tpu_torch.ops.sampling import SamplingParams

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-2, rtol=2e-2)
TOL_KERNEL = dict(atol=6e-2, rtol=6e-2)


def _narrow_bench():
    over = dict(num_layers=2, hidden_size=256, vocab_size=1024,
                intermediate_size=512, moe_intermediate_size=128,
                max_model_len=512)
    return (dataclasses.replace(jget_config("deepseek-v3-bench"), **over),
            dataclasses.replace(tget_config("deepseek-v3-bench"), **over))


def _configs(name):
    if name == "tiny-mla":
        return jget_config(name), tget_config(name), 32
    jc, tc = _narrow_bench()
    return jc, tc, 64


@pytest.mark.parametrize("name", ["tiny-mla", "deepseek-v3-bench-narrow"])
def test_forward_matches_jax(name):
    """Prefill of three sequences, then one decode step, through the whole
    model with int8 experts and an int8 latent cache, on the port's
    reference path and on its kernel path (plain versions), each held to
    the same JAX forward."""
    jc, tc, bs = _configs(name)
    jparams = jquantize(JMoE.init_params(jc, jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    engines = {}
    for backend in ("reference", "kernel"):
        eng = EngineCore(EngineConfig(
            model_config=tc, block_size=bs, num_blocks=16, max_num_seqs=4,
            max_num_batched_tokens=128, quantization="int8",
            kv_cache_dtype="int8", enable_prefix_caching=False,
            attn_backend=backend, device="cpu"),
            params=params_from_numpy(tree, "cpu"))
        rng = np.random.default_rng(1)
        for i, n in enumerate((5, 40, 17)):
            eng.add_request(Request(f"r{i}", rng.integers(
                1, tc.vocab_size, n).tolist(), SamplingParams(
                    temperature=0.0, max_tokens=4, ignore_eos=True)))
        engines[backend] = eng
    ref = engines["reference"]
    jcache = {k: jnp.zeros(v.shape, jnp.int8 if v.dtype == torch.int8
                           else jnp.float32)
              for k, v in ref.kv_cache.items()}
    jfwd = jax.jit(lambda p, kv, b: JMoE.forward(p, kv, b, jc, bs, "auto"))
    for _ in range(2):                        # prefill, then one decode
        steps = {be: eng.scheduler.schedule() for be, eng in engines.items()}
        batch, _ = ref._build_batch(steps["reference"])
        want, jcache = jfwd(jparams, jcache,
                            {k: jnp.asarray(v.numpy())
                             for k, v in batch.items()})
        S = len(steps["reference"].scheduled)
        toks = np.asarray(JMoE.compute_logits(jparams, want, jc)).argmax(-1)
        for backend, eng in engines.items():
            b, _ = eng._build_batch(steps[backend])
            got = TMoE.forward(eng.params, eng.kv_cache, b, tc, bs, backend)
            np.testing.assert_allclose(
                got.float().numpy()[:S], np.asarray(want, np.float32)[:S],
                **(TOL if backend == "reference" else TOL_KERNEL))
            # Both paths continue with the JAX reference's tokens.
            for sr, tok in zip(steps[backend].scheduled, toks[:S].tolist()):
                sr.request.num_computed_tokens += sr.num_new_tokens
                sr.request.output_token_ids.append(tok)


def test_generate_token_identical_to_jax_engine():
    """tiny-mla, int8 experts and int8 latent, block 32: three requests,
    sixteen greedy tokens each, token for token."""
    kw = dict(model="tiny-mla", block_size=32, num_blocks=64,
              max_num_seqs=8, max_num_batched_tokens=128,
              quantization="int8", kv_cache_dtype="int8",
              enable_prefix_caching=False)
    jeng = JEngineCore(JEngineConfig(**kw))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (5, 40, 17)]
    want = jeng.generate([JRequest(f"r{i}", p, JSamplingParams(
        temperature=0.0, max_tokens=16, ignore_eos=True))
        for i, p in enumerate(prompts)])
    teng = EngineCore(EngineConfig(device="cpu", **kw), params=params_from_numpy(
        jax.tree.map(np.asarray, jeng.params), "cpu"))
    got = teng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=16, ignore_eos=True))
        for i, p in enumerate(prompts)])
    assert got == want


def _narrow_llama():
    over = dict(num_layers=2, hidden_size=256, vocab_size=1024,
                intermediate_size=512, max_model_len=512)
    return (dataclasses.replace(jget_config("llama3-1b"), **over),
            dataclasses.replace(tget_config("llama3-1b"), **over))


@pytest.mark.parametrize("name,kv", [("tiny", "bf16"), ("tiny", "int8"),
                                     ("llama3-1b-narrow", "bf16"),
                                     ("llama3-1b-narrow", "int8")])
def test_llama_forward_matches_jax(name, kv):
    """Dense family: prefill of three sequences, then one decode step,
    against the JAX forward on its CPU path, weights through
    ``params_from_numpy``.  The narrowed llama3-1b keeps 32 heads, 8 KV
    heads and D = 64 (row width 512), so its kernel path runs the plain
    versions of kernels H and G.  atol = rtol = 2e-2 on the final hidden
    states for the reference path (one bf16 ulp where XLA fuses a round
    trip away, as for the MoE forward), 6e-2 for the kernel path (q *
    scale and p rounded to bf16 before the dots, as the TPU kernels do)."""
    if name == "tiny":
        jc, tc, bs = jget_config("tiny"), tget_config("tiny"), 32
    else:
        (jc, tc), bs = _narrow_llama(), 64
    jparams = JLlama.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    engines = {}
    for backend in ("reference", "kernel"):
        eng = EngineCore(EngineConfig(
            model_config=tc, block_size=bs, num_blocks=16, max_num_seqs=4,
            max_num_batched_tokens=128, kv_cache_dtype=kv,
            kv_scale_granularity="head" if kv == "int8" else None,
            enable_prefix_caching=False, attn_backend=backend,
            device="cpu"), params=params_from_numpy(tree, "cpu"))
        rng = np.random.default_rng(1)
        for i, n in enumerate((5, 40, 17)):
            eng.add_request(Request(f"r{i}", rng.integers(
                1, tc.vocab_size, n).tolist(), SamplingParams(
                    temperature=0.0, max_tokens=4, ignore_eos=True)))
        engines[backend] = eng
    ref = engines["reference"]
    jcache = {k: jnp.zeros(v.shape, jnp.int8 if v.dtype == torch.int8
                           else (jnp.bfloat16 if v.dtype == torch.bfloat16
                                 else jnp.float32))
              for k, v in ref.kv_cache.items()}
    jfwd = jax.jit(lambda p, kv_, b: JLlama.forward(p, kv_, b, jc, bs,
                                                    "auto"))
    for _ in range(2):                        # prefill, then one decode
        steps = {be: e.scheduler.schedule() for be, e in engines.items()}
        batch, _ = ref._build_batch(steps["reference"])
        want, jcache = jfwd(jparams, jcache,
                            {k: jnp.asarray(v.numpy())
                             for k, v in batch.items()})
        S = len(steps["reference"].scheduled)
        toks = np.asarray(JLlama.compute_logits(jparams, want, jc)).argmax(-1)
        for backend, eng in engines.items():
            b, _ = eng._build_batch(steps[backend])
            got = TLlama.forward(eng.params, eng.kv_cache, b, tc, bs, backend)
            np.testing.assert_allclose(
                got.float().numpy()[:S], np.asarray(want, np.float32)[:S],
                **(TOL if backend == "reference" else TOL_KERNEL))
            for sr, tok in zip(steps[backend].scheduled, toks[:S].tolist()):
                sr.request.num_computed_tokens += sr.num_new_tokens
                sr.request.output_token_ids.append(tok)


@pytest.mark.parametrize("kv,gran", [("bf16", None), ("int8", "token"),
                                     ("int8", "head")])
def test_llama_generate_token_identical_to_jax_engine(kv, gran):
    """tiny (dense), block 32: three requests, sixteen greedy tokens each,
    token for token, in every cache mode."""
    kw = dict(model="tiny", block_size=32, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=128, kv_cache_dtype=kv,
              kv_scale_granularity=gran, enable_prefix_caching=False)
    jeng = JEngineCore(JEngineConfig(**kw))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (5, 40, 17)]
    want = jeng.generate([JRequest(f"r{i}", p, JSamplingParams(
        temperature=0.0, max_tokens=16, ignore_eos=True))
        for i, p in enumerate(prompts)])
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jeng.params), "cpu"))
    assert teng.kv_scale_width == jeng.kv_scale_width
    got = teng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=16, ignore_eos=True))
        for i, p in enumerate(prompts)])
    assert got == want


def _jax_and_port_engines(kw):
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jeng.params), "cpu"))
    return jeng, teng


@pytest.mark.parametrize("model,top_k", [("tiny-mla", 0), ("tiny-mla", 20),
                                         ("tiny", 0), ("tiny", 20)])
def test_sampled_tokens_identical_to_jax_engine(model, top_k, monkeypatch):
    """Random sampling (temperature 1.0, top_p 0.9) through the classic
    step: one seeded and one unseeded request, sixteen tokens each, token
    for token with the JAX engine.  The port draws the JAX package's
    threefry bits, seeded rows from (seed, gen_idx) and unseeded rows from
    the engine key split once per step; tiny-mla runs int8 experts and an
    int8 latent.

    Both engines sample from the JAX forward's logits of each step (the
    port's own forward differs from XLA's by one bf16 ulp in a minority
    of hidden elements, as test_forward_matches_jax allows, which can
    flip a near tie between tokens drawn at temperature 1): the JAX
    program recomputes them, with its own sampler as a check, beside the
    engine's step, and the port's ``compute_logits`` returns them in step
    order."""
    kw = dict(model=model, block_size=32, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=128, enable_prefix_caching=False,
              seed=3)
    if model == "tiny-mla":
        kw.update(quantization="int8", kv_cache_dtype="int8")
    jeng, teng = _jax_and_port_engines(kw)
    jm, jc = jeng.model, jeng.model_config

    @jax.jit
    def logits_and_ids(params, kv, batch, key):
        logits = jm.compute_logits(
            params, jm.forward(params, kv, batch, jc, 32, "auto")[0], jc)
        return logits, JSampling.sample(
            logits, batch["temperature"], batch["top_k"], batch["top_p"],
            key, seeds=batch["seeds"], gen_idx=batch["gen_idx"])

    step_fn = jeng._build_step_fn()
    logits_seen = []

    def recording_step(params, kv, batch, key):
        logits, ids = logits_and_ids(params, kv, batch, key)
        out = step_fn(params, kv, batch, key)
        np.testing.assert_array_equal(np.asarray(ids), np.asarray(out[0]))
        logits_seen.append(torch.from_numpy(np.array(logits)))
        return out

    jeng._step_fn = recording_step
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (9, 23)]
    seeds = (1234, None)

    def reqs(R, SP):
        return [R(f"r{i}", p, SP(temperature=1.0, top_k=top_k, top_p=0.9,
                                 max_tokens=16, seed=sd, ignore_eos=True))
                for i, (p, sd) in enumerate(zip(prompts, seeds))]

    want = jeng.generate(reqs(JRequest, JSamplingParams))
    replay = iter(logits_seen)
    monkeypatch.setattr(teng.model, "compute_logits",
                        lambda *a: next(replay))
    got = teng.generate(reqs(Request, SamplingParams))
    assert got == want
    assert next(replay, None) is None
    assert len(set(got["r0"])) > 1 and len(set(got["r1"])) > 1


def test_chunked_backend_token_identical_to_jax_engine():
    """tiny with attn_backend="chunked" on both packages: three requests,
    sixteen greedy tokens each, token for token."""
    kw = dict(model="tiny", block_size=32, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=128, enable_prefix_caching=False,
              attn_backend="chunked")
    jeng, teng = _jax_and_port_engines(kw)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (5, 40, 17)]
    want = jeng.generate([JRequest(f"r{i}", p, JSamplingParams(
        temperature=0.0, max_tokens=16, ignore_eos=True))
        for i, p in enumerate(prompts)])
    seen = []
    real = TA.ragged_paged_attention_chunked

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    TA.ragged_paged_attention_chunked = spy
    try:
        got = teng.generate([Request(f"r{i}", p, SamplingParams(
            temperature=0.0, max_tokens=16, ignore_eos=True))
            for i, p in enumerate(prompts)])
    finally:
        TA.ragged_paged_attention_chunked = real
    assert seen
    assert got == want


def test_int8_engine_steps_past_512_tokens_matches_jax(monkeypatch):
    """tiny-mla with int8 experts and 1024-token steps: two prompts of 300
    and 400 tokens are prefilled in one 1024-token step (above the 512
    tokens slice 1 allowed; on CPU tensors the experts run dequantized, as
    the JAX package's CPU path runs them) and the greedy tokens match the
    JAX engine."""
    kw = dict(model="tiny-mla", block_size=32, num_blocks=64,
              max_num_seqs=4, max_num_batched_tokens=1024,
              quantization="int8", kv_cache_dtype="int8",
              enable_prefix_caching=False)
    jeng = JEngineCore(JEngineConfig(**kw))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (300, 400)]
    want = jeng.generate([JRequest(f"r{i}", p, JSamplingParams(
        temperature=0.0, max_tokens=4, ignore_eos=True))
        for i, p in enumerate(prompts)])
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jeng.params), "cpu"))
    seen = []
    real = TMoE.forward

    def forward(params, kv, batch, *a, **kw):
        seen.append(batch["token_ids"].shape[0])
        return real(params, kv, batch, *a, **kw)

    monkeypatch.setattr(TMoE, "forward", forward)
    got = teng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=4, ignore_eos=True))
        for i, p in enumerate(prompts)])
    assert max(seen) > 512
    assert got == want


@pytest.mark.parametrize("name", ["tiny", "qwen3-0.6b"])
def test_params_from_numpy_carries_the_llama_tree(name):
    """The dense tree crosses whole and bit-identical; tied embeddings
    (qwen3-0.6b) carry no lm_head, untied ones (tiny) do."""
    over = dict(num_layers=1, vocab_size=64, hidden_size=32,
                intermediate_size=64, num_heads=4, num_kv_heads=2,
                head_dim=8)
    c = dataclasses.replace(jget_config(name), **over)
    tree = jax.tree.map(np.asarray,
                        JLlama.init_params(c, jax.random.PRNGKey(4)))
    got = params_from_numpy(tree, "cpu")
    assert ("lm_head" in got) == (not c.tie_word_embeddings)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_t.keys() == flat_j.keys()
    for path, arr in flat_j.items():
        t = flat_t[path]
        assert tuple(t.shape) == arr.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      arr.astype(np.float32))
    tc = dataclasses.replace(tget_config(name), **over)
    shapes = jax.tree.map(lambda a: a.shape, tree)
    mine = TLlama.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == shapes


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "llm_d_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    # Nor ml_dtypes, aiohttp, prometheus_client, grpc or safetensors: the
    # card machine has none of them (the loader reads safetensors files
    # itself; the metrics and the gateway's HTTP are the port's own).
    banned = re.compile(
        r"^(jax|jaxlib|llm_d_tpu|ml_dtypes|aiohttp|prometheus_client|grpc"
        r"|safetensors)(\.|$)")
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if banned.match(m)]
    assert not bad, bad


@pytest.mark.parametrize("dtype,sw", [("bf16", 1), ("int8", 1), ("int8", 4)])
def test_kv_pool_accounting_matches(dtype, sw):
    layout = TMoE.kv_cache_layout(tget_config("deepseek-v3-bench"))
    assert layout == JMoE.kv_cache_layout(jget_config("deepseek-v3-bench"))
    assert TEngine.kv_bytes_per_token(layout, dtype, sw) == \
        JEngine.kv_bytes_per_token(layout, dtype, sw)
    for budget in (1 << 20, 3 << 30):
        assert TEngine.derive_num_blocks(budget, layout, 16, 64, dtype, sw) \
            == JEngine.derive_num_blocks(budget, layout, 16, 64, dtype, sw)
    for n, lo, hi in ((1, 16, 512), (17, 16, 512), (700, 16, 512)):
        assert TEngine._next_bucket(n, lo, hi) == JEngine._next_bucket(n, lo, hi)


def test_engine_config_defaults_equal_the_jax_dataclass():
    """Every field both packages' ``EngineConfig`` have defaults to the
    same value (the port's default model is ``tiny``, as in JAX)."""
    jfields = {f.name: f for f in dataclasses.fields(JEngineConfig)}
    shared = [f.name for f in dataclasses.fields(EngineConfig)
              if f.name in jfields]
    assert len(shared) >= 25
    assert {"enable_eplb", "eplb_config", "kv_cache_hbm_bytes",
            "stub_components", "spec_strict"} <= set(shared)
    t, j = EngineConfig(), JEngineConfig()
    assert {n: getattr(t, n) for n in shared} == \
        {n: getattr(j, n) for n in shared}
    assert t.model == "tiny"


def test_int8_on_a_dense_model_raises_as_in_jax():
    """``quantization="int8"`` quantizes MoE experts: on a dense model
    both engines refuse to build, with the same message."""
    kw = dict(model="tiny", quantization="int8", block_size=8, num_blocks=16)
    with pytest.raises(ValueError) as je:
        JEngineCore(JEngineConfig(**kw))
    with pytest.raises(ValueError) as te:
        EngineCore(EngineConfig(device="cpu", **kw))
    assert str(te.value) == str(je.value)
    assert "is dense" in str(te.value)


def test_engine_without_device_raises_on_a_cpu_box():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCore(EngineConfig())
