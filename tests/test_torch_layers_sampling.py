"""Port parity: transformer building blocks and sampling
(llm_d_tpu_torch.ops.layers / ops.sampling vs llm_d_tpu.ops.*).

Layers are compared in f32 (atol 1e-5: only summation order differs).
Greedy sampling must give identical ids; random rows must give identical
ids when both packages see the same Gumbel noise (the JAX noise is drawn
with the JAX package's own per-row keys and handed to the port).  The
port's own noise is held to JAX's bit for bit in test_torch_prng.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.ops import layers as JL
from llm_d_tpu.ops import sampling as JS
from llm_d_tpu_torch.ops import layers as TL
from llm_d_tpu_torch.ops import prng
from llm_d_tpu_torch.ops import sampling as TS

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_layers_f32_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=ATOL)

    pos = (np.arange(9) * 37).astype(np.int32)
    cj, sj = JL.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    ct, st = TL.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    q = rng.standard_normal((9, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TL.apply_rope(_t(q), ct, st).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(q), cj, sj)), atol=ATOL)

    wg, wu = (rng.standard_normal((48, 40)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rng.standard_normal((40, 48)).astype(np.float32) * 0.1
    b = rng.standard_normal(40).astype(np.float32)
    np.testing.assert_allclose(
        TL.linear(_t(x), _t(wg), _t(b)).numpy(),
        np.asarray(JL.linear(jnp.asarray(x), jnp.asarray(wg),
                             jnp.asarray(b))), atol=ATOL)
    np.testing.assert_allclose(
        TL.swiglu_mlp(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        np.asarray(JL.swiglu_mlp(*map(jnp.asarray, (x, wg, wu, wd)))),
        atol=ATOL)


def test_bf16_swiglu_rounds_like_jax():
    """bf16 SwiGLU rounds at every elementwise step, as jax.nn.silu
    lowers (x * 1/(1 + exp(-x))): identical bits."""
    rng = np.random.default_rng(1)
    x, wg, wu = (jnp.asarray(rng.standard_normal(s) * sc, jnp.bfloat16)
                 for s, sc in (((32, 64), 1.0), ((64, 96), 0.2),
                               ((64, 96), 0.2)))
    wd = jnp.asarray(rng.standard_normal((96, 64)) * 0.1, jnp.bfloat16)
    want = np.asarray(jax.jit(JL.swiglu_mlp)(x, wg, wu, wd), np.float32)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
          for a in (x, wg, wu, wd)]
    np.testing.assert_array_equal(TL.swiglu_mlp(*tb).float().numpy(), want)


def _sample_inputs(seed, S=6, V=300):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 0.9], np.float32)[:S]
    top_k = np.array([0, 5, 0, 40, 1, 0], np.int32)[:S]
    top_p = np.array([1.0, 1.0, 0.8, 0.95, 1.0, 0.3], np.float32)[:S]
    seeds = np.arange(S, dtype=np.int32) * 7 + 3
    gen = np.arange(S, dtype=np.int32) * 2
    return logits, temp, top_k, top_p, seeds, gen


def test_greedy_ids_identical():
    logits, *_ = _sample_inputs(3)
    S = logits.shape[0]
    z = np.zeros(S, np.float32)
    want = np.asarray(JS.sample(
        jnp.asarray(logits), jnp.asarray(z), jnp.zeros(S, jnp.int32),
        jnp.ones(S), jax.random.PRNGKey(0)))
    got = TS.sample(_t(logits), torch.zeros(S), torch.zeros(S, dtype=torch.int32),
                    torch.ones(S))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_topp_with_shared_noise(seed):
    logits, temp, top_k, top_p, seeds, gen = _sample_inputs(seed)
    S, V = logits.shape
    K = min(TS.TOPK_MAX, V)
    assert K == JS.TOPK_MAX
    base = jax.random.PRNGKey(0)
    noise = np.stack([np.asarray(jax.random.gumbel(
        jax.random.fold_in(jax.random.fold_in(base, int(s)), int(g)), (K,),
        jnp.float32)) for s, g in zip(seeds, gen)])
    want = np.asarray(JS.sample(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jax.random.PRNGKey(1), seeds=jnp.asarray(seeds),
        gen_idx=jnp.asarray(gen)))
    got = TS.sample(_t(logits), torch.from_numpy(temp),
                    torch.from_numpy(top_k), torch.from_numpy(top_p),
                    noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


def test_seeded_rows_repeat_and_ignore_batch():
    """Seeded rows draw from (seed, gen_idx): the same position gives the
    same token whatever the step key and whatever else is in the batch."""
    logits, temp, top_k, top_p, seeds, gen = _sample_inputs(4)
    args = (_t(logits), torch.from_numpy(temp), torch.from_numpy(top_k),
            torch.from_numpy(top_p))
    k1, k2 = prng.prng_key(1), prng.prng_key(2)
    a = TS.sample(*args, key=k1, seeds=torch.from_numpy(seeds),
                  gen_idx=torch.from_numpy(gen))
    b = TS.sample(*args, key=k2, seeds=torch.from_numpy(seeds),
                  gen_idx=torch.from_numpy(gen))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    c = TS.sample(*(t[2:] for t in args), key=k1,
                  seeds=torch.from_numpy(seeds[2:]),
                  gen_idx=torch.from_numpy(gen[2:]))
    np.testing.assert_array_equal(c.numpy(), a.numpy()[2:])


def test_ties_keep_lower_index_first():
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 4)
    tv, ti = TS.top_k_stable(_t(logits), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    z = torch.zeros(2)
    got = TS.sample(_t(logits), z, torch.zeros(2, dtype=torch.int32),
                    torch.ones(2))
    want = JS.sample(jnp.asarray(logits), jnp.zeros(2), jnp.zeros(2, jnp.int32),
                     jnp.ones(2), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1, 0]


def test_logprobs_match():
    logits, *_ = _sample_inputs(5)
    ids = np.array([3, 0, 299, 17, 5, 8], np.int32)
    np.testing.assert_allclose(
        TS.compute_logprobs(_t(logits), torch.from_numpy(ids)).numpy(),
        np.asarray(JS.compute_logprobs(jnp.asarray(logits), jnp.asarray(ids))),
        atol=ATOL)
    ct, it, lt = TS.compute_top_logprobs(_t(logits), torch.from_numpy(ids), 5)
    cj, ij, lj = JS.compute_top_logprobs(jnp.asarray(logits),
                                         jnp.asarray(ids), 5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
