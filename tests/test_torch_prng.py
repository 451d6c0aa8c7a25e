"""Port parity: threefry-2x32 keys and Gumbel noise
(``llm_d_tpu_torch.ops.prng``) bit for bit against ``jax.random``, and
the sampler's per-row noise against the JAX sampler's own keys.

Everything here is integer arithmetic or f32 arithmetic with one
rounding per operation, so the comparisons are exact: keys, raw bits,
uniforms, the logarithm on every float JAX's uniform can return, and
Gumbel noise for seeded rows (seeds 0, 7, 2**31 - 1 at several
``gen_idx``) and unseeded rows (``fold_in(step_key, row)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.ops import sampling as JS
from llm_d_tpu_torch.ops import prng as P
from llm_d_tpu_torch.ops import sampling as TS

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

SEEDS = (0, 7, 2**31 - 1)
GEN_IDX = (0, 1, 15, 1000)


def _key(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, -1, -5, 2**32 + 5])
def test_prng_key_fold_in_and_split(seed):
    key = P.prng_key(seed)
    assert key == _key(jax.random.PRNGKey(seed))
    jk = jax.random.PRNGKey(seed)
    for d in (0, 1, 12345, 2**31 - 1):
        assert P.fold_in(key, d) == _key(jax.random.fold_in(jk, d))
    want = [_key(k) for k in jax.random.split(jk, 3)]
    assert P.split(key, 3) == want
    a, b = P.split(key)
    ja, jb = jax.random.split(jk)
    assert (a, b) == (_key(ja), _key(jb))


def test_fold_in_on_tensors_matches_scalars():
    data = torch.tensor([0, 3, 2**31 - 1, -1], dtype=torch.int32)
    k0, k1 = P.fold_in(P.prng_key(9), data)
    for i, d in enumerate(data.tolist()):
        assert (int(k0[i]), int(k1[i])) == P.fold_in(P.prng_key(9),
                                                     d & 0xFFFFFFFF)


def test_random_bits_and_uniform_match_jax():
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        k = tuple(torch.tensor(w) for w in P.prng_key(seed))
        bits = P.random_bits(k, 257)
        want = np.asarray(jax.random.bits(jk, (257,), jnp.uint32))
        np.testing.assert_array_equal(bits.numpy(), want.astype(np.int64))
        tiny = jnp.finfo(jnp.float32).tiny
        _bits_equal(P.uniform_from_bits(bits),
                    jax.random.uniform(jk, (257,), jnp.float32, tiny, 1.0))


def test_log_matches_xla_on_every_uniform():
    """Every f32 that ``jax.random.uniform(minval=tiny)`` can return
    (the 2**23 multiples of 2**-23, the least one raised to tiny) and the
    negated logs of those, through ``prng.xla_log`` and ``jnp.log``."""
    u = np.arange(1 << 23, dtype=np.float64) * 2.0 ** -23
    u = np.maximum(u, np.finfo(np.float32).tiny).astype(np.float32)
    want = np.asarray(jnp.log(jnp.asarray(u)))
    _bits_equal(P.xla_log(torch.from_numpy(u)), want)
    nl = -want
    _bits_equal(P.xla_log(torch.from_numpy(nl)), jnp.log(jnp.asarray(nl)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_of_seeded_rows_matches_jax(seed):
    base = jax.random.PRNGKey(0)
    keys = [jax.random.fold_in(jax.random.fold_in(base, seed), g)
            for g in GEN_IDX]
    want = np.stack([np.asarray(jax.random.gumbel(k, (64,), jnp.float32))
                     for k in keys])
    S = len(GEN_IDX)
    got = TS.row_noise(S, 64, torch.device("cpu"), P.prng_key(123),
                       seeds=torch.full((S,), seed, dtype=torch.int32),
                       gen_idx=torch.tensor(GEN_IDX, dtype=torch.int32))
    _bits_equal(got, want)


def test_gumbel_of_unseeded_and_mixed_rows_matches_jax():
    """Rows without a seed draw from ``fold_in(step_key, row)``, the step
    key being the second half of ``split`` of the engine's key."""
    _, jstep = jax.random.split(jax.random.PRNGKey(4))
    _, step = P.split(P.prng_key(4))
    assert step == _key(jstep)
    seeds = np.array([-1, 7, -1, 0, 2**31 - 1, -1], np.int32)
    gen = np.array([3, 1, 0, 15, 1000, 2], np.int32)
    want = []
    for row, (s, g) in enumerate(zip(seeds, gen)):
        k = (jax.random.fold_in(jstep, row) if s < 0 else
             jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                   int(s)), int(g)))
        want.append(np.asarray(jax.random.gumbel(k, (64,), jnp.float32)))
    got = TS.row_noise(len(seeds), 64, torch.device("cpu"), step,
                       seeds=torch.from_numpy(seeds),
                       gen_idx=torch.from_numpy(gen))
    _bits_equal(got, np.stack(want))


def test_sample_with_a_key_matches_jax_sample():
    """The whole sampler, its noise drawn from the key on both sides:
    identical ids for mixed seeded, unseeded and greedy rows."""
    rng = np.random.default_rng(11)
    S, V = 8, 300
    logits = rng.standard_normal((S, V)).astype(np.float32) * 3
    temp = np.array([1.0, 0.7, 0.0, 1.3, 1.0, 0.5, 1.0, 2.0], np.float32)
    top_k = np.array([0, 20, 0, 5, 0, 64, 3, 0], np.int32)
    top_p = np.array([0.9, 1.0, 1.0, 0.8, 0.95, 1.0, 1.0, 0.5], np.float32)
    seeds = np.array([-1, 7, -1, 0, 2**31 - 1, -1, 5, 5], np.int32)
    gen = np.array([0, 1, 2, 3, 4, 5, 6, 7], np.int32)
    for step_seed in range(3):
        jkey = jax.random.PRNGKey(step_seed)
        want = np.asarray(JS.sample(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
            jnp.asarray(top_p), jkey, seeds=jnp.asarray(seeds),
            gen_idx=jnp.asarray(gen)))
        got = TS.sample(torch.from_numpy(logits), torch.from_numpy(temp),
                        torch.from_numpy(top_k), torch.from_numpy(top_p),
                        key=P.prng_key(step_seed),
                        seeds=torch.from_numpy(seeds),
                        gen_idx=torch.from_numpy(gen))
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_without_key_or_noise_raises():
    logits = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="key"):
        TS.sample(logits, torch.ones(2), torch.zeros(2, dtype=torch.int32),
                  torch.ones(2))
