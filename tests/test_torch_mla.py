"""Port parity: MLA attention (kernels A and B, and the MLA block).

The plain PyTorch versions of the decode (A) and prefill (B) kernels are
held to the TPU kernels in interpret mode, bf16 and int8 latent caches,
with the tolerance the JAX kernel tests use (atol = rtol = 2e-2: q and p
are rounded to bf16 before their dots).  The decode splice must leave the
cache and scale planes bit-identical.  ``mla_attention_block`` is held to
the JAX block on its CPU path, through the port's reference path and
through its kernel path (the plain versions on CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.models import mla as JMLA
from llm_d_tpu.models.config import ModelConfig as JConfig
from llm_d_tpu.ops import quant as JQ
from llm_d_tpu.ops.pallas.mla_attention import mla_paged_decode_update
from llm_d_tpu.ops.pallas.mla_prefill import mla_flash_prefill
from llm_d_tpu_torch.models import mla as TMLA
from llm_d_tpu_torch.models.config import ModelConfig as TConfig
from llm_d_tpu_torch.models.convert import params_from_numpy, \
    tensor_from_numpy
from llm_d_tpu_torch.ops import mla_decode, mla_prefill

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cache(rng, quantized, L, slots, F):
    shape = (slots, F) if L is None else (L, slots, F)
    rows = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    if not quantized:
        return rows, None
    q, s = jax.jit(JQ.quantize_kv_block, static_argnums=1)(rows, 1)
    return q, s


def _tables(rng, seq_lens, bs, num_blocks):
    S = len(seq_lens)
    B = max(max(-(-int(n) // bs) for n in seq_lens), 1)
    perm = rng.permutation(num_blocks - 1)[: S * B] + 1
    bt = perm.reshape(S, B).astype(np.int32)
    bt[np.asarray(seq_lens) == 0] = 0          # pad rows -> null block
    return jnp.asarray(bt)


@pytest.mark.parametrize("quantized,L,layer,bs,long", [
    pytest.param(False, None, None, 16, False, id="False-None-None-16"),
    pytest.param(True, None, None, 32, False, id="True-None-None-32"),
    pytest.param(True, 3, 1, 32, False, id="True-3-1-32"),
    # A context of ten pages: the card kernel splits it into page ranges.
    pytest.param(True, 3, 1, 32, True, id="True-3-1-32-long")])
def test_decode_plain_matches_tpu_kernel(quantized, L, layer, bs, long):
    rng = np.random.default_rng(10 + bs + (L or 0))
    H, F = 4, 128
    seq_lens = [1, bs // 2, bs, bs + 3, 2 * bs + 5, 0, 0, 0]
    if long:
        seq_lens = [9 * bs + 5, bs + 3, 0, 1]
    S = len(seq_lens)
    num_blocks = S * max(3, -(-max(seq_lens) // bs)) + 1
    kv, ks = _cache(rng, quantized, L, num_blocks * bs, F)
    bt = _tables(rng, seq_lens, bs, num_blocks)
    lens = jnp.asarray(seq_lens, jnp.int32)
    q = jnp.asarray(rng.standard_normal((S, H, F)), jnp.bfloat16)
    row = jnp.asarray(rng.standard_normal((S, F)), jnp.bfloat16)
    if quantized:
        row, row_s = jax.jit(JQ.quantize_kv_block, static_argnums=1)(row, 1)
    scale = 0.19
    lay = None if layer is None else jnp.int32(layer)
    res = mla_paged_decode_update(
        q, row, kv, bt, lens, block_size=bs, scale=scale, layer=lay,
        interpret=True, kv_scale=ks,
        row_scale_new=row_s if quantized else None)

    kv_t, ks_t = _t(kv), (_t(ks) if quantized else None)
    out = mla_decode.mla_paged_decode_update(
        _t(q), _t(row), kv_t, _t(bt), _t(lens), bs, scale, layer=layer,
        kv_scale=ks_t, row_scale_new=_t(row_s) if quantized else None)
    live = np.asarray(seq_lens) > 0
    np.testing.assert_allclose(_f32(out)[live], _f32(res[0])[live], **TOL)
    np.testing.assert_array_equal(_f32(out)[~live], 0.0)
    np.testing.assert_array_equal(_f32(kv_t), _f32(res[1]))
    if quantized:
        np.testing.assert_array_equal(ks_t.numpy(), np.asarray(res[2]))


@pytest.mark.parametrize("quantized,L,layer,bs", [
    (False, None, None, 16), (True, 3, 2, 32)])
def test_prefill_plain_matches_tpu_kernel(quantized, L, layer, bs):
    rng = np.random.default_rng(40 + bs)
    H, F, Q = 4, 128, 16
    seq_lens = [Q, bs + 7, 3 * bs, 0]
    S = len(seq_lens)
    num_blocks = S * 3 + 1
    kv, ks = _cache(rng, quantized, L, num_blocks * bs, F)
    bt = _tables(rng, seq_lens, bs, num_blocks)
    q_pos = np.full((S, Q), -1, np.int32)
    q_pos[0] = np.arange(Q)                           # a whole prompt
    q_pos[1, :10] = np.arange(bs - 3, bs + 7)          # chunk, pad tail
    q_pos[2, :Q] = np.arange(3 * bs - Q, 3 * bs)       # last chunk
    qs = jnp.asarray(rng.standard_normal((S, Q, H, F)), jnp.bfloat16)
    lens = jnp.asarray(seq_lens, jnp.int32)
    scale = 0.23
    lay = None if layer is None else jnp.int32(layer)
    want = mla_flash_prefill(qs, jnp.asarray(q_pos), kv, bt, lens,
                             block_size=bs, scale=scale, layer=lay,
                             interpret=True, kv_scale=ks)
    got = mla_prefill.mla_flash_prefill(
        _t(qs), _t(q_pos), _t(kv), _t(bt), _t(lens), bs, scale,
        layer=layer, kv_scale=_t(ks) if quantized else None)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    np.testing.assert_array_equal(_f32(got)[q_pos < 0], 0.0)


def _mla_config():
    kw = dict(name="mla-test", vocab_size=64, hidden_size=64,
              intermediate_size=96, num_layers=2, num_heads=4,
              num_kv_heads=1, rope_theta=10000.0, max_model_len=256,
              num_experts=4, num_experts_per_tok=2,
              moe_intermediate_size=32, q_lora_rank=32, kv_lora_rank=32,
              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    return JConfig(**kw), TConfig(**kw)


def _batch(seqs, bs, T, S, Q, B):
    """Engine-layout batch for sequences (start, n, block_ids)."""
    a = dict(token_ids=np.zeros(T, np.int32), positions=np.zeros(T, np.int32),
             token_seq_ids=np.zeros(T, np.int32),
             token_qpos=np.zeros(T, np.int32),
             slot_mapping=np.zeros(T, np.int32),
             block_tables=np.zeros((S, B), np.int32),
             seq_lens=np.zeros(S, np.int32),
             qtok_idx=np.full((S, Q), T, np.int32))
    t = 0
    for s, (start, n, blocks) in enumerate(seqs):
        pos = np.arange(start, start + n)
        blocks = np.asarray(blocks, np.int32)
        a["positions"][t:t + n] = pos
        a["token_seq_ids"][t:t + n] = s
        a["token_qpos"][t:t + n] = np.arange(n)
        a["slot_mapping"][t:t + n] = blocks[pos // bs] * bs + pos % bs
        a["qtok_idx"][s, :n] = np.arange(t, t + n)
        a["block_tables"][s, :len(blocks)] = blocks
        a["seq_lens"][s] = start + n
        t += n
    return a


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_mla_block_matches_jax(backend):
    """Prefill then one decode step through the whole MLA block with an
    int8 latent (stacked cache, layer 1): outputs within 2e-2, and the
    written latent rows and scales identical."""
    jc, tc = _mla_config()
    rng = np.random.default_rng(7)
    bs, L, nblk, layer = 32, 2, 8, 1
    lp_j = {k: v[layer] for k, v in JMLA.init_mla_params(
        jc, L, jax.random.PRNGKey(3), jnp.bfloat16).items()}
    lp_t = params_from_numpy(jax.tree.map(np.asarray, lp_j), "cpu")
    F_cache = 128
    kv_j = jnp.zeros((L, nblk * bs, F_cache), jnp.int8)
    ks_j = jnp.zeros((L, nblk * bs, 1), jnp.float32)
    kv_t, ks_t = torch.zeros(kv_j.shape, dtype=torch.int8), \
        torch.zeros(ks_j.shape)
    blocks = [[1, 2], [3]]
    B = 4
    steps = [([(0, 37, blocks[0]), (0, 9, blocks[1])], 64, 2, 64),
             ([(37, 1, blocks[0]), (9, 1, blocks[1])], 16, 8, 1)]
    jfn = jax.jit(lambda lp, x, b, kv, ks: JMLA.mla_attention_block(
        lp, jc, x, b, kv, bs, "auto", jnp.int32(layer), kv_scale=ks))
    for seqs, T, S, Q in steps:
        arr = _batch(seqs, bs, T, S, Q, B)
        x = jnp.asarray(rng.standard_normal((T, jc.hidden_size)),
                        jnp.bfloat16)
        out_j, kv_j, ks_j = jfn(lp_j, x, {k: jnp.asarray(v)
                                          for k, v in arr.items()},
                                kv_j, ks_j)
        out_t = TMLA.mla_attention_block(
            lp_t, tc, _t(x), {k: torch.from_numpy(v) for k, v in arr.items()},
            kv_t, bs, backend, layer, kv_scale=ks_t)
        n_real = sum(n for _, n, _ in seqs)
        np.testing.assert_allclose(_f32(out_t)[:n_real],
                                   _f32(out_j)[:n_real], **TOL)
        # Block 0 is the trash block padding tokens write to (the decode
        # kernel writes only real rows); every other slot must match.
        np.testing.assert_array_equal(kv_t.numpy()[:, bs:],
                                      np.asarray(kv_j)[:, bs:])
        np.testing.assert_array_equal(ks_t.numpy()[:, bs:],
                                      np.asarray(ks_j)[:, bs:])


def test_prefill_shared_memory_plan():
    """The host copy of kernel B's shared-memory plan (q tile of 2
    positions x 16 heads, two key tiles, their scales, the score exchange
    of 4 F parts) and the key tile it picks: 64 keys for int8 rows and 32
    for bf16 ones at the bench's F = 640, since two bf16 tiles of 64 rows
    do not fit.  The key tile does not depend on the block size, so the
    shared cache check admits bf16 pages of 64 rows and int8 ones of 96."""
    from llm_d_tpu_torch.ops import _build
    plan = mla_prefill.smem_bytes
    q_tile = 32 * 648 * 2
    assert plan(640, 64, 1, True) == \
        q_tile + 2 * 64 * 656 + 2 * 64 * 4 + 4 * 32 * 72 * 4
    assert plan(640, 32, 1, False) == \
        q_tile + 2 * 32 * 1296 + 4 * 32 * 40 * 4
    assert plan(640, 64, 1, False) > _build.MAX_SMEM_PER_BLOCK
    assert mla_prefill.key_tile(640, 1, True) == 64
    assert mla_prefill.key_tile(640, 1, False) == 32
    assert mla_prefill.key_tile(768, 1, False) == 32
    q = torch.zeros((1, 2, 16, 640), dtype=torch.bfloat16)

    def check(cond, msg):
        if not cond:
            raise ValueError(msg)

    kv8 = torch.zeros((1, 192, 640), dtype=torch.int8)
    scale = torch.zeros((1, 192, 1), dtype=torch.float32)
    for bs in (64, 96):
        mla_decode.check_cache(check, q, kv8, scale, bs, 0)
    kv16 = torch.zeros((1, 128, 640), dtype=torch.bfloat16)
    for bs in (16, 32, 64):
        mla_decode.check_cache(check, q, kv16, None, bs, 0)


def test_decode_key_tile_covers_every_block_size():
    """Kernel A's key tile: the page where two pages fit a block's shared
    memory at F = 640 (so the bench's int8 64-row pages keep their
    tiling), else the largest of 128, 64, 32, 16 rows that divides the
    page and fits -- for every block size the JAX kernel serves (bf16
    ``% 16``, int8 ``% 32``) up to 1024 rows."""
    from llm_d_tpu_torch.ops import _build
    tile = mla_decode.decode_key_tile
    assert tile(640, 64, 1, True) == 64
    assert tile(640, 64, 1, False) == 64
    assert tile(640, 128, 1, False) == 64
    assert tile(640, 96, 1, False) == 32
    assert tile(640, 160, 1, True) == 32
    assert tile(640, 256, 1, True) == 128
    for quantized, step in ((False, 16), (True, 32)):
        for bs in range(step, 1025, step):
            kt = tile(640, bs, 1, quantized)
            assert kt >= 16 and bs % kt == 0, (quantized, bs)
            assert mla_decode._split_smem_bytes(640, kt, 1, quantized) \
                <= _build.MAX_SMEM_PER_BLOCK
