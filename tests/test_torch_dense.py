"""Port parity for the dense (GQA) attention path: kernels G and H (their
plain versions, on CPU tensors) and ``attention_with_kv_update``.

* G, ``paged_attention_decode_update_plain``, against the JAX kernel
  ``paged_attention_decode_update(interpret=True)`` at the shapes of
  ``tests/test_pallas_kernel.py`` and ``tests/test_kv_quant.py`` (bf16
  pages, int8 pages with one scale per row and one per KV head), with a
  stacked layer index and a ``seq_len = 0`` row.  Output atol = rtol =
  2e-2 (the JAX kernel tests' tolerance: same bf16 rounding points, other
  summation order); the updated cache and scale planes identical.
* H, ``flash_prefill_paged_plain``, against ``flash_prefill_paged(
  interpret=True)`` as ``tests/test_flash_prefill.py`` and
  ``tests/test_kv_quant.py`` drive it (pad rows, pad sequences,
  ``soft_cap``, layer), atol = rtol = 2e-2.
* ``attention_with_kv_update`` on a decode batch and a prefill batch, in
  every cache mode, against the JAX reference path (jitted, so the int8
  scales are the engine's): the port's reference path and its kernel path
  (the plain versions of G and H), outputs atol = rtol = 2e-2, caches and
  scale planes identical from block 1 up (block 0 takes the reference
  path's padding rows, which the kernels do not write).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.ops import attention as JA
from llm_d_tpu.ops.pallas.flash_prefill import flash_prefill_paged as j_flash
from llm_d_tpu.ops.pallas.paged_attention import (
    paged_attention_decode_update as j_decode)
from llm_d_tpu.ops.quant import quantize_kv_block as j_quant
from llm_d_tpu_torch.ops import attention as TA
from llm_d_tpu_torch.ops import flash_prefill as TF
from llm_d_tpu_torch.ops import paged_attention as TP

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
_jquant = jax.jit(j_quant, static_argnums=1)


def _t(a):
    """JAX / numpy array -> torch tensor with the same values (bf16 stays
    bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _caches(rng, shape, sw):
    """(k, v, k_scale, v_scale) as JAX arrays: bf16, or int8 with ``sw``
    scale columns (None scales for bf16)."""
    out = []
    for _ in range(2):
        rows = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        out.append((rows, None) if sw == 0 else _jquant(rows, sw))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _tables(rng, seq_lens, bs, num_blocks):
    S = len(seq_lens)
    B = max(-(-int(max(seq_lens)) // bs), 1)
    bt = (rng.permutation(num_blocks - 1)[:S * B] + 1).reshape(S, B)
    bt[np.asarray(seq_lens) == 0] = 0
    return bt.astype(np.int32)


@pytest.mark.parametrize("H,KVH,D,bs,sw", [
    (8, 8, 64, 16, 0),           # MHA, F 512
    (8, 2, 64, 32, 0),           # GQA 4, F 128
    (8, 4, 128, 16, 0),          # GQA 2, d 128
    (4, 1, 64, 16, 0),           # MQA, F 64
    (8, 2, 64, 32, 1),           # int8, one scale per row
    (8, 2, 64, 32, 2),           # int8, one scale per KV head
])
def test_paged_decode_plain_matches_tpu_kernel(H, KVH, D, bs, sw):
    rng = np.random.default_rng(H * 131 + KVH * 17 + D + bs + sw)
    seq_lens = [1, bs // 2, bs, bs + 3, 3 * bs, 0]
    S, L, layer, F = len(seq_lens), 3, 1, KVH * D
    nblk = S * 3 + 1
    k, v, ks, vs = _caches(rng, (L, nblk * bs, F), sw)
    bt = _tables(rng, seq_lens, bs, nblk)
    lens = np.asarray(seq_lens, np.int32)
    q = jnp.asarray(rng.standard_normal((S, H, D)), jnp.bfloat16)
    kn = jnp.asarray(rng.standard_normal((S, F)), jnp.bfloat16)
    vn = jnp.asarray(rng.standard_normal((S, F)), jnp.bfloat16)
    kns = vns = None
    if sw:
        kn, kns = _jquant(kn, sw)
        vn, vns = _jquant(vn, sw)
    want = j_decode(q, kn, vn, k, v, jnp.asarray(bt), jnp.asarray(lens),
                    block_size=bs, num_kv_heads=KVH, scale=0.15,
                    layer=jnp.asarray(layer, jnp.int32), interpret=True,
                    k_scale=ks, v_scale=vs, k_scale_new=kns,
                    v_scale_new=vns)
    planes = [_t(a) if a is not None else None for a in (k, v, ks, vs)]
    got = TP.paged_attention_decode_update(
        _t(q), _t(kn), _t(vn), planes[0], planes[1], _t(bt), _t(lens), bs,
        KVH, scale=0.15, layer=layer, k_scale=planes[2], v_scale=planes[3],
        k_scale_new=None if kns is None else _t(kns),
        v_scale_new=None if vns is None else _t(vns))
    np.testing.assert_allclose(_f32(got), _f32(want[0]), **TOL)
    assert not np.any(_f32(got)[lens == 0])
    for mine, theirs in zip([p for p in planes if p is not None], want[1:]):
        np.testing.assert_array_equal(_f32(mine)[:, bs:],
                                      _f32(theirs)[:, bs:])


def _prefill_case(rng, S, Q, H, KVH, D, bs, num_blocks, seq_lens, new_lens,
                  L, sw):
    """Sequences whose last ``new_lens[i]`` positions are this step's
    queries (chunked prefill), pad slots at position -1."""
    F = KVH * D
    k, v, ks, vs = _caches(rng, (L, num_blocks * bs, F), sw)
    bt = _tables(rng, [max(n, 1) for n in seq_lens], bs, num_blocks)
    qs = np.zeros((S, Q, H, D), np.float32)
    q_pos = np.full((S, Q), -1, np.int32)
    for s in range(S):
        n = new_lens[s]
        qs[s, :n] = rng.standard_normal((n, H, D))
        q_pos[s, :n] = np.arange(seq_lens[s] - n, seq_lens[s])
    return (jnp.asarray(qs, jnp.bfloat16), q_pos, k, v, ks, vs, bt,
            np.asarray(seq_lens, np.int32))


@pytest.mark.parametrize("H,KVH,D,bs,sw,soft_cap,pad_seqs", [
    (8, 8, 64, 16, 0, None, False),     # MHA
    (8, 2, 64, 32, 0, None, True),      # GQA 4, pad sequences
    (4, 1, 128, 16, 0, None, False),    # MQA, d 128
    (4, 2, 64, 16, 0, 30.0, False),     # soft cap
    (8, 2, 64, 32, 1, None, False),     # int8, per row
    (8, 2, 64, 32, 2, 30.0, False),     # int8, per KV head, soft cap
])
def test_flash_prefill_plain_matches_tpu_kernel(H, KVH, D, bs, sw, soft_cap,
                                                pad_seqs):
    rng = np.random.default_rng(H * 7 + KVH * 3 + D + bs + sw)
    seq_lens = [1, bs // 2, bs, 2 * bs + 3, 3 * bs]
    new_lens = [1, bs // 2, bs // 2, 5, 3 * bs]
    if pad_seqs:
        seq_lens[-2:] = new_lens[-2:] = [0, 0]
    S, Q, L, layer = len(seq_lens), 3 * bs, 2, 1
    qs, q_pos, k, v, ks, vs, bt, lens = _prefill_case(
        rng, S, Q, H, KVH, D, bs, S * 3 + 1, seq_lens, new_lens, L, sw)
    if pad_seqs:
        bt[-2:] = 0
    want = j_flash(qs, jnp.asarray(q_pos), k, v, jnp.asarray(bt),
                   jnp.asarray(lens), block_size=bs, num_kv_heads=KVH,
                   scale=0.17, soft_cap=soft_cap,
                   layer=jnp.asarray(layer, jnp.int32), interpret=True,
                   k_scale=ks, v_scale=vs)
    got = TF.flash_prefill_paged(
        _t(qs), _t(q_pos), _t(k), _t(v), _t(bt), _t(lens), bs, KVH,
        scale=0.17, soft_cap=soft_cap, layer=layer,
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    assert not np.any(_f32(got)[q_pos < 0])


def _batch(seqs, bt, bs, T, S, Q):
    """Engine-layout ragged batch for sequences ``(start, n)``: n new
    tokens at positions start..start+n-1; padding as the engine pads
    (tokens to slot 0 of the trash block, sequences of length 0)."""
    b = dict(positions=np.zeros(T, np.int32),
             token_seq_ids=np.zeros(T, np.int32),
             token_qpos=np.zeros(T, np.int32),
             slot_mapping=np.zeros(T, np.int32),
             block_tables=np.zeros((S, bt.shape[1]), np.int32),
             seq_lens=np.zeros(S, np.int32),
             qtok_idx=np.full((S, Q), T, np.int32))
    t = 0
    for s, (start, n) in enumerate(seqs):
        pos = np.arange(start, start + n)
        b["positions"][t:t + n] = pos
        b["token_seq_ids"][t:t + n] = s
        b["token_qpos"][t:t + n] = np.arange(n)
        b["slot_mapping"][t:t + n] = bt[s, pos // bs] * bs + pos % bs
        b["qtok_idx"][s, :n] = np.arange(t, t + n)
        b["block_tables"][s] = bt[s]
        b["seq_lens"][s] = start + n
        t += n
    return b, t


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("sw", [0, 1, 2])
def test_attention_with_kv_update_matches_jax_reference(mode, sw):
    rng = np.random.default_rng(sw * 10 + len(mode))
    H, KVH, D, bs, L, layer = 8, 2, 64, 32, 2, 1
    F = KVH * D
    if mode == "decode":
        seqs, T, Q = [(0, 1), (bs - 1, 1), (bs, 1), (2 * bs + 4, 1)], 8, 1
    else:
        seqs, T, Q = [(0, 20), (bs + 3, 9), (0, 1)], 32, 32
    S = len(seqs) + 1                                 # one pad sequence
    nblk = S * 4 + 1
    k, v, ks, vs = _caches(rng, (L, nblk * bs, F), sw)
    bt = _tables(rng, [4 * bs] * (S - 1) + [0], bs, nblk)
    b, n_real = _batch(seqs, bt, bs, T, S, Q)
    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.bfloat16)
    kn = jnp.asarray(rng.standard_normal((T, KVH, D)), jnp.bfloat16)
    vn = jnp.asarray(rng.standard_normal((T, KVH, D)), jnp.bfloat16)

    def jattend(q, kn, vn, k, v, ks, vs, b):
        return JA.attention_with_kv_update(
            q, kn, vn, k, v, b, block_size=bs, scale=0.125,
            backend="reference", layer=jnp.int32(layer), k_scale=ks,
            v_scale=vs)

    jfn = jax.jit(jattend)
    want = jfn(q, kn, vn, k, v, ks, vs,
               {n: jnp.asarray(a) for n, a in b.items()})
    for backend in ("reference", "kernel"):
        planes = [_t(a) if a is not None else None for a in (k, v, ks, vs)]
        got = TA.attention_with_kv_update(
            _t(q), _t(kn), _t(vn), planes[0], planes[1],
            {n: _t(a) for n, a in b.items()}, block_size=bs, scale=0.125,
            backend=backend, layer=layer, k_scale=planes[2],
            v_scale=planes[3])
        assert len(got) == len(want) == (5 if sw else 3)
        np.testing.assert_allclose(_f32(got[0])[:n_real],
                                   _f32(want[0])[:n_real], **TOL)
        for mine, theirs in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_f32(mine)[:, bs:],
                                          _f32(theirs)[:, bs:])
