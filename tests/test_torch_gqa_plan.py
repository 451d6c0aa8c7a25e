"""Kernels G and H of the port: their host-side plans, and their plain
versions against the JAX kernels at pages larger than the first CUDA
versions could hold.

* ``paged_attention.decode_plan`` (G) and ``flash_prefill.prefill_plan``
  (H) size a key tile from D, the cache dtype and the heads a block
  covers, never from the block size: for every block size the JAX
  kernels serve (16-512, int8 in multiples of 32), D 64 and 128, G 1-16
  (H: up to 64) and every cache mode, the tile meets the kernel's
  conditions and its shared memory fits, and the shared cache checks
  admit the layout.  ``num_splits`` (G's key-tile ranges) is a function
  of shapes only.
* ``paged_attention_decode_update_plain`` and ``flash_prefill_paged_plain``
  against ``paged_attention_decode_update(interpret=True)`` and
  ``flash_prefill_paged(interpret=True)`` at 256-row pages and D = 128,
  atol = rtol = 2e-2 (the JAX kernel tests' tolerance); G's cache and
  scale planes identical after the splice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.ops.pallas.flash_prefill import flash_prefill_paged as j_flash
from llm_d_tpu.ops.pallas.paged_attention import (
    paged_attention_decode_update as j_decode)
from llm_d_tpu_torch.ops import _build
from llm_d_tpu_torch.ops import flash_prefill as TF
from llm_d_tpu_torch.ops import paged_attention as TP
from test_torch_dense import TOL, _caches, _f32, _jquant, _t, _tables

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

BLOCK_SIZES = tuple(range(16, 513, 16))
# (H, KVH): G = 1 .. 16 over KV head counts of 1 to 32.
GROUPS = [(8, 8), (32, 32), (16, 8), (12, 4), (32, 8), (24, 4), (48, 8),
          (64, 8), (16, 2), (16, 1), (20, 2), (12, 1), (6, 6), (30, 3)]


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def _layout(H, KVH, D, sw, slots=64):
    """Zero caches of one layer and queries of the layout (CPU)."""
    F = KVH * D
    dtype = torch.int8 if sw else torch.bfloat16
    k = torch.zeros((1, slots, F), dtype=dtype)
    v = torch.zeros((1, slots, F), dtype=dtype)
    ks = vs = None
    if sw:
        ks = torch.zeros((1, slots, sw), dtype=torch.float32)
        vs = torch.zeros((1, slots, sw), dtype=torch.float32)
    return torch.zeros((2, H, D), dtype=torch.bfloat16), k, v, ks, vs


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode", ["bf16", "int8-token", "int8-head"])
def test_decode_plan_fits_every_layout(D, mode):
    """G's plan: four warps over ``wh`` KV heads (the largest of 4, 2, 1
    dividing KVH), each head's keys split over ``4 / wh`` warps in whole
    m16 slices (at most four a tile), three ring stages in half an SM's
    shared memory; the same for every block size, which the cache check
    admits."""
    for H, KVH in GROUPS:
        G = H // KVH
        assert 1 <= G <= TP.MAX_GROUP
        sw = {"bf16": 0, "int8-token": 1, "int8-head": KVH}[mode]
        wh, kt, smem = TP.decode_plan(KVH, D, sw > 0, sw > 1)
        wk = 4 // wh
        assert wh in (1, 2, 4) and KVH % wh == 0, (H, KVH)
        assert wh == max(w for w in (1, 2, 4) if KVH % w == 0)
        assert kt in (16, 32, 64) and kt % (16 * wk) == 0
        assert kt // 16 // wk <= 4
        assert smem == 3 * TP.decode_stage_bytes(kt, wh, D, sw > 0, sw > 1)
        assert smem <= _build.MAX_SMEM_PER_BLOCK // 2
        q, k, v, ks, vs = _layout(H, KVH, D, sw)
        for bs in BLOCK_SIZES:
            if sw and bs % 32:
                continue
            TP.check_kv_cache(_check, q, k, v, ks, vs, KVH, bs, 0)
            assert TP.decode_plan(KVH, D, sw > 0, sw > 1) == (wh, kt, smem)


def test_decode_stage_bytes():
    """The host copy of csrc/paged_decode.cu's StageLayout: K and V tiles
    of ``kt`` rows of the group's columns plus a 16-byte pad, then the int8
    scales, 128-byte aligned.  llama3-1b (KVH 8, D 64) in bf16 takes
    32-key tiles of four heads; its int8 caches 64-key ones."""
    assert TP.decode_stage_bytes(32, 4, 64, False, False) == 2 * 32 * 528
    assert TP.decode_stage_bytes(64, 4, 64, True, True) == \
        2 * 64 * 272 + 2 * 1024
    assert TP.decode_stage_bytes(64, 4, 64, True, False) == \
        2 * 64 * 272 + 2 * 256
    assert TP.decode_plan(8, 64, False) == (4, 32, 3 * 2 * 32 * 528)
    assert TP.decode_plan(8, 64, True, True)[:2] == (4, 64)
    assert TP.decode_plan(1, 128, False)[:2] == (1, 64)


def test_num_splits_from_shapes():
    """G's key-tile ranges: (sequence, head group, range) blocks within
    one wave of two per SM, no more ranges than key tiles a block table
    holds, at most 256, at least one."""
    assert TP.num_splits(64, 2, 256, 132) == 2
    assert TP.num_splits(8, 2, 256, 132) == 16
    assert TP.num_splits(8, 2, 4, 132) == 4
    assert TP.num_splits(1, 1, 10_000, 132) == 256
    assert TP.num_splits(512, 2, 256, 132) == 1


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_plan_fits_every_layout(D, quantized):
    """H's plan: 64-key tiles, the q tile of 64 fused rows and two stages
    of K and V; at D = 64 four blocks share an SM, and nothing depends on
    G or the block size, which the cache check admits."""
    kt, smem = TF.prefill_plan(D, quantized)
    assert kt == 64 and smem <= _build.MAX_SMEM_PER_BLOCK
    esz = 1 if quantized else 2
    stage = 2 * 64 * (D * esz + 16) + (2 * 64 * 4 if quantized else 0)
    assert smem == 64 * (D + 8) * 2 + 2 * stage
    if D == 64:
        assert 4 * smem <= 228 * 1024
    for H, KVH in GROUPS + [(64, 1), (32, 1)]:
        assert H // KVH <= TF.ROWS
        for sw in ((1, KVH) if quantized else (0,)):
            q, k, v, ks, vs = _layout(H, KVH, D, sw)
            for bs in BLOCK_SIZES:
                if quantized and bs % 32:
                    continue
                TP.check_kv_cache(_check, q, k, v, ks, vs, KVH, bs, 0)


def test_cache_check_refuses_what_no_kernel_takes():
    """The checks still refuse a head size the kernels lack and pages off
    the JAX kernels' 16-row grid, naming them."""
    q, k, v, ks, vs = _layout(4, 2, 32, 0)
    with pytest.raises(ValueError, match="head size 32"):
        TP.check_kv_cache(_check, q, k, v, ks, vs, 2, 64, 0)
    q, k, v, ks, vs = _layout(4, 2, 64, 0)
    with pytest.raises(ValueError, match="block_size % 16"):
        TP.check_kv_cache(_check, q, k, v, ks, vs, 2, 40, 0)


@pytest.mark.parametrize("kernel,sw", [("decode", 0), ("decode", 2),
                                       ("prefill", 0), ("prefill", 2)])
def test_plain_matches_tpu_kernel_at_256_row_pages(kernel, sw):
    """G's and H's plain versions against the JAX kernels (interpret mode)
    at 256-row pages and D = 128 (llama3-8b's head size), on a bf16 cache
    and an int8 one with a scale per KV head."""
    rng = np.random.default_rng(256 + sw + len(kernel))
    H, KVH, D, bs, L, layer = 8, 2, 128, 256, 2, 1
    F = KVH * D
    if kernel == "decode":
        seq_lens = [1, 300, 0]
        S, nblk = len(seq_lens), 7
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
                        block_size=bs, num_kv_heads=KVH, scale=0.09,
                        layer=jnp.asarray(layer, jnp.int32), interpret=True,
                        k_scale=ks, v_scale=vs, k_scale_new=kns,
                        v_scale_new=vns)
        planes = [_t(a) if a is not None else None for a in (k, v, ks, vs)]
        got = TP.paged_attention_decode_update(
            _t(q), _t(kn), _t(vn), planes[0], planes[1], _t(bt), _t(lens),
            bs, KVH, scale=0.09, layer=layer, k_scale=planes[2],
            v_scale=planes[3],
            k_scale_new=None if kns is None else _t(kns),
            v_scale_new=None if vns is None else _t(vns))
        np.testing.assert_allclose(_f32(got), _f32(want[0]), **TOL)
        assert not np.any(_f32(got)[lens == 0])
        for mine, theirs in zip([p for p in planes if p is not None],
                                want[1:]):
            np.testing.assert_array_equal(_f32(mine)[:, bs:],
                                          _f32(theirs)[:, bs:])
        return
    # Prefill: a 300-token prompt's last 44 positions (its second page)
    # and a pad sequence.
    seq_lens, new_lens = [300, 0], [44, 0]
    S, Q, nblk = len(seq_lens), 48, 6
    k, v, ks, vs = _caches(rng, (L, nblk * bs, F), sw)
    bt = _tables(rng, [max(n, 1) for n in seq_lens], bs, nblk)
    bt[1] = 0
    qs = np.zeros((S, Q, H, D), np.float32)
    q_pos = np.full((S, Q), -1, np.int32)
    qs[0, :44] = rng.standard_normal((44, H, D))
    q_pos[0, :44] = np.arange(256, 300)
    qs = jnp.asarray(qs, jnp.bfloat16)
    lens = np.asarray(seq_lens, np.int32)
    want = j_flash(qs, jnp.asarray(q_pos), k, v, jnp.asarray(bt),
                   jnp.asarray(lens), block_size=bs, num_kv_heads=KVH,
                   scale=0.08, layer=jnp.asarray(layer, jnp.int32),
                   interpret=True, k_scale=ks, v_scale=vs)
    got = TF.flash_prefill_paged(
        _t(qs), _t(q_pos), _t(k), _t(v), _t(bt), _t(lens), bs, KVH,
        scale=0.08, layer=layer, k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    assert not np.any(_f32(got)[q_pos < 0])
