"""Port parity: the chunked flash attention path
(``llm_d_tpu_torch.ops.attention.ragged_paged_attention_chunked``) and
the backend dispatch that reaches it.

The same numpy inputs go through the JAX package's XLA flash recurrence
and the port's plain PyTorch one, on the CPU: bf16 caches, int8 caches
with per-row and per-KV-head scales, ``soft_cap``, the MLA shared latent
(one KV head whose value cache is the key cache), decode (Q = 1) and
prefill with the query chunking forced by a small score budget.
Tolerance atol = rtol = 2e-2, as the JAX attention tests use.  Batches
that no kernel takes (``soft_cap`` decode, rows narrower than 128
columns) go through the chunked path under the 'kernel' backend, as JAX's
'pallas' sends them, and every batch does under 'chunked'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.ops import attention as JA
from llm_d_tpu.ops.quant import quantize_kv_block as _jquant_raw
from llm_d_tpu_torch.ops import attention as TA

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

TOL = dict(atol=2e-2, rtol=2e-2)
_jquant = jax.jit(_jquant_raw, static_argnums=1)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _batch(seqs, bt, bs, T, S, Q):
    """Engine-layout ragged batch for sequences ``(start, n)``."""
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


def _case(rng, mode, KVH, D, sw, bs=16, L=2, B=40):
    """A batch over tables of ``B`` pages (640 keys at bs = 16: 128-key
    chunks, five of them live for the longest sequence)."""
    if mode == "decode":
        seqs, T, Q = [(0, 1), (bs - 1, 1), (bs, 1), (600, 1)], 8, 1
    else:
        seqs, T, Q = [(0, 20), (300, 9), (0, 1)], 32, 32
    S = len(seqs) + 1                          # one pad sequence
    nblk = (S - 1) * B + 1
    bt = np.zeros((S, B), np.int32)
    bt[:S - 1] = (rng.permutation(nblk - 1) + 1).reshape(S - 1, B)
    b, n_real = _batch(seqs, bt, bs, T, S, Q)
    shape = (L, nblk * bs, KVH * D)
    caches = []
    for _ in range(2):
        rows = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        caches.append((rows, None) if sw == 0 else _jquant(rows, sw))
    return b, n_real, caches


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("kind", ["bf16", "int8-row", "int8-head",
                                  "soft_cap", "mla"])
def test_chunked_matches_jax(mode, kind, monkeypatch):
    """``ragged_paged_attention_chunked`` against JAX's.  Prefill runs
    with a score budget small enough that both packages cut the 32 query
    rows into chunks of 8 and the keys into chunks of 16 (128 without
    it)."""
    rng = np.random.default_rng(len(mode) * 7 + len(kind))
    H, KVH, D, bs, layer = 8, 2, 32, 16, 1
    sw = {"int8-row": 1, "int8-head": KVH}.get(kind, 0)
    soft_cap = 5.0 if kind == "soft_cap" else None
    if kind == "mla":
        H, KVH, D = 4, 1, 128
    b, n_real, ((k, ks), (v, vs)) = _case(rng, mode, KVH, D, sw, bs)
    if kind == "mla":
        v, vs = k, ks
    T = b["positions"].shape[0]
    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.bfloat16)
    if mode == "prefill":
        budget = 5 * 8 * H * 16
        monkeypatch.setattr(JA, "_FLASH_SCORE_BUDGET", budget)
        monkeypatch.setattr(TA, "_FLASH_SCORE_BUDGET", budget)
    args = ("token_seq_ids", "positions", "block_tables", "seq_lens",
            "qtok_idx", "token_qpos")
    want = JA.ragged_paged_attention_chunked(
        q, k, v, *(jnp.asarray(b[n]) for n in args), block_size=bs,
        scale=0.2, soft_cap=soft_cap, layer=jnp.int32(layer), k_scale=ks,
        v_scale=vs)
    got = TA.ragged_paged_attention_chunked(
        _t(q), _t(k), _t(v), *(_t(b[n]) for n in args), block_size=bs,
        scale=0.2, soft_cap=soft_cap, layer=layer,
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs))
    assert got.dtype == torch.bfloat16 and got.shape == (T, H, D)
    np.testing.assert_allclose(_f32(got)[:n_real], _f32(want)[:n_real],
                               **TOL)
    assert np.isfinite(_f32(got)).all()


def test_query_and_key_chunks_follow_the_budget(monkeypatch):
    """The budget halves the query chunk first, then the key chunk, and
    the result does not depend on the chunking."""
    rng = np.random.default_rng(3)
    b, n_real, ((k, _), (v, _)) = _case(rng, "prefill", 2, 32, 0)
    T = b["positions"].shape[0]
    q = _t(jnp.asarray(rng.standard_normal((T, 8, 32)), jnp.bfloat16))
    names = ("token_seq_ids", "positions", "block_tables", "seq_lens",
             "qtok_idx", "token_qpos")
    seen = []
    real = TA._flash_over_kv_chunks

    def spy(qs, *a, **kw):
        seen.append((qs.shape[1], a[5]))
        return real(qs, *a, **kw)

    monkeypatch.setattr(TA, "_flash_over_kv_chunks", spy)
    outs = []
    for budget in (1 << 25, 5 * 8 * 8 * 16):
        monkeypatch.setattr(TA, "_FLASH_SCORE_BUDGET", budget)
        outs.append(TA.ragged_paged_attention_chunked(
            q, _t(k), _t(v), *(_t(b[n]) for n in names), block_size=16,
            scale=0.2, layer=1).float().numpy())
    assert seen[0] == (32, 128) and len(seen) == 5
    assert all(s == (8, 16) for s in seen[1:])
    np.testing.assert_allclose(outs[1][:n_real], outs[0][:n_real],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("kind", ["bf16", "int8-row", "soft_cap"])
def test_whole_table_bound_is_bit_equal(mode, kind, monkeypatch):
    """Under a CUDA graph capture the chunked path cannot read the
    longest context to the host and runs every chunk of the table
    (``_context_bound`` returns the table's slots): the extra chunks are
    fully masked, and the output is bit-equal to the live-chunk run."""
    rng = np.random.default_rng(11 + len(kind))
    H, KVH, D, bs = 8, 2, 32, 16
    sw = 1 if kind == "int8-row" else 0
    # Tables of 80 pages: 1280 keys in five 256-key chunks, of which
    # the longest context (601 or 309 keys) needs three or two.
    b, _, ((k, ks), (v, vs)) = _case(rng, mode, KVH, D, sw, bs, B=80)
    T = b["positions"].shape[0]
    q = _t(jnp.asarray(rng.standard_normal((T, H, D)), jnp.bfloat16))
    names = ("token_seq_ids", "positions", "block_tables", "seq_lens",
             "qtok_idx", "token_qpos")
    seen = []
    real = TA._flash_over_kv_chunks

    def spy(*a, **kw):
        seen.append(a[9])                 # n_live
        return real(*a, **kw)

    monkeypatch.setattr(TA, "_flash_over_kv_chunks", spy)
    outs = []
    for whole in (False, True):
        if whole:
            monkeypatch.setattr(TA, "_context_bound", lambda sl, C: C)
        outs.append(TA.ragged_paged_attention_chunked(
            q, _t(k), _t(v), *(_t(b[n]) for n in names), block_size=bs,
            scale=0.2, soft_cap=5.0 if kind == "soft_cap" else None,
            layer=1, k_scale=None if ks is None else _t(ks),
            v_scale=None if vs is None else _t(vs)))
    assert seen == [3 if mode == "decode" else 2, 5]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("backend,soft_cap,D", [
    ("chunked", None, 64),       # every batch takes the chunked path
    ("kernel", 5.0, 64),         # soft-capped decode: no kernel takes it
    ("kernel", None, 16)])       # rows of 32 columns: below the kernels
def test_dispatch_to_chunked_matches_jax(backend, soft_cap, D):
    """``attention_with_kv_update`` sends the batches JAX's 'pallas' and
    'chunked' send to ``ragged_paged_attention_chunked`` there too, with
    the same outputs and the same cache writes."""
    rng = np.random.default_rng(D + int(soft_cap or 0))
    H, KVH, bs, layer = 8, 2, 16, 1
    b, n_real, ((k, _), (v, _)) = _case(rng, "decode", KVH, D, 0, bs)
    T = b["positions"].shape[0]
    q = jnp.asarray(rng.standard_normal((T, H, D)), jnp.bfloat16)
    kn = jnp.asarray(rng.standard_normal((T, KVH, D)), jnp.bfloat16)
    vn = jnp.asarray(rng.standard_normal((T, KVH, D)), jnp.bfloat16)
    jb = {n: jnp.asarray(a) for n, a in b.items()}
    want = JA.attention_with_kv_update(
        q, kn, vn, k, v, jb, block_size=bs, scale=0.125, soft_cap=soft_cap,
        backend="pallas" if backend == "kernel" else backend,
        layer=jnp.int32(layer))
    calls = []
    real = TA.ragged_paged_attention_chunked

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    TA.ragged_paged_attention_chunked = spy
    try:
        got = TA.attention_with_kv_update(
            _t(q), _t(kn), _t(vn), _t(k), _t(v),
            {n: _t(a) for n, a in b.items()}, block_size=bs, scale=0.125,
            soft_cap=soft_cap, backend=backend, layer=layer)
    finally:
        TA.ragged_paged_attention_chunked = real
    assert calls == [1]
    np.testing.assert_allclose(_f32(got[0])[:n_real],
                               _f32(want[0])[:n_real], **TOL)
    for mine, theirs in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_f32(mine)[:, bs:],
                                      _f32(theirs)[:, bs:])


def test_resolve_backend_accepts_chunked():
    assert TA.resolve_backend("chunked", torch.device("cpu")) == "chunked"
    assert TA.resolve_backend("auto", torch.device("cpu")) == "reference"
    with pytest.raises(ValueError):
        TA.resolve_backend("pallas", torch.device("cpu"))
