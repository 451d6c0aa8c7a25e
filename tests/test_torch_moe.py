"""Port parity: MoE routing, the counting-sort tile layout, and the plain
versions of kernels C (dense int8) and D (routed int8).

Routing at the deepseek-v3-bench routing config (sigmoid + bias, 8 groups
keep 4, top-8 of 64), at qwen3-30b-a3b's (softmax, top-8 of 128,
renormalized) and at mixtral-8x22b's (top-2 of 8) must pick identical
experts with weights within 1e-6.  The tile layout metadata must be identical.  The kernels' plain
versions, driven through the port's own glue, are held to the TPU
kernels' glue in interpret mode with the scale-normalised tolerance of
tests/test_moe_int8_kernel.py (max error / max |output| <= 1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops import moe as JM
from llm_d_tpu.ops.quant import quantize_int8 as jquantize_int8
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import tensor_from_numpy
from llm_d_tpu_torch.ops import moe as TM

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _scaled_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("preset,T", [("deepseek-v3-bench", 130),
                                      ("tiny-moe", 21),
                                      ("qwen3-30b-a3b", 96),
                                      ("mixtral-8x22b", 64)])
def test_route_matches(preset, T):
    jc, tc = jget_config(preset), tget_config(preset)
    rng = np.random.default_rng(T)
    E = jc.num_experts
    logits = (rng.standard_normal((T, E)) * 2).astype(np.float32)
    logits[0, :] = 0.5                        # an all-tied row
    bias = (rng.standard_normal(E) * 0.1).astype(np.float32)
    eb = bias if jc.scoring_func == "sigmoid" else None
    wj, ij = JM.route(jnp.asarray(logits), jc,
                      e_bias=None if eb is None else jnp.asarray(eb))
    wt, it = TM.route(torch.from_numpy(logits), tc,
                      e_bias=None if eb is None else torch.from_numpy(eb))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)


def _routing(rng, T, k, E, dup_rows=3, skip_experts=(1, 5)):
    """Random routing with some empty experts and duplicate routes."""
    live = [e for e in range(E) if e not in skip_experts]
    idx = rng.choice(live, size=(T, k)).astype(np.int32)
    idx[:dup_rows, 1] = idx[:dup_rows, 0]      # duplicate (token, expert)
    w = np.abs(rng.standard_normal((T, k))).astype(np.float32) * 0.4
    return idx, w


@pytest.mark.parametrize("T,k,E,rt", [(40, 8, 16, 32), (150, 8, 64, 32)])
def test_sorted_tile_layout_identical(T, k, E, rt):
    rng = np.random.default_rng(T + E)
    idx, w = _routing(rng, T, k, E)
    flat = idx.reshape(-1)
    want = JM._sorted_tile_layout(jnp.asarray(flat), jnp.asarray(w.reshape(-1)),
                                  k, E, rt)
    got = TM._sorted_tile_layout(torch.from_numpy(flat),
                                 torch.from_numpy(w.reshape(-1)), k, E, rt)
    names = ("order", "inv", "tok_s", "slot", "wslot_pad", "tile_expert",
             "num_tiles")
    for name, g, wv in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
    o_j, d_j, c_j = JM._stable_argsort_bounded(jnp.asarray(flat), E)
    o_t, d_t, c_t = TM._stable_argsort_bounded(torch.from_numpy(flat), E)
    for g, wv in ((o_t, o_j), (d_t, d_j), (c_t, c_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def _quant(rng, Lm, E, H, I, layer):
    quant = {"layer": layer}
    for name, shape in (("w_gate", (Lm, E, H, I)), ("w_up", (Lm, E, H, I)),
                        ("w_down", (Lm, E, I, H))):
        q, s = jquantize_int8(jnp.asarray(
            rng.standard_normal(shape) * 0.05, jnp.float32))
        quant[f"{name}_q"], quant[f"{name}_s"] = q, s
    tq = {k: (v if k == "layer" else _t(v)) for k, v in quant.items()}
    quant["layer"] = jnp.int32(layer)
    return quant, tq


@pytest.mark.parametrize("T,E,H,I,k", [(16, 8, 256, 128, 2),
                                       (40, 16, 128, 64, 8)])
def test_dense_int8_plain_matches_tpu_kernel(T, E, H, I, k):
    rng = np.random.default_rng(T * E)
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 1)
    want = JM._dense_int8_kernel_path(x, jnp.asarray(w), jnp.asarray(idx),
                                      jq, interpret=True)
    got = TM._dense_int8_kernel_path(_t(x), _t(w), _t(idx), tq)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("T,E,H,I,k,live", [
    (16, 8, 256, 128, 2, (0, 3, 6)), (40, 16, 128, 64, 8, (9,))])
def test_dense_int8_unrouted_experts_add_nothing(T, E, H, I, k, live):
    """Kernel C skips every expert whose comb column is zero.  On the JAX
    side such an expert's weights cannot reach the output: other int8
    values there leave it bit-identical.  The port's plain version agrees
    with the TPU kernel on such a routing."""
    rng = np.random.default_rng(T * E + len(live))
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx = rng.choice(live, size=(T, k)).astype(np.int32)
    w = np.abs(rng.standard_normal((T, k))).astype(np.float32) * 0.4
    jq, tq = _quant(rng, 2, E, H, I, 1)
    want = JM._dense_int8_kernel_path(x, jnp.asarray(w), jnp.asarray(idx),
                                      jq, interpret=True)
    dead = np.setdiff1d(np.arange(E), live)
    other = dict(jq)
    for name in ("w_gate_q", "w_up_q", "w_down_q"):
        q = np.asarray(jq[name]).copy()
        q[:, dead] = rng.integers(-127, 128, q[:, dead].shape)
        assert not np.array_equal(q, np.asarray(jq[name]))
        other[name] = jnp.asarray(q, jnp.int8)
    again = JM._dense_int8_kernel_path(x, jnp.asarray(w), jnp.asarray(idx),
                                       other, interpret=True)
    np.testing.assert_array_equal(np.asarray(again), np.asarray(want))
    got = TM._dense_int8_kernel_path(_t(x), _t(w), _t(idx), tq)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("T,E,H,I,k,rt", [(24, 8, 256, 128, 2, 16),
                                          (70, 16, 128, 64, 8, 32)])
def test_routed_int8_plain_matches_tpu_kernel(T, E, H, I, k, rt):
    rng = np.random.default_rng(T + 1000 * E)
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 1)
    want = JM._routed_int8_kernel_path(x, jnp.asarray(w), jnp.asarray(idx),
                                       jq, row_tile=rt, interpret=True)
    got = TM._routed_int8_kernel_path(_t(x), _t(w), _t(idx), tq,
                                      row_tile=rt)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("T", [24, 600])
def test_expert_ffn_cpu_path_matches(T):
    """The CPU path (dequantize, then dense or grouped) against the JAX
    package's CPU path, with int8 experts."""
    rng = np.random.default_rng(T)
    E, H, I, k = 8, 64, 32, 2
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 0)
    want = JM.expert_ffn(x, jnp.asarray(w), jnp.asarray(idx), None, None,
                         None, quant=jq)
    got = TM.expert_ffn(_t(x), _t(w), _t(idx), None, None, None, quant=tq)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


def test_group_routing_config_is_the_bench_one():
    c = tget_config("deepseek-v3-bench")
    assert (c.scoring_func, c.n_group, c.topk_group, c.num_experts,
            c.num_experts_per_tok) == ("sigmoid", 8, 4, 64, 8)
    assert dataclasses.asdict(c) == dataclasses.asdict(
        jget_config("deepseek-v3-bench"))


def _jax_streamed_metadata(idx, w, k, E, chunk_t, rt):
    """Per-chunk tables exactly as the JAX glue builds them."""
    T = idx.shape[0]
    chunk_t = max(16, min(-(-chunk_t // 16) * 16, -(-T // 16) * 16))
    C = -(-T // chunk_t)
    pad = C * chunk_t - T
    idx = np.pad(idx, ((0, pad), (0, 0)))
    w = np.pad(w, ((0, pad), (0, 0)))
    S_c = chunk_t * k
    out = []
    for c in range(C):
        _, _, tok_s, slot, wslot_pad, tile_e, num_tiles = \
            JM._sorted_tile_layout(jnp.asarray(idx.reshape(C, S_c)[c]),
                                   jnp.asarray(w.reshape(C, S_c)[c]),
                                   k, E, rt)
        tok_pad = jnp.zeros((wslot_pad.shape[0],), jnp.int32).at[slot].set(
            tok_s)
        out.append([np.asarray(a) for a in (tok_pad, wslot_pad, tile_e,
                                            num_tiles)])
    return [np.concatenate([o[i].reshape(-1) for o in out])
            for i in range(4)]


@pytest.mark.parametrize("T,chunk_t,E,H,I,k,rt,case", [
    (32, 64, 8, 256, 128, 2, 8, "one-chunk"),
    (48, 16, 16, 256, 128, 8, 16, "multi-chunk"),
    (37, 16, 8, 128, 128, 2, 8, "padded-last-chunk"),
    (32, 16, 16, 128, 128, 2, 16, "empty-experts"),
    (48, 16, 4, 256, 128, 2, 8, "duplicates-across-chunks"),
])
def test_streamed_int8_plain_matches_tpu_kernel(T, chunk_t, E, H, I, k, rt,
                                                case):
    """Kernel E's plain version through the port's glue against the TPU
    kernel's glue in interpret mode; the per-chunk metadata identical."""
    rng = np.random.default_rng(T * 7 + E)
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    if case == "empty-experts":
        idx = np.asarray([1, 7, 12], np.int32)[rng.integers(0, 3, (T, k))]
        w = np.abs(rng.standard_normal((T, k))).astype(np.float32) * 0.3
    elif case == "duplicates-across-chunks":
        idx = np.full((T, k), 2, np.int32)
        w = np.abs(rng.standard_normal((T, k))).astype(np.float32) * 0.3
    else:
        idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 1)
    want = JM._streamed_int8_kernel_path(
        x, jnp.asarray(w), jnp.asarray(idx), jq, chunk_t=chunk_t,
        row_tile=rt, interpret=True)
    seen = {}
    real = TM.moe_routed_stream.streamed_moe_int8

    def spy(*args, **kw):
        seen["args"] = args
        return real(*args, **kw)

    TM.moe_routed_stream.streamed_moe_int8 = spy
    try:
        got = TM._streamed_int8_kernel_path(_t(x), _t(w), _t(idx), tq,
                                            chunk_t=chunk_t, row_tile=rt)
    finally:
        TM.moe_routed_stream.streamed_moe_int8 = real
    assert got.shape == (T, H) and got.dtype == torch.bfloat16
    assert _scaled_err(got.float().numpy(), want) <= 1e-2
    meta = _jax_streamed_metadata(idx, w, k, E, chunk_t, rt)
    for name, g, wv in zip(("tok_pad", "wslot_pad", "tile_expert",
                            "num_tiles"), seen["args"][1:5], meta):
        np.testing.assert_array_equal(g.numpy(), wv, err_msg=name)


def test_streamed_chunk_rounding_matches_jax():
    """Chunk heights round up to 16 rows and never exceed the aligned
    batch: the flattened tables have the JAX glue's lengths."""
    rng = np.random.default_rng(3)
    E, H, I, k = 8, 128, 128, 2
    jq, tq = _quant(rng, 1, E, H, I, 0)
    for T, chunk_t in ((20, 7), (20, 100), (64, 33)):
        x = rng.standard_normal((T, H)).astype(np.float32)
        idx, w = _routing(rng, T, k, E, skip_experts=())
        seen = {}
        real = TM.moe_routed_stream.streamed_moe_int8
        TM.moe_routed_stream.streamed_moe_int8 = \
            lambda *a, **kw: seen.update(kw=kw, args=a) or real(*a, **kw)
        try:
            TM._streamed_int8_kernel_path(
                _t(x).to(torch.bfloat16), _t(w), _t(idx), tq,
                chunk_t=chunk_t, row_tile=8)
        finally:
            TM.moe_routed_stream.streamed_moe_int8 = real
        want_chunk = max(16, min(-(-chunk_t // 16) * 16, -(-T // 16) * 16))
        assert seen["kw"]["chunk_t"] == want_chunk
        assert seen["args"][4].shape == (-(-T // want_chunk),)


@pytest.mark.parametrize("T,E,H,I,k,rt", [(16, 8, 256, 128, 2, 8),
                                          (36, 8, 256, 128, 2, 16),
                                          (40, 16, 128, 128, 8, 16)])
def test_grouped_int8_plain_matches_tpu_kernel(T, E, H, I, k, rt):
    rng = np.random.default_rng(T + 31 * E)
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 1)
    want = JM._grouped_int8_kernel_path(x, jnp.asarray(w), jnp.asarray(idx),
                                        jq, row_tile=rt, interpret=True)
    got = TM._grouped_int8_kernel_path(_t(x), _t(w), _t(idx), tq,
                                       row_tile=rt)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


def test_unsort_combine_with_dest_matches_jax():
    rng = np.random.default_rng(5)
    T, k, E, rt, H = 9, 2, 4, 8, 6
    idx, w = _routing(rng, T, k, E, skip_experts=())
    flat = idx.reshape(-1)
    order, inv, _, dest, wslot, _, _ = JM._sorted_tile_layout(
        jnp.asarray(flat), jnp.asarray(w.reshape(-1)), k, E, rt)
    y = rng.standard_normal((wslot.shape[0], H)).astype(np.float32)
    want = JM._unsort_combine(jnp.asarray(y), order, T, k, dest=dest,
                              inv=inv)
    got = TM._unsort_combine(torch.from_numpy(y), _t(order), T, k,
                             dest=_t(dest), inv=_t(inv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("env", [
    {},
    {"LLMD_MOE_PREFILL_KERNEL": "grouped"},
    {"LLMD_MOE_PREFILL_KERNEL": "banana"},
    {"LLMD_MOE_DENSE_KERNEL_MAX_T": "16", "LLMD_MOE_GROUPED_MIN_T": "100"},
    {"LLMD_MOE_DENSE_KERNEL_MAX_T": "banana",
     "LLMD_MOE_GROUPED_MIN_T": "1e3", "LLMD_MOE_PREFILL_KERNEL": "grouped"},
])
def test_int8_regime_matches_jax_dispatch(monkeypatch, env):
    """The port's regime choice against the JAX package's TPU dispatch
    (its backend check forced, its kernel paths replaced by recorders),
    knobs and malformed values included."""
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for regime in ("dense", "routed", "grouped", "streamed"):
        monkeypatch.setattr(JM, f"_{regime}_int8_kernel_path",
                            lambda *a, _r=regime, **kw: _r)
    for T in (1, 16, 17, 64, 65, 100, 101, 512, 513, 8192):
        x = jnp.zeros((T, 8), jnp.bfloat16)
        idx = jnp.zeros((T, 2), jnp.int32)
        want = JM.expert_ffn(x, jnp.ones((T, 2)), idx, None, None, None,
                             quant={"layer": 0})
        assert TM.int8_kernel_regime(T) == want, (T, env)


def test_routed_row_tile_knob(monkeypatch):
    assert TM._routed_row_tile(None, 100, 64) == 32
    assert TM._routed_row_tile(None, 64 * 96, 64) == 64
    monkeypatch.setenv("LLMD_MOE_ROUTED_ROW_TILE", "16")
    assert TM._routed_row_tile(None, 100, 64) == 16
    assert TM._routed_row_tile(8, 100, 64) == 8
    monkeypatch.setenv("LLMD_MOE_ROUTED_ROW_TILE", "banana")
    assert TM._routed_row_tile(None, 100, 64) == 32


@pytest.mark.parametrize("T,chunk_t,E,k,rt,per_block", [
    (48, 16, 16, 8, 16, 8),      # several chunks, 8 tiles a row block
    (40, 16, 8, 2, 8, 4),        # last chunk padded
    (64, 64, 8, 2, 16, 2),       # one chunk
    (32, 16, 16, 2, 16, 1),      # one tile a row block
])
def test_expert_row_blocks_cover_every_live_slot_once(T, chunk_t, E, k, rt,
                                                      per_block):
    """Kernel E's row blocks over the glue's per-chunk layout: every slot
    of a populated tile lies in exactly one block, no idle tile appears,
    a block holds one expert's tiles in expert-major, chunk-ascending
    order, and -1 entries only trail a block."""
    from llm_d_tpu_torch.ops.moe_routed_stream import expert_row_blocks
    rng = np.random.default_rng(T + per_block)
    C = -(-T // chunk_t)
    idx, w = _routing(rng, C * chunk_t, k, E)
    _, _, _, _, _, tile_e, num_tiles = TM._sorted_tile_layout(
        _t(idx).reshape(C, -1), _t(w).reshape(C, -1), k, E, rt)
    tile_e = tile_e.reshape(-1)
    NT = tile_e.shape[0]
    NT_c = NT // C
    blocks = expert_row_blocks(tile_e, num_tiles, E, per_block)
    assert blocks.dtype == torch.int32
    assert blocks.shape == (min(NT, NT // per_block + E), per_block)
    live = [t for t in range(NT) if t % NT_c < int(num_tiles[t // NT_c])]
    slots = [t * rt + r for row in blocks.tolist() for t in row if t >= 0
             for r in range(rt)]
    assert sorted(slots) == [t * rt + r for t in live for r in range(rt)]
    assert len(slots) == len(set(slots))
    order = []
    for row in blocks.tolist():
        tiles = [t for t in row if t >= 0]
        assert row == tiles + [-1] * (per_block - len(tiles))
        assert len({int(tile_e[t]) for t in tiles}) <= 1
        order += tiles
    keys = [(int(tile_e[t]), t) for t in order]
    assert keys == sorted(keys)


def test_row_block_for_the_bench_steps():
    """128 rows a block once the mean rows per expert reach 256 (the
    bench's 3072- and 8192-token steps), 64 below (its 1024-token step),
    never fewer than the row tile."""
    from llm_d_tpu_torch.ops.moe_routed_stream import row_block_for
    assert row_block_for(1024 * 8, 64, 32) == 64
    assert row_block_for(3072 * 8, 64, 32) == 128
    assert row_block_for(8192 * 8, 64, 64) == 128
    assert row_block_for(100, 64, 64) == 64


@pytest.mark.parametrize("T,rt,want", [(128, 32, 32), (65, 16, 32),
                                       (256, 32, 64), (512, 64, 64)])
def test_row_block_for_kernel_d_steps(T, rt, want):
    """Kernel D's decode steps run E's passes in 32-row blocks while the
    mean rows per expert stay under 32 (the bench's wave-2 T = 128: ~16
    rows an expert), 64 from there."""
    from llm_d_tpu_torch.ops.moe_routed_stream import row_block_for
    assert row_block_for(T * 8, 64, rt) == want
