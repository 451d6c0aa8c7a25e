"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: attention kernels (MLA A/B, dense G/H) atol = rtol = 2e-2
against the plain version (same bf16 rounding points, other summation
order); the decode splices leave cache and scale planes identical; MoE
kernels (C-F) max error / max |output| <= 1e-2
(tests/test_moe_int8_kernel.py's rule).

The multistep engine's decode blocks (one CUDA graph each) are held to
their eager body bit for bit, async scheduling to sync and to the
classic loop token for token, and a capture that meets a host sync must
raise.  So are the spec engine's fused rounds and N-round dispatches
(one graph a key, through the kernels or the chunked attention path),
and everything-on greedy tokens equal N = 1's; capped graph sets serve
the uncapped tokens, and bf16 experts past the dense bound are refused
at build.  The spec engine's fused rounds repeat token for token and free
their rejected blocks, and its acceptance coin is the CPU's bit for
bit.  The OpenAI server over the same engine answers with the direct
engine's tokens.  A graph captured before a PD consumer's scatter and a
host-tier restore reads the rows they wrote.
"""

import dataclasses

import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.config import get_config
from llm_d_tpu_torch.ops import mla_decode, mla_prefill
from llm_d_tpu_torch.ops import moe as M
from llm_d_tpu_torch.ops.quant import quantize_int8, quantize_kv_block
from llm_d_tpu_torch.ops.sampling import SamplingParams

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(seed, dev):
    return torch.Generator(device=dev).manual_seed(seed)


def _cache(g, dev, quantized, L, slots, F):
    rows = torch.randn((L, slots, F), generator=g, device=dev).bfloat16()
    if not quantized:
        return rows, None
    return quantize_kv_block(rows, 1)


def _tables(g, dev, seq_lens, bs, num_blocks):
    S = len(seq_lens)
    B = max(max(-(-n // bs) for n in seq_lens), 1)
    perm = torch.randperm(num_blocks - 1, generator=g, device=dev)[:S * B] + 1
    bt = perm.reshape(S, B).to(torch.int32)
    bt[torch.tensor(seq_lens, device=dev) == 0] = 0
    return bt.contiguous()


_DECODE_LENS = {
    "short": lambda bs: [1, bs - 1, bs, bs + 1, 3 * bs + 7, 0, 0, 0],
    # Several page ranges per sequence, ranges of one and of two pages.
    "long": lambda bs: [40 * bs + 3, 64 * bs, 1, 0, 0, 0, 0, 0],
    "single": lambda bs: [64 * bs],
}


def _check_mla_decode(dev, quantized, H, F, bs, seq_lens):
    """Kernel A against the plain version, and twice on the same inputs:
    the partials are combined in a fixed order, so the outputs are
    bit-equal; the splices of the new rows (and scales) are exact."""
    g = _gen(1, dev)
    S, L, layer = len(seq_lens), 3, 1
    nblk = S * max(-(-n // bs) for n in seq_lens) + 1
    kv, ks = _cache(g, dev, quantized, L, nblk * bs, F)
    bt = _tables(g, dev, seq_lens, bs, nblk)
    lens_t = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q = torch.randn((S, H, F), generator=g, device=dev).bfloat16()
    row = torch.randn((S, F), generator=g, device=dev).bfloat16()
    row_s = None
    if quantized:
        row, row_s = quantize_kv_block(row, 1)
    caches = []
    outs = []
    for fn in (mla_decode.mla_paged_decode_update,
               mla_decode.mla_paged_decode_update,
               mla_decode.mla_paged_decode_update_plain):
        kv_i = kv.clone()
        ks_i = ks.clone() if quantized else None
        outs.append(fn(q, row, kv_i, bt, lens_t, bs, 0.11, layer=layer,
                       kv_scale=ks_i, row_scale_new=row_s))
        caches.append((kv_i, ks_i))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0].float(), outs[2].float(), **TOL)
    assert torch.all(outs[0][lens_t == 0] == 0)
    for i in (0, 1):
        assert torch.equal(caches[i][0], caches[2][0])
        if quantized:
            assert torch.equal(caches[i][1], caches[2][1])


@pytest.mark.parametrize("lens", sorted(_DECODE_LENS))
@pytest.mark.parametrize("quantized,H,F,bs", [
    (True, 16, 640, 64), (False, 16, 640, 64), (True, 4, 128, 32)])
def test_mla_decode_kernel(dev, quantized, H, F, bs, lens):
    _check_mla_decode(dev, quantized, H, F, bs, _DECODE_LENS[lens](bs))


@pytest.mark.parametrize("quantized,bs", [
    (False, 96), (False, 128), (False, 256), (True, 160), (True, 256)])
def test_mla_decode_kernel_at_pages_beyond_shared_memory(dev, quantized, bs):
    """Two pages of these sizes do not fit in a block's shared memory at
    F = 640, so the key tile is a part of the page (32, 64 or 128 rows):
    a sequence ending inside a page's first tile, on a tile edge, on a
    page edge, inside a later page, and a long one over several ranges."""
    kt = mla_decode.decode_key_tile(640, bs, 1, quantized)
    assert 0 < kt < bs and bs % kt == 0
    _check_mla_decode(dev, quantized, 16, 640, bs,
                      [5, kt, bs, 2 * bs + kt + 3, 9 * bs + 1, 0, 1, 0])


@pytest.mark.parametrize("quantized,bs", [
    # Key tile 64 for int8 rows, 32 for bf16 ones (F = 640): a tile that
    # is one page, a part of one, or spans two or three.
    (True, 64), (False, 32), (False, 64), (True, 96), (True, 32),
    (False, 16)])
def test_mla_prefill_kernel(dev, quantized, bs):
    """Query tiles of two positions: Q odd (the last tile has one), a
    tile that straddles a page edge and a causal bound, pad positions
    inside a tile and at the end, a sequence shorter than Q, an empty
    sequence; key tiles smaller and larger than a page.  Against the
    plain version, and twice: bit-equal."""
    g = _gen(2, dev)
    H, F, Q, L, layer = 16, 640, 33, 2, 1
    seq_lens = [Q, bs + 9, 3 * bs, 0, 5]
    S = len(seq_lens)
    nblk = S * 4 + 1
    kv, ks = _cache(g, dev, quantized, L, nblk * bs, F)
    bt = _tables(g, dev, seq_lens, bs, nblk)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q_pos = torch.full((S, Q), -1, dtype=torch.int32, device=dev)
    q_pos[0] = torch.arange(Q, device=dev)
    q_pos[1, :20] = torch.arange(bs - 11, bs + 9, device=dev)
    q_pos[2] = torch.arange(3 * bs - Q, 3 * bs, device=dev)
    q_pos[2, 7] = -1                       # a pad inside the tile (6, 7)
    q_pos[4, :5] = torch.arange(5, device=dev)
    qs = torch.randn((S, Q, H, F), generator=g, device=dev).bfloat16()
    args = (qs, q_pos, kv, bt, lens, bs, 0.13)
    kw = dict(layer=layer, kv_scale=ks)
    got = mla_prefill.mla_flash_prefill(*args, **kw)
    again = mla_prefill.mla_flash_prefill(*args, **kw)
    want = mla_prefill.mla_flash_prefill_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    assert torch.equal(got, again)
    assert torch.all(got[q_pos < 0] == 0)


def test_mla_prefill_kernel_rejects_misaligned_queries(dev):
    """Queries at an odd bf16 offset are contiguous but not 16-byte
    aligned: the wrapper raises instead of launching 16-byte loads."""
    S, Q, H, F, bs = 1, 2, 16, 640, 64
    kv = torch.zeros((1, 2 * bs, F), dtype=torch.bfloat16, device=dev)
    bt = torch.tensor([[1]], dtype=torch.int32, device=dev)
    lens = torch.tensor([2], dtype=torch.int32, device=dev)
    q_pos = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    buf = torch.zeros(S * Q * H * F + 1, dtype=torch.bfloat16, device=dev)
    qs = buf[1:].view(S, Q, H, F)
    assert qs.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        mla_prefill.mla_flash_prefill(qs, q_pos, kv, bt, lens, bs, 0.1,
                                      layer=0)


def _quant(g, dev, Lm, E, H, I):
    quant = {}
    for name, shape in (("w_gate", (Lm, E, H, I)), ("w_up", (Lm, E, H, I)),
                        ("w_down", (Lm, E, I, H))):
        quant[f"{name}_q"], quant[f"{name}_s"] = quantize_int8(
            torch.randn(shape, generator=g, device=dev) * 0.05)
    return quant


def _routing(g, dev, T, E, k):
    logits = torch.randn((T, E), generator=g, device=dev)
    cfg = dataclasses.replace(get_config("deepseek-v3-bench"), num_experts=E,
                              num_experts_per_tok=k)
    w, idx = M.route(logits, cfg)
    idx[:3, 1] = idx[:3, 0]                    # duplicate routes
    return w, idx


def _scaled_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-9))


@pytest.mark.parametrize("routing", ["topk", "one_expert", "none"])
@pytest.mark.parametrize("T", [1, 16, 40, 64])
def test_dense_moe_kernel(dev, T, routing):
    """Top-k routing, then comb matrices whose columns are zero but one
    (a single routed expert) or all (no routed expert: the output is
    exactly zero) -- the kernel reads no weight of an unrouted expert."""
    g = _gen(3, dev)
    E, H, I, k = 64, 2048, 512, 8
    quant = _quant(g, dev, 2, E, H, I)
    quant["layer"] = 1
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    w, idx = _routing(g, dev, T, E, k)
    comb = M._combine_matrix(T, E, idx, w)
    if routing == "one_expert":
        comb[:, :37] = 0
        comb[:, 38:] = 0
        comb[:, 37] = w[:, 0]
    elif routing == "none":
        comb.zero_()
    args = (x, comb, 1, quant["w_gate_q"], quant["w_gate_s"],
            quant["w_up_q"], quant["w_up_s"], quant["w_down_q"],
            quant["w_down_s"])
    from llm_d_tpu_torch.ops import moe_int8
    got = moe_int8.dense_moe_int8(*args)
    want = moe_int8.dense_moe_int8_plain(*args)
    if routing == "none":
        assert torch.equal(got, torch.zeros_like(got))
    else:
        assert _scaled_err(got, want) <= 1e-2
        assert torch.equal(got, moe_int8.dense_moe_int8(*args))


@pytest.mark.parametrize("T,rt", [(65, 16), (128, 32), (512, 64)])
def test_routed_moe_kernel(dev, T, rt):
    g = _gen(4, dev)
    E, H, I, k = 64, 2048, 512, 8
    quant = _quant(g, dev, 1, E, H, I)
    quant["layer"] = 0
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    w, idx = _routing(g, dev, T, E, k)
    got = M._routed_int8_kernel_path(x, w, idx, quant, row_tile=rt)
    # Oracle: all experts on the dequantized weights (the plain path).
    want = M._dense_expert_ffn(x, w, idx, *M._dequant_layer(quant))
    assert _scaled_err(got, want) <= 1e-2


@pytest.mark.parametrize("T,rt,tm", [
    (128, 32, 32),       # the bench's wave-2 decode: 32-row blocks
    (65, 16, 32),        # two 16-row tiles a block
    (256, 32, 64),       # 64-row blocks of two tiles
    (512, 64, 64)])
def test_routed_moe_kernel_on_the_streamed_passes(dev, monkeypatch, T, rt,
                                                  tm):
    """Kernel D runs E's launch with one chunk: against its plain version
    on the same metadata, at the row block ``row_block_for`` picks, and
    twice: bit-equal."""
    from llm_d_tpu_torch.ops import moe_routed as MR
    from llm_d_tpu_torch.ops import moe_routed_stream as MS
    g = _gen(10, dev)
    E, H, I, k = 64, 2048, 512, 8
    quant = _quant(g, dev, 2, E, H, I)
    quant["layer"] = 1
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    w, idx = _routing(g, dev, T, E, k)
    assert MS.row_block_for(T * k, E, rt) == tm
    seen = _spy(monkeypatch, MR, "routed_moe_int8")
    M._routed_int8_kernel_path(x, w, idx, quant, row_tile=rt)
    args, kw = seen["args"], seen["kw"]
    want = MR.routed_moe_int8_plain(*args, **kw)
    again = MR.routed_moe_int8(*args, **kw)
    torch.cuda.synchronize()
    assert _scaled_err(seen["out"], want) <= 1e-2
    assert torch.equal(seen["out"], again)


def _spy(monkeypatch, module, name):
    """Replace ``module.name`` by a wrapper that records its last call."""
    real = getattr(module, name)
    seen = {}

    def wrapped(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        seen["out"] = real(*args, **kw)
        return seen["out"]

    wrapped.launches = 0
    monkeypatch.setattr(module, name, wrapped)
    return seen


@pytest.mark.parametrize("T,chunk_t,rt,routing", [
    # Rows a block: 128 once the padded T reaches 2048 (k = 8, E = 64),
    # else 64; tiles a row block in brackets.
    (600, 512, 32, "topk"),           # T not a multiple of chunk_t (2)
    (1024, 1024, 64, "topk"),         # (1)
    (1792, 128, 16, "topk"),          # 14 chunks (4)
    (2304, 256, 16, "topk"),          # (8)
    (2048, 512, 32, "skewed"),        # one expert over every chunk (4)
    (2000, 256, 16, "topk"),          # partial last chunk at rt 16 (8)
    (8192, 512, 32, "topk"),          # the bench's step, 16 chunks (4)
    (8192, 8192, 64, "topk"),         # ... as one chunk (2)
])
def test_streamed_moe_kernel(dev, monkeypatch, T, chunk_t, rt, routing):
    """Kernel E through its glue against its plain version on the same
    metadata: row blocks whose tiles come from several chunks, pad rows,
    idle tiles, every row tile and both row-block heights; twice:
    bit-equal."""
    from llm_d_tpu_torch.ops import moe_routed_stream as MS
    g = _gen(5, dev)
    E, H, I, k = 64, 2048, 512, 8
    quant = _quant(g, dev, 2, E, H, I)
    quant["layer"] = 1
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    w, idx = _routing(g, dev, T, E, k)
    if routing == "skewed":
        idx[:, 0] = 5                      # ~T rows of expert 5
        idx[:, 1:] = torch.where(idx[:, 1:] == 5, 6, idx[:, 1:])
    seen = _spy(monkeypatch, MS, "streamed_moe_int8")
    got = M._streamed_int8_kernel_path(x, w, idx, quant, chunk_t=chunk_t,
                                       row_tile=rt)
    args, kw = seen["args"], seen["kw"]
    want = MS.streamed_moe_int8_plain(*args, **kw)
    again = MS.streamed_moe_int8(*args, **kw)
    torch.cuda.synchronize()
    assert _scaled_err(seen["out"], want) <= 1e-2
    assert torch.equal(seen["out"], again)
    assert got.shape == (T, H) and torch.isfinite(got.float()).all()


@pytest.mark.parametrize("T,chunk_t,rt,per_block", [
    (600, 512, 32, 2), (2000, 256, 16, 8), (8192, 512, 32, 4),
    (8192, 8192, 64, 2), (700, 256, 64, 1)])
def test_streamed_row_blocks_kernel(dev, T, chunk_t, rt, per_block):
    """Kernel E's grouping launch gives the plain grouping's table
    exactly, on the glue's per-chunk layout."""
    from llm_d_tpu_torch.ops import moe_routed_stream as MS
    g = _gen(8, dev)
    E, k = 64, 8
    C = -(-T // chunk_t)
    w, idx = _routing(g, dev, C * chunk_t, E, k)
    *_, tile_e, num_tiles = M._sorted_tile_layout(
        idx.reshape(C, -1), w.reshape(C, -1), k, E, rt)
    tile_e = tile_e.reshape(-1).contiguous()
    num_tiles = num_tiles.contiguous()
    got = MS.expert_row_blocks(tile_e, num_tiles, E, per_block)
    want = MS.expert_row_blocks_plain(tile_e, num_tiles, E, per_block)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_streamed_moe_kernel_skips_idle_row_blocks(dev):
    """No routed row beyond one expert's: every other row block is idle
    and exits, and the output matches the plain version."""
    from llm_d_tpu_torch.ops import moe_routed_stream as MS
    g = _gen(7, dev)
    E, H, I, k, T = 64, 2048, 512, 2, 700
    quant = _quant(g, dev, 1, E, H, I)
    quant["layer"] = 0
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    idx = torch.full((T, k), 9, dtype=torch.long, device=dev)
    w = torch.rand((T, k), generator=g, device=dev)
    before = MS.streamed_moe_int8.launches
    got = M._streamed_int8_kernel_path(x, w, idx, quant, chunk_t=256,
                                       row_tile=32)
    want = M._dense_expert_ffn(x, w, idx, *M._dequant_layer(quant))
    assert _scaled_err(got, want) <= 1e-2
    assert MS.streamed_moe_int8.launches == before + 1


def test_streamed_moe_kernel_rejects_misaligned_rows(dev, monkeypatch):
    """x at an odd bf16 offset is contiguous but not 16-byte aligned: the
    wrapper raises instead of launching cp.async row copies."""
    from llm_d_tpu_torch.ops import moe_routed_stream as MS
    g = _gen(9, dev)
    E, H, I, k, T = 64, 2048, 512, 8, 256
    quant = _quant(g, dev, 1, E, H, I)
    quant["layer"] = 0
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    w, idx = _routing(g, dev, T, E, k)
    seen = _spy(monkeypatch, MS, "streamed_moe_int8")
    M._streamed_int8_kernel_path(x, w, idx, quant, chunk_t=256, row_tile=32)
    args = list(seen["args"])
    buf = torch.zeros(args[0].numel() + 1, dtype=torch.bfloat16, device=dev)
    args[0] = buf[1:].view_as(args[0]).copy_(args[0])
    with pytest.raises(ValueError, match="aligned"):
        MS.streamed_moe_int8(*args, **seen["kw"])


@pytest.mark.parametrize("T,rt", [(600, 128), (2048, 256), (100, 64),
                                  (1000, 32)])
def test_grouped_moe_kernel(dev, monkeypatch, T, rt):
    """Kernel F through its glue (E's passes with the identity row map, in
    row blocks of 128, 64 or 32 rows dividing the row tile) against its
    plain version on the same sorted, padded rows; the unpopulated tail
    tiles must come back zero, and a second call bit-equal."""
    from llm_d_tpu_torch.ops import moe_int8
    g = _gen(6, dev)
    E, H, I, k = 64, 2048, 512, 8
    quant = _quant(g, dev, 1, E, H, I)
    quant["layer"] = 0
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    w, idx = _routing(g, dev, T, E, k)
    seen = _spy(monkeypatch, moe_int8, "grouped_moe_int8")
    M._grouped_int8_kernel_path(x, w, idx, quant, row_tile=rt)
    want = moe_int8.grouped_moe_int8_plain(*seen["args"], **seen["kw"])
    assert _scaled_err(seen["out"], want) <= 1e-2
    n_live = int(seen["args"][3]) * rt
    assert n_live < seen["out"].shape[0]
    assert torch.all(seen["out"][n_live:] == 0)
    again = moe_int8.grouped_moe_int8(*seen["args"], **seen["kw"])
    assert torch.equal(seen["out"], again)


@pytest.mark.parametrize("prefill_kernel,fn", [
    ("streamed", "moe_routed_stream.streamed_moe_int8"),
    ("grouped", "moe_int8.grouped_moe_int8")])
def test_expert_ffn_above_512_tokens_launches_kernel(dev, monkeypatch,
                                                     prefill_kernel, fn):
    """T > 512 on the card goes to kernel E, or to F under
    LLMD_MOE_PREFILL_KERNEL=grouped, and agrees with the plain path."""
    import importlib
    monkeypatch.setenv("LLMD_MOE_PREFILL_KERNEL", prefill_kernel)
    mod_name, name = fn.split(".")
    mod = importlib.import_module(f"llm_d_tpu_torch.ops.{mod_name}")
    g = _gen(7, dev)
    E, H, I, k, T = 64, 2048, 512, 8, 513
    quant = _quant(g, dev, 1, E, H, I)
    quant["layer"] = 0
    x = torch.randn((T, H), generator=g, device=dev).bfloat16()
    w, idx = _routing(g, dev, T, E, k)
    before = getattr(mod, name).launches
    got = M.expert_ffn(x, w, idx, None, None, None, quant=quant)
    assert getattr(mod, name).launches == before + 1
    want = M._dense_expert_ffn(x, w, idx, *M._dequant_layer(quant))
    assert _scaled_err(got, want) <= 1e-2


def _dense_cache(g, dev, L, slots, F, sw):
    """bf16 K and V caches, or int8 ones with ``sw`` scale columns."""
    out = []
    for _ in range(2):
        rows = torch.randn((L, slots, F), generator=g, device=dev).bfloat16()
        out.append((rows, None) if sw == 0 else quantize_kv_block(rows, sw))
    return out


def _check_paged_decode(dev, H, KVH, D, bs, sw, seq_lens):
    """Kernel G against its plain version: output within tolerance, and
    the K/V cache and scale planes identical after the in-place splice."""
    from llm_d_tpu_torch.ops import paged_attention as PA
    g = _gen(8, dev)
    S, L, layer, F = len(seq_lens), 3, 1, KVH * D
    nblk = S * max(-(-n // bs) for n in seq_lens) + 1
    (kc, ks), (vc, vs) = _dense_cache(g, dev, L, nblk * bs, F, sw)
    bt = _tables(g, dev, seq_lens, bs, nblk)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q = torch.randn((S, H, D), generator=g, device=dev).bfloat16()
    kn = torch.randn((S, F), generator=g, device=dev).bfloat16()
    vn = torch.randn((S, F), generator=g, device=dev).bfloat16()
    kns = vns = None
    if sw:
        kn, kns = quantize_kv_block(kn, sw)
        vn, vns = quantize_kv_block(vn, sw)
    outs, planes = [], []
    for fn in (PA.paged_attention_decode_update,
               PA.paged_attention_decode_update_plain):
        c = [t.clone() if t is not None else None for t in (kc, vc, ks, vs)]
        outs.append(fn(q, kn, vn, c[0], c[1], bt, lens, bs, KVH, scale=0.1,
                       layer=layer, k_scale=c[2], v_scale=c[3],
                       k_scale_new=kns, v_scale_new=vns))
        planes.append(c)
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0].float(), outs[1].float(), **TOL)
    assert torch.all(outs[0][lens == 0] == 0)
    for a, b in zip(*planes):
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("H,KVH,D,bs,sw", [
    (32, 8, 64, 64, 0), (32, 8, 64, 64, 1), (32, 8, 64, 64, 8),
    (8, 2, 64, 32, 2), (8, 4, 128, 16, 0),
    # Pages beyond what a page-sized tile fit (the first version refused
    # D = 128 at 512 rows): the key tile is apart from the block size.
    (32, 8, 64, 128, 0), (32, 8, 64, 256, 8), (32, 8, 64, 512, 0),
    (32, 8, 128, 128, 8), (32, 8, 128, 256, 0), (32, 8, 128, 512, 8),
    (32, 8, 128, 512, 0),
    # G = 16 on one KV head (four warps share its keys), G = 6 (mixtral).
    (16, 1, 128, 256, 1), (48, 8, 128, 64, 0)])
def test_paged_decode_kernel(dev, H, KVH, D, bs, sw):
    """Kernel G: output within tolerance, and the K/V cache and scale
    planes identical to the plain version's after the in-place splice."""
    _check_paged_decode(dev, H, KVH, D, bs, sw,
                        [1, bs // 2, bs, bs + 3, 3 * bs, 0, 0])


@pytest.mark.parametrize("sw", [0, 8])
def test_paged_decode_kernel_splits_long_contexts(dev, sw):
    """Kernel G at 8 sequences x 4096 keys (llama3-1b's heads): each
    sequence's key tiles are split over several blocks and combined in
    order; output within tolerance, splice exact."""
    from llm_d_tpu_torch.ops import paged_attention as PA
    wh, kt, _ = PA.decode_plan(8, 64, sw > 0, sw > 1)
    assert PA.num_splits(8, 8 // wh, 4096 // kt, PA._sm_count(
        dev.index or 0)) > 1
    _check_paged_decode(dev, 32, 8, 64, 64, sw, [4096] * 8)


@pytest.mark.parametrize("H,KVH,D,bs,sw,soft_cap", [
    (32, 8, 64, 64, 0, None), (32, 8, 64, 64, 1, None),
    (32, 8, 64, 64, 8, 30.0), (8, 2, 64, 32, 0, 5.0),
    (8, 4, 128, 16, 4, None),
    # Pages beyond what a page-sized tile fit (the first version refused
    # D = 128 at 256 and 512 rows and D = 64 at 512).
    (32, 8, 64, 128, 0, None), (32, 8, 64, 256, 8, None),
    (32, 8, 64, 512, 0, None), (32, 8, 128, 128, 8, None),
    (32, 8, 128, 256, 0, 30.0), (32, 8, 128, 256, 8, None),
    (32, 8, 128, 512, 8, None), (32, 8, 128, 512, 0, None),
    # MHA (G = 1), G = 8 (qwen3-32b, llama3-70b), G = 6 (does not divide
    # the 64-row tile).
    (8, 8, 64, 64, 0, None), (8, 8, 128, 256, 8, None),
    (64, 8, 128, 64, 0, None), (64, 8, 128, 256, 8, None),
    (48, 8, 128, 64, 0, None)])
def test_flash_prefill_kernel(dev, H, KVH, D, bs, sw, soft_cap):
    """Kernel H: causal prefill with pad rows, a pad sequence, a stacked
    layer index and (where given) soft_cap, against its plain version."""
    from llm_d_tpu_torch.ops import flash_prefill as FP
    g = _gen(9, dev)
    Q, L, layer, F = 48, 2, 1, KVH * D
    seq_lens = [Q, bs + 9, 3 * bs, 0]
    S = len(seq_lens)
    nblk = S * 4 + 1
    (kc, ks), (vc, vs) = _dense_cache(g, dev, L, nblk * bs, F, sw)
    bt = _tables(g, dev, seq_lens, bs, nblk)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q_pos = torch.full((S, Q), -1, dtype=torch.int32, device=dev)
    q_pos[0] = torch.arange(Q, device=dev)
    q_pos[1, :20] = torch.arange(bs - 11, bs + 9, device=dev)
    q_pos[2] = torch.arange(3 * bs - Q, 3 * bs, device=dev)
    qs = torch.randn((S, Q, H, D), generator=g, device=dev).bfloat16()
    args = (qs, q_pos, kc, vc, bt, lens, bs, KVH)
    kw = dict(scale=0.12, soft_cap=soft_cap, layer=layer, k_scale=ks,
              v_scale=vs)
    got = FP.flash_prefill_paged(*args, **kw)
    want = FP.flash_prefill_paged_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    assert torch.all(got[q_pos < 0] == 0)


def test_llama_engine_on_the_card_matches_the_cpu_reference(dev):
    """Two layers of llama3-1b at full width, bf16 cache: the first
    generated token of each request through kernels H (prefill) and G
    (decode) equals the CPU reference's, and both kernels launched."""
    from llm_d_tpu_torch.ops import flash_prefill as FP
    from llm_d_tpu_torch.ops import paged_attention as PA
    cfg = dataclasses.replace(get_config("llama3-1b"), num_layers=2)
    kw = dict(model_config=cfg, block_size=64, num_blocks=32,
              max_num_seqs=8, max_num_batched_tokens=512,
              enable_prefix_caching=False)
    card = EngineCore(EngineConfig(device="cuda", **kw))
    host = EngineCore(EngineConfig(device="cpu", **kw), params={
        k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
            else v.cpu()) for k, v in card.params.items()})
    g = torch.Generator().manual_seed(10)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (5, 70, 17)]
    launches = (PA.paged_attention_decode_update.launches,
                FP.flash_prefill_paged.launches)
    outs = [eng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
        for i, p in enumerate(prompts)]) for eng in (card, host)]
    assert [v[0] for v in outs[0].values()] == \
        [v[0] for v in outs[1].values()]
    assert PA.paged_attention_decode_update.launches > launches[0]
    assert FP.flash_prefill_paged.launches > launches[1]


@pytest.mark.parametrize("kv_cache_dtype,bs", [
    ("int8", 64), ("bf16", 64), ("bf16", 128), ("int8", 256)])
def test_engine_on_the_card_matches_the_cpu_reference(dev, kv_cache_dtype,
                                                      bs):
    """Two layers of deepseek-v3-bench at full width: the first generated
    token of each request through the kernels equals the CPU reference's
    (prefill through kernels B and D, decode through A and C), on int8
    and bf16 latent caches in 64-row pages and in pages larger than two
    fit kernel A's shared memory (bf16 128, int8 256)."""
    cfg = dataclasses.replace(get_config("deepseek-v3-bench"), num_layers=2)
    kw = dict(model_config=cfg, block_size=bs, num_blocks=2048 // bs,
              max_num_seqs=8, max_num_batched_tokens=512,
              quantization="int8", kv_cache_dtype=kv_cache_dtype,
              enable_prefix_caching=False)
    card = EngineCore(EngineConfig(device="cuda", **kw))
    host = EngineCore(EngineConfig(device="cpu", **kw), params={
        k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
            else v.cpu()) for k, v in card.params.items()})
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (5, 70, 17)]
    outs = [eng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
        for i, p in enumerate(prompts)]) for eng in (card, host)]
    assert [v[0] for v in outs[0].values()] == \
        [v[0] for v in outs[1].values()]


def test_tiny_serves_on_the_card_through_the_chunked_path(dev):
    """tiny's rows (KVH*D = 32) fit no kernel: on the card every batch
    goes through the chunked attention path, and the greedy tokens equal
    the CPU engine's on the 'chunked' backend."""
    from llm_d_tpu_torch.ops import attention as A
    kw = dict(model="tiny", block_size=32, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=256, enable_prefix_caching=False)
    card = EngineCore(EngineConfig(device="cuda", **kw))
    host = EngineCore(EngineConfig(device="cpu", attn_backend="chunked",
                                   **kw), params={
        k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
            else v.cpu()) for k, v in card.params.items()})
    g = torch.Generator().manual_seed(11)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 70, 17)]
    outs = [eng.generate([Request(f"r{i}", p, SamplingParams(
        temperature=0.0, max_tokens=8, ignore_eos=True))
        for i, p in enumerate(prompts)]) for eng in (card, host)]
    assert [v[0] for v in outs[0].values()] == \
        [v[0] for v in outs[1].values()]
    assert A.resolve_backend("auto", dev) == "kernel"


def test_gumbel_noise_on_the_card_is_the_cpu_noise(dev):
    """The threefry sampler's noise is integer and single-rounding f32
    arithmetic: drawn on the card it is bit-equal to the CPU's."""
    from llm_d_tpu_torch.ops import prng
    from llm_d_tpu_torch.ops.sampling import row_noise
    seeds = torch.tensor([0, 7, 2**31 - 1, -1, -1, 5], dtype=torch.int32)
    gen = torch.tensor([0, 1, 1000, 2, 0, 9], dtype=torch.int32)
    _, step = prng.split(prng.prng_key(3))
    cpu = row_noise(6, 64, torch.device("cpu"), step, seeds, gen)
    card = row_noise(6, 64, dev, step, seeds.to(dev), gen.to(dev)).cpu()
    assert torch.equal(cpu.view(torch.int32), card.view(torch.int32))


def test_accept_coin_on_the_card_is_the_cpu_coin(dev):
    """The fixed-acceptance coin (threefry bits and the [0, 1) mantissa
    trick) drawn on the card is bit-equal to the CPU's, at bench_spec's
    (256, 4) over 64 steps."""
    from llm_d_tpu_torch.ops.sampling import accept_coin
    for step in range(64):
        cpu = accept_coin(step, 256, 4, "cpu")
        card = accept_coin(step, 256, 4, dev).cpu()
        assert torch.equal(cpu.view(torch.int32), card.view(torch.int32))


@pytest.mark.parametrize("fixed", [None, 0.7])
def test_spec_engine_on_the_card_repeats_and_frees_its_blocks(dev, fixed):
    """Two layers of deepseek-v3-bench at full width with spec decode (K =
    4, real verification or the fixed coin): a mixed wave (12 prompts,
    half of them added while the rest decode) served by two engines on
    the same weights (the coin follows the engine's step count) gives
    the same tokens, every request ends by length, kernel B ran the
    verify rows (Q = 16), and the pool is whole again after each
    wave."""
    from llm_d_tpu_torch.ops import mla_prefill as MP
    engines = [_bench_2layer_engine(dev, spec_k=4, spec_fixed_accept=fixed)]
    engines.append(_bench_2layer_engine(
        dev, params=engines[0].params, spec_k=4, spec_fixed_accept=fixed))
    free0 = engines[0].kv_manager.num_free_blocks
    seen = []
    real = MP.mla_flash_prefill

    def spy(qs, *a, **kw):
        seen.append(qs.shape[1])
        return real(qs, *a, **kw)

    spy.launches = 0

    def wave(eng, tag):
        g = torch.Generator().manual_seed(5)
        reqs = [Request(f"{tag}{i}", torch.randint(
            1, 32768, (20 + 9 * i,), generator=g).tolist(), SamplingParams(
                temperature=0.0, max_tokens=24, ignore_eos=True))
            for i in range(12)]
        for r in reqs[:6]:
            eng.add_request(r)
        for r in reqs[6:]:
            eng.step()
            eng.add_request(r)
        while eng.has_work():
            eng.step()
        assert all(len(r.output_token_ids) == 24 for r in reqs)
        assert eng.kv_manager.num_free_blocks == free0
        assert eng.kv_manager._ref == {}
        return [r.output_token_ids for r in reqs], reqs

    MP.mla_flash_prefill = spy
    try:
        first, reqs = wave(engines[0], "s")
        again, _ = wave(engines[1], "t")
    finally:
        MP.mla_flash_prefill = real
    assert first == again
    assert 16 in seen
    assert sum(r.spec_drafted for r in reqs) > 0
    if fixed is not None:
        assert sum(r.spec_accepted for r in reqs) > 0


def _bench_2layer_engine(dev, params=None, draft_params=None, **over):
    """Two layers of deepseek-v3-bench at full width as bench.py serves
    it (int8 experts and latent, 64-row pages), with ``over`` on top."""
    cfg = dataclasses.replace(get_config("deepseek-v3-bench"), num_layers=2,
                              max_model_len=1024)
    kw = dict(model_config=cfg, block_size=64, num_blocks=480,
              max_num_seqs=128, max_num_batched_tokens=8192,
              quantization="int8", kv_cache_dtype="int8",
              enable_prefix_caching=False, device="cuda", seed=7)
    kw.update(over)
    return EngineCore(EngineConfig(**kw), params=params,
                      draft_params=draft_params)


def _block_requests(n, K, sampled, seed):
    """``n`` requests of 40-90 prompt tokens, each served by its prefill
    step and then exactly one K-step block; sampled ones alternate seeded
    and unseeded rows at temperature 0.7."""
    g = torch.Generator().manual_seed(seed)
    reqs = []
    for i in range(n):
        p = torch.randint(1, 32768, (40 + (i * 7) % 51,), generator=g)
        reqs.append(Request(f"b{i}", p.tolist(), SamplingParams(
            temperature=0.7 if sampled else 0.0, top_p=0.9,
            seed=(1234 + i) if sampled and i % 2 else None,
            max_tokens=1 + K, ignore_eos=True)))
    return reqs


def test_graphs_read_the_rows_a_connector_scatter_and_a_restore_wrote(dev):
    """A decode block's graph is captured first; then a PD consumer's
    scatter and a host-tier restore write rows into the cache tensors it
    captured (in place: no buffer is rebound), and the blocks that read
    them are replays of that same graph.  Their tokens equal those of
    engines that read the same rows without graphs or without the tier:
    a classic-loop consumer pulling from the same producer, and a control
    engine whose third pass hits its device prefix cache (same batch
    shapes, so bit-equal)."""
    import time
    from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
    K = 8

    def greedy(rid, prompt, n=1 + K, **kw):
        return Request(rid, prompt, SamplingParams(
            temperature=0.0, max_tokens=n, ignore_eos=True), **kw)

    g = torch.Generator().manual_seed(21)

    def prompt(n):
        return torch.randint(1, 32768, (n,), generator=g).tolist()

    kw = dict(num_scheduler_steps=K, enable_prefix_caching=True,
              num_blocks=8, kv_offload_blocks=64)
    eng = _bench_2layer_engine(dev, **kw)
    eng.generate([greedy("warm", prompt(70))])
    n_graphs = len(eng._graphs.graphs)
    ptrs = {k: v.data_ptr() for k, v in eng.kv_cache.items()}

    # P/D: the graphed engine consumes; a classic-loop consumer reads the
    # same rows eagerly.
    producer = _bench_2layer_engine(dev, params=eng.params)
    classic = _bench_2layer_engine(dev, params=eng.params)
    producer.kv_connector = TpuConnector(KVConnectorConfig(
        kv_role="kv_producer", host="127.0.0.1"))
    p_pd = prompt(90)
    tokens = {}
    for name, cons in (("graphed", eng), ("classic", classic)):
        cons.kv_connector = TpuConnector(KVConnectorConfig(
            kv_role="kv_consumer"))
        pre = greedy(f"pd-{name}", p_pd, 1, do_remote_decode=True)
        producer.generate([pre])
        tokens[name] = cons.generate([greedy(
            f"pd-{name}", p_pd, do_remote_prefill=True,
            kv_transfer_params=pre.kv_transfer_params)])[f"pd-{name}"]
        cons.kv_connector.close()
        cons.kv_connector = None
    assert tokens["graphed"] == tokens["classic"]
    for _ in range(500):
        producer.step()
        if not producer.pinned_transfers:
            break
        time.sleep(0.01)
    assert producer.kv_manager.usage == 0.0
    producer.kv_connector.close()

    # The tier: A, fillers that evict A's prefix, A again (restored).
    control = _bench_2layer_engine(dev, params=eng.params,
                                   **dict(kw, num_blocks=64,
                                          kv_offload_blocks=0))
    p_a = prompt(130)
    fillers = [prompt(130) for _ in range(3)]
    runs = {}
    for name, e in (("tier", eng), ("control", control)):
        runs[name] = [e.generate([greedy(f"a{i}", p)])[f"a{i}"]
                      for i, p in enumerate([p_a, *fillers, p_a])]
    assert eng.host_tier.loads >= 2 and eng.kv_manager.eviction_count > 0
    assert control.kv_manager.eviction_count == 0
    assert runs["tier"] == runs["control"]
    assert len(eng._graphs.graphs) == n_graphs
    assert {k: v.data_ptr() for k, v in eng.kv_cache.items()} == ptrs


@pytest.mark.parametrize("n,S", [(6, 8), (40, 64), (100, 128)])
@pytest.mark.parametrize("sampled", [False, True])
def test_decode_block_graph_replay_equals_the_eager_body(dev, n, S,
                                                         sampled):
    """A decode block served through its CUDA graph, replayed again on the
    same static inputs and cache, is bit-equal to the block's eager body
    (``EngineCore._ms_body``) from the same cache: the ids and the cache
    it leaves.  The replay's ids are also the tokens the engine served,
    and the replays launched kernels A and C (S <= 64) or D (S = 128)."""
    K = 8
    eng = _bench_2layer_engine(dev, num_scheduler_steps=K)
    reqs = _block_requests(n, K, sampled, seed=S)
    eng.generate(reqs)
    assert eng._dispatch_count == 2 and eng._step_count == 1 + K
    g = eng._graphs.graphs[(S, sampled)]
    served = torch.tensor([r.output_token_ids[1:] for r in reqs],
                          dtype=torch.int32)
    snap = {k: v.clone() for k, v in eng.kv_cache.items()}
    g.graph.replay()
    torch.cuda.synchronize()
    ids_graph = g.outputs["ids"].clone()
    kv_graph = {k: v.clone() for k, v in eng.kv_cache.items()}
    for k, v in eng.kv_cache.items():
        v.copy_(snap[k])
    ids_eager = torch.empty_like(g.outputs["ids"])
    eng._ms_body(g.inputs, g.inputs["keys"], ids_eager, sampled)
    torch.cuda.synchronize()
    assert torch.equal(ids_graph, ids_eager)
    for k, v in eng.kv_cache.items():
        assert torch.equal(v, kv_graph[k]), k
    assert torch.equal(ids_graph[:, :n].cpu().T, served)
    moe = "dense_moe_int8" if S <= 64 else "routed_moe_int8"
    for name in ("mla_paged_decode_update", moe):
        assert eng._graphs.launches[name] > 0, name


@pytest.mark.parametrize("N", [1, 2])
def test_fused_graph_replay_equals_the_eager_body(dev, N):
    """Spec decode (K = 4, fixed acceptance 0.7) on the 2-layer bench
    engine: every fused round (N = 1, the single round) or N = 2
    dispatch is a graph replay; each captured key, replayed again on its
    static inputs and cache, is bit-equal to its eager body
    (``EngineCore._fms_body``) from the same cache: every output (ids,
    acceptance, final carry) and the cache outside block 0 (the trash
    block dead slots write).  The replays launched kernel B; requests
    end by length and the pool is whole."""
    from llm_d_tpu_torch.engine.cuda_graph import replay_equals_eager
    eng = _bench_2layer_engine(dev, spec_k=4, spec_fixed_accept=0.7,
                               num_scheduler_steps=N)
    free0 = eng.kv_manager.num_free_blocks
    reqs = _block_requests(12, 11, False, seed=N)
    eng.generate(reqs)
    assert all(len(r.output_token_ids) == 12 for r in reqs)
    assert eng.kv_manager.num_free_blocks == free0
    keys = [k for k in eng._graphs.graphs if k[0] == "fms"]
    assert keys and all(k[6] == N for k in keys)
    assert eng._graphs.replays >= eng._dispatch_count
    for key in keys:
        g = eng._graphs.graphs[key]
        res = replay_equals_eager(
            g, eng.kv_cache, lambda out: eng._fms_body(
                g.inputs, out, N, key[7], key[8], key[9]),
            trash_rows=eng.config.block_size)
        assert res == dict(outputs_equal=True, cache_equal=True), key
    assert eng._graphs.launches["mla_flash_prefill"] > 0
    if N > 1:
        assert eng._step_count > eng._dispatch_count


def test_everything_on_tiny_mla_on_the_card_equals_its_n1_run(dev):
    """``tiny-mla`` (int8 latent in 32-row pages; its 64-wide experts
    are below the int8 kernels' 128-column tile, so they stay bf16) with
    spec decode everything-on (K = 4, N = 4, async scheduling): greedy
    tokens equal the same engine's at N = 1 (the single fused round,
    also graphed) on the same weights, the pipeline chains dispatches,
    and the pool is whole."""
    kw = dict(model="tiny-mla", kv_cache_dtype="int8", block_size=32,
              num_blocks=64, max_num_seqs=8, max_num_batched_tokens=256,
              enable_prefix_caching=False, device="cuda", spec_k=4)
    one = EngineCore(EngineConfig(**kw))
    eon = EngineCore(EngineConfig(**kw, num_scheduler_steps=4,
                                  async_scheduling=True),
                     params=one.params, draft_params=one.draft_params)

    def reqs():
        g = torch.Generator().manual_seed(9)
        return [Request(f"m{i}", torch.randint(1, 512, (5 + 11 * i,),
                                               generator=g).tolist(),
                        SamplingParams(temperature=0.0, max_tokens=20 + i,
                                       ignore_eos=True)) for i in range(5)]

    free0 = eon.kv_manager.num_free_blocks
    want = one.generate(reqs())
    assert eon.generate(reqs()) == want
    assert eon._step_count > 2 * eon._dispatch_count
    assert eon._graphs.replays == eon._dispatch_count
    assert eon.kv_manager.num_free_blocks == free0


def test_async_tokens_equal_sync_tokens_on_the_card(dev):
    """The bench's pipeline on the card (K = 8 here): async scheduling
    serves the same tokens as sync multistep, and both the classic loop's,
    greedy rows and seeded sampled rows alike (a seeded row's noise
    follows its seed and position, whatever the step keys), with
    max_tokens ending mid-block, on a block boundary and inside the first
    block."""
    K = 8
    sync = _bench_2layer_engine(dev, num_scheduler_steps=K)
    async_ = _bench_2layer_engine(dev, num_scheduler_steps=K,
                                  async_scheduling=True, params=sync.params)
    classic = _bench_2layer_engine(dev, params=sync.params)
    cases = [(30, 33, 0.0, None), (9, 20, 0.0, None), (70, 17, 0.7, 1234),
             (100, 5, 0.0, None), (64, 25, 0.7, 99)]

    def reqs():
        gg = torch.Generator().manual_seed(3)
        return [Request(f"a{i}", torch.randint(1, 32768, (n,),
                                               generator=gg).tolist(),
                        SamplingParams(temperature=t, max_tokens=m, seed=s,
                                       ignore_eos=True))
                for i, (n, m, t, s) in enumerate(cases)]

    want = sync.generate(reqs())
    got = async_.generate(reqs())
    assert got == want
    assert classic.generate(reqs()) == want
    assert [len(v) for v in got.values()] == [c[1] for c in cases]
    assert async_._graphs.replays > 1
    assert async_._dispatch_count < async_._step_count


def test_a_failed_capture_raises(dev, monkeypatch):
    """A decode block whose body syncs the host cannot be captured: the
    engine raises and never serves the block eagerly instead."""
    from llm_d_tpu_torch.ops import sampling as SO
    real = SO.sample

    def syncing_sample(logits, *a, **kw):
        float(logits.sum())              # a host sync: illegal in a capture
        return real(logits, *a, **kw)

    monkeypatch.setattr(SO, "sample", syncing_sample)
    eng = _bench_2layer_engine(dev, num_scheduler_steps=8)
    with pytest.raises(RuntimeError):
        eng.generate(_block_requests(3, 8, False, seed=1))
    assert eng._graphs.replays == 0
    assert not eng._graphs.graphs         # the failed key holds no graph


def test_bf16_experts_past_the_dense_bound_are_refused_at_build(dev):
    """bf16 experts over 512 tokens run the grouped plain path, which
    reads its group sizes to the host: a graph cannot hold it, so an
    engine that would capture such a step raises when it is built (a
    fused round captures up to max_num_batched_tokens, a decode block up
    to its row bucket); within the bound it builds, and int8 experts
    build at any size."""
    kw = dict(model="tiny-mla", block_size=32, num_blocks=64,
              enable_prefix_caching=False, device="cuda")
    with pytest.raises(ValueError, match="bf16 experts"):
        EngineCore(EngineConfig(spec_k=4, max_num_batched_tokens=8192,
                                **kw))
    with pytest.raises(ValueError, match="max_num_seqs"):
        EngineCore(EngineConfig(num_scheduler_steps=4, max_num_seqs=1024,
                                max_num_batched_tokens=8192, **kw))
    EngineCore(EngineConfig(spec_k=4, max_num_batched_tokens=512, **kw))
    EngineCore(EngineConfig(num_scheduler_steps=4, max_num_seqs=256,
                            max_num_batched_tokens=8192, **kw))
    EngineCore(EngineConfig(spec_k=4, max_num_batched_tokens=8192,
                            quantization="int8", **kw))


@pytest.mark.parametrize("N", [1, 2])
def test_fused_rounds_through_the_chunked_path_are_captured(dev, N):
    """tiny's rows (KVH*D = 32) fit no kernel, so its fused rounds attend
    through the chunked path, whose context bound is read to the host
    eagerly and is the whole table under a capture: spec decode (K = 4)
    at N rounds a dispatch serves by length with the pool whole, and
    each captured key's replay is bit-equal to its eager body."""
    from llm_d_tpu_torch.engine.cuda_graph import replay_equals_eager
    eng = EngineCore(EngineConfig(
        model="tiny", block_size=32, num_blocks=64, max_num_seqs=8,
        max_num_batched_tokens=256, enable_prefix_caching=False,
        device="cuda", spec_k=4, num_scheduler_steps=N,
        async_scheduling=N > 1))
    free0 = eng.kv_manager.num_free_blocks
    g = torch.Generator().manual_seed(5)
    reqs = [Request(f"c{i}", torch.randint(1, 512, (3 + 17 * i,),
                                           generator=g).tolist(),
                    SamplingParams(temperature=0.0, max_tokens=12 + i,
                                   ignore_eos=True)) for i in range(5)]
    eng.generate(reqs)
    assert [len(r.output_token_ids) for r in reqs] == [12 + i
                                                       for i in range(5)]
    assert eng.kv_manager.num_free_blocks == free0
    keys = [k for k in eng._graphs.graphs if k[0] == "fms"]
    assert keys and eng._graphs.replays == eng._dispatch_count
    for key in keys:
        gr = eng._graphs.graphs[key]
        res = replay_equals_eager(
            gr, eng.kv_cache, lambda out: eng._fms_body(
                gr.inputs, out, key[6], key[7], key[8], key[9]),
            trash_rows=eng.config.block_size)
        assert res == dict(outputs_equal=True, cache_equal=True), key


@pytest.mark.parametrize("cap", ["keys", "pool"])
def test_capped_graphs_serve_the_uncapped_tokens(dev, monkeypatch, cap):
    """With at most two graphs (``CUDA_GRAPH_MAX_KEYS``), or a 1 MB pool
    cap (every new key then finds the pool full and starts a fresh one),
    a spec engine whose traffic meets more fused keys than that drops
    graphs and captures again, and serves the tokens of an engine with
    the default caps on the same weights."""
    from llm_d_tpu_torch.engine import engine as E
    kw = dict(model="tiny-mla", kv_cache_dtype="int8", block_size=32,
              num_blocks=64, max_num_seqs=8, max_num_batched_tokens=256,
              enable_prefix_caching=False, device="cuda", spec_k=4)

    def reqs():
        g = torch.Generator().manual_seed(4)
        return [Request(f"k{i}", torch.randint(1, 512, (5 + 13 * i,),
                                               generator=g).tolist(),
                        SamplingParams(temperature=0.7 if i % 2 else 0.0,
                                       seed=40 + i, max_tokens=9 + 3 * i,
                                       ignore_eos=True)) for i in range(6)]

    free = EngineCore(EngineConfig(**kw))
    want = free.generate(reqs())
    assert len(free._graphs.graphs) > 2 and free._graphs.evictions == 0
    if cap == "keys":
        monkeypatch.setattr(E, "CUDA_GRAPH_MAX_KEYS", 2)
    capped = EngineCore(EngineConfig(**kw), params=free.params,
                        draft_params=free.draft_params)
    if cap == "pool":
        capped._graphs.max_pool_bytes = 1 << 20
    assert capped.generate(reqs()) == want
    graphs = capped._graphs
    assert graphs.evictions > 0 and graphs.replays == capped._dispatch_count
    if cap == "keys":
        assert len(graphs.graphs) <= 2 and graphs.pool_resets == 0
    else:
        assert graphs.pool_resets > 0


def test_server_answers_with_the_direct_engines_tokens(dev):
    """The port's OpenAI server over a 2-layer deepseek-v3-bench in 32-step
    async blocks (the decode graph captured on the server's engine
    thread) answers one greedy token-id request, streamed (the ids ride
    in each chunk's ``llmd`` meta), with the direct engine's tokens, and
    its /metrics counts the request."""
    import asyncio
    import json
    import threading
    import urllib.request

    from llm_d_tpu_torch.server.openai import ModelServer
    from llm_d_tpu_torch.utils.metrics import parse_prometheus_text
    from llm_d_tpu_torch.utils.tokenizer import ByteTokenizer

    K = 32
    direct = _bench_2layer_engine(dev, num_scheduler_steps=K,
                                  async_scheduling=True)
    served = _bench_2layer_engine(dev, num_scheduler_steps=K,
                                  async_scheduling=True, params=direct.params)
    prompt = torch.randint(1, 32768, (100,),
                           generator=torch.Generator().manual_seed(9)).tolist()
    want = direct.generate([Request("d", prompt, SamplingParams(
        temperature=0.0, max_tokens=1 + K, ignore_eos=True))])["d"]

    server = ModelServer(served, ByteTokenizer(), "m")
    app = server.build_app()
    loop = asyncio.new_event_loop()
    box = {}
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        box["port"] = loop.run_until_complete(app.start("127.0.0.1", 0))
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(timeout=120)
    url = f"http://127.0.0.1:{box['port']}"
    try:
        body = dict(prompt=prompt, max_tokens=1 + K, temperature=0.0,
                    ignore_eos=True, stream=True)
        req = urllib.request.Request(
            url + "/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        tokens, done = [], False
        with urllib.request.urlopen(req, timeout=600) as r:
            for line in r:
                if line.strip() == b"data: [DONE]":
                    done = True
                elif line.startswith(b"data: "):
                    tokens += json.loads(line[6:])["llmd"]["tok"]
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            m = parse_prometheus_text(r.read().decode())
    finally:
        asyncio.run_coroutine_threadsafe(app.close(), loop).result(120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert done and tokens == want
    assert server.async_engine.dead is None
    assert served._graphs.replays == 1
    lab = '{model_name="deepseek-v3-bench"}'
    assert m["vllm:generation_tokens_total" + lab] == 1 + K
    assert m['vllm:request_success_total{finished_reason="length",'
             'model_name="deepseek-v3-bench"}'] == 1
    assert m["vllm:time_to_first_token_seconds_count" + lab] == 1
    assert m["llmd_tpu:engine_steps_total" + lab] == 1 + K
    assert m["llmd_tpu:engine_dispatch_total" + lab] == 2


def test_eplb_migration_stages_on_a_side_stream_and_flips_in_place(dev):
    """The EPLB controller at ep = 4 on the 2-layer bench engine's int8
    experts: a skewed trace plans a migration, each tick stages its moves
    on the controller's side stream (never waiting on the host), and the
    flip writes the serving tensors in place: every ``data_ptr()`` is
    unchanged, the physical ``_q``/``_s`` planes equal the logical ones
    gathered by the final plans bit for bit, the tables are the plans'
    stacked tables, and kernel C through the new table gives the logical
    launch's output."""
    import time
    from llm_d_tpu_torch.parallel.eplb import (EplbConfig, EplbController,
                                               _expert_major_keys)
    eng = _bench_2layer_engine(dev, num_blocks=16)
    logical = {k: v.clone() for k, v in eng.params["moe_layers"].items()}
    ctrl = EplbController(64, 4, EplbConfig.from_dict(dict(
        window_size=100, step_interval=4, imbalance_threshold=1.0,
        move_budget=16)))
    params = ctrl.install(eng.params)
    ml = params["moe_layers"]
    assert ml["w_gate_q"].shape[1] == 68
    ptrs = {k: v.data_ptr() for k, v in ml.items()}
    p = torch.arange(1, 65, dtype=torch.float64) ** -1.2
    ids = torch.multinomial(p / p.sum(), 512 * 8, replacement=True,
                            generator=torch.Generator().manual_seed(0))
    params = ctrl.on_step(ids.reshape(1, 512, 8).numpy(), 4, params)
    assert ctrl.migrating and ctrl._migration.total_moves > 16
    step = 5
    t0 = time.monotonic()
    while ctrl.migrating and time.monotonic() - t0 < 30:
        params = ctrl.on_step(None, step, params)
        step += 1
    assert not ctrl.migrating and ctrl.num_rebalances == 1
    assert ctrl._side is not None and ctrl.migrated_bytes > 0
    torch.cuda.synchronize()
    assert {k: v.data_ptr() for k, v in ml.items()} == ptrs
    phys = torch.as_tensor(ctrl.plans[0].phys_to_logical, device=dev).long()
    for name in _expert_major_keys(ml):
        assert torch.equal(ml[name], logical[name][:, phys]), name
    rt, nr = ctrl._stacked_tables(1)
    assert torch.equal(ml["replica_table"].cpu(), torch.from_numpy(rt))
    assert torch.equal(ml["num_replicas"].cpu(), torch.from_numpy(nr))
    g = _gen(3, dev)
    x = torch.randn((16, 2048), generator=g, device=dev).bfloat16()
    weights, idx = M.route(torch.randn((16, 64), generator=g, device=dev),
                           eng.model_config)
    qk = ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s", "w_down_q",
          "w_down_s")
    want = M._dense_int8_kernel_path(
        x, weights, idx, dict({k: logical[k] for k in qk}, layer=0))
    got = M._dense_int8_kernel_path(
        x, weights, M.to_physical_experts(idx, ml["replica_table"][0],
                                          ml["num_replicas"][0]),
        dict({k: ml[k] for k in qk}, layer=0))
    assert _scaled_err(got.float(), want.float()) <= 1e-2


@pytest.mark.parametrize("N", [0, 2])
def test_eplb_routed_ids_in_graph_replays_equal_the_eager_body(dev, N):
    """EPLB on the 2-layer bench engine (one card: the identity table):
    8-step decode blocks (N = 0) or spec rounds in N = 2 dispatches write
    their routed ids into a static output of their graph; a replay on the
    same inputs and cache equals the eager body, the ids included, and
    the tokens equal the engine's with EPLB off, whose tracker saw every
    real token's routing."""
    from llm_d_tpu_torch.engine.cuda_graph import replay_equals_eager
    over = (dict(num_scheduler_steps=8) if N == 0 else
            dict(spec_k=4, spec_fixed_accept=0.7, num_scheduler_steps=N))
    off = _bench_2layer_engine(dev, **over)
    eng = _bench_2layer_engine(dev, params=off.params, enable_eplb=True,
                               draft_params=off.draft_params, **over)
    reqs = _block_requests(12, 8, False, seed=5 + N)
    want = off.generate(_block_requests(12, 8, False, seed=5 + N))
    assert eng.generate(reqs) == want
    assert eng.eplb.tracker.load.sum() >= 8 * 12
    assert eng.eplb.num_rebalances == 0
    for key, g in eng._graphs.graphs.items():
        assert "routed" in g.outputs
        if N == 0:
            res = replay_equals_eager(g, eng.kv_cache, lambda out: (
                eng._ms_body(g.inputs, g.inputs["keys"], out["ids"],
                             key[1], out["routed"])))
        else:
            res = replay_equals_eager(g, eng.kv_cache, lambda out: (
                eng._fms_body(g.inputs, out, N, key[7], key[8], key[9])),
                trash_rows=eng.config.block_size)
        assert res == dict(outputs_equal=True, cache_equal=True), key


@pytest.mark.parametrize("stub", ["attn", "moe_ffn", "shared_expert"])
def test_stubbed_engine_captures_its_own_blocks(dev, stub):
    """A stubbed engine (the attribution sweep's) serves 8-step decode
    blocks through graphs of its own stubbed body: the replay equals the
    eager body, and the ``attn`` stub writes no cache row."""
    from llm_d_tpu_torch.engine.cuda_graph import replay_equals_eager
    eng = _bench_2layer_engine(dev, num_scheduler_steps=8,
                               stub_components=(stub,))
    eng.generate(_block_requests(6, 8, False, seed=9))
    assert eng._graphs.graphs
    for key, g in eng._graphs.graphs.items():
        res = replay_equals_eager(g, eng.kv_cache, lambda out: eng._ms_body(
            g.inputs, g.inputs["keys"], out["ids"], key[1]))
        assert res == dict(outputs_equal=True, cache_equal=True), key
    if stub == "attn":
        assert all(not v.any() for v in eng.kv_cache.values())
