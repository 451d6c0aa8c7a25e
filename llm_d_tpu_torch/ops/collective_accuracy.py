"""Accuracy harness for the int8 EP collectives (port of
``llm_d_tpu.ops.collective_accuracy``).

Quantizing the MoE exchange wire (``parallel/quant_collectives.py``)
injects error at two points with different amplification paths, each
measured and bounded apart before ``LLMD_COLLECTIVE_DTYPE=auto`` may
resolve to int8:

  1. **dispatch** (rows quantized before the expert FFN): the error passes
     through three GEMMs and the SwiGLU nonlinearity, into every expert
     output the row produces;
  2. **combine** (expert outputs quantized on the return wire): the error
     enters after the FFN and is only scaled by the combine weights
     (applied at the origin after dequantization).

Both are measured in isolation (and end to end) against the bf16
dispatch / f32 combine reference on real routed traces: the rows and
routing an engine's own forward produces for token streams it served
(``collect_moe_trace``), not a synthetic proxy.  The arithmetic is numpy
f32, as in the JAX harness, so the reports equal JAX's on the same trace.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# Relative-RMS bounds for the int8 wire with one symmetric f32 scale per
# row (per-element error <= amax/254 of the row).
DISPATCH_REL_BOUND = 2e-2
COMBINE_REL_BOUND = 2e-2


def harvest_routed_trace(engine, token_streams: Sequence[Sequence[int]],
                         max_tokens: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
    """Real MoE dispatch operands from an engine's traffic (one device):
    ``token_streams`` (prompt + generated ids) replay through the model as
    one prefill batch (reference attention, a scratch bf16 cache) with
    ``collect_moe_trace``.  Returns ``{"x": [Lm, T, H] f32, "weights":
    [Lm, T, k] f32, "idx": [Lm, T, k] i32}``."""
    from llm_d_tpu_torch.models import moe as moe_model
    c = engine.model_config
    bs = engine.config.block_size
    streams = [list(ts)[:c.max_model_len] for ts in token_streams if ts]
    if max_tokens is not None:
        kept, total = [], 0
        for ts in streams:
            if total >= max_tokens:
                break
            kept.append(ts[:max_tokens - total])
            total += len(kept[-1])
        streams = kept
    assert streams, "no token streams to replay"
    lens = [len(ts) for ts in streams]
    T, S, Q = sum(lens), len(streams), max(lens)
    B = max(-(-n // bs) for n in lens)
    batch = dict(
        token_ids=np.zeros(T, np.int32), positions=np.zeros(T, np.int32),
        token_seq_ids=np.zeros(T, np.int32),
        token_qpos=np.zeros(T, np.int32),
        slot_mapping=np.zeros(T, np.int32),
        block_tables=np.zeros((S, B), np.int32),
        seq_lens=np.asarray(lens, np.int32),
        sample_idx=np.zeros(S, np.int32),
        qtok_idx=np.full((S, Q), T, np.int32))
    t, next_block = 0, 1                         # block 0 = trash block
    for s, ts in enumerate(streams):
        n = len(ts)
        pos = np.arange(n)
        blocks = np.arange(next_block, next_block + -(-n // bs))
        next_block += len(blocks)
        batch["token_ids"][t:t + n] = ts
        batch["positions"][t:t + n] = pos
        batch["token_seq_ids"][t:t + n] = s
        batch["token_qpos"][t:t + n] = pos
        batch["slot_mapping"][t:t + n] = blocks[pos // bs] * bs + pos % bs
        batch["block_tables"][s, :len(blocks)] = blocks
        batch["sample_idx"][s] = t + n - 1
        batch["qtok_idx"][s, :n] = np.arange(t, t + n)
        t += n
    dev = engine.device
    kv = {k: torch.zeros((c.num_layers, next_block * bs, w),
                         dtype=torch.bfloat16, device=dev)
          for k, w in moe_model.kv_cache_layout(c).items()}
    _, trace = moe_model.forward(
        engine.params, kv,
        {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, c,
        bs, attn_backend="reference", collect_moe_trace=True)
    return {"x": trace["x"].float().cpu().numpy(),
            "weights": trace["weights"].float().cpu().numpy(),
            "idx": trace["idx"].to(torch.int32).cpu().numpy()}


def _rel_rms(err: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean(err ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-12))


def _routed_ffn(xs: np.ndarray, e_flat: np.ndarray, w_gate: np.ndarray,
                w_up: np.ndarray, w_down: np.ndarray) -> np.ndarray:
    """f32 SwiGLU expert FFN per flat (token, choice) slot."""
    g = np.einsum("sh,shi->si", xs, w_gate[e_flat])
    u = np.einsum("sh,shi->si", xs, w_up[e_flat])
    a = g / (1.0 + np.exp(-g)) * u
    return np.einsum("si,sih->sh", a, w_down[e_flat])


def _f32(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def _quant_round_trip(rows: np.ndarray) -> np.ndarray:
    """The int8 wire's per-row round trip with the JAX harness's own
    arithmetic: it runs op by op, where ``/ 127.0`` is a true division
    (the wire under jit, and ``quantize_rows``, multiply by the
    reciprocal; the two differ in a few scales' last bit)."""
    rows = np.asarray(rows, np.float32)
    amax = np.abs(rows).max(axis=-1, keepdims=True)
    scale = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
    q = np.clip(np.round(rows / scale), -127, 127)
    return (q * scale).astype(np.float32)


def collective_error_report(x: np.ndarray, weights: np.ndarray,
                            idx: np.ndarray, w_gate, w_up, w_down) -> Dict:
    """Per-collective int8-vs-exact error over real routed rows ``x [T,
    H]`` with their combine weights and expert ids ``[T, k]`` and the
    layer's experts ``[E, H, I]`` / ``[E, I, H]``.  Reference: bf16
    dispatch rows, f32 expert FFN, f32 combine return; ``dispatch``
    quantizes the outbound rows only, ``combine`` the returned expert
    outputs only, ``end_to_end`` both."""
    T, k = idx.shape
    e_flat = idx.reshape(-1).astype(np.int64)
    wg, wu, wd = _f32(w_gate), _f32(w_up), _f32(w_down)
    rows_bf = torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()
    rows_q8 = _quant_round_trip(np.asarray(x, np.float32))
    tok = np.repeat(np.arange(T), k)

    def combine(y_slots: np.ndarray) -> np.ndarray:
        return (y_slots.reshape(T, k, -1) * weights[..., None]).sum(axis=1)

    y_ref = _routed_ffn(rows_bf[tok], e_flat, wg, wu, wd)
    y_disp = _routed_ffn(rows_q8[tok], e_flat, wg, wu, wd)
    out_ref = combine(y_ref)
    out_disp = combine(y_disp)
    out_comb = combine(_quant_round_trip(y_ref))
    out_e2e = combine(_quant_round_trip(y_disp))
    report = {
        "rows": int(T),
        "dispatch": {
            "max_abs": float(np.abs(out_disp - out_ref).max()),
            "rel_rms": _rel_rms(out_disp - out_ref, out_ref),
            "bound_rel_rms": DISPATCH_REL_BOUND,
        },
        "combine": {
            "max_abs": float(np.abs(out_comb - out_ref).max()),
            "rel_rms": _rel_rms(out_comb - out_ref, out_ref),
            "bound_rel_rms": COMBINE_REL_BOUND,
        },
        "end_to_end": {
            "max_abs": float(np.abs(out_e2e - out_ref).max()),
            "rel_rms": _rel_rms(out_e2e - out_ref, out_ref),
        },
    }
    report["within_bounds"] = bool(
        report["dispatch"]["rel_rms"] <= DISPATCH_REL_BOUND
        and report["combine"]["rel_rms"] <= COMBINE_REL_BOUND)
    return report


def layer_reports(trace: Dict[str, np.ndarray], params: Dict) -> List[Dict]:
    """:func:`collective_error_report` per MoE layer of a harvested trace
    against that layer's experts (``params`` is the engine's
    ``moe_layers``, stacked ``[Lm, E, ...]``; int8 payloads are
    dequantized to bf16 first, the weights serving uses)."""
    from llm_d_tpu_torch.ops.quant import dequantize
    if "w_gate" in params:
        ws = [params[n] for n in ("w_gate", "w_up", "w_down")]
    else:
        ws = [dequantize(params[f"{n}_q"], params[f"{n}_s"], torch.float32)
              for n in ("w_gate", "w_up", "w_down")]
    return [collective_error_report(trace["x"][li], trace["weights"][li],
                                    trace["idx"][li], ws[0][li], ws[1][li],
                                    ws[2][li])
            for li in range(trace["x"].shape[0])]
