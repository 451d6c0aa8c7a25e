"""Accuracy harness for the int8 MLA latent cache: per-absorption bounds
(port of ``llm_d_tpu.ops.mla_accuracy``).

MLA's serving formulation absorbs the two latent up-projections into the
surrounding products, so quantizing the cached latent row changes the
operands of two different dots:

  1. **Score absorption** (W_uk into the queries): the score is one dot of
     the absorbed query ``[q_nope @ W_uk | q_pe]`` against the cached row
     ``[c_kv | k_pe]``; the quantization error enters before the softmax.
  2. **Value absorption** (W_uv on the output): the attended latent (a
     softmax-weighted sum of cached rows) is projected by W_uv; the error
     enters after the softmax, averaged over the context.

The harness measures both terms separately, and end to end, against the
bf16 latent on real rows harvested from a serving engine's cache
(:func:`harvest_latent_rows`): the bounds that justify the int8 latent
(``SCORE_REL_BOUND``, ``VALUE_REL_BOUND``) are a measured property of the
model's latent statistics.  The report's products run in f64 on the rows'
device: the errors it measures are small differences of large sums, so
their summation order must not move them (the card's report equals the
CPU's on the same rows).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from llm_d_tpu_torch.ops import layers as L
from llm_d_tpu_torch.ops.quant import dequantize_kv_block, quantize_kv_block

# Relative-RMS bounds for the int8 latent with one symmetric scale per
# latent row (per-element error <= amax / 254 of the row).
SCORE_REL_BOUND = 2e-2
VALUE_REL_BOUND = 2e-2


def harvest_latent_rows(engine, max_rows: Optional[int] = None
                        ) -> torch.Tensor:
    """Real latent rows from a bf16-latent MLA engine's cache after
    traffic: ``[N, F]`` f32 on the engine's device, every written
    (non-zero) slot row of every layer plane in cache order (the trash
    block 0 and unwritten slots are zero and skipped).  Run requests
    through the engine first."""
    kv = engine.kv_cache["kv"]
    if kv.dtype == torch.int8:
        raise ValueError("harvest_latent_rows reads a bf16 latent; this "
                         "engine caches it in int8")
    rows = kv.float().reshape(-1, kv.shape[-1])
    rows = rows[rows.abs().amax(dim=-1) > 0]
    if max_rows is not None:
        rows = rows[:max_rows]
    return rows


def absorbed_queries(lp: Dict, config, x: torch.Tensor,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The absorbed-query path of ``models/mla.py`` for one layer.

    ``lp`` holds that layer's (unstacked) MLA weights, ``x`` ``[T, Hm]``
    hidden states, ``positions`` ``[T]``.  Returns (q_eff ``[T, H, F]``
    f32, W_uk absorbed and rope applied; w_uv ``[R, H, V]`` f32): the
    operands serving scores with."""
    c = config
    T = x.shape[0]
    H = c.num_heads
    nope, rope = c.qk_nope_head_dim, c.qk_rope_head_dim
    R = c.kv_lora_rank
    if "q_a_proj" in lp:
        cq = L.rms_norm(L.linear(x, lp["q_a_proj"]), lp["q_a_norm"],
                        c.rms_norm_eps)
        q = L.linear(cq, lp["q_b_proj"]).reshape(T, H, nope + rope)
    else:
        q = L.linear(x, lp["q_proj"]).reshape(T, H, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    cos, sin = L.rope_cos_sin(positions, rope, c.rope_theta)
    q_pe = L.apply_rope(q_pe, cos, sin)
    w_kv = lp["kv_b_proj"].reshape(R, H, nope + c.v_head_dim)
    w_uk = w_kv[..., :nope].float()
    w_uv = w_kv[..., nope:].float()
    q_lat = torch.einsum("thn,rhn->thr", q_nope.float(), w_uk)
    return torch.cat([q_lat, q_pe.float()], dim=-1), w_uv


def _rel_rms(err: torch.Tensor, ref: torch.Tensor) -> float:
    return float(err.square().mean().sqrt()
                 / max(float(ref.square().mean().sqrt()), 1e-12))


def absorption_error_report(rows: torch.Tensor, q_eff: torch.Tensor,
                            w_uv: torch.Tensor, kv_lora_rank: int,
                            scale: Optional[float] = None) -> Dict:
    """Per-absorption int8-against-bf16 error over real latent rows.

    ``rows`` ``[N, F]`` (lane padding allowed: pad columns quantize to
    exact zeros), ``q_eff`` ``[T, H, F']`` absorbed queries (F' <= F,
    zero-padded to F), ``w_uv`` ``[R, H, V]``, all on one device.  The N
    rows are one shared context: scores, softmax and the attended latent's
    value projection are computed under the bf16 and the int8 latent, and
    the error is isolated per absorption:

      - ``score``: s_bf16 against s_int8 (before the softmax: W_uk);
      - ``value``: W_uv(p_bf16 @ rows_bf16) against W_uv(p_bf16 @
        rows_int8) (probabilities held: W_uv alone);
      - ``end_to_end``: both at once (what serving computes).

    Returns ``max_abs`` / ``rel_rms`` per term with the bounds, and
    ``within_bounds``."""
    R = kv_lora_rank
    F = rows.shape[-1]
    q = q_eff.double()
    if q.shape[-1] < F:
        q = torch.nn.functional.pad(q, (0, F - q.shape[-1]))
    scale = scale if scale is not None else 1.0
    rows_f = rows.float()
    # The serve dtype and the int8 latent (quantized in f32, as served),
    # then every product in f64.
    rows_bf = rows_f.to(torch.bfloat16).double()
    rq, rs = quantize_kv_block(rows_f, 1, divide=True)
    rows_q8 = dequantize_kv_block(rq, rs, torch.float32).double()
    wv = w_uv.double()

    def attend(rows_for_scores, rows_for_values):
        s = torch.einsum("thf,nf->thn", q * scale, rows_for_scores)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("thn,nr->thr", p, rows_for_values[:, :R])
        return s, torch.einsum("thr,rhv->thv", o, wv)

    s_bf, v_bf = attend(rows_bf, rows_bf)
    s_q8, v_q8 = attend(rows_q8, rows_q8)
    _, v_mix = attend(rows_bf, rows_q8)

    report = {
        "rows": int(rows.shape[0]),
        "score": {
            "max_abs": float((s_q8 - s_bf).abs().max()),
            "rel_rms": _rel_rms(s_q8 - s_bf, s_bf),
            "bound_rel_rms": SCORE_REL_BOUND,
        },
        "value": {
            "max_abs": float((v_mix - v_bf).abs().max()),
            "rel_rms": _rel_rms(v_mix - v_bf, v_bf),
            "bound_rel_rms": VALUE_REL_BOUND,
        },
        "end_to_end": {
            "max_abs": float((v_q8 - v_bf).abs().max()),
            "rel_rms": _rel_rms(v_q8 - v_bf, v_bf),
        },
    }
    report["within_bounds"] = bool(
        report["score"]["rel_rms"] <= SCORE_REL_BOUND
        and report["value"]["rel_rms"] <= VALUE_REL_BOUND)
    return report
