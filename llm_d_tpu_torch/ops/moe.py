"""MoE ops: routing, the expert FFN dispatch, the int8 kernel glue and
expert parallelism over a mesh (port of ``llm_d_tpu.ops.moe``).

Int8 experts on the card run the hand-written kernels by token count, with
the JAX package's knobs read at call time (malformed values fall back to
the defaults):

  T <= LLMD_MOE_DENSE_KERNEL_MAX_T (64)     kernel C (all experts)
  T <= LLMD_MOE_GROUPED_MIN_T (512)         kernel D (routed rows only)
  above, LLMD_MOE_PREFILL_KERNEL=grouped    kernel F (sorted, padded rows)
  above, otherwise                          kernel E (chunk-streamed)

Everything else (CPU tensors, bf16 experts) dequantizes and runs the
plain dense / grouped paths, as the JAX package does off the TPU.

On a mesh (``expert_ffn(..., mesh=)``) the experts shard over every rank
and tokens travel to their experts' ranks by all-to-all (``a2a``) or
every rank runs its experts on all tokens and the outputs are summed
(``psum``); int8 experts run kernel E on the received rows on every
backend (its plain version on the CPU).  On a ``(dp, tp)`` mesh ``x`` is
the rank's dp shard's ``[T_l, H]`` (the same on its tp ranks): each rank
dispatches its ``T_l / tp`` slice over the EP group of all ``dp * tp``
ranks, as the JAX package's stacked ``[dp * T_l]`` rows split over EP,
and the shard's rows come back by an all-gather over its tp group.
DBO (``dbo_min_tokens``, the engine's ``enable_dbo``): from the
threshold on the a2a exchange runs in at least two chunks a rank, the
next chunk's exchange issued before this chunk's experts run
(``expert_ffn_a2a``).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from llm_d_tpu_torch.models.config import ModelConfig
from llm_d_tpu_torch.ops import moe_int8, moe_routed, moe_routed_stream
from llm_d_tpu_torch.ops.layers import silu
from llm_d_tpu_torch.ops.quant import dequantize
from llm_d_tpu_torch.ops.sampling import top_k_stable
from llm_d_tpu_torch.utils.config import env_int

# Below this many tokens the all-experts dense path serves the plain path.
DENSE_DISPATCH_MAX_T = 512
# Int8 kernel regimes (the JAX package's crossovers, kept until the H100
# crossovers are measured).
DENSE_INT8_MAX_T = 64
GROUPED_INT8_MIN_T = 512
# Token-chunk height of the streamed kernel's metadata
# (LLMD_MOE_PREFILL_CHUNK_T).
PREFILL_CHUNK_T = 512


def route_scores(router_logits: torch.Tensor, config: ModelConfig,
                 e_bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate scores, selection scores) [T, E] f32: ``sigmoid`` scoring
    adds the bias for selection only."""
    logits = router_logits.float()
    if config.scoring_func == "sigmoid":
        # 1 / (1 + exp(-x)) op by op, as jax.nn.sigmoid lowers.
        scores = 1.0 / (1.0 + torch.exp(-logits))
        choice = scores + (e_bias.float()[None, :]
                           if e_bias is not None else 0.0)
    else:
        scores = torch.softmax(logits, dim=-1)
        choice = scores
    return scores, choice


def gate_weights(scores: torch.Tensor, idx: torch.Tensor,
                 config: ModelConfig) -> torch.Tensor:
    """Combine weights [T, k] f32 of the chosen experts ``idx`` from the
    gate scores (renormalized and scaled as the config says)."""
    weights = torch.gather(scores, 1, idx.long())
    if config.moe_renormalize:
        weights = weights / torch.clamp_min(
            weights.sum(-1, keepdim=True), 1e-20)
    return (weights * config.routed_scaling_factor).float()


def route(router_logits: torch.Tensor, config: ModelConfig,
          e_bias: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert selection with optional DeepSeek group-limited routing:
    (weights [T, k] f32, idx [T, k] int32).  Ties go to the lower expert
    id, as with ``jax.lax.top_k``."""
    c = config
    T, E = router_logits.shape
    k = c.num_experts_per_tok
    scores, choice = route_scores(router_logits, c, e_bias)
    if c.n_group > 0:
        g = c.n_group
        gs = choice.reshape(T, g, E // g)
        top2 = top_k_stable(gs, min(2, E // g))[0].sum(-1)       # [T, g]
        _, keep = top_k_stable(top2, c.topk_group)
        mask = torch.zeros((T, g), dtype=torch.bool,
                           device=router_logits.device)
        mask.scatter_(1, keep, True)
        choice = torch.where(mask.repeat_interleave(E // g, dim=1), choice,
                             torch.full_like(choice, float("-inf")))
    _, idx = top_k_stable(choice, k)
    return gate_weights(scores, idx, c), idx.to(torch.int32)


def to_physical_experts(idx: torch.Tensor, replica_table: torch.Tensor,
                        num_replicas: torch.Tensor,
                        phase: int = 0, row0: int = 0) -> torch.Tensor:
    """EPLB: map routed logical experts ``idx [T, k]`` to physical replica
    slots ``[T, k]`` (int32) through ``replica_table [E, max_r]`` and
    ``num_replicas [E]``.  The replica is round-robin over the (token,
    slot) index plus the layer's ``phase``, as in the JAX package:
    replicas hold identical weights, so the choice never changes the
    output.  ``row0`` is the first row's index in the step's rows (a dp
    shard's offset in the JAX package's stacked rows).  Plain tensor ops
    (no host read), so a captured body may call it."""
    T, k = idx.shape
    il = idx.long()
    slot = torch.arange(row0 * k, (row0 + T) * k, dtype=torch.int32,
                        device=idx.device).reshape(T, k) + phase
    r = slot % num_replicas[il]
    return replica_table[il, r.long()].to(torch.int32)


def _combine_matrix(T: int, E: int, idx: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """[T, E] f32 combine weights (0 for unrouted pairs; duplicate routes
    accumulate)."""
    comb = torch.zeros((T, E), dtype=torch.float32, device=weights.device)
    return comb.scatter_add_(1, idx.long(), weights.float())


def _excl_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the last dim."""
    return torch.cumsum(v, -1).to(v.dtype) - v


def _stable_argsort_bounded(keys: torch.Tensor, bound: int):
    """Stable argsort of integer keys in [0, bound) by counting, over the
    last dim of ``keys [..., S]``: returns (order, dest, counts) -- the
    argsort, its inverse permutation and the per-key histogram."""
    S = keys.shape[-1]
    dev = keys.device
    kl = keys.long()
    one_hot = kl[..., None] == torch.arange(bound, device=dev)
    cum = torch.cumsum(one_hot.to(torch.int32), dim=-2)        # [..., S, b]
    rank = torch.gather(cum, -1, kl[..., None])[..., 0] - 1
    counts = cum[..., -1, :]
    dest = torch.gather(_excl_cumsum(counts), -1, kl) + rank
    order = torch.zeros(kl.shape, dtype=torch.int32, device=dev)
    order.scatter_(-1, dest, torch.arange(
        S, dtype=torch.int32, device=dev).expand(kl.shape))
    return order, dest.to(torch.int32), counts


def _sorted_tile_layout(flat: torch.Tensor, weights_flat: torch.Tensor,
                        k: int, E: int, rt: int):
    """Counting-sort tile layout over the last dim of ``flat [..., S]``
    (leading dims are independent layouts, e.g. the streamed kernel's
    chunks): rows sorted by expert, each expert's run padded to a
    multiple of ``rt``, one expert per tile.  Returns ``(order, inv,
    tok_s, slot, wslot_pad, tile_expert, num_tiles)`` with the JAX
    package's definitions (``S_pad = ceil(S/rt)*rt + E*rt``; inactive
    trailing tiles repeat the last active tile's expert)."""
    S = flat.shape[-1]
    dev = flat.device
    order, inv, counts = _stable_argsort_bounded(flat, E)
    ol = order.long()
    eid_s = torch.gather(flat.long(), -1, ol)
    tok_s = (order // k).to(torch.int32)
    padded = (counts + rt - 1) // rt * rt
    offs = _excl_cumsum(padded)
    rank = torch.arange(S, dtype=torch.int32, device=dev) \
        - torch.gather(_excl_cumsum(counts), -1, eid_s)
    slot = (torch.gather(offs, -1, eid_s) + rank).to(torch.int32)
    S_pad = -(-S // rt) * rt + E * rt
    NT = S_pad // rt
    wslot_pad = torch.zeros(flat.shape[:-1] + (S_pad,), dtype=torch.float32,
                            device=dev)
    wslot_pad.scatter_(-1, slot.long(),
                       torch.gather(weights_flat.float(), -1, ol))
    num_tiles = (padded.sum(-1) // rt).to(torch.int32)
    bounds = torch.cumsum(padded, -1).to(torch.int64).contiguous()
    starts = torch.minimum(torch.arange(NT, dtype=torch.int64, device=dev),
                           num_tiles[..., None].long() - 1) * rt
    tile_expert = torch.clamp_max(
        torch.searchsorted(bounds, starts.contiguous(), right=True),
        E - 1).to(torch.int32)
    return order, inv, tok_s, slot, wslot_pad, tile_expert, num_tiles


def _routed_row_tile(row_tile: Optional[int], S: int, E: int) -> int:
    """An explicit tile, else ``LLMD_MOE_ROUTED_ROW_TILE``, else 32 rows
    while the mean rows per expert stay under 96, then 64."""
    if row_tile is not None:
        return row_tile
    return env_int("LLMD_MOE_ROUTED_ROW_TILE", 0) \
        or (32 if S < E * 96 else 64)


def _routed_int8_kernel_path(x, weights, idx, quant: dict,
                             row_tile: Optional[int] = None):
    """Metadata-only glue for kernel D: the counting sort plus int32 slot
    arithmetic; activation rows move inside the kernel."""
    T, H = x.shape
    k = idx.shape[1]
    E = quant["w_gate_q"].shape[1]
    S = T * k
    rt = _routed_row_tile(row_tile, S, E)
    order, inv, tok_s, slot, wslot_pad, tile_expert, num_tiles = \
        _sorted_tile_layout(idx.reshape(S), weights.reshape(S), k, E, rt)
    tok_pad = torch.zeros(wslot_pad.shape[0], dtype=torch.int32,
                          device=x.device)
    tok_pad[slot.long()] = tok_s
    pos = slot[inv.long()].reshape(T, k).contiguous()
    out = moe_routed.routed_moe_int8(
        x.to(torch.bfloat16).contiguous(), tok_pad, wslot_pad, tile_expert,
        num_tiles.reshape(1), pos, quant["layer"],
        quant["w_gate_q"], quant["w_gate_s"], quant["w_up_q"],
        quant["w_up_s"], quant["w_down_q"], quant["w_down_s"], row_tile=rt)
    return out.to(x.dtype)


def _streamed_int8_kernel_path(x, weights, idx, quant: dict,
                               chunk_t: Optional[int] = None,
                               row_tile: Optional[int] = None,
                               out_dtype=None):
    """Metadata-only glue for kernel E: one counting sort per token-order
    chunk of ``chunk_t`` rows (batched over the chunks), flattened to the
    TPU kernel's ``[C * S_pad_c]`` / ``[C * NT_c]`` / ``[C]`` tables, plus
    each (token, choice)'s global padded slot for the combine."""
    T, H = x.shape
    k = idx.shape[1]
    E = quant["w_gate_q"].shape[1]
    if chunk_t is None:
        chunk_t = env_int("LLMD_MOE_PREFILL_CHUNK_T", PREFILL_CHUNK_T)
    # Multiples of 16 rows, never taller than the (aligned) batch.
    chunk_t = max(16, min(-(-chunk_t // 16) * 16, -(-T // 16) * 16))
    C = -(-T // chunk_t)
    Tp = C * chunk_t
    S_c = chunk_t * k
    rt = _routed_row_tile(row_tile, S_c, E)
    x_p = x.to(torch.bfloat16)
    if Tp != T:
        # Pad tokens route to expert 0 with zero combine weight (and zero
        # rows): they take slots in the last chunk but add nothing.
        pad = Tp - T
        x_p = torch.nn.functional.pad(x_p, (0, 0, 0, pad))
        idx = torch.nn.functional.pad(idx, (0, 0, 0, pad))
        weights = torch.nn.functional.pad(weights, (0, 0, 0, pad))
    _, inv, tok_s, slot, wslot_pad, tile_expert, num_tiles = \
        _sorted_tile_layout(idx.reshape(C, S_c), weights.reshape(C, S_c),
                            k, E, rt)
    S_pad_c = wslot_pad.shape[1]
    tok_pad = torch.zeros((C, S_pad_c), dtype=torch.int32, device=x.device)
    tok_pad.scatter_(1, slot.long(), tok_s)
    chunk_base = torch.arange(C, dtype=torch.int32,
                              device=x.device)[:, None] * S_pad_c
    pos = (torch.gather(slot, 1, inv.long()) + chunk_base).reshape(Tp, k)
    out = moe_routed_stream.streamed_moe_int8(
        x_p.contiguous(), tok_pad.reshape(-1), wslot_pad.reshape(-1),
        tile_expert.reshape(-1), num_tiles.contiguous(), pos.contiguous(),
        quant["layer"], quant["w_gate_q"], quant["w_gate_s"],
        quant["w_up_q"], quant["w_up_s"], quant["w_down_q"],
        quant["w_down_s"], chunk_t=chunk_t, row_tile=rt)
    return out[:T].to(out_dtype or x.dtype)


def _grouped_int8_kernel_path(x, weights, idx, quant: dict,
                              row_tile: Optional[int] = None):
    """Sort/pad glue for kernel F: rows sorted by expert, each expert's
    run padded to a ``row_tile`` multiple, gathered (never scattered)
    from ``x`` plus a trailing zero row; the kernel's combine-weighted
    bf16 rows come back to tokens through :func:`_unsort_combine`."""
    T, H = x.shape
    k = idx.shape[1]
    E = quant["w_gate_q"].shape[1]
    S = T * k
    if row_tile is None:
        rt = 128 if S < E * 256 else 256
    else:
        rt = row_tile
    order, sort_inv, tok_s, dest, wslot_pad, tile_expert, num_tiles = \
        _sorted_tile_layout(idx.reshape(S), weights.reshape(S), k, E, rt)
    S_pad = wslot_pad.shape[0]
    src = torch.full((S_pad,), T, dtype=torch.int32, device=x.device)
    src[dest.long()] = tok_s
    x_ext = torch.cat([x.to(torch.bfloat16),
                       x.new_zeros((1, H), dtype=torch.bfloat16)])
    x_pad = x_ext[src.long()]
    y_pad = moe_int8.grouped_moe_int8(
        x_pad, wslot_pad, tile_expert, num_tiles.reshape(1),
        quant["layer"], quant["w_gate_q"], quant["w_gate_s"],
        quant["w_up_q"], quant["w_up_s"], quant["w_down_q"],
        quant["w_down_s"], row_tile=rt)
    return _unsort_combine(y_pad, order, T, k, dest=dest,
                           inv=sort_inv).to(x.dtype)


def _dense_int8_kernel_path(x, weights, idx, quant: dict):
    """Glue for kernel C: the combine-weight matrix plus the stacked
    call."""
    T = x.shape[0]
    E = quant["w_gate_q"].shape[1]
    comb = _combine_matrix(T, E, idx, weights)
    out = moe_int8.dense_moe_int8(
        x.to(torch.bfloat16).contiguous(), comb, quant["layer"],
        quant["w_gate_q"], quant["w_gate_s"], quant["w_up_q"],
        quant["w_up_s"], quant["w_down_q"], quant["w_down_s"])
    return out.to(x.dtype)


def _dequant_layer(quant: dict):
    """Dequantized (w_gate, w_up, w_down) of the quant dict's layer plane,
    for the plain paths."""
    li = quant.get("layer")
    trip = []
    for name in ("w_gate", "w_up", "w_down"):
        q, s = quant[f"{name}_q"], quant[f"{name}_s"]
        if li is not None:
            q, s = q[li], s[li]
        trip.append(dequantize(q, s))
    return tuple(trip)


def _dense_expert_ffn(x, weights, idx, w_gate, w_up, w_down) -> torch.Tensor:
    """All experts on all tokens with the combine weight folded into the
    activations: [T, H] f32."""
    T = x.shape[0]
    E = w_gate.shape[0]
    comb = _combine_matrix(T, E, idx, weights)
    xf = x.float()
    h = torch.einsum("th,ehi->eti", xf, w_gate.float())
    u = torch.einsum("th,ehi->eti", xf, w_up.float())
    a = (silu(h) * u * comb.T[:, :, None]).to(x.dtype)
    return torch.einsum("eti,eih->th", a.float(), w_down.float())


def _swiglu_grouped(xs, w_gate, w_up, w_down, group_sizes):
    """SwiGLU over row groups (rows sorted by expert; group g uses expert
    g's weights): [S, H] f32."""
    out = torch.zeros((xs.shape[0], w_down.shape[-1]), dtype=torch.float32,
                      device=xs.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        if n:
            xg = xs[start:start + n].float()
            h = xg @ w_gate[g].float()
            u = xg @ w_up[g].float()
            a = (silu(h) * u).to(xs.dtype)
            out[start:start + n] = a.float() @ w_down[g].float()
        start += n
    return out


def _unsort_combine(y: torch.Tensor, order: torch.Tensor, T: int, k: int,
                    dest: Optional[torch.Tensor] = None,
                    inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sorted, combine-weighted rows back to tokens, summing each token's
    k rows in f32.  ``y`` is in ``order``'s sorted layout, or, with
    ``dest``, in a padded layout where sorted row ``s`` lives at
    ``dest[s]`` (kernel F's layout)."""
    S = T * k
    if inv is None:
        inv = torch.zeros(S, dtype=torch.long, device=y.device)
        inv[order.long()] = torch.arange(S, device=y.device)
    src = inv.long() if dest is None else dest.long()[inv.long()]
    contrib = y[src].float()
    return contrib.reshape(T, k, -1).sum(dim=1)


def _local_expert_ffn(x, weights, idx, w_gate, w_up, w_down,
                      e0: int = 0) -> torch.Tensor:
    """Sorted grouped GEMM over the experts [e0, e0 + E_loc); other slots
    go to a trailing zero-weight trash group."""
    T, H = x.shape
    k = idx.shape[1]
    E_loc = w_gate.shape[0]
    S = T * k
    lid = idx.reshape(S).long() - e0
    is_local = (lid >= 0) & (lid < E_loc)
    sort_key = torch.where(is_local, lid, torch.full_like(lid, E_loc))
    order, inv, key_counts = _stable_argsort_bounded(sort_key, E_loc + 1)
    ol = order.long()
    xs = x[ol // k]
    y = _swiglu_grouped(xs, w_gate, w_up, w_down, key_counts[:E_loc])
    wslot = (weights.reshape(S).float()[ol]
             * is_local[ol].float())[:, None]
    return _unsort_combine(y * wslot, order, T, k, inv=inv)


def int8_kernel_regime(T: int) -> str:
    """Which int8 kernel serves a step of ``T`` tokens: "dense" (C),
    "routed" (D), "grouped" (F) or "streamed" (E), by the JAX package's
    rules and knobs, read at call time."""
    if T <= env_int("LLMD_MOE_DENSE_KERNEL_MAX_T", DENSE_INT8_MAX_T):
        return "dense"
    if T <= env_int("LLMD_MOE_GROUPED_MIN_T", GROUPED_INT8_MIN_T):
        return "routed"
    if os.environ.get("LLMD_MOE_PREFILL_KERNEL", "streamed") == "grouped":
        return "grouped"
    return "streamed"


def expert_ffn(x: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor,
               w_gate: Optional[torch.Tensor], w_up: Optional[torch.Tensor],
               w_down: Optional[torch.Tensor],
               quant: Optional[dict] = None, mesh=None,
               dispatch: str = "auto",
               collective_dtype: Optional[str] = None,
               dbo_min_tokens: Optional[int] = None) -> torch.Tensor:
    """Routed-expert FFN: [T, H] in x.dtype, on every rank of ``mesh``.

    One device: ``quant`` carries stacked int8 payloads ``{w_gate_q,
    w_gate_s, ...}`` plus the MoE ``layer`` plane; on the card they go
    straight to kernels C-F (:func:`int8_kernel_regime`) without a
    dequantized copy.

    On a mesh the expert weights (or payloads) are this rank's shard of
    the expert dim, and ``dispatch`` picks the exchange as the JAX
    package does: ``a2a`` (the default where ``T`` and ``E`` divide by
    the EP degree; :func:`expert_ffn_a2a`) or ``psum`` (every rank runs
    its experts on all tokens, partial outputs all-reduced, quantized
    under the int8 wire); ``dense`` / ``ragged`` are one-device modes and
    raise.  ``collective_dtype`` is the wire (None resolves
    ``LLMD_COLLECTIVE_DTYPE``); ``dbo_min_tokens`` is the a2a exchange's
    DBO threshold (:func:`expert_ffn_a2a`; one device has no exchange to
    overlap and ignores it)."""
    T = x.shape[0]
    if mesh is not None and mesh.size > 1:
        return _expert_ffn_mesh(x, weights, idx, w_gate, w_up, w_down,
                                quant, mesh, dispatch, collective_dtype,
                                dbo_min_tokens)
    if quant is not None and x.is_cuda:
        path = {"dense": _dense_int8_kernel_path,
                "routed": _routed_int8_kernel_path,
                "grouped": _grouped_int8_kernel_path,
                "streamed": _streamed_int8_kernel_path}[int8_kernel_regime(T)]
        return path(x, weights, idx, quant)
    if quant is not None:
        w_gate, w_up, w_down = _dequant_layer(quant)
    if T <= DENSE_DISPATCH_MAX_T:
        out = _dense_expert_ffn(x, weights, idx, w_gate, w_up, w_down)
    else:
        out = _local_expert_ffn(x, weights, idx, w_gate, w_up, w_down)
    return out.to(x.dtype)


# ---------- expert parallelism over a mesh ----------
# (port of the mesh half of ``llm_d_tpu.ops.moe``: ``_a2a_moe_chunk``,
# as ``_a2a_send`` and ``_a2a_finish``, ``expert_ffn_a2a`` and the psum
# branch of ``expert_ffn``)


def _wire_backend(x: torch.Tensor) -> str:
    return "cuda" if x.is_cuda else "cpu"


def _expert_ffn_mesh(x, weights, idx, w_gate, w_up, w_down, quant, mesh,
                     dispatch, collective_dtype, dbo_min_tokens=None):
    from llm_d_tpu_torch.parallel.mesh import AXIS_DP, AXIS_EP
    from llm_d_tpu_torch.parallel.quant_collectives import (
        quantized_psum, resolve_collective_dtype)
    # The step's tokens over the whole mesh: every dp shard's T_l rows.
    T = x.shape[0] * mesh.axis_size(AXIS_DP)
    ep = mesh.axis_size(AXIS_EP)
    E_loc = (quant["w_gate_q"].shape[1] if quant is not None
             else w_gate.shape[0])
    E = E_loc * ep
    if dispatch == "auto":
        dispatch = os.environ.get("LLMD_MOE_DISPATCH", "auto")
    if dispatch in ("dense", "ragged"):
        # One-device modes must not silently run the psum oracle.
        raise ValueError(
            f"dispatch={dispatch!r} is single-device only; use 'a2a' or "
            f"'psum' on a {ep}-device mesh")
    if dispatch == "auto":
        dispatch = "a2a" if (T % ep == 0 and E % ep == 0) else "psum"
    if dispatch == "a2a":
        return expert_ffn_a2a(x, weights, idx, w_gate, w_up, w_down, mesh,
                              quant=quant, collective_dtype=collective_dtype,
                              dbo_min_tokens=dbo_min_tokens)
    if dispatch != "psum":
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if quant is not None:
        w_gate, w_up, w_down = _dequant_layer(quant)
    # "int8-dispatch" has no meaning for a reduction: the exact psum.
    wire = resolve_collective_dtype(collective_dtype, _wire_backend(x))
    # Every rank runs its experts on every dp shard's tokens, and keeps
    # its own shard's rows of the sum.
    xs, ws, ids = (mesh.all_gather(t, AXIS_DP, dim=0)
                   for t in (x, weights, idx))
    out = _local_expert_ffn(xs, ws, ids, w_gate, w_up, w_down,
                            mesh.axis_index(AXIS_EP) * E_loc)
    if wire == "int8":
        out = quantized_psum(out, mesh, AXIS_EP)
    else:
        out = mesh.all_reduce(out, AXIS_EP)
    d, T_l = mesh.axis_index(AXIS_DP), x.shape[0]
    return out[d * T_l:(d + 1) * T_l].to(x.dtype)


def _pack_rows(*planes: torch.Tensor) -> torch.Tensor:
    """Row-aligned planes (``[N, ...]`` of any dtypes) as one int8 byte
    matrix ``[N, bytes a row]``: one exchange carries them all."""
    return torch.cat([p.reshape(p.shape[0], math.prod(p.shape[1:]))
                      .contiguous().view(torch.int8) for p in planes], dim=1)


def _unpack_rows(buf: torch.Tensor, *specs):
    """Inverse of :func:`_pack_rows`: ``specs`` are ``(dtype, width)``
    in packing order; returns ``[N, width]`` planes (width 1 squeezed)."""
    out, col = [], 0
    for dtype, width in specs:
        nbytes = width * torch.empty((), dtype=dtype).element_size()
        plane = buf[:, col:col + nbytes].contiguous().view(dtype)
        out.append(plane[:, 0] if width == 1 else plane)
        col += nbytes
    return out


def _a2a_send(x_c, w_c, idx_c, w_gate, mesh, quant: Optional[dict],
              wire: str) -> dict:
    """One chunk of the dispatch / expert FFN / combine pipeline, its
    dispatch side: the packed send buffer (``"send"``) and what
    :func:`_a2a_finish` needs of the chunk.

    Fixed-region layout (the JAX package's off the TPU): the receive
    buffer has one region of ``S = Tc * k`` rows per source rank, source
    ``s``'s rows contiguous from ``s * S``, shipped by ``all_to_all`` on
    equal splits; shapes stay static and no split size is read to the
    host.  Rows go in order of destination rank
    (:func:`_stable_argsort_bounded` with bound ``ep``), each with its
    local expert id; a region's empty tail carries id -1, which is how
    the receiver tells the rows that arrived (JAX exchanges the counts
    instead).  Under the ``int8`` / ``int8-dispatch`` wire the rows ship
    per-row quantized with an f32 scale beside them and are dequantized
    on arrival.  Payload, scale and id planes travel packed in one byte
    exchange each way (:func:`_pack_rows`).  With ``quant`` the received
    rows run kernel E in arrival order (each row its own token, routed
    k = 1 to its local expert, the validity mask as its combine weight:
    empty tails go to expert 0 with weight 0); bf16 experts run the
    grouped plain path.  Results return by the reverse exchange, as bf16
    or int8 rows (never f32), and the combine weights are applied at the
    origin after dequantization, each token's copies summed in a fixed
    order (the same tokens on every run)."""
    from llm_d_tpu_torch.parallel.mesh import AXIS_EP
    from llm_d_tpu_torch.parallel.quant_collectives import quantize_rows
    Tc, H = x_c.shape
    k = idx_c.shape[1]
    dev = x_c.device
    ep = mesh.axis_size(AXIS_EP)
    E_loc = (quant["w_gate_q"].shape[1] if quant is not None
             else w_gate.shape[0])
    S = Tc * k
    rows = ep * S
    quant_dispatch = wire in ("int8", "int8-dispatch")
    quant_combine = wire == "int8"

    flat = idx_c.reshape(S).long()
    dest = flat // E_loc
    order, _, send_counts = _stable_argsort_bounded(dest, ep)
    ol = order.long()
    dest_s = dest[ol]
    eloc_s = (flat % E_loc)[ol].to(torch.int32)
    tok_s = ol // k
    within = torch.arange(S, device=dev) - _excl_cumsum(send_counts)[dest_s]
    pidx = dest_s * S + within

    payload = x_c[tok_s]                                 # [S, H]
    if quant_dispatch:
        q, qs = quantize_rows(payload)
        planes = (q, qs, eloc_s)
        specs = ((torch.int8, H), (torch.float32, 1), (torch.int32, 1))
    else:
        planes = (payload.to(torch.bfloat16), eloc_s)
        specs = ((torch.bfloat16, H), (torch.int32, 1))
    packed = _pack_rows(*planes)
    send = torch.zeros((rows, packed.shape[1]), dtype=torch.int8,
                       device=dev)
    # Empty tails: id -1 (zero payload, zero scale).
    send[:, -4:] = torch.full((rows, 1), -1, dtype=torch.int32,
                              device=dev).view(torch.int8)
    send[pidx] = packed
    return dict(send=send, specs=specs, pidx=pidx, ol=ol, w_c=w_c,
                Tc=Tc, H=H, k=k, rows=rows, E_loc=E_loc, dtype=x_c.dtype,
                quant_dispatch=quant_dispatch, quant_combine=quant_combine)


def _a2a_finish(st: dict, received: torch.Tensor, w_gate, w_up, w_down,
                mesh, quant: Optional[dict]) -> torch.Tensor:
    """A chunk's rows ``received`` by the dispatch exchange through the
    expert FFN, back by the combine exchange, weighted and summed per
    token: ``[Tc, H]`` f32."""
    from llm_d_tpu_torch.parallel.mesh import AXIS_EP
    from llm_d_tpu_torch.parallel.quant_collectives import (
        dequantize_rows, quantize_rows)
    Tc, H, k, rows, E_loc = st["Tc"], st["H"], st["k"], st["rows"], \
        st["E_loc"]
    pidx, ol, w_c = st["pidx"], st["ol"], st["w_c"]
    quant_dispatch, quant_combine = st["quant_dispatch"], st["quant_combine"]
    S = Tc * k
    dev = received.device
    recv = _unpack_rows(received, *st["specs"])
    recv_e = recv[-1]
    valid = recv_e >= 0
    if quant_dispatch:
        recv_x = dequantize_rows(recv[0], recv[1], st["dtype"])
    else:
        recv_x = recv[0].to(st["dtype"])

    if quant is not None:
        y = _streamed_int8_kernel_path(
            recv_x, valid.float()[:, None],
            torch.where(valid, recv_e, 0)[:, None], quant,
            out_dtype=torch.float32)
    else:
        e_key = torch.where(valid, recv_e.long(), E_loc)
        order2, _, key_counts = _stable_argsort_bounded(e_key, E_loc + 1)
        o2 = order2.long()
        ys = _swiglu_grouped(recv_x[o2], w_gate, w_up, w_down,
                             key_counts[:E_loc])         # empty rows: 0
        y = torch.zeros((rows, H), dtype=torch.float32, device=dev)
        y[o2] = ys                                       # arrival order

    if quant_combine:
        yq, ys_ = quantize_rows(y)
        back = _pack_rows(yq, ys_)
        ret_q, ret_s = _unpack_rows(mesh.all_to_all(back, AXIS_EP),
                                    (torch.int8, H), (torch.float32, 1))
        ret = dequantize_rows(ret_q[pidx], ret_s[pidx])  # [S, H] f32
    else:
        ret = mesh.all_to_all(y.to(torch.bfloat16), AXIS_EP)[pidx].float()
    # Weighted, back in (token, choice) order, and each token's k copies
    # summed in choice order: a fixed order (an index_add on the card
    # sums with atomics, in whatever order they land).
    contrib = torch.empty((S, H), dtype=torch.float32, device=dev)
    contrib[ol] = ret * w_c.reshape(S).float()[ol][:, None]
    return contrib.reshape(Tc, k, H).sum(dim=1)


def dbo_chunk_tokens(T: int, ep: int, chunk_tokens: int,
                     dbo_min_tokens: Optional[int]) -> int:
    """Tokens a dispatch chunk of each EP rank's ``T / ep`` rows (the JAX
    package's rule, on the step's global row count ``T``: every dp
    shard's rows).  DBO: once ``T`` reaches ``max(dbo_min_tokens, 2 *
    ep)`` and a rank has at least 2 rows, at most half of them a chunk,
    so a rank runs at least two chunks; then the largest divisor of the
    rank's rows at or below.  ``dbo_min_tokens`` None reads
    ``LLMD_MOE_DBO`` / ``LLMD_DBO_TOKEN_THRESHOLD`` (a standalone op's
    fallback); below 0 it is off (an engine with DBO off passes -1, so
    the environment never reaches it)."""
    T_loc = T // ep
    if dbo_min_tokens is None and os.environ.get("LLMD_MOE_DBO", "0") == "1":
        dbo_min_tokens = env_int("LLMD_DBO_TOKEN_THRESHOLD", 32)
    if dbo_min_tokens is not None and dbo_min_tokens >= 0 \
            and T >= max(dbo_min_tokens, 2 * ep) and T_loc >= 2:
        chunk_tokens = min(chunk_tokens, T_loc // 2)
    chunk_tokens = max(1, min(chunk_tokens, T_loc))
    while T_loc % chunk_tokens:
        chunk_tokens -= 1
    return chunk_tokens


def expert_ffn_a2a(x, weights, idx, w_gate, w_up, w_down, mesh,
                   chunk_tokens: Optional[int] = None,
                   quant: Optional[dict] = None,
                   collective_dtype: Optional[str] = None,
                   dbo_min_tokens: Optional[int] = None) -> torch.Tensor:
    """Sparse all-to-all EP dispatch over every rank of ``mesh``.

    ``x`` is replicated over the rank's ``(sp, tp)`` ranks (the whole
    batch at dp = 1, the rank's dp shard otherwise; dp and sp are never
    both above 1).  Each rank takes its ``T / (sp * tp)`` slice of it, in
    chunks of ``LLMD_MOE_DP_CHUNK_SIZE`` tokens (1024;
    :func:`dbo_chunk_tokens` with the DBO threshold ``dbo_min_tokens``)
    through the dispatch / expert FFN / combine of :func:`_a2a_send` and
    :func:`_a2a_finish` over the EP group of every rank, then one
    all-gather over ``(sp, tp)`` puts the ``[T, H]`` (in x.dtype) back on
    each of them.  Rank ``(d, s, t)`` so dispatches rows ``d * T + (s *
    tp + t) * T / (sp * tp)`` of the JAX package's stacked ``[dp * T]``
    rows, as its EP split over ``(dp, sp, tp)`` does, and runs as many
    chunks as each JAX shard does.  Needs ``dp * T % ep == 0`` and ``E %
    ep == 0``.

    DBO (dual-batch overlap): chunk ``i + 1``'s dispatch exchange is
    issued (``Mesh.all_to_all_async``) before chunk ``i``'s expert FFN
    and combine run, and waited on after them, so the exchange of one
    chunk overlaps the expert compute of the other.  Chunks share no
    state, so the result is the chunk-by-chunk one, and the exchanges
    carry the same bytes as one chunk's."""
    from llm_d_tpu_torch.parallel.mesh import (AXIS_DP, AXIS_EP, AXIS_SP,
                                               AXIS_TP)
    from llm_d_tpu_torch.parallel.quant_collectives import (
        resolve_collective_dtype)
    wire = resolve_collective_dtype(collective_dtype, _wire_backend(x))
    ep = mesh.axis_size(AXIS_EP)
    # The ranks that hold the same rows: every rank but the dp axis's.
    rep = (AXIS_SP, AXIS_TP)
    n_rep = mesh.axis_size(rep)
    T = x.shape[0]
    if T % n_rep:
        raise ValueError(f"a2a dispatch needs the step's tokens to divide "
                         f"over ep (T={T * (ep // n_rep)}, ep={ep})")
    T_loc = T // n_rep
    if chunk_tokens is None:
        chunk_tokens = env_int("LLMD_MOE_DP_CHUNK_SIZE", 1024)
    chunk_tokens = dbo_chunk_tokens(T * mesh.axis_size(AXIS_DP), ep,
                                    chunk_tokens, dbo_min_tokens)
    r0 = mesh.axis_index(rep) * T_loc
    starts = range(r0, r0 + T_loc, chunk_tokens)

    def send(c0):
        sl = slice(c0, c0 + chunk_tokens)
        st = _a2a_send(x[sl], weights[sl], idx[sl], w_gate, mesh, quant,
                       wire)
        return st, mesh.all_to_all_async(st["send"], AXIS_EP)

    outs = []
    nxt = send(starts[0])
    for i in range(len(starts)):
        st, pending = nxt
        received = pending.wait()
        if i + 1 < len(starts):
            nxt = send(starts[i + 1])
        outs.append(_a2a_finish(st, received, w_gate, w_up, w_down, mesh,
                                quant))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return mesh.all_gather(out.to(x.dtype), rep, dim=0)
