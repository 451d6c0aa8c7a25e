"""Ring attention: exact attention over a sequence sharded on the mesh's
``sp`` axis (port of ``llm_d_tpu.ops.ring_attention``).

The JAX package runs this op in ``jnp`` under ``shard_map``; the port runs
it on each rank of its :class:`~llm_d_tpu_torch.parallel.mesh.Mesh`, in
plain PyTorch (no Pallas kernel is involved on either side).

  - Each rank holds its shard of Q, K and V by JAX's specs ``P(sp, tp,
    None)``: rows ``[T/sp]`` of the sequence, heads ``[H/tp]`` (``dp``
    replicated).
  - ``sp`` ring steps: every rank runs the flash (online-softmax)
    recurrence of its Q rows against the K/V chunk it holds, in f32, then
    passes the ``(k, v)`` pair to the next rank on the ring
    (:meth:`Mesh.ring_shift`, JAX's ``ppermute`` with ``[(i, i + 1)]``).
    After ``sp`` steps every Q row has attended to every K/V row, and no
    rank held more than ``T/sp`` rows of each.
  - Causal masking uses global positions (a chunk's origin is its source
    rank), and a chunk that lies wholly in the rank's future is skipped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# The running max is floored here, so a row whose every key is masked so
# far keeps exp(-inf - floor) = 0 and no NaN.
M_FLOOR = -1e29
# The specs of q, k and v (and the output): sequence over sp, heads over tp.
QKV_SPEC = ("sp", "tp", None)

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _flash_block(q, k, v, q_pos, k_pos, scale: float, causal: bool,
                 carry: Carry) -> Carry:
    """One online-softmax accumulation of ``q`` ``[Tq, H, D]`` against a
    ``(k, v)`` chunk ``[Tk, KVH, D]``, in f32."""
    m, l, acc = carry
    Tq, H, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    qf = q.float().reshape(Tq, KVH, G, D) * scale
    s = torch.einsum("qkgd,skd->qkgs", qf, k.float())
    if causal:
        valid = k_pos[None, :] <= q_pos[:, None]              # [Tq, Tk]
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    m_new = torch.clamp(torch.maximum(m, s.amax(dim=-1)), min=M_FLOOR)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "qkgs,skd->qkgd", p, v.float())
    return m_new, l_new, acc_new


def _init_carry(Tq: int, KVH: int, G: int, D: int,
                device: torch.device) -> Carry:
    return (torch.full((Tq, KVH, G), M_FLOOR, dtype=torch.float32,
                       device=device),
            torch.zeros((Tq, KVH, G), dtype=torch.float32, device=device),
            torch.zeros((Tq, KVH, G, D), dtype=torch.float32, device=device))


def _finish(carry: Carry, q: torch.Tensor) -> torch.Tensor:
    _, l, acc = carry
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh=None, scale: Optional[float] = None,
                   causal: bool = True) -> torch.Tensor:
    """Exact attention over a sequence sharded across ``mesh``'s sp axis.

    ``q`` ``[T/sp, H/tp, D]``, ``k`` and ``v`` ``[T/sp, KVH/tp, D]``: this
    rank's shards (:func:`shard_qkv`).  Returns this rank's ``[T/sp, H/tp,
    D]`` of the output, in q's dtype.  Every rank of the mesh calls it (an
    SPMD call); with no mesh, or ``sp == 1``, it is plain flash attention
    over the one shard."""
    Tl, H, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    scale = scale if scale is not None else D ** -0.5
    sp = 1 if mesh is None else mesh.axis_size("sp")
    dev = q.device
    if sp == 1:
        pos = torch.arange(Tl, dtype=torch.int32, device=dev)
        return _finish(_flash_block(q, k, v, pos, pos, scale, causal,
                                    _init_carry(Tl, KVH, G, D, dev)), q)
    rank = mesh.axis_index("sp")
    q_pos = rank * Tl + torch.arange(Tl, dtype=torch.int32, device=dev)
    q_max = rank * Tl + Tl - 1
    carry = _init_carry(Tl, KVH, G, D, dev)
    kv = torch.stack([k, v])
    for step in range(sp):
        src = (rank - step) % sp                    # the chunk's origin rank
        # A chunk wholly in this shard's future adds nothing: skipped.
        if not causal or src * Tl <= q_max:
            k_pos = src * Tl + torch.arange(Tl, dtype=torch.int32,
                                            device=dev)
            carry = _flash_block(q, kv[0], kv[1], q_pos, k_pos, scale,
                                 causal, carry)
        if step < sp - 1:
            kv = mesh.ring_shift(kv, "sp")
    return _finish(carry, q)


def shard_qkv(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's shard of a full ``[T, heads, D]`` tensor by
    ``P(sp, tp, None)``."""
    from llm_d_tpu_torch.parallel.sharding import shard_tensor
    return shard_tensor(x, QKV_SPEC, mesh)


def attention_reference_dense(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: Optional[float] = None,
                              causal: bool = True) -> torch.Tensor:
    """O(T^2) full-softmax oracle over whole ``[T, H, D]`` / ``[T, KVH,
    D]`` tensors, in f32; returns q's dtype."""
    T, H, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(T, KVH, G, D) * scale
    s = torch.einsum("qkgd,skd->qkgs", qf, k.float())
    if causal:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("qkgs,skd->qkgd", p, v.float())
    return out.reshape(T, H, D).to(q.dtype)
