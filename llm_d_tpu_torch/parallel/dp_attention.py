"""Data-parallel attention (port of ``llm_d_tpu.parallel.dp_attention``).

The wide-EP regime ("TP x DP in attention, EP in MoE layers") runs
attention data-parallel over the mesh's ``dp`` axis while the routed
experts are expert-parallel over every rank.  The JAX package expresses
it as one program over stacked ``[dp, ...]`` arrays, attention under a
partial-manual ``shard_map`` over ``dp``.

In the port each rank *is* one dp shard: the engine hands a rank only its
shard's batch (its ``[T_l]`` tokens and ``[S_l]`` sequences, block ids
rebased to its region) and the rank holds only its ``[L, slots_l, W]``
cache plane, so :func:`dp_attend` is the rank's own attention and no
collective crosses ``dp`` inside it.  ``tp`` stays inside: the heads'
shards and their collectives run on the rank's tp group.  The engine
gathers the shards' sampling rows over ``dp`` after the forward, and the
MoE exchange spans every rank (``ops/moe.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# Batch arrays attention consumes; each is the rank's own shard.
ATTN_BATCH_KEYS = ("positions", "token_seq_ids", "token_qpos",
                   "slot_mapping", "block_tables", "seq_lens", "qtok_idx")

AttendLocal = Callable[..., torch.Tensor]


def dp_attend(attend_local: AttendLocal, mesh, lp, hn: torch.Tensor,
              caches: Tuple[torch.Tensor, ...],
              batch: Dict[str, torch.Tensor], li: int):
    """``attend_local(lp, hn, caches, abatch, li)`` on this rank's dp
    shard: ``hn`` is ``[T_l, D]``, each cache the rank's ``[L, slots_l,
    W]`` plane (updated in place), ``batch`` the shard's.  Returns the
    attention output ``[T_l, D]``.  Off a dp mesh (``mesh`` None, or dp =
    1) the shard is the whole batch: the same call is the one-device
    attention.  (``sp > 1``, which would shard sequences instead, is
    refused when the mesh is built.)"""
    ab = {k: batch[k] for k in ATTN_BATCH_KEYS if k in batch}
    return attend_local(lp, hn, caches, ab, li)
