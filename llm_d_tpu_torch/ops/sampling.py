"""Batched sampling: greedy / temperature / top-k / top-p.

Port of ``llm_d_tpu.ops.sampling`` (``sample``, ``spec_verify``,
``compute_logprobs``, ``verify_logprobs``, ``compute_top_logprobs``).
Greedy rows match the JAX package exactly.

Random rows add Gumbel noise to the masked top-``TOPK_MAX`` logits and
take the argmax, with the JAX package's keys and bits (``ops/prng.py``,
threefry2x32): seeded rows draw from ``fold_in(fold_in(PRNGKey(0),
seed), gen_idx)`` (deterministic for a given request position, whatever
the batch or the step), unseeded rows from ``fold_in(step_key, row)``.
Every row's noise is drawn on the logits' device in one batched call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from llm_d_tpu_torch.ops import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (OpenAI API surface)."""
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0              # 0 = disabled
    max_tokens: int = 16
    min_tokens: int = 0
    stop: tuple = ()
    seed: Optional[int] = None
    ignore_eos: bool = False
    logprobs: Optional[int] = None

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


# Sampling truncates to the top TOPK_MAX logits before top-k/top-p.
TOPK_MAX = 64


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last dim with ties broken toward the LOWER
    index, as ``jax.lax.top_k`` does (``torch.topk`` promises no order
    among equal values on the card)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def row_noise(S: int, K: int, device: torch.device, key: prng.Key,
              seeds: Optional[torch.Tensor] = None,
              gen_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel noise ``[S, K]`` of every row, as the JAX package draws it:
    seeded rows (``seeds >= 0``) from ``fold_in(fold_in(PRNGKey(0),
    seed), gen_idx)``, the others from ``fold_in(key, row)``."""
    rows = torch.arange(S, dtype=torch.int64, device=device)
    k0, k1 = prng.fold_in(key, rows)
    if seeds is not None:
        sd = seeds.to(device, torch.int64)
        gi = (gen_idx.to(device, torch.int64) if gen_idx is not None
              else torch.zeros_like(sd))
        s0, s1 = prng.fold_in(prng.fold_in(prng.prng_key(0),
                                           sd.clamp(min=0)), gi)
        pick = sd >= 0
        k0 = torch.where(pick, s0, k0)
        k1 = torch.where(pick, s1, k1)
    return prng.gumbel((k0, k1), K)


def sample(
    logits: torch.Tensor,          # [S, V] f32
    temperature: torch.Tensor,     # [S] f32 (0 = greedy)
    top_k: torch.Tensor,           # [S] i32 (0 = off)
    top_p: torch.Tensor,           # [S] f32 (1 = off)
    key: Optional[prng.Key] = None,           # this step's key
    seeds: Optional[torch.Tensor] = None,     # [S] i32, -1 = unseeded
    gen_idx: Optional[torch.Tensor] = None,   # [S] i32 tokens generated so far
    noise: Optional[torch.Tensor] = None,     # [S, min(64, V)] Gumbel noise
    random_rows: Optional[bool] = None,       # any row with temperature > 0
) -> torch.Tensor:                 # [S] int64 sampled ids
    """Batched sampling.  The per-row parameter tensors may live on the
    CPU (the engine passes host copies, so deciding whether any row is
    random costs no device sync); they are moved to ``logits.device`` for
    the arithmetic.  ``random_rows`` gives that decision instead (the
    multistep block decides it on the host, once per block, and passes
    device tensors).  ``key`` is the step's key (``prng.split`` of the
    engine's), its words ints or 0-d int64 tensors; ``noise``, when
    given, replaces the drawn Gumbel noise (tests)."""
    S, V = logits.shape
    dev = logits.device
    greedy_ids = torch.argmax(logits, dim=-1)
    if random_rows is None:
        random_rows = bool((temperature > 0.0).any())
    if not random_rows:
        return greedy_ids
    K = min(TOPK_MAX, V)
    temp_d = temperature.to(dev, torch.float32)
    vals, idxs = top_k_stable(logits, K)                     # [S, K]
    v = vals / torch.clamp_min(temp_d, 1e-6)[:, None]
    ranks = torch.arange(K, device=dev)[None, :]
    tk = top_k.to(dev)
    k_eff = torch.where(tk <= 0, torch.full_like(tk, K),
                        torch.clamp_max(tk, K))[:, None]
    keep_k = ranks < k_eff
    probs = torch.softmax(v, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens until the exclusive cumulative prob exceeds p; rank 0
    # always survives.
    keep_p = (cum - probs) < top_p.to(dev, torch.float32)[:, None]
    masked = torch.where(keep_k & keep_p, v,
                         torch.full_like(v, float("-inf")))
    if noise is None:
        if key is None:
            raise ValueError("sample: random rows need a key or noise")
        noise = row_noise(S, K, dev, key, seeds, gen_idx)
    choice = torch.argmax(masked + noise.to(dev), dim=-1)     # [S]
    sampled = torch.gather(idxs, 1, choice[:, None])[:, 0]
    return torch.where(temp_d <= 0.0, greedy_ids, sampled)


# The key of the fixed-acceptance coin, folded with the engine step.
ACCEPT_COIN_SEED = 0x5BEC


def accept_coin(step: int, S: int, K: int, device) -> torch.Tensor:
    """``jax.random.uniform(fold_in(PRNGKey(0x5BEC), step), (S, K))``,
    bit for bit, on ``device``."""
    key = prng.fold_in(prng.prng_key(ACCEPT_COIN_SEED), int(step))
    return prng.uniform(key, S * K, device).reshape(S, K)


def spec_verify(
    logits: torch.Tensor,          # [S*(K+1), V] f32, position-major per seq
    draft_tokens: torch.Tensor,    # [S, K] drafted ids fed at slots 1..K
    spec_n: torch.Tensor,          # [S] live drafts per seq (0 = plain)
    temperature: torch.Tensor,     # [S] f32
    top_k: torch.Tensor,           # [S] i32
    top_p: torch.Tensor,           # [S] f32
    key: prng.Key,
    seeds: torch.Tensor,           # [S] i32, -1 = unseeded
    gen0: torch.Tensor,            # [S] i32 tokens emitted before this step
    coin: Optional[torch.Tensor] = None,          # [S, K] f32
    fixed_accept: Optional[torch.Tensor] = None,  # f32, < 0: verify
    random_rows: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:   # (ids [S, K+1], accepted [S])
    """Draft verification and bonus sampling (``sampling.spec_verify``).

    Every verify position samples the target's token with the randomness
    the non-spec engine would use there: ``sample`` over the ``S*(K+1)``
    rows, parameters repeated per position, seeded rows at ``gen_idx =
    gen0 + q``.  A draft is accepted while it equals the target's sample
    at its position (and is live), so the emitted prefix ``ids[:,
    :accepted + 1]`` is the non-spec output for greedy and seeded rows.

    With a ``coin`` (bench only: the step's ``accept_coin``, drawn on
    the host ahead, so that a captured graph takes it as an input), a
    draft is accepted while its coin is below ``fixed_accept``, an f32
    tensor; a negative rate verifies as above.  The per-row parameters
    may live on the CPU, as for ``sample``; ``random_rows`` says whether
    any row is random, which a graph cannot ask of its inputs."""
    S, K = draft_tokens.shape
    Q = K + 1
    dev = logits.device

    def rep(x):
        return torch.repeat_interleave(x, Q)

    gen_idx = (gen0.to(dev, torch.int64)[:, None]
               + torch.arange(Q, dtype=torch.int64, device=dev)[None, :]
               ).reshape(-1)
    ids = sample(logits, rep(temperature), rep(top_k), rep(top_p), key=key,
                 seeds=rep(seeds), gen_idx=gen_idx,
                 random_rows=random_rows).reshape(S, Q)
    equal = draft_tokens.to(dev, torch.int64) == ids[:, :K]
    if coin is not None:
        match = (coin < fixed_accept) | ((fixed_accept < 0) & equal)
    else:
        match = equal
    live = (torch.arange(K, device=dev)[None, :]
            < spec_n.to(dev)[:, None])
    accepted = torch.cumprod((match & live).to(torch.int32), dim=1).sum(1)
    return ids, accepted


def compute_logprobs(logits: torch.Tensor,
                     token_ids: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen tokens. logits [S, V], ids [S]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, 1, token_ids[:, None].long())[:, 0]


def compute_top_logprobs(logits: torch.Tensor, token_ids: torch.Tensor,
                         n: int = 20):
    """(chosen [S], top_ids [S, n] int32, top_logprobs [S, n])."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen = torch.gather(logp, 1, token_ids[:, None].long())[:, 0]
    top_lps, top_ids = top_k_stable(logp, n)
    return chosen, top_ids.to(torch.int32), top_lps


def verify_logprobs(logits: torch.Tensor, ids: torch.Tensor,
                    top_n: int = 0):
    """Logprobs of every verify position: ``logits`` [S*(K+1), V] as
    ``spec_verify`` takes them, ``ids`` [S, K+1] its samples.  Returns
    ``lp [S, K+1]`` and, with ``top_n > 0``, ``top_ids`` / ``top_lps``
    ``[S, K+1, top_n]``; the host keeps the accepted prefix."""
    S, Q = ids.shape
    flat = ids.reshape(-1)
    if top_n <= 0:
        return compute_logprobs(logits, flat).reshape(S, Q)
    chosen, top_ids, top_lps = compute_top_logprobs(logits, flat, top_n)
    return (chosen.reshape(S, Q), top_ids.reshape(S, Q, top_n),
            top_lps.reshape(S, Q, top_n))
