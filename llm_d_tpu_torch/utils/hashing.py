"""Deterministic KV-block hashing.

The cluster-wide precise prefix index requires every replica to hash token
blocks identically (the reference pins ``PYTHONHASHSEED=42`` and configures
``tokenProcessorConfig{blockSize: 64, hashSeed: "42"}``; reference:
ms-kv-events/values.yaml:47-48, gaie-kv-events/values.yaml:50-57).  We use
sha256 over a canonical encoding of (seed, parent_hash, tokens, extras) --
the same chain scheme as vLLM's ``sha256_cbor`` block hashing -- which is
process- and language-independent by construction, so no PYTHONHASHSEED
pinning is needed.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Iterable, List, Optional, Sequence

DEFAULT_BLOCK_SIZE = 64
DEFAULT_HASH_SEED = "42"


def hash_block(
    parent: Optional[bytes],
    tokens: Sequence[int],
    seed: str = DEFAULT_HASH_SEED,
    extra: bytes = b"",
) -> bytes:
    """Chain-hash one full token block onto its parent prefix hash."""
    h = hashlib.sha256()
    h.update(seed.encode())
    h.update(parent or b"\x00" * 32)
    h.update(struct.pack(f"<{len(tokens)}q", *tokens))
    if extra:
        h.update(extra)
    return h.digest()


def hash_token_blocks(
    tokens: Sequence[int],
    block_size: int = DEFAULT_BLOCK_SIZE,
    seed: str = DEFAULT_HASH_SEED,
) -> List[bytes]:
    """Hashes for every *full* block prefix of ``tokens`` (partial tail
    blocks are never cached/shared, matching the engine's prefix cache)."""
    out: List[bytes] = []
    parent: Optional[bytes] = None
    for start in range(0, len(tokens) - len(tokens) % block_size, block_size):
        parent = hash_block(parent, tokens[start:start + block_size], seed)
        out.append(parent)
    return out
