"""Mid-stream resume, the replica's half (port of the chunk meta and the
client-side checks of ``llm_d_tpu.server.stream_resume``).

A streaming relay (the EPP gateway) journals the token ids a replica has
emitted; when that replica dies mid-stream it re-posts the original body
plus ``body["resume"] = {"offset": N, "token_ids": [...]}`` and the
``x-llmd-resume-offset`` header to a surviving replica.  The replica
admits prompt + journal as a prefill (restored from the prefix cache or
the host / shared tier where it can, recomputed where it cannot) and
emits from offset N on.

Every streamed chunk carries an ``llmd`` object, ``{"off": <completion
token index of the chunk's first token>, "tok": [token ids]}``, and the
first chunk after a resume also ``"src": "restored" | "recomputed"`` and
``"restored"`` (generated-region tokens the cache tiers supplied).
OpenAI clients ignore it; :func:`verify_continuity` checks a collected
stream for duplicated or missing token indices.

The relay itself (``StreamJournal``, ``relay_stream``) is the gateway's
and the DP leader's, and is not here.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

# Key of the per-chunk journal object (see the module docstring).
CHUNK_META_KEY = "llmd"

OUTCOME_RESTORED = "restored"
OUTCOME_RECOMPUTED = "recomputed"


def chunk_meta(off: int, token_ids: List[int],
               src: Optional[str] = None,
               restored_tokens: Optional[int] = None) -> Dict[str, Any]:
    """The ``llmd`` object a server attaches to each chunk."""
    meta: Dict[str, Any] = {"off": off, "tok": list(token_ids)}
    if src is not None:
        meta["src"] = src
        meta["restored"] = int(restored_tokens or 0)
    return meta


def _frame_data(frame: bytes) -> Optional[bytes]:
    """Payload of an SSE ``data:`` frame, or None for other frames."""
    for line in frame.split(b"\n"):
        if line.startswith(b"data:"):
            return line[5:].strip()
    return None


def parse_stream_payload(payload: bytes
                         ) -> Tuple[str, List[Dict[str, Any]], bool]:
    """A collected SSE byte stream as a client sees it: the concatenated
    token text, the chunks' ``llmd`` metas in arrival order, and whether
    ``[DONE]`` arrived."""
    text_parts: List[str] = []
    metas: List[Dict[str, Any]] = []
    done = False
    for frame in payload.split(b"\n\n"):
        data = _frame_data(frame + b"\n")
        if data is None:
            continue
        if data == b"[DONE]":
            done = True
            continue
        try:
            chunk = json.loads(data)
        except ValueError:
            continue
        for choice in chunk.get("choices") or []:
            delta = choice.get("delta") or {}
            text_parts.append(choice.get("text") or delta.get("content")
                              or "")
        meta = chunk.get(CHUNK_META_KEY)
        if isinstance(meta, dict):
            metas.append(meta)
    return "".join(text_parts), metas, done


def verify_continuity(metas: List[Dict[str, Any]],
                      expect_total: Optional[int] = None) -> List[str]:
    """No duplicated and no missing token index over a stream's metas:
    index ``off + i`` of every chunk must run on from 0.  Returns the
    problems found (empty: continuous)."""
    problems: List[str] = []
    expected = 0
    for n, meta in enumerate(metas):
        off = int(meta.get("off", -1))
        toks = list(meta.get("tok") or [])
        if not toks:
            continue
        if off < expected:
            problems.append(
                f"chunk {n}: duplicate token indices {off}..{off + len(toks) - 1} "
                f"(already delivered through {expected - 1})")
        elif off > expected:
            problems.append(
                f"chunk {n}: missing token indices {expected}..{off - 1}")
        expected = max(expected, off + len(toks))
    if expect_total is not None and expected != expect_total:
        problems.append(
            f"stream delivered {expected} token indices, expected "
            f"{expect_total}")
    return problems
