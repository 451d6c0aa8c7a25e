"""Mid-stream resume: the replica's half and the relay's (port of
``llm_d_tpu.server.stream_resume``).

A streaming relay (the EPP gateway, or the DP leader's worker pool in
``server/openai.py``) journals the token ids a replica has emitted; when
that replica dies mid-stream it re-posts the original body plus
``body["resume"] = {"offset": N, "token_ids": [...]}`` and the
``x-llmd-resume-offset`` / ``x-llmd-resume-attempt`` headers to a
surviving replica.  The replica admits prompt + journal as a prefill
(restored from the prefix cache or the host / shared tier where it can,
recomputed where it cannot) and emits from offset N on.

Every streamed chunk carries an ``llmd`` object, ``{"off": <completion
token index of the chunk's first token>, "tok": [token ids]}``, and the
first chunk after a resume also ``"src": "restored" | "recomputed"`` and
``"restored"`` (generated-region tokens the cache tiers supplied).
OpenAI clients ignore it; :func:`verify_continuity` checks a collected
stream for duplicated or missing token indices.

The relay's half:

  - a :class:`StreamJournal` records, per relayed stream, what a resume
    needs: the emitted completion token ids and their offset (the prompt,
    sampling parameters, seed, criticality and absolute deadline ride in
    the request body and headers already);
  - :func:`relay_stream` pumps upstream SSE frames to the client while
    journaling, detects a replica's death (the upstream breaks, or no
    bytes come for ``LLMD_STREAM_STALL_TIMEOUT_S``), and dedupes by token
    offset, so a resumed upstream never duplicates or skips an index.

Degradation, in order: ``LLMD_STREAM_RESUME=0`` never journals (the
fail-fast contract); ``sheddable`` streams are never resumed; a stream is
resumed at most ``LLMD_RESUME_MAX_ATTEMPTS`` times and only while its
deadline budget lasts.  Past any of those the break reaches the client.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from llm_d_tpu_torch.utils.config import env_float, env_int
from llm_d_tpu_torch.utils.faultinject import get_injector
from llm_d_tpu_torch.utils.lifecycle import (
    RESUME_ATTEMPT_HEADER,
    RESUME_OFFSET_HEADER,
)

# Key of the per-chunk journal object (see the module docstring).
CHUNK_META_KEY = "llmd"

OUTCOME_RESTORED = "restored"
OUTCOME_RECOMPUTED = "recomputed"
OUTCOME_FAILED = "failed"


class StreamBroken(Exception):
    """The upstream stream died mid-flight (its connection broke, or it
    ended before ``[DONE]``): the failure a resume recovers from."""


class ClientGone(Exception):
    """Writing to the client failed: the consumer hung up mid-stream.  Not
    an ``OSError``, so a relay lets it propagate (the request is aborted)
    instead of taking it for the upstream's death and spending resume
    attempts on a socket nobody reads."""


class StreamStall(StreamBroken):
    """No upstream bytes for ``LLMD_STREAM_STALL_TIMEOUT_S`` seconds: a
    wedged replica is failed over like a dead one."""


@dataclasses.dataclass
class ResumePolicy:
    enabled: bool
    max_attempts: int
    stall_timeout_s: float


def resume_policy() -> ResumePolicy:
    """The knobs, read again for each request (so they can be changed on
    a live process); invalid values fall back to the defaults."""
    return ResumePolicy(
        enabled=env_int("LLMD_STREAM_RESUME", 1) != 0,
        max_attempts=env_int("LLMD_RESUME_MAX_ATTEMPTS", 2),
        stall_timeout_s=env_float("LLMD_STREAM_STALL_TIMEOUT_S", 0.0))


def chunk_meta(off: int, token_ids: List[int],
               src: Optional[str] = None,
               restored_tokens: Optional[int] = None) -> Dict[str, Any]:
    """The ``llmd`` object a server attaches to each chunk."""
    meta: Dict[str, Any] = {"off": off, "tok": list(token_ids)}
    if src is not None:
        meta["src"] = src
        meta["restored"] = int(restored_tokens or 0)
    return meta


class StreamJournal:
    """One relayed stream's resumable state and its offset dedupe.

    ``token_ids`` / ``offset`` grow as data frames pass through
    :meth:`admit_frame`; ``done`` is set when ``[DONE]`` is relayed.
    ``last_src`` keeps the resume replica's restore-or-recompute verdict
    (its first chunk's meta), the ``outcome`` label of
    ``llmd_tpu:stream_resume_total``.
    """

    def __init__(self, body: Dict[str, Any], criticality: str = "standard",
                 deadline_epoch: Optional[float] = None) -> None:
        self.body = body
        self.criticality = criticality
        self.deadline_epoch = deadline_epoch
        self.token_ids: List[int] = []
        # A body that already carries resume state (a relay upstream is
        # resuming through this one) seeds the journal, so a second break
        # resumes with the whole token history.
        try:
            self.token_ids = [int(t) for t in
                              (body.get("resume") or {}).get(
                                  "token_ids") or []]
        except (TypeError, ValueError):
            self.token_ids = []
        self.done = False
        self.resume_count = 0
        self.last_src: Optional[str] = None
        self.stream_id: Optional[str] = None   # chunk "id" (rid continuity)
        # The finish_reason delivered, if any: a break after the finish
        # chunk but before [DONE] needs no replica (the relay closes the
        # stream itself; a resume would decode past a delivered stop).
        self.finish_reason: Optional[str] = None
        # Token-carrying frames relayed without a parseable llmd meta:
        # dedupe cannot protect these, so such a journal is not resumable.
        self.unjournaled_frames = 0
        # Recovery accounting: mark_break() notes the detection time; the
        # first new token frame after it records (outcome, seconds).
        self._broke_at: Optional[float] = None
        self._recoveries: List[Tuple[str, float]] = []

    @property
    def offset(self) -> int:
        return len(self.token_ids)

    @property
    def resumable(self) -> bool:
        return not self.done and self.unjournaled_frames == 0

    def resume_body(self) -> Dict[str, Any]:
        body = dict(self.body)
        body["resume"] = {"offset": self.offset,
                          "token_ids": list(self.token_ids)}
        if self.stream_id and not body.get("request_id"):
            # The resumed replica emits under the stream id the client
            # has been reading.
            body["request_id"] = self.stream_id
        return body

    def resume_headers(self) -> Dict[str, str]:
        return {RESUME_OFFSET_HEADER: str(self.offset),
                RESUME_ATTEMPT_HEADER: str(self.resume_count)}

    def mark_break(self) -> None:
        """Note the detection of the upstream's death; the next admitted
        token frame closes the recovery-latency measurement."""
        self._broke_at = time.monotonic()

    def take_recoveries(self) -> List[Tuple[str, float]]:
        """Drain the completed (outcome, recovery seconds) pairs."""
        out, self._recoveries = self._recoveries, []
        return out

    def admit_frame(self, frame: bytes) -> bool:
        """Journal one complete SSE frame; False when the frame only
        repeats tokens already delivered (a resumed upstream replaying
        below the journal's offset) and must not reach the client."""
        payload = _frame_data(frame)
        if payload is None:
            return True                     # a comment or heartbeat
        if payload == b"[DONE]":
            self.done = True
            return True
        try:
            chunk = json.loads(payload)
            meta = chunk.get(CHUNK_META_KEY)
            if self.stream_id is None and chunk.get("id"):
                self.stream_id = str(chunk["id"])
        except (ValueError, AttributeError):
            chunk = None
            meta = None
        if not isinstance(meta, dict) or "off" not in meta:
            # Usage frames (choices=[]) and finals carry no tokens: relay
            # them.  A token-carrying frame without meta (a foreign
            # server) disqualifies the journal rather than risk a
            # duplicate on resume.
            if isinstance(meta, dict) or not _carries_tokens(chunk):
                return True
            self.unjournaled_frames += 1
            return True
        off = int(meta.get("off", 0))
        toks = list(meta.get("tok") or [])
        src = meta.get("src")
        if src is not None:
            self.last_src = str(src)
        for choice in (chunk.get("choices") or []
                       if isinstance(chunk, dict) else []):
            if choice.get("finish_reason"):
                self.finish_reason = choice["finish_reason"]
        if toks and off + len(toks) <= self.offset:
            return False                    # a whole duplicate: drop it
        # The resume replica starts at the journal's offset; a gap or an
        # overlap is relayed all the same (verify_continuity flags it).
        appended = False
        for i, t in enumerate(toks):
            if off + i < self.offset:
                continue
            self.token_ids.append(int(t))
            appended = True
        if appended and self._broke_at is not None:
            self._recoveries.append(
                (self.last_src or OUTCOME_RECOMPUTED,
                 time.monotonic() - self._broke_at))
            self._broke_at = None
        return True


def _frame_data(frame: bytes) -> Optional[bytes]:
    """Payload of an SSE ``data:`` frame, or None for other frames."""
    for line in frame.split(b"\n"):
        if line.startswith(b"data:"):
            return line[5:].strip()
    return None


def _carries_tokens(chunk: Any) -> bool:
    if not isinstance(chunk, dict):
        return False
    for choice in chunk.get("choices") or []:
        delta = choice.get("delta") or {}
        if choice.get("text") or delta.get("content"):
            return True
    return False


async def relay_stream(resp, content, journal: StreamJournal,
                       fault_key: str = "",
                       stall_timeout_s: float = 0.0,
                       span=None) -> None:
    """Pump upstream SSE (``content.readany()``, b"" at its end) into the
    client response ``resp`` while journaling.

    Returns once ``[DONE]`` is relayed.  Raises :class:`StreamBroken` when
    the upstream ends before ``[DONE]``, :class:`StreamStall` when the
    watchdog fires, and lets transport errors and the ``stream.relay``
    fault (keyed by ``fault_key``, the upstream's URL) propagate: the
    caller's resume loop takes each for the upstream's death.  A failed
    write to the client raises :class:`ClientGone` (the caller aborts and
    never resumes).  Only whole frames reach the client: a partial frame
    at the break is dropped, so a resumed stream splices at a frame
    boundary.

    ``span``: a ``first_token`` event is added when the first new token
    frame passes, a ``stream_stall`` event when the watchdog fires.
    """
    buf = b""
    saw_token = False
    while True:
        await get_injector().acheck("stream.relay", key=fault_key)
        if stall_timeout_s > 0:
            try:
                chunk = await asyncio.wait_for(
                    content.readany(), stall_timeout_s)
            except asyncio.TimeoutError:
                if span is not None:
                    span.add_event("stream_stall",
                                   timeout_s=stall_timeout_s)
                raise StreamStall(
                    f"no upstream bytes for {stall_timeout_s:.1f}s "
                    f"(token-gap watchdog)") from None
        else:
            chunk = await content.readany()
        if not chunk:
            if journal.done:
                return
            raise StreamBroken("upstream closed before [DONE]")
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            frame += b"\n\n"
            before = journal.offset
            if journal.admit_frame(frame):
                if span is not None and not saw_token \
                        and journal.offset > before:
                    saw_token = True
                    span.add_event("first_token", offset=before)
                try:
                    await resp.write(frame)
                except (ConnectionResetError, OSError) as e:
                    raise ClientGone(str(e) or type(e).__name__) from e
        if journal.done:
            return


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
