"""Continuous-batching scheduler with chunked prefill and preemption.

One scheduler invocation composes a mixed prefill+decode step under a token
budget — the engine-side half of what the reference gets from vLLM's
scheduler (continuous batching, chunked prefill, recompute-preemption).
Unified steps (prefills and decodes in one batch) keep the TPU busy with
large matmuls while decode latency stays bounded by the token budget.

Scheduling policy: running requests first (decode steps starve last),
then waiting requests FIFO by (criticality tier, priority, arrival).  On
block exhaustion the most recently added running request in the lowest
SLO class is preempted and recomputed later (sheddable before standard
before critical; metric: ``vllm:num_preemptions_total``).

Lifecycle: requests carry an optional absolute deadline.  Every
``schedule()`` pass first expires deadlines — queued requests whose
budget passed are refused, running ones are evicted at the step boundary
— and frees their KV blocks the same step (the server renders the 504).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from llm_d_tpu_torch.engine.kv_cache import KVCacheManager
from llm_d_tpu_torch.engine.request import Request, RequestState


@dataclasses.dataclass
class ScheduledRequest:
    request: Request
    num_new_tokens: int           # tokens computed this step
    is_first_schedule: bool = False
    # Speculative decode: draft tokens scheduled ON TOP of num_new_tokens
    # for this decode entry (KV blocks already allocated to cover them;
    # the engine's draft+verify program appends up to this many extra
    # tokens and rolls the rejected tail's blocks back the same step).
    num_draft_tokens: int = 0


@dataclasses.dataclass
class SchedulerOutput:
    scheduled: List[ScheduledRequest]
    preempted: List[Request]
    total_tokens: int
    # Step composition under decode-priority budgeting: decode entries'
    # mandatory tokens, their speculative draft tokens (on top), and
    # prefill-chunk tokens.  total_tokens == decode + prefill; the engine
    # feeds these to the step span, the step-composition counters and the
    # step-latency model without recomputing them from the rows.
    decode_tokens: int = 0
    spec_tokens: int = 0
    prefill_tokens: int = 0

    @property
    def empty(self) -> bool:
        return not self.scheduled


class Scheduler:
    def __init__(
        self,
        kv: KVCacheManager,
        max_num_seqs: int = 64,
        max_num_batched_tokens: int = 1024,
        max_model_len: int = 32000,
    ) -> None:
        self.kv = kv
        self.max_num_seqs = max_num_seqs
        self.max_num_batched_tokens = max_num_batched_tokens
        self.max_model_len = max_model_len
        # The clock deadlines are read against: the ranks of a mesh all
        # read rank 0's, so they expire the same requests on the same step.
        self.clock = time.monotonic
        self.waiting: collections.deque[Request] = collections.deque()
        self.running: List[Request] = []
        self.num_preemptions = 0
        self.num_deadline_evictions = 0
        # Blocks held outside the scheduler (e.g. PD producer pins awaiting a
        # remote pull). While any exist, a stalled sole-running request waits
        # for their asynchronous release instead of being aborted.
        self.external_pinned_blocks = lambda: 0
        # Speculative decode (set by the engine when spec decode is on):
        # callable(Request) -> draft tokens to schedule for this decode
        # entry.  Draft tokens are budgeted like real tokens and their KV
        # blocks allocated up front, but they are strictly opportunistic —
        # the allocation shrinks to the free pool (never preempts: evicting
        # real work for speculative capacity would be a net loss) and the
        # engine rolls the rejected tail back after verification.
        self.spec_lookahead: Optional[Callable[[Request], int]] = None
        # Decode-priority chunk budgeting (set by the engine): callable
        # (decode_tokens_funded) -> per-chunk prefill token cap for this
        # pass, or None for "budget-bound only" (the historical behavior).
        # Called AFTER decode entries are funded, so an adaptive policy can
        # size prefill chunks to the decode load actually in the step.
        self.prefill_chunk_cap: Optional[
            Callable[[int], Optional[int]]] = None
        # Composition of the most recent schedule() pass (tests and the
        # engine's observability read this without re-deriving it).
        self.last_schedule_stats: Dict[str, int] = {}

    # ---------- queue ops ----------

    def add_request(self, request: Request) -> None:
        request.state = RequestState.WAITING
        self.waiting.append(request)

    def abort_request(self, request_id: str) -> Optional[Request]:
        for q in (self.waiting, self.running):
            for r in list(q):
                if r.request_id == request_id:
                    q.remove(r)
                    r.state = RequestState.FINISHED_ABORTED
                    self.kv.free(r)
                    return r
        return None

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ---------- core ----------

    def _preempt_for(self, needy: Request, preempted_now: set,
                     scheduled_ids: set) -> bool:
        """Preempt the most recent running request in the LOWEST SLO class
        other than ``needy`` (sheddable victims before standard before
        critical; most-recent-first within a class, so the class tiers
        only reorder — the historical recency policy is the tie-break).

        Requests already scheduled in this pass are not eligible victims:
        freeing their blocks after they were appended to ``scheduled`` would
        corrupt the batch the engine is about to build.  With KV regions
        (SPMD dp) only same-region victims help — freeing a foreign shard's
        blocks cannot satisfy ``needy``'s allocation.
        """
        region = self.kv.region_of_request(needy)
        # Stable sort over reversed(running): most-recent-first within each
        # tier, tiers from sheddable down to critical.
        victims = sorted(reversed(self.running), key=lambda r: -r.slo_tier)
        for victim in victims:
            if victim is needy or victim.request_id in scheduled_ids:
                continue
            if self.kv.num_regions > 1 \
                    and self.kv.region_of_request(victim) != region:
                continue
            self.running.remove(victim)
            self.kv.free(victim)
            victim.num_computed_tokens = 0
            victim.num_preemptions += 1
            victim.state = RequestState.PREEMPTED
            self.waiting.appendleft(victim)
            preempted_now.add(victim.request_id)
            self.num_preemptions += 1
            return True
        return False

    def _expire_deadlines(self, expired_out: List[Request]) -> None:
        """Refuse queued requests and evict running ones whose deadline
        passed; their KV blocks return to the pool THIS step (a request
        that already blew its budget must not keep burning TPU steps and
        cache).  Evicted requests finish with state FINISHED_DEADLINE —
        the engine surfaces them as outputs and the server maps them to
        504 + x-llmd-deadline-exceeded."""
        now = self.clock()
        for q in (self.waiting, self.running):
            for req in [r for r in list(q) if r.deadline_expired(now)]:
                q.remove(req)
                self.kv.free(req)
                req.state = RequestState.FINISHED_DEADLINE
                self.num_deadline_evictions += 1
                expired_out.append(req)

    def _schedule_running(self, req: Request, budget: int,
                          cap: Optional[int],
                          scheduled: List[ScheduledRequest],
                          preempted: List[Request],
                          preempted_now: set,
                          scheduled_ids: set) -> Tuple[int, int]:
        """Fund one running request (decode entry or in-flight prefill
        chunk) out of ``budget``; returns ``(n, spec_n)`` actually
        scheduled (``(0, 0)`` when nothing fit).  Only what is returned
        may be charged to the budget — a request that bails leaves its
        slack for later chunks (budget conservation)."""
        remaining = req.num_tokens - req.num_computed_tokens
        if remaining <= 0:
            remaining = 1       # decode: compute the next token's KV
        n = min(remaining, budget)
        if cap is not None:
            n = min(n, max(int(cap), 1))
        # Terminal path: a request whose block demand exceeds the whole
        # pool can never run — fail it instead of livelocking with n=0
        # forever (has_work() true, no progress, no client error).
        needed = -(-(req.num_computed_tokens + n) // self.kv.block_size)
        if needed > self.kv.max_request_blocks:
            self.running.remove(req)
            self.kv.free(req)
            req.state = RequestState.FINISHED_ABORTED
            preempted.append(req)
            return 0, 0
        while True:
            ok = self.kv.allocate(req, req.num_computed_tokens + n)
            if ok is not None:
                break
            if self._preempt_for(req, preempted_now, scheduled_ids):
                continue
            # Nothing to preempt: shrink the chunk to the blocks that are
            # actually free so mid-prefill requests keep making progress
            # (partial pools must not stall the pass).
            fit = ((len(req.block_ids) + self.kv.region_free_blocks(
                self.kv.region_of_request(req)))
                * self.kv.block_size) - req.num_computed_tokens
            if fit >= n:
                # Bookkeeping race (free-list vs region accounting, e.g.
                # blocks parked in the evictor): the pool claims ``n``
                # fits but allocate refused.  Shrink by one block and
                # retry instead of dropping the whole chunk — strictly
                # decreasing, so the loop terminates, and the tokens this
                # request ends up not using were never charged, so they
                # remain in the budget for later prefill chunks.
                fit = n - self.kv.block_size
            n = max(fit, 0)
            if n <= 0:
                break
        if n <= 0:
            # Nothing schedulable and nothing preemptable: if no other
            # request holds reclaimable blocks this will never resolve —
            # unless blocks are pinned outside the scheduler (PD transfer
            # in flight), whose async release will unblock us.
            if not scheduled and len(self.running) == 1 \
                    and not self.kv.can_allocate(
                        1, self.kv.region_of_request(req)) \
                    and self.external_pinned_blocks() == 0:
                self.running.remove(req)
                self.kv.free(req)
                req.state = RequestState.FINISHED_ABORTED
                preempted.append(req)
            return 0, 0
        spec_n = 0
        if (self.spec_lookahead is not None and n == 1
                and req.num_computed_tokens == req.num_tokens - 1):
            # Decode entry under spec decode: schedule up to K draft
            # tokens on top of the mandatory one.  Drafts pay token
            # budget like real compute and shrink to the free block
            # pool — speculation never preempts or blocks real work.
            spec_n = min(max(0, int(self.spec_lookahead(req))),
                         budget - n)
            while spec_n > 0 and self.kv.allocate(
                    req, req.num_computed_tokens + n + spec_n) is None:
                spec_n -= 1
        scheduled.append(ScheduledRequest(req, n, num_draft_tokens=spec_n))
        scheduled_ids.add(req.request_id)
        return n, spec_n

    def schedule(self) -> SchedulerOutput:
        scheduled: List[ScheduledRequest] = []
        preempted: List[Request] = []
        self._expire_deadlines(preempted)
        budget = self.max_num_batched_tokens
        # Requests preempted during this pass are not re-admitted in the same
        # step: re-admission would recreate the memory pressure that forced
        # the preemption (thrash).
        preempted_now: set = set()
        scheduled_ids: set = set()
        decode_tokens = spec_tokens = prefill_tokens = 0

        # 1. Decode entries first (decode-priority budgeting): every
        # in-flight stream's next token — plus its speculative lookahead —
        # is funded before ANY prefill chunk sees the budget, so a large
        # chunk can never push a decode out of the step and stall TPOT.
        # A decode entry has emitted output and only its last token's KV
        # left to compute (the engine's per-row is_decode predicate);
        # everything else running is an in-flight prefill chunk.
        running = list(self.running)

        def is_decode(r):
            return (bool(r.output_token_ids)
                    and r.num_tokens - r.num_computed_tokens <= 1
                    and not r.do_remote_decode)

        decodes = [r for r in running if is_decode(r)]
        chunks = [r for r in running if not is_decode(r)]
        for req in decodes:
            if budget <= 0:
                break
            if req.request_id in preempted_now:
                continue        # evicted by an earlier request in this pass
            n, spec_n = self._schedule_running(
                req, budget, None, scheduled, preempted,
                preempted_now, scheduled_ids)
            budget -= n + spec_n
            decode_tokens += n
            spec_tokens += spec_n

        # 2. In-flight chunked prefills spend what the decodes left,
        # per-chunk-capped by the engine's policy (fixed LLMD_PREFILL_CHUNK
        # or the step-latency model sized against the funded decode load).
        cap: Optional[int] = None
        if self.prefill_chunk_cap is not None:
            cap = self.prefill_chunk_cap(decode_tokens + spec_tokens)
        for req in chunks:
            if budget <= 0:
                break
            if req.request_id in preempted_now:
                continue
            n, _ = self._schedule_running(
                req, budget, cap, scheduled, preempted,
                preempted_now, scheduled_ids)
            budget -= n
            prefill_tokens += n

        # 3. Waiting requests, FIFO within (criticality tier, priority)
        # (lower value = more important, matching InferenceObjective; the
        # SLO class is the outer tier, per-request priority the inner).
        pending = sorted(self.waiting,
                         key=lambda r: (r.slo_tier, r.priority,
                                        r.arrival_time))
        for req in pending:
            if budget <= 0 or len(self.running) >= self.max_num_seqs:
                break
            if req.request_id in preempted_now:
                continue
            if req.num_tokens >= self.max_model_len:
                # Oversized prompt: refuse by finishing with length.
                self.waiting.remove(req)
                req.state = RequestState.FINISHED_LENGTH
                preempted.append(req)
                continue
            first = req.num_computed_tokens == 0 and not req.block_ids
            reuse: List[int] = []
            if first:
                reuse, n_cached = self.kv.find_cached_prefix(req)
                if req.do_remote_prefill:
                    # PD consumer: KV arrives via the connector; only the
                    # last prompt token is computed locally.
                    reuse, n_cached = [], 0
                req.num_computed_tokens = n_cached
                # Metrics see prompt-region hits only; a resume admission
                # may restore past the prompt into the generated region —
                # that surplus is the restored-vs-recomputed signal.
                req.num_cached_prompt_tokens = min(
                    n_cached, req.num_prompt_tokens)
                if req.resume_offset:
                    req.resume_restored_tokens = max(
                        0, n_cached - req.num_prompt_tokens)
            remaining = req.num_tokens - req.num_computed_tokens
            n = min(remaining, budget)
            if cap is not None:
                # First chunks obey the same per-chunk cap as running ones.
                n = min(n, max(int(cap), 1))
            if n <= 0:
                continue
            ok = self.kv.allocate(req, req.num_computed_tokens + n, reuse)
            if ok is None:
                req.num_computed_tokens = 0
                # First chunk alone exceeding the whole pool can never be
                # admitted — fail it rather than blocking the queue forever.
                if -(-n // self.kv.block_size) > self.kv.max_request_blocks:
                    self.waiting.remove(req)
                    req.state = RequestState.FINISHED_ABORTED
                    preempted.append(req)
                    continue
                # Drop the region pin (SPMD dp): prefix affinity must not
                # pin the queue head to one full region while others idle —
                # the next pass re-assigns by capacity.
                self.kv.unpin(req)
                break               # head-of-line: don't skip ahead of FIFO
            self.waiting.remove(req)
            self.running.append(req)
            req.state = RequestState.RUNNING
            budget -= n
            prefill_tokens += n
            scheduled.append(ScheduledRequest(req, n, is_first_schedule=first))

        self.last_schedule_stats = {
            "decode_tokens": decode_tokens,
            "spec_tokens": spec_tokens,
            "prefill_tokens": prefill_tokens,
            "chunk_cap": -1 if cap is None else int(cap),
            "budget_left": budget,
        }
        return SchedulerOutput(
            scheduled=scheduled, preempted=preempted,
            total_tokens=sum(s.num_new_tokens for s in scheduled),
            decode_tokens=decode_tokens, spec_tokens=spec_tokens,
            prefill_tokens=prefill_tokens)

    def finish(self, request: Request, state: RequestState) -> None:
        request.state = state
        if request in self.running:
            self.running.remove(request)
        self.kv.free(request)
