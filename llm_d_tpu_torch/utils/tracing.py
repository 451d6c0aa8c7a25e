"""llmd-trace: zero-dependency request tracing across every hop (port of
``llm_d_tpu.utils.tracing``, which holds no JAX code).

The stack's observability was metrics-first (aggregate ``llmd_tpu:*``
histograms), but the open ROADMAP items all need *per-request causal
timelines*: the PD-disagg TTFT bar decomposes into prefill vs KV-wire
vs first-decode-token, per-tenant SLO scoring needs per-request phase
records, and chaos runs need the fault -> retry -> resume chain to be
causally explainable.  P/D-Serve (arxiv 2408.08147) makes fine-grained
per-phase monitoring the operating prerequisite for disaggregated
serving at scale; this module is that layer, stdlib-only so every
component (gateway, EPP ext_proc, sidecar, model server, engine,
connector, simulator, load tool) can afford it.

Model (a deliberately tiny OpenTelemetry subset):

  - a **trace** is one request's end-to-end story, identified by a
    32-hex trace id.  The root hop SEEDS the trace id from the request's
    ``x-request-id`` (sha256), so log lines and traces join on one key
    with no lookup table.
  - a **span** is one timed operation inside a trace: 16-hex span id,
    parent span id (None = root), component, name, start epoch ``ts``,
    duration ``dur``, free-form ``attrs``, and point-in-time ``events``
    (fault-point firings, retries, resume attempts, breaker
    transitions, ``first_token``).
  - spans whose ``attrs["phase"]`` is one of :data:`PHASES` are the
    TTFT/TPOT attribution surface: ``scripts/trace_report.py`` folds
    them into per-request waterfalls and per-phase p50/p99 tables, and
    call sites mirror each phase into the
    ``llmd_tpu:request_phase_seconds{phase,criticality}`` histogram
    (``utils/metrics.py``) so Prometheus/Grafana see the same numbers.

Propagation: ``traceparent`` (W3C) plus the pinned ``x-llmd-trace-*``
headers from :mod:`llm_d_tpu_torch.utils.lifecycle` — both emitted, either
accepted.  The sampling verdict rides the headers AND is derivable from
the trace id alone (deterministic hash vs ``LLMD_TRACE_SAMPLE``), so
every component reaches the same verdict even if the flag header is
dropped by a middlebox.

Collection: per-component ring buffers (``LLMD_TRACE_BUFFER`` spans,
oldest evicted) exported as JSONL — ``Tracer.export_jsonl`` /
:func:`export_all_jsonl` — or scraped live from the ``/debug/traces``
endpoint the gateway / model server / simulator expose.

Knobs (docs/ENVVARS.md): ``LLMD_TRACE`` (master switch),
``LLMD_TRACE_SAMPLE`` (per-trace sampling fraction),
``LLMD_TRACE_BUFFER`` (ring capacity per component tracer).

Engine-safety contract: every API here is host-side Python (clock reads,
dict/deque ops) — recording a span can NEVER introduce a device sync,
so the jit hot loop stays green under the JIT llmd-check pass (the
tracing guard in ``tests/test_tracing.py`` pins this).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Union

from llm_d_tpu_torch.utils.config import env_float, env_int
from llm_d_tpu_torch.utils.lifecycle import (
    TRACE_ID_HEADER,
    TRACE_PARENT_HEADER,
    TRACE_SAMPLED_HEADER,
    TRACEPARENT_HEADER,
)

# Canonical phase vocabulary for the TTFT/TPOT decomposition (the report
# and the request_phase_seconds histogram both key on these):
#   queue        waiting for admission (gateway flow control, engine /
#                sim scheduler queue)
#   schedule     the EPP scheduling decision (plugin pipeline)
#   prefill      prompt (or prompt+generated resume) KV computation
#   transfer     P->D KV wire pull (the NetKV term)
#   first_decode prefill-complete -> first decode token (PD consumer's
#                last-token recompute; ~0 on a fused local prefill)
#   decode       first token -> last token (TPOT region)
#   resume       mid-stream break detection -> first resumed token
PHASES = ("queue", "schedule", "prefill", "transfer", "first_decode",
          "decode", "resume")


def trace_enabled() -> bool:
    """Master switch, re-read per call so operators can flip a live
    process (the resume_policy doctrine)."""
    return env_int("LLMD_TRACE", 1) != 0


def sample_rate() -> float:
    rate = env_float("LLMD_TRACE_SAMPLE", 1.0)
    return min(max(rate, 0.0), 1.0)


def trace_id_from_request_id(request_id: str) -> str:
    """Deterministic 32-hex trace id seeded from the request id — the
    join key between log lines (which carry x-request-id) and traces."""
    return hashlib.sha256(request_id.encode()).hexdigest()[:32]


def _new_trace_id() -> str:
    return uuid.uuid4().hex


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def _id_sampled(trace_id: str, rate: float) -> bool:
    """Deterministic per-trace sampling verdict: every component reaches
    the same answer from the id alone (no coordination, no RNG drift)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        frac = int(trace_id[:8], 16) / float(0x100000000)
    except ValueError:
        return True
    return frac < rate


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagated identity: (trace id, sending span id, verdict)."""
    trace_id: str
    span_id: str
    sampled: bool = True

    def to_headers(self) -> Dict[str, str]:
        flag = "01" if self.sampled else "00"
        return {
            TRACEPARENT_HEADER:
                f"00-{self.trace_id}-{self.span_id}-{flag}",
            TRACE_ID_HEADER: self.trace_id,
            TRACE_PARENT_HEADER: self.span_id,
            TRACE_SAMPLED_HEADER: "1" if self.sampled else "0",
        }


def parse_trace_headers(headers: Dict[str, str]) -> Optional[TraceContext]:
    """TraceContext from lowercased request headers, or None when the
    request carries no trace (this hop becomes the root).  The pinned
    ``x-llmd-trace-*`` trio wins over ``traceparent`` when both are
    present (ours is what upstream llmd hops emit)."""
    tid = headers.get(TRACE_ID_HEADER)
    if tid:
        parent = headers.get(TRACE_PARENT_HEADER, "")
        sampled = headers.get(TRACE_SAMPLED_HEADER, "1") != "0"
        return TraceContext(tid, parent, sampled)
    tp = headers.get(TRACEPARENT_HEADER)
    if tp:
        parts = tp.split("-")
        if len(parts) >= 4 and len(parts[1]) == 32 and len(parts[2]) == 16:
            return TraceContext(parts[1], parts[2],
                                sampled=parts[3][-1:] != "0")
    return None


def trace_headers(ctx: Optional[TraceContext]) -> Dict[str, str]:
    """Headers to forward for ``ctx`` (empty when tracing is off)."""
    if ctx is None:
        return {}
    return ctx.to_headers()


class Span:
    """One timed operation.  Context-manager friendly::

        with tracer.start_span("gateway.schedule", parent=root) as sp:
            sp.set(endpoint=addr)
            sp.add_event("retry", reason="5xx")

    An UNSAMPLED span keeps full id/ctx plumbing (so downstream hops see
    a consistent verdict) but records nothing.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "component",
                 "ts", "dur", "attrs", "events", "sampled", "_tracer",
                 "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str], sampled: bool,
                 ts: Optional[float] = None, **attrs: Any) -> None:
        self._tracer = tracer
        self.name = name
        self.component = tracer.component
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.sampled = sampled
        self.ts = time.time() if ts is None else ts
        self.dur: Optional[float] = None
        self.attrs: Dict[str, Any] = {k: v for k, v in attrs.items()
                                      if v is not None}
        self.events: List[Dict[str, Any]] = []
        self._ended = False

    # ---------- recording ----------

    def set(self, **attrs: Any) -> "Span":
        if self.sampled:
            self.attrs.update(
                {k: v for k, v in attrs.items() if v is not None})
        return self

    def add_event(self, name: str, **attrs: Any) -> "Span":
        if self.sampled:
            ev = {"ts": time.time(), "name": name}
            ev.update({k: v for k, v in attrs.items() if v is not None})
            self.events.append(ev)
        return self

    def end(self, ts: Optional[float] = None, **attrs: Any) -> "Span":
        """Close and record the span (idempotent)."""
        if self._ended:
            return self
        self._ended = True
        self.dur = max(0.0, (time.time() if ts is None else ts) - self.ts)
        if self.sampled:
            self.attrs.update(
                {k: v for k, v in attrs.items() if v is not None})
            self._tracer._record(self)
        return self

    # ---------- propagation ----------

    def ctx(self) -> TraceContext:
        """Context for children / downstream hops (parent = this span)."""
        return TraceContext(self.trace_id, self.span_id, self.sampled)

    # ---------- plumbing ----------

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.set(error=f"{type(exc).__name__}: {exc}")
        self.end()
        return False

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "trace": self.trace_id, "span": self.span_id,
            "parent": self.parent_id, "component": self.component,
            "name": self.name, "ts": round(self.ts, 6),
            "dur": round(self.dur, 6) if self.dur is not None else None,
        }
        if self.attrs:
            out["attrs"] = self.attrs
        if self.events:
            out["events"] = self.events
        return out


ParentLike = Union[TraceContext, Span, None]


def _resolve_parent(parent: ParentLike) -> Optional[TraceContext]:
    if parent is None:
        return None
    if isinstance(parent, Span):
        return parent.ctx()
    return parent


class Tracer:
    """Per-component span factory + bounded ring collector.

    The ring (``LLMD_TRACE_BUFFER`` finished spans, oldest evicted) makes
    tracing always-on affordable: a multi-day soak holds a bounded
    window, and tests / the load tool drain it after the interval they
    care about.  Thread-safe: the engine records from its thread while
    an aiohttp handler snapshots."""

    def __init__(self, component: str,
                 capacity: Optional[int] = None) -> None:
        self.component = component
        self.capacity = (capacity if capacity is not None
                         else env_int("LLMD_TRACE_BUFFER", 2048))
        self._spans: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=max(1, self.capacity)))
        self._lock = threading.Lock()
        self.recorded = 0       # lifetime count (ring may have evicted)

    # ---------- span factories ----------

    def start_span(self, name: str, parent: ParentLike = None,
                   request_id: Optional[str] = None,
                   trace_id: Optional[str] = None,
                   ts: Optional[float] = None,
                   sampled: Optional[bool] = None, **attrs: Any) -> Span:
        """Open a span.  Root resolution: an explicit ``trace_id`` wins,
        then the parent's trace, then a trace id SEEDED from
        ``request_id``, then a random one.  The sampling verdict is an
        explicit ``sampled`` override when given, else the parent's when
        inherited, else the deterministic id hash vs
        ``LLMD_TRACE_SAMPLE``; ``LLMD_TRACE=0`` force-unsamples."""
        pctx = _resolve_parent(parent)
        if trace_id is None:
            if pctx is not None:
                trace_id = pctx.trace_id
            elif request_id:
                trace_id = trace_id_from_request_id(request_id)
            else:
                trace_id = _new_trace_id()
        if not trace_enabled():
            verdict = False
        elif sampled is not None:
            verdict = sampled
        elif pctx is not None:
            verdict = pctx.sampled
        else:
            verdict = _id_sampled(trace_id, sample_rate())
        return Span(self, name, trace_id,
                    pctx.span_id if pctx is not None else None,
                    verdict, ts=ts, request_id=request_id, **attrs)

    def record_span(self, name: str, start: float, end: float,
                    parent: ParentLike = None,
                    request_id: Optional[str] = None,
                    trace_id: Optional[str] = None,
                    **attrs: Any) -> Span:
        """Retroactive span from already-measured epoch timestamps — the
        engine's step-boundary idiom: measure with plain clock reads on
        the hot path, materialize the span outside it."""
        span = self.start_span(name, parent=parent, request_id=request_id,
                               trace_id=trace_id, ts=start, **attrs)
        span.end(ts=end)
        return span

    def event_span(self, name: str, parent: ParentLike = None,
                   **attrs: Any) -> Span:
        """Zero-duration annotation span (breaker transitions, fault
        firings without a request span in reach).  UNPARENTED events
        bypass per-trace sampling: they are rare component-level facts —
        the chaos backstop — and must record whenever tracing is on,
        not vanish on a random fresh trace id's hash."""
        span = self.start_span(
            name, parent=parent, kind="event",
            sampled=(True if _resolve_parent(parent) is None else None),
            **attrs)
        span.end(ts=span.ts)
        return span

    # ---------- collection ----------

    def _record(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            self._spans.append(d)
            self.recorded += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def export_jsonl(self, path: str, drain: bool = False) -> int:
        spans = self.drain() if drain else self.snapshot()
        with open(path, "a") as f:
            for d in spans:
                f.write(json.dumps(d) + "\n")
        return len(spans)


# ---------------------------------------------------------------------------
# Process-global tracer registry.  One tracer per component name; a test
# process hosting a whole sim stack (gateway + 8 sims + relays) exports
# everything in one call.
# ---------------------------------------------------------------------------

_tracers: Dict[str, Tracer] = {}
_registry_lock = threading.Lock()


def get_tracer(component: str) -> Tracer:
    t = _tracers.get(component)
    if t is None:
        with _registry_lock:
            t = _tracers.get(component)
            if t is None:
                t = _tracers[component] = Tracer(component)
    return t


def all_tracers() -> Dict[str, Tracer]:
    with _registry_lock:
        return dict(_tracers)


def snapshot_all() -> List[Dict[str, Any]]:
    """Every component's live ring, merged (the /debug/traces payload)."""
    out: List[Dict[str, Any]] = []
    for t in all_tracers().values():
        out.extend(t.snapshot())
    return out


def export_all_jsonl(path: str, drain: bool = False) -> int:
    n = 0
    for t in all_tracers().values():
        n += t.export_jsonl(path, drain=drain)
    return n


def render_jsonl(spans: Iterable[Dict[str, Any]]) -> str:
    return "".join(json.dumps(d) + "\n" for d in spans)


def trace_event(component: str, name: str, parent: ParentLike = None,
                **attrs: Any) -> None:
    """Fire-and-forget annotation: record an instantaneous event span on
    ``component``'s tracer.  Cheap no-op when tracing is off; a parented
    call inherits the parent's sampling verdict, an unparented one (rare
    component-level facts: breaker flips, fault firings seen outside any
    request span) records whenever tracing is on."""
    if not trace_enabled():
        return
    get_tracer(component).event_span(name, parent=parent, **attrs)


def reset() -> None:
    """Drop every registered tracer (tests)."""
    with _registry_lock:
        _tracers.clear()
