"""Request-lifecycle contract shared by every hop: header names, SLO
classes and deadlines (port of ``llm_d_tpu.utils.lifecycle``).

The gateway, EPP, sidecar and simulator of the JAX package speak this
contract to every model-server replica, so the port's server must read
and write exactly these headers:

  x-llmd-deadline-ms     relative latency budget in ms (client-facing);
                         the OpenAI-body ``timeout`` field (seconds) is
                         an accepted alias.
  x-llmd-deadline        ABSOLUTE unix-epoch deadline in seconds, stamped
                         by the first hop that sees a relative budget and
                         propagated verbatim after that.
  x-llmd-deadline-exceeded  response marker on the 504 of a request
                         refused or evicted because its deadline passed.
  x-llmd-criticality     SLO class: critical | standard | sheddable (body
                         field ``criticality`` is the alias).
  x-llmd-draining        response marker: the replica is draining.
  x-llmd-sched-depth     response header: the replica's scheduler depth
                         (waiting + running).
  x-request-id           the request's correlation id, minted by the
                         first hop and propagated verbatim.

The other names (tenant, retry, prefill hint, placement, resume, trace)
are carried here too so that the two packages name one contract.

Criticality maps to priority tiers for the scheduler's ``(priority,
arrival)`` order and preemption: critical outranks standard outranks
sheddable.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

CRITICALITY_HEADER = "x-llmd-criticality"
TENANT_HEADER = "x-llmd-tenant"
DEADLINE_MS_HEADER = "x-llmd-deadline-ms"
DEADLINE_ABS_HEADER = "x-llmd-deadline"
DEADLINE_EXCEEDED_HEADER = "x-llmd-deadline-exceeded"
DRAINING_HEADER = "x-llmd-draining"
SCHED_DEPTH_HEADER = "x-llmd-sched-depth"
RETRY_ATTEMPT_HEADER = "x-llmd-retry-attempt"
RETRY_BUDGET_HEADER = "x-llmd-retry-budget"
PREFILLER_HEADER = "x-prefiller-host-port"
KV_PLACEMENT_HEADER = "x-llmd-kv-placement"
PREFILL_FALLBACK_HEADER = "x-llmd-prefill-fallback"
RESUME_OFFSET_HEADER = "x-llmd-resume-offset"
RESUME_ATTEMPT_HEADER = "x-llmd-resume-attempt"
REQUEST_ID_HEADER = "x-request-id"
TRACEPARENT_HEADER = "traceparent"
TRACE_ID_HEADER = "x-llmd-trace-id"
TRACE_PARENT_HEADER = "x-llmd-trace-parent"
TRACE_SAMPLED_HEADER = "x-llmd-trace-sampled"

CRITICALITY_CRITICAL = "critical"
CRITICALITY_STANDARD = "standard"
CRITICALITY_SHEDDABLE = "sheddable"
CRITICALITIES = (CRITICALITY_CRITICAL, CRITICALITY_STANDARD,
                 CRITICALITY_SHEDDABLE)

# Engine-side tier per class (lower = scheduled first, preempted last).
CRITICALITY_TIERS = {
    CRITICALITY_CRITICAL: -1,
    CRITICALITY_STANDARD: 0,
    CRITICALITY_SHEDDABLE: 1,
}


def parse_criticality(headers: Dict[str, str],
                      body: Optional[Dict[str, Any]] = None) -> str:
    """Criticality class from lowercased headers / body; default standard.

    Raises ValueError on an unknown class: a typo'd criticality must
    surface as a 400, not silently serve at the wrong tier."""
    raw = headers.get(CRITICALITY_HEADER)
    if raw is None and body is not None:
        raw = body.get("criticality")
    if raw is None or raw == "":
        return CRITICALITY_STANDARD
    value = str(raw).strip().lower()
    if value not in CRITICALITIES:
        raise ValueError(
            f"unknown criticality {raw!r} (expected one of "
            f"{'/'.join(CRITICALITIES)})")
    return value


def parse_deadline(headers: Dict[str, str],
                   body: Optional[Dict[str, Any]] = None,
                   now: Optional[float] = None) -> Optional[float]:
    """Absolute unix-epoch deadline for this request, or None.

    An already-propagated absolute header wins (later hops must not
    re-base it), then the relative ms header, then the OpenAI-body
    ``timeout`` seconds alias.  Raises ValueError on a malformed or
    non-positive budget (client error -> 400)."""
    raw_abs = headers.get(DEADLINE_ABS_HEADER)
    if raw_abs is not None:
        try:
            return float(raw_abs)
        except (TypeError, ValueError) as e:
            raise ValueError(f"invalid {DEADLINE_ABS_HEADER}: {raw_abs!r}") \
                from e
    raw_ms = headers.get(DEADLINE_MS_HEADER)
    if raw_ms is None and body is not None:
        timeout = body.get("timeout")
        if timeout is not None:
            try:
                raw_ms = float(timeout) * 1000.0
            except (TypeError, ValueError) as e:
                raise ValueError(f"invalid timeout: {timeout!r}") from e
    if raw_ms is None:
        return None
    try:
        budget_ms = float(raw_ms)
    except (TypeError, ValueError) as e:
        raise ValueError(f"invalid {DEADLINE_MS_HEADER}: {raw_ms!r}") from e
    if budget_ms <= 0:
        raise ValueError(f"deadline budget must be > 0, got {budget_ms}")
    return (now if now is not None else time.time()) + budget_ms / 1000.0


def remaining_s(deadline_epoch: Optional[float],
                now: Optional[float] = None) -> Optional[float]:
    """Seconds left until an epoch deadline (may be negative); None when
    there is none."""
    if deadline_epoch is None:
        return None
    return deadline_epoch - (now if now is not None else time.time())
