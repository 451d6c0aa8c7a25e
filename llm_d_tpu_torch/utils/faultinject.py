"""Deterministic fault injection for the serving path (port of
``llm_d_tpu.utils.faultinject``, which holds no JAX code).

The reference stack's failure story is K8s-native (probes, restart
semantics, ``kv_load_failure_policy``) plus a load script that *generates*
error traffic; nothing exercises the in-process failure paths on demand.
This module is the missing half: every cross-process hop declares a named
**fault point**, and an operator / test installs **rules** — probability,
fire count, latency, endpoint match — that make the hop fail or stall
deterministically (seeded RNG per point, so the same seed reproduces the
same fault sequence; P/D-Serve-style chaos runs become regression tests).

Fault-point catalog (see docs/resilience.md):

  ``sidecar.prefill``   sidecar -> prefill HTTP post (proxy.py)
  ``gateway.forward``   gateway -> decode replica forward (epp/service.py)
  ``stream.relay``      mid-stream gateway -> backend relay frame
                        (server/stream_resume.py) — a connection that
                        drops AFTER response bytes were committed,
                        distinct from ``engine.step`` death
  ``kv.pull``           TpuConnector consumer KV fetch (transfer/connector.py)
  ``kv.peer_fetch``     shared-tier peer block fetch (engine/offload.py)
  ``kv.restore``        host/shared-tier block restore during (resume)
                        admission (engine/offload.py) — a fired fault is
                        a tier miss: the request recomputes instead
  ``engine.step``       engine step — simulated engine death (engine.py)
  ``cluster.partition`` cluster-sim virtual network link (sim/cluster.py)
                        — keyed ``src->dst``, so ``match=`` expresses a
                        directed P↔D or zone partition
  ``cluster.zone_kill`` cluster-sim correlated zone/gang kill tick
                        (sim/cluster.py) — keyed by zone name; a fired
                        fault takes every replica in the zone down at
                        once
  ``cluster.straggler`` cluster-sim per-replica slowdown tick
                        (sim/cluster.py) — keyed by replica address; a
                        fired fault multiplies that replica's step time
                        (``LLMD_SIM_STRAGGLER_FACTOR``)

Rules come from code (tests: ``install(FaultInjector(...))``) or from the
environment (operators: ``LLMD_FAULTS`` + ``LLMD_FAULT_SEED``)::

    LLMD_FAULTS="kv.pull:p=0.3;gateway.forward:p=1,match=10.0.0.7:8200,count=5"

Spec grammar: ``point:field=value,...`` joined by ``;``.  Fields:

  ``p``       fire probability in [0,1]             (default 1.0)
  ``count``   max fires, then the rule is spent     (default unlimited)
  ``after``   skip the first N matching calls       (default 0)
  ``latency`` seconds to stall before deciding      (default 0)
  ``match``   substring the call key must contain   (default any)
  ``err``     label carried on the raised exception (default "injected")

A fired rule raises :class:`FaultInjected`; each call site catches it
alongside the hop's natural error classes, so the injected fault takes the
EXACT recovery path a real failure would.  A latency-only rule uses
``err=none``.  Malformed spec entries are dropped with a warning (the
invalid-value-fallback doctrine: a typo must not take down serving).

With no rules installed, ``check()``/``acheck()`` are a dict miss — safe on
the hot engine-step path.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# The catalog is advisory (unknown points still work — a test may probe a
# private hop), but spec parsing warns on typos against it.
FAULT_POINTS = (
    "sidecar.prefill",
    "gateway.forward",
    "stream.relay",
    "kv.pull",
    "kv.peer_fetch",
    "kv.restore",
    "engine.step",
    "cluster.partition",
    "cluster.zone_kill",
    "cluster.straggler",
)


class FaultInjected(Exception):
    """Raised by a fired fault rule at a fault point.

    Call sites catch this next to the hop's real failure classes (e.g.
    ``except (aiohttp.ClientError, FaultInjected)``) so injected faults
    traverse the same recovery code as genuine ones.
    """

    def __init__(self, point: str, key: str = "", label: str = "injected"):
        super().__init__(f"fault injected at {point}"
                         f"{f' (key={key})' if key else ''} [{label}]")
        self.point = point
        self.key = key
        self.label = label


class FaultRule:
    """One rule at one point; draws come from a per-rule seeded RNG."""

    def __init__(self, point: str, probability: float = 1.0,
                 count: Optional[int] = None, after: int = 0,
                 latency_s: float = 0.0, match: str = "",
                 label: str = "injected", seed: int = 0) -> None:
        self.point = point
        self.probability = probability
        self.count = count
        self.after = after
        self.latency_s = latency_s
        self.match = match
        self.label = label
        # Determinism: the draw sequence depends only on (seed, point,
        # rule params), never on wall clock or interleaving across points.
        self._rng = random.Random(f"{seed}:{point}:{match}:{label}")
        self.calls = 0          # matching calls seen
        self.fired = 0          # faults actually raised

    def decide(self, key: str) -> Tuple[bool, float]:
        """(fire?, latency_s) for this call.  Not thread-safe; the
        injector serializes access."""
        if self.match and self.match not in key:
            return False, 0.0
        self.calls += 1
        if self.calls <= self.after:
            return False, 0.0
        if self.count is not None and self.fired >= self.count:
            return False, 0.0
        # Draw even for latency-only rules so p= gates the stall too.
        if self.probability < 1.0 and self._rng.random() >= self.probability:
            return False, 0.0
        self.fired += 1
        return self.label != "none", self.latency_s


class FaultInjector:
    """Rule registry + the check API the fault points call."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._rules: Dict[str, List[FaultRule]] = {}
        self._lock = threading.Lock()
        # (point, key, call#) of recently fired faults, for reproducibility
        # assertions and post-mortem ("which fault hit request 17?").
        # Bounded: a multi-day soak under LLMD_FAULTS must not grow memory
        # linearly with fired faults.
        self.fired_log: "collections.deque[Tuple[str, str, int]]" = (
            collections.deque(maxlen=10000))

    # ---------- configuration ----------

    def add_rule(self, point: str, **kw) -> FaultRule:
        rule = FaultRule(point, seed=self.seed, **kw)
        self._rules.setdefault(point, []).append(rule)
        return rule

    def clear(self, point: Optional[str] = None) -> None:
        """Drop rules (one point, or all) — 'the fault clears'."""
        with self._lock:
            if point is None:
                self._rules.clear()
            else:
                self._rules.pop(point, None)

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for point, rules in self._rules.items():
                out[point] = {
                    "calls": sum(r.calls for r in rules),
                    "fired": sum(r.fired for r in rules)}
            return out

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        """Parse the ``LLMD_FAULTS`` grammar; malformed entries are skipped
        with a warning instead of failing the process."""
        inj = cls(seed=seed)
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            point, _, fields = entry.partition(":")
            point = point.strip()
            if point not in FAULT_POINTS:
                logger.warning("faultinject: unknown point %r (known: %s); "
                               "keeping it anyway", point,
                               ", ".join(FAULT_POINTS))
            kw: Dict[str, object] = {}
            bad = False
            for field in fields.split(","):
                field = field.strip()
                if not field:
                    continue
                k, _, v = field.partition("=")
                k, v = k.strip(), v.strip()
                try:
                    if k == "p":
                        kw["probability"] = float(v)
                    elif k == "count":
                        kw["count"] = int(v)
                    elif k == "after":
                        kw["after"] = int(v)
                    elif k == "latency":
                        kw["latency_s"] = float(v)
                    elif k == "match":
                        kw["match"] = v
                    elif k == "err":
                        kw["label"] = v
                    else:
                        raise ValueError(f"unknown field {k!r}")
                except ValueError as e:
                    logger.warning("faultinject: dropping rule %r (%s)",
                                   entry, e)
                    bad = True
                    break
            if not bad:
                inj.add_rule(point, **kw)
        return inj

    # ---------- the check API ----------

    def _decide(self, point: str, key: str) -> Tuple[bool, float, str]:
        with self._lock:
            rules = self._rules.get(point)
            if not rules:
                return False, 0.0, ""
            fire, latency, label = False, 0.0, ""
            for rule in rules:
                if fire and rule.label != "none":
                    # First firing error rule wins the call: later error
                    # rules must not spend their count/fired budget on a
                    # call whose fault they didn't raise.  Latency-only
                    # rules still compose (stall + error).
                    continue
                f, lat = rule.decide(key)
                latency = max(latency, lat)
                if f and not fire:
                    fire, label = True, rule.label
                    self.fired_log.append((point, key, rule.calls))
        if fire:
            # llmd-trace: every fired fault leaves a span event so a
            # chaos run's fault -> retry -> resume chain is causally
            # explainable from the trace alone (call sites add their own
            # request-parented events; this is the component-level
            # backstop that fires even where the exception propagates
            # out of span scope).  Emitted OUTSIDE the rule lock; lazy
            # import keeps the no-rules fast path import-free.
            from llm_d_tpu_torch.utils import tracing
            tracing.trace_event("fault", f"fault.{point}",
                                key=key, label=label)
        return fire, latency, label

    def check(self, point: str, key: str = "") -> None:
        """Sync fault point (engine thread / worker threads).  May sleep
        (injected latency) and may raise :class:`FaultInjected`.

        Async-aware: a latency rule firing on an EVENT-LOOP thread must
        not ``time.sleep`` — that stalls every other request on the
        component, so one injected 50 ms stall distorts the p99 of the
        whole chaos run.  Coroutine callers use :meth:`acheck` (which
        awaits the stall); if a sync call site turns out to run on the
        loop anyway, the stall is skipped with a warning instead of
        poisoning the loop."""
        if not self._rules:
            return
        fire, latency, label = self._decide(point, key)
        if latency > 0:
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                # Plain worker/engine thread: blocking is the point — the
                # injected stall mimics a slow peer or device.
                # llmd: ignore[ASYNC] thread-context only; loop-guarded
                time.sleep(latency)
            else:
                logger.warning(
                    "faultinject: latency rule at %s fired on an event-"
                    "loop thread; use 'await acheck()' — skipping the "
                    "%.3fs stall instead of blocking the loop",
                    point, latency)
        if fire:
            raise FaultInjected(point, key, label)

    async def acheck(self, point: str, key: str = "") -> None:
        """Async fault point (aiohttp handlers).  Never blocks the loop."""
        if not self._rules:
            return
        fire, latency, label = self._decide(point, key)
        if latency > 0:
            await asyncio.sleep(latency)
        if fire:
            raise FaultInjected(point, key, label)


# ---------------------------------------------------------------------------
# Process-global injector.  Default: built once from the environment
# (LLMD_FAULTS / LLMD_FAULT_SEED), empty when unset.  Tests install their
# own and reset() after.
# ---------------------------------------------------------------------------

_injector: Optional[FaultInjector] = None
_injector_lock = threading.Lock()


def _from_env() -> FaultInjector:
    spec = os.environ.get("LLMD_FAULTS", "")
    raw_seed = os.environ.get("LLMD_FAULT_SEED")
    try:
        seed = int(raw_seed) if raw_seed is not None else 0
    except ValueError:
        logger.warning("faultinject: invalid LLMD_FAULT_SEED=%r; using 0",
                       raw_seed)
        seed = 0
    if spec:
        logger.warning("faultinject: ACTIVE (LLMD_FAULTS=%r seed=%d) — "
                       "this process will inject faults", spec, seed)
    return FaultInjector.from_spec(spec, seed=seed)


def get_injector() -> FaultInjector:
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                _injector = _from_env()
    return _injector


def install(injector: FaultInjector) -> FaultInjector:
    """Replace the process-global injector (tests / chaos harnesses)."""
    global _injector
    with _injector_lock:
        _injector = injector
    return injector


def reset() -> None:
    """Back to the env-derived default (re-read on next use)."""
    global _injector
    with _injector_lock:
        _injector = None
