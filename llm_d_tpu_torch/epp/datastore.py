"""EPP datastore: endpoint registry + metrics scraper + circuit breakers
(port of ``llm_d_tpu.epp.datastore``).  The scrapes go over the
standard-library client (``server/http_client.py``); discovery runs the
synchronous resolvers of ``utils/discovery.py`` in an executor.

The reference EPP scrapes every candidate pod's ``/metrics`` and scores on
the ``vllm:*`` gauges (queue depth, KV utilization); the scrape loop is the
data source for the load-aware scorers (reference:
gaie-inference-scheduling/values.yaml:4-6 shows the metric-name wiring,
standalone values.yaml:118-181 the candidate-pod flow).

On top of the scraped view the datastore keeps a per-endpoint
:class:`EndpointBreaker`: request-level failure/success counts with
half-open probing.  Scraping answers "is the pod up?" on the scrape
interval; the breaker answers "are this pod's REQUESTS failing?" at
request speed — P/D-Serve's observation that per-request failover, not pod
restart, is what preserves goodput at scale (arxiv 2408.08147; NetKV
2606.03910 argues the same for decode-instance selection).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional

from llm_d_tpu_torch.server import http_client
from llm_d_tpu_torch.utils.config import env_float, env_int
from llm_d_tpu_torch.utils.metrics import (
    DRAIN_STATE_METRIC, parse_prometheus_text)

logger = logging.getLogger(__name__)


class EndpointBreaker:
    """Per-endpoint circuit breaker consumed by the scheduler pipeline.

    States per endpoint (exported as ``llmd_tpu:endpoint_breaker_state``:
    0=closed, 1=open, 2=half-open):

      closed     counting consecutive request failures; at
                 ``failure_threshold`` the breaker opens.
      open       ``admissible()`` is False — the circuit-breaker-filter
                 drops the endpoint from candidate sets — until ``open_s``
                 elapses, then half-open.
      half-open  one probe request is admitted per ``probe_interval_s``
                 (``note_pick`` arms the window when the probe actually
                 wins the pick); a recorded success closes the breaker, a
                 failure re-opens it.

    Thread-safe: the scheduler reads from a worker thread
    (``asyncio.to_thread``) while the gateway records results on the event
    loop.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"
    _STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, failure_threshold: Optional[int] = None,
                 open_s: Optional[float] = None,
                 probe_interval_s: Optional[float] = None,
                 metrics=None) -> None:
        self.failure_threshold = (
            failure_threshold if failure_threshold is not None
            else env_int("LLMD_BREAKER_FAILURES", 3))
        self.open_s = (open_s if open_s is not None
                       else env_float("LLMD_BREAKER_OPEN_S", 5.0))
        self.probe_interval_s = (
            probe_interval_s if probe_interval_s is not None
            else max(0.05, self.open_s / 4))
        self.metrics = metrics
        self._lock = threading.Lock()
        # addr -> [state, consecutive_failures, opened_at, next_probe_at]
        self._ep: Dict[str, list] = {}

    # ---------- internals (lock held) ----------

    def _slot(self, addr: str) -> list:
        s = self._ep.get(addr)
        if s is None:
            s = self._ep[addr] = [self.CLOSED, 0, 0.0, 0.0]
            self._export(addr, self.CLOSED)
        return s

    def _transition(self, addr: str, s: list, state: str) -> None:
        if s[0] != state:
            logger.info("breaker %s: %s -> %s", addr, s[0], state)
            # llmd-trace: breaker flips are component-level facts a
            # per-request span cannot own — the event span makes chaos
            # timelines (kill -> failures -> open -> half-open -> close)
            # reconstructable next to the request trees.
            from llm_d_tpu_torch.utils import tracing
            tracing.trace_event("epp", "breaker.transition",
                                endpoint=addr, frm=s[0], to=state)
            s[0] = state
            self._export(addr, state)

    def _export(self, addr: str, state: str) -> None:
        if self.metrics is not None:
            self.metrics.breaker_state.labels(endpoint=addr).set(
                self._STATE_CODE[state])
            self.metrics.breaker_transitions.labels(
                endpoint=addr, to=state).inc()

    def _tick(self, addr: str, s: list, now: float) -> None:
        if s[0] == self.OPEN and now - s[2] >= self.open_s:
            self._transition(addr, s, self.HALF_OPEN)
            s[3] = 0.0              # first probe admitted immediately

    # ---------- scheduler-side ----------

    def admissible(self, addr: str) -> bool:
        """May this endpoint win a pick right now?  Used by the filter
        plugin.  Half-open admits only when the probe window is free, and
        ARMS the window atomically on admission — check-then-arm across
        two lock acquisitions would let N concurrently-scheduling requests
        all 'probe' a just-recovering replica at once."""
        now = time.monotonic()
        with self._lock:
            s = self._slot(addr)
            self._tick(addr, s, now)
            if s[0] == self.CLOSED:
                return True
            if s[0] == self.OPEN:
                return False
            if now >= s[3]:         # half-open: probe window free?
                s[3] = now + self.probe_interval_s
                return True
            return False

    def note_pick(self, addr: str) -> None:
        """A half-open endpoint actually won a pick: re-arm the probe
        window from now (the probe is genuinely in flight; admission-time
        arming in ``admissible`` already bounds the concurrent herd)."""
        now = time.monotonic()
        with self._lock:
            s = self._slot(addr)
            if s[0] == self.HALF_OPEN:
                s[3] = now + self.probe_interval_s

    # ---------- data-plane-side ----------

    def record_success(self, addr: str) -> None:
        now = time.monotonic()
        with self._lock:
            s = self._slot(addr)
            self._tick(addr, s, now)
            s[1] = 0
            # Only a HALF-OPEN probe success closes the circuit.  A
            # straggler success from a request dispatched BEFORE the trip
            # must not defeat the open_s hold-off on a flapping endpoint.
            if s[0] == self.HALF_OPEN:
                self._transition(addr, s, self.CLOSED)

    def record_failure(self, addr: str) -> None:
        now = time.monotonic()
        with self._lock:
            s = self._slot(addr)
            self._tick(addr, s, now)
            s[1] += 1
            if s[0] == self.HALF_OPEN or (
                    s[0] == self.CLOSED and s[1] >= self.failure_threshold):
                s[2] = now
                self._transition(addr, s, self.OPEN)

    # ---------- introspection / lifecycle ----------

    def state(self, addr: str) -> str:
        now = time.monotonic()
        with self._lock:
            s = self._ep.get(addr)
            if s is None:
                return self.CLOSED
            self._tick(addr, s, now)
            return s[0]

    def states(self) -> Dict[str, str]:
        now = time.monotonic()
        with self._lock:
            for addr, s in self._ep.items():
                self._tick(addr, s, now)
            return {addr: s[0] for addr, s in self._ep.items()}

    def forget(self, addr: str) -> None:
        """Endpoint left (discovery): drop its breaker state so a
        replacement pod reusing the address starts closed.  The Prometheus
        series are REMOVED (not zeroed) — under pod churn every departed
        address would otherwise leak a permanent label series."""
        with self._lock:
            if self._ep.pop(addr, None) is None or self.metrics is None:
                return
            try:
                self.metrics.breaker_state.remove(addr)
            except KeyError:
                pass
            for state in self._STATE_CODE:
                try:
                    self.metrics.breaker_transitions.remove(addr, state)
                except KeyError:
                    pass


@dataclasses.dataclass
class EndpointState:
    """Last-scraped load signals for one model-server replica."""
    address: str                      # "host:port"
    role: str = "both"                # "prefill" | "decode" | "both"
    num_waiting: float = 0.0
    num_running: float = 0.0
    kv_usage: float = 0.0             # 0..1
    ready: bool = False
    # Replica announced it is draining (llmd_tpu:drain_state metric): the
    # drain-filter excludes it from new assignments while its in-flight
    # requests complete (scrape-level signal — /metrics stays up while
    # readiness is already 503).
    draining: bool = False
    last_scrape: float = 0.0
    scrape_error: Optional[str] = None

    @property
    def url(self) -> str:
        return f"http://{self.address}"


class Datastore:
    # A scrape's time limit (connect, headers and body).
    SCRAPE_TIMEOUT_S = 2.0

    def __init__(self, endpoints: List[EndpointState],
                 scrape_interval_s: float = 0.2,
                 kv_usage_metric: str = "vllm:kv_cache_usage_perc",
                 resolver=None,
                 resolve_interval_s: float = 1.0,
                 breaker: Optional[EndpointBreaker] = None) -> None:
        """``resolver`` (see ``utils.discovery``) makes the endpoint set
        dynamic: each resolve tick reconciles joins/leaves while surviving
        endpoints keep their scraped state.  Static ``endpoints`` and a
        resolver may coexist (static entries never leave)."""
        self.endpoints: Dict[str, EndpointState] = {
            e.address: e for e in endpoints}
        self._static = set(self.endpoints)
        self.scrape_interval_s = scrape_interval_s
        self.kv_usage_metric = kv_usage_metric
        self.resolver = resolver
        self.resolve_interval_s = resolve_interval_s
        self._task: Optional[asyncio.Task] = None
        self._resolve_task: Optional[asyncio.Task] = None
        # Leave hooks (e.g. the gateway drops a pod's prefix-index entries).
        self.on_remove = []
        # Request-level circuit breakers (filter-plugin + gateway consume).
        self.breaker = breaker if breaker is not None else EndpointBreaker()

    def candidates(self, role: Optional[str] = None) -> List[EndpointState]:
        out = []
        # Snapshot: discovery reconciles this dict on the event loop while
        # the scheduler iterates from a worker thread (service.py runs
        # schedule() via asyncio.to_thread).
        for e in list(self.endpoints.values()):
            if role and e.role not in (role, "both"):
                continue
            out.append(e)
        return out

    # ---------- scrape loop ----------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self.resolver is not None:
            # First resolve before the first scrape: a gateway started
            # against an empty static list becomes routable as soon as
            # discovery returns.
            await self.resolve_once()
            self._resolve_task = loop.create_task(self._resolve_loop())
        self._task = loop.create_task(self._loop())

    async def stop(self) -> None:
        for t in (self._task, self._resolve_task):
            if t:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass

    async def _loop(self) -> None:
        while True:
            await self.scrape_once()
            await asyncio.sleep(self.scrape_interval_s)

    # ---------- discovery ----------

    async def _resolve_loop(self) -> None:
        while True:
            await asyncio.sleep(self.resolve_interval_s)
            try:
                await self.resolve_once()
            except Exception as exc:   # discovery outage != gateway outage
                logger.warning("endpoint resolve failed: %s", exc)

    async def resolve_once(self) -> None:
        # The resolvers block (getaddrinfo, the Kubernetes API): off the
        # event loop.
        resolved = await asyncio.get_running_loop().run_in_executor(
            None, self.resolver.resolve)
        if resolved is None:    # resolver outage: skip this tick entirely
            logger.warning("resolver outage; keeping current endpoint set")
            return
        self.reconcile(resolved)

    def reconcile(self, resolved) -> None:
        """Apply a resolved [(address, role)] set: add joins, drop leaves.

        Surviving endpoints keep their EndpointState object (scrape history,
        readiness); static CLI endpoints are never dropped.  Outage
        handling lives in the RESOLVERS (errors resolve to None, which
        ``resolve_once`` skips; MultiResolver substitutes last-known-good
        per sub-resolver), so an empty list here genuinely means
        scale-to-zero and is applied — including on_remove hooks, so the
        prefix index drops the dead pods' ownership before replacements
        reuse their addresses.
        """
        seen = set()
        for address, role in resolved:
            seen.add(address)
            cur = self.endpoints.get(address)
            if cur is None:
                self.endpoints[address] = EndpointState(
                    address=address, role=role)
                logger.info("endpoint joined: %s (%s)", address, role)
            elif cur.role != role and address not in self._static:
                cur.role = role
        for address in list(self.endpoints):
            if address in seen or address in self._static:
                continue
            del self.endpoints[address]
            logger.info("endpoint left: %s", address)
            self.breaker.forget(address)
            for hook in self.on_remove:
                hook(address)

    async def scrape_once(self) -> None:
        await asyncio.gather(
            *(self._scrape(e) for e in self.endpoints.values()),
            return_exceptions=True)

    async def _scrape(self, e: EndpointState) -> None:
        """HTTP transport only; parse/apply lives in
        :meth:`apply_scrape_text` so transports can differ (an in-process
        registry goes through the same apply path — readiness, drain
        detection, and gauge extraction never fork)."""
        try:
            text = await asyncio.wait_for(self._fetch_metrics(e),
                                          self.SCRAPE_TIMEOUT_S)
        except Exception as exc:  # endpoint down -> not a candidate
            self.apply_scrape_error(e, exc)
            return
        self.apply_scrape_text(e, text)

    async def _fetch_metrics(self, e: EndpointState) -> str:
        async with await http_client.get(
                e.url, "/metrics",
                connect_timeout=self.SCRAPE_TIMEOUT_S) as resp:
            # A 5xx with a parseable-but-empty body would score as a
            # zero-load (= most attractive) endpoint; only 200 is ready.
            if resp.status != 200:
                raise http_client.ClientError(f"HTTP {resp.status}")
            return (await resp.read()).decode("utf-8", "replace")

    def apply_scrape_text(self, e: EndpointState, text: str) -> None:
        m = parse_prometheus_text(text)
        e.num_waiting = m.get("vllm:num_requests_waiting", 0.0)
        e.num_running = m.get("vllm:num_requests_running", 0.0)
        e.kv_usage = m.get(self.kv_usage_metric, 0.0)
        e.draining = m.get(DRAIN_STATE_METRIC, 0.0) >= 1.0
        e.ready = True
        e.scrape_error = None
        e.last_scrape = time.monotonic()

    def apply_scrape_error(self, e: EndpointState, exc: Exception) -> None:
        e.ready = False
        e.scrape_error = str(exc)
