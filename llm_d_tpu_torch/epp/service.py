"""llmd-gateway: the inference-scheduler service (EPP) with a data plane
(port of ``llm_d_tpu.epp.service``: the same flags, routes, headers,
metrics and KV-event socket, on the standard library's asyncio through
``server/http_server.py`` and ``server/http_client.py``).

The reference EPP is an Envoy ext_proc sidekick: Envoy streams each request
to it, the plugin pipeline picks an endpoint, and Envoy routes on the
returned ``x-gateway-destination-endpoint`` header (reference:
standalone-inference-scheduling/values.yaml:118-181).  This service packages
the same pipeline behind a self-contained HTTP gateway — it schedules AND
forwards, so no Envoy is required for the first well-lit path — while the
scheduling core (``EppScheduler``) stays transport-agnostic for an ext_proc
front end.

Surfaces:
  POST /v1/completions, /v1/chat/completions  -> schedule + proxy
  GET  /v1/models                             -> proxy to any ready endpoint
  GET  /health                                -> gateway liveness
  GET  /metrics                               -> inference_extension_* metrics
  ZMQ SUB :5557                               -> KV events feeding the
                                                 precise prefix index

``--ext-proc-port`` (the Envoy ext_proc gRPC plane) is refused by name:
it is not yet ported.

    python -m llm_d_tpu_torch.epp.service --port 8080 \
        --config default-config.yaml --discover dns:ms-svc:8200 \
        --kv-events-bind tcp://0.0.0.0:5557
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import random
import time
import uuid as uuid_mod
from typing import Dict, List, Optional, Union

from llm_d_tpu_torch.epp.config import DEFAULT_CONFIG_YAML, parse_config
from llm_d_tpu_torch.epp.datastore import (
    Datastore, EndpointBreaker, EndpointState)
from llm_d_tpu_torch.epp.indexer import PrefixIndex, ZmqEventSubscriber
from llm_d_tpu_torch.epp.plugins import RequestCtx
from llm_d_tpu_torch.epp.scheduler import DESTINATION_HEADER, EppScheduler
from llm_d_tpu_torch.server import http_client, stream_resume
from llm_d_tpu_torch.server.http_server import (
    HTTPServer, Request, Response, StreamResponse, json_response, run_app)
from llm_d_tpu_torch.server.stream_resume import StreamJournal
from llm_d_tpu_torch.utils import tracing
from llm_d_tpu_torch.utils.config import env_int
from llm_d_tpu_torch.utils.discovery import MultiResolver, parse_discover_spec
from llm_d_tpu_torch.utils.faultinject import FaultInjected, get_injector
from llm_d_tpu_torch.utils.lifecycle import (
    CRITICALITY_HEADER,
    CRITICALITY_SHEDDABLE,
    DEADLINE_ABS_HEADER,
    DEADLINE_EXCEEDED_HEADER,
    KV_PLACEMENT_HEADER,
    REQUEST_ID_HEADER,
    RETRY_ATTEMPT_HEADER,
    RETRY_BUDGET_HEADER,
    parse_criticality,
    parse_deadline,
    remaining_s,
)
from llm_d_tpu_torch.utils.metrics import EppMetrics

logger = logging.getLogger(__name__)

# What a forward's failure looks like before any byte is committed, or
# mid-stream: the client's transport failures, an injected fault, a
# stream that ended before [DONE].
_UPSTREAM_ERRORS = (http_client.ClientError, FaultInjected,
                    stream_resume.StreamBroken)
# A forward's connect time limit (aiohttp's sock_connect in the JAX
# gateway); reads have none, so a long generation is never cut.
CONNECT_TIMEOUT_S = 10.0


def parse_endpoint_arg(arg: str) -> EndpointState:
    """"host:port" or "host:port=prefill|decode|both"."""
    role = "both"
    if "=" in arg:
        arg, role = arg.rsplit("=", 1)
    return EndpointState(address=arg, role=role)


class FlowControl:
    """Bounded admission (the reference's flow-control queue,
    example-promQL-queries.md:40-80): at most ``max_inflight`` requests hold
    an upstream slot; excess waits in a bounded FIFO up to
    ``queue_timeout_s``.  Under saturation the gateway degrades to bounded
    latency + fast rejection instead of fanning unbounded concurrency at
    the model servers.

    Admission is SLO-class-aware — low classes shed before high ones
    queue: sheddable requests (class ``sheddable`` or priority < 0) never
    queue, they 429 immediately; standard requests queue up to
    ``max_queue``; critical requests keep ``critical_reserve`` extra queue
    seats (``LLMD_SLO_CRITICAL_RESERVE``) so a standard-traffic burst
    cannot starve them out of the queue."""

    def __init__(self, max_inflight: int, max_queue: int,
                 queue_timeout_s: float, metrics) -> None:
        self._sem = asyncio.Semaphore(max_inflight)
        self.max_queue = max_queue
        self.queue_timeout_s = queue_timeout_s
        self.critical_reserve = env_int("LLMD_SLO_CRITICAL_RESERVE", 8)
        self._queued = 0
        self.metrics = metrics

    async def acquire(self, sheddable: bool,
                      criticality: str = "standard",
                      max_wait_s: Optional[float] = None) -> str:
        """Returns "ok" (slot held), "saturated" (sheddable, no slot),
        "queue_full", or "timeout".  ``max_wait_s`` caps the queue wait
        below ``queue_timeout_s`` (the request's remaining deadline
        budget): a request whose deadline will expire mid-queue must not
        hold a scarce queue seat past the point it is already dead."""
        # Fast path only when nobody is parked: on Python <= 3.11
        # Semaphore.acquire is not FIFO-fair, so without the _queued gate a
        # steady arrival stream would barge past queued waiters until they
        # all starve into queue_timeout 503s.
        if not self._sem.locked() and self._queued == 0:
            await self._sem.acquire()
            return "ok"
        if sheddable:
            return "saturated"
        limit = self.max_queue + (
            self.critical_reserve if criticality == "critical" else 0)
        if self._queued >= limit:
            self.metrics.flow_control_rejects.labels(
                reason="queue_full").inc()
            return "queue_full"
        self._queued += 1
        try:
            # Everything that can raise sits under the finally from the
            # first statement on, so the queue count can never be left
            # stuck high by an exception (PAIR001).
            self.metrics.flow_control_queue.set(self._queued)
            timeout = self.queue_timeout_s
            if max_wait_s is not None:
                timeout = max(0.0, min(timeout, max_wait_s))
            await asyncio.wait_for(self._sem.acquire(), timeout)
            return "ok"
        except asyncio.TimeoutError:
            self.metrics.flow_control_rejects.labels(reason="timeout").inc()
            return "timeout"
        finally:
            self._queued -= 1
            self.metrics.flow_control_queue.set(self._queued)

    def release(self) -> None:
        self._sem.release()


class Gateway:
    def __init__(self, scheduler: EppScheduler, datastore: Datastore,
                 subscriber: Optional[ZmqEventSubscriber] = None,
                 flow: Optional[FlowControl] = None,
                 retry_attempts: Optional[int] = None) -> None:
        self.scheduler = scheduler
        self.datastore = datastore
        self.subscriber = subscriber
        self.flow = flow
        # Retries on an ALTERNATE endpoint after connect-failure/5xx
        # (P/D-Serve: routing-layer retry preserves goodput; 0 disables).
        self.retry_attempts = (retry_attempts if retry_attempts is not None
                               else env_int("LLMD_GATEWAY_RETRIES", 2))

    def build_app(self) -> HTTPServer:
        return HTTPServer({
            ("GET", "/health"): self.health,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/debug/traces"): self.debug_traces,
            ("GET", "/v1/models"): self.models,
            ("POST", "/v1/completions"): self.proxy_inference,
            ("POST", "/v1/chat/completions"): self.proxy_inference,
        }, on_startup=[self._on_startup], on_cleanup=[self._on_cleanup])

    async def _on_startup(self) -> None:
        await self.datastore.start()
        if self.subscriber is not None:
            self.subscriber.start()

    async def _on_cleanup(self) -> None:
        await self.datastore.stop()
        if self.subscriber is not None:
            self.subscriber.stop()

    # ---------- endpoints ----------

    async def health(self, request: Request) -> Response:
        return Response(b"ok")

    async def metrics(self, request: Request) -> Response:
        return Response(self.scheduler.metrics.render(),
                        content_type="text/plain")

    async def debug_traces(self, request: Request) -> Response:
        """llmd-trace span dump: every component tracer in this process
        as JSONL (``scripts/trace_report.py`` input; ``?drain=1`` clears
        the rings after the snapshot — the load tool's post-run scrape)."""
        drain = request.query.get("drain") in ("1", "true")
        spans = ([s for t in tracing.all_tracers().values()
                  for s in t.drain()] if drain else tracing.snapshot_all())
        return Response(tracing.render_jsonl(spans).encode("utf-8"),
                        content_type="application/jsonl")

    async def models(self, request: Request) -> Response:
        for e in self.datastore.candidates():
            if not e.ready:
                continue
            try:
                status, body = await asyncio.wait_for(
                    self._get_json(e.url, "/v1/models"), 5)
                return json_response(body, status=status)
            except Exception:
                continue
        return json_response({"error": "no ready endpoints"}, status=503)

    @staticmethod
    async def _get_json(url: str, path: str) -> tuple:
        async with await http_client.get(url, path) as r:
            return r.status, await r.json()

    async def proxy_inference(self, request: Request
                              ) -> Union[Response, StreamResponse]:
        try:
            body = request.json()
        except ValueError:
            return json_response({"error": "invalid json"}, status=400)

        try:
            priority = int(body.get("priority") or 0)
        except (TypeError, ValueError):
            return json_response(
                {"error": "invalid request: priority must be an int"},
                status=400)
        in_headers = dict(request.headers)
        try:
            criticality = parse_criticality(in_headers, body)
            # Stamp the ABSOLUTE deadline here, at the first hop: later
            # hops must inherit it, not re-base the relative budget after
            # queueing already spent part of it.
            deadline_epoch = parse_deadline(in_headers, body)
        except ValueError as exc:
            return json_response(
                {"error": f"invalid request: {exc}"}, status=400)
        # x-request-id contract: the id is minted HERE when the client
        # sent none, rides every later hop verbatim (headers AND body, so
        # the model server's response/stream id matches), and seeds the
        # trace id — log lines and traces at every component join on it.
        rid = (in_headers.get(REQUEST_ID_HEADER)
               or str(body.get("request_id") or "")
               or f"req-{uuid_mod.uuid4().hex[:16]}")
        body = dict(body)
        body.setdefault("request_id", rid)
        span = tracing.get_tracer("gateway").start_span(
            "gateway.request",
            parent=tracing.parse_trace_headers(in_headers),
            request_id=rid, path=request.path, criticality=criticality)
        try:
            expired = self._deadline_expired(criticality, deadline_epoch)
            if expired is not None:
                span.add_event("deadline_expired", where="pre-queue")
                return expired
            if self.flow is None:
                return await self._schedule_and_forward(
                    body, request, criticality, deadline_epoch, span=span)
            q0 = time.time()
            outcome = await self.flow.acquire(
                sheddable=priority < 0 or criticality == "sheddable",
                criticality=criticality,
                max_wait_s=remaining_s(deadline_epoch))
            tracing.get_tracer("gateway").record_span(
                "gateway.queue", q0, time.time(), parent=span,
                phase="queue", outcome=outcome)
            self.scheduler.metrics.observe_phase(
                "queue", criticality, time.time() - q0)
            if outcome == "saturated":
                self.flow.metrics.flow_control_rejects.labels(
                    reason="saturated").inc()
                return json_response(
                    {"error": "saturated: sheddable request refused under "
                              "load"}, status=429)
            if outcome in ("queue_full", "timeout"):
                # A deadline-capped queue timeout is a deadline miss, not
                # an overload verdict — answer the honest 504.
                expired = self._deadline_expired(criticality, deadline_epoch)
                if expired is not None:
                    span.add_event("deadline_expired", where="queued")
                    return expired
                return json_response(
                    {"error": f"overloaded: flow control {outcome}"},
                    status=503)
            try:
                # Queue time may have eaten the whole budget: refuse before
                # forwarding rather than burn an upstream slot on a request
                # the client has already written off.
                expired = self._deadline_expired(criticality, deadline_epoch)
                if expired is not None:
                    span.add_event("deadline_expired", where="post-queue")
                    return expired
                return await self._schedule_and_forward(
                    body, request, criticality, deadline_epoch, span=span)
            finally:
                self.flow.release()
        finally:
            span.end()

    def _deadline_expired(self, criticality: str,
                          deadline_epoch: Optional[float]
                          ) -> Optional[Response]:
        if deadline_epoch is None or time.time() <= deadline_epoch:
            return None
        self.scheduler.metrics.gateway_deadline_exceeded.labels(
            criticality=criticality).inc()
        return json_response(
            {"error": "deadline exceeded"}, status=504,
            headers={DEADLINE_EXCEEDED_HEADER: "1"})

    async def _schedule_and_forward(self, body: Dict,
                                    request: Request,
                                    criticality: str = "standard",
                                    deadline_epoch: Optional[float] = None,
                                    span: Optional[tracing.Span] = None
                                    ) -> Union[Response, StreamResponse]:
        """Schedule, forward, and on connect-failure/5xx RE-SCHEDULE on the
        surviving replicas (bounded attempts; failed endpoints are excluded
        from the retry's candidate set and recorded against their circuit
        breaker).  Only failures with NO response bytes committed take this
        retry path; a half-sent SSE stream is RESUMED instead — the relay
        journals emitted tokens and, on mid-stream death (upstream break,
        or a stall past the token-gap watchdog), re-schedules on the
        surviving replicas and splices the continuation at the journal
        offset (:mod:`llm_d_tpu_torch.server.stream_resume`)."""
        breaker = self.datastore.breaker
        metrics = self.scheduler.metrics
        tracer = tracing.get_tracer("gateway")
        max_attempts = 1 + max(0, self.retry_attempts)
        excluded: set = set()
        rid = str(body.get("request_id") or "")
        last_error = "no ready endpoints"
        attempts_made = 0          # forwards actually sent (error reporting)
        policy = stream_resume.resume_policy()
        journal: Optional[StreamJournal] = None
        if policy.enabled and bool(body.get("stream", False)) \
                and criticality != CRITICALITY_SHEDDABLE:
            journal = StreamJournal(body, criticality=criticality,
                                    deadline_epoch=deadline_epoch)

        def note_retry(addr: str, reason: str, error: str) -> None:
            """Shared retry bookkeeping: breaker, exclusion, metric, log,
            trace event (the causal record chaos runs replay)."""
            nonlocal last_error
            breaker.record_failure(addr)
            excluded.add(addr)
            last_error = error
            metrics.gateway_retries.labels(reason=reason).inc()
            if span is not None:
                span.add_event("retry", endpoint=addr, reason=reason,
                               attempt=attempts_made, error=error)
            logger.warning(
                "retrying request %s on alternate endpoint "
                "(attempt %d/%d): %s", rid or "-", attempts_made,
                max_attempts, error)

        def has_alternate(addr: str) -> bool:
            return any(e.ready and e.address not in excluded
                       and e.address != addr
                       for e in self.datastore.candidates())
        for attempt in range(max_attempts):
            # A retry after a slow failed forward may already be past the
            # deadline — stop burning attempts on it.
            expired = self._deadline_expired(criticality, deadline_epoch)
            if expired is not None:
                return expired
            try:
                ctx = self._make_ctx(body, request)
                ctx.excluded_endpoints = set(excluded)
                ctx.retry_attempt = attempt
                rid = ctx.request_id
                # Scoring may block (prediction-sidecar HTTP, lock
                # contention): keep it off the event loop so streaming
                # relays never stall.
                s0 = time.time()
                result = await asyncio.to_thread(self.scheduler.schedule, ctx)
            except (TypeError, ValueError) as exc:
                return json_response(
                    {"error": f"invalid request: {exc}",
                     "request_id": rid}, status=400)
            chosen_addr = (result.primary.address
                           if result.primary is not None else None)
            tracer.record_span(
                "gateway.schedule", s0, time.time(), parent=span,
                phase="schedule", attempt=attempt, endpoint=chosen_addr,
                shed=ctx.shed or None,
                # Per-scorer breakdown for the chosen endpoint: the
                # routing decision is explainable per request.
                scores={prof: {plugin: sc.get(chosen_addr)
                               for plugin, sc in plugins.items()}
                        for prof, plugins in result.breakdown.items()}
                if chosen_addr else None)
            self.scheduler.metrics.observe_phase(
                "schedule", criticality, time.time() - s0)
            if ctx.shed:
                # No pod can meet the SLOs and the request is sheddable
                # (priority < 0): refuse instead of queueing it in the
                # negative bucket (reference: README.md:190-192).
                metrics.shed_total.inc()
                return json_response(
                    {"error": "shed: no endpoint meets the requested SLOs",
                     "request_id": rid}, status=429)
            primary = result.primary
            if primary is None:
                # First attempt: genuinely nothing ready.  On a retry:
                # every surviving candidate is excluded — stop early.
                break
            fwd_body = body
            if ctx.predictions:
                # Ride the predictions to the model server so its usage
                # frame can report predicted vs actual (reference SSE usage
                # contract, README.md:130-148).
                fwd_body = dict(body)
                fwd_body["_predicted"] = ctx.predictions

            # PD: hand the sidecar its prefill hint via the request headers.
            fwd_headers = {k: v for k, v in result.headers.items()
                           if k != DESTINATION_HEADER}
            fwd_headers[RETRY_ATTEMPT_HEADER] = str(attempt)
            # Lifecycle contract rides every hop: absolute deadline +
            # SLO class (the sidecar and model server consume both).
            fwd_headers[CRITICALITY_HEADER] = criticality
            if deadline_epoch is not None:
                fwd_headers[DEADLINE_ABS_HEADER] = f"{deadline_epoch:.6f}"
            if rid:
                fwd_headers[REQUEST_ID_HEADER] = rid
            resp = None
            attempts_made += 1
            # Forward span: downstream hops (sidecar, model server, sim)
            # parent their spans on it, so the whole request is ONE
            # connected tree across processes.
            fspan = tracer.start_span(
                "gateway.forward", parent=span,
                endpoint=primary.address, attempt=attempt)
            fwd_headers.update(tracing.trace_headers(fspan.ctx()))
            try:
                await get_injector().acheck("gateway.forward",
                                            key=primary.address)
                # No read timeout: it would count SSE streaming time and
                # sever long generations mid-stream; connect failures
                # surface fast.
                async with await http_client.post_json(
                        primary.url, request.path, fwd_body, fwd_headers,
                        connect_timeout=CONNECT_TIMEOUT_S) as upstream:
                    if upstream.status >= 500 \
                            and attempt + 1 < max_attempts \
                            and has_alternate(primary.address):
                        # Replica-side failure with nothing committed yet
                        # AND somewhere else to go: burn a retry on an
                        # alternate instead of relaying.  With no
                        # alternate (single-replica pool, everything else
                        # excluded) the upstream's own status and
                        # diagnostic body relay verbatim below.
                        note_retry(primary.address, "5xx",
                                   f"upstream {primary.address} "
                                   f"HTTP {upstream.status}")
                        fspan.end(status=upstream.status)
                        continue
                    if upstream.status >= 500:
                        breaker.record_failure(primary.address)
                    else:
                        breaker.record_success(primary.address)
                    out_headers = {}
                    if "content-type" in upstream.headers:
                        out_headers["Content-Type"] = \
                            upstream.headers["content-type"]
                    out_headers[DESTINATION_HEADER] = primary.address
                    out_headers[RETRY_BUDGET_HEADER] = \
                        f"{attempt}/{max_attempts - 1}"
                    # Placement verdict back to the client so load
                    # campaigns report the same local_hit/peer_restore/
                    # recompute mix as the sim scoreboard.
                    if KV_PLACEMENT_HEADER in result.headers:
                        out_headers[KV_PLACEMENT_HEADER] = \
                            result.headers[KV_PLACEMENT_HEADER]
                    resp = await request.stream(out_headers,
                                                status=upstream.status)
                    if journal is not None and upstream.status == 200:
                        await stream_resume.relay_stream(
                            resp, upstream, journal,
                            fault_key=primary.address,
                            stall_timeout_s=policy.stall_timeout_s,
                            span=fspan)
                    else:
                        while True:
                            chunk = await upstream.readany()
                            if not chunk:
                                break
                            await resp.write(chunk)
                    await resp.write_eof()
                    fspan.end(status=upstream.status)
                    return resp
            except _UPSTREAM_ERRORS as exc:
                fspan.end(error=f"{type(exc).__name__}: {exc}")
                if resp is not None:
                    # Headers already went out: a second (json) response
                    # would corrupt the half-sent stream.  A journaled
                    # stream is RESUMED on a surviving replica; anything
                    # else closes truncated (today's contract), counting
                    # the endpoint's failure either way.
                    breaker.record_failure(primary.address)
                    if journal is not None and upstream.status == 200:
                        return await self._resume_stream(
                            request, resp, journal, policy,
                            excluded | {primary.address}, criticality,
                            deadline_epoch, exc, span=span)
                    return resp
                if attempt + 1 < max_attempts:
                    note_retry(primary.address, "connect",
                               f"upstream {primary.address} failed: {exc}")
                    continue
                breaker.record_failure(primary.address)
                excluded.add(primary.address)
                last_error = f"upstream {primary.address} failed: {exc}"
        if excluded:
            metrics.gateway_retry_exhausted.inc()
            logger.error("request %s failed after %d attempt(s): %s",
                         rid or "-", attempts_made, last_error)
            return json_response(
                {"error": last_error, "request_id": rid,
                 "attempts": attempts_made}, status=502)
        return json_response(
            {"error": "no ready endpoints", "request_id": rid}, status=503)

    def _drain_recoveries(self, journal: StreamJournal) -> None:
        metrics = self.scheduler.metrics
        for outcome, secs in journal.take_recoveries():
            metrics.stream_resume.labels(outcome=outcome).inc()
            metrics.request_recovery.observe(secs)
            metrics.observe_phase("resume", journal.criticality, secs)

    async def _resume_stream(self, request: Request,
                             resp: StreamResponse,
                             journal: StreamJournal, policy,
                             excluded: set, criticality: str,
                             deadline_epoch: Optional[float],
                             first_exc: BaseException,
                             span: Optional[tracing.Span] = None
                             ) -> StreamResponse:
        """Mid-stream decode failover: re-schedule the broken stream on
        the surviving replicas (dead endpoints excluded, breaker-aware)
        and splice the continuation into the client's still-open SSE
        response at the journal's token offset.

        Degradation ladder: attempts beyond ``LLMD_RESUME_MAX_ATTEMPTS``,
        an exhausted deadline budget, or no surviving candidate end the
        recovery — the stream closes truncated exactly as it does today,
        with ``llmd_tpu:stream_resume_total{outcome="failed"}`` marking
        the loss."""
        breaker = self.datastore.breaker
        metrics = self.scheduler.metrics
        tracer = tracing.get_tracer("gateway")
        excluded = set(excluded)
        exc: BaseException = first_exc
        while True:
            if journal.finish_reason and not journal.done:
                # The finish chunk was already delivered — only [DONE]
                # was lost in the break.  The stream is logically
                # complete: close it here, no replica needed (resuming
                # would decode past the delivered EOS/stop).
                journal.done = True
                try:
                    await resp.write(b"data: [DONE]\n\n")
                    await resp.write_eof()
                except (ConnectionResetError, OSError):
                    pass
                return resp
            left = remaining_s(deadline_epoch)
            if not journal.resumable \
                    or journal.resume_count >= policy.max_attempts \
                    or (left is not None and left <= 0):
                metrics.stream_resume.labels(
                    outcome=stream_resume.OUTCOME_FAILED).inc()
                if span is not None:
                    span.add_event(
                        "resume_exhausted", offset=journal.offset,
                        attempts=journal.resume_count,
                        error=f"{type(exc).__name__}: {exc}")
                logger.error(
                    "stream %s broke at token %d and was NOT recovered "
                    "(%s; attempts=%d/%d, budget_left=%s)",
                    journal.stream_id or "-", journal.offset, exc,
                    journal.resume_count, policy.max_attempts,
                    "none" if left is None else f"{left:.2f}s")
                return resp               # truncated: today's contract
            journal.resume_count += 1
            journal.mark_break()
            # Resume-attempt span under the ORIGINAL trace id: the
            # failover chain stays one connected tree (the resumed
            # replica's spans parent here), which is what makes a chaos
            # run's kill -> resume -> continuation causally explainable.
            rspan = tracer.start_span(
                "gateway.resume", parent=span,
                attempt=journal.resume_count, offset=journal.offset,
                broke=f"{type(exc).__name__}: {exc}")
            try:
                ctx = self._make_ctx(journal.body, request)
            except (TypeError, ValueError):
                metrics.stream_resume.labels(
                    outcome=stream_resume.OUTCOME_FAILED).inc()
                rspan.end(outcome=stream_resume.OUTCOME_FAILED)
                return resp
            ctx.excluded_endpoints = set(excluded)
            ctx.retry_attempt = journal.resume_count
            result = await asyncio.to_thread(self.scheduler.schedule, ctx)
            primary = result.primary
            if primary is None:
                metrics.stream_resume.labels(
                    outcome=stream_resume.OUTCOME_FAILED).inc()
                rspan.end(outcome=stream_resume.OUTCOME_FAILED,
                          error="no surviving resume target")
                logger.error(
                    "stream %s: no surviving resume target (excluded=%s)",
                    journal.stream_id or "-", sorted(excluded))
                return resp
            rspan.set(endpoint=primary.address)
            fwd_headers = {k: v for k, v in result.headers.items()
                           if k != DESTINATION_HEADER}
            fwd_headers.update(journal.resume_headers())
            fwd_headers[CRITICALITY_HEADER] = criticality
            if deadline_epoch is not None:
                fwd_headers[DEADLINE_ABS_HEADER] = f"{deadline_epoch:.6f}"
            if journal.body.get("request_id"):
                fwd_headers[REQUEST_ID_HEADER] = \
                    str(journal.body["request_id"])
            fwd_headers.update(tracing.trace_headers(rspan.ctx()))
            logger.warning(
                "stream %s broke at token %d (%s); resuming on %s "
                "(attempt %d/%d)", journal.stream_id or "-",
                journal.offset, exc, primary.address,
                journal.resume_count, policy.max_attempts)
            metrics.gateway_retries.labels(reason="resume").inc()
            try:
                await get_injector().acheck("gateway.forward",
                                            key=primary.address)
                async with await http_client.post_json(
                        primary.url, request.path, journal.resume_body(),
                        fwd_headers,
                        connect_timeout=CONNECT_TIMEOUT_S) as upstream:
                    if upstream.status != 200:
                        breaker.record_failure(primary.address)
                        excluded.add(primary.address)
                        exc = RuntimeError(
                            f"resume target {primary.address} answered "
                            f"HTTP {upstream.status}")
                        rspan.end(status=upstream.status,
                                  outcome="refused")
                        continue
                    await stream_resume.relay_stream(
                        resp, upstream, journal,
                        fault_key=primary.address,
                        stall_timeout_s=policy.stall_timeout_s,
                        span=rspan)
            except _UPSTREAM_ERRORS as e:
                # The resume target died too (possibly after partial
                # progress — already journaled and accounted): exclude
                # it and go around.
                breaker.record_failure(primary.address)
                excluded.add(primary.address)
                self._drain_recoveries(journal)
                exc = e
                rspan.end(error=f"{type(e).__name__}: {e}")
                continue
            breaker.record_success(primary.address)
            self._drain_recoveries(journal)
            rspan.end(outcome=journal.last_src
                      or stream_resume.OUTCOME_RECOMPUTED)
            try:
                await resp.write_eof()
            except (ConnectionResetError, OSError):
                pass            # client gone after the final frame
            return resp

    def _make_ctx(self, body: Dict, request: Request) -> RequestCtx:
        return RequestCtx.from_request(body, dict(request.headers))


def build_gateway(
    endpoints: List[EndpointState],
    config_yaml: Optional[str] = None,
    scrape_interval_s: float = 0.2,
    kv_events_bind: Optional[str] = None,
    indexer: Optional[PrefixIndex] = None,
    resolver=None,
    resolve_interval_s: float = 1.0,
    max_inflight: int = 256,
    max_queue: int = 128,
    queue_timeout_s: float = 30.0,
    retry_attempts: Optional[int] = None,
    breaker: Optional[EndpointBreaker] = None,
    rng: Optional[random.Random] = None,
) -> Gateway:
    """The JAX ``build_gateway``'s arguments, and ``rng``: the pickers'
    tie-breaks (a fresh ``random.Random()`` when None)."""
    config = parse_config(config_yaml or DEFAULT_CONFIG_YAML)
    metrics = EppMetrics()
    if breaker is None:
        breaker = EndpointBreaker(metrics=metrics)
    elif breaker.metrics is None:
        breaker.metrics = metrics
    datastore = Datastore(endpoints, scrape_interval_s=scrape_interval_s,
                          resolver=resolver,
                          resolve_interval_s=resolve_interval_s,
                          breaker=breaker)
    needs_index = any(p.type in ("precise-prefix-cache-scorer",
                                 "kv-placement-scorer")
                      for p in config.plugins)
    subscriber = None
    if indexer is None and needs_index:
        indexer = PrefixIndex(metrics=metrics)
    if indexer is not None and kv_events_bind:
        subscriber = ZmqEventSubscriber(indexer, bind=kv_events_bind)
    if indexer is not None:
        # Discovery leave -> drop the pod's prefix-index ownership.
        datastore.on_remove.append(indexer.remove_endpoint)
    scheduler = EppScheduler(config, datastore, metrics=metrics,
                             indexer=indexer, rng=rng)
    flow = (FlowControl(max_inflight, max_queue, queue_timeout_s, metrics)
            if max_inflight > 0 else None)
    return Gateway(scheduler, datastore, subscriber=subscriber, flow=flow,
                   retry_attempts=retry_attempts)


def build_arg_parser() -> argparse.ArgumentParser:
    """The JAX ``main``'s flags, each with its default."""
    p = argparse.ArgumentParser("llmd-gateway")
    p.add_argument("--endpoints", default="",
                   help="comma list of static host:port[=role]; role in "
                        "prefill|decode|both")
    p.add_argument("--discover", default="",
                   help="comma list of discovery specs: "
                        "dns:<headless-svc>:<port>[=role] | "
                        "k8s:[<ns>/]<service>:<port>[=role] "
                        "(per-pod endpoints join/leave live)")
    p.add_argument("--resolve-interval", type=float, default=1.0)
    p.add_argument("--config", default=None,
                   help="EndpointPickerConfig YAML path (default: queue + "
                        "kv-util + prefix scorers, max-score picker)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--scrape-interval", type=float, default=0.2)
    p.add_argument("--kv-events-bind", default=None,
                   help="ZMQ bind for engine KV events, e.g. tcp://*:5557 "
                        "(enables the precise prefix index)")
    p.add_argument("--ext-proc-port", type=int, default=None,
                   help="the Envoy ext_proc gRPC plane: not yet ported "
                        "(refused)")
    p.add_argument("--max-inflight", type=int, default=256,
                   help="flow control: concurrent upstream requests "
                        "(0 disables flow control)")
    p.add_argument("--max-queue", type=int, default=128,
                   help="flow control: waiting-queue depth before 503")
    p.add_argument("--queue-timeout", type=float, default=30.0,
                   help="flow control: max seconds a request may queue")
    p.add_argument("--retry-attempts", type=int, default=None,
                   help="retries on an alternate endpoint after connect "
                        "failure/5xx (default LLMD_GATEWAY_RETRIES or 2; "
                        "0 disables)")
    p.add_argument("--breaker-failures", type=int, default=None,
                   help="consecutive request failures that trip an "
                        "endpoint's circuit breaker (default "
                        "LLMD_BREAKER_FAILURES or 3)")
    p.add_argument("--breaker-open-s", type=float, default=None,
                   help="seconds a tripped breaker stays open before "
                        "half-open probing (default LLMD_BREAKER_OPEN_S "
                        "or 5)")
    return p


def gateway_from_args(p: argparse.ArgumentParser, args) -> Gateway:
    """The gateway ``main`` serves; flag errors exit through ``p``."""
    if args.ext_proc_port is not None:
        p.error("--ext-proc-port: not yet ported (the Envoy ext_proc gRPC "
                "plane; the HTTP gateway serves the same scheduling)")
    config_yaml = None
    if args.config:
        with open(args.config) as f:
            config_yaml = f.read()
    endpoints = [parse_endpoint_arg(e)
                 for e in args.endpoints.split(",") if e.strip()]
    resolver = None
    specs = [s for s in args.discover.split(",") if s.strip()]
    if specs:
        resolvers = [parse_discover_spec(s.strip()) for s in specs]
        resolver = resolvers[0] if len(resolvers) == 1 \
            else MultiResolver(resolvers)
    if not endpoints and resolver is None:
        p.error("need --endpoints and/or --discover")
    return build_gateway(endpoints, config_yaml,
                         scrape_interval_s=args.scrape_interval,
                         kv_events_bind=args.kv_events_bind,
                         resolver=resolver,
                         resolve_interval_s=args.resolve_interval,
                         max_inflight=args.max_inflight,
                         max_queue=args.max_queue,
                         queue_timeout_s=args.queue_timeout,
                         retry_attempts=args.retry_attempts,
                         breaker=EndpointBreaker(
                             failure_threshold=args.breaker_failures,
                             open_s=args.breaker_open_s))


def main(argv: Optional[List[str]] = None) -> None:
    p = build_arg_parser()
    args = p.parse_args(argv)
    gw = gateway_from_args(p, args)
    logging.basicConfig(level=logging.INFO)
    run_app(gw.build_app(), args.host, args.port)


if __name__ == "__main__":
    main()
