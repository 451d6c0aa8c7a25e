"""OpenAI-compatible model server over the port's engine (port of
``llm_d_tpu.server.openai``).

    python -m llm_d_tpu_torch.server.openai --model deepseek-v3-bench \\
        --quantization int8 --kv-cache-dtype int8 --block-size 64 \\
        --num-blocks 576 --max-num-seqs 128 --max-num-batched-tokens 8192 \\
        --num-scheduler-steps 32 --async-scheduling

serves on the first CUDA card (``--device cpu`` must be asked for).  The
paths, status codes, JSON keys, SSE framing, headers and metrics are the
JAX server's, so the gateway, the EPP and the monitoring stack see one
surface:

  GET  /health          -> 200 as soon as the process is up (liveness)
  GET  /v1/models       -> 200 once the model is loaded (readiness); 503
                           with x-llmd-draining while draining
  GET  /metrics         -> Prometheus text, ``vllm:*`` taxonomy
  GET  /debug/traces    -> the tracer rings as JSONL (``?drain=1`` clears)
  GET  /version, POST /tokenize
  POST /v1/completions, /v1/chat/completions (+SSE streaming)
  POST /admin/drain     -> readiness down, in-flight requests complete;
                           SIGTERM drains too, then the process exits

The HTTP layer is the standard library's (``server/http_server.py``):
the card machine has no aiohttp.

``logprobs`` / ``top_logprobs`` are served on completions and chat in
the JAX server's response shape (in the final JSON body; streamed chunks
carry none, as the JAX server's carry none), and ``--spec-k`` serves
speculative decode (``--spec-strict`` refuses to start where a startup
condition would demote it, as in the JAX server; none does today).

EPLB: ``--enable-eplb`` and ``--eplb-config`` (the JAX server's JSON:
``window_size``, ``step_interval``, ``num_redundant_experts``, ...) arm
the engine's expert-load controller; on one card the placement stays
the identity, and ``/metrics`` carries ``llmd_tpu:eplb_imbalance`` and
the migration counters.  ``--kv-cache-hbm-gb`` sizes the block pool from
a memory budget (GiB) instead of ``--num-blocks``.

P/D disaggregation: ``--kv-transfer-config`` (the JAX server's JSON:
``kv_role``, ``kv_ip``, ``kv_port``, ``kv_load_failure_policy``) gives the
engine a KV connector.  A request body with ``{"kv_transfer_params":
{"do_remote_decode": true}}`` is prefilled only, its blocks pinned, and
its final body (or last streamed chunk) carries the ``kv_transfer_params``
a decode server pulls by; a body carrying those params on a consumer pulls
the blocks and decodes.  The routing sidecar (``llm_d_tpu.sidecar``) or
any client that passes the params on drives the pair.  The tiered prefix
cache (``deploy/tiered-prefix-cache``): ``--kv-offload-blocks``,
``--kv-shared-tier-port`` and ``--kv-shared-tier-peers``, whose entries
are static ``host:port`` peers or discovery specs (``dns:<name>:<port>``,
``k8s:[<ns>/]<service>:<port>``) re-resolved every few seconds by the
standard library (``utils/discovery.py``).  On the CPU,
``tests/test_torch_pd.py`` drives two such servers behind the JAX
sidecar; on the card, ``chip_smoke.py`` path (v)(c) runs a producer and a
consumer process.

The rest of an llm-d model server, as the JAX server serves it:

* tracing: each request gets a ``server.request`` span, parented on the
  incoming ``traceparent`` / llmd trace headers, under which the engine
  records its phase and step spans; ``/debug/traces`` dumps them;
* the latency predictor's training feed: ``--latency-training-url``
  posts each finished request's ``ttft`` / ``tpot`` sample, with the
  load it met at arrival, to ``<url>/samples`` (standard library, on a
  daemon thread, 1 s timeout);
* KV events: ``--kv-events-endpoint`` (``--pod-identity``) publishes the
  prefix cache's BlockStored / BlockRemoved events for the EPP's precise
  prefix scorer (``events/kv_events.py``; needs ``zmq`` and ``msgpack``);
* config layers: ``--config`` and ``--config-overlay`` YAML files, the
  command line winning (``utils/config.py``; needs ``yaml``);
* mid-stream resume, the replica's half (``server/stream_resume.py``): a
  body with ``resume`` (and the ``x-llmd-resume-offset`` header) admits
  prompt + journal and streams on from the offset, its first chunk
  marked ``restored`` or ``recomputed``.

A flag whose module is missing is refused by name (``check_served``).

Tensor and expert parallelism: ``--tensor-parallel-size N`` serves one
mesh ``MeshConfig(tp=N)`` (the JAX server's mapping with dp = 1): this
process is rank 0 and starts ranks 1..N-1 (``parallel/launch.py``), each
building its engine on its card (``cuda:rank % cards``; ranks share a
card over gloo where there are fewer cards); readiness comes once every
rank has built.  Drain and SIGTERM stop every rank (exit 0).  If a rank
dies, ``/health`` fails and the server exits non-zero: it never serves
on with fewer ranks.  ``--allow-device-subset`` permits a mesh smaller
than the host's card count.  A mesh serves the wide-EP recipe's flags
(``deploy/wide-ep-lws``): ``--enable-dbo`` and its thresholds,
``--enable-eplb`` / ``--eplb-config`` (migrations between ranks) and
``--kv-transfer-config`` (rank 0 holds the connector), and spec decode
(``--spec-k``, the fused rounds), ``--num-scheduler-steps`` > 1 with
``--async-scheduling``, the host tier (``--kv-offload-blocks``; rank 0
holds the host copy) and the tiered-prefix-cache recipe's shared tier
(``--kv-shared-tier-port``, ``--kv-shared-tier-peers``: rank 0 alone
serves, resolves and dials peers, its blobs whole rows as a one-device
pod's) with ``LLMD_STEP_TIME_TARGET_MS`` (rank 0 sizes the prefill
chunks).  Ranks that share a card (gloo) run the decode blocks and fused
rounds eagerly.

Data parallelism, in the JAX server's two modes (``--data-parallel-size
D``): ``--data-parallel-mode spmd`` (the default) serves one mesh
``MeshConfig(dp=D, tp=N)`` as ``D x N`` ranks started as above (DP
attention, the experts over every rank); ``ranks`` serves a
``DPEngineGroup`` of this host's one-device engines in this process
behind a least-loaded dispatcher (``engine/dp_group.py``; one device a
rank, so ``--tensor-parallel-size`` > 1 is refused there).

One spmd (or tp-only) mesh across the hosts of a LeaderWorkerSet group,
as the JAX server joins them (``deploy/wide-ep-lws``): with
``LWS_LEADER_ADDRESS``, ``LWS_GROUP_SIZE`` > 1 and ``LWS_WORKER_INDEX``
set, each of the G hosts runs ``D * N / G`` of the ranks (refused by name
where that does not divide), host ``i`` global ranks ``i * D * N / G +
r``, all joined at the leader's address (port 8476, JAX's coordinator
port, unless the address names one).  The leader host (index 0) holds
rank 0 and serves as above; a worker host starts its ranks as followers
of rank 0 and answers only ``/health`` and ``/v1/models`` on ``--port``
(its pod's probes).  When rank 0 stops the mesh every host exits 0; when
a rank of a worker host fails (the leader died) that host exits
non-zero.  ``--data-parallel-size-local`` must then equal ``D / G``;
without a group one host serves the whole mesh, whatever it says.

Across hosts, in ranks mode (``--data-parallel-size-local L`` below
``D``): each host serves its L ranks, the first of them global rank
``--data-parallel-start-rank`` (default ``LWS_WORKER_INDEX * L``).  The
host with start rank 0 is the leader: it takes the external traffic and
its ``DPWorkerPool`` proxies a request to the least-loaded worker host
(judged by the ``x-llmd-sched-depth`` each worker reports) when that
worker is less loaded than the local ranks, relaying the worker's SSE
stream through a ``StreamJournal``; when a worker dies mid-stream the
stream resumes on another worker, or on the leader's own engine
(``resume_local``), with no missing and no duplicated token.  The workers
are ``--data-parallel-workers`` (comma-separated ``http://host:port``),
else derived from ``--data-parallel-address`` (or
``LWS_LEADER_ADDRESS``) and ``--data-parallel-rpc-port`` (default
``--port``) by the LeaderWorkerSet naming; with no address the leader
warns and serves its local ranks only.  With ``--data-parallel-hybrid-lb``
no host proxies: each takes external traffic for its own ranks.  The
proxy's client is the standard library's (``server/http_client.py``).
``server.dp_dispatch`` and ``server.resume_local`` spans and
``llmd_tpu:stream_resume_total`` / ``llmd_tpu:request_recovery_seconds``
record the leader's side.

Not served (each refused with a message naming it, not quietly
dropped): ranks mode's multi-host flags in spmd mode, a mesh that does not
divide over an LWS group's hosts or a ``--data-parallel-size-local`` that
contradicts the group, ranks wider than one device
(``--data-parallel-mode ranks`` with ``--tensor-parallel-size`` > 1), and
``--compilation-cache-dir`` (``UNSERVED_FLAGS``).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import importlib
import os
import queue
import signal
import threading
import time
import urllib.request
import uuid as uuid_mod
from typing import Any, Dict, List, Optional, Tuple, Union

from llm_d_tpu_torch.engine.async_engine import AsyncEngine
from llm_d_tpu_torch.engine.dp_group import DPEngineGroup
from llm_d_tpu_torch.engine.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request, RequestOutput
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.mesh import MeshConfig
from llm_d_tpu_torch.server import http_client, stream_resume
from llm_d_tpu_torch.server.http_server import (
    HTTPServer, Response, StreamResponse, json_response, text_response)
from llm_d_tpu_torch.server.http_server import Request as HTTPRequest
from llm_d_tpu_torch.server.stream_resume import StreamJournal
from llm_d_tpu_torch.utils import tracing
from llm_d_tpu_torch.utils.config import (
    apply_file_config, env_float, env_int, load_layers)
from llm_d_tpu_torch.utils.faultinject import FaultInjected
from llm_d_tpu_torch.utils.lifecycle import (
    CRITICALITY_SHEDDABLE,
    DEADLINE_EXCEEDED_HEADER,
    DRAINING_HEADER,
    REQUEST_ID_HEADER,
    RESUME_OFFSET_HEADER,
    SCHED_DEPTH_HEADER,
    parse_criticality,
    parse_deadline,
    remaining_s,
)
from llm_d_tpu_torch.utils.tokenizer import get_tokenizer

logger = logging.getLogger(__name__)

# Training samples waiting for the poster thread; past this many (a slow
# or unreachable trainer) new samples are dropped.
TRAINING_QUEUE_MAX = 1024


def _sampling_from_body(body: Dict[str, Any]) -> SamplingParams:
    lp = body.get("logprobs")
    if lp is True:
        # Chat schema: a boolean switch and a separate count of
        # alternatives (0 or absent: the chosen token's logprob only).
        lp = int(body.get("top_logprobs") or 0)
    elif lp is False:
        lp = None
    return SamplingParams(
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        max_tokens=int(body.get("max_tokens", body.get("max_completion_tokens", 16))),
        min_tokens=int(body.get("min_tokens", 0)),
        stop=tuple(body.get("stop") or ()),
        seed=body.get("seed"),
        ignore_eos=bool(body.get("ignore_eos", False)),
        logprobs=lp,
    )


def _unported(body: Dict[str, Any], engine: EngineCore) -> Optional[str]:
    """What a request asks for that this server does not serve, or None.
    ``kv_transfer_params`` needs a KV connector: without one, a local
    prefill would look healthy while defeating disaggregation."""
    if body.get("kv_transfer_params") and engine.kv_connector is None:
        return ("kv_transfer_params: this server has no KV connector "
                "(start it with --kv-transfer-config)")
    return None


def attach_tokenizer(engine: EngineCore, tokenizer) -> None:
    """The end-of-sequence id and engine-side stop-string detection
    (finish_reason="stop" without decoding to max_tokens first); every
    rank of a mesh attaches the same tokenizer, so all stop alike."""
    if tokenizer.eos_token_id is not None:
        engine.eos_token_id = tokenizer.eos_token_id
    engine.tokenizer = tokenizer


class DPWorkerPool:
    """The leader's dispatch across hosts in multi-host data parallelism
    (ranks mode: ``--data-parallel-address`` / ``--data-parallel-rpc-port``
    / ``--data-parallel-workers``), a port of the JAX server's pool.

    The leader host takes every external request and serves it on its
    local ``DPEngineGroup`` or proxies it as it came to a worker host's
    OpenAI server (the "RPC" is the same HTTP surface), through the
    standard-library client of ``server/http_client.py``.  The policy is
    least outstanding work over comparable loads: both sides count
    scheduler depth (waiting + running requests).  The local depth comes
    from the engine; a worker's is the one it reported (every inference
    reply carries ``x-llmd-sched-depth`` from the worker's scheduler) plus
    the dispatches whose reply headers have not arrived yet (requests the
    last report cannot see), so a long SSE stream does not pin a worker
    at load 1 while its scheduler is empty.  With
    ``--data-parallel-hybrid-lb`` there is no pool: every host takes
    external traffic and balances only its local ranks.
    """

    # The default of the LLMD_WORKER_BACKOFF_S knob (invalid values fall
    # back to it).
    WORKER_BACKOFF_S = 15.0
    DEPTH_HEADER = SCHED_DEPTH_HEADER
    CONNECT_TIMEOUT_S = 5.0

    def __init__(self, workers: List[str]) -> None:
        self.worker_backoff_s = env_float("LLMD_WORKER_BACKOFF_S",
                                          self.WORKER_BACKOFF_S)
        # inflight: open proxied exchanges (metrics only, not load);
        # dispatching: sequence numbers of dispatches no depth report has
        # covered yet (see load()); depth: the worker's last reported
        # scheduler depth; seq: the dispatch counter.
        self.workers = [{"url": u.rstrip("/"), "inflight": 0,
                         "dispatching": set(), "seq": 0,
                         "depth": 0, "down_until": 0.0}
                        for u in workers if u.strip()]
        # Upstream replies being read, closed by close().
        self._open: set = set()

    @staticmethod
    def load(worker: dict) -> int:
        """A worker's comparable load: its last reported scheduler depth
        plus the dispatches no report has counted yet.  A dispatch leaves
        ``dispatching`` when its own headers arrive or when a later
        dispatch's report lands (sampled after this one reached the
        worker, that depth includes it already)."""
        return worker["depth"] + len(worker["dispatching"])

    def pick(self, engine) -> Optional[dict]:
        """The worker to proxy to, or None to serve locally.  A worker
        that failed recently is skipped until its backoff ends, so a dead
        host does not keep winning the least-loaded race."""
        now = time.monotonic()
        live = [w for w in self.workers if w["down_until"] <= now]
        if not live:
            return None
        local = engine.scheduler.num_waiting + engine.scheduler.num_running
        best = min(live, key=self.load)
        return best if self.load(best) < local else None

    # Hop-by-hop headers stay on their hop; every other header is
    # forwarded both ways (a proxied request and a local one look alike
    # to clients and gateways).
    _HOP = {"host", "content-length", "transfer-encoding", "connection",
            "keep-alive", "upgrade", "te", "trailer",
            "proxy-authorization", "proxy-authenticate"}

    def alternates(self, dead: set) -> Optional[dict]:
        """The least-loaded live worker outside ``dead`` (a resume's
        target)."""
        now = time.monotonic()
        live = [w for w in self.workers
                if w["down_until"] <= now and w["url"] not in dead]
        return min(live, key=self.load) if live else None

    async def proxy(self, request: HTTPRequest, body: Dict[str, Any],
                    worker: dict, server=None) -> Optional[StreamResponse]:
        """Proxy one inference request to ``worker``, streaming its reply
        through.

        Returns None when the worker could not be reached before any byte
        of the reply was committed: the caller serves the request
        locally.  A journaled SSE stream (``LLMD_STREAM_RESUME``) whose
        worker dies mid-stream resumes on the least-loaded surviving
        worker, or on the local engine through ``server`` when none is
        left, deduped by token offset: the client's stream goes on with
        no missing and no duplicated token.  Each attempt settles its
        worker's slot, so the dead worker's stream is released and the
        resume target counts the stream once."""
        policy = stream_resume.resume_policy()
        headers = request.headers
        journal = None
        if policy.enabled and bool(body.get("stream", False)):
            try:
                criticality = parse_criticality(headers, body)
            except ValueError:
                criticality = "standard"
            try:
                deadline_epoch = parse_deadline(headers, body)
            except ValueError:
                deadline_epoch = None
            if criticality != CRITICALITY_SHEDDABLE:
                journal = StreamJournal(body, criticality=criticality,
                                        deadline_epoch=deadline_epoch)
        # One span for the dispatch (its attempts as events), parented on
        # the incoming hop, so the leader's decision reads in the trace.
        span = tracing.get_tracer("server").start_span(
            "server.dp_dispatch",
            parent=tracing.parse_trace_headers(headers),
            request_id=headers.get(REQUEST_ID_HEADER)
            or str(body.get("request_id") or "") or None,
            worker=worker["url"])
        try:
            return await self._proxy_attempts(
                request, body, worker, server, policy, journal, span)
        finally:
            span.end()

    async def _proxy_attempts(self, request, body, worker, server,
                              policy, journal, span):
        resp: Optional[StreamResponse] = None
        current: dict = worker
        dead: set = set()
        while True:
            send_body = body
            extra_headers: Dict[str, str] = {}
            if journal is not None and journal.resume_count:
                send_body = journal.resume_body()
                extra_headers = journal.resume_headers()
            extra_headers.update(tracing.trace_headers(span.ctx()))
            span.add_event("dispatch", worker=current["url"],
                           attempt=(journal.resume_count
                                    if journal is not None else 0))
            resp, broke_exc = await self._attempt(
                request, send_body, extra_headers, current, journal,
                resp, policy, span=span)
            self._settle_recoveries(journal, server)
            if broke_exc is None:
                # Relayed to its end, or None: nothing was committed and
                # the caller serves locally.
                return resp
            dead.add(current["url"])
            if journal.finish_reason and not journal.done:
                # The finish chunk was delivered and only [DONE] was lost:
                # close the stream here (a resume would decode past the
                # delivered stop).
                journal.done = True
                try:
                    await resp.write(b"data: [DONE]\n\n")
                    await resp.write_eof()
                except (ConnectionResetError, OSError):
                    pass
                return resp
            if not journal.resumable \
                    or journal.resume_count >= policy.max_attempts \
                    or self._budget_gone(journal):
                # Past the resume contract: re-raise, so the client's
                # connection closes abruptly (a clean end would hide the
                # truncation from a plain SSE client).
                if server is not None:
                    server.engine.metrics.inc_stream_resume(
                        stream_resume.OUTCOME_FAILED)
                raise broke_exc
            journal.resume_count += 1
            journal.mark_break()
            span.add_event("resume", attempt=journal.resume_count,
                           offset=journal.offset, dead=current["url"],
                           error=f"{type(broke_exc).__name__}: "
                                 f"{broke_exc}")
            target = self.alternates(dead)
            if target is None and server is not None:
                # Every worker host is down: the leader's own engine is
                # the last resume target.
                ok = await server.resume_local(request, resp, journal,
                                               parent=span)
                self._settle_recoveries(journal, server)
                if not journal.done:
                    server.engine.metrics.inc_stream_resume(
                        stream_resume.OUTCOME_FAILED)
                    if not ok:
                        raise broke_exc
                return resp
            if target is None:
                if server is not None:
                    server.engine.metrics.inc_stream_resume(
                        stream_resume.OUTCOME_FAILED)
                raise broke_exc
            logger.warning(
                "DP worker %s died mid-stream at token %d; resuming on "
                "%s (attempt %d/%d)", current["url"], journal.offset,
                target["url"], journal.resume_count, policy.max_attempts)
            current = target

    def _budget_gone(self, journal: StreamJournal) -> bool:
        left = remaining_s(journal.deadline_epoch)
        return left is not None and left <= 0

    @staticmethod
    def _settle_recoveries(journal: Optional[StreamJournal],
                           server) -> None:
        """The journal's completed (outcome, seconds) recoveries into the
        leader's metrics."""
        if journal is None or server is None:
            return
        for outcome, secs in journal.take_recoveries():
            server.engine.metrics.inc_stream_resume(outcome)
            server.engine.metrics.request_recovery.observe(secs)

    async def _attempt(self, request: HTTPRequest, body: Dict[str, Any],
                       extra_headers: Dict[str, str], worker: dict,
                       journal: Optional[StreamJournal],
                       resp: Optional[StreamResponse],
                       policy, span=None) -> tuple:
        """One forward to one worker, with the worker's load accounting.

        Returns ``(resp, exc)``: ``exc`` set when the stream died
        mid-relay after bytes were committed (resumable, or re-raised by
        the caller when recovery is off the table); ``resp`` None with no
        ``exc`` when nothing was committed (the caller serves locally)."""
        fwd_headers = {k: v for k, v in request.headers.items()
                       if k not in self._HOP and k != "content-type"}
        fwd_headers.update(extra_headers)
        seq = worker["seq"]
        worker["seq"] += 1
        worker["dispatching"].add(seq)
        headers_seen = False
        counted_self = False
        upstream = None
        # The slot is counted last, just before the try whose finally
        # settles it: nothing may raise in between.
        worker["inflight"] += 1
        try:
            async with await http_client.post_json(
                    worker["url"], request.path_qs, body, fwd_headers,
                    connect_timeout=self.CONNECT_TIMEOUT_S) as upstream:
                self._open.add(upstream)
                # The reply's headers arrived: this dispatch is in the
                # worker's own depth report now (or done), and so is every
                # older one, which reached the worker before this reply
                # left it.
                depth = upstream.headers.get(self.DEPTH_HEADER)
                worker["dispatching"] = {
                    p for p in worker["dispatching"] if p > seq}
                headers_seen = True
                # A streamed reply's report leaves at its start and counts
                # the request itself: when the exchange ends the request
                # has left the worker's scheduler, so it is taken back out
                # (in the finally).  A whole reply's report leaves at its
                # end and excludes it already.  A resumed stream settles
                # each attempt's worker here: the dead one's slot is
                # released, the stream counts once, where it is served.
                counted_self = upstream.headers.get(
                    "content-type", "").startswith("text/event-stream")
                if depth is not None:
                    try:
                        worker["depth"] = max(0, int(depth))
                    except ValueError:
                        pass
                if not counted_self:
                    # An error body or a whole reply: relayed verbatim;
                    # journals and resumes are for committed SSE streams.
                    journal = None
                if resp is not None and (upstream.status != 200
                                         or not counted_self):
                    # A resume target that refused (draining, dead on
                    # arrival): a mid-stream failure of this worker.
                    logger.warning("DP resume on %s refused: HTTP %d",
                                   worker["url"], upstream.status)
                    return resp, RuntimeError(
                        f"resume target {worker['url']} refused: "
                        f"HTTP {upstream.status}")
                if resp is None:
                    resp = await request.stream(
                        {k: v for k, v in upstream.headers.items()
                         if k not in self._HOP}, status=upstream.status)
                if journal is None:
                    while True:
                        chunk = await upstream.readany()
                        if not chunk:
                            break
                        await resp.write(chunk)
                else:
                    await stream_resume.relay_stream(
                        resp, upstream, journal, fault_key=worker["url"],
                        stall_timeout_s=policy.stall_timeout_s, span=span)
                try:
                    await resp.write_eof()
                except (ConnectionResetError, OSError):
                    pass        # the client left after the last frame
                return resp, None
        except (http_client.ClientError, asyncio.TimeoutError, OSError,
                FaultInjected, stream_resume.StreamBroken) as exc:
            worker["down_until"] = time.monotonic() + self.worker_backoff_s
            logger.warning("DP worker %s unreachable (%s); backing off %.0fs",
                           worker["url"], exc, self.worker_backoff_s)
            if resp is None:
                return None, None    # nothing committed: serve locally
            if journal is None:
                raise                # an unjournaled break: the client
            #                          sees it, as without a resume
            return resp, exc         # a mid-stream break (resumable)
        finally:
            self._open.discard(upstream)
            worker["inflight"] -= 1
            if not headers_seen:
                worker["dispatching"].discard(seq)
            elif counted_self:
                worker["depth"] = max(0, worker["depth"] - 1)

    async def close(self) -> None:
        """Close the connections of the replies being relayed."""
        for upstream in list(self._open):
            upstream.close()
        self._open.clear()


class ModelServer:
    def __init__(self, engine: Union[EngineCore, DPEngineGroup], tokenizer,
                 model_name: str) -> None:
        self.engine = engine
        self.async_engine = AsyncEngine(engine)
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.model_loaded = False
        # Multi-host DP: the leader's worker pool (set by main or tests).
        self.dp_pool: Optional[DPWorkerPool] = None
        self.started_at = time.time()
        self.app: Optional[HTTPServer] = None
        # The latency-training sidecar's base URL (--latency-training-url)
        # and the KV-events publisher (--kv-events-endpoint), when set.
        self.latency_training_url: Optional[str] = None
        self._samples: "queue.Queue[tuple]" = queue.Queue(
            maxsize=TRAINING_QUEUE_MAX)
        self._sample_thread: Optional[threading.Thread] = None
        self.kv_event_publisher = None
        # --- lifecycle ---
        # draining: readiness is down and new inference is refused (503)
        # while in-flight requests complete, bounded by drain_timeout_s;
        # stragglers past the bound are aborted.
        self.draining = False
        self._inflight = 0
        self._drain_task: Optional[asyncio.Task] = None
        self._exit_after_drain = False
        self.drain_timeout_s = env_float("LLMD_DRAIN_TIMEOUT_S", 30.0)
        # Default latency budget applied when the client sends none
        # (0 = no default).
        self.deadline_default_ms = env_int("LLMD_DEADLINE_DEFAULT_MS", 0)
        attach_tokenizer(engine, tokenizer)
        # Set when a rank of the engine's mesh died: /health fails.
        self.rank_failure: Optional[str] = None

    # ---------- app ----------

    def build_app(self) -> HTTPServer:
        self.app = HTTPServer({
            ("GET", "/health"): self.health,
            ("GET", "/v1/models"): self.models,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/debug/traces"): self.debug_traces,
            ("GET", "/version"): self.version,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/tokenize"): self.tokenize,
            ("POST", "/admin/drain"): self.admin_drain,
        }, on_startup=[self._on_startup], on_cleanup=[self._on_cleanup])
        return self.app

    async def serve(self, host: str, port: int) -> None:
        """Serve until stopped (SIGTERM after its drain, or SIGINT)."""
        app = self.build_app()
        bound = await app.start(host, port)
        logger.info("serving %s on %s:%d", self.model_name, host, bound)
        try:
            await app.wait_stopped()
        finally:
            await app.close()

    async def _on_startup(self) -> None:
        await self.async_engine.start()
        self.model_loaded = True
        try:
            # Rolling restarts: SIGTERM flips to draining instead of
            # dropping work; after the bounded drain the server stops.
            # Only installable on the main thread's loop: embedded and
            # test servers skip it.
            asyncio.get_running_loop().add_signal_handler(
                signal.SIGTERM, self._on_sigterm)
        except (NotImplementedError, RuntimeError, ValueError):
            pass

    async def _on_cleanup(self) -> None:
        self.async_engine.stop()
        if self.kv_event_publisher is not None:
            self.kv_event_publisher.stop()
        if self.dp_pool is not None:
            await self.dp_pool.close()

    # ---------- probes / meta ----------

    async def health(self, request: HTTPRequest) -> Response:
        if self.rank_failure is not None:
            return text_response(self.rank_failure, status=500)
        if self.async_engine.dead is not None:
            return text_response("engine dead", status=500)
        return text_response("ok")

    async def models(self, request: HTTPRequest) -> Response:
        if not self.model_loaded:
            return json_response({"error": "model loading"}, status=503)
        if self.draining:
            return json_response(
                {"error": "draining"}, status=503,
                headers={DRAINING_HEADER: "1"})
        return json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "created": int(self.started_at), "owned_by": "llm-d-tpu"}],
        })

    async def metrics(self, request: HTTPRequest) -> Response:
        return Response(self.engine.metrics.render())

    async def debug_traces(self, request: HTTPRequest) -> Response:
        """Every tracer's spans as JSONL (``?drain=1`` clears the rings):
        what ``scripts/trace_report.py`` and ``generate_load.py
        --trace-export`` read."""
        drain = request.query.get("drain") in ("1", "true")
        spans = ([s for t in tracing.all_tracers().values()
                  for s in t.drain()] if drain else tracing.snapshot_all())
        return Response(tracing.render_jsonl(spans).encode(),
                        content_type="application/jsonl")

    async def version(self, request: HTTPRequest) -> Response:
        from llm_d_tpu_torch import __version__
        return json_response({"version": __version__})

    async def tokenize(self, request: HTTPRequest) -> Response:
        try:
            body = request.json()
        except ValueError:
            return json_response({"error": "invalid json"}, status=400)
        ids = self.tokenizer.encode(body.get("prompt", ""))
        return json_response({"tokens": ids, "count": len(ids)})

    # ---------- drain (graceful restart protocol) ----------

    async def admin_drain(self, request: HTTPRequest) -> Response:
        """Flip this replica to draining: readiness goes 503, new inference
        is refused, in-flight requests complete up to ``drain_timeout_s``,
        then stragglers are aborted.  Idempotent."""
        self._begin_drain()
        return json_response({
            "status": "draining",
            "inflight": self._inflight,
            "timeout_s": self.drain_timeout_s,
        })

    def _on_sigterm(self) -> None:
        logger.info("SIGTERM: draining (timeout %.1fs)", self.drain_timeout_s)
        self._begin_drain(exit_after=True)

    def _begin_drain(self, exit_after: bool = False) -> None:
        if not self.draining:
            self.draining = True
            self.engine.metrics.drain_state.set(1)
            self.engine.metrics.drain_inflight.set(self._inflight)
            self._drain_task = asyncio.get_running_loop().create_task(
                self._drain_loop())
        if exit_after and not self._exit_after_drain \
                and self._drain_task is not None:
            # SIGTERM may land after /admin/drain already started the
            # drain: attach the stop to the running drain.
            self._exit_after_drain = True
            self._drain_task.add_done_callback(lambda _t: self.app.stop())

    async def _drain_loop(self) -> None:
        bound = time.monotonic() + self.drain_timeout_s
        m = self.engine.metrics
        while time.monotonic() < bound:
            m.drain_inflight.set(self._inflight)
            if self._inflight == 0 and not self.engine.has_work():
                break
            await asyncio.sleep(0.05)
        # Bounded drain: abort stragglers.
        stragglers = list(self.async_engine._streams)
        for rid in stragglers:
            logger.warning("drain timeout: aborting in-flight request %s",
                           rid)
            self.async_engine.abort(rid, notify=True)
        m.drain_inflight.set(0)
        logger.info("drain complete (%d straggler(s) aborted)",
                    len(stragglers))

    # ---------- inference ----------

    def _prompt_ids(self, body: Dict[str, Any], chat: bool) -> List[int]:
        """Prompt token ids for either endpoint schema."""
        if chat:
            messages = body.get("messages", [])
            if hasattr(self.tokenizer, "_tok") and hasattr(
                    self.tokenizer._tok, "apply_chat_template"):
                return self.tokenizer._tok.apply_chat_template(
                    messages, add_generation_prompt=True)
            text = "".join(
                f"<|{m.get('role', 'user')}|>{m.get('content', '')}"
                for m in messages) + "<|assistant|>"
            return self.tokenizer.encode(text)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return prompt
        return self.tokenizer.encode(str(prompt))

    def _make_request(self, body: Dict[str, Any], prompt_ids: List[int],
                      headers: Optional[Dict[str, str]] = None) -> Request:
        headers = headers or {}
        # Correlation: the body's request_id wins, then the x-request-id
        # header, then a fresh mint.
        rid = (body.get("request_id")
               or headers.get(REQUEST_ID_HEADER)
               or f"cmpl-{uuid_mod.uuid4().hex}")
        # Deadline: an absolute epoch from the gateway wins; a bare
        # relative budget is based here.  Epoch -> engine monotonic clock
        # so queue time spent before this hop still counts.
        deadline_epoch = parse_deadline(headers, body)
        if deadline_epoch is None and self.deadline_default_ms > 0:
            deadline_epoch = time.time() + self.deadline_default_ms / 1000.0
        deadline = None
        if deadline_epoch is not None:
            deadline = time.monotonic() + (deadline_epoch - time.time())
        req = Request(
            request_id=rid,
            prompt_token_ids=prompt_ids,
            sampling=_sampling_from_body(body),
            priority=int(body.get("priority", 0)),
            criticality=parse_criticality(headers, body),
            deadline=deadline,
        )
        ktp = body.get("kv_transfer_params")
        if ktp:
            if ktp.get("do_remote_decode"):
                # Producer role: run prefill only, pin KV for remote pull.
                req.do_remote_decode = True
            elif ktp.get("remote_block_ids") or ktp.get("do_remote_prefill"):
                req.do_remote_prefill = True
                req.kv_transfer_params = ktp
        resume = body.get("resume")
        if resume:
            # Mid-stream resume: the relay's journal arrives as generated
            # tokens.  The scheduler admits prompt + journal as a prefill
            # (restored from the prefix cache or a tier where it can,
            # recomputed where it cannot) and decoding continues from the
            # journal's end.
            ids = list(resume.get("token_ids") or [])
            vocab = self.engine.model_config.vocab_size
            if not all(type(t) is int and 0 <= t < vocab for t in ids):
                # The journal is prefilled with the prompt: an id past the
                # embedding table would fault the device.
                raise ValueError(f"resume token ids must be ints in "
                                 f"[0, {vocab})")
            off_hdr = headers.get(RESUME_OFFSET_HEADER)
            if off_hdr is not None and int(off_hdr) != len(ids):
                raise ValueError(
                    f"resume offset {off_hdr} != {len(ids)} journaled "
                    f"token ids")
            if req.do_remote_prefill or req.do_remote_decode:
                raise ValueError("resume cannot combine with PD "
                                 "kv_transfer_params roles")
            req.output_token_ids = ids
            req.resume_offset = len(ids)
        return req

    def _refuse_draining(self) -> Optional[Response]:
        """503 for new inference while draining (the gateway retries it
        on an alternate replica)."""
        if not self.draining:
            return None
        return json_response(
            {"error": "draining: replica is shutting down"}, status=503,
            headers={DRAINING_HEADER: "1"})

    async def completions(self, request: HTTPRequest) -> Response:
        return await self._inference(request, chat=False)

    async def chat_completions(self, request: HTTPRequest) -> Response:
        return await self._inference(request, chat=True)

    async def _inference(self, request: HTTPRequest, chat: bool) -> Response:
        try:
            body = request.json()
        except ValueError:
            return json_response({"error": "invalid json"}, status=400)
        refused = self._refuse_draining()
        if refused is not None:
            return refused
        if self.dp_pool is not None:
            worker = self.dp_pool.pick(self.engine)
            if worker is not None:
                proxied = await self.dp_pool.proxy(request, body, worker,
                                                   server=self)
                if proxied is not None:
                    return proxied
        missing = _unported(body, self.engine)
        if missing is not None:
            return json_response({"error": f"not served: {missing}"},
                                 status=501)
        prompt_ids = self._prompt_ids(body, chat)
        vocab = self.engine.model_config.vocab_size
        if not all(type(t) is int and 0 <= t < vocab for t in prompt_ids):
            # An id past the embedding table would fault the device.
            return json_response({"error": f"invalid request: prompt token "
                                           f"ids must be ints in [0, {vocab})"},
                                 status=400)
        return await self._run(request, body, prompt_ids, chat)

    def _usage(self, req: Request, body: Dict[str, Any]) -> Dict[str, Any]:
        """Usage block with latency actuals (and the gateway's predictions
        when it sent them)."""
        usage: Dict[str, Any] = {
            "prompt_tokens": req.num_prompt_tokens,
            "completion_tokens": len(req.output_token_ids),
            "total_tokens": req.num_tokens,
        }
        if req.first_token_time is not None:
            usage["ttft_ms"] = round(
                (req.first_token_time - req.arrival_time) * 1000.0, 3)
        n_out = len(req.output_token_ids)
        if (req.last_token_time is not None
                and req.first_token_time is not None and n_out > 1):
            usage["avg_tpot_ms"] = round(
                (req.last_token_time - req.first_token_time)
                / (n_out - 1) * 1000.0, 3)
        pred = body.get("_predicted")
        if pred:
            usage["predicted_ttft_ms"] = pred.get("ttft_ms")
            usage["avg_predicted_tpot_ms"] = pred.get("tpot_ms")
        return usage

    def _arrival_features(self, req: Request) -> Dict[str, float]:
        """The load a request meets at admission: the latency predictor's
        features."""
        return {
            "num_waiting": float(self.engine.scheduler.num_waiting),
            "num_running": float(self.engine.scheduler.num_running),
            "kv_usage": float(self.engine.kv_manager.usage),
            "prompt_tokens": float(req.num_prompt_tokens),
        }

    def _post_training_sample(self, req: Request,
                              feats: Dict[str, float]) -> None:
        """Queue a finished request's actuals for the latency-training
        sidecar.  One daemon thread posts them, so neither the event loop
        nor the engine thread waits on it; a failure, or a sample past a
        full queue, is logged at debug."""
        url = self.latency_training_url
        if not url:
            return
        samples = []
        usage = self._usage(req, {})
        if "ttft_ms" in usage:
            samples.append({"target": "ttft", "features": feats,
                            "actual_ms": usage["ttft_ms"]})
        if "avg_tpot_ms" in usage:
            tf = {k: feats[k] for k in
                  ("num_waiting", "num_running", "kv_usage")}
            samples.append({"target": "tpot", "features": tf,
                            "actual_ms": usage["avg_tpot_ms"]})
        if not samples:
            return
        if self._sample_thread is None:
            self._sample_thread = threading.Thread(
                target=self._sample_loop, name="latency-sample", daemon=True)
            self._sample_thread.start()
        try:
            self._samples.put_nowait((url, json.dumps(samples).encode()))
        except queue.Full:
            logger.debug("latency-training queue full; sample dropped")

    def _sample_loop(self) -> None:
        """The one thread that posts training samples, in arrival order."""
        while True:
            url, data = self._samples.get()
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        f"{url}/samples", data=data,
                        headers={"Content-Type": "application/json"}),
                        timeout=1.0) as r:
                    r.read()
            except Exception as exc:
                logger.debug("latency-training sample post failed: %s", exc)

    async def _run(self, http_req: HTTPRequest, body: Dict[str, Any],
                   prompt_ids: List[int], chat: bool) -> Response:
        try:
            req = self._make_request(body, prompt_ids, http_req.headers)
        except (TypeError, ValueError) as exc:
            return json_response(
                {"error": f"invalid request: {exc}"}, status=400)
        # The admission span: a root for a request straight from a client,
        # a child of the gateway's or sidecar's hop otherwise; a root's
        # trace id is seeded from the request id.  The engine's spans
        # parent on it through the request.
        headers = http_req.headers
        span = tracing.get_tracer("server").start_span(
            "server.request",
            parent=tracing.parse_trace_headers(headers),
            request_id=headers.get(REQUEST_ID_HEADER, req.request_id),
            criticality=req.criticality,
            prompt_tokens=req.num_prompt_tokens,
            resume_offset=req.resume_offset or None)
        req.trace_ctx = span.ctx()
        logger.debug("request %s admitted (trace=%s criticality=%s "
                     "prompt_tokens=%d)", req.request_id, span.trace_id,
                     req.criticality, req.num_prompt_tokens)
        if req.deadline_expired():
            # Budget already blown (e.g. spent queueing at the gateway).
            self.engine.metrics.inc_deadline_exceeded(req.criticality)
            span.end(error="deadline exceeded at admission")
            return json_response(
                {"error": "deadline exceeded", "request_id": req.request_id},
                status=504, headers={DEADLINE_EXCEEDED_HEADER: "1"})
        self._inflight += 1
        try:
            if self.draining:
                self.engine.metrics.drain_inflight.set(self._inflight)
            return await self._run_inner(http_req, body, req, chat)
        finally:
            self._inflight -= 1
            if self.draining:
                self.engine.metrics.drain_inflight.set(self._inflight)
            span.end(completion_tokens=len(req.output_token_ids),
                     finish=req.state.value)

    async def _run_inner(self, http_req: HTTPRequest, body: Dict[str, Any],
                         req: Request, chat: bool):
        created = int(time.time())
        arrival_feats = self._arrival_features(req)
        if bool(body.get("stream", False)):
            # The headers leave before this request is admitted, so the
            # depth counts it (+1): the value a fresh scrape would see.
            resp = await http_req.stream({
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                SCHED_DEPTH_HEADER: str(self._sched_depth() + 1)})
            await self._stream_tokens_into(resp, req, body, chat, created)
            await resp.write_eof()
            self._post_training_sample(req, arrival_feats)
            return resp

        final_out = None
        lp_ids: List[int] = []
        lp_vals: List[float] = []
        lp_tops: List[Dict[int, float]] = []
        async with contextlib.aclosing(
                self.async_engine.generate(req)) as outs:
            async for out in outs:
                final_out = out
                if req.sampling.logprobs is not None:
                    lp_ids.extend(out.new_token_ids)
                    lp_vals.extend(out.logprobs or [])
                    lp_tops.extend(out.top_logprobs or [])
        text = self.tokenizer.decode(req.output_token_ids)
        text, stopped = self._apply_stop_strings(req, text, text)
        finish_reason = final_out.finish_reason if final_out else None
        if stopped:
            finish_reason = "stop"
        if finish_reason == "deadline" and not req.output_token_ids:
            # Expired while queued: nothing was produced.
            return json_response(
                {"error": "deadline exceeded", "request_id": req.request_id},
                status=504, headers={DEADLINE_EXCEEDED_HEADER: "1"})
        payload = {
            "id": req.request_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": created,
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "finish_reason": finish_reason,
                **({"message": {"role": "assistant", "content": text}}
                   if chat else {"text": text}),
            }],
            "usage": self._usage(req, body),
        }
        if req.sampling.logprobs is not None and lp_ids:
            payload["choices"][0]["logprobs"] = self._logprobs_field(
                lp_ids, lp_vals, lp_tops, chat)
        if final_out is not None and final_out.kv_transfer_params:
            payload["kv_transfer_params"] = final_out.kv_transfer_params
        self._post_training_sample(req, arrival_feats)
        # This request already left the scheduler: the depth is everyone
        # still queued or running behind it.
        headers = {SCHED_DEPTH_HEADER: str(self._sched_depth())}
        if finish_reason == "deadline":
            headers[DEADLINE_EXCEEDED_HEADER] = "1"
        return json_response(payload, headers=headers)

    def _logprobs_field(self, ids: List[int], values: List[float],
                        tops: List[Dict[int, float]],
                        chat: bool) -> Dict[str, Any]:
        """The ``logprobs`` of a choice: each token's logprob and its
        top-N alternatives, in the chat or the completions schema."""
        toks = [self.tokenizer.decode([t]) for t in ids]
        if chat:
            return {"content": [
                {"token": tok, "logprob": lp,
                 "top_logprobs": [{"token": self.tokenizer.decode([tid]),
                                   "logprob": v} for tid, v in top.items()]}
                for tok, lp, top in zip(toks, values,
                                        tops or [{}] * len(toks))]}
        offsets, pos = [], 0
        for t in toks:
            offsets.append(pos)
            pos += len(t)
        return {
            "tokens": toks,
            "token_logprobs": values,
            "top_logprobs": [{self.tokenizer.decode([tid]): v
                              for tid, v in top.items()}
                             for top in tops] if tops else None,
            "text_offset": offsets,
        }

    async def _stream_tokens_into(self, resp, req: Request,
                                  body: Dict[str, Any], chat: bool,
                                  created: int,
                                  journal: Optional[StreamJournal] = None
                                  ) -> None:
        """Generate and write one (possibly resumed) request's SSE token
        stream, then the usage frame (when asked for) and ``[DONE]``.
        ``journal`` (the DP leader's local resume) sees every frame, so
        the offset dedupe and the recovery accounting work as for a
        proxied resume."""
        async def write_frame(payload: Dict[str, Any]) -> None:
            frame = b"data: " + json.dumps(payload).encode() + b"\n\n"
            if journal is None or journal.admit_frame(frame):
                await resp.write(frame)

        if req.resume_offset >= req.sampling.max_tokens:
            # The break fell between the last token and [DONE]: every
            # token was delivered; send the finish frame without decoding
            # another.
            await write_frame(self._chunk(
                req, "", RequestOutput(req.request_id, [], True, "length"),
                req.resume_offset, created, chat, finished=True,
                finish_reason="length"))
        else:
            await self._generate_stream(req, chat, created, write_frame)
        if bool((body.get("stream_options") or {}).get("include_usage")):
            await write_frame({
                "id": req.request_id,
                "object": "chat.completion.chunk" if chat
                else "text_completion",
                "created": created, "model": self.model_name,
                "choices": [],
                "usage": self._usage(req, body),
            })
        done = b"data: [DONE]\n\n"
        if journal is not None:
            journal.admit_frame(done)
        await resp.write(done)

    async def _generate_stream(self, req: Request, chat: bool,
                               created: int, write_frame) -> None:
        # The completion tokens delivered so far (a resumed request's
        # journal first: its text went out from the replica that died).
        # The engine thread appends to the request's own list, which may
        # already hold a later output's tokens when this one is written.
        ids: List[int] = list(req.output_token_ids)
        all_text_len = len(self.tokenizer.decode(ids)) if ids else 0
        first_meta_pending = req.resume_offset > 0
        async with contextlib.aclosing(
                self.async_engine.generate(req)) as outs:
            async for out in outs:
                off = len(ids)
                ids.extend(out.new_token_ids)
                text = self.tokenizer.decode(ids)
                delta, all_text_len = text[all_text_len:], len(text)
                delta, stopped = self._apply_stop_strings(req, delta, text)
                finished = out.finished or stopped
                reason = "stop" if stopped else out.finish_reason
                src = None
                if first_meta_pending:
                    first_meta_pending = False
                    src = (stream_resume.OUTCOME_RESTORED
                           if req.resume_restored_tokens > 0
                           else stream_resume.OUTCOME_RECOMPUTED)
                await write_frame(self._chunk(
                    req, delta, out, off, created, chat, finished=finished,
                    finish_reason=reason, resume_src=src))
                if stopped and not out.finished:
                    # The engine missed the stop string (it spanned a
                    # longer window): end the request through the engine
                    # thread.
                    self.async_engine.abort(req.request_id)
                    break
                if finished:
                    break

    async def resume_local(self, http_req: HTTPRequest, resp,
                           journal: StreamJournal, parent=None) -> bool:
        """Resume a journaled stream on the local engine (the DP leader's
        last resort when every worker host is down): the remaining tokens
        go into the client's reply already committed.  True when the
        stream reached ``[DONE]``.  ``parent``: the dispatch span the
        resume's span hangs under, so it stays in the request's trace."""
        body = journal.resume_body()
        chat = http_req.path.endswith("/chat/completions")
        headers = http_req.headers
        try:
            req = self._make_request(
                body, self._prompt_ids(body, chat), headers)
        except (TypeError, ValueError) as exc:
            logger.error("local resume rejected: %s", exc)
            return False
        if req.deadline_expired():
            return False
        span = tracing.get_tracer("server").start_span(
            "server.resume_local",
            parent=parent if parent is not None
            else tracing.parse_trace_headers(headers),
            request_id=req.request_id, offset=journal.offset)
        req.trace_ctx = span.ctx()
        logger.warning("resuming stream %s on the local engine at token "
                       "%d", req.request_id, journal.offset)
        # The resumed stream is the client's work in flight: a drain
        # waits for it.
        self._inflight += 1
        try:
            if self.draining:
                self.engine.metrics.drain_inflight.set(self._inflight)
            await self._stream_tokens_into(
                resp, req, body, chat, int(time.time()), journal=journal)
            await resp.write_eof()
        except (ConnectionResetError, OSError):
            # The client's transport died: free the engine's slot rather
            # than decode for nobody.
            self.async_engine.abort(req.request_id)
            span.end(error="client gone")
            return False
        except asyncio.CancelledError:
            self.async_engine.abort(req.request_id)
            span.end(error="cancelled")
            raise
        finally:
            self._inflight -= 1
            if self.draining:
                self.engine.metrics.drain_inflight.set(self._inflight)
        span.end(done=journal.done)
        return journal.done

    def _sched_depth(self) -> int:
        """Scheduler depth (waiting + running)."""
        s = self.engine.scheduler
        return int(s.num_waiting + s.num_running)

    def _apply_stop_strings(self, req: Request, delta: str, full: str):
        """Truncate output at the first stop string. Returns (delta', stopped)."""
        for s in req.sampling.stop:
            idx = full.find(s)
            if idx >= 0:
                delta_start = len(full) - len(delta)
                return (full[delta_start:idx] if idx > delta_start else ""), True
        return delta, False

    def _chunk(self, req: Request, delta: str, out: RequestOutput, off: int,
               created: int, chat: bool, finished: bool,
               finish_reason: Optional[str],
               resume_src: Optional[str] = None) -> Dict[str, Any]:
        choice: Dict[str, Any] = {
            "index": 0,
            "finish_reason": finish_reason if finished else None}
        if chat:
            choice["delta"] = {"content": delta}
        else:
            choice["text"] = delta
        chunk = {
            "id": req.request_id,
            "object": "chat.completion.chunk" if chat else "text_completion",
            "created": created, "model": self.model_name,
            "choices": [choice],
            stream_resume.CHUNK_META_KEY: stream_resume.chunk_meta(
                off, out.new_token_ids, src=resume_src,
                restored_tokens=req.resume_restored_tokens),
        }
        if out.finished and out.kv_transfer_params:
            chunk["kv_transfer_params"] = out.kv_transfer_params
        return chunk


def build_server(engine_config: EngineConfig,
                 tokenizer_name: Optional[str] = None,
                 model_name: Optional[str] = None,
                 engine: Optional[Union[EngineCore, DPEngineGroup]] = None
                 ) -> ModelServer:
    engine = engine or EngineCore(engine_config)
    tok = get_tokenizer(tokenizer_name)
    return ModelServer(engine, tok,
                       model_name or engine_config.resolve_model().name)


def derive_dp_workers(leader_address: str, n_workers: int,
                      rpc_port: int) -> List[str]:
    """Worker base URLs by the LeaderWorkerSet naming: the leader pod
    ``<lws>-<g>`` has workers ``<lws>-<g>-<i>`` in the same headless
    subdomain."""
    host = leader_address
    if "//" in host:
        host = host.split("//", 1)[1]
    host = host.split(":", 1)[0]
    pod, dot, domain = host.partition(".")
    suffix = f"{dot}{domain}" if dot else ""
    return [f"http://{pod}-{i}{suffix}:{rpc_port}"
            for i in range(1, n_workers + 1)]


def dp_local_size(args) -> int:
    """The DP ranks on this host (``--data-parallel-size-local``, by
    default all of ``--data-parallel-size``)."""
    return args.data_parallel_size_local or args.data_parallel_size


def dp_start_rank(args) -> int:
    """This host's first global DP rank: ``--data-parallel-start-rank``,
    else ``LWS_WORKER_INDEX`` times the local ranks in multi-host ranks
    mode, else 0."""
    dp_local = dp_local_size(args)
    if args.data_parallel_mode != "ranks" \
            or dp_local >= args.data_parallel_size:
        return 0
    if args.data_parallel_start_rank is not None:
        return args.data_parallel_start_rank
    return int(os.environ.get("LWS_WORKER_INDEX", "0")) * dp_local


def dp_workers_from_args(args) -> List[str]:
    """The worker hosts' URLs the leader dispatches to:
    ``--data-parallel-workers``, else derived from the leader's address
    (``--data-parallel-address`` or ``LWS_LEADER_ADDRESS``) and
    ``--data-parallel-rpc-port`` (default ``--port``); empty when there
    is no address."""
    workers = [w.strip() for w in args.data_parallel_workers.split(",")
               if w.strip()]
    if workers:
        return workers
    leader = (args.data_parallel_address
              or os.environ.get("LWS_LEADER_ADDRESS", ""))
    if not leader:
        return []
    n_hosts = args.data_parallel_size // dp_local_size(args)
    return derive_dp_workers(leader, n_hosts - 1,
                             args.data_parallel_rpc_port or args.port)


def mesh_from_args(args) -> Optional[MeshConfig]:
    """The JAX server's mapping: ``--data-parallel-mode spmd`` puts dp and
    tp on one mesh (the experts over all ``dp * tp`` ranks); ``ranks``
    keeps dp out of it (the DP group's engines are its ranks)."""
    dp, tp = args.data_parallel_size, args.tensor_parallel_size
    if dp > 1 and args.data_parallel_mode == "spmd":
        return MeshConfig(dp=dp, tp=tp)
    return MeshConfig(tp=tp) if tp > 1 else None


def world_from_args(args) -> int:
    """The rank processes ``args`` serves: the mesh's devices (1 for one
    engine or a DP group in this process)."""
    mesh = mesh_from_args(args)
    return mesh.num_devices if mesh is not None else 1


def lws_layout_from_args(args, env: Optional[dict] = None):
    """This host's share of one mesh across the hosts of a LeaderWorkerSet
    group (``parallel.mesh.lws_rank_layout``: ``LWS_LEADER_ADDRESS``,
    ``LWS_GROUP_SIZE`` > 1, ``LWS_WORKER_INDEX``), the JAX server's rule:
    the hosts join one process group in spmd mode and with tp alone, while
    ranks mode with dp > 1 keeps independent hosts.  None outside a
    group; raises ValueError, naming the sizes, where the mesh does not
    divide over the hosts."""
    from llm_d_tpu_torch.parallel.mesh import lws_rank_layout
    if args.data_parallel_mode == "ranks" and args.data_parallel_size > 1:
        return None
    return lws_rank_layout(world_from_args(args), env)


def engine_config_from_args(args) -> EngineConfig:
    """Parsed CLI flags -> EngineConfig."""
    return EngineConfig(
        model=args.model, block_size=args.block_size,
        num_blocks=args.num_blocks, max_num_seqs=args.max_num_seqs,
        max_num_batched_tokens=args.max_num_batched_tokens,
        num_scheduler_steps=args.num_scheduler_steps,
        async_scheduling=args.async_scheduling,
        kv_offload_blocks=args.kv_offload_blocks,
        kv_shared_tier_port=args.kv_shared_tier_port,
        kv_shared_tier_peers=shared_tier_peers(args),
        quantization=args.quantization,
        kv_cache_dtype=args.kv_cache_dtype,
        kv_cache_hbm_bytes=(int(args.kv_cache_hbm_gb * 2**30)
                            if args.kv_cache_hbm_gb else None),
        enable_eplb=args.enable_eplb,
        eplb_config=json.loads(args.eplb_config) if args.eplb_config else None,
        enable_dbo=args.enable_dbo,
        dbo_decode_token_threshold=args.dbo_decode_token_threshold,
        dbo_prefill_token_threshold=args.dbo_prefill_token_threshold,
        spec_k=args.spec_k,
        spec_strict=True if args.spec_strict else None,
        mesh=mesh_from_args(args),
        allow_device_subset=args.allow_device_subset,
        device=args.device)


# The JAX server's flags this server does not serve, by argparse dest,
# with what is missing.  Each is refused when set to anything but its
# default.
UNSERVED_FLAGS = {
    "compilation_cache_dir": "XLA's compilation cache has no counterpart "
                             "(the kernels build with nvcc)",
}

# The flags of multi-host data parallelism, served in ranks mode.
MULTI_HOST_FLAGS = ("--data-parallel-start-rank", "--data-parallel-address",
                    "--data-parallel-rpc-port", "--data-parallel-hybrid-lb",
                    "--data-parallel-workers")

# Served flags that need a module beyond the standard library, by
# argparse dest.  Where one is missing the flag is refused by name:
# starting without it would hide the misconfiguration.
FLAG_MODULES = {
    "config": ("yaml",),
    "config_overlay": ("yaml",),
    "kv_events_endpoint": ("zmq", "msgpack"),
}


def build_arg_parser() -> argparse.ArgumentParser:
    """The JAX server's flags (same names and defaults) plus ``--device``;
    ``check_served`` refuses the ones in ``UNSERVED_FLAGS``."""
    p = argparse.ArgumentParser("llmd-serve-torch")
    p.add_argument("--config", default=None)
    p.add_argument("--config-overlay", action="append", default=[])
    p.add_argument("--compilation-cache-dir", default=None)
    p.add_argument("--model", default="tiny")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--max-num-seqs", type=int, default=128)
    p.add_argument("--max-num-batched-tokens", type=int, default=2048)
    p.add_argument("--tensor-parallel-size", type=int, default=1)
    p.add_argument("--data-parallel-size", type=int, default=1)
    p.add_argument("--data-parallel-size-local", type=int, default=None)
    p.add_argument("--data-parallel-start-rank", type=int, default=None)
    p.add_argument("--data-parallel-address", default=None)
    p.add_argument("--data-parallel-rpc-port", type=int, default=None)
    p.add_argument("--data-parallel-hybrid-lb", action="store_true")
    p.add_argument("--data-parallel-workers", default="")
    p.add_argument("--data-parallel-mode", choices=["spmd", "ranks"],
                   default="spmd")
    p.add_argument(
        "--num-scheduler-steps", type=int, default=1,
        help="decode steps per dispatch on pure-decode rounds (each block "
             "one CUDA graph replay on the card)")
    p.add_argument(
        "--async-scheduling", action="store_true",
        help="keep one decode block in flight and dispatch its successor "
             "before retiring it; requires --num-scheduler-steps > 1")
    p.add_argument("--allow-device-subset", action="store_true")
    p.add_argument("--latency-training-url", default=None)
    p.add_argument(
        "--kv-offload-blocks", type=int, default=0,
        help="host-RAM tier capacity in KV blocks (0 = off); evicted "
             "device blocks stay restorable (reference: tiered-prefix-cache)")
    p.add_argument(
        "--kv-shared-tier-port", type=int, default=None,
        help="serve host-tier blocks to peer pods on this port (0 = "
             "ephemeral; requires --kv-offload-blocks > 0; the LMCache "
             "role)")
    p.add_argument(
        "--kv-shared-tier-peers", default="",
        help="comma list of shared-tier servers consulted on prefix miss "
             "before recompute: static host:port entries and discovery "
             "specs (dns:<name>:<port>, k8s:[<ns>/]<service>:<port>), "
             "re-resolved every few seconds")
    p.add_argument("--quantization", default=None, choices=[None, "int8"],
                   help="MoE expert-weight quantization")
    p.add_argument("--kv-cache-dtype", default=None,
                   choices=[None, "bf16", "int8"],
                   help="paged-KV cache dtype (default: LLMD_KV_CACHE_DTYPE, "
                        "else bf16; LLMD_MLA_LATENT_DTYPE gates the MLA "
                        "latent separately)")
    p.add_argument(
        "--kv-cache-hbm-gb", type=float, default=None,
        help="size the block pool from this device-memory budget in GiB "
             "(dtype-aware: an int8 cache fits ~2x the blocks); overrides "
             "--num-blocks")
    p.add_argument(
        "--enable-dbo", action="store_true",
        help="dual-batch overlap on a mesh: from the phase's threshold on, "
             "the EP dispatch runs in >= 2 chunks, one chunk's exchange in "
             "flight while the other's experts compute (reference: "
             "--enable-dbo, decode.yaml:78); MoE models only, nothing to "
             "overlap on one device")
    p.add_argument(
        "--dbo-decode-token-threshold", type=int, default=32,
        help="min tokens before DBO splits a decode batch (decode.yaml:98)")
    p.add_argument(
        "--dbo-prefill-token-threshold", type=int, default=32,
        help="min tokens before DBO splits a prefill batch (prefill.yaml:79)")
    p.add_argument(
        "--enable-eplb", action="store_true",
        help="MoE expert load balancing with redundant experts (reference: "
             "--enable-eplb, decode.yaml:79); one card: the identity "
             "placement, routed ids collected, imbalance published; a "
             "mesh: each rank its P / ep physical slots, live migrations "
             "between ranks")
    p.add_argument(
        "--eplb-config", default=None,
        help='JSON eplb config, e.g. \'{"window_size":1000,'
             '"step_interval":3000,"num_redundant_experts":32}\'')
    p.add_argument(
        "--spec-k", type=int, default=None,
        help="speculative decode (MTP draft-and-verify): draft tokens per "
             "decode step, verified in one fused forward; greedy and "
             "seeded output equals non-spec decode.  Default: LLMD_SPEC_K "
             "(0 = off); needs --num-scheduler-steps 1")
    p.add_argument(
        "--spec-strict", action="store_true",
        help="refuse to start instead of demoting spec decode at startup "
             "(LLMD_SPEC_STRICT); no startup condition demotes it today")
    p.add_argument(
        "--kv-transfer-config", default=None,
        help="KV connector JSON for P/D disaggregation: kv_role "
             "(kv_producer | kv_consumer | kv_both), kv_ip (address "
             "advertised to consumers), kv_port (0 = ephemeral), "
             "kv_load_failure_policy (fail | recompute)")
    p.add_argument(
        "--kv-events-endpoint", default=None,
        help="publish KV-cache block events to this ZMQ endpoint for the "
             "EPP's precise prefix index, e.g. tcp://epp:5557 (needs zmq "
             "and msgpack)")
    p.add_argument(
        "--pod-identity", default=None,
        help="this replica's address as the EPP sees it (host:port); "
             "defaults to <host>:<port>")
    p.add_argument(
        "--device", default=None,
        help="torch device to serve on (default: the first CUDA card; "
             "'cpu' runs the plain PyTorch path and must be asked for)")
    return p


def shared_tier_peers(args) -> tuple:
    return tuple(s.strip() for s in args.kv_shared_tier_peers.split(",")
                 if s.strip())


def check_modules(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` for the first flag of ``FLAG_MODULES`` that is set
    while a module it needs cannot be imported."""
    for dest, modules in FLAG_MODULES.items():
        if getattr(args, dest) == parser.get_default(dest):
            continue
        missing = []
        for name in modules:
            try:
                importlib.import_module(name)
            except ImportError:
                missing.append(name)
        if missing:
            flag = "--" + dest.replace("_", "-")
            parser.error(f"{flag} needs the Python module(s) "
                         f"{', '.join(missing)}, which cannot be imported "
                         f"here")


def apply_config_layers(parser: argparse.ArgumentParser, args,
                        argv: Optional[List[str]] = None) -> None:
    """``--config`` then each ``--config-overlay``, merged into ``args``
    with the command line winning (before ``check_served``, so a layer
    that sets an unserved flag is refused too)."""
    if not (args.config or args.config_overlay):
        return
    layers = ([args.config] if args.config else []) + args.config_overlay
    try:
        merged = load_layers(layers)
    except ImportError as exc:
        flag = "--config" if args.config else "--config-overlay"
        parser.error(f"{flag} needs the Python module(s) {exc.name}, "
                     f"which cannot be imported here")
    apply_file_config(args, parser, merged, argv=argv)


def check_served(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` for the first unserved flag set to anything but
    its default, for a served flag whose module is missing, for a
    shared-tier discovery spec that does not parse, and for a shared tier
    without the host tier it serves from."""
    for dest, why in UNSERVED_FLAGS.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            parser.error(f"{flag} is not served by the PyTorch port: {why}")
    check_modules(parser, args)
    from llm_d_tpu_torch.utils import discovery
    for spec in shared_tier_peers(args):
        if discovery.is_dynamic(spec):
            try:
                discovery.parse_discover_spec(spec)
            except ValueError as exc:
                parser.error(f"--kv-shared-tier-peers {spec}: {exc}")
    if (args.kv_shared_tier_port is not None or shared_tier_peers(args)) \
            and args.kv_offload_blocks <= 0:
        # Running with the cross-pod cache off while the operator
        # configured it is a misconfiguration, not a fallback.
        parser.error("--kv-shared-tier-port/--kv-shared-tier-peers require "
                     "--kv-offload-blocks > 0 (the shared tier serves the "
                     "host tier's blocks)")


def check_dp_flags(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` for the data-parallel layouts the port does not
    serve: a mesh that does not divide over an LWS group's hosts, a
    ``--data-parallel-size-local`` that contradicts the group, ranks mode's
    multi-host flags in spmd mode, and ``ranks`` with ranks wider than one
    device, on one host or across hosts."""
    dp = args.data_parallel_size
    if dp < 1:
        parser.error(f"--data-parallel-size {dp} must be >= 1")
    dp_local = dp_local_size(args)
    if dp_local > dp or dp % dp_local:
        parser.error(f"--data-parallel-size-local {dp_local} must divide "
                     f"--data-parallel-size {dp}")
    ranks = args.data_parallel_mode == "ranks"
    if not ranks:
        for flag in MULTI_HOST_FLAGS:
            dest = flag[2:].replace("-", "_")
            if getattr(args, dest) != parser.get_default(dest):
                parser.error(
                    f"{flag} is not served in --data-parallel-mode spmd: "
                    "it belongs to --data-parallel-mode ranks (independent "
                    f"hosts: {', '.join(MULTI_HOST_FLAGS)}); in spmd mode "
                    "the hosts of a LeaderWorkerSet group join one mesh "
                    "from LWS_LEADER_ADDRESS, LWS_GROUP_SIZE and "
                    "LWS_WORKER_INDEX")
    try:
        layout = lws_layout_from_args(args)
    except ValueError as exc:
        parser.error(f"--data-parallel-size {dp} --tensor-parallel-size "
                     f"{args.tensor_parallel_size}: {exc}")
    if layout is not None and args.data_parallel_size_local \
            and dp_local * layout.hosts != dp:
        parser.error(
            f"--data-parallel-size-local {dp_local} contradicts the "
            f"LeaderWorkerSet group: LWS_GROUP_SIZE={layout.hosts} hosts "
            f"hold --data-parallel-size {dp} as {dp // layout.hosts} dp "
            "ranks a host")
    if dp > 1 and ranks and args.tensor_parallel_size > 1:
        parser.error(
            "--data-parallel-mode ranks with --tensor-parallel-size "
            f"{args.tensor_parallel_size} is not served by the PyTorch port "
            "(a rank's submesh needs a process group of its own): use "
            "--data-parallel-mode spmd, or one device a rank")


def check_mesh_flags(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` for a mesh layout the port does not serve,
    before any rank starts.  Spec decode, the fused rounds, multistep
    blocks (ranks that share a card run the bodies eagerly), the host and
    shared tiers are served on a mesh."""
    check_dp_flags(parser, args)


def _local(rank: int, world: int, layout) -> Tuple[int, int]:
    """(this rank's index on its host, the host's rank count)."""
    if layout is None:
        return rank, world
    return rank - layout.first, layout.local


def _rank_main(rank: int, world: int, address: str, argv: List[str],
               layout=None, ready=None) -> None:
    """Ranks 1..N-1 of a mesh (``--tensor-parallel-size``, with
    ``--data-parallel-size`` in spmd mode), or a worker host's ranks of an
    LWS group's mesh (``layout``): the same flags, the engine on this
    rank's card, then rank 0's steps until it stops the mesh.  ``ready``
    is set once every rank has built.  SIGTERM and SIGINT are rank 0's to
    act on."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    logging.basicConfig(level=logging.INFO)
    import torch.distributed as dist
    from llm_d_tpu_torch.parallel.mesh import init_distributed
    from llm_d_tpu_torch.utils.device import resolve_device
    p = build_arg_parser()
    args = p.parse_args(argv)
    apply_config_layers(p, args, argv)
    local = _local(rank, world, layout)
    init_distributed(rank, world, address,
                     resolve_device(args.device, local[0]), local=local)
    engine = EngineCore(engine_config_from_args(args))
    attach_tokenizer(engine, get_tokenizer(args.tokenizer))
    dist.barrier()                   # every rank has built
    if ready is not None:
        ready.set()
    engine.follow(record=False)
    dist.barrier()                   # every rank has read the stop
    _log_kernel_launches(rank, engine)
    dist.destroy_process_group()


def _log_kernel_launches(rank: int, engine: EngineCore) -> None:
    """A stopping rank's kernel launches (each wrapper's eager count plus
    what its block graphs' replays launched), one log line, and its last
    steps' prefill chunk sizes (every rank's are rank 0's), another."""
    from llm_d_tpu_torch.engine.cuda_graph import kernel_counts
    counts = kernel_counts()
    if engine._graphs is not None:
        for name, n in engine._graphs.launches.items():
            counts[name] += n
    logger.info("mesh rank %d stopped: kernel launches %s", rank,
                json.dumps(counts))
    logger.info("mesh rank %d prefill chunks %s", rank,
                json.dumps(list(engine.prefill_chunks)))


# After a rank dies, /health answers 500 this long before the server
# stops (so a liveness probe sees the failure), then it exits non-zero.
RANK_FAILURE_GRACE_S = 2.0


def _watch_ranks(server: "ModelServer", procs, loop, stopping) -> None:
    """Rank 0's watch over the other ranks: one that exits while the
    server runs fails /health and stops the server (exit non-zero)."""
    while not stopping.is_set():
        for p in procs:
            if not p.is_alive():
                if stopping.is_set():
                    return
                server.rank_failure = (f"rank {p.name} exited with code "
                                       f"{p.exitcode}")
                logger.error("mesh: %s; stopping", server.rank_failure)
                stopping.wait(RANK_FAILURE_GRACE_S)
                loop.call_soon_threadsafe(server.app.stop)
                return
        stopping.wait(0.5)


def _serve_mesh(args, argv: List[str], layout=None) -> int:
    """Rank 0 of a mesh of ``dp * tp`` ranks: start the other ranks of
    this host (all of them, or with an LWS group's ``layout`` the leader
    host's share, the rest joining from the worker hosts), build, wait
    until every rank has built, serve; then stop every rank."""
    import torch.distributed as dist
    from llm_d_tpu_torch.parallel.launch import free_port, start_ranks
    from llm_d_tpu_torch.parallel.mesh import init_distributed
    from llm_d_tpu_torch.utils.device import resolve_device
    world = world_from_args(args)
    if layout is None:
        address, ranks = f"127.0.0.1:{free_port()}", None
    else:
        address, ranks = layout.address, range(1, layout.local)
        logger.info("LWS group: leader host, ranks 0..%d of %d; the %d "
                    "other hosts join at %s", layout.local - 1, world,
                    layout.hosts - 1, address)
    procs = start_ranks(world, address, _rank_main, (argv, layout),
                        ranks=ranks)
    stopping = threading.Event()
    try:
        backend = init_distributed(0, world, address,
                                   resolve_device(args.device, 0),
                                   local=_local(0, world, layout))
        logger.info("mesh: %s, %d ranks on %s", mesh_from_args(args),
                    world, backend)
        server = build_server(engine_config_from_args(args), args.tokenizer)
        connector = kv_connector_from_args(args)
        if connector is not None:
            # Rank 0's: the transport server and the pulls are its own.
            server.engine.kv_connector = connector
            logger.info("KV connector: role=%s serving on %s:%s",
                        connector.config.kv_role, connector.host,
                        connector.port)
        dist.barrier()               # every rank has built
        if args.latency_training_url:
            server.latency_training_url = \
                args.latency_training_url.rstrip("/")
        publisher = kv_event_publisher_from_args(args)
        if publisher is not None:
            publisher.attach(server.engine.kv_manager)
            publisher.start()
            server.kv_event_publisher = publisher

        async def serve():
            watcher = threading.Thread(
                target=_watch_ranks, name="rank-watch", daemon=True,
                args=(server, procs, asyncio.get_running_loop(), stopping))
            watcher.start()
            await server.serve(args.host, args.port)

        asyncio.run(serve())
        stopping.set()
        if server.rank_failure is not None:
            return 1
        server.engine.stop_mesh()
        dist.barrier()               # every rank has read the stop
        _log_kernel_launches(0, server.engine)
        for p in procs:
            p.join(timeout=60)
        dist.destroy_process_group()
        return 0 if all(p.exitcode == 0 for p in procs) else 1
    finally:
        stopping.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _serve_worker_host(args, argv: List[str], layout) -> int:
    """A worker host of an LWS group's mesh: start this host's ranks as
    followers of rank 0 (on the leader host) and answer the pod's probes,
    ``/health`` and ``/v1/models`` on ``--port``, and nothing else: rank 0
    serves the completions.  Returns 0 once rank 0 has stopped the mesh
    and every rank here exited 0; non-zero at once when a rank here fails
    (the leader died, or a rank crashed), so the group is recreated
    instead of hanging."""
    import multiprocessing
    from llm_d_tpu_torch.parallel.launch import start_ranks
    world = world_from_args(args)
    model_name = engine_config_from_args(args).resolve_model().name
    ready = multiprocessing.get_context("spawn").Event()
    first, last = layout.first, layout.first + layout.local - 1
    logger.info("LWS group: worker host, ranks %d..%d of %d, joining the "
                "leader at %s", first, last, world, layout.address)
    procs = start_ranks(world, layout.address, _rank_main,
                        (argv, layout, ready),
                        ranks=range(first, last + 1))
    failure: List[str] = []
    started = time.time()

    async def health(request: HTTPRequest) -> Response:
        if failure:
            return text_response(failure[0], status=500)
        return text_response("ok")

    async def models(request: HTTPRequest) -> Response:
        if not ready.is_set():
            return json_response({"error": "model loading"}, status=503)
        return json_response({
            "object": "list",
            "data": [{"id": model_name, "object": "model",
                      "created": int(started), "owned_by": "llm-d-tpu"}]})

    def watch(app: HTTPServer, loop) -> None:
        while True:
            for p in procs:
                if not p.is_alive() and p.exitcode != 0:
                    failure.append(f"rank {p.name} exited with code "
                                   f"{p.exitcode}")
                    logger.error("LWS worker host: %s; stopping",
                                 failure[0])
                    loop.call_soon_threadsafe(app.stop)
                    return
            if not any(p.is_alive() for p in procs):
                logger.info("LWS worker host: rank 0 stopped the mesh")
                loop.call_soon_threadsafe(app.stop)
                return
            time.sleep(0.2)

    async def serve() -> None:
        app = HTTPServer({("GET", "/health"): health,
                          ("GET", "/v1/models"): models})
        bound = await app.start(args.host, args.port)
        logger.info("LWS worker host: probes on %s:%d", args.host, bound)
        loop = asyncio.get_running_loop()
        # SIGTERM: the ranks are rank 0's to stop (the leader's drain).
        loop.add_signal_handler(signal.SIGTERM, lambda: logger.info(
            "LWS worker host: SIGTERM; the ranks follow rank 0"))
        threading.Thread(target=watch, args=(app, loop), name="rank-watch",
                         daemon=True).start()
        try:
            await app.wait_stopped()
        finally:
            await app.close()

    try:
        asyncio.run(serve())
        for p in procs:
            p.join(timeout=30)
        return 0 if not failure and all(p.exitcode == 0 for p in procs) \
            else 1
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def kv_connector_config_from_args(args):
    """The ``KVConnectorConfig`` of ``--kv-transfer-config``, or None."""
    if not args.kv_transfer_config:
        return None
    from llm_d_tpu_torch.transfer import KVConnectorConfig
    ktc = json.loads(args.kv_transfer_config)
    return KVConnectorConfig(
        kv_role=ktc.get("kv_role", "kv_both"),
        host=ktc.get("kv_ip", "127.0.0.1"),
        port=int(ktc.get("kv_port", 0)),
        kv_load_failure_policy=ktc.get("kv_load_failure_policy", "fail"))


def kv_connector_from_args(args):
    """The engine's KV connector of ``--kv-transfer-config``, or None."""
    config = kv_connector_config_from_args(args)
    if config is None:
        return None
    from llm_d_tpu_torch.transfer import TpuConnector
    return TpuConnector(config)


def kv_event_publisher_from_args(args):
    """The ``ZmqKvEventPublisher`` of ``--kv-events-endpoint`` (not yet
    started), or None.  The EPP keys its prefix index by the address it
    routes to, so a wildcard ``--host`` without ``--pod-identity`` is
    replaced by this host's address (with a warning)."""
    if not args.kv_events_endpoint:
        return None
    from llm_d_tpu_torch.events.kv_events import ZmqKvEventPublisher
    identity = args.pod_identity
    if not identity:
        host = args.host
        if host in ("0.0.0.0", "::", ""):
            import socket
            host = socket.gethostbyname(socket.gethostname())
            logger.warning(
                "kv-events: --pod-identity not set and --host is a "
                "wildcard; guessing %s:%s (set --pod-identity to the "
                "address the EPP routes to)", host, args.port)
        identity = f"{host}:{args.port}"
    return ZmqKvEventPublisher(args.kv_events_endpoint, identity,
                               model=args.model)


def main(argv: Optional[List[str]] = None) -> None:
    import sys
    p = build_arg_parser()
    args = p.parse_args(argv)
    apply_config_layers(p, args, argv)
    check_served(p, args)
    check_mesh_flags(p, args)
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    layout = lws_layout_from_args(args)
    if layout is not None and not layout.leader:
        sys.exit(_serve_worker_host(args, argv, layout))
    if world_from_args(args) > 1:
        sys.exit(_serve_mesh(args, argv, layout))
    server = server_from_args(args)
    asyncio.run(server.serve(args.host, args.port))


def server_from_args(args) -> ModelServer:
    """The server of one process (one engine, or this host's DP group in
    ranks mode, with the leader's worker pool across hosts), its KV
    connectors and KV-events publisher attached: what ``main`` serves
    when no mesh is asked for."""
    cfg = engine_config_from_args(args)
    engine = None
    dp, dp_local = args.data_parallel_size, dp_local_size(args)
    multi_host = dp_local < dp           # ranks mode (check_dp_flags)
    start_rank = dp_start_rank(args)
    if multi_host:
        # The hosts run independent engine ranks (no process group spans
        # them); the LWS environment drives only the rank arithmetic and
        # the workers' addresses.
        logger.info("multi-host DP: local ranks %d..%d of %d (%s)",
                    start_rank, start_rank + dp_local - 1, dp,
                    "hybrid-lb" if args.data_parallel_hybrid_lb
                    else "leader dispatch")
    if dp > 1:
        # --data-parallel-mode ranks: this host's one-device engines
        # behind the local least-loaded dispatcher.
        engine = DPEngineGroup(cfg, dp_size=dp_local, start_rank=start_rank)
        logger.info("DP group: ranks %d..%d on %s", start_rank,
                    start_rank + dp_local - 1,
                    [str(e.device) for e in engine.engines])
    server = build_server(cfg, args.tokenizer, engine=engine)
    if multi_host and not args.data_parallel_hybrid_lb and start_rank == 0:
        # The leader's dispatch across hosts, over the OpenAI HTTP surface.
        workers = dp_workers_from_args(args)
        if workers:
            server.dp_pool = DPWorkerPool(workers)
            logger.info("DP leader dispatching across %d worker hosts: %s",
                        len(workers), workers)
        else:
            logger.warning(
                "multi-host DP leader has no worker addresses (pass "
                "--data-parallel-workers or run under LWS); serving "
                "local ranks only")
    if args.latency_training_url:
        server.latency_training_url = args.latency_training_url.rstrip("/")
    conn_cfg = kv_connector_config_from_args(args)
    if conn_cfg is not None and engine is not None:
        # A connector a rank, explicit ports offset by the rank.
        engine.set_kv_connectors(conn_cfg)
        logger.info("KV connectors: role=%s serving on ports %s",
                    conn_cfg.kv_role, [c.port for c in engine.kv_connectors])
    elif conn_cfg is not None:
        connector = kv_connector_from_args(args)
        server.engine.kv_connector = connector
        logger.info("KV connector: role=%s serving on %s:%s",
                    connector.config.kv_role, connector.host, connector.port)
    publisher = kv_event_publisher_from_args(args)
    if publisher is not None:
        # A DP group caches blocks in every rank's manager: the EPP's
        # prefix index must see them all.
        for km in getattr(server.engine, "kv_managers",
                          [server.engine.kv_manager]):
            publisher.attach(km)
        publisher.start()
        server.kv_event_publisher = publisher
        logger.info("KV events: publishing %s to %s",
                    publisher.topic.decode(), publisher.endpoint)
    return server


if __name__ == "__main__":
    main()
