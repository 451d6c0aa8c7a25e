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
cache: ``--kv-offload-blocks``, ``--kv-shared-tier-port`` and static
``host:port`` entries of ``--kv-shared-tier-peers`` (dynamic ``dns:`` /
``k8s:`` specs are refused by name).  On the CPU,
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
than the host's card count.  On a mesh P/D, the host tier, spec decode,
EPLB and (gloo on CUDA) ``--num-scheduler-steps`` > 1 are refused by
name.

Not served (each refused with a message naming it, not quietly
dropped): the DP and DBO flags (``UNSERVED_FLAGS``), and the relay half
of resume (the DP leader's).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import importlib
import queue
import signal
import threading
import time
import urllib.request
import uuid as uuid_mod
from typing import Any, Dict, List, Optional

from llm_d_tpu_torch.engine.async_engine import AsyncEngine
from llm_d_tpu_torch.engine.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request, RequestOutput
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.mesh import MeshConfig
from llm_d_tpu_torch.server import stream_resume
from llm_d_tpu_torch.server.http_server import (
    HTTPServer, Response, json_response, text_response)
from llm_d_tpu_torch.server.http_server import Request as HTTPRequest
from llm_d_tpu_torch.utils import tracing
from llm_d_tpu_torch.utils.config import (
    apply_file_config, env_float, env_int, load_layers)
from llm_d_tpu_torch.utils.lifecycle import (
    DEADLINE_EXCEEDED_HEADER,
    DRAINING_HEADER,
    REQUEST_ID_HEADER,
    RESUME_OFFSET_HEADER,
    SCHED_DEPTH_HEADER,
    parse_criticality,
    parse_deadline,
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


class ModelServer:
    def __init__(self, engine: EngineCore, tokenizer, model_name: str) -> None:
        self.engine = engine
        self.async_engine = AsyncEngine(engine)
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.model_loaded = False
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
                                  created: int) -> None:
        """Generate and write one (possibly resumed) request's SSE token
        stream, then the usage frame (when asked for) and ``[DONE]``."""
        async def write_frame(payload: Dict[str, Any]) -> None:
            await resp.write(b"data: " + json.dumps(payload).encode()
                             + b"\n\n")

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
        await resp.write(b"data: [DONE]\n\n")

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
                 engine: Optional[EngineCore] = None) -> ModelServer:
    engine = engine or EngineCore(engine_config)
    tok = get_tokenizer(tokenizer_name)
    return ModelServer(engine, tok,
                       model_name or engine_config.resolve_model().name)


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
        spec_k=args.spec_k,
        spec_strict=True if args.spec_strict else None,
        mesh=(MeshConfig(tp=args.tensor_parallel_size)
              if args.tensor_parallel_size > 1 else None),
        allow_device_subset=args.allow_device_subset,
        device=args.device)


# The JAX server's flags this server does not serve, by argparse dest,
# with what is missing.  Each is refused when set to anything but its
# default.
_MULTI_DEVICE = ("DP attention is not served by the port yet (one mesh "
                 "of --tensor-parallel-size ranks)")
UNSERVED_FLAGS = {
    "compilation_cache_dir": "XLA's compilation cache has no counterpart "
                             "(the kernels build with nvcc)",
    "data_parallel_size": _MULTI_DEVICE,
    "data_parallel_size_local": _MULTI_DEVICE,
    "data_parallel_start_rank": _MULTI_DEVICE,
    "data_parallel_address": _MULTI_DEVICE,
    "data_parallel_rpc_port": _MULTI_DEVICE,
    "data_parallel_hybrid_lb": _MULTI_DEVICE,
    "data_parallel_workers": _MULTI_DEVICE,
    "data_parallel_mode": _MULTI_DEVICE,
    "enable_dbo": "dual-batch overlap is not ported",
    "dbo_decode_token_threshold": "dual-batch overlap is not ported",
    "dbo_prefill_token_threshold": "dual-batch overlap is not ported",
}

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
        help="comma list of static host:port shared-tier servers consulted "
             "on prefix miss before recompute (dynamic dns:/k8s: specs are "
             "not served)")
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
    p.add_argument("--enable-dbo", action="store_true")
    p.add_argument("--dbo-decode-token-threshold", type=int, default=32)
    p.add_argument("--dbo-prefill-token-threshold", type=int, default=32)
    p.add_argument(
        "--enable-eplb", action="store_true",
        help="MoE expert load balancing with redundant experts (reference: "
             "--enable-eplb, decode.yaml:79); one card: the identity "
             "placement, routed ids collected, imbalance published")
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
    its default, for a served flag whose module is missing, for dynamic
    shared-tier peer specs, and for a shared tier without the host tier
    it serves from."""
    for dest, why in UNSERVED_FLAGS.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            parser.error(f"{flag} is not served by the PyTorch port: {why}")
    check_modules(parser, args)
    from llm_d_tpu_torch.engine.offload import DYNAMIC_PEER_PREFIXES
    dynamic = [p for p in shared_tier_peers(args)
               if p.startswith(DYNAMIC_PEER_PREFIXES)]
    if dynamic:
        parser.error(
            f"--kv-shared-tier-peers {','.join(dynamic)} is not served by "
            "the PyTorch port: dynamic peer discovery (dns:/k8s:) needs the "
            "EPP's aiohttp resolvers; pass static host:port peers")
    if (args.kv_shared_tier_port is not None or shared_tier_peers(args)) \
            and args.kv_offload_blocks <= 0:
        # Running with the cross-pod cache off while the operator
        # configured it is a misconfiguration, not a fallback.
        parser.error("--kv-shared-tier-port/--kv-shared-tier-peers require "
                     "--kv-offload-blocks > 0 (the shared tier serves the "
                     "host tier's blocks)")


def check_mesh_flags(parser: argparse.ArgumentParser, args) -> None:
    """``parser.error`` for a flag the engine refuses on a mesh, before
    any rank starts."""
    tp = args.tensor_parallel_size
    if tp <= 1:
        return
    refused = {
        "--kv-transfer-config": bool(args.kv_transfer_config),
        "--kv-offload-blocks": args.kv_offload_blocks > 0,
        "--spec-k": bool(args.spec_k),
        "--enable-eplb": args.enable_eplb,
    }
    for flag, on in refused.items():
        if on:
            parser.error(f"{flag} is not served on a mesh "
                         f"(--tensor-parallel-size {tp}) by the PyTorch port")
    if args.num_scheduler_steps > 1 and args.device != "cpu":
        import torch
        from llm_d_tpu_torch.parallel.mesh import backend_for
        if backend_for(torch.device("cuda"), tp) == "gloo":
            parser.error(
                f"--num-scheduler-steps {args.num_scheduler_steps} is not "
                f"served on {tp} ranks that share a card: their gloo "
                "collectives cannot be captured in a CUDA graph")


def _rank_main(rank: int, world: int, address: str, argv: List[str]) -> None:
    """Ranks 1..N-1 of ``--tensor-parallel-size N``: the same flags, the
    engine on this rank's card, then rank 0's steps until it stops the
    mesh.  SIGTERM and SIGINT are rank 0's to act on."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    logging.basicConfig(level=logging.INFO)
    import torch.distributed as dist
    from llm_d_tpu_torch.parallel.mesh import init_distributed
    from llm_d_tpu_torch.utils.device import resolve_device
    p = build_arg_parser()
    args = p.parse_args(argv)
    apply_config_layers(p, args, argv)
    init_distributed(rank, world, address,
                     resolve_device(args.device, rank))
    engine = EngineCore(engine_config_from_args(args))
    attach_tokenizer(engine, get_tokenizer(args.tokenizer))
    dist.barrier()                   # every rank has built
    engine.follow(record=False)
    dist.destroy_process_group()


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


def _serve_mesh(args, argv: List[str]) -> int:
    """Rank 0 of ``--tensor-parallel-size N``: start the other ranks,
    build, wait until every rank has built, serve; then stop every
    rank."""
    import torch.distributed as dist
    from llm_d_tpu_torch.parallel.launch import free_port, start_ranks
    from llm_d_tpu_torch.parallel.mesh import init_distributed
    from llm_d_tpu_torch.utils.device import resolve_device
    world = args.tensor_parallel_size
    address = f"127.0.0.1:{free_port()}"
    procs = start_ranks(world, address, _rank_main, (argv,))
    stopping = threading.Event()
    try:
        backend = init_distributed(0, world, address,
                                   resolve_device(args.device, 0))
        logger.info("mesh: tp=%d ranks on %s", world, backend)
        server = build_server(engine_config_from_args(args), args.tokenizer)
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


def kv_connector_from_args(args):
    """The engine's KV connector of ``--kv-transfer-config``, or None."""
    if not args.kv_transfer_config:
        return None
    from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
    ktc = json.loads(args.kv_transfer_config)
    return TpuConnector(KVConnectorConfig(
        kv_role=ktc.get("kv_role", "kv_both"),
        host=ktc.get("kv_ip", "127.0.0.1"),
        port=int(ktc.get("kv_port", 0)),
        kv_load_failure_policy=ktc.get("kv_load_failure_policy", "fail")))


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
    if args.tensor_parallel_size > 1:
        sys.exit(_serve_mesh(args, list(sys.argv[1:] if argv is None
                                        else argv)))
    server = build_server(engine_config_from_args(args), args.tokenizer)
    if args.latency_training_url:
        server.latency_training_url = args.latency_training_url.rstrip("/")
    connector = kv_connector_from_args(args)
    if connector is not None:
        server.engine.kv_connector = connector
        logger.info("KV connector: role=%s serving on %s:%s",
                    connector.config.kv_role, connector.host, connector.port)
    publisher = kv_event_publisher_from_args(args)
    if publisher is not None:
        publisher.attach(server.engine.kv_manager)
        publisher.start()
        server.kv_event_publisher = publisher
        logger.info("KV events: publishing %s to %s",
                    publisher.topic.decode(), publisher.endpoint)
    asyncio.run(server.serve(args.host, args.port))


if __name__ == "__main__":
    main()
