"""EPP plugin pipeline: profile handlers, filters, scorers, pickers (port
of ``llm_d_tpu.epp.plugins``: every type of ``PLUGIN_TYPES``, the same
scores).  The pickers draw their ties from a ``random.Random`` they are
given (``rng``; the scheduler shares one), not from the module-global
``random``: ``random.Random(s).choice(x)`` draws what ``random.seed(s);
random.choice(x)`` draws.

TPU-framework counterpart of the reference scheduler's plugin set
(reference config surface: SURVEY.md §2.4; per-plugin citations below).
Every plugin is configured from ``EndpointPickerConfig`` YAML and composed
per scheduling profile with weights.

Contract per request:
  profile-handler -> profiles to run
  per profile: filters prune candidates -> scorers emit [0,1] per endpoint
  -> weighted sum -> picker chooses; post-pick hooks let stateful scorers
  (approximate prefix LRU) learn the routing decision.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

from llm_d_tpu_torch.epp.datastore import Datastore, EndpointState
from llm_d_tpu_torch.utils.hashing import hash_block
from llm_d_tpu_torch.utils.lifecycle import (
    KV_PLACEMENT_HEADER, PREFILLER_HEADER, REQUEST_ID_HEADER,
    parse_criticality, parse_deadline)
from llm_d_tpu_torch.utils.predictor import TransferCostModel

Scores = Dict[str, float]


@dataclasses.dataclass
class RequestCtx:
    """What the pipeline knows about one request."""
    body: Dict[str, Any]
    prompt_text: str = ""
    token_ids: Optional[Sequence[int]] = None
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    request_id: str = ""
    # SLO-aware path (reference: x-prediction-based-scheduling,
    # x-slo-ttft-ms, x-slo-tpot-ms headers; priority<0 sheddable).
    in_headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    prediction_based: bool = False
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None
    priority: int = 0
    # SLO class (critical | standard | sheddable; x-llmd-criticality /
    # body "criticality"): drives gateway admission under saturation and
    # rides to the model server's tiered scheduler.
    criticality: str = "standard"
    # Absolute unix-epoch deadline (x-llmd-deadline-ms / body "timeout");
    # stamped by the gateway and propagated to every later hop.
    deadline_epoch: Optional[float] = None
    shed: bool = False
    predictions: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Retry-on-alternate-endpoint: addresses whose forward already failed
    # for THIS request; the scheduler drops them from every candidate set
    # so the retry re-runs the full pipeline over the remaining replicas.
    excluded_endpoints: set = dataclasses.field(default_factory=set)
    # 0 on the first schedule of a request, 1.. on gateway retries — the
    # scheduler counts a REQUEST (requests_total) only on attempt 0 so
    # retry storms don't inflate traffic dashboards mid-incident.
    retry_attempt: int = 0

    @classmethod
    def from_request(cls, body: Dict[str, Any],
                     in_headers: Dict[str, str]) -> "RequestCtx":
        """Build the pipeline context from a parsed request body + already-
        lowercased headers.  ONE implementation for every transport front
        end (HTTP gateway, ext_proc gRPC) — the two planes must schedule a
        given request identically, so the extraction must not fork."""
        prompt = body.get("prompt")
        token_ids = None
        text = ""
        if isinstance(prompt, list) and prompt \
                and isinstance(prompt[0], int):
            token_ids = prompt
        elif prompt is not None:
            text = str(prompt)
        elif "messages" in body:
            text = "".join(m.get("content", "")
                           for m in body.get("messages", []))
        return cls(body=body, prompt_text=text, token_ids=token_ids,
                   headers={}, in_headers=in_headers,
                   priority=int(body.get("priority") or 0),
                   criticality=parse_criticality(in_headers, body),
                   deadline_epoch=parse_deadline(in_headers, body),
                   request_id=in_headers.get(
                       REQUEST_ID_HEADER, body.get("request_id", "")))

    def block_keys(self, block_size: int) -> List[bytes]:
        """Chain block hashes for prefix scoring: token ids when present
        (matches the engine's KV block hashing), UTF-8 bytes otherwise."""
        if self.token_ids:
            units: Sequence[int] = list(self.token_ids)
        else:
            units = list(self.prompt_text.encode())
        out: List[bytes] = []
        parent: Optional[bytes] = None
        for i in range(0, len(units) - len(units) % block_size, block_size):
            parent = hash_block(parent, units[i:i + block_size])
            out.append(parent)
        return out


class Plugin:
    """Base: subclasses override the hooks they implement."""

    def __init__(self, name: str, params: Dict[str, Any],
                 datastore: Datastore) -> None:
        self.name = name
        self.params = params
        self.datastore = datastore

    # filters
    def filter(self, ctx: RequestCtx,
               candidates: List[EndpointState]) -> List[EndpointState]:
        return candidates

    # scorers
    def score(self, ctx: RequestCtx,
              candidates: List[EndpointState]) -> Optional[Scores]:
        return None

    # pickers
    def pick(self, ctx: RequestCtx, candidates: List[EndpointState],
             total_scores: Scores) -> Optional[EndpointState]:
        return None

    # post-decision learning hook
    def on_picked(self, ctx: RequestCtx, endpoint: EndpointState,
                  profile: str) -> None:
        pass


# ---------- filters ----------

class PrefillFilter(Plugin):
    """Keep prefill-role endpoints (reference: gaie-pd/values.yaml:21)."""

    def filter(self, ctx, candidates):
        return [e for e in candidates if e.role in ("prefill", "both")]


class DecodeFilter(Plugin):
    """Keep decode-role endpoints (reference: gaie-pd/values.yaml:22)."""

    def filter(self, ctx, candidates):
        return [e for e in candidates if e.role in ("decode", "both")]


class DrainFilter(Plugin):
    """Drop endpoints that announced they are draining
    (``EndpointState.draining``, scraped from ``llmd_tpu:drain_state``):
    a replica finishing its in-flight work before a restart must stop
    winning picks even while its scrape still answers.

    Strict (no fail-open): a draining replica refuses new inference with
    503 anyway, so passing it through under a fully-draining fleet only
    converts a fast 503 into a forward-then-retry loop."""

    def filter(self, ctx, candidates):
        return [e for e in candidates if not e.draining]


class CircuitBreakerFilter(Plugin):
    """Drop endpoints whose request-level circuit breaker is open
    (``datastore.breaker``; see ``EndpointBreaker``): a replica whose
    requests are failing must stop winning picks even while its scrape
    still looks healthy.

    Fail-open: when EVERY candidate is tripped the original set passes
    through — a full outage must keep probing and heal through half-open,
    not turn into a permanent 503 after the pods recover."""

    def filter(self, ctx, candidates):
        breaker = getattr(self.datastore, "breaker", None)
        if breaker is None:
            return candidates
        allowed = [e for e in candidates if breaker.admissible(e.address)]
        return allowed or candidates

    def on_picked(self, ctx, endpoint, profile):
        breaker = getattr(self.datastore, "breaker", None)
        if breaker is not None:
            # Arms the half-open probe window (no-op for closed breakers).
            breaker.note_pick(endpoint.address)


# ---------- scorers ----------

def _minmax(vals: Dict[str, float], invert: bool = False) -> Scores:
    if not vals:
        return {}
    lo, hi = min(vals.values()), max(vals.values())
    if hi - lo < 1e-12:
        return {k: 1.0 for k in vals}
    out = {k: (v - lo) / (hi - lo) for k, v in vals.items()}
    if invert:
        out = {k: 1.0 - v for k, v in out.items()}
    return out


class QueueScorer(Plugin):
    """Less queue depth -> higher score (reference:
    gaie-kv-events/values.yaml:58, scraped vllm:num_requests_waiting)."""

    def score(self, ctx, candidates):
        return _minmax({e.address: e.num_waiting + e.num_running
                        for e in candidates}, invert=True)


class KvCacheUtilizationScorer(Plugin):
    """Lower KV usage -> higher score (reference:
    gaie-kv-events/values.yaml:59; metric rename shim
    gaie-inference-scheduling/values.yaml:4-6)."""

    def score(self, ctx, candidates):
        return {e.address: 1.0 - min(max(e.kv_usage, 0.0), 1.0)
                for e in candidates}


class PrefixCacheScorer(Plugin):
    """Approximate prefix affinity: remembers which endpoint each block
    chain was routed to in a per-endpoint LRU; score = matched prefix
    fraction.  (Reference: approximate prefix-cache-scorer with
    ``lruCapacityPerServer``/``hashBlockSize``; tiered
    inferencepool/values.yaml:23-29 instantiates it twice.)"""

    def __init__(self, name, params, datastore):
        super().__init__(name, params, datastore)
        self.block_size = int(params.get("hashBlockSize", 64))
        self.capacity = int(params.get("lruCapacityPerServer", 31250))
        # addr -> OrderedDict[block_hash, None] (LRU, newest last)
        self._lru: Dict[str, OrderedDict] = {}
        self._lock = threading.Lock()

    def score(self, ctx, candidates):
        keys = ctx.block_keys(self.block_size)
        if not keys:
            return {e.address: 0.0 for e in candidates}
        out: Scores = {}
        with self._lock:
            for e in candidates:
                lru = self._lru.get(e.address)
                n = 0
                if lru:
                    for k in keys:
                        if k not in lru:
                            break
                        n += 1
                out[e.address] = n / len(keys)
        return out

    def on_picked(self, ctx, endpoint, profile):
        keys = ctx.block_keys(self.block_size)
        if not keys:
            return
        with self._lock:
            lru = self._lru.setdefault(endpoint.address, OrderedDict())
            for k in keys:
                lru.pop(k, None)
                lru[k] = None
            while len(lru) > self.capacity:
                lru.popitem(last=False)


class PrecisePrefixCacheScorer(Plugin):
    """Precise prefix affinity from the KV-event-fed cluster index
    (reference: gaie-kv-events/values.yaml:49-57 ``indexerConfig``).

    Score = longest block-prefix actually resident on the endpoint (per the
    engine's own KV events) / total blocks.  Falls back to 0 when the
    indexer has no data.
    """

    def __init__(self, name, params, datastore, indexer=None):
        super().__init__(name, params, datastore)
        ipc = params.get("indexerConfig", {}).get(
            "tokenProcessorConfig", {})
        self.block_size = int(ipc.get("blockSize",
                                      params.get("blockSize", 64)))
        self.indexer = indexer

    def score(self, ctx, candidates):
        if self.indexer is None or not ctx.token_ids:
            return {e.address: 0.0 for e in candidates}
        keys = ctx.block_keys(self.block_size)
        if not keys:
            return {e.address: 0.0 for e in candidates}
        out: Scores = {}
        for e in candidates:
            n = self.indexer.longest_prefix(keys, e.address)
            out[e.address] = n / len(keys)
        return out


class KvPlacementScorer(Plugin):
    """Transfer-cost-aware KV placement: score = inverted expected TTFT.

    Per candidate the expected TTFT is the queue/load cost (the analytic
    latency predictor over the endpoint's live scrape signals) for the
    tokens it would actually have to prefill, PLUS the modeled wire cost
    of restoring the prefix blocks it lacks from the best peer replica or
    shared host tier (``PrefixIndex.restorable_prefix`` + the
    ``TransferCostModel``'s per-link byte pricing).  Unlike
    residency-fraction affinity scoring, cached-prefix benefit here
    SATURATES: a fully-cached replica's advantage is bounded by the
    prefill cost it avoids, while its queue cost grows without bound — so
    the docs/cluster-sim.md pinning pathology (a hot replica outscoring
    idle scale-up capacity forever) disappears by construction, and a
    warm peer turns a would-be recompute into a cheap restore.

    The picked endpoint's plan lands on ``ctx.kv_restore_plan`` (the sim
    and a restore-capable gateway consume it) and its verdict — local_hit
    / peer_restore / recompute — on the ``x-llmd-kv-placement`` response
    header and the ``llmd_tpu:kv_placement_decision_total`` counter.
    """

    def __init__(self, name, params, datastore, indexer=None, metrics=None):
        super().__init__(name, params, datastore)
        ipc = params.get("indexerConfig", {}).get(
            "tokenProcessorConfig", {})
        self.block_size = int(ipc.get("blockSize",
                                      params.get("blockSize", 64)))
        # KV bytes per token across all layers (kv_bytes_per_token_layer x
        # num_layers); the default prices a mid-size bf16 model.  Deploy
        # profiles should set this from the served model's geometry.
        self.kv_bytes_per_token = int(params.get("kvBytesPerToken", 131072))
        self.indexer = indexer
        self.metrics = metrics
        self.predictor = AnalyticLatencyPredictor(params)
        self.transfer = TransferCostModel()

    def score(self, ctx, candidates):
        if not candidates:
            return None
        # Token ids only (like the precise scorer): UTF-8 fallback hashes
        # would never match the engine's token-chained KV events.
        keys = (ctx.block_keys(self.block_size)
                if self.indexer is not None and ctx.token_ids else [])
        n_tokens = float(len(ctx.token_ids) if ctx.token_ids
                         else len(ctx.prompt_text) // 4)
        costs: Dict[str, float] = {}
        plans: Dict[str, Dict[str, Any]] = {}
        for e in candidates:
            local = peer = 0
            source, tier, nbytes = None, "device", 0
            if keys:
                rp = self.indexer.restorable_prefix(keys, e.address)
                local, peer = rp.local_blocks, rp.peer_blocks
                source, tier = rp.source, rp.tier
                nbytes = rp.nbytes or (
                    peer * self.block_size * self.kv_bytes_per_token)
            miss_tokens = max(
                0.0, n_tokens - (local + peer) * self.block_size)
            cost = self.predictor.predict(
                e, prompt_tokens=miss_tokens)["ttft_ms"]
            restore_ms = 0.0
            if peer:
                restore_ms = self.transfer.restore_ms(
                    nbytes, "host" if tier == "host" else "peer")
                cost += restore_ms
            verdict = ("peer_restore" if peer
                       else "local_hit" if local else "recompute")
            plans[e.address] = {
                "verdict": verdict, "local_blocks": local,
                "peer_blocks": peer, "source": source, "tier": tier,
                "restore_bytes": nbytes if peer else 0,
                "restore_ms": restore_ms, "block_size": self.block_size,
            }
            costs[e.address] = cost
        ctx._kv_plan_map = plans
        return _minmax(costs, invert=True)

    def on_picked(self, ctx, endpoint, profile):
        plans = getattr(ctx, "_kv_plan_map", None)
        if not plans or endpoint.address not in plans:
            return
        plan = plans[endpoint.address]
        ctx.kv_restore_plan = plan
        ctx.headers[KV_PLACEMENT_HEADER] = plan["verdict"]
        if self.metrics is not None:
            self.metrics.kv_placement_decisions.labels(
                verdict=plan["verdict"]).inc()


# ---------- pickers ----------

class MaxScorePicker(Plugin):
    """Highest weighted score wins; ties break uniformly at random
    (reference: max-score-picker), drawn from ``rng``."""

    def __init__(self, name, params, datastore,
                 rng: Optional[random.Random] = None):
        super().__init__(name, params, datastore)
        self.rng = rng if rng is not None else random.Random()

    def pick(self, ctx, candidates, total_scores):
        if not candidates:
            return None
        best = max(total_scores.get(e.address, 0.0) for e in candidates)
        top = [e for e in candidates
               if total_scores.get(e.address, 0.0) >= best - 1e-9]
        return self.rng.choice(top)


class RandomPicker(Plugin):
    """Uniform pick over the top ``maxNumOfEndpoints`` candidates
    (reference: wide-ep inferencepool.values.yaml:34-37 — used where
    per-DP-rank routing is not possible), drawn from ``rng``."""

    def __init__(self, name, params, datastore,
                 rng: Optional[random.Random] = None):
        super().__init__(name, params, datastore)
        self.rng = rng if rng is not None else random.Random()

    def pick(self, ctx, candidates, total_scores):
        if not candidates:
            return None
        n = int(self.params.get("maxNumOfEndpoints", len(candidates)))
        ranked = sorted(candidates,
                        key=lambda e: -total_scores.get(e.address, 0.0))
        return self.rng.choice(ranked[:max(1, n)])


# ---------- SLO-aware scheduling (predicted-latency path) ----------

class AnalyticLatencyPredictor:
    """Default predictor: latency from an endpoint's live load signals.

    Stands in for the prediction sidecars when none are deployed — the same
    feature set the trained models consume (queue depth, running batch, KV
    utilization), with linear coefficients instead of learned ones."""

    def __init__(self, params: Dict[str, Any]) -> None:
        self.ttft_base_ms = float(params.get("ttftBaseMs", 50.0))
        self.ttft_per_waiting_ms = float(params.get("ttftPerWaitingMs", 80.0))
        self.ttft_per_prompt_tok_ms = float(
            params.get("ttftPerPromptTokenMs", 0.1))
        self.tpot_base_ms = float(params.get("tpotBaseMs", 8.0))
        self.tpot_per_running_ms = float(params.get("tpotPerRunningMs", 0.5))

    def predict(self, e: EndpointState,
                prompt_tokens: float = 0.0) -> Dict[str, float]:
        kv_slow = 1.0 / max(1e-3, 1.0 - min(e.kv_usage, 0.99))
        return {
            "ttft_ms": (self.ttft_base_ms
                        + self.ttft_per_waiting_ms * e.num_waiting
                        + self.ttft_per_prompt_tok_ms * prompt_tokens)
            * kv_slow,
            "tpot_ms": (self.tpot_base_ms
                        + self.tpot_per_running_ms * e.num_running) * kv_slow,
        }


class HttpLatencyPredictor:
    """Prediction-sidecar client (reference: PREDICTION_SERVER_URL CSV).

    Round-robins the sidecars; per-endpoint results are cached briefly so
    per-request scoring doesn't multiply HTTP round-trips (the reference
    documents ~300 QPS/sidecar as the scaling limit)."""

    def __init__(self, urls: Sequence[str], cache_ttl_s: float = 0.2,
                 timeout_s: float = 0.1) -> None:
        self.urls = [u.rstrip("/") for u in urls]
        self.cache_ttl_s = cache_ttl_s
        self.timeout_s = timeout_s
        self._cache: Dict[tuple, tuple] = {}
        self._rr = 0
        # Sidecar failure must NOT score as zero latency (that would place
        # the failing endpoint in the best bucket); fall back to the
        # analytic estimate instead.
        self._fallback = AnalyticLatencyPredictor({})

    def predict(self, e: EndpointState,
                prompt_tokens: float = 0.0) -> Dict[str, float]:
        import json as _json
        import urllib.request

        now = time.monotonic()
        # Predictions vary with prompt length; bucket it for the cache.
        key = (e.address, int(prompt_tokens) // 256)
        hit = self._cache.get(key)
        if hit and now - hit[0] < self.cache_ttl_s:
            return hit[1]
        feats = {"num_waiting": e.num_waiting, "num_running": e.num_running,
                 "kv_usage": e.kv_usage, "prompt_tokens": prompt_tokens}
        url = self.urls[self._rr % len(self.urls)]
        self._rr += 1
        try:
            req = urllib.request.Request(
                f"{url}/predict",
                data=_json.dumps({"features": feats}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                out = _json.loads(resp.read())
            if not out.get("ttft_ms") and not out.get("tpot_ms"):
                # Untrained model: same hazard as a failure.
                out = self._fallback.predict(e, prompt_tokens)
        except Exception:
            out = self._fallback.predict(e, prompt_tokens)
        self._cache[key] = (now, out)
        return out


class SloRequestTracker(Plugin):
    """Captures per-request SLOs from the prediction headers (reference:
    slo-request-tracker; README.md:271-272,99-107)."""

    def score(self, ctx, candidates):
        h = ctx.in_headers
        ctx.prediction_based = h.get(
            "x-prediction-based-scheduling", "").lower() in ("true", "1")
        try:
            if "x-slo-ttft-ms" in h:
                ctx.slo_ttft_ms = float(h["x-slo-ttft-ms"])
            if "x-slo-tpot-ms" in h:
                ctx.slo_tpot_ms = float(h["x-slo-tpot-ms"])
        except (TypeError, ValueError) as e:
            # Client-controlled input: surfaces as a 400 at the gateway.
            raise ValueError(f"invalid SLO header: {e}") from e
        return None


class SloScorer(Plugin):
    """Predicted TTFT/TPOT vs SLOs -> positive/negative headroom buckets
    (reference: slo-scorer + HEADROOM_* env knobs, README.md:296-305).

    Positive bucket (both SLOs met) always outranks negative; within a
    bucket, headroom blends with the ttft/tpot weights and the selection
    strategy ('least' packs, 'most' spreads).  When no pod meets the SLOs
    and the request's priority < 0, it is marked shed (the gateway answers
    429 instead of queueing it; README.md:190-192)."""

    def __init__(self, name, params, datastore, predictor=None):
        super().__init__(name, params, datastore)
        urls = params.get("predictionServerURL")
        if predictor is not None:
            self.predictor = predictor
        elif urls:
            self.predictor = HttpLatencyPredictor(str(urls).split(","))
        else:
            self.predictor = AnalyticLatencyPredictor(params)
        self.w_ttft = float(params.get("headroomTtftWeight", 0.5))
        self.w_tpot = float(params.get("headroomTpotWeight", 0.5))
        self.neg_w_ttft = float(params.get("negHeadroomTtftWeight", 0.5))
        self.neg_w_tpot = float(params.get("negHeadroomTpotWeight", 0.5))
        self.strategy = params.get("headroomSelectionStrategy", "least")
        self.slo_buffer = float(params.get("sloBufferFactor", 1.0))

    def score(self, ctx, candidates):
        if not candidates:
            return None
        # No SLOs provided => SLO=0: pure lowest-predicted-latency pick
        # (reference: "treated as SLO=0 -> lowest latency pod").
        slo_ttft = ctx.slo_ttft_ms if ctx.slo_ttft_ms is not None else 0.0
        slo_tpot = (ctx.slo_tpot_ms if ctx.slo_tpot_ms is not None
                    else 0.0) * self.slo_buffer
        n_tokens = float(len(ctx.token_ids) if ctx.token_ids
                         else len(ctx.prompt_text) // 4)
        head: Dict[str, tuple] = {}
        preds: Dict[str, Dict[str, float]] = {}
        any_positive = False
        for e in candidates:
            pred = self.predictor.predict(e, prompt_tokens=n_tokens)
            preds[e.address] = pred
            h_ttft = slo_ttft - pred["ttft_ms"]
            h_tpot = slo_tpot - pred["tpot_ms"]
            positive = h_ttft >= 0 and h_tpot >= 0
            any_positive = any_positive or positive
            head[e.address] = (positive, h_ttft, h_tpot)
        if ctx.slo_ttft_ms is not None and not any_positive \
                and (ctx.priority < 0 or ctx.criticality == "sheddable"):
            ctx.shed = True
        out: Scores = {}
        # Buckets normalize separately: within POSITIVE the strategy
        # applies ('least' headroom packs, 'most' spreads); within NEGATIVE
        # the least deficit always wins; positive strictly outranks.
        pos_blend = {a: self.w_ttft * t + self.w_tpot * p
                     for a, (pos, t, p) in head.items() if pos}
        neg_blend = {a: self.neg_w_ttft * t + self.neg_w_tpot * p
                     for a, (pos, t, p) in head.items() if not pos}
        pos_n = _minmax(pos_blend, invert=(self.strategy == "least"))
        neg_n = _minmax(neg_blend)
        for e in candidates:
            a = e.address
            # Positive maps into [0.55, 1.0], negative into [0, 0.45]:
            # the buckets can never tie, whatever the strategy inversion.
            out[a] = 0.55 + 0.45 * pos_n[a] if a in pos_n \
                else 0.45 * neg_n.get(a, 0.0)
        # Stash per-endpoint predictions; on_picked binds the ACTUAL pick's
        # prediction to the ctx for the usage frame.
        ctx._slo_pred_map = preds
        return out

    def on_picked(self, ctx, endpoint, profile):
        pred_map = getattr(ctx, "_slo_pred_map", None)
        if pred_map and endpoint.address in pred_map:
            ctx.predictions = pred_map[endpoint.address]


class SloAwareProfileHandler(Plugin):
    """Routes prediction-based requests onto the ``slo`` profile
    (reference: slo-aware-profile-handler, README.md:273,285-291)."""

    def profiles(self, ctx: RequestCtx, available: List[str]) -> List[str]:
        h = ctx.in_headers
        prediction = h.get(
            "x-prediction-based-scheduling", "").lower() in ("true", "1")
        if prediction and "slo" in available:
            return ["slo"]
        defaults = [p for p in available if p != "slo"]
        return defaults[:1] if defaults else available[:1]


# ---------- profile handlers ----------

class SingleProfileHandler(Plugin):
    """Every request runs the sole scheduling profile
    (reference: gaie-kv-events/values.yaml:48)."""

    def profiles(self, ctx: RequestCtx, available: List[str]) -> List[str]:
        return [available[0]] if available else []


class PdProfileHandler(Plugin):
    """Selective prefill/decode disaggregation: prompts at or above
    ``threshold`` tokens run the prefill AND decode profiles; short prompts
    decode-only (reference: gaie-pd/values.yaml:29-32 pd-profile-handler
    {threshold, hashBlockSize}; decision metric
    llm_d_inference_scheduler_pd_decision_total)."""

    def __init__(self, name, params, datastore, metrics=None):
        super().__init__(name, params, datastore)
        self.threshold = int(params.get("threshold", 0))
        self.metrics = metrics

    def profiles(self, ctx: RequestCtx, available: List[str]) -> List[str]:
        n_tokens = (len(ctx.token_ids) if ctx.token_ids
                    else len(ctx.prompt_text) // 4)
        disaggregate = n_tokens >= self.threshold
        if self.metrics is not None:
            self.metrics.pd_decisions.labels(
                decision_type="disaggregated" if disaggregate
                else "decode-only").inc()
        if disaggregate and "prefill" in available and "decode" in available:
            return ["prefill", "decode"]
        if "decode" in available:
            return ["decode"]
        return [available[0]] if available else []


class PrefillHeaderHandler(Plugin):
    """Exports the prefill profile's pick as the sidecar's prefill hint
    header (reference: gaie-pd/values.yaml:20 prefill-header-handler)."""

    HEADER = PREFILLER_HEADER

    def on_picked(self, ctx, endpoint, profile):
        if profile == "prefill":
            ctx.headers[self.HEADER] = endpoint.address


PLUGIN_TYPES = {
    "prefill-filter": PrefillFilter,
    "decode-filter": DecodeFilter,
    "drain-filter": DrainFilter,
    "circuit-breaker-filter": CircuitBreakerFilter,
    "queue-scorer": QueueScorer,
    "kv-cache-utilization-scorer": KvCacheUtilizationScorer,
    "prefix-cache-scorer": PrefixCacheScorer,
    "precise-prefix-cache-scorer": PrecisePrefixCacheScorer,
    "kv-placement-scorer": KvPlacementScorer,
    "max-score-picker": MaxScorePicker,
    "random-picker": RandomPicker,
    "single-profile-handler": SingleProfileHandler,
    "pd-profile-handler": PdProfileHandler,
    "prefill-header-handler": PrefillHeaderHandler,
    "slo-request-tracker": SloRequestTracker,
    "slo-scorer": SloScorer,
    "slo-aware-profile-handler": SloAwareProfileHandler,
}
