"""Engine and scheduler metrics in the llm-d taxonomy (port of
``EngineMetrics``, ``EppMetrics`` and ``parse_prometheus_text`` in
``llm_d_tpu.utils.metrics``).

Every model-server replica exposes the ``vllm:*`` family that the EPP's
load-aware scorers scrape (``vllm:num_requests_waiting``,
``vllm:num_requests_running``, ``vllm:kv_cache_usage_perc``) plus the
``llmd_tpu:*`` lifecycle and engine metrics.  Names, help strings, label
names and histogram buckets are the JAX package's, so dashboards, PromQL
and the EPP read both servers alike.

The card machine has no ``prometheus_client``, so this module carries
its own small registry (``Counter``, ``Gauge``, ``Histogram``, each with
``labels()``) and writes the Prometheus text exposition format (0.0.4)
as ``prometheus_client`` renders these metrics: labels sorted by name,
a counter's samples under ``<name>_total``, and each labelled counter and
histogram child's creation time in a ``<name>_created`` gauge family.
Children are updated from the engine thread and rendered from the
server's event loop, so each child guards its values with a lock.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Canonical ``llmd_tpu:*`` names read outside this module.
DRAIN_STATE_METRIC = "llmd_tpu:drain_state"
COLLECTIVE_BYTES_METRIC = "llmd_tpu:collective_bytes_total"
STREAM_RESUME_METRIC = "llmd_tpu:stream_resume_total"
REQUEST_RECOVERY_METRIC = "llmd_tpu:request_recovery_seconds"
REQUEST_PHASE_METRIC = "llmd_tpu:request_phase_seconds"
SPEC_DRAFT_METRIC = "llmd_tpu:spec_draft_tokens_total"
SPEC_ACCEPTED_METRIC = "llmd_tpu:spec_accepted_tokens_total"
STEP_PREFILL_TOKENS_METRIC = "llmd_tpu:step_prefill_tokens_total"
STEP_DECODE_TOKENS_METRIC = "llmd_tpu:step_decode_tokens_total"
FEATURE_DISABLED_METRIC = "llmd_tpu:engine_feature_disabled_total"
# rate(steps) / rate(dispatches) is the multistep amortization ratio:
# ~K under K-step decode blocks, 1 on the classic per-step path.
ENGINE_DISPATCH_METRIC = "llmd_tpu:engine_dispatch_total"
ENGINE_STEP_METRIC = "llmd_tpu:engine_steps_total"
EPLB_IMBALANCE_METRIC = "llmd_tpu:eplb_imbalance"
EPLB_MIGRATIONS_METRIC = "llmd_tpu:eplb_migrations_total"
EPLB_MIGRATED_BYTES_METRIC = "llmd_tpu:eplb_migrated_bytes_total"
EPLB_MIGRATION_STALL_METRIC = "llmd_tpu:eplb_migration_stall_seconds"
# The EPP's precise prefix index: KV block events ingested, by type; the
# kv-placement-scorer's verdict on each pick (local_hit | peer_restore |
# recompute).
KV_EVENTS_METRIC = "llmd_tpu:kv_events_total"
KV_PLACEMENT_DECISION_METRIC = "llmd_tpu:kv_placement_decision_total"

# Buckets mirroring vLLM's TTFT / TPOT histograms (seconds).
_TIME_BUCKETS = (
    0.001, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.25, 0.5,
    0.75, 1.0, 2.5, 5.0, 7.5, 10.0, 20.0, 40.0, 80.0,
)


# ---------------------------------------------------------------- registry

def _float_str(d: float) -> str:
    """A sample value as Go (and ``prometheus_client``) prints it."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _sample(name: str, labels: Sequence[Tuple[str, str]],
            value: float) -> str:
    if not labels:
        return f"{name} {_float_str(value)}"
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels))
    return f"{name}{{{body}}} {_float_str(value)}"


class _Child:
    def __init__(self, metric: "_Metric") -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self.created = time.time()


class _CounterChild(_Child):
    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by "
                             "non-negative amounts")
        with self._lock:
            self._value += amount

    def samples(self, m: "_Metric", labels):
        with self._lock:
            return [(m.name + "_total", labels, self._value)]


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def samples(self, m: "_Metric", labels):
        with self._lock:
            return [(m.name, labels, self._value)]


class _HistogramChild(_Child):
    def __init__(self, metric: "_Metric") -> None:
        super().__init__(metric)
        self._bounds = metric.buckets
        self._counts = [0.0] * len(self._bounds)

    def observe(self, amount: float) -> None:
        with self._lock:
            self._value += amount
            for i, b in enumerate(self._bounds):
                if amount <= b:
                    self._counts[i] += 1
                    break

    def samples(self, m: "_Metric", labels):
        with self._lock:
            counts, total = list(self._counts), self._value
        out, acc = [], 0.0
        for b, c in zip(self._bounds, counts):
            acc += c
            out.append((m.name + "_bucket",
                        labels + (("le", _float_str(b)),), acc))
        out.append((m.name + "_count", labels, acc))
        out.append((m.name + "_sum", labels, total))
        return out


class _Metric:
    kind = ""
    child_type = _Child

    def __init__(self, name: str, doc: str, labelnames: Sequence[str] = (),
                 registry: Optional["CollectorRegistry"] = None,
                 buckets: Sequence[float] = _TIME_BUCKETS) -> None:
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        if self.kind == "histogram":
            bounds = [float(b) for b in buckets]
            if bounds[-1] != math.inf:
                bounds.append(math.inf)
            self.buckets = tuple(bounds)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            # An unlabelled metric is its one child, rendered from the
            # start (as prometheus_client renders it).
            self._children[()] = self.child_type(self)
        if registry is not None:
            registry.register(self)

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name}: labelled metric; use labels()")
        return self._children[()]

    def inc(self, amount: float = 1) -> None:
        self._only().inc(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def remove(self, *labelvalues: str) -> None:
        """Drop one child (``KeyError`` when it does not exist)."""
        key = tuple(str(v) for v in labelvalues)
        if len(key) != len(self.labelnames):
            raise ValueError(f"{self.name}: {len(key)} label values for "
                             f"{len(self.labelnames)} labels")
        with self._lock:
            del self._children[key]

    def labels(self, **labels: str):
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} are not "
                             f"{sorted(self.labelnames)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self.child_type(self)
            return child

    def _items(self):
        with self._lock:
            return [(tuple(zip(self.labelnames, key)), child)
                    for key, child in self._children.items()]

    @property
    def family(self) -> str:
        """The name on the metric's HELP and TYPE lines."""
        return self.name

    def render(self) -> List[str]:
        items = self._items()
        lines = [f"# HELP {self.family} {_escape_help(self.doc)}",
                 f"# TYPE {self.family} {self.kind}"]
        for labels, child in items:
            lines.extend(_sample(*s) for s in child.samples(self, labels))
        return lines + self._created(items)

    def _created(self, items) -> List[str]:
        if not items:
            return []
        name = self.name + "_created"
        return ([f"# HELP {name} {_escape_help(self.doc)}",
                 f"# TYPE {name} gauge"]
                + [_sample(name, labels, child.created)
                   for labels, child in items])


class Counter(_Metric):
    kind = "counter"
    child_type = _CounterChild

    def __init__(self, name: str, *a, **kw) -> None:
        super().__init__(name[:-len("_total")] if name.endswith("_total")
                         else name, *a, **kw)

    @property
    def family(self) -> str:
        return self.name + "_total"


class Gauge(_Metric):
    kind = "gauge"
    child_type = _GaugeChild

    def _created(self, items) -> List[str]:
        return []


class Histogram(_Metric):
    kind = "histogram"
    child_type = _HistogramChild


class CollectorRegistry:
    """Metrics in registration order; ``render`` writes them all."""

    def __init__(self) -> None:
        self._metrics: List[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"duplicate metric {metric.name!r}")
            self._metrics.append(metric)

    def render(self) -> bytes:
        with self._lock:
            metrics = list(self._metrics)
        lines = [ln for m in metrics for ln in m.render()]
        return ("\n".join(lines) + "\n").encode("utf-8")


# ----------------------------------------------------------- the taxonomy

class EngineMetrics:
    """The ``vllm:*`` metric family exposed by every model-server replica
    (the EPP's kv-cache-utilization and queue scorers read
    ``vllm:kv_cache_usage_perc`` and ``vllm:num_requests_waiting``)."""

    def __init__(self, model_name: str) -> None:
        self.registry = CollectorRegistry()
        self.model_name = model_name
        labels = {"model_name": model_name}

        def gauge(name: str, doc: str):
            return Gauge(name, doc, list(labels),
                         registry=self.registry).labels(**labels)

        def counter(name: str, doc: str):
            return Counter(name, doc, list(labels),
                           registry=self.registry).labels(**labels)

        def histo(name: str, doc: str, buckets=_TIME_BUCKETS):
            return Histogram(name, doc, list(labels), buckets=buckets,
                             registry=self.registry).labels(**labels)

        # Scheduler-consumed load signals.
        self.kv_cache_usage_perc = gauge(
            "vllm:kv_cache_usage_perc", "Fraction of KV-cache blocks in use (0..1).")
        self.num_requests_waiting = gauge(
            "vllm:num_requests_waiting", "Requests queued, not yet scheduled.")
        self.num_requests_running = gauge(
            "vllm:num_requests_running", "Requests currently in the running batch.")
        # Latency distributions.
        self.time_to_first_token = histo(
            "vllm:time_to_first_token_seconds", "Time from arrival to first output token.")
        self.inter_token_latency = histo(
            "vllm:inter_token_latency_seconds", "Latency between consecutive output tokens.")
        self.e2e_request_latency = histo(
            "vllm:e2e_request_latency_seconds", "End-to-end request latency.")
        # Prefix-cache effectiveness.
        self.prefix_cache_queries = counter(
            "vllm:prefix_cache_queries_total", "Tokens queried against the prefix cache.")
        self.prefix_cache_hits = counter(
            "vllm:prefix_cache_hits_total", "Tokens served from the prefix cache.")
        # Work counters.
        self.prompt_tokens = counter(
            "vllm:prompt_tokens_total", "Prefill tokens processed.")
        self.generation_tokens = counter(
            "vllm:generation_tokens_total", "Output tokens generated.")
        self.request_success = Counter(
            "vllm:request_success", "Finished requests.",
            ["model_name", "finished_reason"], registry=self.registry)
        self.preemptions = counter(
            "vllm:num_preemptions_total", "Requests preempted to reclaim KV blocks.")
        self.kv_transfer_time = histo(
            "llmd_tpu:kv_transfer_seconds", "P->D KV-cache transfer time per request.")
        self.kv_cache_evictions = counter(
            "llmd_tpu:kv_cache_evictions_total", "Cached KV blocks evicted (LRU).")
        self.kv_offload_saves = counter(
            "llmd_tpu:kv_offload_saved_blocks_total", "KV blocks offloaded to host tier.")
        self.kv_offload_loads = counter(
            "llmd_tpu:kv_offload_loaded_blocks_total", "KV blocks restored from host tier.")
        self.kv_shared_tier_hits = counter(
            "llmd_tpu:kv_shared_tier_hits_total",
            "KV blocks fetched from a peer pod's shared tier.")
        self.kv_shared_tier_misses = counter(
            "llmd_tpu:kv_shared_tier_misses_total",
            "Shared-tier lookups that missed on every peer.")
        # --- lifecycle (deadlines / SLO classes / drain) ---
        self._queue_wait = Histogram(
            "llmd_tpu:request_queue_wait_seconds",
            "Arrival-to-first-schedule wait, by criticality class.",
            ["model_name", "criticality"], buckets=_TIME_BUCKETS,
            registry=self.registry)
        self._deadline_exceeded = Counter(
            "llmd_tpu:deadline_exceeded_total",
            "Requests refused or evicted after their deadline passed, "
            "by criticality class.",
            ["model_name", "criticality"], registry=self.registry)
        self.drain_inflight = gauge(
            "llmd_tpu:drain_inflight",
            "In-flight requests still completing while this replica "
            "drains (0 when not draining or drained).")
        self.drain_state = gauge(
            DRAIN_STATE_METRIC,
            "1 while this replica is draining (readiness down, in-flight "
            "completing); the EPP's drain-filter keys on this.")
        self._collective_bytes = Counter(
            COLLECTIVE_BYTES_METRIC,
            "EP collective wire bytes shipped (dispatch/combine, "
            "estimated from routed tokens), by collective and wire "
            "dtype.",
            ["model_name", "collective", "dtype"], registry=self.registry)
        self._stream_resume = Counter(
            STREAM_RESUME_METRIC,
            "Mid-stream resumes at this relay, by outcome "
            "(restored | recomputed | failed).",
            ["model_name", "outcome"], registry=self.registry)
        self.request_recovery = histo(
            REQUEST_RECOVERY_METRIC,
            "Mid-stream break detection to first resumed token.")
        self._request_phase = Histogram(
            REQUEST_PHASE_METRIC,
            "Per-request phase duration (TTFT/TPOT attribution), by "
            "phase and criticality class.",
            ["model_name", "phase", "criticality"], buckets=_TIME_BUCKETS,
            registry=self.registry)
        self.spec_draft_tokens = counter(
            SPEC_DRAFT_METRIC,
            "Draft tokens proposed by the MTP drafter and verified by "
            "the target model.")
        self.spec_accepted_tokens = counter(
            SPEC_ACCEPTED_METRIC,
            "Draft tokens the target model accepted (emitted verbatim).")
        # Step composition: incremented host-side from scheduler metadata
        # on every engine step, never a device sync.
        self.step_prefill_tokens = counter(
            STEP_PREFILL_TOKENS_METRIC,
            "Prefill-chunk tokens computed per engine step.")
        self.step_decode_tokens = counter(
            STEP_DECODE_TOKENS_METRIC,
            "Decode + speculative-verify tokens computed per engine "
            "step.")
        self._feature_disabled = Counter(
            FEATURE_DISABLED_METRIC,
            "Requested features demoted, at startup or per request, by "
            "feature and blocker.",
            ["model_name", "feature", "blocker"], registry=self.registry)
        self.engine_dispatches = counter(
            ENGINE_DISPATCH_METRIC,
            "Compiled-program dispatches (one host fetch each); "
            "steps/dispatches is the multistep amortization ratio.")
        self.engine_steps = counter(
            ENGINE_STEP_METRIC,
            "Engine rounds retired (a fused-multistep dispatch retires "
            "N at once).")
        self.eplb_imbalance = gauge(
            EPLB_IMBALANCE_METRIC,
            "Windowed per-expert load imbalance (max/mean; 1.0 = even) "
            "driving the migration hysteresis gate.")
        self.eplb_migrations = counter(
            EPLB_MIGRATIONS_METRIC,
            "Completed live expert migrations (atomic table+weight "
            "flips).")
        self.eplb_migrated_bytes = counter(
            EPLB_MIGRATED_BYTES_METRIC,
            "Expert-slot weight bytes staged by background migration "
            "copies (incl. int8 sibling planes).")
        self.eplb_migration_stall = histo(
            EPLB_MIGRATION_STALL_METRIC,
            "Host-blocked seconds at a migration flip (≈0: staging is "
            "async; the flip is a reference swap).")

    def observe_phase(self, phase: str, criticality: str,
                      seconds: float) -> None:
        self._request_phase.labels(
            model_name=self.model_name, phase=phase,
            criticality=criticality).observe(max(0.0, seconds))

    def observe_queue_wait(self, criticality: str, seconds: float) -> None:
        self._queue_wait.labels(
            model_name=self.model_name, criticality=criticality).observe(
            seconds)

    def inc_stream_resume(self, outcome: str) -> None:
        self._stream_resume.labels(
            model_name=self.model_name, outcome=outcome).inc()

    def inc_deadline_exceeded(self, criticality: str) -> None:
        self._deadline_exceeded.labels(
            model_name=self.model_name, criticality=criticality).inc()

    def inc_feature_disabled(self, feature: str, blocker: str) -> None:
        self._feature_disabled.labels(
            model_name=self.model_name, feature=feature,
            blocker=blocker).inc()

    def add_collective_bytes(self, collective: str, dtype: str,
                             n: int) -> None:
        self._collective_bytes.labels(
            model_name=self.model_name, collective=collective,
            dtype=dtype).inc(n)

    def render(self) -> bytes:
        return self.registry.render()


class EppMetrics:
    """Scheduler-side metrics (the ``inference_extension_*`` family, the
    P/D decision counter and the gateway's resilience counters), with the
    JAX package's names, help strings, labels and buckets."""

    def __init__(self, registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        r = self.registry
        self.scheduling_duration = Histogram(
            "inference_extension_scheduler_e2e_duration_seconds",
            "End-to-end scheduling latency per request.", registry=r,
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5))
        self.plugin_duration = Histogram(
            "inference_extension_scheduler_plugin_duration_seconds",
            "Per-plugin processing latency.", ["plugin"], registry=r,
            buckets=(0.00001, 0.0001, 0.001, 0.01, 0.1))
        self.pd_decisions = Counter(
            "llm_d_inference_scheduler_pd_decision_total",
            "Prefill/decode disaggregation decisions.", ["decision_type"],
            registry=r)
        self.prefix_indexer_size = Gauge(
            "inference_extension_prefix_indexer_size",
            "Blocks tracked by the prefix indexer.", registry=r)
        self.prefix_indexer_hit_ratio = Gauge(
            "inference_extension_prefix_indexer_hit_ratio",
            "Prefix indexer hit ratio over recent requests.", registry=r)
        self.kv_events = Counter(
            KV_EVENTS_METRIC,
            "KV block events ingested by the prefix index, by type "
            "(BlockStored | BlockRemoved | AllBlocksCleared).",
            ["type"], registry=r)
        self.kv_placement_decisions = Counter(
            KV_PLACEMENT_DECISION_METRIC,
            "kv-placement-scorer verdicts on picked endpoints "
            "(local_hit | peer_restore | recompute).",
            ["verdict"], registry=r)
        self.flow_control_queue = Gauge(
            "inference_extension_flow_control_queue_size",
            "Requests held by gateway flow control.", registry=r)
        self.flow_control_rejects = Counter(
            "inference_extension_flow_control_rejects_total",
            "Requests rejected by gateway flow control.", ["reason"],
            registry=r)
        self.requests_total = Counter(
            "inference_objective_request_total",
            "Requests scheduled.", ["target"], registry=r)
        self.shed_total = Counter(
            "inference_objective_request_shed_total",
            "Requests shed due to SLO headroom exhaustion.", registry=r)
        self.breaker_state = Gauge(
            "llmd_tpu:endpoint_breaker_state",
            "Per-endpoint circuit breaker state (0=closed, 1=open, "
            "2=half-open).", ["endpoint"], registry=r)
        self.breaker_transitions = Counter(
            "llmd_tpu:endpoint_breaker_transitions_total",
            "Breaker state transitions.", ["endpoint", "to"], registry=r)
        self.gateway_retries = Counter(
            "llmd_tpu:gateway_retries_total",
            "Forwards retried on an alternate endpoint.", ["reason"],
            registry=r)
        self.gateway_retry_exhausted = Counter(
            "llmd_tpu:gateway_retry_exhausted_total",
            "Requests that failed after the full retry budget.",
            registry=r)
        self.gateway_deadline_exceeded = Counter(
            "llmd_tpu:gateway_deadline_exceeded_total",
            "Requests 504'd at the gateway because their deadline passed.",
            ["criticality"], registry=r)
        self.stream_resume = Counter(
            STREAM_RESUME_METRIC,
            "Mid-stream resumes at the gateway relay, by outcome "
            "(restored | recomputed | failed).",
            ["outcome"], registry=r)
        self.request_recovery = Histogram(
            REQUEST_RECOVERY_METRIC,
            "Mid-stream break detection to first resumed token.",
            buckets=_TIME_BUCKETS, registry=r)
        # The gateway's phases: queue (flow-control wait), schedule (the
        # plugin pipeline's decision), resume.
        self._request_phase = Histogram(
            REQUEST_PHASE_METRIC,
            "Per-request phase duration at the gateway (TTFT "
            "attribution), by phase and criticality class.",
            ["phase", "criticality"], buckets=_TIME_BUCKETS, registry=r)

    def observe_phase(self, phase: str, criticality: str,
                      seconds: float) -> None:
        self._request_phase.labels(
            phase=phase, criticality=criticality).observe(
            max(0.0, seconds))

    def render(self) -> bytes:
        return self.registry.render()


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Tiny parser for the exposition format: returns ``{metric{labels}:
    value}`` plus bare ``{metric: value}`` for the first sample of each
    name."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, value = line.rsplit(" ", 1)
            parts = value.split()
            val = float(parts[0])
        except ValueError:
            continue
        out[key] = val
        bare = key.split("{", 1)[0]
        out.setdefault(bare, val)
    return out
