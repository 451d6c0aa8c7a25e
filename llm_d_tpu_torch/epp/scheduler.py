"""EPP scheduling pipeline: config -> plugin instances -> per-request run
(port of ``llm_d_tpu.epp.scheduler``).  The pickers share one
``random.Random`` (``rng``), so a seed fixes every tie-break.

Composes the plugin graph parsed from ``EndpointPickerConfig`` and executes
it per request: profile handler -> (filters -> weighted scorers -> picker)
per profile.  Emits the reference's decision headers
(``x-gateway-destination-endpoint``; reference: standalone
values.yaml:170-181 keys Envoy's ORIGINAL_DST cluster on it) and scheduler
metrics (``inference_extension_*``; reference:
example-promQL-queries.md:40-80).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Dict, Optional

from llm_d_tpu_torch.epp.config import EndpointPickerConfig
from llm_d_tpu_torch.epp.datastore import Datastore, EndpointState
from llm_d_tpu_torch.epp.plugins import (
    PLUGIN_TYPES,
    KvPlacementScorer,
    MaxScorePicker,
    PdProfileHandler,
    Plugin,
    PrecisePrefixCacheScorer,
    PrefillHeaderHandler,
    RandomPicker,
    RequestCtx,
    SingleProfileHandler,
    SloAwareProfileHandler,
)
from llm_d_tpu_torch.utils.metrics import EppMetrics

logger = logging.getLogger(__name__)

DESTINATION_HEADER = "x-gateway-destination-endpoint"


@dataclasses.dataclass
class SchedulingResult:
    """Per-profile picks; ``primary`` is where the request is sent."""
    picks: Dict[str, EndpointState]
    headers: Dict[str, str]
    scores: Dict[str, Dict[str, float]]     # profile -> addr -> score
    # Per-SCORER raw scores (profile -> plugin -> addr -> score): the
    # llmd-trace scheduling span records the chosen endpoint's breakdown
    # so a routing decision is explainable per request, not just in
    # aggregate plugin-duration metrics.
    breakdown: Dict[str, Dict[str, Dict[str, float]]] = \
        dataclasses.field(default_factory=dict)

    @property
    def primary(self) -> Optional[EndpointState]:
        for name in ("decode", "default"):
            if name in self.picks:
                return self.picks[name]
        return next(iter(self.picks.values()), None)


class EppScheduler:
    def __init__(self, config: EndpointPickerConfig, datastore: Datastore,
                 metrics: Optional[EppMetrics] = None,
                 indexer=None, rng: Optional[random.Random] = None) -> None:
        self.config = config
        self.rng = rng if rng is not None else random.Random()
        self.datastore = datastore
        self.metrics = metrics or EppMetrics()
        self.indexer = indexer
        self.plugins: Dict[str, Plugin] = {}
        for spec in config.plugins:
            cls = PLUGIN_TYPES.get(spec.type)
            if cls is None:
                raise ValueError(f"unknown plugin type {spec.type!r}")
            if cls is PrecisePrefixCacheScorer:
                inst = cls(spec.name, spec.parameters, datastore,
                           indexer=indexer)
            elif cls is KvPlacementScorer:
                inst = cls(spec.name, spec.parameters, datastore,
                           indexer=indexer, metrics=self.metrics)
            elif cls is PdProfileHandler:
                inst = cls(spec.name, spec.parameters, datastore,
                           metrics=self.metrics)
            elif cls in (MaxScorePicker, RandomPicker):
                inst = cls(spec.name, spec.parameters, datastore,
                           rng=self.rng)
            else:
                inst = cls(spec.name, spec.parameters, datastore)
            self.plugins[spec.name] = inst
        # Most specific handler wins: slo-aware > pd > single.
        self._profile_handler = None
        for kinds in (SloAwareProfileHandler, PdProfileHandler,
                      SingleProfileHandler):
            self._profile_handler = next(
                (p for p in self.plugins.values() if isinstance(p, kinds)),
                None)
            if self._profile_handler is not None:
                break

    # ---------- per-request ----------

    def schedule(self, ctx: RequestCtx) -> SchedulingResult:
        t0 = time.perf_counter()
        available = [p.name for p in self.config.profiles]
        if self._profile_handler is not None:
            profile_names = self._profile_handler.profiles(ctx, available)
        else:
            profile_names = available[:1]

        picks: Dict[str, EndpointState] = {}
        all_scores: Dict[str, Dict[str, float]] = {}
        all_breakdown: Dict[str, Dict[str, Dict[str, float]]] = {}
        for pname in profile_names:
            profile = self.config.profile(pname)
            if profile is None:
                continue
            chosen, scores, breakdown = self._run_profile(ctx, profile)
            all_scores[pname] = scores
            all_breakdown[pname] = breakdown
            if chosen is not None:
                picks[pname] = chosen
                for plugin in self.plugins.values():
                    plugin.on_picked(ctx, chosen, pname)
                self._append_prefill_alternates(ctx, pname, chosen, scores)

        headers = dict(ctx.headers)
        result = SchedulingResult(picks=picks, headers=headers,
                                  scores=all_scores,
                                  breakdown=all_breakdown)
        primary = result.primary
        if primary is not None:
            result.headers[DESTINATION_HEADER] = primary.address
            if ctx.retry_attempt == 0:
                self.metrics.requests_total.labels(
                    target=primary.address).inc()
        self.metrics.scheduling_duration.observe(time.perf_counter() - t0)
        return result

    # Runner-up prefillers appended to the hint header (sidecar failover).
    PREFILL_ALTERNATES = 2

    def _append_prefill_alternates(self, ctx: RequestCtx, pname: str,
                                   chosen, scores: Dict[str, float]) -> None:
        """Extend ``x-prefiller-host-port`` with up to PREFILL_ALTERNATES
        runners-up (score order) so the sidecar can fail over to the next
        prefiller without a gateway round trip (P/D-Serve: per-request
        failover at the routing layer, not pod restart).  A single-
        prefiller pool leaves the header as the bare winner — the wire
        format only grows when there IS an alternate."""
        if pname != "prefill":
            return
        header = PrefillHeaderHandler.HEADER
        if ctx.headers.get(header) != chosen.address:
            return                     # no prefill-header-handler configured
        alts = sorted((a for a in scores if a != chosen.address),
                      key=lambda a: -scores[a])[:self.PREFILL_ALTERNATES]
        if alts:
            ctx.headers[header] = ",".join([chosen.address] + alts)

    def _run_profile(self, ctx: RequestCtx, profile):
        role = {"prefill": "prefill", "decode": "decode"}.get(profile.name)
        candidates = [e for e in self.datastore.candidates(role)
                      if e.ready and e.address not in ctx.excluded_endpoints]
        totals: Dict[str, float] = {e.address: 0.0 for e in candidates}
        breakdown: Dict[str, Dict[str, float]] = {}
        picker: Optional[Plugin] = None
        picker_ref = None
        for ref in profile.plugins:
            plugin = self.plugins.get(ref.plugin_ref)
            if plugin is None:
                continue
            t0 = time.perf_counter()
            filtered = plugin.filter(ctx, candidates)
            if filtered is not candidates:
                candidates = filtered
                totals = {e.address: totals.get(e.address, 0.0)
                          for e in candidates}
            scores = plugin.score(ctx, candidates)
            if scores is not None:
                breakdown[plugin.name] = {
                    a: round(float(s), 6) for a, s in scores.items()}
                for addr, s in scores.items():
                    if addr in totals:
                        totals[addr] += ref.weight * s
            self.metrics.plugin_duration.labels(plugin=plugin.name).observe(
                time.perf_counter() - t0)
            # Remember the last picker-capable plugin in the profile.
            if type(plugin).pick is not Plugin.pick:
                picker = plugin
                picker_ref = ref
        if not candidates:
            return None, totals, breakdown
        if picker is None:
            picker = MaxScorePicker("max-score-picker", {}, self.datastore,
                                    rng=self.rng)
        chosen = picker.pick(ctx, candidates, totals)
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("profile=%s scores=%s chosen=%s", profile.name,
                         {a: round(s, 3) for a, s in totals.items()},
                         chosen.address if chosen else None)
        return chosen, totals, breakdown
