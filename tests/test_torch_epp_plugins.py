"""Port parity: the EPP's plugin pipeline (``llm_d_tpu_torch.epp.config``,
``.plugins``, ``.scheduler``, ``.datastore``'s breaker and
``utils.metrics.EppMetrics``) against the JAX package's, on the CPU.

* Configs: every ``EndpointPickerConfig`` a ConfigMap in ``deploy/``
  ships, and ``DEFAULT_CONFIG_YAML``, parse to the JAX package's objects;
  malformed configs fail with the same exception and message.
* Plugins: every type of ``PLUGIN_TYPES`` on seeded endpoint states
  (queue depth, KV use, prefix blocks on device and host tiers, roles,
  draining, open breakers): equal filters, scores, profiles and the
  headers and predictions ``on_picked`` leaves; the pickers pick the same
  endpoint from ``random.Random(s)`` as JAX's from ``random.seed(s)``;
  the SLO plugins with ``AnalyticLatencyPredictor`` and
  ``HttpLatencyPredictor`` (against JAX's prediction server, and a dead
  one: the analytic fallback).
* Scheduler: ``EppScheduler`` gives equal ``SchedulingResult``s (picks,
  headers, scores, per-scorer breakdowns) and equal ``/metrics`` counts
  under every ``deploy/`` config, request after request.
* The breaker: the same states through a failure / open / half-open /
  probe sequence, and the same exported series.
* ``TransferCostModel`` (the kv-placement scorer's link prices, in
  ``utils/predictor.py``): the same restore ms from the analytic prior.
"""

import asyncio
import dataclasses
import pathlib
import random
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from llm_d_tpu.epp import config as jconfig
from llm_d_tpu.epp import datastore as jds
from llm_d_tpu.epp import indexer as jindexer
from llm_d_tpu.epp import plugins as jplugins
from llm_d_tpu.epp import scheduler as jscheduler
from llm_d_tpu.utils import metrics as jmetrics
from llm_d_tpu_torch.epp import config as tconfig
from llm_d_tpu_torch.epp import datastore as tds
from llm_d_tpu_torch.epp import indexer as tindexer
from llm_d_tpu_torch.epp import plugins as tplugins
from llm_d_tpu_torch.epp import scheduler as tscheduler
from llm_d_tpu_torch.utils import metrics as tmetrics

# One intra-op thread: the suite's parallel workers, each with a thread
# pool as wide as the machine, would oversubscribe its cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
J = dict(config=jconfig, ds=jds, indexer=jindexer, plugins=jplugins,
         scheduler=jscheduler, metrics=jmetrics)
T = dict(config=tconfig, ds=tds, indexer=tindexer, plugins=tplugins,
         scheduler=tscheduler, metrics=tmetrics)


def _deploy_configs():
    out = {}
    for path in sorted((ROOT / "deploy").rglob("*.yaml")):
        for doc in yaml.safe_load_all(path.read_text()):
            if not doc or doc.get("kind") != "ConfigMap":
                continue
            for key, text in (doc.get("data") or {}).items():
                if "EndpointPickerConfig" in text:
                    out[f"{path.relative_to(ROOT)}:{key}"] = text
    return out


CONFIGS = dict(_deploy_configs(), default=jconfig.DEFAULT_CONFIG_YAML)


def test_the_deploy_tree_ships_every_recipe_config():
    assert sorted(CONFIGS) == [
        "default",
        "deploy/inference-scheduling/gateway.yaml:default-config.yaml",
        "deploy/pd-disaggregation/pd.yaml:pd-config.yaml",
        "deploy/predicted-latency/gateway.yaml:slo-config.yaml",
        "deploy/tiered-prefix-cache/gateway.yaml:default-config.yaml",
        "deploy/wide-ep-lws/gateway.yaml:pd-config.yaml"]
    assert tconfig.DEFAULT_CONFIG_YAML == jconfig.DEFAULT_CONFIG_YAML


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_parse_equal(name):
    j = jconfig.parse_config(CONFIGS[name])
    t = tconfig.parse_config(CONFIGS[name])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for p in j.plugins:
        assert dataclasses.asdict(t.plugin(p.name)) == \
            dataclasses.asdict(j.plugin(p.name))
    for pr in j.profiles:
        assert dataclasses.asdict(t.profile(pr.name)) == \
            dataclasses.asdict(j.profile(pr.name))
    assert t.plugin("nope") is None and t.profile("nope") is None


MALFORMED = {
    "wrong-kind": "kind: InferencePool\n",
    "plugin-without-type": "plugins:\n- name: q\n",
    "ref-without-name": ("plugins:\n- type: queue-scorer\n"
                         "schedulingProfiles:\n- plugins:\n  - weight: 2\n"),
    "weight-not-a-number": ("plugins:\n- type: queue-scorer\n"
                            "schedulingProfiles:\n- plugins:\n"
                            "  - pluginRef: queue-scorer\n    weight: x\n"),
    "bad-yaml": "plugins: [type: queue-scorer\n",
    "plugins-not-a-list": "plugins: 3\n",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_configs_fail_alike(name):
    errors = []
    for mod in (jconfig, tconfig):
        with pytest.raises(Exception) as e:
            mod.parse_config(MALFORMED[name])
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_unknown_plugin_types_and_empty_configs_alike():
    text = "plugins:\n- type: no-such-scorer\n"
    errors = []
    for m in (J, T):
        cfg = m["config"].parse_config(text)
        ds = m["ds"].Datastore([], scrape_interval_s=999)
        with pytest.raises(ValueError) as e:
            m["scheduler"].EppScheduler(cfg, ds)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    j, t = (m["config"].parse_config("") for m in (J, T))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert [p.name for p in t.profiles] == ["default"]


# ---------------------------------------------------------------------------
# seeded endpoint states
# ---------------------------------------------------------------------------

N_EP = 6
BLOCK = 64


def _addresses():
    return [f"10.0.0.{i}:8200" for i in range(N_EP)]


def _prompts(rng, n):
    """Token-id prompts sharing prefixes (whole 64-token blocks), and a
    few text prompts and chats."""
    stems = [rng.integers(1, 1000, BLOCK * k).tolist() for k in (2, 4, 6)]
    out = []
    for i in range(n):
        kind = i % 5
        if kind == 3:
            out.append({"prompt": "x" * int(rng.integers(0, 900))})
        elif kind == 4:
            out.append({"messages": [
                {"role": "user", "content": "y" * int(rng.integers(1, 600))}]})
        else:
            stem = stems[int(rng.integers(0, len(stems)))]
            cut = int(rng.integers(0, len(stem) + 1))
            tail = rng.integers(1, 1000, int(rng.integers(0, 130))).tolist()
            out.append({"prompt": stem[:cut] + tail})
    return stems, out


def _headers(rng, i):
    h = {}
    if i % 3 == 0:
        h["x-prediction-based-scheduling"] = "true"
        h["x-slo-ttft-ms"] = str(float(rng.choice([30, 200, 900, 5000])))
        h["x-slo-tpot-ms"] = str(float(rng.choice([5, 12, 40])))
    if i % 4 == 1:
        h["x-llmd-criticality"] = "sheddable"
    return h


class World:
    """One package's datastore (seeded endpoint states), prefix index
    (seeded KV events) and metrics."""

    def __init__(self, m, seed: int, stems) -> None:
        rng = np.random.default_rng(seed)
        self.m = m
        self.metrics = m["metrics"].EppMetrics()
        breaker = m["ds"].EndpointBreaker(failure_threshold=2, open_s=60.0,
                                          metrics=self.metrics)
        eps = []
        for i, addr in enumerate(_addresses()):
            e = m["ds"].EndpointState(
                address=addr,
                role=["prefill", "decode", "both"][i % 3] if i < 5
                else "both",
                num_waiting=float(rng.integers(0, 9)),
                num_running=float(rng.integers(0, 17)),
                kv_usage=float(rng.uniform(0, 1.05)),
                ready=bool(rng.uniform() > 0.1) or i < 3,
                draining=bool(rng.uniform() < 0.2) and i >= 3)
            eps.append(e)
        self.ds = m["ds"].Datastore(eps, scrape_interval_s=999,
                                    breaker=breaker)
        for addr in _addresses()[4:5]:          # one open breaker
            breaker.record_failure(addr)
            breaker.record_failure(addr)
        self.index = m["indexer"].PrefixIndex(metrics=self.metrics)
        from llm_d_tpu_torch.utils.hashing import hash_token_blocks
        for stem in stems:
            keys = hash_token_blocks(stem, BLOCK)
            for addr in _addresses():
                n = int(rng.integers(0, len(keys) + 1))
                tier = "host" if rng.uniform() < 0.3 else "device"
                if n:
                    self.index.on_event(addr, "BlockStored", keys[:n],
                                        nbytes=int(rng.integers(1, 5)) << 20,
                                        tier=tier)
            if rng.uniform() < 0.5:
                self.index.on_event(_addresses()[0], "BlockRemoved",
                                    keys[1:2])


PARAMS = {
    "prefix-cache-scorer": [{}, {"hashBlockSize": 64,
                                 "lruCapacityPerServer": 3}],
    "precise-prefix-cache-scorer": [{"kvEventsPort": 5557},
                                    {"indexerConfig": {"tokenProcessorConfig":
                                                       {"blockSize": 64}}}],
    "kv-placement-scorer": [{"blockSize": 64, "kvBytesPerToken": 131072},
                            {"blockSize": 64, "ttftPerWaitingMs": 10}],
    "random-picker": [{}, {"maxNumOfEndpoints": 2}],
    "pd-profile-handler": [{"threshold": 0}, {"threshold": 200}],
    "slo-scorer": [{}, {"headroomSelectionStrategy": "most",
                        "sloBufferFactor": 1.2}],
}


def _make(world, ptype, params, rng=None):
    m = world.m
    cls = m["plugins"].PLUGIN_TYPES[ptype]
    P = m["plugins"]
    if cls is P.PrecisePrefixCacheScorer:
        return cls(ptype, params, world.ds, indexer=world.index)
    if cls is P.KvPlacementScorer:
        return cls(ptype, params, world.ds, indexer=world.index,
                   metrics=world.metrics)
    if cls is P.PdProfileHandler:
        return cls(ptype, params, world.ds, metrics=world.metrics)
    if cls in (P.MaxScorePicker, P.RandomPicker) and rng is not None:
        return cls(ptype, params, world.ds, rng=rng)
    return cls(ptype, params, world.ds)


def _ctx(m, body, headers):
    return m["plugins"].RequestCtx.from_request(dict(body), dict(headers))


def _state(ctx):
    """What a plugin may leave on the context."""
    return dict(headers=dict(ctx.headers), shed=ctx.shed,
                predictions=dict(ctx.predictions),
                prediction_based=ctx.prediction_based,
                slo=(ctx.slo_ttft_ms, ctx.slo_tpot_ms),
                plan=getattr(ctx, "kv_restore_plan", None))


def _metrics_text(metrics):
    text = metrics.render().decode()
    text = re.sub(r"(_created(\{[^}]*\})?) \S+", r"\1 T", text)
    # Durations differ run to run: keep the counts, drop sums and buckets.
    return [ln for ln in text.splitlines()
            if not re.match(r"\S+_duration_seconds_(sum|bucket)", ln)]


@pytest.mark.parametrize("ptype", sorted(jplugins.PLUGIN_TYPES))
def test_plugin_types_are_the_jax_types(ptype):
    assert sorted(tplugins.PLUGIN_TYPES) == sorted(jplugins.PLUGIN_TYPES)
    assert tplugins.PLUGIN_TYPES[ptype].__name__ == \
        jplugins.PLUGIN_TYPES[ptype].__name__


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("ptype", sorted(jplugins.PLUGIN_TYPES))
def test_every_plugin_scores_as_jax(ptype, seed):
    rng = np.random.default_rng(100 + seed)
    stems, bodies = _prompts(rng, 15)
    worlds = [World(m, seed, stems) for m in (J, T)]
    for params in PARAMS.get(ptype, [{}]):
        random.seed(seed)
        t_rng = random.Random(seed)
        plugins = [_make(worlds[0], ptype, params),
                   _make(worlds[1], ptype, params, rng=t_rng)]
        for i, body in enumerate(bodies):
            hdr = _headers(np.random.default_rng(i + 7 * seed), i)
            ctxs = [_ctx(m, body, hdr) for m in (J, T)]
            got = []
            for w, p, ctx in zip(worlds, plugins, ctxs):
                cands = [e for e in w.ds.candidates() if e.ready]
                out = {"filter": [e.address for e in p.filter(ctx, cands)]}
                scores = p.score(ctx, cands)
                out["score"] = scores
                totals = {e.address: float(k) for k, e in enumerate(cands)}
                if i % 2:
                    totals = {a: 1.0 for a in totals}       # all tied
                pick = p.pick(ctx, cands, totals)
                out["pick"] = pick.address if pick is not None else None
                if hasattr(p, "profiles"):
                    out["profiles"] = [
                        p.profiles(ctx, pr) for pr in
                        (["default"], ["prefill", "decode"], ["decode"],
                         ["default", "slo"], [])]
                for prof in ("default", "prefill", "decode"):
                    p.on_picked(ctx, cands[i % len(cands)], prof)
                out["after"] = _state(ctx)
                out["rescore"] = p.score(ctx, cands)
                got.append(out)
            assert got[1] == got[0], (ptype, params, i)
    assert _metrics_text(worlds[1].metrics) == \
        _metrics_text(worlds[0].metrics)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("ptype", ["max-score-picker", "random-picker"])
def test_pickers_draw_ties_like_the_global_random(ptype, seed):
    """``random.Random(s)`` in the port, ``random.seed(s)`` in JAX: the
    same endpoint on every tie, over many draws."""
    stems, _ = _prompts(np.random.default_rng(seed), 1)
    worlds = [World(m, seed, stems) for m in (J, T)]
    random.seed(seed)
    jp = _make(worlds[0], ptype, {})
    tp = _make(worlds[1], ptype, {}, rng=random.Random(seed))
    jc, tc = ([e for e in w.ds.candidates()] for w in worlds)
    picks = []
    for k in range(200):
        totals = {e.address: float(k % 3 == 0 and e.address.endswith("1:8200"))
                  for e in jc}
        j = jp.pick(None, jc, totals).address
        t = tp.pick(None, tc, totals).address
        picks.append((j, t))
    assert all(j == t for j, t in picks)
    assert len({j for j, _ in picks}) > 1


def test_slo_scorer_with_the_analytic_predictor():
    """The predictor itself, endpoint by endpoint, and the shed verdict of
    a sheddable request no pod can serve in time."""
    stems, _ = _prompts(np.random.default_rng(5), 1)
    worlds = [World(m, 5, stems) for m in (J, T)]
    for params in ({}, {"ttftBaseMs": 10, "tpotPerRunningMs": 2.0}):
        preds = [m["plugins"].AnalyticLatencyPredictor(params) for m in (J, T)]
        for ej, et in zip(worlds[0].ds.candidates(),
                          worlds[1].ds.candidates()):
            for n in (0, 100, 4000):
                assert preds[1].predict(et, n) == preds[0].predict(ej, n)
    got = []
    for w in worlds:
        p = _make(w, "slo-scorer", {})
        ctx = _ctx(w.m, {"prompt": [1] * 300, "priority": -1},
                   {"x-slo-ttft-ms": "1", "x-slo-tpot-ms": "1"})
        w.m["plugins"].SloRequestTracker("t", {}, w.ds).score(ctx, [])
        scores = p.score(ctx, w.ds.candidates())
        got.append((scores, ctx.shed))
    assert got[1] == got[0] and got[0][1] is True
    for w in worlds:                    # a bad SLO header: ValueError alike
        ctx = _ctx(w.m, {"prompt": "x"}, {"x-slo-ttft-ms": "fast"})
        with pytest.raises(ValueError, match="invalid SLO header"):
            w.m["plugins"].SloRequestTracker("t", {}, w.ds).score(ctx, [])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def prediction_server():
    """JAX's prediction server (aiohttp) with a trained latency model."""
    from aiohttp import web
    from llm_d_tpu.predictor.model import (
        TPOT_FEATURES, TTFT_FEATURES, LatencyModel)
    from llm_d_tpu.predictor.server import PredictionServer
    rng = np.random.default_rng(0)
    models = {}
    for target, feats in (("ttft", TTFT_FEATURES), ("tpot", TPOT_FEATURES)):
        X = rng.uniform(0, 10, (64, len(feats)))
        y = 20 + X @ rng.uniform(1, 5, len(feats))
        m = LatencyModel(feats)
        m.fit(X, y)
        models[target] = m
    server = PredictionServer("http://127.0.0.1:1", sync_interval_s=3600)
    loop = asyncio.new_event_loop()
    port = _free_port()
    runner = web.AppRunner(server.build_app())

    async def start():
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
    threading.Thread(target=loop.run_forever, daemon=True).start()
    asyncio.run_coroutine_threadsafe(start(), loop).result(30)
    server.models = models
    yield f"http://127.0.0.1:{port}"
    asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)


@pytest.mark.parametrize("alive", [True, False])
def test_http_predictor_against_the_jax_prediction_server(
        prediction_server, alive):
    url = prediction_server if alive else f"http://127.0.0.1:{_free_port()}"
    stems, _ = _prompts(np.random.default_rng(6), 1)
    worlds = [World(m, 6, stems) for m in (J, T)]
    preds = [m["plugins"].HttpLatencyPredictor([url, url], timeout_s=5.0)
             for m in (J, T)]
    analytic = tplugins.AnalyticLatencyPredictor({})
    for ej, et in zip(worlds[0].ds.candidates(), worlds[1].ds.candidates()):
        for n in (0, 300, 1000):
            j, t = preds[0].predict(ej, n), preds[1].predict(et, n)
            assert t == j
            assert (t == analytic.predict(et, n)) is (not alive)
    # The slo-scorer configured with the sidecars scores as JAX's.
    got = []
    for w in worlds:
        p = _make(w, "slo-scorer", {"predictionServerURL": f"{url},{url}"})
        ctx = _ctx(w.m, {"prompt": [5] * 700},
                   {"x-slo-ttft-ms": "400", "x-slo-tpot-ms": "30"})
        w.m["plugins"].SloRequestTracker("t", {}, w.ds).score(ctx, [])
        got.append(p.score(ctx, w.ds.candidates()))
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _result(res):
    return dict(picks={k: e.address for k, e in res.picks.items()},
                headers=res.headers, scores=res.scores,
                breakdown=res.breakdown,
                primary=res.primary.address if res.primary else None)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scheduler_results_equal_under_every_config(name, seed):
    rng = np.random.default_rng(200 + seed)
    stems, bodies = _prompts(rng, 24)
    worlds = [World(m, seed, stems) for m in (J, T)]
    random.seed(seed)
    scheds = [jscheduler.EppScheduler(
                  jconfig.parse_config(CONFIGS[name]), worlds[0].ds,
                  metrics=worlds[0].metrics, indexer=worlds[0].index),
              tscheduler.EppScheduler(
                  tconfig.parse_config(CONFIGS[name]), worlds[1].ds,
                  metrics=worlds[1].metrics, indexer=worlds[1].index,
                  rng=random.Random(seed))]
    assert list(scheds[1].plugins) == list(scheds[0].plugins)
    assert type(scheds[1]._profile_handler).__name__ == \
        type(scheds[0]._profile_handler).__name__
    for i, body in enumerate(bodies):
        hdr = _headers(np.random.default_rng(i), i)
        got = []
        for m, w, s in zip((J, T), worlds, scheds):
            ctx = _ctx(m, body, hdr)
            ctx.retry_attempt = i % 4 == 3
            if i % 6 == 5:
                ctx.excluded_endpoints = {_addresses()[i % N_EP]}
            res = s.schedule(ctx)
            got.append((_result(res), _state(ctx)))
        assert got[1] == got[0], (name, i)
    assert _metrics_text(worlds[1].metrics) == \
        _metrics_text(worlds[0].metrics)


def test_prefill_alternates_rank_runners_up_as_jax():
    """A P/D pool of four prefillers: the hint header carries the winner
    and two runners-up in score order, as the JAX scheduler's."""
    text = CONFIGS["deploy/pd-disaggregation/pd.yaml:pd-config.yaml"]
    text = text.replace("- type: prefill-filter",
                        "- type: prefill-header-handler\n"
                        "- type: prefill-filter")
    got = []
    for m in (J, T):
        cfg = m["config"].parse_config(text)
        cfg.profile("prefill").plugins.append(
            m["config"].ProfilePluginRef("prefill-header-handler"))
        eps = [m["ds"].EndpointState(address=f"p{i}:1", role="prefill",
                                     num_waiting=float(i), ready=True)
               for i in range(4)]
        eps.append(m["ds"].EndpointState(address="d:1", role="decode",
                                         ready=True))
        ds = m["ds"].Datastore(eps, scrape_interval_s=999)
        kw = {} if m is J else {"rng": random.Random(0)}
        random.seed(0)
        res = m["scheduler"].EppScheduler(cfg, ds, **kw).schedule(
            _ctx(m, {"prompt": [1] * 100}, {}))
        got.append(_result(res))
    assert got[1] == got[0]
    assert got[0]["headers"]["x-prefiller-host-port"] == "p0:1,p1:1,p2:1"


def test_breaker_states_and_series_equal():
    out = []
    for m in (J, T):
        metrics = m["metrics"].EppMetrics()
        b = m["ds"].EndpointBreaker(failure_threshold=2, open_s=0.2,
                                    probe_interval_s=0.1, metrics=metrics)
        seq = []
        for op in ("fail", "ok", "fail", "fail", "adm", "sleep", "adm",
                   "adm", "pick", "fail", "sleep", "adm", "ok", "adm",
                   "forget"):
            if op == "fail":
                b.record_failure("a")
            elif op == "ok":
                b.record_success("a")
            elif op == "adm":
                seq.append(b.admissible("a"))
            elif op == "pick":
                b.note_pick("a")
            elif op == "sleep":
                time.sleep(0.25)
            elif op == "forget":
                text_before = _metrics_text(metrics)
                b.forget("a")
            seq.append(b.state("a"))
        b.record_failure("b")
        seq.append(b.states())
        out.append((seq, text_before, _metrics_text(metrics)))
    assert out[1] == out[0]


@pytest.mark.parametrize("knobs", [{}, {
    "LLMD_KV_TRANSFER_PEER_GBPS": "25", "LLMD_KV_TRANSFER_HOST_GBPS": "100",
    "LLMD_KV_TRANSFER_SETUP_MS": "0.5"}])
def test_transfer_cost_model_prices_restores_as_jax(knobs, monkeypatch):
    """The kv-placement scorer's link prices: the analytic prior, from the
    ``LLMD_KV_TRANSFER_*`` knobs (``knobs``, else their defaults), equal
    to an uncalibrated JAX model's."""
    from llm_d_tpu.predictor.model import TransferCostModel as J
    from llm_d_tpu_torch.utils.predictor import TransferCostModel as T
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    models = [J(), T()]
    for src in ("peer", "host", "other"):
        for nbytes in (0, 1, 1 << 20, 3 << 30):
            assert models[1].restore_ms(nbytes, src) == \
                models[0].restore_ms(nbytes, src)
