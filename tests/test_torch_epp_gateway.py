"""Port parity: the EPP gateway (``llm_d_tpu_torch.epp.service``: the
standard-library HTTP gateway) against the JAX package's aiohttp gateway,
both in front of the same port model servers, on the CPU.

* Two ``tiny`` replicas (one weight set) behind both gateways, built
  alike (``DEFAULT_CONFIG_YAML``; the JAX pickers seeded by
  ``random.seed(s)``, the port's by ``random.Random(s)``; each scrape
  taken when the replicas are idle): the same destination
  (``x-gateway-destination-endpoint``), retry-budget header and reply
  for every request, plain and streamed; the same ``/metrics`` families
  and request counts; ``/v1/models``, ``/health``, ``/debug/traces``.
* Statuses: flow control (a sheddable request refused while the one slot
  is held, a standard one refused with the queue full), an expired
  deadline (504 and its header), malformed bodies (400), no ready
  endpoint (503): the same status and body from both.
* Resilience: a ``gateway.forward`` fault on the first forward is retried
  on the alternate replica (destination, budget header, retries counter,
  the breaker opened at one failure and the next request routed round
  it); faults on every forward exhaust the budget: the same 502 body.
* A stream resumes across a port replica's death (an ``engine.step``
  fault) through the port gateway, continuous and equal to an
  uninterrupted run.
* P/D: a ``tiny-mla`` int8 producer and consumer, the port sidecar in
  front of the consumer, both gateways with the recipe's ``pd-config``:
  the same replies, each pulled by the consumer.
* The entry point: ``python -m llm_d_tpu_torch.epp.service`` with
  aiohttp, prometheus_client and jax blocked, the inference-scheduling
  recipe's flags (``--config`` the ConfigMap's file, ``--discover
  dns:localhost:<port>`` twice, ``--kv-events-bind``) and environment:
  it routes, its precise index fills from a replica's KV events, and it
  exits 0 on SIGTERM; the flags parse as JAX's ``main`` parses them, and
  ``--ext-proc-port`` is refused by name.
"""

import asyncio
import json
import os
import pathlib
import random
import re
import signal
import subprocess
import sys
import time

import pytest
import requests
import torch
import yaml

from llm_d_tpu.epp import service as jservice
from llm_d_tpu.epp.datastore import EndpointBreaker as JBreaker
from llm_d_tpu.epp.datastore import EndpointState as JEndpoint
from llm_d_tpu.utils import faultinject as jfault
from llm_d_tpu.utils.metrics import parse_prometheus_text
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.epp import service as tservice
from llm_d_tpu_torch.epp.datastore import EndpointBreaker as TBreaker
from llm_d_tpu_torch.epp.datastore import EndpointState as TEndpoint
from llm_d_tpu_torch.server import openai as TServer
from llm_d_tpu_torch.server import stream_resume as tresume
from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
from llm_d_tpu_torch.utils import faultinject as tfault
from test_torch_server import TIMEOUT, _free_port, _Served, _serve_jax

# One intra-op thread: the suite's parallel workers, each with a thread
# pool as wide as the machine, would oversubscribe its cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(model="tiny", block_size=8, num_blocks=128, max_num_seqs=8,
          max_num_batched_tokens=64, min_token_bucket=16, min_seq_bucket=4,
          enable_prefix_caching=False)
GREEDY = dict(model="m", temperature=0.0, ignore_eos=True)


def _serve_port_app(app, ready_path="/health") -> _Served:
    return _Served(lambda: app.start("127.0.0.1", 0), app.close, ready_path)


def _call(served, coro_fn):
    return asyncio.run_coroutine_threadsafe(coro_fn(), served.loop).result(60)


class Gateways:
    """The JAX gateway and the port's, built alike in front of ``urls``
    (``build`` keyword arguments for both), scraped on demand."""

    def __init__(self, urls, seed=0, roles=None, breakers=(None, None),
                 **build) -> None:
        pods = list(zip([u.split("//")[1] for u in urls],
                        roles or ["both"] * len(urls)))
        build.setdefault("scrape_interval_s", 3600.0)
        self.jgw = jservice.build_gateway(
            [JEndpoint(address=a, role=r) for a, r in pods],
            breaker=breakers[0], **build)
        self.tgw = tservice.build_gateway(
            [TEndpoint(address=a, role=r) for a, r in pods],
            breaker=breakers[1], rng=random.Random(seed), **build)
        self.seed(seed)
        self.jax = _serve_jax(self.jgw, ready_path="/health")
        self.port = _serve_port_app(self.tgw.build_app())
        self.scrape()

    def seed(self, s) -> None:
        random.seed(s)
        self.tgw.scheduler.rng.seed(s)

    def scrape(self) -> None:
        for served, gw in ((self.jax, self.jgw), (self.port, self.tgw)):
            _call(served, gw.datastore.scrape_once)
            assert all(e.ready for e in gw.datastore.candidates()), \
                [(e.address, e.scrape_error)
                 for e in gw.datastore.candidates()]

    def both(self, method, path, **kw):
        kw.setdefault("timeout", TIMEOUT)
        return [requests.request(method, s.url + path, **kw)
                for s in (self.jax, self.port)]

    def close(self) -> None:
        self.port.close()
        self.jax.close()


@pytest.fixture(scope="module")
def replicas():
    eng = EngineCore(EngineConfig(device="cpu", **KW))
    servers = [TServer.build_server(None, engine=e, model_name="m")
               for e in (eng, EngineCore(EngineConfig(device="cpu", **KW),
                                         params=eng.params))]
    served = [_Served(lambda a=s.build_app(): a.start("127.0.0.1", 0),
                      s.app.close) for s in servers]
    yield served
    for s in served:
        s.close()


@pytest.fixture(scope="module")
def gws(replicas):
    g = Gateways([s.url for s in replicas], retry_attempts=2)
    yield g
    g.close()


def _strip(body):
    """A reply without its clock: no ``created``, and of its usage only
    the token counts."""
    body = dict(body)
    body.pop("created", None)
    if isinstance(body.get("usage"), dict):
        body["usage"] = {k: v for k, v in body["usage"].items()
                         if k.endswith("_tokens")}
    return body


def _families(text):
    return sorted(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _counts(text):
    """The metrics a request count decides (no durations)."""
    out = {}
    for k, v in parse_prometheus_text(text).items():
        if "_created" in k or "_bucket" in k or "_sum" in k:
            continue
        if "duration" in k or "phase" in k:
            if not k.split("{")[0].endswith("_count"):
                continue
        out[k] = v
    return out


def test_destinations_replies_and_metrics_equal(gws, replicas):
    gws.seed(11)
    prompts = [[7] * 70, list(range(1, 140)), [7] * 70 + [3] * 10,
               list(range(1, 140)), [5, 6, 7], "a text prompt"]
    dests = []
    for i, prompt in enumerate(prompts):
        gws.scrape()
        for stream in (False, True):
            body = dict(GREEDY, prompt=prompt, max_tokens=4, stream=stream)
            hdr = {"x-request-id": f"rq-{i}-{stream}"}
            rs = gws.both("POST", "/v1/completions", json=body, headers=hdr)
            assert [r.status_code for r in rs] == [200, 200]
            for h in ("x-gateway-destination-endpoint",
                      "x-llmd-retry-budget"):
                assert rs[1].headers.get(h) == rs[0].headers.get(h), h
            dests.append(rs[1].headers["x-gateway-destination-endpoint"])
            if stream:
                assert rs[1].headers["content-type"].startswith(
                    "text/event-stream")
                j, t = (tresume.parse_stream_payload(r.content) for r in rs)
                assert t == j and t[2]
            else:
                assert _strip(rs[1].json()) == _strip(rs[0].json())
    assert len(set(dests)) == 2         # both replicas served
    rs = gws.both("POST", "/v1/chat/completions", json=dict(
        GREEDY, messages=[{"role": "user", "content": "hi"}], max_tokens=3),
        headers={"x-request-id": "chat"})
    assert _strip(rs[1].json()) == _strip(rs[0].json())
    rs = gws.both("GET", "/v1/models")
    assert [r.status_code for r in rs] == [200, 200]
    assert rs[1].json()["data"][0]["id"] == rs[0].json()["data"][0]["id"]
    assert [r.text for r in gws.both("GET", "/health")] == ["ok", "ok"]
    rs = gws.both("GET", "/metrics")
    assert _families(rs[1].text) == _families(rs[0].text)
    assert _counts(rs[1].text) == _counts(rs[0].text)
    traces = gws.both("GET", "/debug/traces")
    names = [sorted({json.loads(ln)["name"] for ln in r.text.splitlines()})
             for r in traces]
    assert {"gateway.request", "gateway.schedule", "gateway.forward"} <= \
        set(names[1])


def test_flow_control_and_request_statuses_equal(replicas):
    g = Gateways([s.url for s in replicas], max_inflight=1, max_queue=0,
                 queue_timeout_s=5.0, retry_attempts=2)
    installed = [jfault.install(jfault.FaultInjector()),
                 tfault.install(tfault.FaultInjector())]
    try:
        got = []
        for served, inj in ((g.jax, installed[0]), (g.port, installed[1])):
            # The first forward holds the one slot for 1.5 s.
            inj.add_rule("gateway.forward", latency_s=1.5, count=1,
                         label="none")
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(3) as ex:
                held = ex.submit(requests.post, served.url + "/v1/completions",
                                 json=dict(GREEDY, prompt=[1, 2], max_tokens=2),
                                 timeout=TIMEOUT)
                time.sleep(0.5)
                shed = requests.post(
                    served.url + "/v1/completions",
                    json=dict(GREEDY, prompt=[1], max_tokens=1),
                    headers={"x-llmd-criticality": "sheddable"},
                    timeout=TIMEOUT)
                full = requests.post(
                    served.url + "/v1/completions",
                    json=dict(GREEDY, prompt=[1], max_tokens=1),
                    timeout=TIMEOUT)
                held = held.result()
            out = [(r.status_code, r.json() if r.status_code != 200
                    else None) for r in (shed, full, held)]
            for body, hdr in (
                    (dict(GREEDY, prompt=[1], max_tokens=1),
                     {"x-llmd-deadline": f"{time.time() - 5:.6f}"}),
                    (dict(GREEDY, prompt=[1], priority="x"), {}),
                    (dict(GREEDY, prompt=[1]),
                     {"x-llmd-criticality": "urgent"})):
                r = requests.post(served.url + "/v1/completions", json=body,
                                  headers=hdr, timeout=TIMEOUT)
                out.append((r.status_code, r.json(),
                            r.headers.get("x-llmd-deadline-exceeded")))
            r = requests.post(served.url + "/v1/completions", data=b"{nope",
                              timeout=TIMEOUT)
            out.append((r.status_code, r.json()))
            got.append(out)
        assert got[1] == got[0]
        assert [o[0] for o in got[0]] == [429, 503, 200, 504, 400, 400, 400]
        rs = g.both("GET", "/metrics")
        assert _counts(rs[1].text) == _counts(rs[0].text)
    finally:
        jfault.reset()
        tfault.reset()
        g.close()


def test_retry_on_an_injected_fault_and_the_breaker_equal(replicas):
    g = Gateways([s.url for s in replicas], seed=5, retry_attempts=2,
                 breakers=(JBreaker(failure_threshold=1, open_s=60.0),
                           TBreaker(failure_threshold=1, open_s=60.0)))
    installed = [jfault.install(jfault.FaultInjector()),
                 tfault.install(tfault.FaultInjector())]
    try:
        got = []
        for served, inj in ((g.jax, installed[0]), (g.port, installed[1])):
            inj.add_rule("gateway.forward", count=1)
            out = []
            for i in range(3):
                r = requests.post(served.url + "/v1/completions", json=dict(
                    GREEDY, prompt=[4, 5, 6], max_tokens=2),
                    headers={"x-request-id": f"f{i}"}, timeout=TIMEOUT)
                out.append((r.status_code, _strip(r.json()),
                            r.headers["x-gateway-destination-endpoint"],
                            r.headers["x-llmd-retry-budget"]))
            assert inj.stats()["gateway.forward"]["fired"] == 1
            got.append(out)
        assert got[1] == got[0]
        assert [o[3] for o in got[0]] == ["1/2", "0/2", "0/2"]
        assert len({o[2] for o in got[0]}) == 1     # routed round the trip
        rs = g.both("GET", "/metrics")
        assert _counts(rs[1].text) == _counts(rs[0].text)
        m = parse_prometheus_text(rs[1].text)
        assert m['llmd_tpu:gateway_retries_total{reason="connect"}'] == 1
        assert sorted(v for k, v in m.items() if k.startswith(
            "llmd_tpu:endpoint_breaker_state{")) == [0.0, 1.0]
        # Every forward fails: the budget runs out, the same 502.
        got = []
        for served, inj in ((g.jax, installed[0]), (g.port, installed[1])):
            inj.clear()
            inj.add_rule("gateway.forward")
            r = requests.post(served.url + "/v1/completions", json=dict(
                GREEDY, prompt=[4], max_tokens=1),
                headers={"x-request-id": "exhaust"}, timeout=TIMEOUT)
            got.append((r.status_code, r.json()))
        assert got[1] == got[0] and got[0][0] == 502
    finally:
        jfault.reset()
        tfault.reset()
        g.close()


def test_no_ready_endpoint_answers_503_alike():
    dead = f"http://127.0.0.1:{_free_port()}"
    jgw = jservice.build_gateway([JEndpoint(address=dead.split("//")[1])],
                                 scrape_interval_s=0.05)
    tgw = tservice.build_gateway([TEndpoint(address=dead.split("//")[1])],
                                 scrape_interval_s=0.05)
    served = [_serve_jax(jgw, ready_path="/health"),
              _serve_port_app(tgw.build_app())]
    try:
        got = []
        for s in served:
            r = requests.post(s.url + "/v1/completions", json=dict(
                GREEDY, prompt=[1], max_tokens=1),
                headers={"x-request-id": "none"}, timeout=TIMEOUT)
            m = requests.get(s.url + "/v1/models", timeout=TIMEOUT)
            got.append((r.status_code, r.json(), m.status_code, m.json()))
        assert got[1] == got[0] and got[0][0] == 503
        errors = [e.scrape_error for gw in (jgw, tgw)
                  for e in gw.datastore.candidates()]
        assert all(errors)
    finally:
        for s in served:
            s.close()


def test_the_port_gateway_resumes_a_stream_across_a_replica_death():
    eng = EngineCore(EngineConfig(device="cpu", **KW))
    servers = [TServer.build_server(None, engine=e, model_name="m")
               for e in (eng, EngineCore(EngineConfig(device="cpu", **KW),
                                         params=eng.params))]
    served = [_Served(lambda a=s.build_app(): a.start("127.0.0.1", 0),
                      s.app.close) for s in servers]
    gw = None
    try:
        body = dict(GREEDY, prompt="recover me mid stream", max_tokens=12,
                    stream=True)
        want = requests.post(served[0].url + "/v1/completions",
                             json=dict(body, stream=False),
                             timeout=TIMEOUT).json()["choices"][0]["text"]
        tgw = tservice.build_gateway(
            [TEndpoint(address=s.url.split("//")[1]) for s in served],
            scrape_interval_s=0.05, retry_attempts=3)
        gw = _serve_port_app(tgw.build_app())
        for _ in range(200):
            if all(e.ready for e in tgw.datastore.candidates()):
                break
            time.sleep(0.05)
        inj = tfault.install(tfault.FaultInjector())
        inj.add_rule("engine.step", after=3, count=1)
        r = requests.post(gw.url + "/v1/completions", json=body,
                          stream=True, timeout=TIMEOUT)
        assert r.status_code == 200
        text, metas, done = tresume.parse_stream_payload(r.content)
        assert done, "the stream did not reach [DONE]"
        assert tresume.verify_continuity(metas, expect_total=12) == []
        assert text == want
        assert inj.stats()["engine.step"]["fired"] == 1
        dead = [s for s in servers if s.async_engine.dead is not None]
        assert len(dead) == 1
        m = parse_prometheus_text(requests.get(
            gw.url + "/metrics", timeout=TIMEOUT).text)
        assert sum(v for k, v in m.items() if k.startswith(
            "llmd_tpu:stream_resume_total{")) == 1
        assert m['llmd_tpu:gateway_retries_total{reason="resume"}'] == 1
        assert m["llmd_tpu:request_recovery_seconds_count"] == 1
    finally:
        tfault.reset()
        if gw is not None:
            gw.close()
        for s in served:
            s.close()


def _pd_config(hint: bool):
    """The recipe's ``pd-config.yaml``; with ``hint``, also the
    prefill-header-handler (the recipe has none: its sidecar's static
    ``--prefiller`` picks the prefill pod)."""
    docs = yaml.safe_load_all(
        (ROOT / "deploy/pd-disaggregation/pd.yaml").read_text())
    cm = next(d for d in docs if d and d.get("kind") == "ConfigMap")
    text = cm["data"]["pd-config.yaml"]
    if hint:
        text = text.replace(
            "- type: prefill-filter\n",
            "- type: prefill-filter\n- type: prefill-header-handler\n", 1)
        text = text.replace(
            "  - pluginRef: prefill-filter\n",
            "  - pluginRef: prefill-filter\n"
            "  - pluginRef: prefill-header-handler\n", 1)
        assert text.count("prefill-header-handler") == 2
    return text


@pytest.mark.parametrize("hint", [False, True])
def test_pd_through_both_gateways_and_the_port_sidecar(hint):
    """The recipe's pd-config (the sidecar's static prefiller), and the
    same with the gateway naming the prefiller in the hint header."""
    from llm_d_tpu_torch.sidecar.proxy import RoutingSidecar
    kw = dict(KW, model="tiny-mla", quantization="int8",
              kv_cache_dtype="int8", block_size=4)
    engines = {}
    base = EngineCore(EngineConfig(device="cpu", **kw))
    served = {}
    for role in ("kv_producer", "kv_consumer"):
        e = EngineCore(EngineConfig(device="cpu", **kw), params=base.params)
        e.kv_connector = TpuConnector(KVConnectorConfig(kv_role=role,
                                                        host="127.0.0.1"))
        engines[role] = e
        s = TServer.build_server(None, engine=e, model_name="m")
        served[role] = _Served(lambda a=s.build_app(): a.start(
            "127.0.0.1", 0), s.app.close)
    side = RoutingSidecar(
        served["kv_consumer"].url, prefill_retries=0,
        static_prefiller=(None if hint
                          else served["kv_producer"].url.split("//")[1]))
    side_served = _serve_port_app(side.build_app(), "/v1/models")
    g = None
    try:
        prompts = [list(range(3, 3 + n)) for n in (9, 13, 17)]
        want = [requests.post(served["kv_consumer"].url + "/v1/completions",
                              json=dict(GREEDY, prompt=p, max_tokens=5),
                              timeout=TIMEOUT).json()["choices"][0]["text"]
                for p in prompts]
        urls = [served["kv_producer"].url, side_served.url]
        g = Gateways(urls, config_yaml=_pd_config(hint),
                     roles=["prefill", "decode"])
        for i, p in enumerate(prompts):
            rs = g.both("POST", "/v1/completions", json=dict(
                GREEDY, prompt=p, max_tokens=5),
                headers={"x-request-id": f"pd{i}"})
            assert [r.status_code for r in rs] == [200, 200]
            assert _strip(rs[1].json()) == _strip(rs[0].json())
            assert rs[1].json()["choices"][0]["text"] == want[i]
            assert rs[1].headers["x-gateway-destination-endpoint"] == \
                side_served.url.split("//")[1]
        text = engines["kv_consumer"].metrics.render().decode()
        assert 'llmd_tpu:kv_transfer_seconds_count{model_name="tiny-mla"} 6' \
            in text
        rs = g.both("GET", "/metrics")
        assert _counts(rs[1].text) == _counts(rs[0].text)
    finally:
        if g is not None:
            g.close()
        side_served.close()
        for s in served.values():
            s.close()
        for e in engines.values():
            e.kv_connector.close()


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _recipe():
    docs = [d for d in yaml.safe_load_all(
        (ROOT / "deploy/inference-scheduling/gateway.yaml").read_text()) if d]
    cm = next(d for d in docs if d.get("kind") == "ConfigMap")
    dep = next(d for d in docs if d.get("kind") == "Deployment")
    c = dep["spec"]["template"]["spec"]["containers"][0]
    return (cm["data"]["default-config.yaml"], c["args"],
            {e["name"]: e["value"] for e in c["env"]})


def _capture(module, argv, monkeypatch):
    """The keyword arguments ``module.main(argv)`` builds its gateway
    with (the build replaced by a recorder; nothing serves)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake(endpoints, config_yaml=None, **kw):
        seen.update(kw, config_yaml=config_yaml,
                    endpoints=[(e.address, e.role) for e in endpoints])
        raise Stop
    monkeypatch.setattr(module, "build_gateway", fake)
    with pytest.raises(Stop):
        module.main(argv)
    r, b = seen.pop("resolver"), seen.pop("breaker")
    subs = getattr(r, "resolvers", [r] if r is not None else [])
    seen["resolvers"] = [(type(x).__name__, getattr(x, "name", None),
                          getattr(x, "service", None), x.port, x.role)
                         for x in subs]
    seen["breaker"] = (b.failure_threshold, b.open_s)
    return seen


@pytest.mark.parametrize("case", ["recipe", "static", "tuned"])
def test_entry_point_flags_parse_as_jax(case, tmp_path, monkeypatch):
    text, args, env = _recipe()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = tmp_path / "default-config.yaml"
    cfg.write_text(text)
    argv = {"recipe": [a if a != "/config/default-config.yaml"
                       else str(cfg) for a in args],
            "static": ["--endpoints", "a:1=prefill,b:2=decode,c:3",
                       "--scrape-interval", "0.5"],
            "tuned": ["--discover", "k8s:ns/svc:8200=decode",
                      "--max-inflight", "0", "--max-queue", "3",
                      "--queue-timeout", "2", "--retry-attempts", "5",
                      "--breaker-failures", "7", "--breaker-open-s", "9",
                      "--resolve-interval", "3", "--port", "9"]}[case]
    j = _capture(jservice, argv, monkeypatch)
    t = _capture(tservice, argv, monkeypatch)
    assert t == j
    if case == "recipe":
        assert j["config_yaml"] == text
        assert j["breaker"] == (3, 5.0)
        assert [r[0] for r in j["resolvers"]] == [
            "K8sEndpointSliceResolver", "DnsResolver"]


def test_entry_point_refusals(monkeypatch, capsys):
    for argv, word in ((["--endpoints", "a:1", "--ext-proc-port", "9002"],
                        "--ext-proc-port: not yet ported"),
                       ([], "need --endpoints and/or --discover")):
        with pytest.raises(SystemExit) as e:
            tservice.main(argv)
        assert e.value.code == 2
        assert word in capsys.readouterr().err


_ENTRY = """
import sys
for name in ("aiohttp", "prometheus_client", "requests", "jax", "grpc"):
    sys.modules[name] = None
from llm_d_tpu_torch.epp.service import main
main(sys.argv[1:])
"""


def test_the_entry_point_serves_the_recipe(tmp_path):
    """The recipe's gateway over two port replicas found by ``dns:``
    specs; one replica publishes its KV events to ``--kv-events-bind``:
    a token prompt's later twin lands where its blocks are, by the
    precise index; SIGTERM exits 0."""
    pytest.importorskip("zmq")
    text, args, env = _recipe()
    cfg = tmp_path / "default-config.yaml"
    cfg.write_text(text)
    kv = f"tcp://127.0.0.1:{_free_port()}"
    kw = dict(KW, block_size=64, num_blocks=32, max_num_batched_tokens=256,
              enable_prefix_caching=True)
    eng = EngineCore(EngineConfig(device="cpu", **kw))
    servers = [TServer.build_server(None, engine=e, model_name="m")
               for e in (eng, EngineCore(EngineConfig(device="cpu", **kw),
                                         params=eng.params))]
    served = [_Served(lambda a=s.build_app(): a.start("127.0.0.1", 0),
                      s.app.close) for s in servers]
    from llm_d_tpu_torch.events.kv_events import ZmqKvEventPublisher
    pubs = []
    for s, srv in zip(served, servers):
        pub = ZmqKvEventPublisher(kv, pod_identity=s.url.split("//")[1],
                                  model="m")
        pub.attach(srv.engine.kv_manager)
        pub.start()
        pubs.append(pub)
    port = _free_port()
    argv = ["--port", str(port), "--host", "127.0.0.1",
            "--config", str(cfg),
            "--discover", ",".join(f"dns:localhost:{s.url.rsplit(':', 1)[1]}"
                                   for s in served),
            "--kv-events-bind", kv]
    proc = subprocess.Popen(
        [sys.executable, "-c", _ENTRY, *argv],
        env=dict(os.environ, PYTHONPATH=str(ROOT), **env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(ROOT))
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(300):
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                if requests.get(url + "/v1/models",
                                timeout=5).status_code == 200:
                    break
            except requests.ConnectionError:
                pass
            time.sleep(0.1)
        prefix = list(range(10, 10 + 128))
        first = requests.post(url + "/v1/completions", json=dict(
            GREEDY, prompt=prefix + [1] * 8, max_tokens=2), timeout=TIMEOUT)
        assert first.status_code == 200, first.text
        home = first.headers["x-gateway-destination-endpoint"]
        for _ in range(100):
            m = parse_prometheus_text(requests.get(
                url + "/metrics", timeout=TIMEOUT).text)
            if m.get("inference_extension_prefix_indexer_size", 0) >= 2:
                break
            time.sleep(0.1)
        assert m["inference_extension_prefix_indexer_size"] >= 2
        for k in range(3):
            r = requests.post(url + "/v1/completions", json=dict(
                GREEDY, prompt=prefix + [2 + k] * 8, max_tokens=2),
                timeout=TIMEOUT)
            assert r.status_code == 200
            assert r.headers["x-gateway-destination-endpoint"] == home
            assert r.headers["x-llmd-kv-placement"] == "local_hit"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        for pub in pubs:
            pub.stop()
        for s in served:
            s.close()
