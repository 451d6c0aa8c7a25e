"""Port parity: the shared tier's peer discovery
(``llm_d_tpu_torch.utils.discovery``, standard library only) against the
JAX package's resolvers (``llm_d_tpu.epp.discovery``, asyncio and
aiohttp), and the tiered-prefix-cache recipe's flags served by the port.

* ``parse_discover_spec`` on every discovery spec in ``deploy/``: the
  same resolver kind and fields as JAX's; a malformed spec raises in both.
* ``DnsResolver("localhost")``: JAX's answer (IPv6 bracketed); a lookup
  error is None in both (``getaddrinfo`` made to fail: no name leaves the
  host).
* The k8s resolver, port and JAX, against one fake standard-library API
  server: the same list (unready addresses still listed), label selector,
  URL and bearer header; a 403 and a missing API server are None in both.
* ``MultiResolver`` serving a failing resolver's last good answer: the
  same sequence of answers as JAX's.
* A one-device tier with ``dns:localhost:<port>`` peers pulls the prefix
  from that port (port from port, and the JAX tier from a port pod); its
  refresh follows churn, static peers first, departed peers' health gone.
* The recipe's flags (``deploy/tiered-prefix-cache/modelserver.yaml``)
  with ``tiny`` at tp = 2 pass ``check_served`` / ``check_mesh_flags``.
* Two entry points (``python -m llm_d_tpu_torch.server.openai``) with the
  recipe's flags on a tp = 2 CPU mesh under ``LLMD_STEP_TIME_TARGET_MS``,
  each the other's peer by ``dns:localhost:<port>``: B's reply equals
  A's, B's shared-tier hits count the prompt's full blocks, both exit 0
  on SIGTERM.
"""

import asyncio
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import requests
import torch

from llm_d_tpu.epp import discovery as JDisc
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.utils import discovery as TDisc

from test_torch_tp_server import _alive, _children, _free_port

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC_RE = re.compile(r"(?:dns|k8s):[^\",\s]+")


def deploy_specs():
    specs = set()
    for path in sorted((ROOT / "deploy").rglob("*.yaml")):
        specs.update(SPEC_RE.findall(path.read_text()))
    return sorted(specs)


def _fields(r):
    keys = ("name", "service", "namespace", "port", "role", "api_server")
    return type(r).__name__, {k: getattr(r, k) for k in keys
                              if hasattr(r, k)}


# ---------- specs ----------

@pytest.mark.parametrize("spec", deploy_specs() + [
    "k8s:prod/ms-decode:8200=decode", "dns:ms:1=prefill"])
def test_specs_parse_as_the_jax_resolvers_do(spec):
    assert _fields(TDisc.parse_discover_spec(spec)) == \
        _fields(JDisc.parse_discover_spec(spec))


@pytest.mark.parametrize("spec", ["zk:nope:1", "dns::8", "k8s::9",
                                  "dns:svc:port"])
def test_malformed_specs_raise_in_both(spec):
    for mod in (TDisc, JDisc):
        with pytest.raises(ValueError):
            mod.parse_discover_spec(spec)


def test_the_deploy_specs_include_the_tiered_recipes():
    assert "dns:ms-tiered:8700" in deploy_specs()


# ---------- dns ----------

def test_dns_resolver_answers_as_jax(monkeypatch):
    got = TDisc.DnsResolver("localhost", 8200, role="decode").resolve()
    want = asyncio.run(JDisc.DnsResolver("localhost", 8200,
                                         role="decode").resolve())
    assert got == want and ("127.0.0.1:8200", "decode") in got

    def fake(host, port, *a, **kw):
        return [(socket.AF_INET6, socket.SOCK_STREAM, 6, "",
                 ("::1", port, 0, 0)),
                (socket.AF_INET, socket.SOCK_STREAM, 6, "",
                 ("127.0.0.1", port))]
    monkeypatch.setattr(socket, "getaddrinfo", fake)
    got = TDisc.DnsResolver("svc", 9).resolve()
    assert got == asyncio.run(JDisc.DnsResolver("svc", 9).resolve())
    assert got == [("127.0.0.1:9", "both"), ("[::1]:9", "both")]

    def broken(*a, **kw):
        raise socket.gaierror(socket.EAI_NONAME, "no such name")
    monkeypatch.setattr(socket, "getaddrinfo", broken)
    assert TDisc.DnsResolver("svc", 1).resolve() is None
    assert asyncio.run(JDisc.DnsResolver("svc", 1).resolve()) is None


# ---------- k8s ----------

SLICES = {"items": [
    {"endpoints": [
        {"addresses": ["10.0.0.1"], "conditions": {"ready": True}},
        {"addresses": ["10.0.0.2"], "conditions": {"ready": False}},
        {"addresses": ["10.0.0.3"]}]},
    {"endpoints": [{"addresses": ["10.0.0.4"], "conditions": {}}]}]}


@pytest.fixture(scope="module")
def api_server():
    """A fake Kubernetes API: EndpointSlices of namespace ``prod``; the
    ``denied`` Service answers 403.  Records each request."""
    seen = []

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append((self.path, self.headers.get("Authorization")))
            ok = self.path.startswith(
                "/apis/discovery.k8s.io/v1/namespaces/prod/endpointslices")
            if not ok or "denied" in self.path:
                self.send_response(403 if ok else 404)
                self.end_headers()
                return
            body = json.dumps(SLICES).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}", seen
    finally:
        srv.shutdown()
        srv.server_close()


def _jax_resolve(r):
    async def run():
        try:
            return await r.resolve()
        finally:
            await r.close()
    return asyncio.run(run())


@pytest.mark.parametrize("service", ["ms-decode", "denied"])
def test_k8s_resolver_reads_the_api_as_jax(api_server, service):
    url, seen = api_server
    kw = dict(namespace="prod", role="decode", api_server=url, token="tok",
              ca_file="")
    seen.clear()
    got = TDisc.K8sEndpointSliceResolver(service, 8200, **kw).resolve()
    mine = list(seen)
    seen.clear()
    want = _jax_resolve(JDisc.K8sEndpointSliceResolver(service, 8200, **kw))
    assert got == want
    assert mine == seen and len(mine) == 1
    path, auth = mine[0]
    assert auth == "Bearer tok"
    assert path.endswith(
        f"?labelSelector=kubernetes.io/service-name={service}")
    if service == "denied":
        assert got is None
    else:
        assert got == [(f"10.0.0.{i}:8200", "decode") for i in (1, 2, 3, 4)]


def test_k8s_resolver_without_an_api_server_is_an_outage(monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    r, j = (m.K8sEndpointSliceResolver("x", 1) for m in (TDisc, JDisc))
    assert r.api_server is None and j.api_server is None
    assert r.namespace == j.namespace
    assert r.resolve() is None and _jax_resolve(j) is None


# ---------- multi ----------

def test_multi_resolver_serves_stale_while_a_resolver_errors():
    seq = [[("c:3", "decode")], None, "boom", [("c:4", "decode")]]

    class Fixed:
        def resolve(self):
            return [("a:1", "both")]

    class Flaky:
        def __init__(self):
            self.results = list(seq)

        def resolve(self):
            r = self.results.pop(0)
            if r == "boom":
                raise RuntimeError("api down")
            return r

    class AFlaky(Flaky):
        async def resolve(self):
            return Flaky.resolve(self)

    port = TDisc.MultiResolver([Fixed(), Flaky()])
    jax_r = JDisc.MultiResolver([JDisc.StaticResolver([("a:1", "both")]),
                                 AFlaky()])
    got = [port.resolve() for _ in seq]
    want = [asyncio.run(jax_r.resolve()) for _ in seq]
    assert got == want
    assert got[2] == [("a:1", "both"), ("c:3", "decode")]
    # Every resolver failing with no history: an outage in both.
    lone, alone = Flaky(), AFlaky()
    lone.results = alone.results = ["boom"]
    assert TDisc.MultiResolver([lone]).resolve() is None
    assert asyncio.run(JDisc.MultiResolver([alone]).resolve()) is None


# ---------- the tier ----------

BS = 4
TIER_KW = dict(block_size=BS, num_blocks=16, max_num_seqs=4,
               max_num_batched_tokens=64, min_token_bucket=16,
               min_seq_bucket=4, kv_offload_blocks=64)
PROMPT = [7, 3, 9, 1, 4, 6, 2, 8, 5, 0, 11, 13]     # 3 full blocks


def _greedy(rid, R=Request, SP=SamplingParams):
    return R(rid, list(PROMPT), SP(temperature=0.0, max_tokens=4,
                                   ignore_eos=True))


@pytest.fixture(scope="module")
def jparams():
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    return JEngineCore(JEngineConfig(model="tiny", block_size=BS,
                                     num_blocks=16)).params


def _port(jparams, **kw):
    return EngineCore(EngineConfig(model="tiny", device="cpu", **TIER_KW,
                                   **kw),
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jparams), "cpu"))


def _jax(jparams, **kw):
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    return JEngineCore(JEngineConfig(model="tiny", **TIER_KW, **kw),
                       params=jparams)


@pytest.mark.parametrize("fetching", ["port", "jax"])
def test_a_tier_with_dns_peers_pulls_from_that_port(jparams, fetching):
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    pod_a = _port(jparams, kv_shared_tier_port=0)
    try:
        first = pod_a.generate([_greedy("a")])["a"]
        addr = f"127.0.0.1:{pod_a.host_tier.port}"
        make, R = ((_port, (Request, SamplingParams)) if fetching == "port"
                   else (_jax, (JRequest, JSamplingParams)))
        pod_b = make(jparams, kv_shared_tier_peers=(
            f"dns:localhost:{pod_a.host_tier.port}",))
        try:
            assert addr in pod_b.host_tier.peers     # the first resolve
            rb = _greedy("b", *R)
            assert pod_b.generate([rb])["b"] == first
            assert pod_b.host_tier.remote_hits >= 2
            assert rb.num_cached_prompt_tokens >= 8
        finally:
            pod_b.host_tier.close()
    finally:
        pod_a.host_tier.close()


def test_the_refresh_follows_churn_as_jax(jparams, monkeypatch):
    """A resolve that names other peers replaces the resolved ones and
    drops departed peers' health; static peers come first; an outage
    keeps the last view.  The same on the JAX tier."""
    spec = "dns:localhost:7"
    tiers = [_port(jparams, kv_shared_tier_peers=(
                 "127.0.0.1:5", spec)).host_tier,
             _jax(jparams, kv_shared_tier_peers=(
                 "127.0.0.1:5", spec)).host_tier]
    answers = {"now": [("127.0.0.9:5999", "both")]}

    def fake(self):
        return answers["now"]

    async def afake(self):
        return answers["now"]
    monkeypatch.setattr(TDisc.DnsResolver, "resolve", fake)
    monkeypatch.setattr(JDisc.DnsResolver, "resolve", afake)
    try:
        for t in tiers:
            assert t.peers == ["127.0.0.1:5", "127.0.0.1:7"]
            t._peer_health["127.0.0.1:7"] = (3, 0.0)
            t._refresh_peers()
            assert t.peers == ["127.0.0.1:5", "127.0.0.9:5999"]
            assert "127.0.0.1:7" not in t._peer_health
        answers["now"] = None
        for t in tiers:
            t._refresh_peers()
            assert t.peers == ["127.0.0.1:5", "127.0.0.9:5999"]
    finally:
        for t in tiers:
            t.close()


# ---------- the recipe's flags ----------

def recipe_flags():
    """The model server's args in ``deploy/tiered-prefix-cache``."""
    text = (ROOT / "deploy/tiered-prefix-cache/modelserver.yaml").read_text()
    args = text.split("args:", 1)[1].split("env:", 1)[0]
    return re.findall(r'^\s*- "([^"]*)"', args, re.M)


def _on_the_cpu(flags, tp=2):
    out = list(flags)
    out[out.index("--model") + 1] = "tiny"
    out[out.index("--tensor-parallel-size") + 1] = str(tp)
    return [a.replace("$(POD_IP)", "127.0.0.1") for a in out] + [
        "--device", "cpu"]


def test_the_recipes_flags_are_served_on_a_tp2_mesh(capsys):
    from llm_d_tpu_torch.parallel.mesh import MeshConfig
    from llm_d_tpu_torch.server import openai as TServer
    flags = recipe_flags()
    for f in ("--tensor-parallel-size", "--kv-offload-blocks",
              "--kv-shared-tier-port", "--kv-shared-tier-peers",
              "--kv-events-endpoint", "--pod-identity"):
        assert f in flags
    p = TServer.build_arg_parser()
    args = p.parse_args(_on_the_cpu(flags))
    TServer.check_served(p, args)
    TServer.check_mesh_flags(p, args)
    assert capsys.readouterr().err == ""
    cfg = TServer.engine_config_from_args(args)
    assert cfg.mesh == MeshConfig(tp=2)
    assert cfg.kv_shared_tier_peers == ("dns:ms-tiered:8700",)
    assert (cfg.kv_offload_blocks, cfg.kv_shared_tier_port) == (41000, 8700)


# ---------- the recipe's entry points ----------

NEW = 4


class _Pod:
    """One entry point with the recipe's flags at tp = 2 on the CPU, in a
    process group of its own (its ranks die with it)."""

    def __init__(self, name, tier_port, peer_port):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        flags = _on_the_cpu(recipe_flags())
        for flag, value in (
                ("--port", self.port), ("--kv-offload-blocks", 64),
                ("--kv-shared-tier-port", tier_port),
                ("--kv-shared-tier-peers", f"dns:localhost:{peer_port}"),
                ("--kv-events-endpoint", f"tcp://127.0.0.1:{_free_port()}"),
                ("--pod-identity", f"127.0.0.1:{self.port}")):
            flags[flags.index(flag) + 1] = str(value)
        flags += ["--host", "127.0.0.1", "--block-size", str(BS),
                  "--num-blocks", "64", "--max-num-seqs", "8",
                  "--max-num-batched-tokens", "64"]
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("LWS_")}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", LLMD_DRAIN_TIMEOUT_S="20",
                   LLMD_STEP_TIME_TARGET_MS="50")
        self.log_path = ROOT / "build" / f"test_tier_{name}_{os.getpid()}.log"
        self.log_path.parent.mkdir(exist_ok=True)
        self._log = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_tpu_torch.server.openai", *flags],
            env=env, cwd=str(ROOT), stdout=self._log,
            stderr=subprocess.STDOUT, start_new_session=True)

    def wait_ready(self, deadline):
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, self.log()
            try:
                if requests.get(self.url + "/v1/models",
                                timeout=5).status_code == 200:
                    return
            except requests.ConnectionError:
                pass
            time.sleep(0.2)
        raise TimeoutError(self.log())

    def tokens(self, prompt):
        r = requests.post(self.url + "/v1/completions", json=dict(
            prompt=prompt, max_tokens=NEW, temperature=0.0, ignore_eos=True,
            stream=True), stream=True, timeout=60)
        assert r.status_code == 200
        frames = [json.loads(ln[6:]) for ln in r.iter_lines()
                  if ln.startswith(b"data: ") and ln != b"data: [DONE]"]
        return [t for f in frames if "llmd" in f for t in f["llmd"]["tok"]]

    def metric(self, name):
        text = requests.get(self.url + "/metrics", timeout=10).text
        return sum(float(line.rsplit(" ", 1)[1])
                   for line in text.splitlines()
                   if line.startswith(name + "{"))

    def log(self) -> str:
        self._log.flush()
        return self.log_path.read_text(errors="replace")[-4000:]

    def close(self):
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=30)
        self._log.close()
        self.log_path.unlink(missing_ok=True)


def test_the_recipes_entry_points_share_a_prefix_on_tp2_meshes():
    tier = {"a": _free_port(), "b": _free_port()}
    pods = {"a": _Pod("a", tier["a"], tier["b"]),
            "b": _Pod("b", tier["b"], tier["a"])}
    try:
        deadline = time.monotonic() + 120
        for pod in pods.values():
            pod.wait_ready(deadline)
        first = pods["a"].tokens(PROMPT)
        assert len(first) == NEW
        assert pods["b"].tokens(PROMPT) == first
        hits = pods["b"].metric("llmd_tpu:kv_shared_tier_hits_total")
        assert hits >= (len(PROMPT) - 1) // BS, pods["b"].log()
        ranks = {n: _children(p.proc.pid) for n, p in pods.items()}
        for pod in pods.values():
            pod.proc.send_signal(signal.SIGTERM)
        for n, pod in pods.items():
            assert pod.proc.wait(timeout=60) == 0, pod.log()
        time.sleep(0.5)
        assert not [c for cs in ranks.values() for c in cs if _alive(c)]
        for n, pod in pods.items():
            log = pod.log()
            assert "mesh rank 1 prefill chunks" in log, log
    finally:
        for pod in pods.values():
            pod.close()
