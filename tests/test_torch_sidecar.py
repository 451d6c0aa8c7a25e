"""Port parity: the routing sidecar (``llm_d_tpu_torch.sidecar.proxy``,
standard-library HTTP) against the JAX package's aiohttp sidecar, both in
front of the same port consumer, on the CPU.

* A ``tiny-mla`` int8 P/D set: two port producers and a port consumer
  (one weight set).  Through either sidecar, a prompt prefilled on the
  hinted producer (``x-prefiller-host-port``) decodes on the consumer
  from the pulled blocks: the same tokens from both sidecars, equal to the
  consumer serving the prompt alone, streamed or not.
* Failover: a dead first prefiller in the hint fails over to the second
  (``LLMD_PREFILL_RETRIES`` / ``LLMD_PREFILL_BACKOFF_S``); every
  prefiller dead prefills locally on the consumer, the reply carrying
  ``x-llmd-prefill-fallback: local``; a prefiller's 4xx is final (no
  second round); the same replies and producer counts from both.
* TLS (``--prefiller-use-tls``): the port's sidecar prefills through a
  TLS front of a producer once the front's CA is trusted, and prefills
  locally when it is not.
* Pass-through (``/health``, ``/v1/models``, ``/metrics``, a 404), an
  expired deadline (504), invalid JSON (400): the same statuses.
* The entry point: ``python -m llm_d_tpu_torch.sidecar.proxy`` with the
  P/D recipe's flags and environment (aiohttp, prometheus_client and jax
  blocked) serves a completion and exits 0 on SIGTERM; the flags parse as
  JAX's ``main`` parses them.
"""

import asyncio
import datetime
import ipaddress
import os
import pathlib
import signal
import ssl
import subprocess
import sys
import threading
import time

import pytest
import requests
import torch
import yaml

from llm_d_tpu.sidecar import proxy as jproxy
from llm_d_tpu.utils.metrics import parse_prometheus_text
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.server import openai as TServer
from llm_d_tpu_torch.server import stream_resume as tresume
from llm_d_tpu_torch.sidecar import proxy as tproxy
from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
from test_torch_server import TIMEOUT, _free_port, _Served, _serve_jax

# One intra-op thread: the suite's parallel workers, each with a thread
# pool as wide as the machine, would oversubscribe its cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(model="tiny-mla", quantization="int8", kv_cache_dtype="int8",
          block_size=4, num_blocks=128, max_num_seqs=8,
          max_num_batched_tokens=64, min_token_bucket=16, min_seq_bucket=4,
          enable_prefix_caching=False)
GREEDY = dict(model="m", temperature=0.0, ignore_eos=True)
HINT = "x-prefiller-host-port"
FALLBACK = "x-llmd-prefill-fallback"


class PD:
    """Producers p1, p2 and a consumer (port servers), and both sidecars
    in front of the consumer."""

    def __init__(self) -> None:
        base = EngineCore(EngineConfig(device="cpu", **KW))
        self.engines, self.served = {}, {}
        for name, role in (("p1", "kv_producer"), ("p2", "kv_producer"),
                           ("c", "kv_consumer")):
            e = EngineCore(EngineConfig(device="cpu", **KW),
                           params=base.params)
            e.kv_connector = TpuConnector(KVConnectorConfig(
                kv_role=role, host="127.0.0.1"))
            s = TServer.build_server(None, engine=e, model_name="m")
            self.engines[name] = e
            self.served[name] = _Served(
                lambda a=s.build_app(): a.start("127.0.0.1", 0), s.app.close)
        self.addr = {n: s.url.split("//")[1] for n, s in self.served.items()}
        self.dead = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
        kw = dict(prefill_retries=1, prefill_backoff_s=0.01)
        self.jside = jproxy.RoutingSidecar(self.served["c"].url, **kw)
        self.tside = tproxy.RoutingSidecar(self.served["c"].url, **kw)
        tapp = self.tside.build_app()
        self.sides = [_serve_jax(self.jside),
                      _Served(lambda: tapp.start("127.0.0.1", 0),
                              tapp.close)]

    def prompt_tokens(self, name) -> float:
        return self.engines[name].metrics.prompt_tokens._value

    def transfers(self) -> float:
        text = self.engines["c"].metrics.render().decode()
        return parse_prometheus_text(text)[
            'llmd_tpu:kv_transfer_seconds_count{model_name="tiny-mla"}']

    def close(self) -> None:
        for s in self.sides:
            s.close()
        for s in self.served.values():
            s.close()
        for e in self.engines.values():
            e.kv_connector.close()


@pytest.fixture(scope="module")
def pd():
    stack = PD()
    yield stack
    stack.close()


def _both(pd, hint, body, headers=None):
    """The same request through the JAX sidecar, then the port's; each
    answer with the producers' prompt tokens it cost."""
    out = []
    for side in pd.sides:
        before = {n: pd.prompt_tokens(n) for n in ("p1", "p2", "c")}
        t0 = pd.transfers()
        hdr = dict(headers or {})
        if hint is not None:
            hdr[HINT] = hint
        r = requests.post(side.url + "/v1/completions", json=body,
                          headers=hdr, timeout=TIMEOUT)
        cost = {n: pd.prompt_tokens(n) - before[n] for n in before}
        out.append((r, cost, pd.transfers() - t0))
    return out


def _text(r, stream):
    if stream:
        return tresume.parse_stream_payload(r.content)[0]
    return r.json()["choices"][0]["text"]


@pytest.mark.parametrize("stream", [False, True])
def test_both_sidecars_give_the_single_engine_tokens(pd, stream):
    prompts = [list(range(5, 5 + n)) for n in (7, 12, 21)]
    for i, p in enumerate(prompts):
        body = dict(GREEDY, prompt=p, max_tokens=5, stream=stream)
        want = requests.post(pd.served["c"].url + "/v1/completions",
                             json=dict(body, stream=False),
                             timeout=TIMEOUT).json()["choices"][0]["text"]
        hint = pd.addr["p1" if i % 2 else "p2"]
        got = _both(pd, hint, body)
        for r, cost, pulled in got:
            assert r.status_code == 200 and FALLBACK not in r.headers
            assert _text(r, stream) == want
            named = "p1" if i % 2 else "p2"
            assert cost[named] == len(p), cost
            assert pulled == 1
        assert [c for _, c, _ in got][0] == [c for _, c, _ in got][1]


def test_failover_to_the_second_prefiller(pd):
    body = dict(GREEDY, prompt=list(range(40, 58)), max_tokens=4)
    want = requests.post(pd.served["c"].url + "/v1/completions", json=body,
                         timeout=TIMEOUT).json()["choices"][0]["text"]
    got = _both(pd, f"{pd.dead[0]},{pd.addr['p2']}", body)
    for r, cost, pulled in got:
        assert r.status_code == 200 and FALLBACK not in r.headers
        assert r.json()["choices"][0]["text"] == want
        assert cost["p2"] == 18 and cost["p1"] == 0 and pulled == 1


def test_every_prefiller_down_prefills_locally(pd):
    body = dict(GREEDY, prompt=list(range(60, 75)), max_tokens=4)
    want = requests.post(pd.served["c"].url + "/v1/completions", json=body,
                         timeout=TIMEOUT).json()["choices"][0]["text"]
    got = _both(pd, ",".join(pd.dead), body)
    for r, cost, pulled in got:
        assert r.status_code == 200
        assert r.headers[FALLBACK] == "local"
        assert r.json()["choices"][0]["text"] == want
        assert cost == {"p1": 0, "p2": 0, "c": 15} and pulled == 0


def test_a_prefillers_4xx_is_final(pd):
    """A request the prefiller refuses (a temperature that is not a
    number) is not retried on the next prefiller: the consumer answers
    it."""
    body = dict(GREEDY, prompt=[1, 2, 3], max_tokens=2, temperature="hot")
    got = _both(pd, f"{pd.addr['p1']},{pd.addr['p2']}", body)
    assert [r.status_code for r, _, _ in got][0] == \
        [r.status_code for r, _, _ in got][1]
    assert got[0][0].json() == got[1][0].json()
    for r, cost, pulled in got:
        assert r.status_code == 400 and cost["p2"] == 0


def _tls_files(tmp_path):
    """A CA's certificate and a server certificate for 127.0.0.1 that it
    signed, with the server's key (PEM files under ``tmp_path``)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    now = datetime.datetime.now(datetime.timezone.utc)

    def cert(subject, key, issuer, signer, ca, extra=()):
        b = (x509.CertificateBuilder()
             .subject_name(x509.Name([x509.NameAttribute(
                 NameOID.COMMON_NAME, subject)]))
             .issuer_name(x509.Name([x509.NameAttribute(
                 NameOID.COMMON_NAME, issuer)]))
             .public_key(key.public_key())
             .serial_number(x509.random_serial_number())
             .not_valid_before(now - datetime.timedelta(minutes=5))
             .not_valid_after(now + datetime.timedelta(days=1))
             .add_extension(x509.BasicConstraints(ca=ca, path_length=None),
                            critical=True)
             .add_extension(x509.KeyUsage(
                 digital_signature=not ca, key_cert_sign=ca, crl_sign=ca,
                 content_commitment=False, key_encipherment=False,
                 data_encipherment=False, key_agreement=False,
                 encipher_only=False, decipher_only=False), critical=True)
             .add_extension(x509.SubjectKeyIdentifier.from_public_key(
                 key.public_key()), critical=False)
             .add_extension(x509.AuthorityKeyIdentifier
                            .from_issuer_public_key(signer.public_key()),
                            critical=False))
        for ext in extra:
            b = b.add_extension(ext, critical=False)
        return b.sign(signer, hashes.SHA256())

    ca_key = ec.generate_private_key(ec.SECP256R1())
    key = ec.generate_private_key(ec.SECP256R1())
    ca = cert("test ca", ca_key, "test ca", ca_key, True)
    leaf = cert("127.0.0.1", key, "test ca", ca_key, False, (
        x509.SubjectAlternativeName([x509.IPAddress(
            ipaddress.ip_address("127.0.0.1"))]),
        x509.ExtendedKeyUsage([ExtendedKeyUsageOID.SERVER_AUTH])))
    files = {n: tmp_path / f"{n}.pem" for n in ("ca", "cert", "key")}
    files["ca"].write_bytes(ca.public_bytes(serialization.Encoding.PEM))
    files["cert"].write_bytes(leaf.public_bytes(serialization.Encoding.PEM))
    files["key"].write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return files


class _TlsFront:
    """TLS in front of a plain TCP port: each connection's bytes piped
    both ways, on its own loop in a daemon thread."""

    def __init__(self, target_port: int, files) -> None:
        ctx = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
        ctx.load_cert_chain(files["cert"], files["key"])
        self.loop = asyncio.new_event_loop()

        async def pipe(r, w):
            try:
                while data := await r.read(1 << 16):
                    w.write(data)
                    await w.drain()
            finally:
                w.close()

        async def handle(r, w):
            ur, uw = await asyncio.open_connection("127.0.0.1", target_port)
            await asyncio.gather(pipe(r, uw), pipe(ur, w),
                                 return_exceptions=True)

        self.server = self.loop.run_until_complete(asyncio.start_server(
            handle, "127.0.0.1", 0, ssl=ctx))
        self.port = self.server.sockets[0].getsockname()[1]
        threading.Thread(target=self.loop.run_forever, daemon=True).start()

    def close(self) -> None:
        async def stop():
            self.server.close()
        asyncio.run_coroutine_threadsafe(stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)


def test_a_prefiller_over_tls(pd, tmp_path, monkeypatch):
    """``prefiller_use_tls``: the hinted prefiller answers over TLS only.
    With its CA trusted (``SSL_CERT_FILE``) the prompt is prefilled there
    and decodes with the consumer's own tokens; with the CA not trusted
    the certificate check fails and the consumer prefills locally."""
    files = _tls_files(tmp_path)
    front = _TlsFront(int(pd.addr["p2"].rsplit(":", 1)[1]), files)
    side = tproxy.RoutingSidecar(pd.served["c"].url, prefiller_use_tls=True,
                                 prefill_retries=0)
    app = side.build_app()
    served = _Served(lambda: app.start("127.0.0.1", 0), app.close)
    try:
        p = list(range(80, 97))
        body = dict(GREEDY, prompt=p, max_tokens=4)
        want = requests.post(pd.served["c"].url + "/v1/completions",
                             json=body, timeout=TIMEOUT).json()
        for trusted in (True, False):
            if trusted:
                monkeypatch.setenv("SSL_CERT_FILE", str(files["ca"]))
            else:
                monkeypatch.delenv("SSL_CERT_FILE")
            before = {n: pd.prompt_tokens(n) for n in ("p2", "c")}
            t0 = pd.transfers()
            r = requests.post(served.url + "/v1/completions", json=body,
                              headers={HINT: f"127.0.0.1:{front.port}"},
                              timeout=TIMEOUT)
            cost = {n: pd.prompt_tokens(n) - before[n] for n in before}
            assert r.status_code == 200
            assert r.json()["choices"][0]["text"] == \
                want["choices"][0]["text"]
            if trusted:
                assert FALLBACK not in r.headers
                assert cost["p2"] == len(p) and pd.transfers() - t0 == 1
            else:
                assert r.headers[FALLBACK] == "local"
                assert cost == {"p2": 0, "c": len(p)}
    finally:
        served.close()
        front.close()


def test_passthrough_and_refusals_alike(pd):
    for method, path in (("GET", "/health"), ("GET", "/v1/models"),
                         ("GET", "/metrics"), ("GET", "/nope"),
                         ("POST", "/tokenize")):
        rs = [requests.request(method, s.url + path, timeout=TIMEOUT,
                               json={"prompt": "ab"} if method == "POST"
                               else None)
              for s in pd.sides]
        assert rs[1].status_code == rs[0].status_code, path
        if path in ("/health", "/v1/models", "/tokenize"):
            assert rs[1].status_code == 200
            if path != "/health":
                assert rs[1].json() == rs[0].json()
    got = []
    for s in pd.sides:
        r1 = requests.post(s.url + "/v1/completions", data=b"{x",
                           timeout=TIMEOUT)
        r2 = requests.post(s.url + "/v1/completions",
                           json=dict(GREEDY, prompt=[1], max_tokens=1),
                           headers={"x-llmd-deadline":
                                    f"{time.time() - 9:.6f}",
                                    "x-request-id": "late"},
                           timeout=TIMEOUT)
        got.append((r1.status_code, r1.json(), r2.status_code, r2.json(),
                    r2.headers.get("x-llmd-deadline-exceeded")))
    assert got[1] == got[0]
    assert got[0][0] == 400 and got[0][2] == 504


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _recipe():
    docs = [d for d in yaml.safe_load_all(
        (ROOT / "deploy/pd-disaggregation/pd.yaml").read_text()) if d]
    dep = next(d for d in docs if d.get("kind") == "Deployment"
               and d["metadata"]["name"] == "ms-pd-decode")
    c = next(c for c in dep["spec"]["template"]["spec"]["containers"]
             if c["name"] == "routing-proxy")
    return c["args"], {e["name"]: e["value"] for e in c["env"]}


@pytest.mark.parametrize("case", ["recipe", "tuned"])
def test_entry_point_flags_parse_as_jax(case, monkeypatch):
    args, env = _recipe()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = {"recipe": args,
            "tuned": ["--host", "127.0.0.1", "--port", "9", "--decode-url",
                      "http://d:1", "--prefiller-use-tls",
                      "--prefill-timeout", "3", "--prefill-retries", "4",
                      "--prefill-backoff", "0.5", "--connector", "nixlv2"]
            }[case]
    got = []
    for mod in (jproxy, tproxy):
        ns = vars(tproxy.build_arg_parser().parse_args(argv)) \
            if mod is tproxy else None
        seen = {}

        class Stop(Exception):
            pass

        def fake(*a, **kw):
            seen.update(args=a, kw=kw)
            raise Stop
        monkeypatch.setattr(mod, "RoutingSidecar", fake)
        with pytest.raises(Stop):
            mod.main(argv)
        got.append(seen)
        if ns is not None:
            assert ns["connector"] == argv[argv.index("--connector") + 1]
    assert got[1] == got[0]


def test_sidecar_knobs_from_the_recipe_environment(monkeypatch):
    _, env = _recipe()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("LLMD_PREFILL_TIMEOUT_S", "12")
    s = [cls("http://127.0.0.1:1", "p:1")
         for cls in (jproxy.RoutingSidecar, tproxy.RoutingSidecar)]
    keys = ("decode_url", "static_prefiller", "scheme", "prefill_timeout_s",
            "prefill_retries", "prefill_backoff_s")
    assert [getattr(s[1], k) for k in keys] == \
        [getattr(s[0], k) for k in keys]
    assert (s[1].prefill_retries, s[1].prefill_backoff_s) == (2, 0.25)


_ENTRY = """
import sys
for name in ("aiohttp", "prometheus_client", "requests", "jax", "grpc"):
    sys.modules[name] = None
from llm_d_tpu_torch.sidecar.proxy import main
main(sys.argv[1:])
"""


def test_the_entry_point_serves_the_recipe(pd):
    args, env = _recipe()
    port = _free_port()
    argv = [a for a in args]
    argv[argv.index("--port") + 1] = str(port)
    argv[argv.index("--decode-url") + 1] = pd.served["c"].url
    argv[argv.index("--prefiller") + 1] = pd.addr["p1"]
    proc = subprocess.Popen(
        [sys.executable, "-c", _ENTRY, *argv, "--host", "127.0.0.1"],
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
        body = dict(GREEDY, prompt=list(range(90, 101)), max_tokens=3)
        want = requests.post(pd.served["c"].url + "/v1/completions",
                             json=body, timeout=TIMEOUT).json()
        before = pd.prompt_tokens("p1")
        r = requests.post(url + "/v1/completions", json=body,
                          timeout=TIMEOUT)
        assert r.status_code == 200, r.text
        assert r.json()["choices"] == want["choices"]
        assert pd.prompt_tokens("p1") - before == 11
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
