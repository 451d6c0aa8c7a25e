"""Port parity: the port's OpenAI server (``llm_d_tpu_torch.server.openai``,
standard-library HTTP) against the JAX server (``llm_d_tpu.server.openai``,
aiohttp), both serving over real sockets on the CPU.

Each pair of servers runs the same model on the same weights (the JAX
engine's parameters carried across by ``params_from_numpy``): ``tiny``
(bf16 cache, one step per dispatch) and ``tiny-mla`` (int8 experts and
latent) in 4-step decode blocks with async scheduling.  Every request
goes to both servers in turn, one at a time, so both engines see the same
schedule; the comparisons are exact:

* greedy completions and chat text, token-id prompts, stop strings,
  ``max_tokens`` and usage token counts; streamed chunks (text deltas,
  finish reason, the ``llmd`` token meta) and the ``[DONE]`` end;
* request-id correlation, probe status codes, 504 + header for an expired
  deadline, 400 for a bad criticality, the drain protocol (503 + header
  on readiness and new inference, in-flight requests complete);
* ``/metrics``: the same ``vllm:*`` families, and equal counters and
  histogram counts after the same requests, read with the JAX package's
  ``parse_prometheus_text``; the unchanged EPP ``Datastore.scrape_once``
  reads the port server's load gauges;
* ``logprobs`` / ``top_logprobs`` on completions and chat, streamed and
  not: the same reply shape and tokens, logprob values at atol = rtol =
  2e-2 (the forwards differ by one bf16 ulp in a few hidden elements);
* ``--spec-k 4`` (``tiny`` with speculative decode, the drafter's weights
  carried across too): the JAX spec server's tokens, plain and with
  logprobs.

``--enable-eplb``, ``--eplb-config``, ``--kv-cache-hbm-gb`` and
``--spec-strict`` map to the JAX server's engine config; on ``tiny-mla``
the two servers answer alike and publish the same
``llmd_tpu:eplb_imbalance``.

Port-only checks: ``kv_transfer_params`` on a server without a KV
connector and unserved CLI flags (dynamic shared-tier peer specs among
them) are refused with a message naming them; a flag whose module is
missing (``yaml``, ``zmq``, ``msgpack``) is refused naming the module;
the observability flags parse as the JAX parser parses them; a ``resume``
body is served as the JAX server serves it; the P/D and tier flags map
to the engine config and the connector;
``--spec-k`` with ``--num-scheduler-steps`` > 1 parses;
and ``python -m llm_d_tpu_torch.server.openai`` serves with aiohttp,
prometheus_client and requests blocked, then drains and exits 0 on
SIGTERM.  Every HTTP call has its own timeout.
"""

import asyncio
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import requests

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.epp.datastore import Datastore, EndpointState
from llm_d_tpu.server import openai as JServer
from llm_d_tpu.server.openai import build_server as jbuild_server
from llm_d_tpu.utils.lifecycle import (
    CRITICALITY_HEADER, DEADLINE_ABS_HEADER, DEADLINE_EXCEEDED_HEADER,
    DRAINING_HEADER, REQUEST_ID_HEADER, SCHED_DEPTH_HEADER)
from llm_d_tpu.utils.metrics import parse_prometheus_text
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.server import openai as TServer

import torch

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 120          # seconds, per HTTP call (first calls compile in JAX)

MODES = {
    "tiny": dict(model="tiny", kv_cache_dtype="bf16"),
    "tiny-mla-k4": dict(model="tiny-mla", quantization="int8",
                        kv_cache_dtype="int8", num_scheduler_steps=4,
                        async_scheduling=True),
    "tiny-spec": dict(model="tiny", kv_cache_dtype="bf16", spec_k=4),
    "tiny-everything": dict(model="tiny", kv_cache_dtype="bf16", spec_k=4,
                            num_scheduler_steps=4, async_scheduling=True),
}


def _kw(mode):
    return dict(block_size=8, num_blocks=64, max_num_seqs=8,
                max_num_batched_tokens=64, min_token_bucket=16,
                min_seq_bucket=4, enable_prefix_caching=False,
                **MODES[mode])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_ready(url: str, path: str = "/v1/models") -> None:
    for _ in range(300):
        try:
            if requests.get(url + path, timeout=5).status_code == 200:
                return
        except requests.ConnectionError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"{url} never became ready")


class _Served:
    """One server on its own event loop in a daemon thread."""

    def __init__(self, start, stop, ready_path: str = "/v1/models") -> None:
        self.loop = asyncio.new_event_loop()
        self._stop = stop
        box = {}
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            box["port"] = self.loop.run_until_complete(start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(timeout=60)
        self.url = f"http://127.0.0.1:{box['port']}"
        _wait_ready(self.url, ready_path)

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self._stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _serve_jax(server, ready_path: str = "/v1/models") -> _Served:
    """An aiohttp application of the JAX package (``server.build_app()``)
    on its own loop, ready once ``ready_path`` answers 200."""
    from aiohttp import web
    runner = web.AppRunner(server.build_app())
    port = _free_port()

    async def start():
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        return port

    return _Served(start, runner.cleanup, ready_path)


def _serve_port(server) -> _Served:
    app = server.build_app()
    return _Served(lambda: app.start("127.0.0.1", 0), app.close)


class _Pair:
    def __init__(self, mode: str) -> None:
        kw = _kw(mode)
        jeng = JEngineCore(JEngineConfig(**kw))

        def tree(p):
            return params_from_numpy(jax.tree.map(np.asarray, p), "cpu")

        teng = EngineCore(EngineConfig(device="cpu", **kw),
                          params=tree(jeng.params),
                          draft_params=(tree(jeng.draft_params)
                                        if jeng.draft_params else None))
        self.jax_server = jbuild_server(None, engine=jeng, model_name="m")
        self.port_server = TServer.build_server(None, engine=teng,
                                                model_name="m")
        self.jax = _serve_jax(self.jax_server)
        self.port = _serve_port(self.port_server)

    def both(self, method, path, **kw):
        """The same call on the JAX server, then the port's."""
        kw.setdefault("timeout", TIMEOUT)
        return [requests.request(method, s.url + path, **kw)
                for s in (self.jax, self.port)]

    def close(self) -> None:
        self.port.close()
        self.jax.close()


@pytest.fixture(scope="module")
def tiny():
    pair = _Pair("tiny")
    yield pair
    pair.close()


@pytest.fixture(scope="module")
def tiny_mla_k4():
    pair = _Pair("tiny-mla-k4")
    yield pair
    pair.close()


@pytest.fixture(scope="module")
def tiny_spec():
    pair = _Pair("tiny-spec")
    yield pair
    pair.close()


def _strip(body):
    """A completion without the fields that differ by construction."""
    return {k: v for k, v in body.items() if k not in ("id", "created")} \
        | {"usage": {k: v for k, v in body["usage"].items()
                     if not k.endswith("_ms")}}


def _sse(resp):
    """A streamed reply's frames: JSON chunks, then "DONE"."""
    assert resp.status_code == 200
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    frames = []
    for line in resp.iter_lines():
        if line.startswith(b"data: "):
            data = line[len(b"data: "):]
            frames.append("DONE" if data == b"[DONE]" else json.loads(data))
    return frames


def _chunks(frames):
    """A stream's token chunks as (token ids, finish reason), its whole
    text, and the frames after the tokens (the usage frame, if any).
    Chunk texts are compared as a whole: the JAX server cuts each delta
    from the request's token list, which its engine thread may already
    have extended by the next output's tokens."""
    toks = [f for f in frames[:-1] if f["choices"]]
    ch = toks[0]["choices"][0]
    key = "delta" if "delta" in ch else "text"
    text = "".join(f["choices"][0][key]["content"] if key == "delta"
                   else f["choices"][0][key] for f in toks)
    return ([(f["llmd"]["tok"], f["choices"][0]["finish_reason"],
              f["object"], f["model"]) for f in toks], text,
            [{k: v for k, v in f.items() if k not in ("id", "created")}
             for f in frames[:-1] if not f["choices"]])


GREEDY = dict(temperature=0.0, ignore_eos=True)


@pytest.mark.parametrize("prompt", ["hello world", [5, 17, 300, 42, 7, 9]])
def test_greedy_completion_equals_the_jax_server(tiny, prompt):
    j, t = tiny.both("POST", "/v1/completions", json=dict(
        GREEDY, model="m", prompt=prompt, max_tokens=7))
    assert j.status_code == t.status_code == 200
    assert _strip(t.json()) == _strip(j.json())
    assert t.json()["usage"]["completion_tokens"] == 7
    assert t.json()["choices"][0]["finish_reason"] == "length"
    assert t.headers[SCHED_DEPTH_HEADER] == "0"


def test_chat_completion_equals_the_jax_server(tiny):
    j, t = tiny.both("POST", "/v1/chat/completions", json=dict(
        GREEDY, model="m", max_tokens=5,
        messages=[{"role": "user", "content": "hi there"}]))
    assert j.status_code == t.status_code == 200
    assert _strip(t.json()) == _strip(j.json())
    assert t.json()["object"] == "chat.completion"


@pytest.mark.parametrize("chat", [False, True])
def test_streamed_chunks_equal_the_jax_server(tiny, chat):
    body = dict(GREEDY, model="m", max_tokens=6, stream=True,
                stream_options={"include_usage": True})
    if chat:
        path = "/v1/chat/completions"
        body["messages"] = [{"role": "user", "content": "stream"}]
    else:
        path, body["prompt"] = "/v1/completions", "stream me"
    j, t = (_sse(r) for r in tiny.both("POST", path, json=body, stream=True))
    assert j[-1] == t[-1] == "DONE"
    usage = [f.pop("usage") for f in (j[-2], t[-2])]
    assert [{k: v for k, v in u.items() if not k.endswith("_ms")}
            for u in usage] == [{"prompt_tokens": usage[0]["prompt_tokens"],
                                 "completion_tokens": 6,
                                 "total_tokens": usage[0]["total_tokens"]}] * 2
    assert _chunks(t) == _chunks(j)
    text = _chunks(t)[1]
    assert t[-3]["choices"][0]["finish_reason"] == "length"
    body.pop("stream")
    for whole in tiny.both("POST", path, json=body):
        choice = whole.json()["choices"][0]
        assert text == (choice["message"]["content"] if chat
                        else choice["text"])


def test_stop_strings_and_max_tokens_equal_the_jax_server(tiny):
    body = dict(GREEDY, model="m", prompt=[3, 99, 104, 105], max_tokens=12)
    j, t = tiny.both("POST", "/v1/completions", json=body)
    text = j.json()["choices"][0]["text"]
    assert t.json()["choices"][0]["text"] == text
    stop = next((text[i:i + 2] for i in range(2, len(text) - 1)
                 if text[i:i + 2].isprintable()), None)
    assert stop, text
    for stream in (False, True):
        body2 = dict(body, stop=[stop], stream=stream)
        j, t = tiny.both("POST", "/v1/completions", json=body2,
                         stream=stream)
        if stream:
            jf, tf = _sse(j), _sse(t)
            (jt, jtext, jrest), (tt, ttext, trest) = _chunks(jf), _chunks(tf)
            assert (ttext, trest) == (jtext, jrest)
            if jt != tt:
                # The JAX server decodes each chunk from the request's
                # token list, which its engine thread may already have
                # extended by the next output: it then sees the stop
                # string early and ends its stream on that output's frame.  The port decodes from the stream's own
                # ids, so its stream is always the one without that
                # look-ahead: the JAX frames are the port's up to the one
                # where the JAX stream saw the stop early.
                n = len(jt)
                assert n < len(tt) and jt[:-1] == tt[:n - 1]
                assert jt[-1][0] == tt[n - 1][0]
                assert jt[-1][1] == tt[-1][1] == "stop"
            assert tf[-2]["choices"][0]["finish_reason"] == "stop"
        else:
            assert _strip(t.json()) == _strip(j.json())
            assert t.json()["choices"][0]["finish_reason"] == "stop"
            assert stop not in t.json()["choices"][0]["text"]


def test_request_id_comes_back_as_the_id(tiny):
    body = dict(GREEDY, model="m", prompt="id", max_tokens=2)
    for r in tiny.both("POST", "/v1/completions",
                       json=dict(body, request_id="body-rid-1")):
        assert r.json()["id"] == "body-rid-1"
    for r in tiny.both("POST", "/v1/completions", json=body,
                       headers={REQUEST_ID_HEADER: "hdr-rid-2"}):
        assert r.json()["id"] == "hdr-rid-2"
    for r in tiny.both("POST", "/v1/completions",
                       json=dict(body, stream=True, request_id="sse-rid-3"),
                       stream=True):
        assert {f["id"] for f in _sse(r)[:-1]} == {"sse-rid-3"}


@pytest.mark.parametrize("method,path", [
    ("GET", "/health"), ("GET", "/v1/models"), ("GET", "/version"),
    ("GET", "/metrics"), ("GET", "/nowhere"), ("POST", "/health"),
    ("GET", "/v1/completions")])
def test_probe_status_codes_equal_the_jax_server(tiny, method, path):
    j, t = tiny.both(method, path)
    assert t.status_code == j.status_code
    if path == "/v1/models":
        assert t.json()["data"][0]["id"] == j.json()["data"][0]["id"] == "m"


def test_bad_requests_equal_the_jax_server(tiny):
    j, t = tiny.both("POST", "/v1/completions", data=b"{not json",
                     headers={"Content-Type": "application/json"})
    assert j.status_code == t.status_code == 400
    assert t.json() == j.json()
    j, t = tiny.both("POST", "/v1/completions",
                     json={"prompt": "x", "max_tokens": 1},
                     headers={CRITICALITY_HEADER: "mega"})
    assert j.status_code == t.status_code == 400


def test_expired_deadline_is_504_with_its_header(tiny):
    for r in tiny.both("POST", "/v1/completions",
                       json={"prompt": "late", "max_tokens": 2},
                       headers={DEADLINE_ABS_HEADER: str(time.time() - 5)}):
        assert r.status_code == 504
        assert r.headers.get(DEADLINE_EXCEEDED_HEADER) == "1"
        assert r.json()["error"] == "deadline exceeded"


def _families(text):
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE") and ln.split()[2].startswith("vllm:")}


def _counts(text, names=()):
    """Counters and histogram counts of the ``vllm:*`` families (plus
    ``names``), by sample key."""
    m = parse_prometheus_text(text)
    return {k: v for k, v in m.items() if "{" in k and (
        k.startswith("vllm:") and (k.split("{")[0].endswith(
            ("_total", "_count")))
        or k.split("{")[0] in names)}


def _metrics(pair):
    return [r.text for r in pair.both("GET", "/metrics")]


def test_metrics_equal_the_jax_server(tiny):
    """The ``vllm:*`` counters and histogram counts, and the engine's
    phase histogram (one queue, prefill and decode sample per request and
    criticality), equal the JAX server's."""
    tiny.both("POST", "/v1/completions", json=dict(
        GREEDY, model="m", prompt=[1, 2, 3], max_tokens=4))
    j, t = _metrics(tiny)
    assert _families(t) == _families(j)
    assert "vllm:generation_tokens_total" in _families(t)
    names = ("llmd_tpu:request_phase_seconds_count",)
    jc, tc = _counts(j, names), _counts(t, names)
    assert tc == jc
    for phase in ("queue", "prefill", "decode"):
        assert sum(v for k, v in tc.items() if k.startswith(names[0])
                   and f'phase="{phase}"' in k) >= 1, phase
    assert tc['vllm:generation_tokens_total{model_name="tiny"}'] >= 4
    assert tc['vllm:time_to_first_token_seconds_count{model_name="tiny"}'] >= 1
    assert tc['vllm:inter_token_latency_seconds_count{model_name="tiny"}'] >= 3


def test_epp_datastore_scrapes_the_port_server(tiny):
    """The unchanged EPP scrape reads the port server's load gauges (set
    here on the idle engine, which updates them only when it steps)."""
    eng = tiny.port_server.engine
    assert not eng.has_work()
    m = eng.metrics
    m.num_requests_waiting.set(3)
    m.num_requests_running.set(5)
    m.kv_cache_usage_perc.set(0.25)
    addr = tiny.port.url.split("//", 1)[1]

    async def scrape():
        ds = Datastore([EndpointState(address=addr)], scrape_interval_s=60)
        await ds.start()
        try:
            await ds.scrape_once()
        finally:
            await ds.stop()
        return ds.endpoints[addr]

    try:
        e = asyncio.run(scrape())
    finally:
        eng._update_queue_metrics()
    assert e.ready and e.scrape_error is None
    assert (e.num_waiting, e.num_running, e.kv_usage) == (3.0, 5.0, 0.25)
    assert e.draining is False


@pytest.mark.parametrize("prompt", [[11, 12, 13, 14, 15], "multistep",
                                    [7, 8, 9]])
def test_multistep_async_greedy_equals_the_jax_server(tiny_mla_k4, prompt):
    pair = tiny_mla_k4
    body = dict(GREEDY, model="m", prompt=prompt, max_tokens=10)
    j, t = pair.both("POST", "/v1/completions", json=body)
    assert j.status_code == t.status_code == 200
    assert _strip(t.json()) == _strip(j.json())
    j, t = (_sse(r) for r in pair.both(
        "POST", "/v1/completions", json=dict(body, stream=True),
        stream=True))
    assert _chunks(t) == _chunks(j)
    # One prefill token, then 4-token blocks (the last one cut at 10).
    assert [len(f["llmd"]["tok"]) for f in t[:-1]] == [1, 4, 4, 1]
    names = ("llmd_tpu:engine_steps_total", "llmd_tpu:engine_dispatch_total")
    jm, tm = _metrics(pair)
    assert _counts(tm, names) == _counts(jm, names)


def _logprobs(reply, chat):
    """A reply's logprobs field as (token strings, values, top lists of
    (token, value)), plus the completions schema's text offsets."""
    lp = reply.json()["choices"][0]["logprobs"]
    if chat:
        items = lp["content"]
        return ([x["token"] for x in items], [x["logprob"] for x in items],
                [[(t["token"], t["logprob"]) for t in x["top_logprobs"]]
                 for x in items], None)
    tops = [list(t.items()) for t in lp["top_logprobs"] or []]
    return lp["tokens"], lp["token_logprobs"], tops, lp["text_offset"]


def _same_logprobs(t, j, chat):
    """Equal tokens and offsets, values at atol = rtol = 2e-2."""
    tt, tv, ttop, toff = _logprobs(t, chat)
    jt, jv, jtop, joff = _logprobs(j, chat)
    assert tt == jt and toff == joff
    np.testing.assert_allclose(tv, jv, atol=2e-2, rtol=2e-2)
    assert [[tok for tok, _ in row] for row in ttop] == \
        [[tok for tok, _ in row] for row in jtop]
    for trow, jrow in zip(ttop, jtop):
        np.testing.assert_allclose([v for _, v in trow], [v for _, v in jrow],
                                   atol=2e-2, rtol=2e-2)
    assert all(v <= 0 for v in tv)
    return tt, tv, ttop


def _logprobs_body(chat, stream, top):
    body = dict(GREEDY, model="m", max_tokens=6, stream=stream)
    if chat:
        body.update(messages=[{"role": "user", "content": "probe"}],
                    logprobs=True)
        if top is not None:
            body["top_logprobs"] = top
        return "/v1/chat/completions", body
    body.update(prompt=[9, 41, 7, 300], logprobs=top or 0)
    return "/v1/completions", body


@pytest.mark.parametrize("chat,top", [(False, 3), (False, 0), (True, 2),
                                      (True, None)])
def test_logprobs_equal_the_jax_server(tiny, chat, top):
    """Completions ``logprobs=N`` and chat ``logprobs=true`` (with and
    without ``top_logprobs``): the reply equals the JAX server's but for
    the logprob values, which match at 2e-2; in chat the greedy token
    heads its sorted top list."""
    path, body = _logprobs_body(chat, False, top)
    j, t = tiny.both("POST", path, json=body)
    assert j.status_code == t.status_code == 200
    strip = [_strip(r.json()) for r in (t, j)]
    for s in strip:
        s["choices"][0].pop("logprobs")
    assert strip[0] == strip[1]
    toks, _, tops = _same_logprobs(t, j, chat)
    assert len(toks) == 6
    if not top:
        assert all(row == [] for row in tops)
    elif chat:
        # (The completions schema keys alternatives by their text, which
        # the byte tokenizer repeats across ids.)
        assert all(len(row) == top and row[0][0] == tok
                   and [v for _, v in row] == sorted(
                       (v for _, v in row), reverse=True)
                   for row, tok in zip(tops, toks))


@pytest.mark.parametrize("chat", [False, True])
def test_streamed_logprobs_requests_equal_the_jax_server(tiny, chat):
    """A streamed request asking for logprobs is served: the chunks equal
    the JAX server's (which carry no logprobs) and end in [DONE]."""
    path, body = _logprobs_body(chat, True, 2)
    j, t = (_sse(r) for r in tiny.both("POST", path, json=body, stream=True))
    assert j[-1] == t[-1] == "DONE"
    assert _chunks(t) == _chunks(j)
    assert sum(len(c[0]) for c in _chunks(t)[0]) == 6


@pytest.mark.parametrize("prompt", [[11, 12, 13, 14, 15], "spec decode"])
def test_spec_server_equals_the_jax_spec_server(tiny_spec, prompt):
    """``--spec-k 4``: completions (whole and streamed) and a logprobs
    request give the JAX spec server's tokens; both engines drafted."""
    body = dict(GREEDY, model="m", prompt=prompt, max_tokens=12)
    j, t = tiny_spec.both("POST", "/v1/completions", json=body)
    assert j.status_code == t.status_code == 200
    assert _strip(t.json()) == _strip(j.json())
    j, t = (_sse(r) for r in tiny_spec.both(
        "POST", "/v1/completions", json=dict(body, stream=True),
        stream=True))
    assert _chunks(t) == _chunks(j)
    j, t = tiny_spec.both("POST", "/v1/completions",
                          json=dict(body, logprobs=2))
    assert _same_logprobs(t, j, False)[0] == _logprobs(j, False)[0]
    names = ("llmd_tpu:spec_draft_tokens_total",
             "llmd_tpu:engine_steps_total")
    jm, tm = _metrics(tiny_spec)
    assert _counts(tm, names) == _counts(jm, names)
    assert _counts(tm, names)[
        'llmd_tpu:spec_draft_tokens_total{model_name="tiny"}'] > 0
    assert tiny_spec.port_server.engine.spec_k == 4


def test_everything_on_server_equals_the_jax_server():
    """``--spec-k 4 --num-scheduler-steps 4 --async-scheduling`` (the
    fused multistep pipeline): a greedy completion and a streamed one
    give the JAX server's tokens, both engines drafted, and the engine
    steps outnumber the dispatches on both."""
    pair = _Pair("tiny-everything")
    try:
        body = dict(GREEDY, model="m", prompt=[11, 12, 13, 14, 15],
                    max_tokens=12)
        j, t = pair.both("POST", "/v1/completions", json=body)
        assert j.status_code == t.status_code == 200
        assert _strip(t.json()) == _strip(j.json())
        j, t = (_sse(r) for r in pair.both(
            "POST", "/v1/completions", json=dict(body, stream=True),
            stream=True))
        (tc, tt, _), (jc, jt, _) = _chunks(t), _chunks(j)
        assert [x for c in tc for x in c[0]] == [x for c in jc for x in c[0]]
        assert tt == jt
        names = ("llmd_tpu:spec_draft_tokens_total",
                 "llmd_tpu:engine_steps_total",
                 "llmd_tpu:engine_dispatch_total")
        jm, tm = _metrics(pair)
        assert _counts(tm, names) == _counts(jm, names)
        eng = pair.port_server.engine
        assert eng.spec_k == 4 and eng._step_count > eng._dispatch_count
    finally:
        pair.close()


def test_eplb_and_pool_budget_server_equals_the_jax_server():
    """``--enable-eplb --eplb-config ... --kv-cache-hbm-gb ...
    --spec-strict`` through both servers' parsers: the engine configs
    agree, the engines derive the same block pool from the budget, and
    after the same greedy requests (``tiny-mla``, int8 experts and
    latent) the replies and ``llmd_tpu:eplb_imbalance`` on ``/metrics``
    are equal, with the routed ids recorded."""
    argv = ["--model", "tiny-mla", "--quantization", "int8",
            "--kv-cache-dtype", "int8", "--block-size", "8",
            "--max-num-batched-tokens", "64", "--enable-eplb",
            "--eplb-config", json.dumps({"window_size": 100,
                                         "step_interval": 4}),
            "--kv-cache-hbm-gb", "0.0005", "--spec-strict"]
    p = TServer.build_arg_parser()
    args = p.parse_args(argv + ["--device", "cpu"])
    TServer.check_served(p, args)
    tcfg = TServer.engine_config_from_args(args)
    jcfg = JServer.engine_config_from_args(
        JServer.build_arg_parser().parse_args(argv))
    names = ("enable_eplb", "eplb_config", "kv_cache_hbm_bytes",
             "spec_strict", "num_blocks")
    assert [getattr(tcfg, n) for n in names] == \
        [getattr(jcfg, n) for n in names]
    jeng = JEngineCore(jcfg)
    tree = jax.tree.map(np.asarray, jeng.params)
    tree["moe_layers"] = {k: v for k, v in tree["moe_layers"].items()
                          if k not in ("replica_table", "num_replicas")}
    teng = EngineCore(tcfg, params=params_from_numpy(tree, "cpu"))
    assert teng.config.num_blocks == jeng.config.num_blocks != 2048
    assert teng.spec_strict and jeng.spec_strict
    jax_srv = _serve_jax(jbuild_server(None, engine=jeng, model_name="m"))
    port_srv = _serve_port(TServer.build_server(None, engine=teng,
                                                model_name="m"))
    try:
        for prompt in ([5, 17, 300, 42, 7, 9], [1, 2, 3], "hello eplb"):
            j, t = (requests.post(s.url + "/v1/completions", json=dict(
                GREEDY, model="m", prompt=prompt, max_tokens=9),
                timeout=TIMEOUT) for s in (jax_srv, port_srv))
            assert j.status_code == t.status_code == 200
            assert _strip(t.json()) == _strip(j.json())
        gauge = 'llmd_tpu:eplb_imbalance{model_name="tiny-mla"}'
        jm, tm = (parse_prometheus_text(requests.get(
            s.url + "/metrics", timeout=TIMEOUT).text)
            for s in (jax_srv, port_srv))
        assert tm[gauge] == jm[gauge] > 1.0
        migrations = 'llmd_tpu:eplb_migrations_total{model_name="tiny-mla"}'
        assert tm[migrations] == jm[migrations] == 0
        assert teng.eplb.tracker.load.sum() == jeng.eplb.tracker.load.sum() > 0
    finally:
        port_srv.close()
        jax_srv.close()


@pytest.mark.parametrize("body,names", [
    (dict(kv_transfer_params={"do_remote_decode": True}),
     "kv_transfer_params")])
def test_unported_features_are_refused_by_name(tiny, body, names):
    r = requests.post(tiny.port.url + "/v1/completions", json=dict(
        GREEDY, prompt="x", max_tokens=2, **body), timeout=TIMEOUT)
    assert r.status_code == 501
    assert names in r.json()["error"]


def test_a_resume_body_is_served_as_the_jax_server_serves_it(tiny):
    """Mid-stream resume is served, not refused: the journal's tokens
    come back as the start of the completion, the usage counts them, and
    an offset header that disagrees with the journal is a 400."""
    base = dict(GREEDY, model="m", prompt=[7, 8, 9], max_tokens=6)
    j, t = tiny.both("POST", "/v1/completions", json=base)
    assert _strip(t.json()) == _strip(j.json())
    r = requests.post(tiny.port.url + "/v1/completions",
                      json=dict(base, stream=True), stream=True,
                      timeout=TIMEOUT)
    journal = [tok for f in _sse(r)[:-1] for tok in f["llmd"]["tok"]]
    body = dict(base, resume={"offset": 2, "token_ids": journal[:2]})
    j, t = tiny.both("POST", "/v1/completions", json=body,
                     headers={"x-llmd-resume-offset": "2"})
    assert t.status_code == j.status_code == 200
    assert _strip(t.json()) == _strip(j.json())
    assert t.json()["usage"]["completion_tokens"] == 6
    j, t = tiny.both("POST", "/v1/completions", json=body,
                     headers={"x-llmd-resume-offset": "3"})
    assert t.status_code == j.status_code == 400


@pytest.mark.parametrize("prompt", [[1, 2, 10 ** 6], [3, -1], [4, 2.5]])
def test_out_of_vocabulary_prompt_ids_are_refused(tiny, prompt):
    """A token id outside the embedding table is a 400, not a device
    fault that would kill the engine thread (the JAX engine clamps)."""
    r = requests.post(tiny.port.url + "/v1/completions", json=dict(
        GREEDY, prompt=prompt, max_tokens=2), timeout=TIMEOUT)
    assert r.status_code == 400
    assert "token ids" in r.json()["error"]
    assert requests.get(tiny.port.url + "/health",
                        timeout=TIMEOUT).status_code == 200


@pytest.mark.parametrize("journal", [[5, 10 ** 6], [-1], [4, 2.5]])
@pytest.mark.parametrize("stream", [False, True])
def test_out_of_vocabulary_resume_ids_are_refused(tiny, journal, stream):
    """A resume journal is prefilled with the prompt, so its ids are held
    to the prompt's check: a 400, and the engine serves on."""
    r = requests.post(tiny.port.url + "/v1/completions", json=dict(
        GREEDY, prompt=[7, 8, 9], max_tokens=4, stream=stream,
        resume={"offset": len(journal), "token_ids": journal}),
        headers={"x-llmd-resume-offset": str(len(journal))},
        timeout=TIMEOUT)
    assert r.status_code == 400
    assert "token ids" in r.json()["error"]
    r = requests.post(tiny.port.url + "/v1/completions", json=dict(
        GREEDY, prompt=[7, 8, 9], max_tokens=2), timeout=TIMEOUT)
    assert r.status_code == 200
    assert r.json()["usage"]["completion_tokens"] == 2


# The multi-host flags in spmd mode: refused, the message naming each as
# ranks mode's, where they are served.
SPMD_ACROSS_HOSTS = ["--data-parallel-size", "2",
                     "--data-parallel-size-local", "1"]


# (flag1, a dns: shared-tier peer, is served since: tests/test_torch_discovery.py.)
@pytest.mark.parametrize("flag", [
    pytest.param(["--data-parallel-start-rank", "2"] + SPMD_ACROSS_HOSTS,
                 id="flag0"),
    pytest.param(["--data-parallel-rpc-port", "8"] + SPMD_ACROSS_HOSTS,
                 id="flag2"),
    pytest.param(["--data-parallel-hybrid-lb"] + SPMD_ACROSS_HOSTS,
                 id="flag3"),
    pytest.param(["--compilation-cache-dir", "/tmp/x"], id="flag4")])
def test_an_unserved_cli_flag_is_a_parser_error(flag, capsys):
    p = TServer.build_arg_parser()
    args = p.parse_args(["--model", "tiny"] + flag)
    with pytest.raises(SystemExit) as e:
        TServer.check_served(p, args)
        TServer.check_mesh_flags(p, args)
    assert e.value.code == 2
    assert flag[0] in capsys.readouterr().err


MULTI_HOST_DESTS = sorted(f[2:].replace("-", "_")
                          for f in TServer.MULTI_HOST_FLAGS)


@pytest.mark.parametrize("dest", sorted(TServer.UNSERVED_FLAGS)
                         + MULTI_HOST_DESTS)
def test_every_unserved_flag_is_still_refused(dest, capsys):
    """Each entry of ``UNSERVED_FLAGS`` (the P/D and tier flags are no
    longer among them) set to a value other than its default is a parser
    error naming the flag; so is each multi-host flag (served in ranks
    mode since the leader's dispatch was ported) with one mesh across
    hosts."""
    p = TServer.build_arg_parser()
    action = next(a for a in p._actions if a.dest == dest)
    flag = action.option_strings[0]
    if action.nargs == 0:
        argv = [flag]
    elif action.type is int:
        argv = [flag, "2"]
    elif action.type is float:
        argv = [flag, "2.5"]
    elif action.choices:
        argv = [flag, next(c for c in action.choices
                           if c != action.default)]
    else:
        argv = [flag, "x"]
    if dest in MULTI_HOST_DESTS:
        argv += SPMD_ACROSS_HOSTS
    args = p.parse_args(argv)
    with pytest.raises(SystemExit) as e:
        TServer.check_served(p, args)
        TServer.check_mesh_flags(p, args)
    assert e.value.code == 2
    assert flag in capsys.readouterr().err


@pytest.mark.parametrize("flag,module", [
    (["--kv-events-endpoint", "tcp://x:1"], "zmq"),
    (["--kv-events-endpoint", "tcp://x:1"], "msgpack"),
    (["--config", "layers.yaml"], "yaml"),
    (["--config-overlay", "h100.yaml"], "yaml")])
def test_a_flag_whose_module_is_missing_is_refused_by_name(
        flag, module, monkeypatch, capsys):
    """Where ``zmq``, ``msgpack`` or ``yaml`` cannot be imported, the flag
    that needs it is a parser error naming the flag and the module."""
    monkeypatch.setitem(sys.modules, module, None)
    p = TServer.build_arg_parser()
    with pytest.raises(SystemExit) as e:
        TServer.check_served(p, p.parse_args(["--model", "tiny"] + flag))
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag[0] in err and module in err


@pytest.mark.parametrize("argv", [
    ["--config", "base.yaml"], ["--config-overlay", "h100.yaml"],
    ["--latency-training-url", "http://trainer:8000/"],
    ["--kv-events-endpoint", "tcp://epp:5557"],
    ["--pod-identity", "10.0.0.3:8200"]], ids=lambda a: a[0])
def test_an_observability_flag_is_served(argv, capsys):
    """``--config``, ``--config-overlay``, ``--latency-training-url``,
    ``--kv-events-endpoint`` and ``--pod-identity`` pass ``check_served``
    (their modules import here) and parse into what the JAX server's
    parser builds."""
    p = TServer.build_arg_parser()
    args = p.parse_args(["--model", "tiny"] + argv)
    TServer.check_served(p, args)
    assert capsys.readouterr().err == ""
    jargs = JServer.build_arg_parser().parse_args(["--model", "tiny"] + argv)
    dest = argv[0][2:].replace("-", "_")
    assert getattr(args, dest) == getattr(jargs, dest)
    assert getattr(args, dest) != p.get_default(dest)


@pytest.mark.parametrize("argv", [
    ["--data-parallel-size", "2"],
    ["--data-parallel-size", "2", "--data-parallel-size-local", "2"],
    ["--data-parallel-size", "2", "--data-parallel-mode", "ranks"]],
    ids=lambda a: a[-2])
def test_a_data_parallel_flag_is_served(argv, capsys):
    """``--data-parallel-size``, ``--data-parallel-size-local`` (equal to
    the size: one host) and ``--data-parallel-mode`` pass ``check_served``
    and ``check_mesh_flags`` and parse into what the JAX server's parser
    builds."""
    p = TServer.build_arg_parser()
    args = p.parse_args(["--model", "tiny"] + argv)
    TServer.check_served(p, args)
    TServer.check_mesh_flags(p, args)
    assert capsys.readouterr().err == ""
    jargs = JServer.build_arg_parser().parse_args(["--model", "tiny"] + argv)
    dest = argv[-2][2:].replace("-", "_")
    assert getattr(args, dest) == getattr(jargs, dest)
    assert getattr(args, dest) != p.get_default(dest)


def test_pd_and_tier_flags_are_served(capsys):
    """``--kv-transfer-config``, ``--kv-offload-blocks``,
    ``--kv-shared-tier-port`` and static ``--kv-shared-tier-peers`` parse
    into the EngineConfig the JAX server's parser builds and the
    connector its JSON names; a shared tier without the host tier is a
    parser error, as in the JAX server."""
    argv = ["--model", "tiny", "--kv-offload-blocks", "64",
            "--kv-shared-tier-port", "0", "--kv-shared-tier-peers",
            "10.0.0.9:5999, 1.2.3.4:1", "--kv-transfer-config",
            json.dumps({"kv_role": "kv_consumer", "kv_ip": "10.0.0.1",
                        "kv_load_failure_policy": "recompute"})]
    p = TServer.build_arg_parser()
    args = p.parse_args(argv)
    TServer.check_served(p, args)
    assert capsys.readouterr().err == ""
    cfg = TServer.engine_config_from_args(args)
    jcfg = JServer.engine_config_from_args(
        JServer.build_arg_parser().parse_args(argv))
    names = ("kv_offload_blocks", "kv_shared_tier_port",
             "kv_shared_tier_peers")
    assert [getattr(cfg, n) for n in names] == \
        [getattr(jcfg, n) for n in names] == \
        [64, 0, ("10.0.0.9:5999", "1.2.3.4:1")]
    conn = TServer.kv_connector_from_args(args)
    try:
        assert (conn.config.kv_role, conn.host, conn.port,
                conn.config.kv_load_failure_policy) == (
            "kv_consumer", "10.0.0.1", 0, "recompute")
        assert conn.server is None
    finally:
        conn.close()
    assert TServer.kv_connector_from_args(p.parse_args([])) is None
    with pytest.raises(SystemExit):
        TServer.check_served(p, p.parse_args(["--kv-shared-tier-port", "0"]))
    assert "--kv-offload-blocks > 0" in capsys.readouterr().err


def test_spec_k_with_multistep_is_a_parser_error(capsys):
    """No longer an error: the port serves the fused multistep pipeline,
    so ``--spec-k 4 --num-scheduler-steps 4 --async-scheduling`` parses
    into that EngineConfig, as the JAX server's parser maps it."""
    p = TServer.build_arg_parser()
    argv = ["--model", "tiny", "--spec-k", "4", "--num-scheduler-steps",
            "4", "--async-scheduling"]
    args = p.parse_args(argv)
    TServer.check_served(p, args)
    assert capsys.readouterr().err == ""
    cfg = TServer.engine_config_from_args(args)
    assert (cfg.spec_k, cfg.num_scheduler_steps, cfg.async_scheduling) == \
        (4, 4, True)
    jcfg = JServer.engine_config_from_args(
        JServer.build_arg_parser().parse_args(argv))
    assert (jcfg.spec_k, jcfg.num_scheduler_steps, jcfg.async_scheduling) \
        == (cfg.spec_k, cfg.num_scheduler_steps, cfg.async_scheduling)
    args = p.parse_args(["--spec-k", "4", "--spec-strict"])
    TServer.check_served(p, args)
    assert TServer.engine_config_from_args(args).spec_k == 4
    assert TServer.engine_config_from_args(p.parse_args([])).spec_k is None


def test_served_cli_flags_map_to_the_engine_config():
    p = TServer.build_arg_parser()
    args = p.parse_args(
        "--model deepseek-v3-bench --quantization int8 --kv-cache-dtype "
        "int8 --block-size 64 --num-blocks 576 --max-num-seqs 128 "
        "--max-num-batched-tokens 8192 --num-scheduler-steps 32 "
        "--async-scheduling --data-parallel-mode spmd".split())
    TServer.check_served(p, args)
    cfg = TServer.engine_config_from_args(args)
    assert (cfg.model, cfg.quantization, cfg.kv_cache_dtype, cfg.block_size,
            cfg.num_blocks, cfg.max_num_seqs, cfg.max_num_batched_tokens,
            cfg.num_scheduler_steps, cfg.async_scheduling, cfg.device) == (
        "deepseek-v3-bench", "int8", "int8", 64, 576, 128, 8192, 32, True,
        None)


_ENTRY = """
import sys
for name in ("aiohttp", "prometheus_client", "requests", "jax"):
    sys.modules[name] = None
from llm_d_tpu_torch.server.openai import main
main(sys.argv[1:])
"""


def test_entry_point_serves_without_aiohttp_and_exits_0_on_sigterm():
    """``main`` with aiohttp, prometheus_client, requests and jax blocked
    in ``sys.modules``: serves ``tiny`` on the CPU, drains on SIGTERM
    (readiness 503 while an in-flight stream completes) and exits 0.

    The server process runs one intra-op thread: with PyTorch's default
    (a thread per core) its spinning worker threads compete with the
    test run's other workers for the cores, and a 40-token ``tiny``
    stream then outlasted the 20 s drain bound."""
    port = _free_port()
    env = dict(os.environ, LLMD_DRAIN_TIMEOUT_S="20",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", _ENTRY, "--model", "tiny", "--device", "cpu",
         "--port", str(port), "--host", "127.0.0.1", "--block-size", "8",
         "--num-blocks", "64", "--max-num-batched-tokens", "64"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=str(ROOT))
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(600):
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                if requests.get(url + "/v1/models",
                                timeout=5).status_code == 200:
                    break
            except requests.ConnectionError:
                time.sleep(0.1)
        r = requests.post(url + "/v1/completions", json=dict(
            GREEDY, prompt=[1, 2, 3], max_tokens=3), timeout=TIMEOUT)
        assert r.json()["usage"]["completion_tokens"] == 3
        stream = requests.post(url + "/v1/completions", json=dict(
            GREEDY, prompt="drain", max_tokens=40, stream=True),
            stream=True, timeout=TIMEOUT)
        lines = stream.iter_lines()
        first = next(ln for ln in lines if ln.startswith(b"data: "))
        proc.send_signal(signal.SIGTERM)
        rest = [ln for ln in lines if ln.startswith(b"data: ")]
        assert rest[-1] == b"data: [DONE]"
        assert len([first] + rest) == 41
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def test_drain_protocol_equals_the_jax_server(tiny):
    """Runs last against the module's pair (a drain is one-way): an
    in-flight streamed request completes while readiness and new
    inference get 503 with the draining header, on both servers."""
    body = dict(GREEDY, model="m", prompt="in flight", max_tokens=24,
                stream=True)
    streams = [requests.post(s.url + "/v1/completions", json=body,
                             stream=True, timeout=TIMEOUT)
               for s in (tiny.jax, tiny.port)]
    lines = [s.iter_lines() for s in streams]
    for it in lines:                  # both requests are running
        next(ln for ln in it if ln.startswith(b"data: "))
    for r in tiny.both("POST", "/admin/drain"):
        assert r.status_code == 200 and r.json()["status"] == "draining"
    for r in tiny.both("GET", "/v1/models"):
        assert r.status_code == 503
        assert r.headers.get(DRAINING_HEADER) == "1"
    for r in tiny.both("POST", "/v1/completions",
                       json={"prompt": "new", "max_tokens": 1}):
        assert r.status_code == 503
        assert r.headers.get(DRAINING_HEADER) == "1"
    for r in tiny.both("GET", "/health"):
        assert r.status_code == 200
    for it in lines:                  # the in-flight requests complete
        rest = [ln for ln in it if ln.startswith(b"data: ")]
        assert rest[-1] == b"data: [DONE]"
        assert json.loads(rest[-2][6:])["choices"][0]["finish_reason"] \
            == "length"
    for text in _metrics(tiny):
        assert parse_prometheus_text(text)["llmd_tpu:drain_state"] == 1.0
    assert tiny.both("POST", "/admin/drain")[1].status_code == 200


def test_metrics_exposition_equals_prometheus_client():
    """The port's registry writes what ``prometheus_client`` writes for the
    JAX ``EngineMetrics`` after the same updates, byte for byte apart from
    the ``_created`` timestamps: names, help, label order, buckets and
    number formatting (1.23456789e+08, 1e-07)."""
    import re

    from llm_d_tpu.utils.metrics import EngineMetrics as JMetrics
    from llm_d_tpu_torch.utils.metrics import EngineMetrics as TMetrics

    texts = []
    for cls in (JMetrics, TMetrics):
        m = cls("tiny")
        m.generation_tokens.inc(3)
        m.prompt_tokens.inc(123456789)
        for v in (0.02, 100.0, 1e-4):
            m.time_to_first_token.observe(v)
        m.inter_token_latency.observe(0.001)
        for reason, n in (("length", 1), ("stop", 2)):
            m.request_success.labels(model_name="tiny",
                                     finished_reason=reason).inc(n)
        m.observe_queue_wait("standard", 0.5)
        m.observe_queue_wait("critical", 1e-7)
        m.inc_deadline_exceeded("sheddable")
        m.kv_cache_usage_perc.set(0.125)
        m.drain_state.set(1)
        texts.append(re.sub(r"(_created\{[^}]*\}) \S+", r"\1 T",
                            m.render().decode()))
    assert texts[1] == texts[0]
