"""Port parity: mid-stream resume, the relay's half
(``llm_d_tpu_torch.server.stream_resume``: ``StreamJournal``,
``relay_stream``, ``resume_policy``), the standard-library HTTP client
(``server/http_client.py``) and the DP leader's relay with its local
resume (``DPWorkerPool`` and ``ModelServer.resume_local``), against the
JAX package on the CPU (port of ``tests/test_stream_recovery.py``'s
journal and relay cases).

* The journal: the same frames fed to the port's ``StreamJournal`` and to
  JAX's give the same offsets, token ids, ``resume_body()``,
  ``resume_headers()``, stream id, finish reason, ``src`` and recovery
  outcomes: the dedupe and resume handshake, the seeding from an
  inherited ``resume`` body, the finish-reason tracking, the recovery
  accounting.  The policy's env knobs read alike.
* ``relay_stream``: the same upstream byte pieces through both relays
  write the same frames and leave the same journal, and end alike: a
  whole stream, a break mid-frame (the partial frame dropped), a resumed
  upstream replaying delivered tokens, the stall watchdog (with its span
  event), the ``stream.relay`` fault, a client that hung up.
* The HTTP client: chunked and ``Content-Length`` replies, a body that
  ends with the connection, and every broken reply (mid-chunk, before
  the last chunk, short of its length, a refused connection, a read
  timeout) as ``ClientError``; the request it sends.
* The DP leader (two port servers on free ports, ``tiny`` on the JAX
  engine's weights): a one-shot ``engine.step`` fault kills the worker
  mid-stream; the leader resumes on its own engine; the stream is
  continuous (``verify_continuity``), its tokens equal one healthy port
  engine's and the JAX engine's, ``llmd_tpu:stream_resume_total`` and
  ``request_recovery_seconds`` count it, and the pool's slot is settled.
  With two workers the stream resumes on the other one.  With resume off,
  a ``sheddable`` stream, or no attempts left, the break reaches the
  client (no ``[DONE]``).
"""

import asyncio
import json
import socket
import time

import jax
import numpy as np
import pytest
import requests
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu.server import stream_resume as jresume
from llm_d_tpu.utils import faultinject as jfaultinject
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.server import http_client
from llm_d_tpu_torch.server import openai as TServer
from llm_d_tpu_torch.server import stream_resume as tresume
from llm_d_tpu_torch.utils import faultinject
from llm_d_tpu_torch.utils.faultinject import FaultInjector
from test_torch_server import TIMEOUT, _serve_port

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ENGINE_KW = dict(model="tiny", block_size=4, num_blocks=64, max_num_seqs=8,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4)
PROMPT = [7, 3, 9, 1]
NEW = 12


@pytest.fixture()
def inject():
    def make() -> FaultInjector:
        return faultinject.install(FaultInjector())
    yield make
    faultinject.reset()


def _frame(chunk) -> bytes:
    return b"data: " + json.dumps(chunk).encode() + b"\n\n"


def _journals(body, **kw):
    return (tresume.StreamJournal(body, **kw),
            jresume.StreamJournal(body, **kw))


def _state(j):
    return dict(offset=j.offset, token_ids=list(j.token_ids), done=j.done,
                resumable=j.resumable, stream_id=j.stream_id,
                finish_reason=j.finish_reason, last_src=j.last_src,
                resume_body=j.resume_body(), resume_headers=j.resume_headers())


def _feed(journals, frame):
    """One frame into both journals: their verdicts and states agree."""
    verdicts = [j.admit_frame(frame) for j in journals]
    assert verdicts[0] == verdicts[1]
    assert _state(journals[0]) == _state(journals[1])
    return verdicts[0]


# ---------- the journal ----------

def test_journal_dedupe_and_resume_handshake_equal_jax():
    body = {"prompt": "hi", "stream": True, "max_tokens": 4}
    js = _journals(body, criticality="standard")
    assert _state(js[0]) == _state(js[1])
    assert js[0].resumable and js[0].offset == 0
    assert _feed(js, _frame({"id": "cmpl-1", "choices": [{"text": "a "}],
                             "llmd": {"off": 0, "tok": [11]}}))
    assert _feed(js, _frame({"id": "cmpl-1", "choices": [{"text": "b "}],
                             "llmd": {"off": 1, "tok": [12]}}))
    assert js[0].resume_body()["resume"] == {"offset": 2,
                                             "token_ids": [11, 12]}
    assert js[0].resume_body()["request_id"] == "cmpl-1"
    assert js[0].resume_headers()["x-llmd-resume-offset"] == "2"
    js[0].resume_count = js[1].resume_count = 1
    assert _state(js[0])["resume_headers"]["x-llmd-resume-attempt"] == "1"
    # A resumed upstream replaying token 1 is dropped; new tokens pass.
    assert not _feed(js, _frame({"id": "cmpl-1", "choices": [{"text": "b "}],
                                 "llmd": {"off": 1, "tok": [12]}}))
    assert _feed(js, _frame({"id": "cmpl-1", "choices": [{"text": "c "}],
                             "llmd": {"off": 2, "tok": [13],
                                      "src": "restored", "restored": 2}}))
    # An overlap keeps only the tokens past the offset.
    assert _feed(js, _frame({"id": "cmpl-1", "choices": [{"text": "cd"}],
                             "llmd": {"off": 2, "tok": [13, 14]}}))
    assert js[0].token_ids == [11, 12, 13, 14]
    assert _feed(js, _frame({"id": "cmpl-1", "choices": [],
                             "usage": {"completion_tokens": 4}}))
    assert _feed(js, b": heartbeat\n\n")
    assert js[0].resumable
    # A token-carrying frame without meta (a foreign server) disqualifies.
    assert _feed(js, _frame({"id": "x", "choices": [{"text": "q"}]}))
    assert not js[0].resumable
    assert _feed(js, b"data: [DONE]\n\n")
    assert js[0].done


def test_journal_seeds_from_an_inherited_resume_body_equal_jax():
    body = {"prompt": "hi", "stream": True,
            "resume": {"offset": 3, "token_ids": [7, 8, 9]}}
    js = _journals(body)
    assert js[0].token_ids == [7, 8, 9] and js[0].offset == 3
    assert _feed(js, _frame({"id": "c", "choices": [{"text": "d "}],
                             "llmd": {"off": 3, "tok": [10]}}))
    assert js[0].resume_body()["resume"] == {"offset": 4,
                                             "token_ids": [7, 8, 9, 10]}
    for bad in ({"token_ids": ["x", None]}, {"token_ids": 5}, None):
        js = _journals({"resume": bad})
        assert js[0].offset == js[1].offset == 0


def test_journal_tracks_the_delivered_finish_reason_equal_jax():
    js = _journals({"stream": True})
    _feed(js, _frame({"choices": [{"text": "a", "finish_reason": None}],
                      "llmd": {"off": 0, "tok": [1]}}))
    assert js[0].finish_reason is None
    _feed(js, _frame({"choices": [{"text": "", "finish_reason": "stop"}],
                      "llmd": {"off": 1, "tok": [2]}}))
    assert js[0].finish_reason == "stop" and not js[0].done


def test_journal_recovery_accounting_equal_jax():
    js = _journals({"stream": True})
    _feed(js, _frame({"choices": [{"text": "a"}],
                      "llmd": {"off": 0, "tok": [1]}}))
    for j in js:
        j.mark_break()
        assert j.take_recoveries() == []       # nothing resumed yet
    # A replayed frame (no new token) does not close the measurement.
    _feed(js, _frame({"choices": [{"text": "a"}],
                      "llmd": {"off": 0, "tok": [1]}}))
    assert [j.take_recoveries() for j in js] == [[], []]
    _feed(js, _frame({"choices": [{"text": "b"}],
                      "llmd": {"off": 1, "tok": [2], "src": "recomputed",
                               "restored": 0}}))
    recs = [j.take_recoveries() for j in js]
    assert [[o for o, _ in r] for r in recs] == [
        [tresume.OUTCOME_RECOMPUTED]] * 2
    assert all(s >= 0.0 for r in recs for _, s in r)
    assert [j.take_recoveries() for j in js] == [[], []]   # drained


@pytest.mark.parametrize("env", [
    {}, {"LLMD_STREAM_RESUME": "0", "LLMD_RESUME_MAX_ATTEMPTS": "5",
         "LLMD_STREAM_STALL_TIMEOUT_S": "1.5"},
    {"LLMD_STREAM_RESUME": "banana", "LLMD_RESUME_MAX_ATTEMPTS": "x",
     "LLMD_STREAM_STALL_TIMEOUT_S": "-"}], ids=["default", "set", "invalid"])
def test_resume_policy_env_knobs_equal_jax(env, monkeypatch):
    for k in ("LLMD_STREAM_RESUME", "LLMD_RESUME_MAX_ATTEMPTS",
              "LLMD_STREAM_STALL_TIMEOUT_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t, j = tresume.resume_policy(), jresume.resume_policy()
    assert (t.enabled, t.max_attempts, t.stall_timeout_s) == \
        (j.enabled, j.max_attempts, j.stall_timeout_s)
    if env.get("LLMD_RESUME_MAX_ATTEMPTS") == "5":
        assert (t.enabled, t.max_attempts, t.stall_timeout_s) == \
            (False, 5, 1.5)


def test_continuity_oracle_and_payload_parser_equal_jax():
    metas = [[{"off": 0, "tok": [1, 2]}, {"off": 2, "tok": [3]}],
             [{"off": 0, "tok": [1, 2]}, {"off": 1, "tok": [2, 3]}],
             [{"off": 0, "tok": [1]}, {"off": 2, "tok": [3]}],
             [{"off": 0, "tok": [1]}, {"off": 1, "tok": []}]]
    for m in metas:
        for total in (None, 3):
            assert tresume.verify_continuity(m, total) == \
                jresume.verify_continuity(m, total)
    payload = (_frame({"choices": [{"text": "a "}],
                       "llmd": {"off": 0, "tok": [5]}})
               + _frame({"choices": [{"delta": {"content": "b "}}],
                         "llmd": {"off": 1, "tok": [6]}})
               + b"data: [DONE]\n\n")
    for p in (payload, payload[:-16]):
        assert tresume.parse_stream_payload(p) == \
            jresume.parse_stream_payload(p)


# ---------- relay_stream ----------

class _Content:
    """An upstream body: ``readany()`` hands out the pieces in turn (b""
    after the last); a piece None waits, as a wedged replica does."""

    def __init__(self, pieces):
        self.pieces = list(pieces)

    async def readany(self) -> bytes:
        if not self.pieces:
            return b""
        piece = self.pieces.pop(0)
        if piece is None:
            await asyncio.sleep(30)
            return b""
        return piece


class _Resp:
    def __init__(self, fail_after=None):
        self.written, self.fail_after = [], fail_after

    async def write(self, data: bytes) -> None:
        if self.fail_after is not None and \
                len(self.written) >= self.fail_after:
            raise ConnectionResetError("client gone")
        self.written.append(data)


class _Span:
    def __init__(self):
        self.events = []

    def add_event(self, name, **attrs):
        self.events.append((name, attrs))


def _stream_bytes(n, start=0, done=True):
    out = b"".join(_frame({"id": "cmpl-r", "choices": [{"text": f"{t} "}],
                           "llmd": {"off": t, "tok": [100 + t]}})
                   for t in range(start, start + n))
    return out + (b"data: [DONE]\n\n" if done else b"")


def _pieces(data: bytes, size: int):
    return [data[i:i + size] for i in range(0, len(data), size)]


RELAY_CASES = {
    # name: (pieces, journal body, stall_timeout_s, fault, client fails)
    "whole": (_pieces(_stream_bytes(5), 37), {}, 0.0, False, None),
    "break_mid_frame": (_pieces(_stream_bytes(4, done=False)[:-20], 29), {},
                        0.0, False, None),
    "replay_below_offset": (
        _pieces(_stream_bytes(6), 50),
        {"resume": {"offset": 3, "token_ids": [100, 101, 102]}}, 0.0, False,
        None),
    "stall_watchdog": ([_stream_bytes(2, done=False), None], {}, 0.05, False,
                       None),
    "stream_relay_fault": (_pieces(_stream_bytes(5), 64), {}, 0.0, True,
                           None),
    "client_gone": (_pieces(_stream_bytes(5), 64), {}, 0.0, False, 2),
}


@pytest.mark.parametrize("case", sorted(RELAY_CASES))
def test_relay_stream_equals_jax(case):
    """The same upstream pieces through the port's and JAX's
    ``relay_stream``: the same frames written, the same journal, the same
    ending (by exception name) and the same span events."""
    pieces, body, stall, fault, fail_after = RELAY_CASES[case]
    outcome = []
    for mod, fi in ((tresume, faultinject), (jresume, jfaultinject)):
        inj = fi.install(fi.FaultInjector())
        if fault:
            inj.add_rule("stream.relay", after=2, count=1,
                         match="http://w1")
        journal, resp, span = mod.StreamJournal(dict(body)), \
            _Resp(fail_after), _Span()
        try:
            asyncio.run(mod.relay_stream(
                resp, _Content(pieces), journal, fault_key="http://w1",
                stall_timeout_s=stall, span=span))
            ended = "returned"
        except Exception as e:                  # compared across packages
            ended = type(e).__name__
        finally:
            fi.reset()
        outcome.append(dict(ended=ended, written=resp.written,
                            journal=_state(journal), events=span.events))
    assert outcome[0] == outcome[1]
    want = {"whole": "returned", "break_mid_frame": "StreamBroken",
            "replay_below_offset": "returned",
            "stall_watchdog": "StreamStall",
            "stream_relay_fault": "FaultInjected",
            "client_gone": "ClientGone"}[case]
    assert outcome[0]["ended"] == want
    frames = outcome[0]["written"]
    assert all(f.endswith(b"\n\n") for f in frames)    # whole frames only
    if case == "replay_below_offset":
        # Tokens 0-2 were delivered before: their replays are dropped.
        assert [json.loads(f[6:])["llmd"]["off"] for f in frames[:-1]] \
            == [3, 4, 5]
    if case == "break_mid_frame":
        assert len(frames) == 3 and outcome[0]["journal"]["offset"] == 3


# ---------- the standard-library HTTP client ----------

def _chunked(*parts, ext=False, trailer=False):
    body = b"".join(b"%x%s\r\n%s\r\n" % (len(p), b";x=1" if ext else b"", p)
                    for p in parts)
    return body + b"0\r\n" + (b"x-t: 1\r\n" if trailer else b"") + b"\r\n"


HEAD_CHUNKED = (b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                b"X-LLMD-Sched-Depth: 3\r\nTransfer-Encoding: chunked\r\n"
                b"\r\n")
CLIENT_CASES = {
    # name: (reply bytes, stall after them, want body or error)
    "chunked": (HEAD_CHUNKED + _chunked(b"data: a\n\n", b"data: bb\n\n",
                                        ext=True, trailer=True),
                False, b"data: a\n\ndata: bb\n\n"),
    "content_length": (b"HTTP/1.1 404 Not Found\r\nContent-Length: 11\r\n"
                       b"Content-Type: application/json\r\n\r\n"
                       b'{"error":1}', False, b'{"error":1}'),
    "close_delimited": (b"HTTP/1.0 200 OK\r\n\r\nuntil the end", False,
                        b"until the end"),
    "interim_100": (b"HTTP/1.1 100 Continue\r\n\r\nHTTP/1.1 200 OK\r\n"
                    b"Content-Length: 2\r\n\r\nok", False, b"ok"),
    "mid_chunk": (HEAD_CHUNKED + b"a\r\ndata: ", False, "ClientError"),
    "before_last_chunk": (HEAD_CHUNKED + _chunked(b"data: a\n\n")[:-5],
                          False, "ClientError"),
    "short_of_length": (b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\n"
                        b"12345", False, "ClientError"),
    "no_reply": (b"", False, "ClientError"),
    "bad_status_line": (b"SPDY/3 200 OK\r\n\r\n", False, "ClientError"),
    "read_timeout": (HEAD_CHUNKED + b"5\r\nabc", True, "ClientError"),
    "refused": (None, False, "ClientError"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("case", sorted(CLIENT_CASES))
def test_http_client_decodes_replies_and_reports_broken_ones(case):
    reply, stall, want = CLIENT_CASES[case]
    seen = {}

    async def serve(reader, writer):
        head = await reader.readuntil(b"\r\n\r\n")
        seen["head"] = head.decode("latin-1")
        n = int(next(ln.split(":")[1] for ln in seen["head"].split("\r\n")
                     if ln.lower().startswith("content-length")))
        seen["body"] = await reader.readexactly(n)
        writer.write(reply)
        await writer.drain()
        if stall:
            await asyncio.sleep(5)
        writer.close()

    async def run():
        port = _free_port()
        server = None
        if reply is not None:
            server = await asyncio.start_server(serve, "127.0.0.1", port)
        try:
            resp = await http_client.post_json(
                f"http://127.0.0.1:{port}", "/v1/completions?x=1",
                {"prompt": [1, 2]},
                {"X-Request-Id": "r1", "content-type": "text/plain",
                 "Host": "elsewhere"},
                connect_timeout=2.0, read_timeout=0.3 if stall else None)
            async with resp:
                body = b""
                while True:
                    data = await resp.readany()
                    if not data:
                        break
                    body += data
                assert await resp.readany() == b""
            return resp, body
        finally:
            if server is not None:
                server.close()
                await server.wait_closed()

    if isinstance(want, str):
        with pytest.raises(http_client.ClientError):
            asyncio.run(run())
        return
    resp, body = asyncio.run(run())
    assert body == want
    if case == "chunked":
        assert resp.status == 200
        assert resp.headers["content-type"] == "text/event-stream"
        assert resp.headers["x-llmd-sched-depth"] == "3"
    if case == "content_length":
        assert resp.status == 404 and resp.reason == "Not Found"
    # What the client sent: the target, its own host, type and length,
    # the body, and the caller's other headers.
    lines = seen["head"].split("\r\n")
    assert lines[0] == "POST /v1/completions?x=1 HTTP/1.1"
    hdrs = {ln.split(":", 1)[0].lower(): ln.split(":", 1)[1].strip()
            for ln in lines[1:] if ":" in ln}
    assert hdrs["content-type"] == "application/json"
    assert hdrs["host"].startswith("127.0.0.1:")
    assert hdrs["x-request-id"] == "r1" and hdrs["connection"] == "close"
    assert sum(ln.lower().startswith("content-type") for ln in lines) == 1
    assert json.loads(seen["body"]) == {"prompt": [1, 2]}


# ---------- the DP leader's relay ----------

_WEIGHTS = {}


def _weights():
    """The JAX engine's weights (for every port engine here) and its
    uninterrupted tokens for ``PROMPT``."""
    if not _WEIGHTS:
        jeng = JEngineCore(JEngineConfig(**ENGINE_KW))
        want = jeng.generate([JRequest(
            request_id="solo", prompt_token_ids=list(PROMPT),
            sampling=JSamplingParams(temperature=0.0, max_tokens=NEW,
                                     ignore_eos=True))])["solo"]
        _WEIGHTS["params"] = jax.tree.map(np.asarray, jeng.params)
        _WEIGHTS["want"] = want
    return _WEIGHTS["params"], _WEIGHTS["want"]


def _port_server():
    params, _ = _weights()
    eng = EngineCore(EngineConfig(device="cpu", **ENGINE_KW),
                     params=params_from_numpy(params, "cpu"))
    return TServer.build_server(None, engine=eng, model_name="m")


def _metric(server, name: str, label: str = "") -> float:
    """The sum of ``name``'s samples (with ``label`` among their labels)
    in ``server``'s /metrics text."""
    total = 0.0
    for line in server.engine.metrics.render().decode().splitlines():
        if line.startswith((name + "{", name + " ")) and label in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


def _kill_mid_stream(inj, url, body, after_frames=2):
    """Stream ``body`` from ``url``; once ``after_frames`` frames have
    arrived, a one-shot ``engine.step`` error kills whichever engine steps
    next (the serving worker: the leader idles)."""
    payload, killed = b"", False
    try:
        with requests.post(url + "/v1/completions", json=body, stream=True,
                           timeout=TIMEOUT) as r:
            assert r.status_code == 200
            for chunk in r.iter_content(chunk_size=None):
                payload += chunk
                if not killed and payload.count(b"\n\n") >= after_frames:
                    inj.add_rule("engine.step", count=1)
                    killed = True
    except requests.exceptions.ChunkedEncodingError:
        pass                     # the break reached the client
    assert killed
    return payload


def _eventually(cond, timeout_s: float = 10.0) -> bool:
    """Whether ``cond()`` holds within ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def _settled(pool):
    """Every worker's slot settled once the leader's attempts end (their
    finally runs just after the client has read the reply's end)."""
    _eventually(lambda: all(w["inflight"] == 0 for w in pool.workers))
    for w in pool.workers:
        assert w["inflight"] == 0 and w["dispatching"] == set()
        assert w["depth"] >= 0


def _greedy(stream=True, **kw):
    return dict(prompt=PROMPT, max_tokens=NEW, temperature=0.0,
                ignore_eos=True, stream=stream, **kw)


@pytest.mark.parametrize("workers", [1, 2], ids=["local", "other_worker"])
def test_dp_relay_resumes_and_settles_accounting(workers, inject,
                                                 monkeypatch):
    """The leader proxies a stream to its (first) worker, whose engine
    dies mid-stream: the stream resumes on the other worker, or on the
    leader's own engine when there is none, with continuous offsets and
    the tokens of one healthy port engine and of the JAX engine; the
    leader counts the resume, and every worker's slot is settled."""
    params, want = _weights()
    solo = EngineCore(EngineConfig(device="cpu", **ENGINE_KW),
                      params=params_from_numpy(params, "cpu"))
    healthy = solo.generate([Request("solo", list(PROMPT), SamplingParams(
        temperature=0.0, max_tokens=NEW, ignore_eos=True))])["solo"]
    assert healthy == want
    inj = inject()
    # Every engine step is slowed (a latency rule), so the kill lands
    # mid-stream.
    inj.add_rule("engine.step", latency_s=0.05, label="none")
    leader = _port_server()
    hosts = [_port_server() for _ in range(workers)]
    served = [_serve_port(s) for s in hosts]
    lserved = _serve_port(leader)
    pool = TServer.DPWorkerPool([s.url for s in served])
    leader.dp_pool = pool
    monkeypatch.setattr(TServer.DPWorkerPool, "pick",
                        lambda self, engine: self.workers[0])
    try:
        payload = _kill_mid_stream(inj, lserved.url, _greedy())
        assert hosts[0].async_engine.dead is not None
        text, metas, done = tresume.parse_stream_payload(payload)
        assert done, "the stream did not complete after the worker died"
        assert tresume.verify_continuity(metas, expect_total=NEW) == []
        assert jresume.verify_continuity(metas, expect_total=NEW) == []
        assert [t for m in metas for t in m["tok"]] == want
        srcs = [m["src"] for m in metas if "src" in m]
        assert srcs == [tresume.OUTCOME_RECOMPUTED]
        assert len({json.loads(f[6:])["id"] for f in payload.split(b"\n\n")
                    if f.startswith(b"data: {")}) == 1     # one stream id
        # The leader settles the recovery once its relay returns, which
        # may be just after the client read the stream's end.
        assert _eventually(lambda: _metric(
            leader, "llmd_tpu:stream_resume_total") >= 1)
        assert _metric(
            leader, "llmd_tpu:request_recovery_seconds_count") >= 1
        served_by = [_metric(s, "vllm:request_success_total")
                     for s in [leader] + hosts]
        # The leader's engine, or the second worker, served the resume.
        assert served_by == ([1.0, 0.0] if workers == 1
                             else [0.0, 0.0, 1.0])
        assert pool.workers[0]["down_until"] > time.monotonic()
        _settled(pool)
    finally:
        lserved.close()
        for s in served:
            s.close()


@pytest.mark.parametrize("mode", ["resume_off", "sheddable",
                                  "no_attempts_left"])
def test_dp_relay_past_the_resume_contract_breaks_the_stream(
        mode, inject, monkeypatch):
    """Resume off (``LLMD_STREAM_RESUME=0``), a ``sheddable`` stream, or
    ``LLMD_RESUME_MAX_ATTEMPTS=0``: the worker's death reaches the client
    as a break (no ``[DONE]``); only a journaled stream counts a failed
    resume."""
    headers = {}
    if mode == "resume_off":
        monkeypatch.setenv("LLMD_STREAM_RESUME", "0")
    elif mode == "sheddable":
        headers = {"x-llmd-criticality": "sheddable"}
    else:
        monkeypatch.setenv("LLMD_RESUME_MAX_ATTEMPTS", "0")
    inj = inject()
    inj.add_rule("engine.step", latency_s=0.05, label="none")
    leader, worker = _port_server(), _port_server()
    wserved, lserved = _serve_port(worker), _serve_port(leader)
    pool = TServer.DPWorkerPool([wserved.url])
    leader.dp_pool = pool
    monkeypatch.setattr(TServer.DPWorkerPool, "pick",
                        lambda self, engine: self.workers[0])
    try:
        payload, killed = b"", False
        try:
            with requests.post(lserved.url + "/v1/completions",
                               json=_greedy(), headers=headers, stream=True,
                               timeout=TIMEOUT) as r:
                assert r.status_code == 200
                for chunk in r.iter_content(chunk_size=None):
                    payload += chunk
                    if not killed and payload.count(b"\n\n") >= 2:
                        inj.add_rule("engine.step", count=1)
                        killed = True
        except requests.exceptions.ChunkedEncodingError:
            pass
        assert killed
        _, metas, done = tresume.parse_stream_payload(payload)
        assert not done
        assert tresume.verify_continuity(metas) == []
        _settled(pool)
        failed = _metric(leader, "llmd_tpu:stream_resume_total",
                         'outcome="failed"')
        assert failed == (1.0 if mode == "no_attempts_left" else 0.0)
        assert _metric(leader, "vllm:request_success_total") == 0
        _settled(pool)
    finally:
        lserved.close()
        wserved.close()
