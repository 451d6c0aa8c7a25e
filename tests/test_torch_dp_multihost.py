"""Port parity: multi-host data parallelism in ranks mode
(``--data-parallel-{size-local,start-rank,address,rpc-port,hybrid-lb,
workers}``): the leader's worker pool (``DPWorkerPool``), the start-rank
arithmetic and the wiring of ``server_from_args``, against the JAX server
on the CPU (port of ``tests/test_dp_multihost.py``).

* Two port servers on free ports, a leader (``DPEngineGroup(dp_size=1,
  start_rank=0)``) and a worker (``start_rank=1``), ``tiny`` on the JAX
  engine's weights (``models/convert.py``), and the JAX leader on the
  JAX engine with the JAX pool on the port worker: an idle leader serves
  locally; a forced remote reply equals the local one and the JAX
  leader's, local and proxied; the worker's ``x-llmd-sched-depth`` is
  reported (whole and streamed replies) and consumed by the pool; after
  every exchange ``inflight`` and ``dispatching`` are back at 0 and
  ``depth`` is at 0 or above.
* The pool's policy, fed the same events as JAX's ``DPWorkerPool``, gives
  the same ``load`` / ``pick`` / ``alternates`` at each step: least
  outstanding work, a stream's load is the worker's scheduler depth (not
  the open exchange), a dead worker's backoff (``LLMD_WORKER_BACKOFF_S``)
  and its expiry.
* ``derive_dp_workers``, the parsed flags, the start rank (the flag, or
  ``LWS_WORKER_INDEX`` times the local ranks) and the worker list (the
  flag, or derived from ``--data-parallel-address`` /
  ``LWS_LEADER_ADDRESS`` and ``--data-parallel-rpc-port``) equal the JAX
  server's on the same inputs; ``server_from_args`` attaches a pool only
  on the leader without ``--data-parallel-hybrid-lb``.
* ``python -m llm_d_tpu_torch.server.openai`` as a leader and a worker
  host with ``--device cpu``: a request that meets a busy leader is
  proxied and answered as the worker answers it; both exit 0 on SIGTERM.
* What stays refused is refused by name: spmd with
  ``--data-parallel-size-local`` below the size, ranks with
  ``--tensor-parallel-size`` > 1 on one host and across hosts.
"""

import asyncio
import contextlib
import json
import logging
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import requests
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.server import openai as JServer
from llm_d_tpu_torch.engine import EngineConfig
from llm_d_tpu_torch.engine.dp_group import DPEngineGroup
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.server import openai as TServer
from test_torch_server import _serve_jax, _serve_port
from test_torch_tp_server import FLAGS, ROOT, _free_port, _strip

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ENGINE_KW = dict(model="tiny", block_size=4, num_blocks=64, max_num_seqs=8,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4)
TIMEOUT = 60
GREEDY = dict(temperature=0.0, ignore_eos=True)
DEPTH = TServer.DPWorkerPool.DEPTH_HEADER


class _Hosts:
    """A port leader and worker host, and the JAX leader with the JAX
    pool on the port worker, all on the JAX engine's weights."""

    def __init__(self) -> None:
        jeng = JEngineCore(JEngineConfig(**ENGINE_KW))
        params = jax.tree.map(np.asarray, jeng.params)
        cfg = EngineConfig(device="cpu", **ENGINE_KW)
        self.leader = TServer.build_server(None, engine=DPEngineGroup(
            cfg, 1, params=params_from_numpy(params, "cpu"), start_rank=0),
            model_name="m")
        self.worker = TServer.build_server(None, engine=DPEngineGroup(
            cfg, 1, params=params_from_numpy(params, "cpu"), start_rank=1),
            model_name="m")
        self.jleader = JServer.build_server(None, engine=jeng,
                                            model_name="m")
        self.served = []
        self.served.append(_serve_port(self.worker))
        self.wurl = self.served[-1].url
        self.leader.dp_pool = TServer.DPWorkerPool([self.wurl])
        self.served.append(_serve_port(self.leader))
        self.lurl = self.served[-1].url
        self.jleader.dp_pool = JServer.DPWorkerPool([self.wurl])
        self.served.append(_serve_jax(self.jleader))
        self.jurl = self.served[-1].url

    def close(self) -> None:
        for s in reversed(self.served):
            s.close()


@pytest.fixture(scope="module")
def hosts():
    h = _Hosts()
    yield h
    h.close()


def _post(url, body, **kw):
    r = requests.post(url + "/v1/completions", json=body, timeout=TIMEOUT,
                      **kw)
    assert r.status_code == 200, r.text
    return r


@contextlib.contextmanager
def _forced(pool):
    """The pool's pick forced to its first worker (an idle leader serves
    locally otherwise)."""
    pool.pick = lambda engine: pool.workers[0]
    try:
        yield
    finally:
        del pool.pick


def _settled(pool):
    """After an exchange: no dispatch pending, no exchange open, depth at
    0 or above (the leader's finally runs just after the client has read
    the reply's end)."""
    deadline = time.monotonic() + 10
    while any(w["inflight"] for w in pool.workers) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    for w in pool.workers:
        assert w["inflight"] == 0 and w["dispatching"] == set()
        assert w["depth"] >= 0


def _successes(url) -> float:
    text = requests.get(url + "/metrics", timeout=TIMEOUT).text
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("vllm:request_success_total{"))


def test_each_host_holds_its_own_ranks(hosts):
    lg, wg = hosts.leader.engine, hosts.worker.engine
    assert (lg.start_rank, wg.start_rank) == (0, 1)
    assert len(lg.engines) == len(wg.engines) == 1
    assert lg.engines[0] is not wg.engines[0]
    assert not (set(t.data_ptr() for t in lg.engines[0].kv_cache.values())
                & set(t.data_ptr() for t in wg.engines[0].kv_cache.values()))


def test_the_leader_serves_locally_when_idle(hosts):
    pool = hosts.leader.dp_pool
    seq, done = pool.workers[0]["seq"], _successes(hosts.wurl)
    r = _post(hosts.lurl, dict(GREEDY, prompt=[5, 6, 7], max_tokens=4))
    assert r.json()["usage"]["completion_tokens"] == 4
    assert pool.workers[0]["seq"] == seq           # nothing dispatched
    assert _successes(hosts.wurl) == done
    _settled(pool)


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "streamed"])
def test_a_forced_remote_reply_equals_the_local_one_and_the_jax_leaders(
        hosts, stream):
    """The same greedy request served by the port leader locally and
    through its worker, and by the JAX leader locally and through the same
    port worker: four equal replies (the same weights on every host); the
    worker served the two proxied ones."""
    body = dict(GREEDY, prompt=[9, 8, 7], max_tokens=4, stream=stream)
    done = _successes(hosts.wurl)
    replies = []
    for url, pool in ((hosts.lurl, hosts.leader.dp_pool),
                      (hosts.jurl, hosts.jleader.dp_pool)):
        replies.append(_post(url, body))
        with _forced(pool):
            replies.append(_post(url, body))
        _settled(pool)
    if stream:
        got = []
        for r in replies:
            frames = [json.loads(ln[6:]) for ln in r.iter_lines()
                      if ln.startswith(b"data: {")]
            got.append([(f["llmd"], f["choices"][0]["finish_reason"])
                        for f in frames])
            assert r.text.rstrip().endswith("data: [DONE]")
    else:
        got = [_strip(r.json()) for r in replies]
    assert got[1:] == got[:1] * 3
    assert _successes(hosts.wurl) == done + 2


def test_the_depth_header_is_reported_and_consumed(hosts):
    """Every inference reply carries the worker's scheduler depth; the
    leader's pool folds it into the worker's load (stale state is
    replaced) and takes a finished stream back out."""
    r = _post(hosts.wurl, dict(GREEDY, prompt=[3, 1, 4], max_tokens=2))
    assert int(r.headers[DEPTH]) >= 0
    r = _post(hosts.wurl, dict(GREEDY, prompt=[3, 1, 4], max_tokens=2,
                               stream=True), stream=True)
    assert int(r.headers[DEPTH]) >= 1          # a stream counts itself
    r.close()
    pool = hosts.leader.dp_pool
    w = pool.workers[0]
    w["depth"] = 99                            # stale: the report fixes it
    with _forced(pool):
        r = _post(hosts.lurl, dict(GREEDY, prompt=[2, 7, 1], max_tokens=2))
    assert int(r.headers[DEPTH]) >= 0          # relayed to the client
    _settled(pool)
    assert w["depth"] < 99
    with _forced(pool):
        r = _post(hosts.lurl, dict(GREEDY, prompt=[2, 7, 1], max_tokens=3,
                                   stream=True), stream=True)
        list(r.iter_content())
        r.close()
    _settled(pool)
    assert w["depth"] == 0


class _Sched:
    num_waiting = num_running = 0


class _Eng:
    scheduler = _Sched()


def _pools(urls):
    return TServer.DPWorkerPool(urls), JServer.DPWorkerPool(urls)


def _same(pools, step):
    """Both pools' loads, pick and alternates at one step."""
    out = []
    for pool in pools:
        pick = pool.pick(_Eng())
        alt = pool.alternates({pool.workers[0]["url"]})
        out.append(dict(load=[type(pool).load(w) for w in pool.workers],
                        pick=None if pick is None
                        else pool.workers.index(pick),
                        alt=None if alt is None else pool.workers.index(alt)))
    assert out[0] == out[1], f"step {step}"
    return out[0]


POLICY_EVENTS = [
    # (local waiting, local running, {worker: {field: value}})
    (0, 0, {}),                                          # idle: local
    (0, 3, {0: {"depth": 1, "dispatching": {0}}}),       # least loaded: w1
    (0, 2, {0: {"depth": 5}, 1: {"depth": 4}}),          # all busier: local
    (1, 1, {0: {"depth": 0, "dispatching": set(), "inflight": 1}}),
    (1, 1, {0: {"dispatching": {5, 6}}}),                # unreported load
    (4, 4, {0: {"down_until": 1e12}, 1: {"depth": 9}}),  # w0 backed off
    (4, 4, {0: {"down_until": 0.0, "depth": 2}}),        # backoff over
    (1, 0, {0: {"down_until": 1e12}, 1: {"down_until": 1e12}}),  # all down
]


def test_the_pool_policy_follows_the_jax_pool_step_by_step():
    pools = _pools(["http://w0:8200/", "http://w1:8200"])
    assert [w["url"] for w in pools[0].workers] == \
        [w["url"] for w in pools[1].workers]
    want_picks = [None, 1, None, 0, None, None, 0, None]
    for step, (waiting, running, sets) in enumerate(POLICY_EVENTS):
        _Sched.num_waiting, _Sched.num_running = waiting, running
        for pool in pools:
            for i, fields in sets.items():
                for k, v in fields.items():
                    pool.workers[i][k] = set(v) if isinstance(v, set) else v
        assert _same(pools, step)["pick"] == want_picks[step]
    _Sched.num_waiting = _Sched.num_running = 0


def test_a_streams_load_is_the_scheduler_depth_not_the_open_exchange():
    """A long stream keeps its exchange open (inflight 1), but once the
    worker reported its scheduler depth the worker is judged by that."""
    pools = _pools(["http://w1"])
    _Sched.num_waiting, _Sched.num_running = 1, 1
    try:
        for pool in pools:
            pool.workers[0].update(inflight=1, dispatching=set(), depth=0)
        assert _same(pools, 0) == dict(load=[0], pick=0, alt=None)
        for pool in pools:
            pool.workers[0]["dispatching"] = {5, 6}
        assert _same(pools, 1) == dict(load=[2], pick=None, alt=None)
    finally:
        _Sched.num_waiting = _Sched.num_running = 0


class _Req:
    path_qs = "/v1/completions"
    path = "/v1/completions"
    headers = {}
    streamed = None


def test_a_dead_workers_backoff_and_its_expiry(monkeypatch):
    """A worker nothing listens on: the proxy returns None before any byte
    is committed (the caller serves locally) and the worker is backed off
    for ``LLMD_WORKER_BACKOFF_S`` (invalid values fall back, as in JAX);
    it loses the pick while backed off and wins it again after."""
    monkeypatch.setenv("LLMD_WORKER_BACKOFF_S", "0.2")
    pool = TServer.DPWorkerPool([f"http://127.0.0.1:{_free_port()}",
                                 "http://w2"])
    assert pool.worker_backoff_s == \
        JServer.DPWorkerPool(["http://x"]).worker_backoff_s == 0.2
    monkeypatch.setenv("LLMD_WORKER_BACKOFF_S", "banana")
    assert TServer.DPWorkerPool(["http://x"]).worker_backoff_s == \
        JServer.DPWorkerPool(["http://x"]).worker_backoff_s == \
        TServer.DPWorkerPool.WORKER_BACKOFF_S
    dead, live = pool.workers
    _Sched.num_waiting = 5

    async def run():
        assert await pool.proxy(_Req(), {"prompt": "x"}, dead) is None
        assert dead["down_until"] > time.monotonic()
        assert dead["inflight"] == 0 and dead["dispatching"] == set()
        live["depth"] = 3
        assert pool.pick(_Eng()) is live        # dead looks idle, loses
        await asyncio.sleep(0.25)
        assert pool.pick(_Eng()) is dead        # re-probed after backoff
        await pool.close()

    try:
        asyncio.run(run())
    finally:
        _Sched.num_waiting = 0


# ---------- flags and wiring ----------

@pytest.mark.parametrize("args", [
    ("wide-ep-decode-0.wide-ep-decode.ns", 2, 8200),
    ("leader:1234", 1, 9000), ("http://lead.svc:8200", 3, 8300),
    ("lead", 0, 8200), ("10.0.0.5", 2, 8200)], ids=lambda a: str(a))
def test_worker_urls_are_derived_as_the_jax_server_derives_them(args):
    assert TServer.derive_dp_workers(*args) == \
        JServer.derive_dp_workers(*args)
    if args[0] == "wide-ep-decode-0.wide-ep-decode.ns":
        assert TServer.derive_dp_workers(*args) == [
            "http://wide-ep-decode-0-1.wide-ep-decode.ns:8200",
            "http://wide-ep-decode-0-2.wide-ep-decode.ns:8200"]


def _jax_dp_wiring(args, env):
    """The JAX server's ``main`` arithmetic on parsed ``args``: (start
    rank, the leader's workers or None where no pool is attached)."""
    dp_local = args.data_parallel_size_local or args.data_parallel_size
    multi = (args.data_parallel_mode == "ranks"
             and dp_local < args.data_parallel_size)
    start = 0
    if multi:
        start = args.data_parallel_start_rank
        if start is None:
            start = int(env.get("LWS_WORKER_INDEX", "0")) * dp_local
    if not (multi and not args.data_parallel_hybrid_lb and start == 0):
        return start, None
    workers = [w.strip() for w in args.data_parallel_workers.split(",")
               if w.strip()]
    if not workers:
        leader = (args.data_parallel_address
                  or env.get("LWS_LEADER_ADDRESS", ""))
        if leader:
            workers = JServer.derive_dp_workers(
                leader, args.data_parallel_size // dp_local - 1,
                args.data_parallel_rpc_port or args.port)
    return start, workers


RANKS = ["--data-parallel-mode", "ranks", "--data-parallel-size", "4",
         "--data-parallel-size-local", "2"]
WIRING = {
    "leader_workers": (RANKS + ["--data-parallel-workers",
                                "http://w1:8200, http://w2:8200"], {}),
    "leader_address": (RANKS + ["--data-parallel-address", "lead.svc",
                                "--data-parallel-rpc-port", "8300"], {}),
    "leader_lws_env": (RANKS + ["--port", "8201"],
                       {"LWS_LEADER_ADDRESS": "grp-0.grp.ns:8200"}),
    "leader_no_address": (RANKS, {}),
    "worker_flag": (RANKS + ["--data-parallel-start-rank", "2"], {}),
    "worker_lws_env": (RANKS + ["--data-parallel-address", "lead"],
                       {"LWS_WORKER_INDEX": "1"}),
    "hybrid_lb": (RANKS + ["--data-parallel-hybrid-lb",
                           "--data-parallel-workers", "http://w1:8200"], {}),
    "one_host": (["--data-parallel-mode", "ranks", "--data-parallel-size",
                  "2", "--data-parallel-start-rank", "3"], {}),
}


@pytest.mark.parametrize("case", sorted(WIRING))
def test_flags_start_rank_and_workers_equal_the_jax_server(case,
                                                           monkeypatch):
    """The flags parse as the JAX parser parses them; the start rank and
    the leader's workers are the JAX ``main``'s; the flags pass the
    checks."""
    argv, env = WIRING[case]
    for k in ("LWS_WORKER_INDEX", "LWS_LEADER_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = TServer.build_arg_parser()
    args = p.parse_args(["--model", "tiny"] + argv)
    TServer.check_served(p, args)
    TServer.check_mesh_flags(p, args)
    jargs = JServer.build_arg_parser().parse_args(["--model", "tiny"] + argv)
    for dest in ("data_parallel_size", "data_parallel_size_local",
                 "data_parallel_start_rank", "data_parallel_address",
                 "data_parallel_rpc_port", "data_parallel_hybrid_lb",
                 "data_parallel_workers", "data_parallel_mode", "port"):
        assert getattr(args, dest) == getattr(jargs, dest), dest
    start, workers = _jax_dp_wiring(jargs, env)
    assert TServer.dp_start_rank(args) == start
    if workers is not None:
        assert TServer.dp_workers_from_args(args) == workers
    assert TServer.world_from_args(args) == 1      # no mesh: one process


@pytest.mark.parametrize("case", ["leader_workers", "leader_no_address",
                                  "worker_lws_env", "hybrid_lb"])
def test_server_from_args_attaches_the_pool_only_on_the_leader(
        case, monkeypatch, caplog):
    argv, env = WIRING[case]
    for k in ("LWS_WORKER_INDEX", "LWS_LEADER_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p = TServer.build_arg_parser()
    args = p.parse_args(FLAGS + argv)
    caplog.set_level(logging.INFO, logger=TServer.logger.name)
    server = TServer.server_from_args(args)
    _, want = _jax_dp_wiring(args, env)
    assert server.engine.start_rank == TServer.dp_start_rank(args)
    assert len(server.engine.engines) == 2           # the local ranks
    if want:
        assert [w["url"] for w in server.dp_pool.workers] == \
            [u.rstrip("/") for u in want]
    else:
        assert server.dp_pool is None
    if case == "leader_no_address":
        assert "no worker addresses" in caplog.text
    if case == "hybrid_lb":
        assert "hybrid-lb" in caplog.text


@pytest.mark.parametrize("flags,named", [
    (["--data-parallel-size", "2", "--data-parallel-size-local", "1"],
     None),
    (["--data-parallel-size", "2", "--data-parallel-mode", "ranks",
      "--tensor-parallel-size", "2"], "--data-parallel-mode ranks"),
    (["--data-parallel-size", "4", "--data-parallel-size-local", "2",
      "--data-parallel-mode", "ranks", "--tensor-parallel-size", "2",
      "--data-parallel-start-rank", "2"], "--tensor-parallel-size 2"),
    (["--data-parallel-size", "4", "--data-parallel-size-local", "3",
      "--data-parallel-mode", "ranks"], "must divide")],
    ids=["spmd_across_hosts", "ranks_tp", "ranks_tp_across_hosts",
         "local_not_dividing"])
def test_what_stays_refused_is_refused_by_name(flags, named, capsys,
                                              monkeypatch):
    """``spmd_across_hosts`` is served since (``named`` None): outside an
    LWS group one host holds the whole mesh, as in the JAX server
    (``tests/test_torch_lws.py`` joins a group's hosts)."""
    for k in ("LWS_GROUP_SIZE", "LWS_LEADER_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    p = TServer.build_arg_parser()
    args = p.parse_args(["--device", "cpu"] + flags)
    TServer.check_served(p, args)
    if named is None:
        TServer.check_mesh_flags(p, args)
        assert capsys.readouterr().err == ""
        assert TServer.lws_layout_from_args(args) is None
        return
    with pytest.raises(SystemExit) as e:
        TServer.check_mesh_flags(p, args)
    assert e.value.code == 2
    assert named in capsys.readouterr().err


# ---------- the entry points ----------

class _Host:
    def __init__(self, argv, name):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("LWS_")}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", LLMD_DRAIN_TIMEOUT_S="20")
        self.log_path = ROOT / "build" / f"test_multihost_{name}_{os.getpid()}.log"
        self.log_path.parent.mkdir(exist_ok=True)
        self._log = open(self.log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "llm_d_tpu_torch.server.openai", *FLAGS,
             "--port", str(self.port), *argv], env=env, cwd=str(ROOT),
            stdout=self._log, stderr=subprocess.STDOUT)

    def log(self) -> str:
        return self.log_path.read_text(errors="replace")[-4000:]

    def wait_ready(self):
        for _ in range(1200):
            assert self.proc.poll() is None, self.log()
            try:
                if requests.get(self.url + "/v1/models",
                                timeout=5).status_code == 200:
                    return
            except requests.ConnectionError:
                pass
            time.sleep(0.1)
        raise TimeoutError(self.log())

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._log.close()
        self.log_path.unlink(missing_ok=True)


def _running(url) -> float:
    text = requests.get(url + "/metrics", timeout=TIMEOUT).text
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(("vllm:num_requests_running{",
                                 "vllm:num_requests_waiting{")))


def test_the_entry_points_serve_as_leader_and_worker_and_exit_0():
    """A worker host (start rank 1) and a leader host with the worker's
    URL: a request that meets the leader busy with a stream is proxied
    and answered as the worker answers it directly; both exit 0 on
    SIGTERM."""
    ranks = ["--data-parallel-mode", "ranks", "--data-parallel-size", "2",
             "--data-parallel-size-local", "1"]
    worker = _Host(ranks + ["--data-parallel-start-rank", "1"], "worker")
    leader = _Host(ranks + ["--data-parallel-workers", worker.url],
                   "leader")
    try:
        worker.wait_ready()
        leader.wait_ready()
        stream = requests.post(leader.url + "/v1/completions", json=dict(
            GREEDY, prompt=[1, 2, 3], max_tokens=300, stream=True),
            stream=True, timeout=TIMEOUT)
        lines = stream.iter_lines()
        next(ln for ln in lines if ln.startswith(b"data: "))
        deadline = time.monotonic() + 30
        while _running(leader.url) < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        body = dict(GREEDY, prompt=[9, 8, 7], max_tokens=5)
        proxied = _post(leader.url, body).json()
        rest = [ln for ln in lines if ln.startswith(b"data: ")]
        assert rest[-1] == b"data: [DONE]"
        assert _successes(worker.url) == 1       # the worker served it
        direct = _post(worker.url, body).json()
        assert _strip(proxied) == _strip(direct)
        assert _successes(leader.url) == 1       # the stream, locally
        for h in (leader, worker):
            h.proc.send_signal(signal.SIGTERM)
        for h in (leader, worker):
            assert h.proc.wait(timeout=60) == 0, h.log()
        assert "dispatching across 1 worker hosts" in leader.log()
        assert "local ranks 1..1 of 2" in worker.log()
    finally:
        leader.close()
        worker.close()
