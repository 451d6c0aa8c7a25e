"""Port parity: P/D disaggregation (``llm_d_tpu_torch.transfer``) against
the JAX package's connector and transport, on the CPU.

* Wire v2 byte-exact, both directions: a JAX engine's cache and a port
  engine's cache filled from the same numpy arrays pack the same bytes
  (``_pack_blocks``), and a blob packed by either package and scattered
  by the other leaves exactly those arrays in the consumer's blocks (the
  port writes its cache tensors in place), for ``tiny`` on bf16, int8
  per-token and int8 per-head caches and ``tiny-mla`` on a bf16 and an
  int8 latent; dtype, layout and version mismatches are rejected by name.
* Transport: round trips on the port's native and Python servers, and
  each package's client against the other's servers.
* P/D greedy tokens (a port producer, a port consumer) equal the port's
  single engine of the consumer's configuration: ``tiny``, ``tiny-mla``
  on an int8 latent, the consumer in 4-step blocks under async
  scheduling, and the consumer at ``spec_k = 2`` (the producer's prefill
  then finishes through the fused round's retire); across packages, a
  JAX producer with a port consumer and a port producer with a JAX
  consumer give the JAX single engine's tokens.
* Mirrors of ``tests/test_pd.py``: a block-aligned prompt, a missing
  connector fails loudly, ``kv_load_failure_policy`` fail and recompute,
  a producer's pin timeout releases its blocks, deterministic injected
  pull drops recovered by retry or by recompute (``tiny`` and an int8
  ``tiny-mla`` latent, after ``tests/test_chaos.py``), and the JAX routing
  sidecar in front of a port producer server and a port consumer server
  (completion, probes passed through).

Every comparison is exact.
"""

import asyncio
import json
import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import requests
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.engine.request import RequestState as JRequestState
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu.transfer import KVConnectorConfig as JKVConnectorConfig
from llm_d_tpu.transfer import TpuConnector as JTpuConnector
from llm_d_tpu.transfer import connector as JConn
from llm_d_tpu.transfer import transport as JTransport
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request, RequestState
from llm_d_tpu_torch.models.convert import params_from_numpy, tensor_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.server import openai as TServer
from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
from llm_d_tpu_torch.transfer import connector as TConn
from llm_d_tpu_torch.transfer import transport

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ENGINE_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4)
CACHE_MODES = {
    "tiny-bf16": dict(model="tiny", kv_cache_dtype="bf16"),
    "tiny-int8-token": dict(model="tiny", kv_cache_dtype="int8",
                            kv_scale_granularity="token"),
    "tiny-int8-head": dict(model="tiny", kv_cache_dtype="int8",
                           kv_scale_granularity="head"),
    "tiny-mla-bf16": dict(model="tiny-mla", quantization="int8",
                          kv_cache_dtype="bf16"),
    "tiny-mla-int8": dict(model="tiny-mla", quantization="int8",
                          kv_cache_dtype="int8"),
}
PROMPTS = {
    "pd-a": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],      # partial last block
    "pd-b": [2, 7, 1, 8, 2, 8, 1],
    "pd-c": [11, 22, 33, 44, 55, 66, 77, 88, 99, 10, 20, 30, 40],
}


def greedy(rid, prompt, n=6, R=Request, SP=SamplingParams, **kw):
    return R(rid, list(prompt), SP(temperature=0.0, max_tokens=n,
                                   ignore_eos=True), **kw)


def port_tree(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _drive(engine, until, max_steps=4000):
    for _ in range(max_steps):
        engine.step()
        if until():
            return
        if not engine.scheduler.has_work():
            time.sleep(0.002)       # waiting on the transfer threads
    raise AssertionError("condition not reached")


# ---------------------------------------------------------------------------
# wire v2
# ---------------------------------------------------------------------------

def _filled_pair(mode, seed=0):
    """A JAX engine and a port engine of ``mode`` whose caches hold the
    same random numpy arrays; returns (jax engine, port engine, arrays)."""
    kw = dict(ENGINE_KW, **CACHE_MODES[mode])
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = EngineCore(EngineConfig(device="cpu", **kw),
                      params=port_tree(jeng.params))
    assert sorted(jeng.kv_cache) == sorted(teng.kv_cache)
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, buf in teng.kv_cache.items():
        shape = tuple(buf.shape)
        assert shape == tuple(jeng.kv_cache[name].shape)
        if buf.dtype == torch.int8:
            a = rng.integers(-128, 128, shape, dtype=np.int8)
        elif buf.dtype == torch.float32:
            a = rng.standard_normal(shape).astype(np.float32)
        else:
            a = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        arrays[name] = a
        buf.copy_(tensor_from_numpy(a, "cpu"))
        jeng.kv_cache[name] = jnp.asarray(a)
    return jeng, teng, arrays


def _rows(arr, b, bs=ENGINE_KW["block_size"]):
    return np.asarray(arr)[:, b * bs:(b + 1) * bs]


def _port_np(t):
    a = t.numpy() if t.dtype != torch.bfloat16 else \
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return a


SRC_BLOCKS = [5, 2, 9]          # producer blocks, out of order
DST_BLOCKS = [7, 1, 3]          # the consumer's own blocks


@pytest.mark.parametrize("mode", sorted(CACHE_MODES))
def test_wire_bytes_equal_and_scatter_both_ways(mode):
    jeng, teng, arrays = _filled_pair(mode)
    blob = TConn._pack_blocks(teng, SRC_BLOCKS)
    jblob = JConn._pack_blocks(jeng, SRC_BLOCKS)
    assert blob == jblob

    # JAX blob -> port consumer: the arrays land in the consumer's blocks,
    # in place (the tensors graphs captured), and nowhere else.
    _, tdst, _ = _filled_pair(mode, seed=1)
    before = {n: (t.data_ptr(), t.clone()) for n, t in tdst.kv_cache.items()}
    TConn.scatter_blocks(tdst, DST_BLOCKS, jblob)
    for name, t in tdst.kv_cache.items():
        assert t.data_ptr() == before[name][0]
        got = _port_np(t)
        for s, d in zip(SRC_BLOCKS, DST_BLOCKS):
            np.testing.assert_array_equal(
                _rows(got, d).view(np.uint8),
                _rows(arrays[name], s).view(np.uint8), err_msg=name)
        keep = torch.ones(t.shape[1], dtype=torch.bool)
        for d in DST_BLOCKS:
            keep[d * 4:(d + 1) * 4] = False
        np.testing.assert_array_equal(
            _port_np(t[:, keep]).view(np.uint8),
            _port_np(before[name][1][:, keep]).view(np.uint8))

    # Port blob -> JAX consumer.
    jdst, _, _ = _filled_pair(mode, seed=2)
    JConn._scatter_blocks(jdst, DST_BLOCKS, blob)
    for name in arrays:
        got = np.asarray(jdst.kv_cache[name])
        for s, d in zip(SRC_BLOCKS, DST_BLOCKS):
            np.testing.assert_array_equal(
                _rows(got, d).view(np.uint8),
                _rows(arrays[name], s).view(np.uint8), err_msg=name)


def test_wire_rejects_dtype_layout_and_version_mismatches():
    _, q8, _ = _filled_pair("tiny-int8-token")
    _, bf, _ = _filled_pair("tiny-bf16")
    blob8 = TConn._pack_blocks(q8, SRC_BLOCKS)
    blob16 = TConn._pack_blocks(bf, SRC_BLOCKS)
    assert len(blob8) < 0.65 * len(blob16)
    with pytest.raises(ValueError, match="layout"):
        TConn.scatter_blocks(bf, DST_BLOCKS, blob8)
    with pytest.raises(ValueError, match="layout"):
        TConn.scatter_blocks(q8, DST_BLOCKS, blob16)
    tampered = bytearray(blob8)
    hdr = list(TConn._HEADER.unpack_from(bytes(tampered), 0))
    hdr[1] = TConn._WIRE_VERSION + 1
    tampered[:TConn._HEADER.size] = TConn._HEADER.pack(*hdr)
    with pytest.raises(ValueError, match="version"):
        TConn.scatter_blocks(q8, DST_BLOCKS, bytes(tampered))
    # A structurally valid slab whose dtype code lies: named rejection,
    # and nothing is written.
    tampered = bytearray(blob8)
    width, code = struct.unpack_from("<IB", bytes(tampered),
                                     TConn._HEADER.size)
    struct.pack_into("<IB", tampered, TConn._HEADER.size, width,
                     0 if code != 0 else 1)
    before = {n: t.clone() for n, t in q8.kv_cache.items()}
    with pytest.raises(ValueError, match="shipped"):
        TConn.scatter_blocks(q8, DST_BLOCKS, bytes(tampered))
    assert all(torch.equal(before[n], t) for n, t in q8.kv_cache.items())
    with pytest.raises(ValueError, match="truncated"):
        TConn.scatter_blocks(q8, DST_BLOCKS, blob8[:-1])


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

SERVERS = {
    "py": (transport.PyTransferServer, transport.py_fetch,
           transport.py_release),
    "native": (transport.NativeTransferServer, transport.native_fetch,
               transport.native_release),
}


def _roundtrip(server, fetch, release):
    try:
        blob = bytes(range(256)) * 1000
        server.register("req-1", blob)
        assert fetch("127.0.0.1", server.port, "req-1") == blob
        with pytest.raises(JTransport.TransferNotFound
                           if fetch.__module__.startswith("llm_d_tpu.")
                           else transport.TransferNotFound):
            fetch("127.0.0.1", server.port, "missing")
        assert release("127.0.0.1", server.port, "req-1")
        deadline = time.time() + 5
        released = []
        while time.time() < deadline and not released:
            released = server.drain_released()
        assert released == ["req-1"]
    finally:
        server.close()


@pytest.mark.parametrize("kind", sorted(SERVERS))
def test_transport_roundtrip_on_the_port_servers(kind):
    if kind == "native":
        assert transport._load_native() is not None, "g++ build failed"
    server_cls, fetch, release = SERVERS[kind]
    _roundtrip(server_cls("127.0.0.1", 0), fetch, release)
    # The other client against the same kind of server.
    other = SERVERS["py" if kind == "native" else "native"]
    _roundtrip(server_cls("127.0.0.1", 0), other[1], other[2])


@pytest.mark.parametrize("kind", sorted(SERVERS))
def test_transport_crosses_packages(kind):
    """A port client against a JAX server and a JAX client against a port
    server (the native library of each package, or the Python ends)."""
    jsrv = {"py": JTransport.PyTransferServer,
            "native": JTransport.NativeTransferServer}[kind]
    jfetch = {"py": (JTransport.py_fetch, JTransport.py_release),
              "native": (JTransport.native_fetch,
                         JTransport.native_release)}[kind]
    if kind == "native" and JTransport._load_native() is None:
        pytest.skip("the JAX package's native transport did not build")
    _roundtrip(jsrv("127.0.0.1", 0), *SERVERS[kind][1:])
    _roundtrip(SERVERS[kind][0]("127.0.0.1", 0), *jfetch)


# ---------------------------------------------------------------------------
# P/D greedy parity
# ---------------------------------------------------------------------------

PD_CASES = {
    "tiny": dict(model="tiny"),
    "tiny-mla-int8": dict(model="tiny-mla", quantization="int8",
                          kv_cache_dtype="int8"),
    "tiny-async-k4": dict(model="tiny", num_scheduler_steps=4,
                          async_scheduling=True),
    "tiny-spec2": dict(model="tiny", spec_k=2),
}


@pytest.fixture(scope="module")
def jax_params():
    return {m: JEngineCore(JEngineConfig(model=m, **ENGINE_KW)).params
            for m in ("tiny", "tiny-mla")}


def _port_engine(kw, jparams, role=None, **conn):
    jeng_params = jparams[kw["model"]]
    eng = EngineCore(EngineConfig(device="cpu", **ENGINE_KW, **kw),
                     params=port_tree(jeng_params))
    if role is not None:
        eng.kv_connector = TpuConnector(KVConnectorConfig(
            kv_role=role, host="127.0.0.1", **conn))
    return eng


def _prefill_remote(producer, prompts, R=Request, SP=SamplingParams,
                    done=RequestState.FINISHED_REMOTE_PREFILL):
    reqs = [greedy(rid, p, 1, R=R, SP=SP, do_remote_decode=True)
            for rid, p in prompts.items()]
    for r in reqs:
        producer.add_request(r)
    _drive(producer, lambda: all(r.state == done for r in reqs))
    for r in reqs:
        assert r.kv_transfer_params["remote_block_ids"] == r.block_ids
        assert r.request_id in producer.pinned_transfers
    return {r.request_id: r.kv_transfer_params for r in reqs}


def _decode_remote(consumer, prompts, params, n=6, R=Request,
                   SP=SamplingParams, reqs_out=None):
    reqs = [greedy(rid, p, n, R=R, SP=SP, do_remote_prefill=True,
                   kv_transfer_params=params[rid])
            for rid, p in prompts.items()]
    if reqs_out is not None:
        reqs_out.extend(reqs)
    return consumer.generate(reqs)


def _released(producer):
    _drive(producer, lambda: not producer.pinned_transfers)
    assert producer.kv_manager.usage == 0.0


@pytest.mark.parametrize("case", sorted(PD_CASES))
def test_pd_tokens_equal_the_single_engine(case, jax_params):
    kw = PD_CASES[case]
    single = _port_engine(kw, jax_params)
    expected = single.generate([greedy(rid, p) for rid, p in PROMPTS.items()])
    producer = _port_engine(kw, jax_params, "kv_producer")
    consumer = _port_engine(kw, jax_params, "kv_consumer")
    try:
        params = _prefill_remote(producer, PROMPTS)
        reqs = []
        got = _decode_remote(consumer, PROMPTS, params, reqs_out=reqs)
        assert got == expected
        _released(producer)
        text = consumer.metrics.render().decode()
        assert f'llmd_tpu:kv_transfer_seconds_count{{model_name="' \
            f'{consumer.model_config.name}"}} {len(PROMPTS)}' in text
        if kw.get("num_scheduler_steps", 1) > 1:
            # The admitted rows' decode ran in blocks after their 1-token
            # prefill step.
            assert consumer._step_count > consumer._dispatch_count
        if kw.get("spec_k"):
            # The consumer speculated from its first decode step on.
            assert sum(r.spec_drafted for r in reqs) > 0
    finally:
        producer.kv_connector.close()
        consumer.kv_connector.close()


def test_pd_across_packages(jax_params):
    """JAX producer -> port consumer and port producer -> JAX consumer,
    both with the JAX single engine's tokens."""
    jsingle = JEngineCore(JEngineConfig(model="tiny", **ENGINE_KW),
                          params=jax_params["tiny"])
    expected = jsingle.generate([greedy(rid, p, R=JRequest,
                                        SP=JSamplingParams)
                                 for rid, p in PROMPTS.items()])
    jprod = JEngineCore(JEngineConfig(model="tiny", **ENGINE_KW),
                        params=jax_params["tiny"])
    jprod.kv_connector = JTpuConnector(JKVConnectorConfig(
        kv_role="kv_producer", host="127.0.0.1"))
    jcons = JEngineCore(JEngineConfig(model="tiny", **ENGINE_KW),
                        params=jax_params["tiny"])
    jcons.kv_connector = JTpuConnector(JKVConnectorConfig(
        kv_role="kv_consumer"))
    tprod = _port_engine(dict(model="tiny"), jax_params, "kv_producer")
    tcons = _port_engine(dict(model="tiny"), jax_params, "kv_consumer")
    try:
        params = _prefill_remote(jprod, PROMPTS, R=JRequest,
                                 SP=JSamplingParams,
                                 done=JRequestState.FINISHED_REMOTE_PREFILL)
        assert _decode_remote(tcons, PROMPTS, params) == expected
        _released(jprod)
        params = _prefill_remote(tprod, PROMPTS)
        assert _decode_remote(jcons, PROMPTS, params, R=JRequest,
                              SP=JSamplingParams) == expected
        _released(tprod)
    finally:
        for e in (jprod, jcons, tprod, tcons):
            e.kv_connector.close()


# ---------------------------------------------------------------------------
# mirrors of tests/test_pd.py
# ---------------------------------------------------------------------------

def test_pd_block_aligned_prompt(jax_params):
    prompt = {"pd-8": [7, 8, 9, 10, 11, 12, 13, 14]}   # 2 full blocks
    kw = dict(model="tiny")
    expected = _port_engine(kw, jax_params).generate(
        [greedy("pd-8", prompt["pd-8"], 4)])
    producer = _port_engine(kw, jax_params, "kv_producer")
    consumer = _port_engine(kw, jax_params, "kv_consumer")
    try:
        params = _prefill_remote(producer, prompt)
        assert _decode_remote(consumer, prompt, params, n=4) == expected
    finally:
        producer.kv_connector.close()
        consumer.kv_connector.close()


def test_missing_connector_fails_loudly(jax_params):
    engine = _port_engine(dict(model="tiny"), jax_params)
    req = greedy("orphan", [1, 2, 3], 4, do_remote_prefill=True,
                 kv_transfer_params={"remote_host": "h", "remote_port": 1,
                                     "uuid": "orphan"})
    prod = greedy("nopin", [1, 2, 3], 1, do_remote_decode=True)
    engine.add_request(req)
    engine.add_request(prod)
    outs = engine.step()
    assert sorted(o.request_id for o in outs if o.finished
                  and o.finish_reason == "abort") == ["nopin", "orphan"]
    assert req.state == prod.state == RequestState.FINISHED_ABORTED
    assert not engine.has_work()


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()      # nothing listens here now
    return port


@pytest.mark.parametrize("policy", ["fail", "recompute"])
def test_kv_load_failure_policy(policy, jax_params):
    """Unreachable producer: "fail" aborts the request and the engine
    lives on; "recompute" prefills locally, with the single engine's
    tokens."""
    prompt = [5, 4, 3, 2, 1]
    expected = _port_engine(dict(model="tiny"), jax_params).generate(
        [greedy("b", prompt, 4)])["b"]
    consumer = _port_engine(dict(model="tiny"), jax_params, "kv_consumer",
                            kv_load_failure_policy=policy, timeout_ms=2000,
                            pull_retries=0)
    try:
        req = greedy("x", prompt, 4, do_remote_prefill=True,
                     kv_transfer_params={"remote_host": "127.0.0.1",
                                         "remote_port": _dead_port(),
                                         "uuid": "x"})
        out = consumer.generate([req])
        if policy == "fail":
            assert req.state == RequestState.FINISHED_ABORTED
            assert out["x"] == []
        else:
            assert out["x"] == expected
        assert not consumer.scheduler.has_work()
        assert consumer.kv_manager.usage == 0.0
    finally:
        consumer.kv_connector.close()


def test_producer_pin_timeout_releases_blocks(jax_params):
    producer = _port_engine(dict(model="tiny"), jax_params, "kv_producer",
                            pin_timeout_s=0.2)
    try:
        _prefill_remote(producer, {"ghost": [1, 2, 3, 4, 5]})
        assert producer.kv_manager.usage > 0
        deadline = time.time() + 5
        while time.time() < deadline and "ghost" in producer.pinned_transfers:
            producer.step()
            time.sleep(0.02)
        assert "ghost" not in producer.pinned_transfers
        assert producer.kv_manager.usage == 0.0
        with pytest.raises(transport.TransferNotFound):
            transport.fetch("127.0.0.1", producer.kv_connector.port, "ghost")
    finally:
        producer.kv_connector.close()


@pytest.mark.parametrize("model", ["tiny", "tiny-mla-int8"])
@pytest.mark.parametrize("drops,fallback", [(1, False), (3, True)])
def test_injected_pull_drops_recover(model, drops, fallback, jax_params):
    """Deterministic pull drops (the ``kv.pull`` fault point, a fixed
    count): one drop is absorbed by the retry budget, three exhaust it and
    the ``recompute`` policy prefills locally; either way each request
    gives the single engine's tokens.  On ``tiny`` and on ``tiny-mla``
    with an int8 latent (the JAX package's int8-latent chaos case draws
    its drops at random)."""
    from llm_d_tpu_torch.utils import faultinject
    kw = PD_CASES[model]
    single = _port_engine(kw, jax_params)
    prompts = {f"drop-{i}": [5 + i, 1, 4, 1, 5, 9, 2 + i] for i in range(3)}
    expected = single.generate([greedy(rid, p) for rid, p in
                                prompts.items()])
    producer = _port_engine(kw, jax_params, "kv_producer")
    consumer = _port_engine(kw, jax_params, "kv_consumer",
                            kv_load_failure_policy="recompute",
                            pull_retries=2, pull_backoff_s=0.01)
    inj = faultinject.install(faultinject.FaultInjector(seed=0))
    try:
        for rid, prompt in prompts.items():
            params = _prefill_remote(producer, {rid: prompt})
            inj.clear()
            inj.add_rule("kv.pull", count=drops)
            got = _decode_remote(consumer, {rid: prompt}, params)
            assert got[rid] == expected[rid], rid
            assert inj.stats()["kv.pull"]["fired"] == drops
        transfers = 0 if fallback else len(prompts)
        text = consumer.metrics.render().decode()
        assert f'llmd_tpu:kv_transfer_seconds_count{{model_name="' \
            f'{consumer.model_config.name}"}} {transfers}' in text
    finally:
        faultinject.reset()
        producer.kv_connector.close()
        consumer.kv_connector.close()


# ---------------------------------------------------------------------------
# the JAX sidecar in front of two port servers
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Loop:
    """An event loop in a daemon thread."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)


@pytest.fixture(scope="module")
def pd_stack(jax_params):
    from aiohttp import web
    from llm_d_tpu.sidecar.proxy import RoutingSidecar
    loop = _Loop()
    apps, closers = {}, []
    engines = {}
    for role in ("kv_producer", "kv_consumer"):
        eng = _port_engine(dict(model="tiny"), jax_params, role)
        engines[role] = eng
        app = TServer.build_server(None, engine=eng, model_name="tiny") \
            .build_app()
        apps[role] = loop.run(app.start("127.0.0.1", 0))
        closers.append(app.close)
    sidecar = RoutingSidecar(
        f"http://127.0.0.1:{apps['kv_consumer']}",
        static_prefiller=f"127.0.0.1:{apps['kv_producer']}")
    runner = web.AppRunner(sidecar.build_app())
    port = _free_port()

    async def start():
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
    loop.run(start())
    url = f"http://127.0.0.1:{port}"
    for _ in range(200):
        try:
            if requests.get(url + "/v1/models", timeout=5).status_code \
                    == 200:
                break
        except requests.ConnectionError:
            pass
        time.sleep(0.05)
    yield dict(url=url, engines=engines,
               prefill=f"http://127.0.0.1:{apps['kv_producer']}")
    loop.run(runner.cleanup())
    for close in closers:
        loop.run(close())
    loop.close()
    for eng in engines.values():
        eng.kv_connector.close()


def test_sidecar_pd_completion(pd_stack, jax_params):
    url, engines = pd_stack["url"], pd_stack["engines"]
    prompt = [11, 22, 33, 44, 55, 66]
    base = _port_engine(dict(model="tiny"), jax_params).generate(
        [greedy("side-base", prompt, 5)])["side-base"]
    r = requests.post(url + "/v1/completions", json={
        "model": "tiny", "prompt": prompt, "max_tokens": 5,
        "temperature": 0.0, "ignore_eos": True}, timeout=120)
    assert r.status_code == 200, r.text
    body = r.json()
    assert body["usage"]["completion_tokens"] == 5
    from llm_d_tpu_torch.utils.tokenizer import get_tokenizer
    assert body["choices"][0]["text"] == get_tokenizer(None).decode(base)
    # The decode ran on the consumer from the producer's blocks.
    text = engines["kv_consumer"].metrics.render().decode()
    assert 'llmd_tpu:kv_transfer_seconds_count{model_name="tiny"} 1' in text
    _released(engines["kv_producer"])


def test_producer_server_answers_with_transfer_params(pd_stack):
    """The producer's final body, and its last streamed chunk, carry the
    ``kv_transfer_params`` the JAX server returns: the pinned blocks, the
    connector's address and the uuid (and the first token)."""
    prod = pd_stack["engines"]["kv_producer"]
    keys = {"remote_block_ids", "remote_host", "remote_port", "uuid",
            "first_token"}
    for stream in (False, True):
        r = requests.post(pd_stack["prefill"] + "/v1/completions", json={
            "model": "tiny", "prompt": [1, 2, 3, 4, 5], "max_tokens": 1,
            "temperature": 0.0, "stream": stream,
            "kv_transfer_params": {"do_remote_decode": True}}, timeout=60)
        assert r.status_code == 200, r.text
        if stream:
            frames = [json.loads(ln[6:]) for ln in r.text.splitlines()
                      if ln.startswith("data: {")]
            params = frames[-1]["kv_transfer_params"]
            assert all("kv_transfer_params" not in f for f in frames[:-1])
        else:
            body = r.json()
            params = body["kv_transfer_params"]
            assert body["choices"][0]["finish_reason"] == "remote_prefill"
        assert set(params) == keys
        assert params["remote_port"] == prod.kv_connector.port
        assert params["remote_host"] == "127.0.0.1"
        assert len(params["remote_block_ids"]) == 2      # 5 tokens, bs 4
        transport.fetch("127.0.0.1", params["remote_port"], params["uuid"])
        assert transport.release("127.0.0.1", params["remote_port"],
                                 params["uuid"])
    _released(prod)


def test_sidecar_passthrough_probes(pd_stack):
    url = pd_stack["url"]
    assert requests.get(url + "/health", timeout=10).status_code == 200
    r = requests.get(url + "/metrics", timeout=10)
    assert r.status_code == 200
    assert "vllm:kv_cache_usage_perc" in r.text
