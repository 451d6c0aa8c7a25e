"""Port parity: the EPP's precise prefix index (``llm_d_tpu_torch.epp.
indexer``: ``PrefixIndex``, ``RestorePlan``, ``ZmqEventSubscriber``)
against the JAX package's, on the CPU.

* In process: seeded event streams (BlockStored on device and host
  tiers with byte sizes, BlockRemoved, AllBlocksCleared, a departed
  endpoint, an LRU small enough to evict) leave both indexes with the
  same blocks and owners, and every ``longest_prefix`` /
  ``restorable_prefix`` query answers alike, with the same
  ``inference_extension_prefix_indexer_*`` gauges and
  ``llmd_tpu:kv_events_total`` counts.
* Over ZMQ: one KV-event stream from the port engine's
  ``ZmqKvEventPublisher`` (``tiny``, prefix caching on, waves that evict)
  reaches the JAX subscriber and the port's, each bound on 127.0.0.1:
  both indexes hold the same blocks and answer every query alike.
"""

import re
import socket
import time

import numpy as np
import pytest
import torch

from llm_d_tpu.epp import indexer as jindexer
from llm_d_tpu.utils.metrics import EppMetrics as JEppMetrics
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.epp import indexer as tindexer
from llm_d_tpu_torch.events import kv_events as tevents
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.utils.hashing import hash_token_blocks
from llm_d_tpu_torch.utils.metrics import EppMetrics as TEppMetrics

# One intra-op thread: the suite's parallel workers, each with a thread
# pool as wide as the machine, would oversubscribe its cores.
torch.set_num_threads(1)

PODS = ["10.0.0.1:8200", "10.0.0.2:8200", "10.0.0.3:8200", "[::1]:8200"]


def _state(index):
    with index._lock:
        return [(h, dict(o)) for h, o in index._blocks.items()]


def _metrics(m):
    text = m.render().decode()
    return [ln for ln in text.splitlines()
            if "indexer" in ln or "kv_events" in ln
            if not re.search(r"_created", ln)]


def _queries(rng, chains, index_pair, pods=PODS):
    """Every pod's longest / restorable prefix of every chain and of its
    random cuts, on both indexes in turn."""
    out = []
    for keys in chains:
        for cut in (len(keys), int(rng.integers(0, len(keys) + 1))):
            for pod in list(pods) + ["10.9.9.9:1"]:
                got = []
                for idx in index_pair:
                    plan = idx.restorable_prefix(keys[:cut], pod)
                    got.append((idx.longest_prefix(keys[:cut], pod),
                                plan.local_blocks, plan.peer_blocks,
                                plan.source, plan.tier, plan.nbytes,
                                plan.total_blocks))
                out.append(got)
    return out


@pytest.mark.parametrize("capacity", [40, 100_000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_streams_leave_equal_indexes(seed, capacity):
    rng = np.random.default_rng(seed)
    chains = [hash_token_blocks(rng.integers(1, 500, 64 * n).tolist(), 64)
              for n in (3, 6, 9, 12)]
    pair = [jindexer.PrefixIndex(capacity=capacity, metrics=JEppMetrics()),
            tindexer.PrefixIndex(capacity=capacity, metrics=TEppMetrics())]
    for step in range(60):
        pod = PODS[int(rng.integers(0, len(PODS)))]
        keys = chains[int(rng.integers(0, len(chains)))]
        a = int(rng.integers(0, len(keys)))
        b = int(rng.integers(a, len(keys) + 1))
        kind = rng.choice(["BlockStored"] * 4 + ["BlockRemoved",
                                                 "AllBlocksCleared"])
        tier = "host" if rng.uniform() < 0.3 else "device"
        nbytes = int(rng.integers(0, 8)) << 20
        for idx in pair:
            if kind == "AllBlocksCleared":
                idx.on_event(pod, kind, ())
            else:
                idx.on_event(pod, str(kind), keys[a:b], nbytes=nbytes,
                             tier=tier)
        if step == 40:
            for idx in pair:
                idx.remove_endpoint(PODS[1])
        if step % 10 == 9:
            got = _queries(np.random.default_rng(step), chains, pair)
            assert all(g[0] == g[1] for g in got), step
            assert _state(pair[1]) == _state(pair[0])
            assert pair[1].size == pair[0].size
    assert _metrics(pair[1].metrics) == _metrics(pair[0].metrics)


def test_restore_plans_and_inproc_sinks_alike():
    """``RestorePlan`` carries the same fields and totals; the in-process
    sinks (``attach_inproc``) feed both indexes alike."""
    keys = hash_token_blocks(list(range(64 * 5)), 64)
    pair = [jindexer.PrefixIndex(), tindexer.PrefixIndex()]
    for idx in pair:
        idx.attach_inproc(PODS[0], block_nbytes=7)("BlockStored", keys[:2])
        idx.attach_inproc(PODS[1], block_nbytes=9, tier="host")(
            "BlockStored", keys[:5])
        idx.attach_inproc(PODS[2], block_nbytes=3)("BlockStored", keys[:4])
    plans = [idx.restorable_prefix(keys, PODS[0]) for idx in pair]
    assert [vars(p) for p in plans][0] == [vars(p) for p in plans][1]
    assert plans[1].total_blocks == 5 and plans[1].source == PODS[1]
    assert plans[1].tier == "host" and plans[1].nbytes == 27
    assert tindexer.RestorePlan().total_blocks == 0
    assert tindexer.DEVICE_TIER == jindexer.DEVICE_TIER
    assert tindexer.HOST_TIER == jindexer.HOST_TIER


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_zmq_stream_from_the_port_publisher_feeds_both_indexes():
    pytest.importorskip("zmq")
    pytest.importorskip("msgpack")
    binds = [f"tcp://127.0.0.1:{_free_port()}" for _ in range(2)]
    pair = [jindexer.PrefixIndex(), tindexer.PrefixIndex()]
    subs = [jindexer.ZmqEventSubscriber(pair[0], bind=binds[0]),
            tindexer.ZmqEventSubscriber(pair[1], bind=binds[1])]
    for s in subs:
        s.start()
    eng = EngineCore(EngineConfig(
        device="cpu", model="tiny", block_size=4, num_blocks=12,
        max_num_seqs=4, max_num_batched_tokens=64, min_token_bucket=16,
        min_seq_bucket=4, enable_prefix_caching=True))
    pod = "127.0.0.1:8200"
    pub = tevents.ZmqKvEventPublisher(binds[0], pod_identity=pod, model="m")
    pub.attach(eng.kv_manager)
    pub.start()
    # One publisher socket, connected to both subscribers: one stream.
    pub._sock.connect(binds[1])
    try:
        time.sleep(0.3)                     # the slow joiner
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, 250, 14).tolist() for _ in range(4)]
        waves = [prompts[:2], prompts[2:], prompts[:2]]
        for w, wave in enumerate(waves):
            eng.generate([Request(f"w{w}-{i}", p, SamplingParams(
                temperature=0.0, max_tokens=3, ignore_eos=True))
                for i, p in enumerate(wave)])
        chains = [hash_token_blocks(p, 4) for p in prompts]
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if pub._q.empty() and _state(pair[0]) == _state(pair[1]) \
                    and pair[0].size:
                break
            time.sleep(0.1)
        time.sleep(0.3)
        assert pair[0].size > 0
        assert _state(pair[1]) == _state(pair[0])
        got = _queries(np.random.default_rng(0), chains, pair, [pod])
        assert all(g[0] == g[1] for g in got)
        assert any(g[0][0] for g in got)
        assert {o for _, owners in _state(pair[1]) for o in owners} == {pod}
    finally:
        pub.stop()
        for s in subs:
            s.stop()
