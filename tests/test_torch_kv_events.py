"""Port parity: KV-cache events (``llm_d_tpu_torch.events.kv_events``)
into the JAX EPP's precise prefix index (``llm_d_tpu.epp.indexer``).

* In process: the port engine's BlockStored / BlockRemoved events, through
  the port's ``InprocKvEventSink``, leave the JAX EPP's ``PrefixIndex`` as
  the JAX engine's events leave it (same blocks, same owners), on
  ``tiny`` with the prefix cache on and a pool small enough that later
  waves evict earlier prefixes.
* Over ZMQ: the port's ``ZmqKvEventPublisher`` and the JAX package's, both
  on 127.0.0.1, into the JAX EPP's ``ZmqEventSubscriber``: the index
  scores the port pod's prefixes as it scores the JAX pod's.
* The server's ``--kv-events-endpoint`` / ``--pod-identity``: the
  publisher's topic, with the pod identity given or guessed from the
  host for a wildcard ``--host``, as the JAX server builds it.
"""

import socket
import time

import jax
import numpy as np

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.epp.indexer import PrefixIndex, ZmqEventSubscriber
from llm_d_tpu.events import kv_events as jevents
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.events import kv_events as tevents
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.server import openai as TServer

import torch

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ENGINE_KW = dict(model="tiny", block_size=4, num_blocks=12, max_num_seqs=4,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4, enable_prefix_caching=True)


def _pair():
    jeng = JEngineCore(JEngineConfig(**ENGINE_KW))
    teng = EngineCore(EngineConfig(device="cpu", **ENGINE_KW),
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jeng.params), "cpu"))
    return jeng, teng


def _waves(engine, R, SP):
    """Three waves of two requests: the third re-asks the first wave's
    prompts after the second has evicted part of their blocks."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 250, 14).tolist() for _ in range(4)]
    out = {}
    for w, ps in enumerate((prompts[:2], prompts[2:], prompts[:2])):
        out.update(engine.generate([
            R(request_id=f"w{w}r{i}", prompt_token_ids=list(p),
              sampling=SP(temperature=0.0, max_tokens=6, ignore_eos=True))
            for i, p in enumerate(ps)]))
    return out, prompts


def _index_state(index):
    return {h: sorted(owners) for h, owners in index._blocks.items()}


def test_inproc_events_leave_the_jax_index():
    jeng, teng = _pair()
    jindex, tindex = PrefixIndex(), PrefixIndex()
    jevents.InprocKvEventSink(jindex, "pod").attach(jeng.kv_manager)
    tevents.InprocKvEventSink(tindex, "pod").attach(teng.kv_manager)
    removed = []
    teng.kv_manager.on_block_removed.append(lambda h, b: removed.append(h))
    want, _ = _waves(jeng, JRequest, JSamplingParams)
    got, _ = _waves(teng, Request, SamplingParams)
    assert got == want
    assert removed and teng.kv_manager.eviction_count > 0
    assert _index_state(tindex) == _index_state(jindex)
    assert tindex.size == jindex.size > 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_zmq_events_score_the_port_pod_as_a_jax_pod():
    jeng, teng = _pair()
    endpoint = f"tcp://127.0.0.1:{_free_port()}"
    index = PrefixIndex()
    sub = ZmqEventSubscriber(index, bind=endpoint)
    sub.start()
    pubs = [jevents.ZmqKvEventPublisher(endpoint, "jax-pod", model="tiny"),
            tevents.ZmqKvEventPublisher(endpoint, "port-pod", model="tiny")]
    pubs[0].attach(jeng.kv_manager)
    pubs[1].attach(teng.kv_manager)
    try:
        for p in pubs:
            p.start()
        time.sleep(0.5)                 # the SUB side sees both connects
        _, prompts = _waves(jeng, JRequest, JSamplingParams)
        _waves(teng, Request, SamplingParams)
        keys = [teng.kv_manager.request_block_hashes(Request(
            request_id=f"q{i}", prompt_token_ids=p,
            sampling=SamplingParams())) for i, p in enumerate(prompts)]
        for _ in range(100):
            scores = [(index.longest_prefix(k, "jax-pod"),
                       index.longest_prefix(k, "port-pod")) for k in keys]
            if all(a == b for a, b in scores) and any(a for a, _ in scores):
                break
            time.sleep(0.05)
        assert all(a == b for a, b in scores), scores
        assert any(a for a, _ in scores)
        jkeys = {h for h, o in index._blocks.items() if "jax-pod" in o}
        tkeys = {h for h, o in index._blocks.items() if "port-pod" in o}
        assert tkeys == jkeys
    finally:
        for p in pubs:
            p.stop()
        sub.stop()


def test_the_server_builds_the_publisher_as_the_jax_server():
    p = TServer.build_arg_parser()
    args = p.parse_args(["--model", "tiny", "--kv-events-endpoint",
                         "tcp://epp:5557", "--pod-identity", "10.0.0.3:8200"])
    pub = TServer.kv_event_publisher_from_args(args)
    assert (pub.endpoint, pub.topic) == ("tcp://epp:5557",
                                         b"kv@10.0.0.3:8200@tiny")
    args = p.parse_args(["--model", "tiny", "--kv-events-endpoint",
                         "tcp://epp:5557", "--port", "8311"])
    host = socket.gethostbyname(socket.gethostname())
    assert TServer.kv_event_publisher_from_args(args).topic == \
        f"kv@{host}:8311@tiny".encode()
    args = p.parse_args(["--kv-events-endpoint", "tcp://epp:5557",
                         "--host", "127.0.0.1", "--port", "8311"])
    assert TServer.kv_event_publisher_from_args(args).topic == \
        b"kv@127.0.0.1:8311@tiny"
    assert TServer.kv_event_publisher_from_args(p.parse_args([])) is None
