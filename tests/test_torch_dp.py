"""Port parity: the DP engine group (``--data-parallel-mode ranks``): two
one-device engine cores behind the least-loaded dispatcher
(``engine/dp_group.DPEngineGroup``), and the server's data-parallel
flags in both modes.

* The group's greedy tokens equal the JAX engine's and the port's single
  engine's on the same weights; each rank holds its own whole pool
  (tp = 1 a rank) on its device, and the ranks share rank 0's weights
  where they share the device.
* Dispatch balances the load, an abort reaches the owning rank, and the
  gauges add up every rank's.
* ``--data-parallel-size 2 --device cpu`` serves replies (token-id and
  text prompts, a streamed one) equal to the one-engine server's, in spmd
  mode (two rank processes, a ``MeshConfig(dp=2)`` mesh) and in ranks
  mode; the spmd server exits 0 on SIGTERM with no rank left.
* What stays refused is refused by name before anything starts: ranks
  mode's multi-host flags in spmd mode (they serve ranks mode:
  ``tests/test_torch_dp_multihost.py``), ranks mode with
  ``--tensor-parallel-size`` > 1 and the shared KV tier on the mesh; a
  group asked for more devices than it was given.  A
  ``--data-parallel-size-local`` below the size in spmd mode is served
  (one host holds the mesh outside an LWS group).
"""

import signal
import time

import numpy as np
import pytest
import requests
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.dp_group import DPEngineGroup
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams

from test_torch_tp_server import (GREEDY, TIMEOUT, _alive, _children,
                                  _frames, _Server, _strip)

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ENGINE_KW = dict(model="tiny", device="cpu", block_size=4, num_blocks=64,
                 max_num_seqs=8, max_num_batched_tokens=64,
                 min_token_bucket=16, min_seq_bucket=4)
PROMPTS = {
    "r1": [2, 4, 6, 8, 10],
    "r2": [100, 90, 80, 70, 60, 50],
    "r3": [7, 14, 21],
    "r4": [11, 13, 17, 19, 23, 29, 31],
    "r5": [1, 2, 3, 4],
    "r6": [42],
    "r7": [5, 10, 15, 20, 25, 30, 35, 40],
    "r8": [99, 98, 97],
}


def greedy_req(rid, prompt, n=6):
    return Request(rid, list(prompt), SamplingParams(
        temperature=0.0, max_tokens=n, ignore_eos=True))


@pytest.fixture(scope="module")
def jax_run(devices):
    """The JAX engine's tokens for ``PROMPTS`` and its weights."""
    import jax
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    kw = {k: v for k, v in ENGINE_KW.items() if k != "device"}
    e = JEngineCore(JEngineConfig(**kw))
    out = e.generate([JRequest(request_id=r, prompt_token_ids=list(p),
                               sampling=JSamplingParams(
                                   temperature=0.0, max_tokens=6,
                                   ignore_eos=True))
                      for r, p in PROMPTS.items()])
    return out, jax.tree.map(np.asarray, e.params)


@pytest.fixture(scope="module")
def group(jax_run):
    g = DPEngineGroup(EngineConfig(**ENGINE_KW), dp_size=2,
                      params=params_from_numpy(jax_run[1], "cpu"))
    yield g
    g.close()


def test_group_tokens_equal_the_jax_engine_and_a_single_engine(jax_run,
                                                               group):
    want, tree = jax_run
    single = EngineCore(EngineConfig(**ENGINE_KW),
                        params=params_from_numpy(tree, "cpu"))
    assert single.generate([greedy_req(r, p) for r, p in PROMPTS.items()]) \
        == want
    reqs = [greedy_req(r, p) for r, p in PROMPTS.items()]
    assert group.generate(reqs) == want
    assert not group.has_work()


def test_each_rank_holds_its_own_pool(group):
    """tp = 1 a rank: every rank's K/V is the whole ``[L, slots, W]``
    pool of its own, on its device; the ranks share rank 0's weights
    where they share the device."""
    slots = ENGINE_KW["num_blocks"] * ENGINE_KW["block_size"]
    assert len(group.engines) == 2
    k0, k1 = (e.kv_cache["k"] for e in group.engines)
    assert k0.shape == k1.shape == (2, slots, 32)
    assert k0.data_ptr() != k1.data_ptr()
    assert all(e.device == torch.device("cpu") for e in group.engines)
    assert group.engines[1].params["embed"] is group.engines[0].params["embed"]
    assert group.kv_managers == [e.kv_manager for e in group.engines]


def test_dispatch_balances_load(group):
    reqs = [greedy_req(f"lb-{i}", [i + 1, i + 2, i + 3], 3) for i in range(4)]
    for r in reqs:
        group.add_request(r)
    per_rank = [e.scheduler.num_waiting + e.scheduler.num_running
                for e in group.engines]
    assert per_rank == [2, 2]
    while group.has_work():
        group.step()
    assert all(len(r.output_token_ids) == 3 for r in reqs)


def test_abort_routes_to_the_owning_rank(group):
    group.add_request(greedy_req("other", [3, 2, 1], 50))
    r = greedy_req("kill-me", [1, 2, 3], 50)
    group.add_request(r)
    owner = group._rank_of["kill-me"]
    group.step()
    calls = []
    for i, e in enumerate(group.engines):
        real = e.abort_request
        e.abort_request = (lambda rid, real=real, i=i:
                           (calls.append(i), real(rid)))
    try:
        group.abort_request("kill-me")
    finally:
        for e in group.engines:
            del e.abort_request
    assert calls == [owner]
    assert all(rr.request_id != "kill-me"
               for e in group.engines for rr in e.scheduler.running)
    group.abort_request("other")
    while group.has_work():
        group.step()


def test_aggregated_gauges(group):
    reqs = [greedy_req(f"g-{i}", [i + 1] * 3, 4) for i in range(4)]
    for r in reqs:
        group.add_request(r)
    group.step()
    text = group.metrics.render().decode()

    def gauge(name):
        return [float(ln.split()[-1]) for ln in text.splitlines()
                if ln.startswith(name)]
    assert gauge("vllm:num_requests_running") == [4.0]
    assert [e.scheduler.num_running for e in group.engines] == [2, 2]
    usage = sum(e.kv_manager.usage for e in group.engines) / 2
    assert usage > 0
    assert gauge("vllm:kv_cache_usage_perc") == [pytest.approx(usage)]
    while group.has_work():
        group.step()


def test_set_kv_connectors_gives_each_rank_its_own(group):
    """P/D on a group: a connector a rank, each with its own transfer
    server (ephemeral ports differ); one connector for the whole group is
    refused."""
    from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
    group.set_kv_connectors(KVConnectorConfig(kv_role="kv_producer"))
    try:
        conns = group.kv_connectors
        assert len(conns) == 2 and conns[0] is not conns[1]
        assert conns[0].port and conns[1].port and \
            conns[0].port != conns[1].port
        assert group.kv_connector is conns[0]
    finally:
        group.close_kv_connectors()
        for e in group.engines:
            e.kv_connector = None
    with pytest.raises(ValueError, match="set_kv_connectors"):
        group.kv_connector = TpuConnector(KVConnectorConfig(
            kv_role="kv_consumer"))


def test_a_group_refuses_what_it_does_not_serve():
    from llm_d_tpu_torch.parallel.mesh import MeshConfig
    with pytest.raises(ValueError, match="tp=2"):
        DPEngineGroup(EngineConfig(**dict(ENGINE_KW, mesh=MeshConfig(tp=2))),
                      dp_size=2)
    with pytest.raises(ValueError, match="needs 2 devices, got 1"):
        DPEngineGroup(EngineConfig(**ENGINE_KW), dp_size=2,
                      devices=[torch.device("cpu")])


# The multi-host flags are served in ranks mode; in spmd mode the refusal
# names each of them as ranks mode's.  A --data-parallel-size-local below
# the size in spmd mode is served as the JAX server serves it (one host
# holds the whole mesh outside an LWS group: tests/test_torch_lws.py).
SPMD_ACROSS_HOSTS = ["--data-parallel-size-local", "1"]


@pytest.mark.parametrize("flags,named", [
    (SPMD_ACROSS_HOSTS + ["--data-parallel-start-rank", "1"],
     "--data-parallel-start-rank"),
    (SPMD_ACROSS_HOSTS + ["--data-parallel-address", "leader:8200"],
     "--data-parallel-address"),
    (SPMD_ACROSS_HOSTS + ["--data-parallel-rpc-port", "9000"],
     "--data-parallel-rpc-port"),
    (SPMD_ACROSS_HOSTS + ["--data-parallel-hybrid-lb"],
     "--data-parallel-hybrid-lb"),
    (SPMD_ACROSS_HOSTS + ["--data-parallel-workers", "w1:8200"],
     "--data-parallel-workers"),
    # Served since: the case keeps its id.
    pytest.param(["--data-parallel-size-local", "1"], None,
                 id="flags5---data-parallel-size-local"),
    (["--data-parallel-mode", "ranks", "--tensor-parallel-size", "2"],
     "--data-parallel-mode ranks"),
    # Served since (the shared tier on a mesh): the case keeps its id.
    pytest.param(["--tensor-parallel-size", "2", "--kv-offload-blocks", "8",
                  "--kv-shared-tier-port", "0"], None,
                 id="flags7---kv-shared-tier-port")])
def test_what_dp_does_not_serve_is_refused_by_name(flags, named, capsys):
    """``named`` None: a layout served since, accepted without a word."""
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    args = p.parse_args(["--data-parallel-size", "2", "--device", "cpu"]
                        + flags)
    if named is None:
        TServer.check_served(p, args)
        TServer.check_mesh_flags(p, args)
        assert capsys.readouterr().err == ""
        return
    with pytest.raises(SystemExit) as e:
        TServer.check_served(p, args)
        TServer.check_mesh_flags(p, args)
    assert e.value.code == 2
    assert named in capsys.readouterr().err


# ---------- the server ----------

DP_FLAGS = ["--data-parallel-size", "2"]


@pytest.fixture(scope="module")
def servers():
    one = _Server()
    spmd = _Server(DP_FLAGS)
    ranks = _Server(DP_FLAGS + ["--data-parallel-mode", "ranks"])
    try:
        for s in (one, spmd, ranks):
            s.wait_ready()
        yield one, spmd, ranks
    finally:
        for s in (one, spmd, ranks):
            s.close()


@pytest.mark.parametrize("mode", ["spmd", "ranks"])
def test_dp_server_replies_equal_the_one_engine_server(servers, mode):
    one, spmd, ranks = servers
    srv = spmd if mode == "spmd" else ranks
    assert requests.get(srv.url + "/health", timeout=TIMEOUT).status_code \
        == 200
    for prompt, n in (([1, 2, 3], 5), ([40, 41, 42, 43, 44, 45, 46], 9),
                      ("hello data", 6)):
        body = dict(GREEDY, prompt=prompt, max_tokens=n)
        a, b = (requests.post(s.url + "/v1/completions", json=body,
                              timeout=TIMEOUT) for s in (one, srv))
        assert a.status_code == b.status_code == 200
        assert _strip(b.json()) == _strip(a.json())
    body = dict(GREEDY, prompt=[9, 8, 7], max_tokens=6, stream=True)
    a, b = (_frames(requests.post(s.url + "/v1/completions", json=body,
                                  stream=True, timeout=TIMEOUT))
            for s in (one, srv))
    assert [f["llmd"]["tok"] for f in b[:-1]] == \
        [f["llmd"]["tok"] for f in a[:-1]]
    assert b[-1] == a[-1] == "DONE"


def test_spmd_dp_server_sigterm_stops_every_rank_and_exits_0(servers):
    _, spmd, _ = servers
    ranks = _children(spmd.proc.pid)
    assert ranks, "rank 1 is not a child of the server"
    spmd.proc.send_signal(signal.SIGTERM)
    assert spmd.proc.wait(timeout=60) == 0, spmd.log()
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in ranks) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in ranks if _alive(p)]
