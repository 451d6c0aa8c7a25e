"""Port parity: the shared KV tier (the tiered-prefix-cache recipe's
cross-pod cache, ``deploy/tiered-prefix-cache``) on a port mesh, against
the JAX package's one-device pods built as ``tests/test_offload.py``
builds them, on ``tiny`` and on ``tiny-mla`` with int8 experts and an
int8 latent.  The port's ranks are gloo processes (one pool at a time:
two ranks, then four), each call with a deadline.

* A port ``MeshConfig(tp=2)`` pulls a prefix from a JAX pod's shared-tier
  server: its tokens equal the JAX pod's, ``remote_hits`` > 0, and each
  rank's restored rows equal its tp shard of the JAX pod's slab, bit for
  bit.  Only rank 0 opens a peer connection (``transport.fetch`` counted
  on every rank).
* The reverse: a JAX pod pulls the prefix from the port mesh's server
  (rank 0's), its tokens the mesh's, its restored blobs rank 0's bytes
  (whole rows, as a one-device pod's).
* A ``MeshConfig(dp=2, tp=2)`` consumer restores the prefix into the
  region its request holds: the region's ranks hold their shards of the
  JAX slab, the other region's ranks write nothing.
* An injected ``kv.peer_fetch`` fault and a dead peer are each a miss on
  every rank (no rank loads a block), with the JAX pod's tokens.
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import MeshConfig

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

BS = 4
TIER_KW = dict(block_size=BS, num_blocks=16, max_num_seqs=4,
               max_num_batched_tokens=64, min_token_bucket=16,
               min_seq_bucket=4, kv_offload_blocks=64)
MODELS = {"tiny": {}, "tiny-mla": dict(quantization="int8",
                                       kv_cache_dtype="int8")}
PROMPT = [7, 3, 9, 1, 4, 6, 2, 8, 5, 0, 11, 13, 17]     # 3 full blocks
FILLER = [40, 41, 42, 43, 44, 45]
NEW = 4
# A rank's engines held between the pool's calls (the reverse case's
# server lives on rank 0 while the JAX pod pulls).
HELD = []


class Pools:
    """One rank pool at a time, of the size the next case asks for."""

    def __init__(self):
        self.pool = None

    def __call__(self, world: int) -> RankPool:
        if self.pool is None or self.pool.world != world:
            self.close()
            self.pool = RankPool(world, timeout_s=120)
        return self.pool

    def close(self):
        if self.pool is not None:
            self.pool.close()
            self.pool = None


@pytest.fixture(scope="module")
def pools():
    p = Pools()
    try:
        yield p
    finally:
        p.close()


def greedy(rid, prompt, R=Request, SP=SamplingParams):
    return R(rid, list(prompt), SP(temperature=0.0, max_tokens=NEW,
                                   ignore_eos=True))


def jax_pod(model, **kw):
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    return JEngineCore(JEngineConfig(model=model, **TIER_KW, **MODELS[model],
                                     **kw))


def jax_generate(pod, rid, prompt):
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    return pod.generate([greedy(rid, prompt, JRequest,
                                JSamplingParams)])[rid]


def tree_of(pod):
    import jax
    return jax.tree.map(np.asarray, pod.params)


def jax_slab(pod, blob):
    """A JAX pod's slab (whole rows) as numpy arrays by buffer name."""
    from llm_d_tpu.engine import offload as JOffload
    L = pod.model_config.num_layers
    return JOffload._unpack_block_slab(blob, JOffload._slab_layout(pod), L,
                                       BS)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


# ---------- rank side ----------

def _mesh_engine(model, tree, mesh, **kw):
    return EngineCore(EngineConfig(model=model, device="cpu", mesh=mesh,
                                   **TIER_KW, **MODELS[model], **kw),
                      params=params_from_numpy(tree, "cpu"))


def _spy(eng):
    """Record each restore's rows on this rank (its shard of the block's
    region, None off the region) and count ``transport.fetch`` calls."""
    from llm_d_tpu_torch.engine import offload as TOffload
    km = eng.kv_manager
    restored, fetches = [], [0]
    real_lookup, real_fetch = km.secondary_lookup, TOffload.transport.fetch

    def lookup(h, protected=frozenset(), region=0):
        b = real_lookup(h, protected, region)
        if b is not None:
            rows = None
            if km.region_of_block(b) == eng.dp_index:
                local = km.local_block_id(b)
                rows = {}
                for name, buf in eng.kv_cache.items():
                    r = buf.view(buf.shape[0], -1, BS,
                                 buf.shape[2])[:, local].clone()
                    rows[name] = (r.view(torch.int16) if r.dtype ==
                                  torch.bfloat16 else r).numpy()
            restored.append((h, km.region_of_block(b), rows))
        return b

    def fetch(*a, **kw):
        fetches[0] += 1
        return real_fetch(*a, **kw)

    km.secondary_lookup = lookup
    TOffload.transport.fetch = fetch
    return restored, fetches, lambda: setattr(TOffload.transport, "fetch",
                                              real_fetch)


def rank_pull(model, tree, mesh, peers, fault=False, filler=False):
    """Rank side: a mesh engine with ``peers`` serves ``PROMPT`` (with
    ``filler``, after ``FILLER``'s first step: the filler holds region 0,
    so the prompt takes region 1); with ``fault`` every ``kv.peer_fetch``
    fires."""
    from llm_d_tpu_torch.utils import faultinject
    inj = faultinject.FaultInjector()
    if fault:
        inj.add_rule("kv.peer_fetch")
    faultinject.install(inj)
    try:
        eng = _mesh_engine(model, tree, mesh,
                           kv_shared_tier_peers=tuple(peers))
        restored, fetches, unspy = _spy(eng)
        tier = eng.host_tier
        info = dict(rank=eng.mesh.rank, dp=eng.dp_index,
                    tp=eng.mesh.coord["tp"], peers=list(tier.peers),
                    server=tier.server is not None)
        try:
            if eng.mesh.rank != 0:
                eng.follow()
                tokens = None
            else:
                if filler:
                    eng.add_request(greedy("f", FILLER))
                    eng.step()
                tokens = eng.generate([greedy("p", PROMPT)])["p"]
                eng.stop_mesh()
        finally:
            unspy()
        return dict(info, tokens=tokens, restored=restored,
                    fetches=fetches[0], loads=tier.loads,
                    remote_hits=tier.remote_hits,
                    remote_misses=tier.remote_misses,
                    keys=list(tier._store))
    finally:
        faultinject.reset()


def rank_serve(model, tree):
    """Rank side: a tp = 2 engine serving its shared tier on an ephemeral
    port serves ``PROMPT``; the engine stays held (rank 0's server with
    it) until ``rank_release``.  Returns rank 0's port, tokens and
    blobs."""
    eng = _mesh_engine(model, tree, MeshConfig(tp=2), kv_shared_tier_port=0)
    HELD.append(eng)
    tier = eng.host_tier
    if eng.mesh.rank != 0:
        eng.follow()
        return dict(server=tier.server is not None, keys=list(tier._store))
    tokens = eng.generate([greedy("p", PROMPT)])["p"]
    eng.stop_mesh()
    return dict(server=True, port=tier.port, tokens=tokens,
                blobs=dict(tier._store), keys=list(tier._store))


def rank_release():
    while HELD:
        HELD.pop().host_tier.close()


# ---------- the main process ----------

def _check_shards(out, pod, served_blobs, region=0):
    """Every restore on every rank: the same hashes and regions in the
    same order; on the region's ranks the rows are their tp shard of the
    JAX pod's slab, bit for bit."""
    lead = out[0]["restored"]
    assert lead, "no block was restored"
    checked = 0
    for o in out:
        assert [(h, r) for h, r, _ in o["restored"]] == \
            [(h, r) for h, r, _ in lead]
        for h, r, rows in o["restored"]:
            assert r == region
            if o["dp"] != region:
                assert rows is None
                continue
            want = jax_slab(pod, served_blobs[h])
            for name, got in rows.items():
                w = want[name]
                if got.shape[-1] != w.shape[-1]:               # a tp shard
                    t = o["tp"]
                    w = w[..., t * got.shape[-1]:(t + 1) * got.shape[-1]]
                assert np.array_equal(_bits(got), _bits(w)), (o["rank"],
                                                              name)
                checked += 1
    return checked


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_tp2_mesh_pulls_a_jax_pods_prefix(pools, model):
    pod = jax_pod(model, kv_shared_tier_port=0)
    try:
        want = jax_generate(pod, "a", PROMPT)
        served = dict(pod.host_tier._store)
        peers = [f"127.0.0.1:{pod.host_tier.port}"]
        out = pools(2).run(rank_pull, model, tree_of(pod), MeshConfig(tp=2),
                           peers)
    finally:
        pod.host_tier.close()
    assert out[0]["tokens"] == want
    assert out[0]["remote_hits"] >= 2 and out[0]["server"] is False
    assert all(o["loads"] == out[0]["loads"] > 0 for o in out)
    # Rank 0 alone dialed; the follower holds no peers and the same keys.
    assert out[0]["fetches"] >= 2 and out[0]["peers"] == peers
    assert out[1]["fetches"] == 0 and out[1]["peers"] == []
    assert out[1]["keys"] == out[0]["keys"]
    layout = len(jax_slab(pod, next(iter(served.values()))))
    assert _check_shards(out, pod, served) == \
        2 * len(out[0]["restored"]) * layout


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_jax_pod_pulls_the_meshs_prefix(pools, model):
    seed_pod = jax_pod(model)
    tree = tree_of(seed_pod)
    want = jax_generate(seed_pod, "a", PROMPT)
    pool = pools(2)
    try:
        out = pool.run(rank_serve, model, tree)
        assert out[0]["tokens"] == want
        assert out[1]["server"] is False
        assert out[1]["keys"] == out[0]["keys"]
        pod = jax_pod(model, kv_shared_tier_peers=(
            f"127.0.0.1:{out[0]['port']}",))
        try:
            r = jax_generate(pod, "b", PROMPT)
            assert r == want
            assert pod.host_tier.remote_hits >= 2
            got = {h: b for h, b in pod.host_tier._store.items()
                   if h in out[0]["blobs"]}
            assert len(got) >= 2
            for h, blob in got.items():
                assert blob == out[0]["blobs"][h]
        finally:
            pod.host_tier.close()
    finally:
        pool.run(rank_release)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("trouble", ["fault", "dead_peer"])
def test_a_failed_fetch_is_a_miss_on_every_rank(pools, model, trouble):
    from llm_d_tpu_torch.parallel.launch import free_port
    pod = jax_pod(model, kv_shared_tier_port=0)
    try:
        want = jax_generate(pod, "a", PROMPT)
        port = pod.host_tier.port if trouble == "fault" else free_port()
        out = pools(2).run(rank_pull, model, tree_of(pod), MeshConfig(tp=2),
                           [f"127.0.0.1:{port}"],
                           fault=trouble == "fault")
    finally:
        pod.host_tier.close()
    assert out[0]["tokens"] == want
    assert all(o["loads"] == 0 and not o["restored"] for o in out)
    assert out[0]["remote_hits"] == 0 and out[0]["remote_misses"] >= 1
    assert out[1]["fetches"] == 0
    # A dead peer is dialed once and then backed off; a faulted one never.
    assert out[0]["fetches"] == (0 if trouble == "fault" else 1)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_dp2_tp2_consumer_restores_into_its_region(pools, model):
    pod = jax_pod(model, kv_shared_tier_port=0)
    try:
        want = jax_generate(pod, "a", PROMPT)
        served = dict(pod.host_tier._store)
        out = pools(4).run(rank_pull, model, tree_of(pod),
                           MeshConfig(dp=2, tp=2),
                           [f"127.0.0.1:{pod.host_tier.port}"],
                           filler=True)
    finally:
        pod.host_tier.close()
    assert out[0]["tokens"] == want
    assert out[0]["remote_hits"] >= 2
    assert [o["fetches"] > 0 for o in out] == [True, False, False, False]
    # The filler took region 0, so the prompt's blocks land in region 1:
    # ranks 2 and 3 hold their shards, ranks 0 and 1 wrote nothing.
    layout = len(jax_slab(pod, next(iter(served.values()))))
    assert _check_shards(out, pod, served, region=1) == \
        2 * len(out[0]["restored"]) * layout
