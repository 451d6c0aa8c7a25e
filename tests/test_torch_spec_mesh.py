"""Port parity: spec decode, the fused rounds and the host KV tier on a
``MeshConfig(dp=2, tp=2)`` mesh (ep = 4), against the JAX package's
stacked engine on its 4-device mesh; the port's ranks are 4 gloo
processes spawned once for the file, each call with a deadline.

* Spec alone (``spec_k`` = 4, one fused round a step) and everything-on
  (``spec_k`` = 4, 2 rounds a dispatch, async scheduling, EPLB at ep = 4)
  on ``tiny-moe`` and ``tiny-mla`` (int8 experts and latent), on
  ``tests/test_everything_on.py``'s workload: every request's tokens equal
  the same mesh's plain run's, the greedy ones the JAX engine's with the
  same flags on the same mesh; every rank holds the same tokens, keeps
  ``spec_k`` = 4 and gets its free blocks back (per-shard verify strides,
  shard-local trims; ``tests/test_everything_on.py``
  ``test_stacked_dp_eplb_everything_on_parity_and_leak_free``).
* The host tier (``tests/test_spmd_dp.py test_stacked_offload_restore``):
  a prompt saved, both regions thrashed, the prompt again: its tokens are
  the first run's, ``loads`` rises, and on every rank of the requesting
  region each restored block holds its shard of rank 0's saved slab.
* The server's flags: ``--spec-k 4`` and ``--kv-offload-blocks 64`` build
  at dp = tp = 2; ``--num-scheduler-steps 16 --async-scheduling`` passes
  for ranks that share a card, whose engines run the bodies eagerly; the
  shared tier's flags pass too (served on a mesh since:
  ``tests/test_torch_shared_tier_mesh.py``).
* A follower whose plan, extension or bail-out differs from rank 0's
  raises; a KV pull in flight drains every rank by rank 0's reading.
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.engine.offload import _unpack_block_slab
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import MeshConfig

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

DP, TP = 2, 2
WORLD = DP * TP
ENGINE = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, min_token_bucket=16,
              min_seq_bucket=4)
MODELS = {"tiny-moe": {},
          "tiny-mla": dict(quantization="int8", kv_cache_dtype="int8")}
FLAGS = {
    "spec": dict(spec_k=4),
    "everything_on": dict(
        spec_k=4, num_scheduler_steps=2, async_scheduling=True,
        enable_eplb=True, eplb_config={"num_redundant_experts": 4,
                                       "window_size": 100,
                                       "step_interval": 4}),
}
# tests/test_everything_on.py's workload: (id, prompt, max tokens, seed).
WORKLOAD = [("g0", [1, 5, 9, 200, 3, 17, 42], 12, None),
            ("g1", [4, 4, 4, 8], 12, None),
            ("g2", list(range(40, 55)), 8, None),
            ("s0", [7, 7, 2, 300], 12, 123),
            ("s1", [9, 1, 9, 1, 9], 10, 31337)]


def workload(R, SP):
    return [R(request_id=rid, prompt_token_ids=list(p), sampling=SP(
        temperature=0.0, max_tokens=n, ignore_eos=True) if seed is None
        else SP(temperature=0.9, top_p=0.95, top_k=20, max_tokens=n,
                seed=seed, ignore_eos=True))
        for rid, p, n, seed in WORKLOAD]


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, timeout_s=120) as p:
        yield p


def rank_serve(model, tree, draft, runs):
    """Rank side: each ``(name, engine kw)`` of ``runs`` as a dp x tp
    engine on the JAX weights (and drafter), serving the workload; rank 0
    orders, the others follow.  Returns {name: (tokens, free blocks before
    and after, spec_k)}."""
    out = {}
    for name, kw in runs:
        eng = EngineCore(
            EngineConfig(model=model, device="cpu",
                         mesh=MeshConfig(dp=DP, tp=TP), **ENGINE, **kw),
            params=params_from_numpy(tree, "cpu"),
            draft_params=params_from_numpy(draft, "cpu"))
        before = eng.kv_manager.num_free_blocks
        if eng.mesh.rank != 0:
            tokens = eng.follow()
        else:
            tokens = eng.generate(workload(Request, SamplingParams))
            eng.stop_mesh()
        out[name] = (tokens, before, eng.kv_manager.num_free_blocks,
                     eng.spec_k)
    return out


def jax_serve(devices, model, flags):
    """The JAX stacked engine at dp = tp = 2 with ``flags``: (tokens, the
    engine)."""
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    e = JEngineCore(JEngineConfig(model=model, mesh=JMeshConfig(dp=DP, tp=TP),
                                  allow_device_subset=True, **ENGINE,
                                  **MODELS[model], **flags),
                    devices=list(devices)[:WORLD])
    assert e.spec_k == 4
    return e.generate(workload(JRequest, JSamplingParams)), e


@pytest.mark.parametrize("model", sorted(MODELS))
def test_spec_and_everything_on_give_the_plain_mesh_and_jax_tokens(
        pool, devices, model):
    import jax
    want = {}
    for name in FLAGS:
        want[name], jeng = jax_serve(devices, model, FLAGS[name])
        if name == "spec":
            # The logical weights (the EPLB engine's are its table's).
            tree = jax.tree.map(np.asarray, jeng.params)
            draft = jax.tree.map(np.asarray, jeng.draft_params)
    runs = [("plain", MODELS[model])] + [
        (name, dict(MODELS[model], **flags)) for name, flags in FLAGS.items()]
    out = pool.run(rank_serve, model, tree, draft, runs)
    greedy = [rid for rid, _, _, seed in WORKLOAD if seed is None]
    plain = out[0]["plain"][0]
    for name in FLAGS:
        for rank, got in enumerate(out):
            tokens, before, after, spec_k = got[name]
            assert tokens == plain, (name, rank)
            assert spec_k == 4, (name, rank)
            assert after == before, f"{name}: rank {rank} leaked blocks"
        assert {r: plain[r] for r in greedy} == \
            {r: want[name][r] for r in greedy}, name


TIER_BLOCKS = 16


def rank_tier():
    """Rank side: JAX's restore scenario on ``tiny`` at 16 blocks with 64
    host blocks (weights drawn from the seed on every rank).  Each
    restore's rows are read back on the ranks of its block's region,
    beside rank 0's saved slab."""
    eng = EngineCore(EngineConfig(
        model="tiny", device="cpu", mesh=MeshConfig(dp=DP, tp=TP),
        **dict(ENGINE, num_blocks=TIER_BLOCKS), kv_offload_blocks=64))
    km, tier = eng.kv_manager, eng.host_tier
    bs = eng.config.block_size
    restored = []
    real = km.secondary_lookup

    def lookup(h, protected=frozenset(), region=0):
        b = real(h, protected, region)
        if b is not None:
            rows = None
            if km.region_of_block(b) == eng.dp_index:
                local = km.local_block_id(b)
                rows = {name: buf.view(buf.shape[0], -1, bs,
                                       buf.shape[2])[:, local].clone()
                        for name, buf in eng.kv_cache.items()}
            restored.append((h, b, rows, tier._store.get(h)))
        return b

    km.secondary_lookup = lookup
    info = dict(rank=eng.mesh.rank, dp=eng.dp_index,
                tp=eng.mesh.coord["tp"], layout=tier._full_layout(),
                L=eng.model_config.num_layers)
    if eng.mesh.rank != 0:
        eng.follow()
        return dict(info, restored=restored, loads=tier.loads)

    def greedy(rid, prompt, n=4):
        return Request(rid, list(prompt), SamplingParams(
            temperature=0.0, max_tokens=n, ignore_eos=True))

    prompt_a = [7, 3, 9, 1, 4, 6, 2, 8, 5, 0, 11, 13]     # 3 full blocks
    first = eng.generate([greedy("a1", prompt_a)])["a1"]
    saves = tier.saves
    for i in range(8):                  # thrash both regions
        filler = [(100 + 17 * i + j) % 500 for j in range(12)]
        eng.generate([greedy(f"f{i}", filler, 2)])
    evictions = km.eviction_count
    loads_before = tier.loads
    r2 = greedy("a2", prompt_a)
    again = eng.generate([r2])["a2"]
    eng.stop_mesh()
    return dict(info, restored=restored, loads=tier.loads, first=first,
                again=again, saves=saves, evictions=evictions,
                loads_before=loads_before,
                cached=r2.num_cached_prompt_tokens)


def test_host_tier_restores_into_the_requesting_region(pool):
    out = pool.run(rank_tier)
    lead = out[0]
    assert lead["saves"] >= 3 and lead["evictions"] > 0
    assert lead["again"] == lead["first"]
    assert lead["loads"] > lead["loads_before"]
    assert lead["cached"] >= 8
    assert all(o["loads"] == lead["loads"] for o in out)
    assert lead["restored"] and all(
        len(o["restored"]) == len(lead["restored"]) for o in out)
    checked = 0
    for o in out:
        for (h, b, rows, _), (h0, b0, _, blob) in zip(o["restored"],
                                                      lead["restored"]):
            assert (h, b) == (h0, b0) and blob is not None
            if b // (TIER_BLOCKS // DP) != o["dp"]:
                assert rows is None
                continue
            slab = _unpack_block_slab(blob, o["layout"], o["L"],
                                      ENGINE["block_size"])
            for name, got in rows.items():
                want = slab[name]
                w = got.shape[-1]
                if w != want.shape[-1]:                  # a tp shard
                    want = want[..., o["tp"] * w:(o["tp"] + 1) * w]
                assert torch.equal(got.view(torch.uint8),
                                   want.contiguous().view(torch.uint8)), name
                checked += 1
    # Both tp ranks of the region checked every buffer of every block.
    assert checked == TP * len(lead["restored"]) * len(out[0]["layout"])


def rank_flags(argv):
    """Rank side: the server's engine config from ``argv``, built."""
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    eng = EngineCore(TServer.engine_config_from_args(p.parse_args(argv)))
    return (eng.spec_k, eng.host_tier is not None, eng.mesh.config,
            eng._graphs is None)


def test_the_mesh_flags_are_served_and_the_shared_tier_refused(pool,
                                                                capsys):
    from llm_d_tpu_torch.server import openai as TServer
    mesh = ["--data-parallel-size", "2", "--tensor-parallel-size", "2"]
    argv = mesh + ["--model", "tiny", "--device", "cpu", "--spec-k", "4",
                   "--kv-offload-blocks", "64", "--num-scheduler-steps", "2",
                   "--async-scheduling", "--block-size", "4",
                   "--num-blocks", "32", "--max-num-seqs", "8",
                   "--max-num-batched-tokens", "64"]
    p = TServer.build_arg_parser()
    args = p.parse_args(argv)
    TServer.check_served(p, args)
    TServer.check_mesh_flags(p, args)
    for got in pool.run(rank_flags, argv):
        assert got == (4, True, MeshConfig(dp=DP, tp=TP), True)
    # Ranks that share a card (gloo): the recipe's 16-step async blocks
    # are served, the bodies eager (no capture on a staged mesh; each
    # rank's own card, nccl, captures).
    card = p.parse_args(mesh + ["--num-scheduler-steps", "16",
                                "--async-scheduling"])
    TServer.check_mesh_flags(p, card)

    class Staged:
        stage_host = True

    class Nccl:
        stage_host = False
    cuda = torch.device("cuda")
    assert not EngineCore.captures_bodies(cuda, Staged())
    assert EngineCore.captures_bodies(cuda, Nccl())
    assert EngineCore.captures_bodies(cuda, None)
    assert not EngineCore.captures_bodies(torch.device("cpu"), None)
    for flags in (["--kv-offload-blocks", "8", "--kv-shared-tier-port", "0"],
                  ["--kv-offload-blocks", "8", "--kv-shared-tier-peers",
                   "127.0.0.1:9"]):
        args = p.parse_args(mesh + flags)
        TServer.check_served(p, args)
        TServer.check_mesh_flags(p, args)
        assert capsys.readouterr().err == ""


def test_a_rank_that_disagrees_with_rank_0_raises():
    """A follower compares its own plan, extension or bail-out with rank
    0's on the step channel and raises where they differ: a rank that
    dispatched alone would deadlock the EP exchange."""
    plan = (2, 8, 16, 16, 0, (0, 1), (("a", 12),))

    class Channel:
        leader = False

        def recv(self):
            return ("plan", plan)

    class Mesh:
        rank = 1

    class Follower:
        _channel, mesh = Channel(), Mesh()
    EngineCore._agree(Follower, "plan", plan)
    for what, mine in (("plan", None), ("extension", plan)):
        with pytest.raises(RuntimeError, match="disagrees with rank 0"):
            EngineCore._agree(Follower, what, mine)


def test_a_pull_in_flight_drains_every_rank_alike():
    """Only rank 0 holds the KV connector: whether a pull in flight
    drains a pipelined dispatch is rank 0's reading at its step order,
    which the other ranks receive with it (a rank that extended alone
    would deadlock the exchange)."""
    class Follower:
        _channel, kv_connector = object(), None

    for pending in (True, False):
        Follower._step_pending = pending
        assert EngineCore._pull_drains(Follower) is pending
