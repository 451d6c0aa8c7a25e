"""Port parity: SPMD data parallelism (``EngineConfig.mesh =
MeshConfig(dp=2, tp=2)``, the wide-EP regime: DP attention over a dp x tp
mesh, the routed experts over all four ranks) against the JAX package's
stacked engine on its 4-device mesh; the port's ranks are 4 gloo
processes spawned once for the file, each call with a deadline.

* Greedy tokens equal the JAX stacked engine's on ``tiny``, ``tiny-moe``
  and ``tiny-mla`` (int8 experts, int8 latent) in classic steps, and on
  ``tiny-moe`` in 2-step blocks, classic and async; every rank holds the
  same tokens; ``llmd_tpu:collective_bytes_total`` equals JAX's.
* Each rank's KV plane is ``[L, slots / dp, W]`` (W over tp where the
  cache shards) and its routed-expert bytes are the total / ep; each
  rank's shards equal JAX's addressable shards on that rank's device.
* ``kv_cache_hbm_bytes`` is a per-device budget: the block count scales
  by dp, as JAX's does.
* KV regions: pinning, the trash blocks, prefix affinity, and affinity
  yielding to capacity, on the port's ``KVCacheManager`` beside JAX's.
* The server's flags build ``MeshConfig(dp=2, tp=2)`` for spmd and
  ``MeshConfig(tp=2)`` for ranks.
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.kv_cache import KVCacheManager
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models import get_model
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import Mesh, MeshConfig

from test_torch_tp import ENGINE, MODELS, collective_bytes

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

DP, TP = 2, 2
WORLD = DP * TP
# Six requests of 3-9 tokens: the two regions get different token counts,
# so every step pads a shard to the common T_l / S_l buckets.
PROMPTS = {
    "s1": [2, 4, 6, 8, 10, 12, 14],
    "s2": [100, 90, 80, 70, 60, 50],
    "s3": [7, 7, 7],
    "s4": [11, 13, 17, 19, 23, 29, 31, 37, 41],
    "s5": [5, 10, 15, 20],
    "s6": [99, 98, 97, 96, 95],
}
BLOCKS = {"blocks": dict(num_scheduler_steps=2),
          "async blocks": dict(num_scheduler_steps=2, async_scheduling=True)}


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, timeout_s=120) as p:
        yield p


def _requests(cls_req, cls_sp):
    return [cls_req(request_id=r, prompt_token_ids=list(p),
                    sampling=cls_sp(temperature=0.0, max_tokens=5,
                                    ignore_eos=True))
            for r, p in PROMPTS.items()]


def _jmesh(devices):
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    return make_mesh(JMeshConfig(dp=DP, tp=TP), list(devices)[:WORLD])


def jax_generate(devices, model, kw):
    """The JAX stacked engine at dp = tp = 2: (tokens, its weights as
    numpy, its collective bytes)."""
    import jax
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    e = JEngineCore(JEngineConfig(model=model, mesh=JMeshConfig(dp=DP, tp=TP),
                                  allow_device_subset=True, **ENGINE, **kw),
                    devices=list(devices)[:WORLD])
    out = e.generate(_requests(JRequest, JSamplingParams))
    return (out, jax.tree.map(np.asarray, e.params),
            collective_bytes(e.metrics.render().decode()))


def rank_generate(model, tree, kw):
    """Rank side: the dp x tp engine on the JAX tree; rank 0 serves the
    requests, the others follow.  Returns (tokens, collective bytes on
    rank 0, this rank's cache shapes, its routed-expert bytes)."""
    eng = EngineCore(EngineConfig(model=model, device="cpu",
                                  mesh=MeshConfig(dp=DP, tp=TP), **ENGINE,
                                  **kw),
                     params=params_from_numpy(tree, "cpu"))
    shapes = {k: tuple(v.shape) for k, v in eng.kv_cache.items()}
    ml = eng.params["moe_layers"] if "moe_layers" in eng.params else {}
    experts = sum(v.numel() * v.element_size() for k, v in ml.items()
                  if k.startswith(("w_gate", "w_up", "w_down")))
    if eng.mesh.rank != 0:
        return eng.follow(), None, shapes, experts
    out = eng.generate(_requests(Request, SamplingParams))
    eng.stop_mesh()
    return (out, collective_bytes(eng.metrics.render().decode()), shapes,
            experts)


def _check(out, want, jbytes):
    tokens = [o[0] for o in out]
    assert tokens[0] == want
    assert all(t == tokens[0] for t in tokens)
    assert out[0][1] == jbytes


@pytest.mark.parametrize("model", sorted(MODELS))
def test_greedy_tokens_at_dp2_tp2_equal_the_jax_stacked_engine(
        pool, devices, model):
    """Also each rank's KV plane (``[L, slots / dp, W]``, W over tp for
    GQA K/V) and, on the MoE models, its routed-expert bytes (total /
    ep)."""
    want, tree, jbytes = jax_generate(devices, model, MODELS[model])
    out = pool.run(rank_generate, model, tree, MODELS[model])
    _check(out, want, jbytes)
    c = tget_config(model)
    layout = get_model(c).kv_cache_layout(c)
    slots = ENGINE["num_blocks"] * ENGINE["block_size"] // DP
    for o in out:
        for name, w in layout.items():
            width = w if c.use_mla else w // TP
            assert o[2][name] == (c.num_layers, slots, width), name
    if c.is_moe:
        total = sum(a.nbytes for k, a in tree["moe_layers"].items()
                    if k.startswith(("w_gate", "w_up", "w_down")))
        assert [o[3] for o in out] == [total // WORLD] * WORLD
        assert set(jbytes) == {"dispatch", "combine"}


@pytest.mark.parametrize("mode", sorted(BLOCKS))
def test_blocks_at_dp2_tp2_equal_the_jax_stacked_engine(pool, devices, mode):
    kw = BLOCKS[mode]
    want, tree, jbytes = jax_generate(devices, "tiny-moe", kw)
    _check(pool.run(rank_generate, "tiny-moe", tree, kw), want, jbytes)


@pytest.mark.parametrize("preset", ["tiny-moe", "tiny-mla"])
def test_rank_shards_equal_jax_addressable_shards_at_dp2_tp2(devices,
                                                             preset):
    """Dense weights, attention and the shared expert replicated over dp
    and split over tp, the routed experts split over all four ranks: each
    rank's shard equals JAX's on that rank's device, bit for bit."""
    import jax
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.models.config import get_config as jget_config
    from llm_d_tpu.parallel.sharding import logical_to_sharding, shard_pytree
    jc, tc = jget_config(preset), tget_config(preset)
    jm = jget_model(jc)
    params = jm.init_params(jc, jax.random.PRNGKey(6))
    tree = jax.tree.map(np.asarray, params)
    mesh = _jmesh(devices)
    sharded = shard_pytree(params, logical_to_sharding(
        jm.sharding_rules(jc), params, mesh))
    flat = jax.tree_util.tree_flatten_with_path(sharded)[0]
    for r in range(WORLD):
        m = Mesh(MeshConfig(dp=DP, tp=TP), r, WORLD, "cpu")
        assert m.coord == {"dp": r // TP, "sp": 0, "tp": r % TP}
        mine = params_from_numpy(tree, "cpu", mesh=m,
                                 rules=get_model(tc).sharding_rules(tc))
        dev = mesh.devices.reshape(-1)[r]
        for path, arr in flat:
            node = mine
            for k in path:
                node = node[k.key]
            want = np.asarray(next(s.data for s in arr.addressable_shards
                                   if s.device == dev))
            got = (node.view(torch.uint16).numpy()
                   if node.dtype == torch.bfloat16 else node.numpy())
            if want.dtype.name == "bfloat16":
                want = want.view(np.uint16)
            np.testing.assert_array_equal(got, want, err_msg=str(path))
        for k in ("w_gate", "w_up", "w_down"):
            assert mine["moe_layers"][k].numel() * WORLD == \
                tree["moe_layers"][k].size


def rank_refusals():
    """Rank side: a pool that does not split into dp regions, on the dp
    mesh (the shared tier and a step-time target are served there since:
    ``tests/test_torch_shared_tier_mesh.py``)."""
    try:
        EngineCore(EngineConfig(**dict(ENGINE, model="tiny", device="cpu",
                                       mesh=MeshConfig(dp=DP, tp=TP),
                                       num_blocks=63)))
        regions = None
    except ValueError as e:
        regions = str(e)
    return regions


def test_refused_by_name_on_the_dp_mesh(pool):
    """A pool that does not split into dp regions is refused by name."""
    for regions in pool.run(rank_refusals):
        assert regions is not None and "2 KV regions" in regions


def rank_budget(budget):
    eng = EngineCore(EngineConfig(
        model="tiny", device="cpu", mesh=MeshConfig(dp=DP, tp=TP),
        kv_cache_hbm_bytes=budget, **ENGINE))
    return (eng.config.num_blocks, eng.kv_manager.blocks_per_region,
            tuple(eng.kv_cache["k"].shape))


def test_kv_cache_hbm_bytes_is_per_device_and_scales_by_dp(pool, devices):
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    budget = 1 << 16
    j = JEngineCore(JEngineConfig(model="tiny", mesh=JMeshConfig(dp=DP, tp=TP),
                                  allow_device_subset=True,
                                  kv_cache_hbm_bytes=budget, **ENGINE),
                    devices=list(devices)[:WORLD])
    one = EngineCore(EngineConfig(model="tiny", device="cpu",
                                  kv_cache_hbm_bytes=budget, **ENGINE))
    out = pool.run(rank_budget, budget)
    assert out[0][0] == j.config.num_blocks == DP * one.config.num_blocks
    assert out[0][1] == one.config.num_blocks
    assert all(o == out[0] for o in out)
    assert out[0][2][1] == one.kv_cache["k"].shape[1]


# ---------- KV regions, beside the JAX manager ----------

def _managers(**kw):
    from llm_d_tpu.engine.kv_cache import KVCacheManager as JKVCacheManager
    return KVCacheManager(**kw), JKVCacheManager(**kw)


def _req(rid, prompt):
    return Request(rid, list(prompt), SamplingParams(temperature=0.0,
                                                     max_tokens=4))


def _jreq(rid, prompt):
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    return JRequest(request_id=rid, prompt_token_ids=list(prompt),
                    sampling=JSamplingParams(temperature=0.0, max_tokens=4))


def test_regions_pin_requests_and_reserve_trash_blocks():
    tk, jk = _managers(num_blocks=32, block_size=4, num_regions=4)
    assert tk.blocks_per_region == jk.blocks_per_region == 8
    assert tk.num_free_blocks == jk.num_free_blocks == 28
    regions = set()
    for i in range(8):
        prompt = list(range(1 + i, 13 + i))
        r, jr = _req(f"q{i}", prompt), _jreq(f"q{i}", prompt)
        tk.allocate(r, 12)
        jk.allocate(jr, 12)
        assert r.block_ids == jr.block_ids
        region = tk.region_of_request(r)
        assert region == jk.region_of_request(jr)
        assert all(b // tk.blocks_per_region == region for b in r.block_ids)
        assert all(b % tk.blocks_per_region != 0 for b in r.block_ids)
        regions.add(region)
    assert regions == {0, 1, 2, 3}


def test_region_prefix_affinity():
    prompt = list(range(100, 112))
    got = []
    for km, mk in zip(_managers(num_blocks=32, block_size=4, num_regions=4),
                      (_req, _jreq)):
        a = mk("a", prompt)
        km.allocate(a, 12)
        a.num_computed_tokens = 12
        km.cache_full_blocks(a)
        km.free(a)
        b = mk("b", prompt + [7, 8, 9, 10])
        blocks, n_cached = km.find_cached_prefix(b)
        assert km.region_of_request(b) == km.region_of_request(a)
        assert n_cached == 12 and len(blocks) == 3
        got.append((km.region_of_request(b), list(blocks)))
    assert got[0] == got[1]


def test_affinity_yields_to_capacity():
    prompt = list(range(50, 62))
    got = []
    for km, mk in zip(_managers(num_blocks=16, block_size=4, num_regions=2),
                      (_req, _jreq)):
        a = mk("a", prompt)
        km.allocate(a, 12)
        region_a = km.region_of_request(a)
        a.num_computed_tokens = 12
        km.cache_full_blocks(a)
        hog = mk("hog", list(range(200, 216)))
        km._region_of_req["hog"] = region_a
        km.allocate(hog, 16)
        assert km.region_free_blocks(region_a) < 3
        km.free(a)
        b = mk("b", prompt + list(range(300, 316)))
        region_b = km.assign_region(b)
        assert region_b != region_a
        assert km.allocate(b, len(b.prompt_token_ids)) is not None
        c = mk("c", [1, 2, 3, 4])
        km.assign_region(c)
        assert km.unpin(c)
        assert c.request_id not in km._region_of_req
        got.append((region_a, region_b, list(b.block_ids)))
    assert got[0] == got[1]


def test_server_flags_build_the_spmd_mesh():
    """``--data-parallel-mode spmd`` (the default) puts dp and tp on one
    mesh, ``ranks`` keeps dp out of it: the JAX server's mapping."""
    from llm_d_tpu.server import openai as JServer
    from llm_d_tpu_torch.server import openai as TServer
    for flags in (["--data-parallel-size", "2", "--tensor-parallel-size",
                   "2"],
                  ["--data-parallel-size", "2", "--tensor-parallel-size",
                   "2", "--data-parallel-mode", "ranks"],
                  ["--data-parallel-size", "2"]):
        cfg = TServer.engine_config_from_args(
            TServer.build_arg_parser().parse_args(["--model", "tiny-moe"]
                                                  + flags))
        jcfg = JServer.engine_config_from_args(
            JServer.build_arg_parser().parse_args(["--model", "tiny-moe"]
                                                  + flags))
        assert (cfg.mesh.dp, cfg.mesh.sp, cfg.mesh.tp) == \
            (jcfg.mesh.dp, jcfg.mesh.sp, jcfg.mesh.tp)
    p = TServer.build_arg_parser()
    spmd = p.parse_args(["--data-parallel-size", "2",
                         "--tensor-parallel-size", "2"])
    assert TServer.engine_config_from_args(spmd).mesh == \
        MeshConfig(dp=2, tp=2)
    assert TServer.world_from_args(spmd) == 4
    ranks = p.parse_args(["--data-parallel-size", "2",
                          "--tensor-parallel-size", "2",
                          "--data-parallel-mode", "ranks"])
    assert TServer.engine_config_from_args(ranks).mesh == MeshConfig(tp=2)
