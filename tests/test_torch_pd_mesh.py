"""Port parity: P/D disaggregation between ``MeshConfig(dp=2, tp=2)``
meshes (``tests/test_spmd_dp.py``'s stacked P/D round trip), and the
wide-EP recipe's server flags (``deploy/wide-ep-lws``).

A producer and a consumer engine share the same 4 gloo ranks (spawned
once for the file): rank 0 holds both connectors and drives the requests,
the other ranks follow the producer, then the consumer, then the producer
again until its pins are released.

* Two requests (one a KV region) prefilled on the producer mesh and
  decoded on the consumer mesh give the one-device engine's tokens on
  ``tiny`` (GQA K/V split over tp) and ``tiny-mla`` (int8 latent); the
  wire bytes equal the JAX stacked producer's for the same request; every
  rank of the consumer's region holds the slab's rows of its shard; the
  producer's pins are released on every rank.
* A mesh producer serves a one-device consumer, and a one-device producer
  a mesh consumer, with the same tokens.
* ``kv_load_failure_policy`` ``recompute``: a pull from a dead producer
  is prefilled locally on every rank.
* The flag sets of ``prefill-lws.yaml`` and ``decode-lws.yaml`` (at dp =
  2, tp = 2) parse into the mesh config, and the servers' engines built
  from them on the ranks (``tiny-moe``, 16-step async blocks on the CPU)
  serve a request disaggregated; the decode set passes whole where the
  ranks share a card (its bodies then run eagerly).
"""

import time

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request, RequestState
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.launch import RankPool, free_port
from llm_d_tpu_torch.parallel.mesh import MeshConfig

from test_torch_spmd_dp import DP, TP, WORLD
from test_torch_tp import ENGINE, MODELS

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

PROMPTS = {"pd-a": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
           "pd-b": [7, 3, 9, 1, 4, 6, 2, 8, 5]}
MESH = MeshConfig(dp=DP, tp=TP)


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, timeout_s=120) as p:
        yield p


def _req(rid, n, cls_req=Request, cls_sp=SamplingParams, **kw):
    return cls_req(request_id=rid, prompt_token_ids=list(PROMPTS[rid]),
                   sampling=cls_sp(temperature=0.0, max_tokens=n,
                                   ignore_eos=True), **kw)


def _connector(role, **kw):
    from llm_d_tpu_torch.transfer import KVConnectorConfig, TpuConnector
    return TpuConnector(KVConnectorConfig(kv_role=role, host="127.0.0.1",
                                          **kw))


def _prefill(prod, rids):
    """Rank 0: the producer's prefills of ``rids``: their transfer params
    and the slabs its transport server registered."""
    blobs = {}
    register = prod.kv_connector.server.register
    prod.kv_connector.server.register = \
        lambda u, b: (blobs.__setitem__(u, b), register(u, b))[1]
    reqs = [_req(rid, 1, do_remote_decode=True) for rid in rids]
    for r in reqs:
        prod.add_request(r)
    while any(r.state is not RequestState.FINISHED_REMOTE_PREFILL
              for r in reqs):
        prod.step()
    return {r.request_id: r.kv_transfer_params for r in reqs}, blobs


def _drain(prod):
    """Rank 0: step the producer until the consumer's releases came."""
    for _ in range(4000):
        if not prod.pinned_transfers:
            return
        prod.step()
        time.sleep(0.002)
    raise AssertionError("the producer's pins were never released")


def _checked_scatters():
    """Wrap the connector's scatter: after each, this rank's rows of the
    blocks, where their region is this rank's, against its shard of the
    slab.  Returns the list of (region, held here, rows equal)."""
    from llm_d_tpu_torch.transfer import connector as TConn
    seen = []
    real = TConn.scatter_blocks

    def checked(eng, block_ids, blob):
        real(eng, block_ids, blob)
        r, local = TConn._local_blocks(eng, block_ids)
        if r != eng.dp_index:
            seen.append((r, False, None))
            return
        bs, nb = eng.config.block_size, len(block_ids)
        bnb = TConn._HEADER.unpack_from(blob, 0)[5]
        same = True
        for name, off, count, dtype, width in TConn.check_slab(eng, blob,
                                                               nb):
            have = eng.kv_cache[name]
            L, w = have.shape[0], have.shape[2]
            wire = TConn.host_tensor(blob, off, count, dtype, False).view(
                L, bnb, bs, width)[:, :nb]
            t = eng.mesh.axis_index("tp") if eng.mesh is not None else 0
            if w != width:
                wire = wire[..., t * w:(t + 1) * w]
            rows = have.view(L, -1, bs, w)[:, local]
            same &= torch.equal(rows, wire)
        seen.append((r, True, same))
    TConn.scatter_blocks = checked
    return seen


def rank_pd(model, tree, kw, layout):
    """Rank side.  ``layout``: "mesh" (producer and consumer meshes),
    "mesh->one" (consumer one device on rank 0) or "one->mesh".  Returns
    on rank 0 (tokens, slabs, consumer block ids, free blocks of both
    after), elsewhere (tokens followed, region rows, pins left)."""
    cfg = EngineConfig(model=model, device="cpu", mesh=MESH, **ENGINE, **kw)
    one = EngineConfig(model=model, device="cpu", **ENGINE, **kw)
    params = params_from_numpy(tree, "cpu")
    prod = EngineCore(cfg if layout != "one->mesh" else one, params=params)
    cons = EngineCore(cfg if layout != "mesh->one" else one, params=params)
    mesh_eng = prod if prod.mesh is not None else cons
    scatters = _checked_scatters()
    if mesh_eng.mesh.rank != 0:
        got = {}
        if prod.mesh is not None:
            prod.follow(record=False)
        if cons.mesh is not None:
            got = cons.follow()
        if prod.mesh is not None:
            prod.follow(record=False)
        return got, scatters, len(prod.pinned_transfers)
    prod.kv_connector = _connector("kv_producer")
    cons.kv_connector = _connector("kv_consumer")
    try:
        params_by, blobs = _prefill(prod, PROMPTS)
        prod.stop_mesh()
        dreqs = [_req(rid, 6, do_remote_prefill=True,
                      kv_transfer_params=params_by[rid]) for rid in PROMPTS]
        out = cons.generate(dreqs)
        cons.stop_mesh()
        _drain(prod)
        prod.stop_mesh()
    finally:
        prod.kv_connector.close()
        cons.kv_connector.close()
    return (out, blobs, scatters, (prod.kv_manager.num_free_blocks,
                                   cons.kv_manager.num_free_blocks))


def _one_device(model, tree, kw):
    eng = EngineCore(EngineConfig(model=model, device="cpu", **ENGINE, **kw),
                     params=params_from_numpy(tree, "cpu"))
    return eng.generate([_req(rid, 6) for rid in PROMPTS]), eng


def _jax_stacked_blobs(devices, model, kw, tree):
    """The JAX stacked producer's slabs of the same requests."""
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.engine.request import RequestState as JRequestState
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.transfer import connector as JConn
    jeng = JEngineCore(JEngineConfig(
        model=model, mesh=JMeshConfig(dp=DP, tp=TP), allow_device_subset=True,
        **ENGINE, **kw), params=tree, devices=list(devices)[:WORLD])
    reqs = [_req(rid, 1, JRequest, JSamplingParams, do_remote_decode=True)
            for rid in PROMPTS]
    jeng.kv_connector = JConn.TpuConnector(JConn.KVConnectorConfig(
        kv_role="kv_producer", host="127.0.0.1"))
    try:
        for r in reqs:
            jeng.add_request(r)
        while any(r.state is not JRequestState.FINISHED_REMOTE_PREFILL
                  for r in reqs):
            jeng.step()
        return {r.request_id: JConn._pack_blocks(jeng, r.block_ids)
                for r in reqs}
    finally:
        jeng.kv_connector.close()


@pytest.fixture(scope="module")
def trees(devices):
    import jax
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.models.config import get_config as jget_config
    from llm_d_tpu.ops.quant import quantize_moe_experts
    out = {}
    for model, kw in MODELS.items():
        if model == "tiny-moe":
            continue
        jc = jget_config(model)
        p = jget_model(jc).init_params(jc, jax.random.PRNGKey(3))
        if kw.get("quantization") == "int8":
            p = quantize_moe_experts(p)
        out[model] = jax.tree.map(np.asarray, p)
    return out


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_pd_between_dp2_tp2_meshes_equals_one_device_and_jax_wire(
        pool, devices, trees, model):
    kw, tree = MODELS[model], trees[model]
    want, one = _one_device(model, tree, kw)
    out = pool.run(rank_pd, model, tree, kw, "mesh")
    tokens, blobs, scatters0, free = out[0]
    assert tokens == want
    assert all(o[0] == want for o in out[1:])
    # Both regions served a request; each region's two ranks, and only
    # they, wrote their shard of its slab, equal to it.
    scatters = [scatters0] + [o[1] for o in out[1:]]
    for rank, seen in enumerate(scatters):
        assert seen == [(rank // TP, True, True)]
    assert free[0] == free[1] == ENGINE["num_blocks"] - DP
    assert all(o[2] == 0 for o in out[1:])
    _same_wire(blobs, _jax_stacked_blobs(devices, model, kw, tree))


def _same_wire(blobs, jblobs):
    """The port's slabs against JAX's: the same bytes; an int8 cache's
    rows (the tp ranks' partial sums quantized) within one step of JAX's,
    their scales within 2e-2, the headers and sizes the same bytes."""
    from llm_d_tpu_torch.transfer.connector import _BUF_HEADER, _HEADER
    from llm_d_tpu_torch.transfer.transport import wire_dtype
    assert blobs.keys() == jblobs.keys()
    for rid, blob in blobs.items():
        jblob = jblobs[rid]
        assert len(blob) == len(jblob)
        _, _, L, bs, n_bufs, nb = _HEADER.unpack_from(blob, 0)
        assert blob[:_HEADER.size] == jblob[:_HEADER.size]
        off = _HEADER.size
        for _ in range(n_bufs):
            width, code = _BUF_HEADER.unpack_from(blob, off)
            assert blob[off:off + _BUF_HEADER.size] == \
                jblob[off:off + _BUF_HEADER.size]
            off += _BUF_HEADER.size
            dtype = torch.empty((), dtype=wire_dtype(code))
            n = L * nb * bs * width * dtype.element_size()
            a, b = (torch.frombuffer(bytearray(x[off:off + n]),
                                     dtype=dtype.dtype)
                    for x in (blob, jblob))
            if dtype.dtype == torch.int8:
                assert (a.int() - b.int()).abs().max() <= 1
            elif dtype.dtype == torch.float32:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2)
            else:
                assert torch.equal(a, b), rid
            off += n


@pytest.mark.parametrize("layout", ["mesh->one", "one->mesh"])
def test_pd_between_a_mesh_and_one_device_both_ways(pool, trees, layout):
    tree = trees["tiny"]
    want, _ = _one_device("tiny", tree, {})
    out = pool.run(rank_pd, "tiny", tree, {}, layout)
    assert out[0][0] == want
    if layout == "one->mesh":
        assert all(o[0] == want for o in out[1:])


def rank_recompute(tree):
    """Rank side: a consumer mesh with the recompute policy pulls from a
    producer that is not there."""
    cons = EngineCore(EngineConfig(model="tiny", device="cpu", mesh=MESH,
                                   **ENGINE), params=params_from_numpy(
                                       tree, "cpu"))
    if cons.mesh.rank != 0:
        return cons.follow()
    cons.kv_connector = _connector("kv_consumer",
                                   kv_load_failure_policy="recompute",
                                   timeout_ms=2000, pull_retries=0)
    dead = dict(remote_host="127.0.0.1", remote_port=free_port(),
                uuid="gone", remote_block_ids=[1])
    try:
        out = cons.generate([_req(rid, 6, do_remote_prefill=True,
                                  kv_transfer_params=dict(dead))
                             for rid in PROMPTS])
    finally:
        cons.stop_mesh()
        cons.kv_connector.close()
    return out


def test_recompute_policy_prefills_locally_on_every_rank(pool, trees):
    tree = trees["tiny"]
    want, _ = _one_device("tiny", tree, {})
    assert pool.run(rank_recompute, tree) == [want] * WORLD


# ---------- the recipe's flags ----------

PREFILL_LWS = ["--model", "deepseek-v3-bench", "--port", "8200",
               "--data-parallel-size", "2", "--tensor-parallel-size", "2",
               "--max-num-batched-tokens", "8192", "--kv-transfer-config",
               '{"kv_connector":"TPUConnector","kv_role":"kv_producer",'
               '"kv_port":8300}']
DECODE_LWS = ["--model", "deepseek-v3-bench", "--port", "8200",
              "--data-parallel-size", "2", "--tensor-parallel-size", "2",
              "--enable-eplb", "--eplb-config",
              '{"window_size":1000,"step_interval":3000,'
              '"num_redundant_experts":32}',
              "--num-scheduler-steps", "16", "--async-scheduling",
              "--enable-dbo", "--dbo-decode-token-threshold", "32",
              "--dbo-prefill-token-threshold", "32", "--kv-transfer-config",
              '{"kv_connector":"TPUConnector","kv_role":"kv_consumer",'
              '"kv_load_failure_policy":"recompute"}']


def _cpu(flags, model="tiny-moe", kv_port=None):
    """A recipe's flags on the CPU at a test's size."""
    out = list(flags)
    out[out.index("--model") + 1] = model
    if kv_port is not None:
        i = out.index("--kv-transfer-config") + 1
        out[i] = out[i].replace('"kv_port":8300', f'"kv_port":{kv_port}')
    return out + ["--device", "cpu", "--num-blocks", "64", "--block-size",
                  "4", "--max-num-seqs", "8"]


@pytest.mark.parametrize("flags", [PREFILL_LWS, DECODE_LWS],
                         ids=["prefill-lws", "decode-lws"])
def test_the_recipe_flag_sets_parse_into_the_mesh_config(flags):
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    args = p.parse_args(flags + ["--device", "cpu"])
    TServer.check_served(p, args)
    TServer.check_mesh_flags(p, args)
    cfg = TServer.engine_config_from_args(args)
    assert cfg.mesh == MeshConfig(dp=2, tp=2) and cfg.mesh.ep == 4
    conn = TServer.kv_connector_config_from_args(args)
    if flags is DECODE_LWS:
        assert cfg.enable_dbo and cfg.dbo_decode_token_threshold == 32 \
            and cfg.dbo_prefill_token_threshold == 32
        assert cfg.enable_eplb and cfg.eplb_config["num_redundant_experts"] \
            == 32
        assert cfg.num_scheduler_steps == 16 and cfg.async_scheduling
        assert (conn.kv_role, conn.kv_load_failure_policy) == \
            ("kv_consumer", "recompute")
    else:
        assert cfg.max_num_batched_tokens == 8192
        assert (conn.kv_role, conn.port) == ("kv_producer", 8300)


def test_the_recipe_keeps_captured_blocks_refused_on_a_shared_card(capsys):
    """Without ``--device cpu`` four ranks share the card over gloo: the
    decode recipe passes whole, its 16-step async blocks included, and
    their bodies run eagerly (no CUDA graph holds a gloo collective)."""
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    args = p.parse_args(DECODE_LWS)
    TServer.check_mesh_flags(p, args)
    assert capsys.readouterr().err == ""
    assert args.num_scheduler_steps == 16 and args.async_scheduling

    class Shared:
        stage_host = True
    assert not EngineCore.captures_bodies(torch.device("cuda"), Shared())


def rank_recipe(kv_port):
    """Rank side: the producer built from prefill-lws's flags and the
    consumer from decode-lws's, serving one request disaggregated."""
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    engines = []
    for flags in (_cpu(PREFILL_LWS, kv_port=kv_port), _cpu(DECODE_LWS)):
        args = p.parse_args(flags)
        eng = EngineCore(TServer.engine_config_from_args(args))
        engines.append((eng, args))
    (prod, pargs), (cons, cargs) = engines
    if prod.mesh.rank != 0:
        prod.follow(record=False)
        got = cons.follow()
        prod.follow(record=False)
        return got, cons.eplb.num_redundant
    prod.kv_connector = TServer.kv_connector_from_args(pargs)
    cons.kv_connector = TServer.kv_connector_from_args(cargs)
    try:
        params_by, _ = _prefill(prod, ["pd-a"])
        prod.stop_mesh()
        out = cons.generate([_req("pd-a", 6, do_remote_prefill=True,
                                  kv_transfer_params=params_by["pd-a"])])
        cons.stop_mesh()
        _drain(prod)
        prod.stop_mesh()
    finally:
        prod.kv_connector.close()
        cons.kv_connector.close()
    return out, cons.eplb.num_redundant


def test_the_recipe_servers_engines_serve_disaggregated(pool):
    out = pool.run(rank_recipe, free_port())
    tokens = out[0][0]["pd-a"]
    assert len(tokens) == 6
    assert all(o[0]["pd-a"] == tokens for o in out)
    # 32 redundant experts clamp to E * (ep - 1) = 24 at tiny-moe's 8.
    assert all(o[1] == 24 for o in out)
