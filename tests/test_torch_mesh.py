"""Port parity: the mesh, the sharding rules and the quantized collectives
(``llm_d_tpu_torch/parallel/``) against the JAX package.

* ``select_devices`` arranges devices as JAX's ``make_mesh`` does, with
  the same errors; ``lws_distributed_args`` reads the same LWS env dicts
  as JAX's; dp and sp meshes are refused by name.
* On 4 gloo ranks (spawned once for the file, each call with a
  deadline): every rank's ``(dp, sp, tp)`` coordinate, its axis indices,
  and the all-reduce, all-gather and all-to-all results.
* Every rank's shard shape equals JAX's ``NamedSharding.shard_shape`` for
  every preset and tp of ``tests/test_multichip.py``'s divisibility test,
  the rule tables give JAX's specs path for path, and on ``tiny-mla`` and
  ``tiny-moe`` each rank's converted shard (``params_from_numpy``) and
  each rank's loaded checkpoint shard (``load_from_safetensors_dir``)
  equal JAX's addressable shard on that device, bit for bit;
  ``validate_divisibility`` gives JAX's messages.
* ``quantize_rows`` / ``dequantize_rows`` are bit-equal to JAX's, the byte
  models equal, and ``quantized_psum`` on 4 ranks (and over one tp axis of
  2, rows that do not divide included) matches JAX's on the same mesh.

Rank-side functions are module-level and import no JAX (the ranks import
this module by name).
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.models import get_model
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.parallel import quant_collectives as TQ
from llm_d_tpu_torch.parallel import sharding as TS
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import (Mesh, MeshConfig, check_served,
                                           lws_distributed_args,
                                           select_devices)

WORLD = 4


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, timeout_s=60) as p:
        yield p


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2, timeout_s=60) as p:
        yield p


def _jspec(spec):
    from jax.sharding import PartitionSpec as P
    return P(*spec)


def _jmesh(tp, devices):
    from llm_d_tpu.parallel.mesh import make_mesh
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    return make_mesh(JMeshConfig(tp=tp), list(devices)[:tp])


# ---------- mesh ----------

@pytest.mark.parametrize("cfg,n,subset", [
    ((1, 1, 4), 4, False), ((2, 1, 2), 4, False), ((1, 1, 2), 8, True),
    ((1, 1, 2), 8, False), ((1, 2, 4), 4, False), (None, 4, False)])
def test_select_devices_is_make_mesh(devices, cfg, n, subset):
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    jc = JMeshConfig(*cfg) if cfg else None
    tc = MeshConfig(*cfg) if cfg else None
    devs = list(devices)[:n]
    try:
        want = make_mesh(jc, devs, allow_subset=subset)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            select_devices(tc, list(range(n)), subset)
        assert str(got.value) == str(e)
        return
    got = select_devices(tc, list(range(n)), subset)
    ids = np.vectorize(lambda d: devs.index(d))(want.devices)
    assert got.shape == want.devices.shape
    np.testing.assert_array_equal(got.astype(int), ids)


def test_lws_args_from_the_jax_env_dicts():
    from llm_d_tpu.parallel.mesh import lws_distributed_args as jlws
    for env in ({}, {"LWS_LEADER_ADDRESS": "leader"},
                {"LWS_LEADER_ADDRESS": "10.0.0.1:9000", "LWS_GROUP_SIZE":
                 "4", "LWS_WORKER_INDEX": "3"}):
        want = jlws(env)
        got = lws_distributed_args(env)
        if want is None:
            assert got is None
            continue
        assert got == dict(init_method=f"tcp://{want['coordinator_address']}",
                           world_size=want["num_processes"],
                           rank=want["process_id"])


def test_dp_and_sp_refused_by_name():
    with pytest.raises(ValueError, match="dp > 1"):
        check_served(MeshConfig(dp=2, tp=2))
    with pytest.raises(ValueError, match="sp > 1"):
        check_served(MeshConfig(sp=2))


def rank_collectives():
    """Rank side: coordinate, axis indices and one of each collective."""
    m = Mesh.from_process_group(MeshConfig(tp=WORLD), torch.device("cpu"))
    r = m.rank
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
    return dict(
        coord=m.coord, shape=m.shape, tp=m.axis_index("tp"),
        ep=m.axis_index(("dp", "sp", "tp")),
        reduce=m.all_reduce(x).tolist(),
        reduce_max=m.all_reduce(x, op="max").tolist(),
        gather=m.all_gather(x, dim=1).tolist(),
        a2a=m.all_to_all(torch.arange(8, dtype=torch.int8) + 8 * r).tolist())


def test_coordinates_groups_and_collectives(pool):
    out = pool.run(rank_collectives)
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(WORLD)]
    for r, o in enumerate(out):
        assert o["coord"] == {"dp": 0, "sp": 0, "tp": r}
        assert o["shape"] == {"dp": 1, "sp": 1, "tp": WORLD}
        assert o["tp"] == o["ep"] == r
        np.testing.assert_array_equal(o["reduce"], sum(xs))
        np.testing.assert_array_equal(o["reduce_max"], xs[-1])
        np.testing.assert_array_equal(o["gather"], np.concatenate(xs, 1))
        assert o["a2a"] == [2 * r + 8 * s + j for s in range(WORLD)
                            for j in range(2)]


# ---------- sharding ----------

@pytest.mark.parametrize("preset,tp", [("tiny", 2), ("qwen3-0.6b", 8),
                                       ("llama3-8b", 8), ("llama3-70b", 8),
                                       ("qwen3-30b-a3b", 4),
                                       ("deepseek-v3-bench", 4),
                                       ("tiny-mla", 2), ("tiny-moe", 2)])
def test_shard_shapes_equal_jax(devices, preset, tp):
    """Every leaf: the port's rule gives JAX's spec, and its shard shape
    is JAX's ``NamedSharding(mesh, spec).shard_shape``."""
    import jax
    from jax.sharding import NamedSharding
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.models.config import get_config as jget_config
    from llm_d_tpu.parallel import sharding as JS
    jc, tc = jget_config(preset), tget_config(preset)
    jm, tm = jget_model(jc), get_model(tc)
    shapes = jax.eval_shape(lambda k: jm.init_params(jc, k),
                            jax.random.PRNGKey(0))
    mesh = _jmesh(tp, devices)
    jrules, trules = jm.sharding_rules(jc), tm.sharding_rules(tc)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert leaves
    for path, leaf in leaves:
        p = JS._path_str(path)
        jspec = JS.spec_for_path(jrules, p, leaf)
        tspec = TS.spec_for_path(trules, p, leaf)
        assert _jspec(tspec) == jspec, p
        want = NamedSharding(mesh, jspec).shard_shape(leaf.shape)
        assert TS.shard_shape(leaf.shape, tspec, MeshConfig(tp=tp)) == want
    assert tm.kv_cache_spec(tc).keys() == jm.kv_cache_spec(jc).keys()
    for k, spec in tm.kv_cache_spec(tc).items():
        assert _jspec(spec) == jm.kv_cache_spec(jc)[k]


def _assert_rank_shards_equal_jax(jc, params, devices, mine_of):
    """``mine_of(rank_mesh)`` (the port's shards on a rank) equals JAX's
    addressable shard of ``params`` on that rank's device, bit for bit,
    on a 2-device tp mesh."""
    import jax
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.parallel.sharding import logical_to_sharding, shard_pytree
    jm = jget_model(jc)
    mesh = _jmesh(2, devices)
    sharded = shard_pytree(params, logical_to_sharding(
        jm.sharding_rules(jc), params, mesh))
    for r in range(2):
        mine = mine_of(Mesh(MeshConfig(tp=2), r, 2, "cpu"))
        dev = mesh.devices.reshape(-1)[r]
        flat = jax.tree_util.tree_flatten_with_path(sharded)[0]
        for path, arr in flat:
            node = mine
            for k in path:
                node = node[k.key]
            want = next(s.data for s in arr.addressable_shards
                        if s.device == dev)
            want = np.asarray(want)
            got = node.view(torch.uint16).numpy() if node.dtype == \
                torch.bfloat16 else node.numpy()
            if want.dtype.name == "bfloat16":
                want = want.view(np.uint16)
            np.testing.assert_array_equal(got, want, err_msg=str(path))


@pytest.mark.parametrize("preset", ["tiny-mla", "tiny-moe"])
def test_rank_shards_equal_jax_addressable_shards(devices, preset):
    """``params_from_numpy`` with the mesh (the JAX init, int8 experts)."""
    import jax
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.models.config import get_config as jget_config
    from llm_d_tpu.ops.quant import quantize_moe_experts
    jc, tc = jget_config(preset), tget_config(preset)
    params = quantize_moe_experts(jget_model(jc).init_params(
        jc, jax.random.PRNGKey(2)))
    tree = jax.tree.map(np.asarray, params)
    _assert_rank_shards_equal_jax(jc, params, devices, lambda m: (
        params_from_numpy(tree, "cpu", mesh=m,
                          rules=get_model(tc).sharding_rules(tc))))


@pytest.mark.parametrize("name", ["tiny-mla", "tiny-moe"])
def test_loaded_checkpoint_shards_equal_jax_shards(devices, name, tmp_path):
    """``load_from_safetensors_dir`` with a mesh: each rank's shards of a
    checkpoint (written by the loader tests' helper) equal JAX's
    addressable shards of the JAX loader's tree."""
    from llm_d_tpu.models import loader as JL
    from llm_d_tpu_torch.models import loader as TL
    from test_torch_loader import _configs, _write_checkpoint
    jc, tc = _configs(name)
    _write_checkpoint(tmp_path, name, seed=3)
    params = JL.load_from_safetensors_dir(jc, str(tmp_path))
    _assert_rank_shards_equal_jax(jc, params, devices, lambda m: (
        TL.load_from_safetensors_dir(tc, str(tmp_path), device="cpu",
                                     mesh=m)))


def test_validate_divisibility_messages_equal_jax(devices):
    import jax
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.models.config import ModelConfig as JConfig
    from llm_d_tpu.parallel import sharding as JS
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    from llm_d_tpu_torch.models.config import ModelConfig as TConfig
    kw = dict(name="odd", vocab_size=90, hidden_size=48, intermediate_size=60,
              num_layers=2, num_heads=6, num_kv_heads=2, max_model_len=64,
              num_experts=6, num_experts_per_tok=2, moe_intermediate_size=12)
    jc, tc = JConfig(**kw), TConfig(**kw)
    jm = jget_model(jc)
    shapes = jax.eval_shape(lambda k: jm.init_params(jc, k),
                            jax.random.PRNGKey(0))
    mesh = make_mesh(JMeshConfig(tp=4), list(devices)[:4])
    want = JS.validate_divisibility(jm.sharding_rules(jc), shapes, mesh)
    got = TS.validate_divisibility(get_model(tc).sharding_rules(tc), shapes,
                                   MeshConfig(tp=4))
    assert want and got == want


# ---------- quantized collectives ----------

def test_quantize_rows_bit_equal_and_byte_models():
    """Against the jitted JAX functions (what the JAX programs run: XLA
    turns ``/ 127.0`` into a reciprocal multiply, as the port does)."""
    import jax
    import jax.numpy as jnp
    from llm_d_tpu.parallel import quant_collectives as JQ
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 40)) * 3).astype(np.float32)
    x[0, 2] = 0.0
    jq, js = jax.jit(JQ.quantize_rows)(jnp.asarray(x))
    tq, ts = TQ.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequantize_rows(tq, ts).numpy(),
        np.asarray(jax.jit(JQ.dequantize_rows)(jq, js)))
    for h in (64, 7168):
        for mode in ("bf16", "int8", "int8-dispatch", "f32-combine"):
            assert TQ.a2a_row_bytes(h, mode) == JQ.a2a_row_bytes(h, mode)
            assert TQ.ep_a2a_bytes_per_token(h, 8, mode, 3) == \
                JQ.ep_a2a_bytes_per_token(h, 8, mode, 3)
        for mode in ("bf16", "int8", "int8-dispatch"):
            assert TQ.psum_bytes_per_token(h, mode) == \
                JQ.psum_bytes_per_token(h, mode)
    for explicit in ("bf16", "int8", "int8-dispatch"):
        assert TQ.resolve_collective_dtype(explicit) == \
            JQ.resolve_collective_dtype(explicit)
    assert TQ.resolve_collective_dtype("auto", "cpu") == "bf16"
    assert TQ.resolve_collective_dtype("auto", "cuda") == "int8"
    with pytest.raises(ValueError):
        TQ.resolve_collective_dtype("fp8")


def rank_quantized_psum(xs, axis_n):
    """Rank side: this rank's rows through ``quantized_psum``."""
    m = Mesh.from_process_group(MeshConfig(tp=axis_n), torch.device("cpu"))
    mine = torch.from_numpy(xs[m.rank])
    return (TQ.quantized_psum(mine, m, "tp").numpy(),
            m.all_reduce(mine).numpy())


def _jax_quantized_psum(xs, n, devices):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from llm_d_tpu.parallel.quant_collectives import quantized_psum
    from llm_d_tpu.utils.jax_compat import shard_map
    import jax
    mesh = _jmesh(n, devices)
    body = lambda xl: (quantized_psum(xl, "tp", n), jax.lax.psum(xl, "tp"))
    # Under jit, as the JAX engine runs it (an eager shard_map takes ~20 s
    # on the CPU).
    got, want = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("tp"),),
                                  out_specs=(P(), P()), check_vma=False))(
        jnp.asarray(np.concatenate(xs)))
    return np.asarray(got), np.asarray(want)


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-12))


@pytest.mark.parametrize("T", [8, 9])
def test_quantized_psum_matches_jax_on_four_ranks(pool, devices, T):
    rng = np.random.default_rng(17 + T)
    xs = [rng.standard_normal((T, 16)).astype(np.float32)
          for _ in range(WORLD)]
    jq, jexact = _jax_quantized_psum(xs, WORLD, devices)
    out = pool.run(rank_quantized_psum, xs, WORLD)
    for q, exact in out:
        np.testing.assert_allclose(exact, jexact, rtol=1e-6, atol=1e-6)
        assert q.shape == jq.shape == (T, 16)
        assert _rel_rms(q, exact) <= 2e-2
        # Equal to JAX's but where an f32 partial sum lands a quantization
        # code the other side of a rounding tie (one step: amax / 127).
        step = np.abs(jq).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(q - jq) <= step * 1.01 + 1e-6)
    np.testing.assert_array_equal(out[0][0], out[-1][0])


def test_quantized_psum_single_tp_axis(pool2, devices):
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((9, 16)).astype(np.float32) for _ in range(2)]
    jq, jexact = _jax_quantized_psum(xs, 2, devices)
    for q, exact in pool2.run(rank_quantized_psum, xs, 2):
        np.testing.assert_array_equal(exact, jexact)
        step = np.abs(jq).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(q - jq) <= step * 1.01 + 1e-6)
        assert _rel_rms(q, exact) <= 2e-2
