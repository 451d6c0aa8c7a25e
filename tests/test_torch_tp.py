"""Port parity: tensor and expert parallelism in the models and the
engine (``EngineConfig.mesh = MeshConfig(tp=2)``) against the JAX package
on its 2-device tp mesh, the port's ranks as 2 gloo processes (spawned
once for the file, each call with a deadline).

* The model forward of ``tiny`` (bf16 and int8 K/V caches), ``tiny-mla``
  (int8 experts, int8 latent) and ``tiny-moe``: a prefill step and a
  decode step through each rank's shards (``params_from_numpy`` with the
  mesh) against JAX's jitted
  forward on the sharded tree, on the reference attention path: final
  hidden states within atol = rtol = 2e-2 (the one-rank forward tests'
  bound), the same on both ranks; the replicated latent cache rows and
  each rank's K/V head shard equal to JAX's cache shard outside the trash
  block 0 (bit for bit at the first layer).
* ``EngineCore`` greedy tokens at tp = 2 equal the JAX engine's on
  ``MeshConfig(tp=2)`` on ``tiny``, ``tiny-mla`` (int8 experts and an int8
  latent) and ``tiny-moe``, in the classic loop, and every rank's tokens
  are identical; ``llmd_tpu:collective_bytes_total`` equals JAX's on the
  same requests (tiny-moe).
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models import get_model
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import Mesh, MeshConfig
from llm_d_tpu_torch.parallel.sharding import shard_shape

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

TP = 2
TOL = dict(atol=2e-2, rtol=2e-2)
BS = 4
PROMPTS = {
    "s1": [2, 4, 6, 8, 10, 12, 14],
    "s2": [100, 90, 80, 70, 60, 50],
    "s3": [7, 7, 7],
    "s4": [11, 13, 17, 19, 23, 29, 31, 37, 41],
}
ENGINE = dict(block_size=BS, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, min_token_bucket=16,
              min_seq_bucket=4)
MODELS = {"tiny": {}, "tiny-mla": dict(quantization="int8",
                                       kv_cache_dtype="int8"),
          "tiny-moe": {}}


@pytest.fixture(scope="module")
def pool():
    with RankPool(TP, timeout_s=120) as p:
        yield p


def _jmesh(devices):
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    return make_mesh(JMeshConfig(tp=TP), list(devices)[:TP])


# ---------- the model forward ----------

def _batches(vocab):
    """A prefill step (sequences of 7 and 5 tokens, padded to T = 16,
    S = 4) and a decode step of both, engine layout."""
    rng = np.random.default_rng(5)
    seqs = [(rng.integers(1, vocab, 7), [1, 2]), (rng.integers(1, vocab, 5),
                                                  [3, 4])]
    out = []
    for step in ("prefill", "decode"):
        T, S, B = 16, 4, 4
        Q = 8 if step == "prefill" else 1
        a = dict(token_ids=np.zeros(T, np.int32),
                 positions=np.zeros(T, np.int32),
                 token_seq_ids=np.zeros(T, np.int32),
                 token_qpos=np.zeros(T, np.int32),
                 slot_mapping=np.zeros(T, np.int32),
                 block_tables=np.zeros((S, B), np.int32),
                 seq_lens=np.zeros(S, np.int32),
                 sample_idx=np.zeros(S, np.int32),
                 qtok_idx=np.full((S, Q), T, np.int32))
        t = 0
        for s, (toks, blocks) in enumerate(seqs):
            n0 = len(toks)
            pos = np.arange(n0) if step == "prefill" else np.asarray([n0])
            ids = toks if step == "prefill" else np.asarray([toks[-1]])
            n = len(pos)
            blk = np.asarray(blocks)
            a["token_ids"][t:t + n] = ids
            a["positions"][t:t + n] = pos
            a["token_seq_ids"][t:t + n] = s
            a["token_qpos"][t:t + n] = np.arange(n)
            a["slot_mapping"][t:t + n] = blk[pos // BS] * BS + pos % BS
            a["block_tables"][s, :len(blk)] = blk
            a["seq_lens"][s] = pos[-1] + 1
            a["sample_idx"][s] = t + n - 1
            a["qtok_idx"][s, :n] = np.arange(t, t + n)
            t += n
        out.append(a)
    return out


def _cache_shapes(c, kv):
    layout = get_model(c).kv_cache_layout(c)
    shapes = {}
    for name, w in layout.items():
        shapes[name] = ((c.num_layers, 6 * BS, w), np.int8 if kv == "int8"
                        else "bf16")
        if kv == "int8":
            shapes[f"{name}_scale"] = ((c.num_layers, 6 * BS, 1), np.float32)
    return shapes


def rank_forward(model, tree, kv, batches):
    """Rank side: the port's forward on this rank's shards and cache."""
    c = tget_config(model)
    m = Mesh.from_process_group(MeshConfig(tp=TP), torch.device("cpu"))
    mod = get_model(c)
    params = params_from_numpy(tree, "cpu", mesh=m,
                               rules=mod.sharding_rules(c))
    specs = mod.kv_cache_spec(c)
    cache = {}
    for name, (shape, dt) in _cache_shapes(c, kv).items():
        spec = specs.get(name, ()) if not name.endswith("_scale") else ()
        dt = torch.bfloat16 if dt == "bf16" else (
            torch.int8 if dt == np.int8 else torch.float32)
        cache[name] = torch.zeros(shard_shape(shape, spec, m), dtype=dt)
    hidden = []
    for b in batches:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        hidden.append(mod.forward(params, cache, tb, c, BS, "reference",
                                  mesh=m).float().numpy())
    return hidden, {k: (v.view(torch.int16) if v.dtype == torch.bfloat16
                        else v).numpy() for k, v in cache.items()}


def _jax_forward(model, kv, devices):
    import functools
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from llm_d_tpu.models import get_model as jget_model
    from llm_d_tpu.models.config import get_config as jget_config
    from llm_d_tpu.ops.quant import quantize_moe_experts
    from llm_d_tpu.parallel.sharding import logical_to_sharding, shard_pytree
    jc = jget_config(model)
    jm = jget_model(jc)
    params = jm.init_params(jc, jax.random.PRNGKey(4))
    if MODELS[model].get("quantization"):
        params = quantize_moe_experts(params)
    mesh = _jmesh(devices)
    sharded = shard_pytree(params, logical_to_sharding(
        jm.sharding_rules(jc), params, mesh))
    specs = jm.kv_cache_spec(jc)
    cache = {}
    for name, (shape, dt) in _cache_shapes(tget_config(model), kv).items():
        spec = specs.get(name, P()) if not name.endswith("_scale") else P()
        dt = jnp.bfloat16 if dt == "bf16" else dt
        cache[name] = jax.device_put(jnp.zeros(shape, dt),
                                     NamedSharding(mesh, spec))
    fwd = jax.jit(functools.partial(
        jm.forward, config=jc, block_size=BS, attn_backend="reference",
        mesh=mesh))
    hidden = []
    batches = _batches(jc.vocab_size)
    for b in batches:
        h, cache = fwd(sharded, cache, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        hidden.append(np.asarray(h, np.float32))
    tree = jax.tree.map(np.asarray, params)
    return tree, batches, hidden, cache, mesh


@pytest.mark.parametrize("model,kv", [(m, MODELS[m].get(
    "kv_cache_dtype", "bf16")) for m in sorted(MODELS)] + [("tiny", "int8")])
def test_forward_at_tp2_matches_jax(pool, devices, model, kv):
    """``tiny`` also on an int8 K/V cache with one scale per row: the
    row's scale covers both ranks' KV heads (the amax is all-reduced)."""
    tree, batches, want, jcache, mesh = _jax_forward(model, kv, devices)
    out = pool.run(rank_forward, model, tree, kv, batches)
    for r, (hidden, cache) in enumerate(out):
        for step, (got, ref) in enumerate(zip(hidden, want)):
            np.testing.assert_allclose(got[:2], ref[:2], err_msg=str(step),
                                       **TOL)
        np.testing.assert_array_equal(hidden[-1], out[0][0][-1])
        dev = mesh.devices.reshape(-1)[r]
        for name, mine in cache.items():
            shard = np.asarray(next(s.data for s in
                                    jcache[name].addressable_shards
                                    if s.device == dev))
            if shard.dtype.name == "bfloat16":
                shard = shard.view(np.int16)
            assert mine.shape == shard.shape, name
            # Layer 0 bit for bit; deeper rows follow hidden states an
            # ulp apart (the one-rank tests' bounds).
            np.testing.assert_array_equal(mine[0, BS:], shard[0, BS:],
                                          err_msg=name)


# ---------- the engine ----------

def _requests():
    return [Request(r, list(p), SamplingParams(
        temperature=0.0, max_tokens=6, ignore_eos=True))
        for r, p in PROMPTS.items()]


def collective_bytes(metrics_text: str):
    out = {}
    for line in metrics_text.splitlines():
        if line.startswith("llmd_tpu:collective_bytes_total{"):
            labels, value = line.rsplit(" ", 1)
            out[labels.split("collective=\"")[1].split("\"")[0]] = \
                float(value)
    return out


def rank_generate(model, tree, kw):
    """Rank side: a tp engine on the JAX tree; rank 0 serves the
    requests, the other follows.  Returns (tokens, collective bytes)."""
    eng = EngineCore(EngineConfig(model=model, device="cpu",
                                  mesh=MeshConfig(tp=TP), **ENGINE, **kw),
                     params=params_from_numpy(tree, "cpu"))
    if eng.mesh.rank != 0:
        return eng.follow(), None
    out = eng.generate(_requests())
    eng.stop_mesh()
    return out, collective_bytes(eng.metrics.render().decode())


def jax_generate(devices, model, kw):
    import jax
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    e = JEngineCore(JEngineConfig(model=model, mesh=JMeshConfig(tp=TP),
                                  allow_device_subset=True, **ENGINE, **kw),
                    devices=list(devices)[:TP])
    out = e.generate([JRequest(request_id=r, prompt_token_ids=list(p),
                               sampling=JSamplingParams(
                                   temperature=0.0, max_tokens=6,
                                   ignore_eos=True))
                      for r, p in PROMPTS.items()])
    return (out, jax.tree.map(np.asarray, e.params),
            collective_bytes(e.metrics.render().decode()))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_greedy_tokens_at_tp2_equal_the_jax_engine(pool, devices, model):
    want, tree, jbytes = jax_generate(devices, model, MODELS[model])
    out = pool.run(rank_generate, model, tree, MODELS[model])
    tokens = [o[0] for o in out]
    assert tokens[0] == want
    assert all(t == tokens[0] for t in tokens)
    assert out[0][1] == jbytes
    if model == "tiny-moe":
        assert set(jbytes) == {"dispatch", "combine"}
        assert all(v > 0 for v in jbytes.values())
