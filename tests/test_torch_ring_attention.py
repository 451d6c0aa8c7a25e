"""Port parity: ring attention (``llm_d_tpu_torch/ops/ring_attention.py``)
against the JAX package's on its 8-device CPU mesh.

* The cases of ``tests/test_ring_attention.py``: sp8, sp4-tp2 and dp2-sp4,
  causal and not, at T = 64, H = 4, KVH = 2, D = 16, bf16.  The same numpy
  inputs (from a seed) go through the JAX ``ring_attention`` and through
  the port's on 8 gloo ranks (one ``RankPool`` for the file), each rank
  given its ``P(sp, tp, None)`` shard; the ranks' shards put back together
  equal JAX's output and the port's ``attention_reference_dense`` within
  atol = rtol = 3e-2 (JAX's test's bound), and the dense references of
  both packages agree within the same bound.
* The memory-shape case: at T = 256 each rank's inputs and output hold
  T / sp rows, and the result matches the dense oracle.
* sp = 1 (a dp8 mesh, and no mesh at all) is plain flash attention.

Rank-side functions are module-level and import no JAX.
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.ops.ring_attention import (attention_reference_dense,
                                                ring_attention, shard_qkv)
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import Mesh, MeshConfig

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

WORLD = 8
TOL = dict(atol=3e-2, rtol=3e-2)
MESHES = {"sp8": (1, 8, 1), "sp4-tp2": (1, 4, 2), "dp2-sp4": (2, 4, 1)}


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, timeout_s=60) as p:
        yield p


def _case(seed, T, H, KVH, D):
    """bf16 inputs as numpy f32 (exact bf16 values)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((T, H, D), (T, KVH, D), (T, KVH, D)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append(x.to(torch.bfloat16).float().numpy())
    return out


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def rank_ring(cfg, q, k, v, causal):
    """Rank side: this rank's shards through the port's ring attention.
    Returns (the output shard as f32 numpy, the rows each input held, the
    shard's slices in the full tensor)."""
    import torch.distributed as dist
    mesh = Mesh.from_process_group(MeshConfig(*cfg), torch.device("cpu"))
    parts = [shard_qkv(_t(x), mesh) for x in (q, k, v)]
    out = ring_attention(*parts, mesh, causal=causal)
    dist.barrier()
    Tl, Hl = out.shape[0], out.shape[1]
    s, t = mesh.coord["sp"], mesh.coord["tp"]
    return (out.float().numpy(), [p.shape[0] for p in parts],
            (s * Tl, t * Hl))


def _assemble(results, shape):
    full = np.full(shape, np.nan, np.float32)
    for out, _, (r0, h0) in results:
        Tl, Hl = out.shape[:2]
        block = full[r0:r0 + Tl, h0:h0 + Hl]
        # Replicas (dp) must agree bit for bit.
        assert np.isnan(block).all() or np.array_equal(block, out)
        full[r0:r0 + Tl, h0:h0 + Hl] = out
    assert not np.isnan(full).any()
    return full


def _jax(devices, cfg, q, k, v, causal):
    """JAX's ring attention (jitted, as its memory-shape test runs it:
    eager ``shard_map`` takes ~20 s a case here) and its dense oracle."""
    import jax
    import jax.numpy as jnp
    from llm_d_tpu.ops.ring_attention import (
        attention_reference_dense as jdense, ring_attention as jring)
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    mesh = make_mesh(JMeshConfig(*cfg), devices)
    out = jax.jit(lambda a, b, c: jring(a, b, c, mesh, causal=causal))(
        jq, jk, jv)
    ref = jax.jit(lambda a, b, c: jdense(a, b, c, causal=causal))(jq, jk, jv)
    return np.asarray(out, np.float32), np.asarray(ref, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("label", sorted(MESHES))
def test_ring_matches_jax_and_dense(pool, devices, label, causal):
    T, H, KVH, D = 64, 4, 2, 16
    seed = sorted(MESHES).index(label) * 2 + int(causal)
    q, k, v = _case(seed, T, H, KVH, D)
    cfg = MESHES[label]
    got = _assemble(pool.run(rank_ring, cfg, q, k, v, causal), (T, H, D))
    jout, jref = _jax(devices, cfg, q, k, v, causal)
    ref = attention_reference_dense(_t(q), _t(k), _t(v),
                                    causal=causal).float().numpy()
    np.testing.assert_allclose(got, jout, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(ref, jref, **TOL)


def test_ring_long_sequence_memory_shape(pool, devices):
    """Each sp shard holds only T / sp rows of Q, K, V and the output."""
    T, H, KVH, D = 256, 4, 2, 16
    q, k, v = _case(3, T, H, KVH, D)
    res = pool.run(rank_ring, (1, 8, 1), q, k, v, True)
    for out, rows, _ in res:
        assert out.shape[0] == T // 8
        assert rows == [T // 8] * 3
    ref = attention_reference_dense(_t(q), _t(k), _t(v)).float().numpy()
    np.testing.assert_allclose(_assemble(res, (T, H, D)), ref, **TOL)


def test_ring_sp1_degenerates_to_flash(pool, devices):
    q, k, v = _case(5, 32, 4, 2, 16)
    res = pool.run(rank_ring, (8, 1, 1), q, k, v, True)
    ref = attention_reference_dense(_t(q), _t(k), _t(v)).float().numpy()
    jout, _ = _jax(devices, (8, 1, 1), q, k, v, True)
    got = _assemble(res, q.shape)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, jout, **TOL)
    alone = ring_attention(_t(q), _t(k), _t(v)).float().numpy()
    np.testing.assert_array_equal(alone, got)
