"""Port parity: the tiered prefix cache (``llm_d_tpu_torch.engine.offload``)
against the JAX package's ``HostKVTier``, on the CPU.

* Slab v2 byte-exact, both directions: from caches filled with the same
  numpy arrays, the port's ``_pack_block_slab`` (and a flush through the
  tier's gather) writes the JAX package's bytes, and each package's
  ``_unpack_block_slab`` reads the other's blob back to those arrays, for
  ``tiny`` on bf16, int8 per-token and int8 per-head caches and
  ``tiny-mla`` on a bf16 and an int8 latent; a slab of another cache
  dtype is rejected by name.
* Mirrors of ``tests/test_offload.py`` and the int8 slab cases: a
  restore after device eviction gives the first run's tokens (and the
  JAX engine's), with the saved and loaded counters; the metrics are
  wired; the host tier keeps its LRU capacity; the same under 4-step
  decode blocks with async scheduling; int8 blocks restore with their
  scale planes byte-exact; the shared tier serves a cross-pod prefix hit
  port to port, JAX pod to port pod and port pod to JAX pod; a dead peer
  degrades to recompute (discovery specs: ``tests/test_torch_discovery.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_tpu.engine import offload as JOffload
from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine import offload as TOffload
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy, tensor_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

BS = 4
TIER_KW = dict(block_size=BS, num_blocks=16, max_num_seqs=4,
               max_num_batched_tokens=64, min_token_bucket=16,
               min_seq_bucket=4, kv_offload_blocks=64)
CACHE_MODES = {
    "tiny-bf16": dict(model="tiny", kv_cache_dtype="bf16"),
    "tiny-int8-token": dict(model="tiny", kv_cache_dtype="int8",
                            kv_scale_granularity="token"),
    "tiny-int8-head": dict(model="tiny", kv_cache_dtype="int8",
                           kv_scale_granularity="head"),
    "tiny-mla-bf16": dict(model="tiny-mla", quantization="int8",
                          kv_cache_dtype="bf16"),
    "tiny-mla-int8": dict(model="tiny-mla", quantization="int8",
                          kv_cache_dtype="int8"),
}
PROMPT_A = [7, 3, 9, 1, 4, 6, 2, 8, 5, 0, 11, 13]       # 3 full blocks


def greedy(rid, prompt, n=4, R=Request, SP=SamplingParams):
    return R(rid, list(prompt), SP(temperature=0.0, max_tokens=n,
                                   ignore_eos=True))


@pytest.fixture(scope="module")
def jparams():
    return {m: JEngineCore(JEngineConfig(model=m, block_size=BS,
                                         num_blocks=16)).params
            for m in ("tiny", "tiny-mla")}


def _port(jparams, **kw):
    cfg = dict(TIER_KW, model="tiny")
    cfg.update(kw)
    return EngineCore(EngineConfig(device="cpu", **cfg), params=params_from_numpy(
        jax.tree.map(np.asarray, jparams[cfg["model"]]), "cpu"))


def _jax(jparams, **kw):
    cfg = dict(TIER_KW, model="tiny")
    cfg.update(kw)
    return JEngineCore(JEngineConfig(**cfg), params=jparams[cfg["model"]])


def _np(t):
    return (t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            if t.dtype == torch.bfloat16 else t.numpy())


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


# ---------------------------------------------------------------------------
# slab v2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(CACHE_MODES))
def test_slab_bytes_equal_and_read_both_ways(mode, jparams):
    jeng = _jax(jparams, **CACHE_MODES[mode])
    teng = _port(jparams, **CACHE_MODES[mode])
    rng = np.random.default_rng(3)
    arrays = {}
    for name, buf in teng.kv_cache.items():
        shape = tuple(buf.shape)
        if buf.dtype == torch.int8:
            a = rng.integers(-128, 128, shape, dtype=np.int8)
        elif buf.dtype == torch.float32:
            a = rng.standard_normal(shape).astype(np.float32)
        else:
            a = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        arrays[name] = a
        buf.copy_(tensor_from_numpy(a, "cpu"))
        jeng.kv_cache[name] = jnp.asarray(a)
    L = teng.model_config.num_layers
    for b in (1, 6, 13):
        rows = slice(b * BS, (b + 1) * BS)
        jblob = JOffload._pack_block_slab(
            {n: np.ascontiguousarray(a[:, rows]) for n, a in arrays.items()})
        tblob = TOffload._pack_block_slab(
            {n: t[:, rows] for n, t in teng.kv_cache.items()})
        assert tblob == jblob
        # The tier's own store path: the step's gather, then the pack.
        teng.host_tier._on_stored(b"h%d" % b, b)
        teng.host_tier.flush()
        assert teng.host_tier._store[b"h%d" % b] == jblob
        got = TOffload._unpack_block_slab(
            jblob, TOffload._slab_layout(teng), L, BS)
        back = JOffload._unpack_block_slab(
            tblob, JOffload._slab_layout(jeng), L, BS)
        for n, a in arrays.items():
            np.testing.assert_array_equal(_bytes(_np(got[n])),
                                          _bytes(a[:, rows]), err_msg=n)
            np.testing.assert_array_equal(_bytes(back[n]),
                                          _bytes(a[:, rows]), err_msg=n)
    assert teng.host_tier.saves == teng.host_tier.num_blocks == 3


def test_slab_rejects_another_cache_dtype(jparams):
    """A bf16 pod rejects an int8 pod's slab (and vice versa), whichever
    package packed it."""
    q8 = _port(jparams, kv_cache_dtype="int8", kv_offload_blocks=8)
    bf = _port(jparams, kv_offload_blocks=8)
    jq8 = _jax(jparams, kv_cache_dtype="int8", kv_offload_blocks=8)
    q8.generate([greedy("x", [1, 2, 3, 4, 5, 6, 7, 8], 2)])
    jq8.generate([greedy("x", [1, 2, 3, 4, 5, 6, 7, 8], 2,
                         R=JRequest, SP=JSamplingParams)])
    L = q8.model_config.num_layers
    for blob in (next(iter(q8.host_tier._store.values())),
                 next(iter(jq8.host_tier._store.values()))):
        with pytest.raises(ValueError, match="mismatch|layout"):
            TOffload._unpack_block_slab(blob, TOffload._slab_layout(bf),
                                        L, BS)
    bf.generate([greedy("y", [1, 2, 3, 4, 5, 6, 7, 8], 2)])
    blob = next(iter(bf.host_tier._store.values()))
    with pytest.raises(ValueError, match="mismatch|layout"):
        TOffload._unpack_block_slab(blob, TOffload._slab_layout(q8), L, BS)


# ---------------------------------------------------------------------------
# mirrors of tests/test_offload.py
# ---------------------------------------------------------------------------

def _thrash(engine, n=6):
    for i in range(n):
        filler = [(100 + 17 * i + j) % 500 for j in range(12)]
        engine.generate([greedy(f"f{i}", filler, 2)])
    assert engine.kv_manager.eviction_count > 0, \
        "device cache never evicted (test too weak)"


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_restore_after_device_eviction(kv, jparams):
    engine = _port(jparams, kv_cache_dtype=kv)
    first = engine.generate([greedy("a1", PROMPT_A)])["a1"]
    assert engine.host_tier.saves >= 3, "full blocks were not offloaded"
    jeng = _jax(jparams, kv_cache_dtype=kv)
    assert first == jeng.generate([greedy("a1", PROMPT_A, R=JRequest,
                                          SP=JSamplingParams)])["a1"]
    if kv == "int8":
        # Every buffer (int8 payloads + f32 scales) round-trips the slab
        # byte-exactly.
        blob = next(iter(engine.host_tier._store.values()))
        slab = TOffload._unpack_block_slab(
            blob, TOffload._slab_layout(engine),
            engine.model_config.num_layers, BS)
        assert slab["k"].dtype == torch.int8
        assert slab["k_scale"].dtype == torch.float32
        assert TOffload._pack_block_slab(slab) == blob
    _thrash(engine)
    loads = engine.host_tier.loads
    r2 = greedy("a2", PROMPT_A)
    assert engine.generate([r2])["a2"] == first
    assert engine.host_tier.loads > loads, "no host-tier restore"
    assert r2.num_cached_prompt_tokens >= 8, "restore gave no prefix hit"
    # The restored blocks hold the saved slab's bytes.
    km = engine.kv_manager
    for h in km.request_block_hashes(r2)[:2]:
        b = km.lookup_hash(h)
        rows = {n: t[:, b * BS:(b + 1) * BS]
                for n, t in engine.kv_cache.items()}
        assert TOffload._pack_block_slab(rows) == engine.host_tier._store[h]
    text = engine.metrics.render().decode()
    assert 'llmd_tpu:kv_offload_loaded_blocks_total{model_name="tiny"} ' \
        f'{float(engine.host_tier.loads)}' in text


def test_restore_under_async_decode_blocks(jparams):
    """The tier under 4-step decode blocks with async scheduling: the
    flush runs at each retire, the restore gives the first run's tokens,
    which are the tier-less classic engine's."""
    engine = _port(jparams, num_scheduler_steps=4, async_scheduling=True)
    plain = _port(jparams, kv_offload_blocks=0, num_blocks=64)
    want = plain.generate([greedy("a", PROMPT_A, 9)])["a"]
    assert engine.generate([greedy("a1", PROMPT_A, 9)])["a1"] == want
    assert engine._step_count > engine._dispatch_count
    saves = engine.host_tier.saves
    assert saves >= 5          # the prompt's 3 blocks and 2 decoded ones
    _thrash(engine)
    r2 = greedy("a2", PROMPT_A, 9)
    assert engine.generate([r2])["a2"] == want
    assert engine.host_tier.loads > 0 and r2.num_cached_prompt_tokens >= 8


def test_offload_metrics_wired(jparams):
    engine = _port(jparams)
    engine.generate([greedy("m", [1, 2, 3, 4, 5, 6, 7, 8], 2)])
    text = engine.metrics.render().decode()
    assert 'llmd_tpu:kv_offload_saved_blocks_total{model_name="tiny"} 2.0' \
        in text
    for name in ("kv_offload_loaded_blocks_total",
                 "kv_shared_tier_hits_total", "kv_shared_tier_misses_total"):
        assert f"llmd_tpu:{name}" in text


def test_host_tier_capacity_lru(jparams):
    engine = _port(jparams, num_blocks=32, kv_offload_blocks=2)
    engine.generate([greedy("cap", list(range(1, 17)), 2)])     # 4 blocks
    assert engine.host_tier.saves == 4
    assert engine.host_tier.num_blocks == 2
    km = engine.kv_manager
    hashes = km.request_block_hashes(greedy("cap", list(range(1, 17))))
    assert list(engine.host_tier._store) == hashes[2:4]


# ---------------------------------------------------------------------------
# cross-pod shared tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serving,fetching", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_shared_tier_cross_pod_prefix_hit(serving, fetching, jparams):
    make = {"port": _port, "jax": _jax}
    R = {"port": (Request, SamplingParams),
         "jax": (JRequest, JSamplingParams)}
    pod_a = make[serving](jparams, kv_shared_tier_port=0)
    try:
        first = pod_a.generate([greedy("a", PROMPT_A, 4, *R[serving])])["a"]
        assert pod_a.host_tier.port > 0 and pod_a.host_tier.saves >= 3
        pod_b = make[fetching](jparams, kv_shared_tier_peers=(
            f"127.0.0.1:{pod_a.host_tier.port}",))
        try:
            rb = greedy("b", PROMPT_A, 4, *R[fetching])
            assert pod_b.generate([rb])["b"] == first
            # The prefix came over the wire, not from recompute.
            assert pod_b.host_tier.remote_hits >= 2
            assert rb.num_cached_prompt_tokens >= 8
            text = pod_b.metrics.render()
            text = text.decode() if isinstance(text, bytes) else text
            assert "llmd_tpu:kv_shared_tier_hits_total" in text
            pod_b.generate([greedy("c", [50, 51, 52, 53, 54, 55, 56, 57], 2,
                                   *R[fetching])])
            assert pod_b.host_tier.remote_misses >= 1
        finally:
            pod_b.host_tier.close()
    finally:
        pod_a.host_tier.close()


def test_shared_tier_peer_down_degrades_to_recompute(jparams):
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    want = _port(jparams).generate([greedy("s", prompt, 3)])["s"]
    pod = _port(jparams, kv_shared_tier_peers=("127.0.0.1:1",))
    assert pod.generate([greedy("x", prompt, 3)])["x"] == want
    assert pod.host_tier.remote_hits == 0

