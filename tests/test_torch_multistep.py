"""Port parity: multistep and async scheduling in the port's EngineCore
(``num_scheduler_steps`` > 1, ``async_scheduling``) against the JAX
engine's classic multistep pipeline, on the CPU.

On CPU tensors a decode block's body runs eagerly (the card replays it
as a CUDA graph: ``tests/test_torch_gpu.py``).  Every comparison is
exact:

* greedy tokens of the port's multistep run, sync and async, identical
  to the JAX engine's multistep run and to the port's classic run, on
  ``tiny-mla`` (int8 experts, int8 latent) and ``tiny`` (bf16, int8 per
  token, int8 per head) with ``num_scheduler_steps=4``;
* async against sync within the port (after ``tests/test_async_sched.py``):
  greedy rows and a seeded sampled row (temperature 0.7, seed 1234),
  max_tokens ending mid-block, on block boundaries and inside the first
  block; the pipeline engages; an abort in flight leaves the survivors'
  tokens as the sync run's; speculative tail blocks are all released
  after the drain; async scheduling is off by default and refused
  without multistep;
* the K sampling keys of every block equal ``jax.random.split(step_key,
  K)`` of the JAX engine's step key, bit for bit.
"""

import jax
import numpy as np
import pytest

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams

import torch

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

K = 4
MODES = {
    "tiny-mla": dict(model="tiny-mla", quantization="int8",
                     kv_cache_dtype="int8"),
    "tiny-bf16": dict(model="tiny", kv_cache_dtype="bf16"),
    "tiny-int8-token": dict(model="tiny", kv_cache_dtype="int8",
                            kv_scale_granularity="token"),
    "tiny-int8-head": dict(model="tiny", kv_cache_dtype="int8",
                           kv_scale_granularity="head"),
}


def _kw(mode, **over):
    kw = dict(block_size=8, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, min_token_bucket=16,
              min_seq_bucket=4, enable_prefix_caching=False,
              **MODES[mode])
    kw.update(over)
    return kw


def _port(kw, params=None):
    return EngineCore(EngineConfig(device="cpu", **kw), params=params)


# Prompts, max_tokens (ending mid-block, on block boundaries, inside the
# first block), temperature and seed: the cases of test_async_sched.py.
CASES = [
    ([1, 2, 3, 4, 5], 16, 0.0, None),      # 4 full blocks
    ([7, 8, 9], 10, 0.0, None),            # stops mid-block 3
    ([11, 12, 13, 14], 6, 0.0, None),      # stops mid-block 2
    ([3, 1, 4, 1, 5, 9], 13, 0.7, 1234),   # seeded sampling
    ([2, 7, 1, 8], 3, 0.0, None),          # shorter than one block
]


def _reqs(R=Request, SP=SamplingParams, tag="r", greedy_only=False):
    return [R(f"{tag}{i}", p, SP(temperature=t, max_tokens=m, seed=s,
                                 ignore_eos=True))
            for i, (p, m, t, s) in enumerate(CASES)
            if not (greedy_only and t > 0)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_multistep_greedy_tokens_identical_to_jax_and_classic(mode):
    """The JAX engine's multistep run (sync) against the port's multistep
    runs, sync and async, and the port's classic run, on the same
    weights: greedy tokens identical.  Block tables cross 8-row pages
    inside blocks, and the rows that finish inside a block become pad
    rows of its successor."""
    jeng = JEngineCore(JEngineConfig(num_scheduler_steps=K,
                                     **_kw(mode)))
    want = jeng.generate(_reqs(JRequest, JSamplingParams, greedy_only=True))
    assert jeng._dispatch_count < jeng._step_count
    tree = jax.tree.map(np.asarray, jeng.params)
    for steps, async_ in ((K, False), (K, True), (1, False)):
        eng = _port(_kw(mode, num_scheduler_steps=steps,
                        async_scheduling=async_),
                    params_from_numpy(tree, "cpu"))
        got = eng.generate(_reqs(greedy_only=True))
        assert got == want, (steps, async_)
        if steps > 1:
            assert eng._dispatch_count < eng._step_count


@pytest.mark.parametrize("mode", ["tiny-mla", "tiny-bf16"])
def test_async_matches_sync(mode):
    """Greedy rows and the seeded sampled row: async tokens identical to
    sync, and the sync multistep run identical to the classic run."""
    sync = _port(_kw(mode, num_scheduler_steps=K)).generate(_reqs())
    async_ = _port(_kw(mode, num_scheduler_steps=K,
                       async_scheduling=True)).generate(_reqs())
    assert sync == async_
    assert all(len(v) for v in sync.values())
    assert len(set(sync["r3"])) > 1
    classic = _port(_kw(mode)).generate(_reqs())
    assert classic == sync


def _in_flight(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    for _ in range(100):
        eng.step()
        if eng._inflight is not None:
            return
    raise AssertionError("pipeline never went in flight")


def test_async_pipeline_actually_engages():
    eng = _port(_kw("tiny-bf16", num_scheduler_steps=K,
                    async_scheduling=True))
    reqs = _reqs()
    _in_flight(eng, reqs)
    for _ in range(200):
        if not eng.has_work():
            break
        eng.step()
    assert eng._inflight is None
    assert [len(r.output_token_ids) for r in reqs] == [c[1] for c in CASES]


def test_async_abort_in_flight():
    eng = _port(_kw("tiny-bf16", num_scheduler_steps=K,
                    async_scheduling=True))
    reqs = _reqs(tag="a")
    _in_flight(eng, reqs)
    eng.abort_request("a0")           # longest-running request, mid-flight
    for _ in range(500):
        if not eng.has_work():
            break
        eng.step()
    assert not eng.has_work()
    # The aborted request stopped early; the survivors match the sync run.
    assert len(reqs[0].output_token_ids) < 16
    sync = _port(_kw("tiny-bf16", num_scheduler_steps=K)).generate(
        _reqs(tag="s"))
    for i in (1, 2, 3, 4):
        assert list(reqs[i].output_token_ids) == sync[f"s{i}"]


def test_async_blocks_released_after_drain():
    """Speculative tail blocks must not leak once everything finishes."""
    eng = _port(_kw("tiny-bf16", num_scheduler_steps=K,
                    async_scheduling=True))
    eng.generate(_reqs())
    assert eng.scheduler.num_running == 0
    assert eng.kv_manager.num_free_blocks == eng.kv_manager.num_blocks - 1


def test_async_off_by_default_and_refused_without_multistep():
    assert EngineConfig().async_scheduling is False
    assert EngineConfig().num_scheduler_steps == 1
    with pytest.raises(ValueError, match="num_scheduler_steps > 1"):
        _port(_kw("tiny-bf16", async_scheduling=True))


def test_block_keys_are_jax_splits_of_the_step_key():
    """Each block's K keys (the rows of the body's ``keys``) equal
    ``jax.random.split(step_key, K)`` of the key the JAX engine hands its
    multistep program at the same dispatch, bit for bit; the engine keys
    split in between (prefill steps) stay in step too."""
    kw = _kw("tiny-bf16", num_scheduler_steps=K, seed=11)
    jeng = JEngineCore(JEngineConfig(**kw))
    want = []
    jfn = jeng._multistep_fn

    def recording(params, kv, mbatch, rng):
        want.append(np.asarray(jax.random.key_data(
            jax.random.split(rng, K))).astype(np.int64))
        return jfn(params, kv, mbatch, rng)

    jeng._multistep_fn = recording
    jeng.generate(_reqs(JRequest, JSamplingParams, greedy_only=True))
    eng = _port(kw)
    got = []
    body = eng._ms_body

    def spy(mb, keys, ids, random_rows):
        got.append(keys.numpy().copy())
        return body(mb, keys, ids, random_rows)

    eng._ms_body = spy
    eng.generate(_reqs(greedy_only=True))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_graph_capture_holds_the_collector_off(monkeypatch):
    """A block's body is recorded with the cyclic garbage collector off
    (and on again after, also when the body raises): a dead engine's
    pinned buffers freed by a collection inside a capture would abort
    the process on the card.  The CUDA calls of ``_capture`` are stood in
    for on the CPU; the warm-up runs with the collector on."""
    import contextlib
    import gc
    import types
    import torch
    from llm_d_tpu_torch.engine import cuda_graph

    class _Stream:
        def wait_stream(self, other):
            pass

    fakes = dict(current_stream=lambda *a: _Stream(),
                 Stream=lambda *a: _Stream(),
                 stream=lambda s: contextlib.nullcontext(),
                 synchronize=lambda *a: None, empty_cache=lambda: None,
                 memory_reserved=lambda *a: 0, CUDAGraph=object,
                 graph=lambda g, pool=None: contextlib.nullcontext())
    for name, fake in fakes.items():
        monkeypatch.setattr(torch.cuda, name, fake)
    graphs = object.__new__(cuda_graph.DecodeGraphs)
    graphs.device, graphs.pool, graphs.pool_bytes = "cpu", None, 0
    seen = {}

    def body(n):
        seen[n] = gc.isenabled()

    assert gc.isenabled()
    graphs._capture(types.SimpleNamespace(key="k"), body, 4)
    assert seen == {1: True, 4: False}
    assert gc.isenabled()

    def failing(n):
        if n > 1:
            raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        graphs._capture(types.SimpleNamespace(key="k"), failing, 4)
    assert gc.isenabled()
