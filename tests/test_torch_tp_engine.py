"""Port parity: the tp engine's 4-step async decode blocks against the JAX
engine on ``MeshConfig(tp=2)``, a step-time target on the mesh, and what
the port refuses on a mesh.

* Greedy tokens at tp = 2 with ``num_scheduler_steps=4`` and async
  scheduling equal the JAX engine's on ``tiny``, ``tiny-mla`` (int8
  experts, int8 latent) and ``tiny-moe``; every rank's tokens are
  identical (2 gloo ranks, spawned once for the file, each call with a
  deadline).
* An abort and a deadline reach every rank at the step that sees them
  (the deadline read against rank 0's clock).
* ``LLMD_STEP_TIME_TARGET_MS`` on the mesh: rank 1's step-time model is
  fed other samples than rank 0's, yet every rank's prefill chunks are
  rank 0's (its cap rides the step channel) and the tokens equal the JAX
  engine's at tp = 2.
* Refused by name: DBO on a dense model; the multi-host DP flags before
  any rank starts, and ``--tensor-parallel-size`` /
  ``--allow-device-subset`` map to the engine's mesh.  A gloo mesh on
  CUDA runs its blocks eagerly.  (P/D, EPLB at ep > 1, DBO, spec decode,
  the fused rounds, the host tier and the shared tier on a mesh are
  served: ``tests/test_torch_wide_ep.py``, ``tests/test_torch_pd_mesh.py``,
  ``tests/test_torch_spec_mesh.py``, ``tests/test_torch_shared_tier_mesh.py``.)
"""

import time

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request, RequestState
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import MeshConfig

from test_torch_tp import ENGINE, MODELS, TP, jax_generate, rank_generate

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

BLOCKS = dict(num_scheduler_steps=4, async_scheduling=True)


@pytest.fixture(scope="module")
def pool():
    with RankPool(TP, timeout_s=120) as p:
        yield p


@pytest.mark.parametrize("model", sorted(MODELS))
def test_async_blocks_at_tp2_equal_the_jax_engine(pool, devices, model):
    kw = dict(MODELS[model], **BLOCKS)
    want, tree, jbytes = jax_generate(devices, model, kw)
    out = pool.run(rank_generate, model, tree, kw)
    tokens = [o[0] for o in out]
    assert tokens[0] == want
    assert all(t == tokens[0] for t in tokens)
    assert out[0][1] == jbytes


def rank_abort_and_deadline():
    """Rank side: rank 0 aborts one request after two steps, and another's
    deadline passes on rank 0's clock before the third; every rank must
    drop both at the same step."""
    eng = EngineCore(EngineConfig(model="tiny", device="cpu",
                                  mesh=MeshConfig(tp=TP), **ENGINE))
    if eng.mesh.rank != 0:
        return eng.follow()
    reqs = [Request(f"r{i}", [3 + i, 5, 7, 9], SamplingParams(
        temperature=0.0, max_tokens=8, ignore_eos=True)) for i in range(3)]
    reqs[2].deadline = time.monotonic() + 2.0
    for r in reqs:
        eng.add_request(r)
    eng.step()
    eng.step()
    eng.abort_request("r0")
    time.sleep(max(0.0, reqs[2].deadline - time.monotonic()) + 0.1)
    while eng.has_work():
        eng.step()
    eng.stop_mesh()
    assert reqs[0].state is RequestState.FINISHED_ABORTED
    assert reqs[2].state is RequestState.FINISHED_DEADLINE
    return {r.request_id: list(r.output_token_ids) for r in reqs}


def test_aborts_and_deadlines_reach_every_rank(pool):
    out = pool.run(rank_abort_and_deadline)
    assert out[0] == out[1]
    assert len(out[0]["r0"]) == 2 and len(out[0]["r1"]) == 8
    assert len(out[0]["r2"]) == 2


# LLMD_STEP_TIME_TARGET_MS on the mesh: rank 0's model learns
# ``step_ms = 1 + 0.1 * prefill + 0.2 * decode`` (a cap of 24 tokens at no
# decode load under 3.4 ms); rank 1's learns a law that would cap nothing.
STEP_TARGET_MS = "3.4"
STEP_PROMPTS = {"p1": list(range(3, 63)), "p2": [5, 9, 2, 7, 11]}


def _train(model, law):
    for p in range(0, 64, 8):
        for d in (0, 4, 8):
            model.observe(p, d, law(p, d))


def _law_rank0(p, d):
    return 1.0 + 0.1 * p + 0.2 * d


def _step_requests(R, SP):
    return [R(request_id=r, prompt_token_ids=list(p), sampling=SP(
        temperature=0.0, max_tokens=5, ignore_eos=True))
        for r, p in STEP_PROMPTS.items()]


def rank_step_time(model, tree):
    """Rank side: a tp engine under the step-time target, rank 0's model
    trained on ``_law_rank0`` and frozen there, rank 1's on another law
    and left to learn its own step times.  Returns (tokens, this rank's
    prefill chunk sizes)."""
    import os
    os.environ["LLMD_STEP_TIME_TARGET_MS"] = STEP_TARGET_MS
    try:
        eng = EngineCore(EngineConfig(model=model, device="cpu",
                                      mesh=MeshConfig(tp=TP), **ENGINE,
                                      **MODELS[model]),
                         params=params_from_numpy(tree, "cpu"))
    finally:
        del os.environ["LLMD_STEP_TIME_TARGET_MS"]
    if eng.mesh.rank != 0:
        _train(eng.step_time_model, lambda p, d: 1.0 + 0.001 * p)
        return eng.follow(), list(eng.prefill_chunks)
    _train(eng.step_time_model, _law_rank0)
    eng.step_time_model.observe = lambda *a: None
    out = eng.generate(_step_requests(Request, SamplingParams))
    eng.stop_mesh()
    return out, list(eng.prefill_chunks)


@pytest.mark.parametrize("model", ["tiny", "tiny-mla"])
def test_step_time_target_on_the_mesh_follows_rank_0(pool, devices, model,
                                                     monkeypatch):
    import jax
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    monkeypatch.setenv("LLMD_STEP_TIME_TARGET_MS", STEP_TARGET_MS)
    monkeypatch.delenv("LLMD_PREFILL_CHUNK", raising=False)
    e = JEngineCore(JEngineConfig(model=model, mesh=JMeshConfig(tp=TP),
                                  allow_device_subset=True, **ENGINE,
                                  **MODELS[model]),
                    devices=list(devices)[:TP])
    _train(e.step_time_model, _law_rank0)
    e.step_time_model.observe = lambda *a: None
    want = e.generate(_step_requests(JRequest, JSamplingParams))
    tree = jax.tree.map(np.asarray, e.params)
    out = pool.run(rank_step_time, model, tree)
    assert out[0][0] == want
    assert out[1][0] == want
    chunks = out[0][1]
    assert out[1][1] == chunks
    # The cap engaged: the 60-token prompt, whole in one step of the 64
    # token budget without it, took chunks of at most 24 (the first step
    # also prefilled the 5-token prompt).
    assert len(chunks) >= 3 and max(chunks[1:]) <= 24
    assert sum(chunks) == sum(len(p) for p in STEP_PROMPTS.values())


# The multi-host flags in spmd mode: each refused by name as ranks mode's
# (where they are served since the leader's dispatch).
ACROSS_HOSTS = ["--data-parallel-size", "2", "--data-parallel-size-local",
                "1"]


@pytest.mark.parametrize("flags,named", [
    (ACROSS_HOSTS + ["--data-parallel-address", "10.0.0.1"],
     "--data-parallel-address"),
    # Served since (the shared tier on a mesh): the cases keep their ids.
    pytest.param(["--kv-offload-blocks", "8", "--kv-shared-tier-port", "0"],
                 None, id="flags1---kv-shared-tier-port"),
    pytest.param(["--kv-offload-blocks", "8", "--kv-shared-tier-peers",
                  "h:9"], None, id="flags2---kv-shared-tier-peers"),
    (ACROSS_HOSTS + ["--data-parallel-rpc-port", "5555"],
     "--data-parallel-rpc-port"),
    # Served since: the case keeps its id.
    pytest.param(["--data-parallel-size-local", "1",
                  "--data-parallel-size", "2"], None,
                 id="flags4---data-parallel-size-local 1"),
    (ACROSS_HOSTS + ["--data-parallel-workers", "w1:8200"],
     "--data-parallel-workers"),
    (ACROSS_HOSTS + ["--data-parallel-hybrid-lb"],
     "--data-parallel-hybrid-lb")])
def test_the_server_refuses_by_name_before_any_rank_starts(flags, named,
                                                           capsys):
    """With ``--tensor-parallel-size 2`` on the card (no ``--device
    cpu``): one mesh across hosts (the multi-host flags are served in
    ranks mode, ``tests/test_torch_dp_multihost.py``).  Spec decode, the
    host and shared tiers and multistep blocks are served on a mesh
    (``tests/test_torch_spec_mesh.py``,
    ``tests/test_torch_shared_tier_mesh.py``)."""
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    args = p.parse_args(["--tensor-parallel-size", "2"] + flags)
    if named is None:
        # A --data-parallel-size-local below the size is served since: one
        # host holds the mesh outside an LWS group (tests/test_torch_lws.py);
        # so is the shared tier on a mesh.
        TServer.check_served(p, args)
        TServer.check_mesh_flags(p, args)
        assert capsys.readouterr().err == ""
        return
    with pytest.raises(SystemExit) as e:
        TServer.check_served(p, args)
        TServer.check_mesh_flags(p, args)
    assert e.value.code == 2
    assert named in capsys.readouterr().err


def test_tensor_parallel_flags_map_to_the_mesh():
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    args = p.parse_args(["--tensor-parallel-size", "4",
                         "--allow-device-subset", "--device", "cpu",
                         "--num-scheduler-steps", "4", "--async-scheduling"])
    TServer.check_served(p, args)
    TServer.check_mesh_flags(p, args)          # the CPU runs blocks eagerly
    cfg = TServer.engine_config_from_args(args)
    assert cfg.mesh == MeshConfig(tp=4) and cfg.allow_device_subset
    assert TServer.engine_config_from_args(p.parse_args([])).mesh is None


def test_gloo_on_cuda_refuses_captured_blocks_and_dbo_is_refused():
    """A gloo mesh on CUDA captures no block: its 4-step async blocks are
    served with the bodies run eagerly (the rule is the backend's, decided
    at build)."""
    class FakeMesh:
        stage_host = True
        config = MeshConfig(tp=TP)
    assert not EngineCore.captures_bodies(torch.device("cuda"), FakeMesh())
    with pytest.raises(ValueError, match="enable_dbo"):
        EngineCore(EngineConfig(enable_dbo=True, device="cpu"))
    # dp and sp together are refused in the JAX engine's words; sp alone
    # is served (tests/test_torch_sp.py), so it gets as far as the ranks.
    with pytest.raises(ValueError, match="dp and sp are mutually exclusive"):
        EngineCore(EngineConfig(mesh=MeshConfig(dp=2, sp=2), device="cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        EngineCore(EngineConfig(mesh=MeshConfig(sp=2, tp=2), device="cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        EngineCore(EngineConfig(mesh=MeshConfig(tp=2), device="cpu"))


def test_mesh_of_one_is_the_one_device_engine():
    tree_free = EngineCore(EngineConfig(model="tiny", device="cpu",
                                        mesh=MeshConfig(tp=1), **ENGINE))
    assert tree_free.mesh is None
    one = EngineCore(EngineConfig(model="tiny", device="cpu", **ENGINE))
    for k, v in one.params["layers"].items():
        assert torch.equal(v, tree_free.params["layers"][k])
    assert params_from_numpy({}, "cpu") == {}
