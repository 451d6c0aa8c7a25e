"""Port parity: the tp engine's 4-step async decode blocks against the JAX
engine on ``MeshConfig(tp=2)``, and what the port refuses on a mesh.

* Greedy tokens at tp = 2 with ``num_scheduler_steps=4`` and async
  scheduling equal the JAX engine's on ``tiny``, ``tiny-mla`` (int8
  experts, int8 latent) and ``tiny-moe``; every rank's tokens are
  identical (2 gloo ranks, spawned once for the file, each call with a
  deadline).
* An abort and a deadline reach every rank at the step that sees them
  (the deadline read against rank 0's clock).
* Refused by name: the shared KV tier and a step-time target on a mesh;
  DBO on a dense model; sp meshes; the server's flags for them and the
  multi-host DP flags before any rank starts, and
  ``--tensor-parallel-size`` / ``--allow-device-subset`` map to the
  engine's mesh.  A gloo mesh on CUDA runs its blocks eagerly.  (P/D,
  EPLB at ep > 1, DBO, spec decode, the fused rounds and the host tier
  on a mesh are served: ``tests/test_torch_wide_ep.py``,
  ``tests/test_torch_pd_mesh.py``, ``tests/test_torch_spec_mesh.py``.)
"""

import time

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


REFUSALS = {
    "shared KV tier port": dict(kv_offload_blocks=8, kv_shared_tier_port=0),
    "shared KV tier peers": dict(kv_offload_blocks=8,
                                 kv_shared_tier_peers=("127.0.0.1:9",)),
    "LLMD_STEP_TIME_TARGET_MS": dict(env=("LLMD_STEP_TIME_TARGET_MS", "50")),
}


def rank_refusals():
    """Rank side: each refused configuration's error on this rank."""
    import os
    out = {}
    for name, over in REFUSALS.items():
        over = dict(over)
        env = over.pop("env", None)
        if env:
            os.environ[env[0]] = env[1]
        cfg = dict(ENGINE, model="tiny", device="cpu",
                   mesh=MeshConfig(tp=TP))
        cfg.update(over)
        try:
            EngineCore(EngineConfig(**cfg))
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
        finally:
            if env:
                del os.environ[env[0]]
    return out


def test_refused_by_name_on_a_mesh(pool):
    for errors in pool.run(rank_refusals):
        for name, msg in errors.items():
            assert msg is not None and "not served on mesh" in msg, name
            assert name.split()[0] in msg, (name, msg)


# The multi-host flags in spmd mode: each refused by name as ranks mode's
# (where they are served since the leader's dispatch).
ACROSS_HOSTS = ["--data-parallel-size", "2", "--data-parallel-size-local",
                "1"]


@pytest.mark.parametrize("flags,named", [
    (ACROSS_HOSTS + ["--data-parallel-address", "10.0.0.1"],
     "--data-parallel-address"),
    (["--kv-offload-blocks", "8", "--kv-shared-tier-port", "0"],
     "--kv-shared-tier-port"),
    (["--kv-offload-blocks", "8", "--kv-shared-tier-peers", "h:9"],
     "--kv-shared-tier-peers"),
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
    cpu``): the shared tier and one mesh across hosts (the multi-host
    flags are served in ranks mode, ``tests/test_torch_dp_multihost.py``).
    Spec decode, the host tier and multistep blocks are served on a mesh
    (``tests/test_torch_spec_mesh.py``)."""
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    args = p.parse_args(["--tensor-parallel-size", "2"] + flags)
    if named is None:
        # A --data-parallel-size-local below the size is served since: one
        # host holds the mesh outside an LWS group (tests/test_torch_lws.py).
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
    fake = type("Fake", (), {})()
    fake.config = EngineConfig(num_scheduler_steps=4, async_scheduling=True)
    fake.mesh, fake.spec_k, fake._step_time_target_ms = FakeMesh(), 0, 0.0
    EngineCore._check_mesh(fake)
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
