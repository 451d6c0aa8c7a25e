"""Port parity: the tp engine's 4-step async decode blocks against the JAX
engine on ``MeshConfig(tp=2)``, and what the port refuses on a mesh.

* Greedy tokens at tp = 2 with ``num_scheduler_steps=4`` and async
  scheduling equal the JAX engine's on ``tiny``, ``tiny-mla`` (int8
  experts, int8 latent) and ``tiny-moe``; every rank's tokens are
  identical (2 gloo ranks, spawned once for the file, each call with a
  deadline).
* An abort and a deadline reach every rank at the step that sees them
  (the deadline read against rank 0's clock).
* Refused by name: spec decode, the host tier, P/D, EPLB at ep > 1, a
  step-time target and captured blocks on a gloo mesh on CUDA on a mesh;
  DBO everywhere; dp and sp meshes; the server's flags for them before
  any rank starts, and ``--tensor-parallel-size`` /
  ``--allow-device-subset`` map to the engine's mesh.
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
    "spec decode": dict(spec_k=2),
    "host and shared KV tiers": dict(kv_offload_blocks=8),
    "EPLB at ep = 2": dict(model="tiny-moe", enable_eplb=True),
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


def rank_pd_refusal():
    """Rank side: a KV connector (P/D) on a mesh engine is refused at
    its first step, by name."""
    eng = EngineCore(EngineConfig(model="tiny", device="cpu",
                                  mesh=MeshConfig(tp=TP), **ENGINE))
    if eng.mesh.rank != 0:
        return None
    eng.kv_connector = object()
    try:
        eng.step()
    except ValueError as e:
        return str(e)
    return None


def test_refused_by_name_on_a_mesh(pool):
    for errors in pool.run(rank_refusals):
        for name, msg in errors.items():
            assert msg is not None and "not served on mesh" in msg, name
            assert name.split()[0] in msg, (name, msg)
    msg = pool.run(rank_pd_refusal)[0]
    assert msg is not None and "P/D" in msg


@pytest.mark.parametrize("flags,named", [
    (["--kv-transfer-config", '{"kv_role": "kv_producer"}'],
     "--kv-transfer-config"),
    (["--kv-offload-blocks", "8"], "--kv-offload-blocks"),
    (["--spec-k", "2"], "--spec-k"),
    (["--enable-eplb"], "--enable-eplb"),
    (["--num-scheduler-steps", "4", "--async-scheduling"],
     "--num-scheduler-steps 4"),
    (["--data-parallel-size", "2"], "--data-parallel-size"),
    (["--enable-dbo"], "--enable-dbo")])
def test_the_server_refuses_by_name_before_any_rank_starts(flags, named,
                                                           capsys):
    """With ``--tensor-parallel-size 2`` on the card (no ``--device
    cpu``): ranks sharing a card would run gloo, so captured blocks are
    refused too."""
    from llm_d_tpu_torch.server import openai as TServer
    p = TServer.build_arg_parser()
    args = p.parse_args(["--tensor-parallel-size", "2"] + flags)
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
    class FakeMesh:
        stage_host = True
        config = MeshConfig(tp=TP)
    fake = type("Fake", (), {})()
    fake.config = EngineConfig(num_scheduler_steps=4, async_scheduling=True)
    fake.mesh, fake.spec_k, fake._step_time_target_ms = FakeMesh(), 0, 0.0
    with pytest.raises(ValueError, match="gloo collectives cannot be "
                                         "captured"):
        EngineCore._check_mesh(fake)
    with pytest.raises(ValueError, match="enable_dbo"):
        EngineCore(EngineConfig(enable_dbo=True, device="cpu"))
    with pytest.raises(ValueError, match="dp > 1"):
        EngineCore(EngineConfig(mesh=MeshConfig(dp=2, tp=2), device="cpu"))
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
