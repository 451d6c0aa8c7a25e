"""Port parity: the engine on a mesh with an ``sp`` axis, served as the
JAX engine serves it (``EngineConfig.mesh = MeshConfig(sp=2)`` and
``MeshConfig(sp=2, tp=2)``): attention and the KV cache replicated over
sp and split over tp by the same rule tables, the routed experts over all
``sp * tp`` ranks, rank 0 ordering the others.  The port's ranks are gloo
processes (one ``RankPool`` of 2 and one of 4 for the file).

* Greedy tokens equal the JAX engine's on the same mesh on ``tiny-moe``
  and ``tiny-mla`` (int8 experts, int8 latent), with JAX's weights carried
  across; every rank holds the same tokens; each rank's KV plane is the
  whole pool (W over tp for GQA K/V) and its routed-expert bytes are the
  total / (sp * tp); ``llmd_tpu:collective_bytes_total`` equals JAX's.
* dp = 2 with sp = 2 is refused with the JAX engine's message.
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
from llm_d_tpu_torch.parallel.mesh import MeshConfig

from test_torch_tp import ENGINE, MODELS, PROMPTS, collective_bytes

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

MESHES = {"sp2": (1, 2, 1), "sp2-tp2": (1, 2, 2)}
SP_MODELS = ("tiny-mla", "tiny-moe")


@pytest.fixture(scope="module")
def pools():
    with RankPool(2, timeout_s=120) as p2, RankPool(4, timeout_s=120) as p4:
        yield {2: p2, 4: p4}


def _requests(cls_req, cls_sp):
    return [cls_req(request_id=r, prompt_token_ids=list(p),
                    sampling=cls_sp(temperature=0.0, max_tokens=5,
                                    ignore_eos=True))
            for r, p in PROMPTS.items()]


def jax_generate(devices, model, mesh, kw):
    """The JAX engine on ``MeshConfig(*mesh)``: (tokens, its weights as
    numpy, its collective bytes)."""
    import jax
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    n = int(np.prod(mesh))
    e = JEngineCore(JEngineConfig(model=model, mesh=JMeshConfig(*mesh),
                                  allow_device_subset=True, **ENGINE, **kw),
                    devices=list(devices)[:n])
    out = e.generate(_requests(JRequest, JSamplingParams))
    return (out, jax.tree.map(np.asarray, e.params),
            collective_bytes(e.metrics.render().decode()))


def rank_generate(model, mesh, tree, kw):
    """Rank side: the sp engine on the JAX tree; rank 0 serves the
    requests, the others follow.  Returns (tokens, collective bytes on
    rank 0, this rank's cache shapes, its routed-expert bytes)."""
    eng = EngineCore(EngineConfig(model=model, device="cpu",
                                  mesh=MeshConfig(*mesh), **ENGINE, **kw),
                     params=params_from_numpy(tree, "cpu"))
    shapes = {k: tuple(v.shape) for k, v in eng.kv_cache.items()}
    ml = eng.params["moe_layers"]
    experts = sum(v.numel() * v.element_size() for k, v in ml.items()
                  if k.startswith(("w_gate", "w_up", "w_down")))
    if eng.mesh.rank != 0:
        return eng.follow(), None, shapes, experts
    out = eng.generate(_requests(Request, SamplingParams))
    eng.stop_mesh()
    return (out, collective_bytes(eng.metrics.render().decode()), shapes,
            experts)


@pytest.mark.parametrize("model", SP_MODELS)
@pytest.mark.parametrize("label", sorted(MESHES))
def test_greedy_tokens_on_an_sp_mesh_equal_the_jax_engine(pools, devices,
                                                          label, model):
    mesh = MESHES[label]
    world = int(np.prod(mesh))
    want, tree, jbytes = jax_generate(devices, model, mesh, MODELS[model])
    out = pools[world].run(rank_generate, model, mesh, tree, MODELS[model])
    tokens = [o[0] for o in out]
    assert tokens[0] == want
    assert all(t == want for t in tokens)
    assert out[0][1] == jbytes
    c = tget_config(model)
    tp = mesh[2]
    slots = ENGINE["num_blocks"] * ENGINE["block_size"]
    for o in out:
        for name, w in get_model(c).kv_cache_layout(c).items():
            width = w if c.use_mla else w // tp
            assert o[2][name] == (c.num_layers, slots, width), name
    total = sum(a.nbytes for k, a in tree["moe_layers"].items()
                if k.startswith(("w_gate", "w_up", "w_down")))
    assert [o[3] for o in out] == [total // world] * world


def test_dp_and_sp_together_refused_in_the_jax_engines_words(devices):
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    with pytest.raises(ValueError) as jerr:
        JEngineCore(JEngineConfig(model="tiny", mesh=JMeshConfig(dp=2, sp=2),
                                  allow_device_subset=True, **ENGINE),
                    devices=list(devices)[:4])
    with pytest.raises(ValueError) as terr:
        EngineCore(EngineConfig(model="tiny", device="cpu",
                                mesh=MeshConfig(dp=2, sp=2), **ENGINE))
    assert str(terr.value) == str(jerr.value)
    assert "SPMD dp and sp are mutually exclusive" in str(terr.value)
