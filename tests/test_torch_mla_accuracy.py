"""Port parity: the int8-latent accuracy harness
(``llm_d_tpu_torch/ops/mla_accuracy.py``) against the JAX package's, as
``tests/test_mla_quant.py::test_absorption_harness_bounds_on_real_trace``
runs it.

* A bf16-latent ``tiny-mla`` engine of each package, the port's on JAX's
  weights, serves the same four greedy requests; the latent rows harvested
  from the port's cache equal the JAX engine's, bit for bit (the bf16
  latent widened to f32).
* ``absorbed_queries`` of layer 0 on the same hidden states matches JAX's
  at atol = rtol = 1e-4 (both q_eff and w_uv).
* ``absorption_error_report`` on those rows and queries gives JAX's
  numbers at rtol = 1e-4, and the bounds hold as the JAX test asserts
  them: each absorption's relative RMS within its bound, and the end to
  end error within twice the value bound.
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops import mla_accuracy as tacc
from llm_d_tpu_torch.ops.sampling import SamplingParams

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

ENGINE_KW = dict(model="tiny-mla", block_size=4, num_blocks=64,
                 max_num_seqs=4, max_num_batched_tokens=64,
                 min_token_bucket=16, min_seq_bucket=4)
PROMPTS = {f"t{i}": [(7 * i + 13 * j) % 500 + 1 for j in range(12)]
           for i in range(4)}
NEW = 6
TOL = dict(atol=1e-4, rtol=1e-4)


def _requests(cls_req, cls_sp):
    return [cls_req(request_id=r, prompt_token_ids=list(p),
                    sampling=cls_sp(temperature=0.0, max_tokens=NEW,
                                    ignore_eos=True))
            for r, p in PROMPTS.items()]


@pytest.fixture(scope="module")
def traced():
    """Both engines after the same traffic: (JAX engine, port engine, the
    JAX tokens, the port's)."""
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    import jax
    je = JEngineCore(JEngineConfig(**ENGINE_KW))
    jout = je.generate(_requests(JRequest, JSamplingParams))
    te = EngineCore(EngineConfig(device="cpu", **ENGINE_KW),
                    params=params_from_numpy(
                        jax.tree.map(np.asarray, je.params), "cpu"))
    tout = te.generate(_requests(Request, SamplingParams))
    return je, te, jout, tout


def _queries(je, te):
    """Layer 0's absorbed queries of both packages on the same bf16
    hidden states (8 rows, positions 0..7)."""
    import jax.numpy as jnp
    from llm_d_tpu.models.config import get_config as jget_config
    from llm_d_tpu.ops import mla_accuracy as jacc
    c = jget_config("tiny-mla")
    x = np.random.default_rng(0).standard_normal(
        (8, c.hidden_size)).astype(np.float32)
    jlp = {k: v[0] for k, v in je.params["moe_layers"].items()}
    jq, jw = jacc.absorbed_queries(jlp, c, jnp.asarray(x, jnp.bfloat16),
                                   jnp.arange(8, dtype=jnp.int32))
    tlp = {k: v[0] for k, v in te.params["moe_layers"].items()}
    tq, tw = tacc.absorbed_queries(
        tlp, tget_config("tiny-mla"),
        torch.from_numpy(x).to(torch.bfloat16),
        torch.arange(8, dtype=torch.int32))
    return (np.asarray(jq), np.asarray(jw)), (tq, tw)


def test_harvested_rows_equal_the_jax_engines(traced):
    from llm_d_tpu.ops import mla_accuracy as jacc
    je, te, jout, tout = traced
    assert tout == jout
    rows = tacc.harvest_latent_rows(te)
    jrows = jacc.harvest_latent_rows(je)
    assert rows.shape[0] >= 16, rows.shape          # traffic was traced
    np.testing.assert_array_equal(rows.numpy(), jrows)
    assert tacc.harvest_latent_rows(te, max_rows=5).shape[0] == 5


def test_absorbed_queries_match_jax(traced):
    je, te, _, _ = traced
    (jq, jw), (tq, tw) = _queries(je, te)
    assert tq.dtype == tw.dtype == torch.float32
    np.testing.assert_allclose(tq.numpy(), jq, **TOL)
    np.testing.assert_allclose(tw.numpy(), jw, **TOL)


def test_absorption_report_matches_jax_and_meets_the_bounds(traced):
    from llm_d_tpu.ops import mla_accuracy as jacc
    je, te, _, _ = traced
    (jq, jw), (tq, tw) = _queries(je, te)
    c = tget_config("tiny-mla")
    scale = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
    rows = tacc.harvest_latent_rows(te)
    rep = tacc.absorption_error_report(rows, tq, tw, c.kv_lora_rank,
                                       scale=scale)
    jrep = jacc.absorption_error_report(rows.numpy(), jq, jw,
                                        c.kv_lora_rank, scale=scale)
    assert rep["rows"] == jrep["rows"]
    for term in ("score", "value", "end_to_end"):
        for key, want in jrep[term].items():
            np.testing.assert_allclose(rep[term][key], want, rtol=1e-4,
                                       err_msg=f"{term}/{key}")
    assert rep["within_bounds"] == jrep["within_bounds"]
    # The JAX test's assertions, on the port's report.
    assert rep["score"]["rel_rms"] <= rep["score"]["bound_rel_rms"], rep
    assert rep["value"]["rel_rms"] <= rep["value"]["bound_rel_rms"], rep
    assert rep["within_bounds"] is True
    assert rep["end_to_end"]["rel_rms"] <= 2 * tacc.VALUE_REL_BOUND
    assert (tacc.SCORE_REL_BOUND, tacc.VALUE_REL_BOUND) == \
        (jacc.SCORE_REL_BOUND, jacc.VALUE_REL_BOUND)
