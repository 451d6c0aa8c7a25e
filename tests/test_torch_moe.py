"""Port parity: MoE routing, the counting-sort tile layout, and the plain
versions of kernels C (dense int8) and D (routed int8).

Routing at the deepseek-v3-bench routing config (sigmoid + bias, 8 groups
keep 4, top-8 of 64) must pick identical experts with weights within
1e-6.  The tile layout metadata must be identical.  The kernels' plain
versions, driven through the port's own glue, are held to the TPU
kernels' glue in interpret mode with the scale-normalised tolerance of
tests/test_moe_int8_kernel.py (max error / max |output| <= 1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops import moe as JM
from llm_d_tpu.ops.quant import quantize_int8 as jquantize_int8
from llm_d_tpu_torch.models.config import get_config as tget_config
from llm_d_tpu_torch.models.convert import tensor_from_numpy
from llm_d_tpu_torch.ops import moe as TM


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _scaled_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("preset,T", [("deepseek-v3-bench", 130),
                                      ("tiny-moe", 21)])
def test_route_matches(preset, T):
    jc, tc = jget_config(preset), tget_config(preset)
    rng = np.random.default_rng(T)
    E = jc.num_experts
    logits = (rng.standard_normal((T, E)) * 2).astype(np.float32)
    logits[0, :] = 0.5                        # an all-tied row
    bias = (rng.standard_normal(E) * 0.1).astype(np.float32)
    eb = bias if jc.scoring_func == "sigmoid" else None
    wj, ij = JM.route(jnp.asarray(logits), jc,
                      e_bias=None if eb is None else jnp.asarray(eb))
    wt, it = TM.route(torch.from_numpy(logits), tc,
                      e_bias=None if eb is None else torch.from_numpy(eb))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)


def _routing(rng, T, k, E, dup_rows=3, skip_experts=(1, 5)):
    """Random routing with some empty experts and duplicate routes."""
    live = [e for e in range(E) if e not in skip_experts]
    idx = rng.choice(live, size=(T, k)).astype(np.int32)
    idx[:dup_rows, 1] = idx[:dup_rows, 0]      # duplicate (token, expert)
    w = np.abs(rng.standard_normal((T, k))).astype(np.float32) * 0.4
    return idx, w


@pytest.mark.parametrize("T,k,E,rt", [(40, 8, 16, 32), (150, 8, 64, 32)])
def test_sorted_tile_layout_identical(T, k, E, rt):
    rng = np.random.default_rng(T + E)
    idx, w = _routing(rng, T, k, E)
    flat = idx.reshape(-1)
    want = JM._sorted_tile_layout(jnp.asarray(flat), jnp.asarray(w.reshape(-1)),
                                  k, E, rt)
    got = TM._sorted_tile_layout(torch.from_numpy(flat),
                                 torch.from_numpy(w.reshape(-1)), k, E, rt)
    names = ("order", "inv", "tok_s", "slot", "wslot_pad", "tile_expert",
             "num_tiles")
    for name, g, wv in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
    o_j, d_j, c_j = JM._stable_argsort_bounded(jnp.asarray(flat), E)
    o_t, d_t, c_t = TM._stable_argsort_bounded(torch.from_numpy(flat), E)
    for g, wv in ((o_t, o_j), (d_t, d_j), (c_t, c_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def _quant(rng, Lm, E, H, I, layer):
    quant = {"layer": layer}
    for name, shape in (("w_gate", (Lm, E, H, I)), ("w_up", (Lm, E, H, I)),
                        ("w_down", (Lm, E, I, H))):
        q, s = jquantize_int8(jnp.asarray(
            rng.standard_normal(shape) * 0.05, jnp.float32))
        quant[f"{name}_q"], quant[f"{name}_s"] = q, s
    tq = {k: (v if k == "layer" else _t(v)) for k, v in quant.items()}
    quant["layer"] = jnp.int32(layer)
    return quant, tq


@pytest.mark.parametrize("T,E,H,I,k", [(16, 8, 256, 128, 2),
                                       (40, 16, 128, 64, 8)])
def test_dense_int8_plain_matches_tpu_kernel(T, E, H, I, k):
    rng = np.random.default_rng(T * E)
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 1)
    want = JM._dense_int8_kernel_path(x, jnp.asarray(w), jnp.asarray(idx),
                                      jq, interpret=True)
    got = TM._dense_int8_kernel_path(_t(x), _t(w), _t(idx), tq)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("T,E,H,I,k,rt", [(24, 8, 256, 128, 2, 16),
                                          (70, 16, 128, 64, 8, 32)])
def test_routed_int8_plain_matches_tpu_kernel(T, E, H, I, k, rt):
    rng = np.random.default_rng(T + 1000 * E)
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 1)
    want = JM._routed_int8_kernel_path(x, jnp.asarray(w), jnp.asarray(idx),
                                       jq, row_tile=rt, interpret=True)
    got = TM._routed_int8_kernel_path(_t(x), _t(w), _t(idx), tq,
                                      row_tile=rt)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


@pytest.mark.parametrize("T", [24, 600])
def test_expert_ffn_cpu_path_matches(T):
    """The CPU path (dequantize, then dense or grouped) against the JAX
    package's CPU path, with int8 experts."""
    rng = np.random.default_rng(T)
    E, H, I, k = 8, 64, 32, 2
    x = jnp.asarray(rng.standard_normal((T, H)), jnp.bfloat16)
    idx, w = _routing(rng, T, k, E)
    jq, tq = _quant(rng, 2, E, H, I, 0)
    want = JM.expert_ffn(x, jnp.asarray(w), jnp.asarray(idx), None, None,
                         None, quant=jq)
    got = TM.expert_ffn(_t(x), _t(w), _t(idx), None, None, None, quant=tq)
    assert _scaled_err(got.float().numpy(), want) <= 1e-2


def test_group_routing_config_is_the_bench_one():
    c = tget_config("deepseek-v3-bench")
    assert (c.scoring_func, c.n_group, c.topk_group, c.num_experts,
            c.num_experts_per_tok) == ("sigmoid", 8, 4, 64, 8)
    assert dataclasses.asdict(c) == dataclasses.asdict(
        jget_config("deepseek-v3-bench"))
