"""Port parity: int8 quantization (llm_d_tpu_torch.ops.quant vs
llm_d_tpu.ops.quant).

The scale planes must match bit for bit.  The JAX package always runs
these functions under ``jit`` (the engine step, ``_quantize_int8_jit``),
so the reference here is the jitted form: XLA turns ``/ 127.0`` into a
multiply by the f32 reciprocal there, and the port follows it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.ops import quant as JQ
from llm_d_tpu_torch.models.convert import tensor_from_numpy
from llm_d_tpu_torch.ops import quant as TQ

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _vals(x):
    """numpy / torch array -> numpy with bf16 widened to f32 values."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("shape,dtype", [
    ((3, 64, 48), np.float32), ((2, 4, 96, 32), np.float32),
    ((128, 40), "bfloat16")])
def test_quantize_int8_bit_exact(shape, dtype):
    rng = np.random.default_rng(hash(shape) % 2**32)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0, 0] = 0.0                       # a column may be all-zero
    w[..., :, 1] = 0.0
    wj = jnp.asarray(w, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    qj, sj = jax.jit(JQ.quantize_int8)(wj)
    qt, st = TQ.quantize_int8(tensor_from_numpy(_np(wj), "cpu"))
    np.testing.assert_array_equal(qt.numpy(), _np(qj))
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    np.testing.assert_array_equal(
        TQ.dequantize(qt, st).float().numpy(),
        _np(JQ.dequantize(qj, sj)).astype(np.float32))


@pytest.mark.parametrize("sw", [1, 4])
def test_quantize_kv_block_bit_exact(sw):
    rng = np.random.default_rng(11 + sw)
    rows = jnp.asarray(rng.standard_normal((3, 17, 128)) * 2, jnp.bfloat16)
    qj, sj = jax.jit(JQ.quantize_kv_block, static_argnums=1)(rows, sw)
    qt, st = TQ.quantize_kv_block(tensor_from_numpy(_np(rows), "cpu"), sw)
    np.testing.assert_array_equal(qt.numpy(), _np(qj))
    np.testing.assert_array_equal(st.numpy(), _np(sj))
    np.testing.assert_array_equal(
        TQ.dequantize_kv_block(qt, st, torch.float32).numpy(),
        _np(JQ.dequantize_kv_block(qj, sj, jnp.float32)))
    assert TQ.kv_scale_width(4, "head") == JQ.kv_scale_width(4, "head") == 4
    assert TQ.kv_scale_width(4, "token") == JQ.kv_scale_width(4, "token") == 1


def test_quantize_moe_experts_bit_exact():
    rng = np.random.default_rng(5)
    L, E, H, I = 2, 4, 64, 32
    ml = {
        "w_gate": jnp.asarray(rng.standard_normal((L, E, H, I)) * 0.1,
                              jnp.bfloat16),
        "w_up": jnp.asarray(rng.standard_normal((L, E, H, I)) * 0.1,
                            jnp.bfloat16),
        "w_down": jnp.asarray(rng.standard_normal((L, E, I, H)) * 0.1,
                              jnp.bfloat16),
        "router": jnp.asarray(rng.standard_normal((L, H, E)), jnp.float32),
    }
    got = TQ.quantize_moe_experts(
        {"moe_layers": {k: tensor_from_numpy(_np(v), "cpu")
                        for k, v in ml.items()}})["moe_layers"]
    want = JQ.quantize_moe_experts({"moe_layers": ml})["moe_layers"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_vals(got[k]), _vals(want[k]))
