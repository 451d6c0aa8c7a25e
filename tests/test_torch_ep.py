"""Port parity: expert parallelism over a mesh (the mesh half of
``ops/moe.py``: ``expert_ffn(..., mesh=)`` and ``expert_ffn_a2a``) and
the collective accuracy harness (``ops/collective_accuracy.py``) against
the JAX package.

* On 4 gloo ranks (spawned once for the file, each call with a deadline)
  against JAX's ``expert_ffn`` on a 4-device mesh (ep = 4), the inputs of
  ``tests/test_moe_a2a.py`` / ``tests/test_collective_quant.py`` from
  numpy seeds: the a2a and psum dispatches on the bf16 wire (atol = rtol
  = 3e-2, the JAX a2a tests' bound), unchunked, chunked and under skewed
  routing (every token to one rank's experts); the int8-dispatch and int8
  wires (2% rel-RMS against the bf16 wire and atol = rtol = 6e-2 against
  JAX's same wire, the JAX harness bounds); the quantized psum.  With int8
  experts each rank runs kernel E's plain version on its received rows
  (JAX dequantizes there on the CPU): held at the int8 bounds.  Every
  rank returns the same ``[T, H]``.  ``dense`` / ``ragged`` on a mesh
  raise as in JAX.
* The harness: ``collective_error_report`` / ``layer_reports`` on the
  JAX engine's harvested trace equal JAX's reports; the port's own
  harvest on the same weights and served streams gives JAX's trace (rows
  within 2e-2, routing equal but at near ties) and reports within the
  bounds.
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.ops import moe as TMoeOps
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import Mesh, MeshConfig

WORLD = 4
TOL = dict(atol=3e-2, rtol=3e-2)
TOL_INT8 = dict(atol=6e-2, rtol=6e-2)


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, timeout_s=90) as p:
        yield p


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _case(seed, T, E, H=32, I=16, k=2, skew=False):
    """numpy inputs (f32 values exact in bf16) and JAX's routing."""
    import jax.numpy as jnp
    from llm_d_tpu.models.config import ModelConfig
    from llm_d_tpu.ops import moe as JMoeOps
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    x = bf(rng.standard_normal((T, H)))
    router = rng.standard_normal((H, E)).astype(np.float32)
    wg = bf(rng.standard_normal((E, H, I)) * 0.2)
    wu = bf(rng.standard_normal((E, H, I)) * 0.2)
    wd = bf(rng.standard_normal((E, I, H)) * 0.2)
    cfg = ModelConfig(name="ep-test", num_experts=E, num_experts_per_tok=k,
                      moe_renormalize=True)
    w, idx = JMoeOps.route(jnp.dot(jnp.asarray(x), jnp.asarray(router)), cfg)
    w, idx = np.asarray(w), np.asarray(idx)
    if skew:
        idx = np.tile(np.asarray([[0, 1]], np.int32), (T, 1))
        w = np.full((T, k), 0.5, np.float32)
    return dict(x=x, w=w, idx=idx, wg=wg, wu=wu, wd=wd)


def _jax_ffn(case, mesh, dispatch, wire, chunk=None, quant=None):
    """JAX's EP path on ``mesh``, under ``jax.jit`` as the JAX engine runs
    it (eager ``shard_map`` takes ~20 s a call on the CPU)."""
    import jax
    import jax.numpy as jnp
    from llm_d_tpu.ops import moe as JMoeOps
    a = [jnp.asarray(case["x"], jnp.bfloat16), jnp.asarray(case["w"]),
         jnp.asarray(case["idx"])]
    ws = [jnp.asarray(case[n], jnp.bfloat16) for n in ("wg", "wu", "wd")]
    if quant is not None:
        q = {k: (jnp.asarray(v) if k != "layer" else v)
             for k, v in quant.items()}
        fn = jax.jit(lambda x, w, i: JMoeOps.expert_ffn(
            x, w, i, None, None, None, mesh=mesh, dispatch=dispatch,
            quant=q, collective_dtype=wire))
    elif chunk is not None:
        fn = jax.jit(lambda x, w, i, *ws: JMoeOps.expert_ffn_a2a(
            x, w, i, *ws, mesh, chunk_tokens=chunk, collective_dtype=wire))
    else:
        fn = jax.jit(lambda x, w, i, *ws: JMoeOps.expert_ffn(
            x, w, i, *ws, mesh=mesh, dispatch=dispatch,
            collective_dtype=wire))
    return np.asarray(fn(*a) if quant is not None else fn(*a, *ws),
                      np.float32)


def rank_expert_ffn(cases, e_rows=None):
    """Rank side: every (case, dispatch, wire, chunk, quant) spec through
    the port's EP path with this rank's experts.  With ``e_rows`` (a
    list) the row counts kernel E's wrapper received are appended to
    it, and it is returned beside the outputs."""
    from llm_d_tpu_torch.ops import moe_routed_stream
    m = Mesh.from_process_group(MeshConfig(tp=WORLD), torch.device("cpu"))
    out = []
    if e_rows is not None:
        real = moe_routed_stream.streamed_moe_int8

        def counted(x, *a, **kw):
            e_rows.append(x.shape[0])
            return real(x, *a, **kw)
        moe_routed_stream.streamed_moe_int8 = counted
    for case, dispatch, wire, chunk, quant in cases:
        x, w = _bf16(case["x"]), torch.from_numpy(case["w"])
        idx = torch.from_numpy(case["idx"])
        if quant is not None:
            E = quant["w_gate_q"].shape[1]
            sl = slice(m.rank * E // WORLD, (m.rank + 1) * E // WORLD)
            q = {k: (torch.from_numpy(np.ascontiguousarray(v[:, sl]))
                     if k != "layer" else v) for k, v in quant.items()}
            y = TMoeOps.expert_ffn(x, w, idx, None, None, None, quant=q,
                                   mesh=m, dispatch=dispatch,
                                   collective_dtype=wire)
        else:
            E = case["wg"].shape[0]
            sl = slice(m.rank * E // WORLD, (m.rank + 1) * E // WORLD)
            ws = [_bf16(case[n][sl]) for n in ("wg", "wu", "wd")]
            if chunk is not None:
                y = TMoeOps.expert_ffn_a2a(x, w, idx, *ws, m,
                                           chunk_tokens=chunk,
                                           collective_dtype=wire)
            else:
                y = TMoeOps.expert_ffn(x, w, idx, *ws, mesh=m,
                                       dispatch=dispatch,
                                       collective_dtype=wire)
        out.append(y.float().numpy())
    if e_rows is not None:
        moe_routed_stream.streamed_moe_int8 = real
        return out, e_rows
    return out


def _rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / max(np.sqrt(np.mean(b ** 2)), 1e-12))


def _check_ranks_equal(outs):
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)


def test_bf16_wire_a2a_and_psum_match_jax(pool, devices):
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(JMeshConfig(tp=WORLD), list(devices)[:WORLD])
    specs = []
    for name, case in (("T16E8", _case(1, 16, 8)), ("T32E16", _case(2, 32, 16)),
                       ("T16E64", _case(3, 16, 64)),
                       ("skew", _case(5, 16, 16, skew=True))):
        for dispatch in ("a2a", "psum"):
            specs.append((name, case, dispatch, "bf16", None))
    big = _case(11, 64, 16)
    specs += [("chunk8", big, "a2a", "bf16", 8),
              ("chunk2", big, "a2a", "bf16", 2)]
    outs = pool.run(rank_expert_ffn,
                    [(c, d, w, ch, None) for _, c, d, w, ch in specs])
    _check_ranks_equal(outs)
    for (name, case, dispatch, wire, chunk), got in zip(specs, outs[0]):
        want = _jax_ffn(case, mesh, dispatch, wire, chunk)
        np.testing.assert_allclose(got, want, err_msg=f"{name} {dispatch}",
                                   **TOL)
    # Chunked == unchunked, as in JAX.
    np.testing.assert_allclose(outs[0][-1], outs[0][-2], **TOL)


def test_int8_wires_match_jax_and_the_bounds(pool, devices):
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(JMeshConfig(tp=WORLD), list(devices)[:WORLD])
    specs = []
    for name, case in (("T16E16", _case(13, 16, 16)),
                       ("skew", _case(5, 32, 16, skew=True))):
        for dispatch, wire in (("a2a", "int8-dispatch"), ("a2a", "int8"),
                               ("psum", "int8"), ("a2a", "bf16"),
                               ("psum", "bf16")):
            specs.append((name, case, dispatch, wire, None))
    specs.append(("chunk2", _case(11, 64, 16), "a2a", "int8", 2))
    outs = pool.run(rank_expert_ffn,
                    [(c, d, w, ch, None) for _, c, d, w, ch in specs])
    _check_ranks_equal(outs)
    got = {(n, d, w): o for (n, _, d, w, _), o in zip(specs, outs[0])}
    for name, case, dispatch, wire, chunk in specs:
        mine = got[(name, dispatch, wire)]
        want = _jax_ffn(case, mesh, dispatch, wire, chunk)
        tol = TOL if wire == "bf16" else TOL_INT8
        np.testing.assert_allclose(mine, want, err_msg=f"{name} {wire}",
                                   **tol)
        if wire != "bf16" and (name, dispatch, "bf16") in got:
            assert _rel_rms(mine, got[(name, dispatch, "bf16")]) <= 2e-2


def _int8_experts(E, H, I, seed):
    """Stacked int8 payloads [2, E, ...] with the layer plane 1 live (the
    JAX test's layout) and their bf16 dequantization."""
    import jax.numpy as jnp
    from llm_d_tpu.ops.quant import dequantize, quantize_int8
    rng = np.random.default_rng(seed)
    quant, deq = {"layer": 1}, {}
    for name, short, shape in (("w_gate", "wg", (E, H, I)),
                               ("w_up", "wu", (E, H, I)),
                               ("w_down", "wd", (E, I, H))):
        q, s = quantize_int8(jnp.asarray(
            rng.standard_normal(shape) * 0.05, jnp.float32))
        quant[f"{name}_q"] = np.stack([np.zeros_like(q), np.asarray(q)])
        quant[f"{name}_s"] = np.stack([np.ones_like(s), np.asarray(s)])
        deq[short] = np.asarray(dequantize(q, s), np.float32)
    return quant, deq


def test_int8_experts_run_e_on_received_rows(pool, devices):
    """The wide-EP serving configuration: int8 experts, each rank's
    received rows through kernel E (its plain version here), on the bf16
    and int8 wires, against JAX's ``expert_ffn`` with the same payloads
    (which dequantizes off the TPU)."""
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(JMeshConfig(tp=WORLD), list(devices)[:WORLD])
    T, E, H, I = 32, 16, 64, 32
    quant, deq = _int8_experts(E, H, I, 3)
    case = _case(4, T, E, H=H, I=I)
    case.update(deq)
    specs = [(case, "a2a", wire, None, quant) for wire in ("bf16", "int8")]
    res = pool.run(rank_expert_ffn, specs, [])
    outs = [o for o, _ in res]
    _check_ranks_equal(outs)
    for (_, _, wire, _, _), got in zip(specs, outs[0]):
        want = _jax_ffn(case, mesh, "a2a", wire, quant=quant)
        assert _rel_rms(got, want) <= 2e-2
        np.testing.assert_allclose(got, want, **TOL_INT8)
    # Kernel E's wrapper took each rank's received rows (one region of
    # T/ep * k rows per source rank), once per call.
    k = case["idx"].shape[1]
    for _, rows in res:
        assert rows == [WORLD * (T // WORLD) * k] * len(specs)


def test_single_device_modes_raise_on_a_mesh():
    m = Mesh(MeshConfig(tp=2), 0, 2, "cpu")
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    for mode in ("dense", "ragged"):
        with pytest.raises(ValueError, match="single-device only"):
            TMoeOps.expert_ffn(x, torch.zeros(4, 2), torch.zeros(
                4, 2, dtype=torch.int32), torch.zeros(2, 8, 4),
                torch.zeros(2, 8, 4), torch.zeros(2, 4, 8), mesh=m,
                dispatch=mode)


# ---------- the accuracy harness ----------

def _traffic():
    """The JAX harness test's traffic engine (tiny-moe) and its served
    streams."""
    from llm_d_tpu.engine.engine import EngineConfig, EngineCore
    from llm_d_tpu.engine.request import Request
    from llm_d_tpu.ops.sampling import SamplingParams
    e = EngineCore(EngineConfig(
        model="tiny-moe", block_size=4, num_blocks=64, max_num_seqs=4,
        max_num_batched_tokens=64, min_token_bucket=16, min_seq_bucket=4))
    reqs = [Request(
        request_id=f"r{i}",
        prompt_token_ids=[(7 * i + 13 * j) % 500 + 1 for j in range(12)],
        sampling=SamplingParams(temperature=0.0, max_tokens=6,
                                ignore_eos=True)) for i in range(3)]
    out = e.generate(reqs)
    return e, [r.prompt_token_ids + out[r.request_id] for r in reqs]


def _assert_reports_close(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["rows"] == w["rows"]
        assert g["within_bounds"] == w["within_bounds"]
        for part in ("dispatch", "combine", "end_to_end"):
            for key in ("max_abs", "rel_rms"):
                np.testing.assert_allclose(g[part][key], w[part][key],
                                           rtol=rtol, err_msg=part + key)


def test_harness_reports_equal_jax_on_the_same_trace():
    import jax
    from llm_d_tpu.ops import collective_accuracy as jacc
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.models.convert import params_from_numpy
    from llm_d_tpu_torch.ops import collective_accuracy as tacc
    je, streams = _traffic()
    trace = jacc.harvest_routed_trace(je, streams)
    want = jacc.layer_reports(trace, je.params["moe_layers"])
    tree = jax.tree.map(np.asarray, je.params)
    tparams = params_from_numpy(tree, "cpu")
    got = tacc.layer_reports(trace, tparams["moe_layers"])
    _assert_reports_close(got, want, rtol=1e-5)
    for r in got:
        assert r["within_bounds"], r
    # The port's own harvest on the same weights and streams.
    te = EngineCore(EngineConfig(
        model="tiny-moe", block_size=4, num_blocks=64, max_num_seqs=4,
        max_num_batched_tokens=64, min_token_bucket=16, min_seq_bucket=4,
        device="cpu"), params=tparams)
    mine = tacc.harvest_routed_trace(te, streams)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in trace.items()}
    np.testing.assert_allclose(mine["x"], trace["x"], atol=2e-2, rtol=2e-2)
    differ = (mine["idx"] != trace["idx"]).any(-1)
    assert differ.mean() <= 0.05, differ.sum()
    for r in tacc.layer_reports(mine, tparams["moe_layers"]):
        assert r["within_bounds"], r
