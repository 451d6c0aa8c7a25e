"""Port parity: EPLB (``llm_d_tpu_torch.parallel.eplb``, the physical
expert dispatch and the engine's routed-id collection) against the JAX
package, on the CPU.

* The planner: ``plan_placement``, ``align_plan``, ``plan_delta`` and
  ``LoadTracker`` give the JAX package's arrays for ep in {1, 2, 4, 8},
  redundancy 0, auto and 32 and three seeded Zipf loads; the controller
  clamps alike; the divisibility and feasibility errors are raised alike.
* ``to_physical_experts`` equals the JAX op for random tables and
  phases; the expert FFN through a P = E + r physical table equals the
  logical FFN on the plain versions of kernels C, D and E, each at a T of
  its regime (``tests/test_eplb.py::test_physical_dispatch_matches_logical``).
* The controller at ep = 4 on ``tiny-mla``'s bf16 and int8 expert weights
  (two MoE layers) against the JAX controller on the 4-device CPU mesh,
  with the same skewed trace: each tick stages the same moves, the
  counters are equal, after the flip the physical weights (``_q``/``_s``
  planes included) and tables equal JAX's bit for bit, and every serving
  tensor kept its address; hysteresis and min-delta suppression as in
  ``tests/test_eplb.py``.
* The engine with EPLB on ``tiny-mla`` (int8 latent; bf16 and int8
  experts): the classic step, 4-step async blocks, the fused spec round
  and N = 4 everything-on (real verification and fixed acceptance) give
  the JAX engine's tokens (the fused paths through the existing replay
  helpers, which hand both trackers the JAX step's routed ids) and the
  port's tokens with EPLB off; the trackers' ``load`` and ``layer_load``,
  ``num_suppressed``, ``num_rebalances`` and the imbalance gauge equal
  the JAX engine's.  ``bench_eplb_skew``'s sequence (Zipf trace,
  interval 32, window 512) migrates nothing on either.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.models import moe as JMoE
from llm_d_tpu.models.config import get_config as jget_config
from llm_d_tpu.ops import moe as JMoeOps
from llm_d_tpu.ops.quant import quantize_moe_experts as jquantize
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu.parallel import eplb as J
from llm_d_tpu.parallel.mesh import MeshConfig, make_mesh
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops import moe as TMoeOps
from llm_d_tpu_torch.ops import moe_int8
from llm_d_tpu_torch.ops.quant import quantize_moe_experts
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel import eplb as T
from test_torch_everything_on import MLA_KW as EON_MLA_KW
from test_torch_everything_on import FmsReplay, greedy_req, seeded_req
from test_torch_spec import step_log

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

E64 = 64
ZIPF_SEEDS = (0, 1, 2)


def _zipf_load(seed: int, E: int = E64, s: float = 1.2) -> np.ndarray:
    rng = np.random.RandomState(seed)
    p = np.arange(1, E + 1, dtype=np.float64) ** -s
    p /= p.sum()
    return np.bincount(rng.choice(E, size=4096, p=rng.permutation(p)),
                       minlength=E).astype(np.float64)


def _plans_equal(a, b) -> None:
    assert a.num_logical == b.num_logical
    assert a.slots_per_shard == b.slots_per_shard
    for f in ("phys_to_logical", "replica_table", "num_replicas"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ep", [1, 2, 4, 8])
@pytest.mark.parametrize("redundancy", ["0", "auto", "32"])
def test_planner_and_tracker_match_jax(ep, redundancy):
    """Placement, alignment to the serving plan, the delta moves and the
    load window, array for array, on three seeded Zipf loads; the
    controller's clamped redundancy and table width."""
    # The controller's config reads 0 as auto; it clamps (at ep = 1 to 0
    # redundant slots) and keeps the divisibility constraint.
    cfg = {"num_redundant_experts": 32 if redundancy == "32" else 0}
    cj = J.EplbController(E64, ep, J.EplbConfig.from_dict(cfg))
    ct = T.EplbController(E64, ep, T.EplbConfig.from_dict(cfg))
    assert (ct.num_redundant, ct.max_r) == (cj.num_redundant, cj.max_r)
    _plans_equal(ct.plan, cj.plan)
    if ep == 1:
        assert ct.num_redundant == 0 and ct.max_r == 1
    r = 0 if redundancy == "0" else ct.num_redundant
    cur_j = J.plan_placement(np.ones(E64), r, ep)
    cur_t = T.plan_placement(np.ones(E64), r, ep)
    _plans_equal(cur_t, cur_j)
    for seed in ZIPF_SEEDS:
        load = _zipf_load(seed)
        new_j, new_t = (m.plan_placement(load, r, ep) for m in (J, T))
        _plans_equal(new_t, new_j)
        al_j, al_t = J.align_plan(new_j, cur_j), T.align_plan(new_t, cur_t)
        _plans_equal(al_t, al_j)
        assert T.plan_delta(cur_t, al_t) == J.plan_delta(cur_j, al_j)
        cur_j, cur_t = al_j, al_t
    # The window: layer-leading samples over several steps, evicted by
    # engine steps, not samples.
    tj, tt = J.LoadTracker(E64, window_size=5), T.LoadTracker(E64, 5)
    rng = np.random.RandomState(ep)
    for i in range(6):
        ids = rng.randint(0, E64, size=(3, 16 * (i + 1), 2))
        steps = 1 + i % 3
        tj.record(ids, steps=steps)
        tt.record(ids, steps=steps)
        np.testing.assert_array_equal(tt.load, tj.load)
        np.testing.assert_array_equal(tt.layer_load, tj.layer_load)
        assert tt.imbalance() == tj.imbalance()
    flat = rng.randint(0, E64, size=40)           # aggregate-only sample
    tj.record(flat)
    tt.record(flat)
    np.testing.assert_array_equal(tt.load, tj.load)
    np.testing.assert_array_equal(tt.layer_load, tj.layer_load)


def _raises(fn):
    try:
        fn()
    except Exception as e:      # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    "plan_divisibility", "plan_too_many_replicas", "controller_divisibility",
    "align_geometry"])
def test_errors_raised_alike(case):
    def run(m):
        if case == "plan_divisibility":
            return lambda: m.plan_placement([1.0] * 8, num_redundant=3, ep=4)
        if case == "plan_too_many_replicas":
            return lambda: m.plan_placement([1.0] * 4, num_redundant=9, ep=4)
        if case == "controller_divisibility":
            return lambda: m.EplbController(6, 4, m.EplbConfig.from_dict(
                {"num_redundant_experts": 1}))
        return lambda: m.align_plan(m.plan_placement([1.0] * 8, 8, 4),
                                    m.plan_placement([1.0] * 8, 0, 4))
    want = _raises(run(J))
    assert want is not None and want[0] == "ValueError"
    assert _raises(run(T)) == want


# ---------------------------------------------------------------------------
# physical dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", [0, 3, 11])
def test_to_physical_experts_matches_jax(phase):
    rng = np.random.RandomState(phase)
    plan = J.plan_placement(rng.rand(16), num_redundant=16, ep=4)
    idx = rng.randint(0, 16, size=(37, 4)).astype(np.int32)
    want = JMoeOps.to_physical_experts(
        jax.numpy.asarray(idx), jax.numpy.asarray(plan.replica_table),
        jax.numpy.asarray(plan.num_replicas), phase=phase)
    got = TMoeOps.to_physical_experts(
        torch.from_numpy(idx), torch.from_numpy(plan.replica_table),
        torch.from_numpy(plan.num_replicas), phase=phase)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _quant_stack(E, H, I, Lm, seed):
    g = torch.Generator().manual_seed(seed)
    w = {n: (torch.randn(s, generator=g) * 0.05).to(torch.bfloat16)
         for n, s in (("w_gate", (Lm, E, H, I)), ("w_up", (Lm, E, H, I)),
                      ("w_down", (Lm, E, I, H)))}
    return quantize_moe_experts({"moe_layers": w})["moe_layers"]


@pytest.mark.parametrize("path,T_", [
    ("_dense_int8_kernel_path", 16), ("_routed_int8_kernel_path", 256),
    ("_streamed_int8_kernel_path", 1024)])
def test_physical_dispatch_matches_logical(path, T_):
    """Kernels C, D and E (their plain versions on CPU tensors) through a
    P = 16 + 8 physical table (hot experts replicated, slots permuted)
    give the logical table's output: D and E bit for bit (each token's k
    rows are computed and combined alike), C within f32 summation order."""
    E, k, H, I, Lm = 16, 4, 128, 128, 2
    rng = np.random.RandomState(T_)
    q = _quant_stack(E, H, I, Lm, seed=T_)
    plan = J.plan_placement(rng.rand(E) ** 4, num_redundant=8, ep=4)
    assert plan.num_physical == 24 and plan.num_replicas.max() > 1
    phys = torch.from_numpy(plan.phys_to_logical).long()
    qp = {n: v[:, phys].contiguous() for n, v in q.items()}
    np.testing.assert_array_equal(
        qp["w_up_q"][1].numpy(),
        T.gather_physical(q["w_up_q"][1], plan).numpy())
    x = torch.from_numpy(rng.randn(T_, H).astype(np.float32)).to(
        torch.bfloat16)
    router = torch.from_numpy(rng.randn(H, E).astype(np.float32))
    c = dataclasses.replace(jget_config("tiny-mla"), num_experts=E,
                            num_experts_per_tok=k)
    weights, idx = TMoeOps.route(x.float() @ router, c)
    idx_p = TMoeOps.to_physical_experts(
        idx, torch.from_numpy(plan.replica_table),
        torch.from_numpy(plan.num_replicas), phase=1)
    glue = getattr(TMoeOps, path)
    want = glue(x, weights, idx, dict(q, layer=1)).float()
    got = glue(x, weights, idx_p, dict(qp, layer=1)).float()
    if path == "_dense_int8_kernel_path":
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-2 * scale
    else:
        assert torch.equal(got, want)


def test_dense_kernel_groups_cover_any_physical_count():
    """Kernel C's pass-2 expert groups: the old choice where it divides,
    else 16 groups of ceil(P / 16), trailing groups shorter or empty (an
    EPLB table of E + r slots)."""
    assert [moe_int8.dense_groups(E) for E in (8, 64, 68, 72, 96)] == \
        [8, 16, 4, 8, 16]
    for P in (65, 67, 130, 255):
        g = moe_int8.dense_groups(P)
        assert g == 16 and -(-P // g) <= 64 and g * -(-P // g) >= P


# ---------------------------------------------------------------------------
# the controller at ep = 4
# ---------------------------------------------------------------------------

@pytest.fixture()
def mesh4(devices):
    return make_mesh(MeshConfig(tp=4), jax.devices()[:4])


def _tiny_mla_moe(quant: str):
    """tiny-mla with three layers (two MoE layers), the JAX init: (JAX
    params, the port's copy)."""
    jc = dataclasses.replace(jget_config("tiny-mla"), num_layers=3)
    jp = JMoE.init_params(jc, jax.random.PRNGKey(0))
    if quant == "int8":
        jp = jquantize(jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


CTRL = dict(num_redundant_experts=8, window_size=100, step_interval=4,
            imbalance_threshold=1.0, move_budget=3)


def _skewed(Lm, hot, tokens=256):
    ids = np.zeros((Lm, tokens, 2), np.int64)
    for li, e in enumerate(hot):
        ids[li, :, 0] = e
        ids[li, :, 1] = (e + 1 + li) % 8
    return ids


def _ptrs(ml):
    return {k: v.data_ptr() for k, v in ml.items()}


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_controller_migration_matches_jax_at_ep4(quant, mesh4):
    jp, tp = _tiny_mla_moe(quant)
    E = 8
    cj = J.EplbController(E, 4, J.EplbConfig.from_dict(CTRL))
    ct = T.EplbController(E, 4, T.EplbConfig.from_dict(CTRL))
    logical = {k: np.asarray(v) for k, v in jp["moe_layers"].items()}
    jp = cj.install(jp, mesh4, None)
    tp_in = tp
    tp = ct.install(tp)
    assert tp is not tp_in and "replica_table" not in tp_in["moe_layers"]
    ml_t = tp["moe_layers"]
    keys = J._expert_major_keys(ml_t)
    assert set(keys) == set(J._expert_major_keys(jp["moe_layers"]))
    if quant == "int8":
        assert {"w_gate_q", "w_gate_s", "w_down_q", "w_down_s"} <= set(keys)
    for name in keys + ["replica_table", "num_replicas"]:
        np.testing.assert_array_equal(
            ml_t[name].float().numpy() if ml_t[name].is_floating_point()
            else ml_t[name].numpy(),
            np.asarray(jp["moe_layers"][name]).astype(
                np.float32 if ml_t[name].is_floating_point()
                else np.asarray(jp["moe_layers"][name]).dtype), err_msg=name)
    ptrs = _ptrs(ml_t)
    ids = _skewed(ct.n_layers, [0, 5])
    jp = cj.on_step(ids, 4, jp, mesh4)
    tp = ct.on_step(ids, 4, tp)
    ticks, flipped_at = 1, None
    assert ct.migrating and cj.migrating
    total = ct._migration.total_moves
    assert total == cj._migration.total_moves > ct.move_budget
    # The JAX flip waits for its slab's readiness, which an asynchronous
    # CPU dispatch defers by a tick or more (the loop takes no time, so
    # its slab is waited for once staged); the port's CPU copies are done
    # when queued, so it flips at the tick its last batch stages.
    while (ct.migrating or cj.migrating) and ticks < 100:
        if cj.migrating and not cj._migration.moves:
            jax.block_until_ready(list(cj._migration.staged.values()))
        if ct.migrating and cj.migrating:
            assert list(ct._migration.moves) == list(cj._migration.moves)
            assert ct._migration.staged_bytes == cj._migration.staged_bytes
            assert ct.migrated_bytes == cj.migrated_bytes == 0
            assert _ptrs(ml_t) == ptrs
        jp = cj.on_step(None, 4 + ticks, jp, mesh4)
        if ct.migrating:
            tp = ct.on_step(None, 4 + ticks, tp)
            flipped_at = None if ct.migrating else ticks
        ticks += 1
    assert not ct.migrating and not cj.migrating
    assert flipped_at == -(-total // ct.move_budget) - 1
    for a in ("num_rebalances", "num_suppressed", "migrated_bytes"):
        assert getattr(ct, a) == getattr(cj, a), a
    assert ct.num_rebalances == 1 and ct.migrated_bytes > 0
    assert ct.last_flip_stall_s < 0.25
    for li in range(ct.n_layers):
        _plans_equal(ct.plans[li], cj.plans[li])
    ml_j = jp["moe_layers"]
    for name in keys:
        got = ml_t[name]
        got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        want = np.asarray(ml_j[name])
        want = want.view(np.int16) if got.dtype == torch.int16 else want
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        for li in range(ct.n_layers):
            np.testing.assert_array_equal(
                ml_t[name][li].float().numpy(),
                logical[name][li][ct.plans[li].phys_to_logical].astype(
                    np.float32), err_msg=f"{name} layer {li}")
    for name in ("replica_table", "num_replicas"):
        np.testing.assert_array_equal(ml_t[name].numpy(),
                                      np.asarray(ml_j[name]))
    assert _ptrs(ml_t) == ptrs


@pytest.mark.parametrize("case", ["hysteresis", "min_delta"])
def test_suppression_matches_jax(case, mesh4):
    """Hysteresis (threshold 2.0, perfectly even load) and min-delta
    suppression (threshold 0.0, the uniform load the initial plan already
    serves): no migration, the serving tensors untouched, counters equal
    to the JAX controller's."""
    jp, tp = _tiny_mla_moe("int8")
    cfg = dict(CTRL, imbalance_threshold=2.0 if case == "hysteresis"
               else 0.0)
    cj = J.EplbController(8, 4, J.EplbConfig.from_dict(cfg))
    ct = T.EplbController(8, 4, T.EplbConfig.from_dict(cfg))
    jp = cj.install(jp, mesh4, None)
    tp = ct.install(tp)
    before = {k: v.clone() for k, v in tp["moe_layers"].items()}
    ptrs = _ptrs(tp["moe_layers"])
    ids = np.tile(np.arange(8), 32).reshape(ct.n_layers, -1, 1)
    ml_j = jp["moe_layers"]
    jp = cj.on_step(ids, 4, jp, mesh4)
    tp = ct.on_step(ids, 4, tp)
    assert not ct.migrating and not cj.migrating
    assert jp["moe_layers"] is ml_j
    for a in ("num_rebalances", "num_suppressed", "migrated_bytes"):
        assert getattr(ct, a) == getattr(cj, a), a
    assert ct.num_suppressed == (1 if case == "hysteresis" else 0)
    assert ct.migrated_bytes == 0
    assert _ptrs(tp["moe_layers"]) == ptrs
    assert all(torch.equal(v, before[k]) for k, v in tp["moe_layers"].items())


def test_on_step_refuses_a_device_tensor():
    """Routed ids reach ``on_step`` from the step's batched host fetch;
    reading a device tensor there would sync the host on the card."""
    ct = T.EplbController(8, 1, T.EplbConfig())

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    ids = torch.zeros((1, 4, 2), dtype=torch.int32).as_subclass(FakeCuda)
    with pytest.raises(TypeError, match="host"):
        ct.on_step(ids, 1, {})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

EPLB = dict(enable_eplb=True,
            eplb_config={"window_size": 100, "step_interval": 4})
MLA_KW = dict(model="tiny-mla", block_size=8, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, min_token_bucket=16,
              min_seq_bucket=4, kv_cache_dtype="int8",
              enable_prefix_caching=False)
PATHS = {"classic": {},
         "blocks": dict(num_scheduler_steps=4, async_scheduling=True)}


def _greedy(R, SP, tag="g"):
    """Two greedy rows whose prompts fill one 16-token step (few program
    shapes: the JAX side compiles each)."""
    rng = np.random.default_rng(0)
    return [R(f"{tag}{i}", rng.integers(1, 512, size=n).tolist(),
              SP(temperature=0.0, max_tokens=m, ignore_eos=True))
            for i, (n, m) in enumerate(((5, 9), (11, 6)))]


def _seeded(R, SP, tag="s"):
    return [R(f"{tag}0", [3, 1, 4, 1, 5, 9], SP(
        temperature=0.9, top_p=0.95, top_k=20, max_tokens=7, seed=7,
        ignore_eos=True)), R(f"{tag}1", [2, 7, 1, 8], SP(
            temperature=0.7, max_tokens=6, ignore_eos=True))]


def _gauge(engine) -> str:
    text = engine.metrics.render().decode()
    return next(ln.split()[-1] for ln in text.splitlines()
                if ln.startswith("llmd_tpu:eplb_imbalance{"))


def _trackers_equal(teng, jeng) -> None:
    t, j = teng.eplb, jeng.eplb
    assert t.tracker.load.sum() > 0
    np.testing.assert_array_equal(t.tracker.load, j.tracker.load)
    np.testing.assert_array_equal(t.tracker.layer_load, j.tracker.layer_load)
    for a in ("num_suppressed", "num_rebalances", "migrated_bytes"):
        assert getattr(t, a) == getattr(j, a), a
    assert t.num_rebalances == 0 and t.ep == j.ep == 1
    assert t.tracker.imbalance() == j.tracker.imbalance()
    assert float(_gauge(teng)) == float(_gauge(jeng))


def _port(jeng, kw):
    params = jax.tree.map(np.asarray, jeng.params)
    if jeng.eplb is not None:
        # The JAX engine installed its table: serve the logical weights
        # (the identity plan's gather is a permutation-free copy).
        p2l = jeng.eplb.plan.phys_to_logical
        assert p2l.tolist() == list(range(len(p2l)))
        params = dict(params, moe_layers={
            k: v for k, v in params["moe_layers"].items()
            if k not in ("replica_table", "num_replicas")})
    dp = jeng.draft_params
    return EngineCore(EngineConfig(device="cpu", **kw),
                      params=params_from_numpy(params, "cpu"),
                      draft_params=None if dp is None else params_from_numpy(
                          jax.tree.map(np.asarray, dp), "cpu"))


@pytest.mark.parametrize("path,quant", [("classic", "int8"),
                                        ("classic", "bf16"),
                                        ("blocks", "int8")])
def test_engine_collects_as_jax_classic_and_blocks(path, quant):
    """The classic step (int8 and bf16 experts) and 4-step async blocks:
    greedy tokens equal the JAX engine's (with EPLB) and the port's
    without EPLB, the trackers and the gauge equal the JAX engine's;
    seeded rows equal the port's without EPLB; the physical table is
    installed, the identity."""
    kw = dict(MLA_KW, quantization=None if quant == "bf16" else "int8",
              **PATHS[path])
    jeng = JEngineCore(JEngineConfig(**kw, **EPLB))
    teng = _port(jeng, dict(kw, **EPLB))
    off = _port(jeng, kw)
    ml = teng.params["moe_layers"]
    assert ml["replica_table"].shape == (1, 8, 1)
    assert ml["replica_table"].dtype == ml["num_replicas"].dtype == \
        torch.int32
    assert ml["replica_table"][0, :, 0].tolist() == list(range(8))
    want = jeng.generate(_greedy(JRequest, JSamplingParams))
    got = teng.generate(_greedy(Request, SamplingParams))
    assert got == want
    assert off.generate(_greedy(Request, SamplingParams)) == got
    _trackers_equal(teng, jeng)
    if path == "blocks":
        assert teng._dispatch_count < teng._step_count
    assert teng.generate(_seeded(Request, SamplingParams)) == \
        off.generate(_seeded(Request, SamplingParams))


def test_engine_classic_sampled_matches_jax():
    """Seeded and unseeded sampling through the classic step with EPLB:
    both engines sample the JAX forward's logits of each step (as
    ``test_sampled_tokens_identical_to_jax_engine`` compares them), so
    the tokens, and with them the routing the trackers see, are equal."""
    kw = dict(MLA_KW, quantization="int8", seed=3, **EPLB)
    jeng = JEngineCore(JEngineConfig(**kw))
    teng = _port(jeng, kw)
    jm, jc = jeng.model, jeng.model_config

    @jax.jit
    def logits_of(params, kv, batch):
        hidden = jm.forward(params, kv, batch, jc, 8, "auto")[0]
        return jm.compute_logits(params, hidden, jc)

    step_fn = jeng._build_step_fn()
    seen = []

    def recording_step(params, kv, batch, key):
        seen.append(torch.from_numpy(np.array(logits_of(params, kv, batch))))
        return step_fn(params, kv, batch, key)

    jeng._step_fn = recording_step
    want = jeng.generate(_seeded(JRequest, JSamplingParams))
    replay = iter(seen)
    real = teng.model.compute_logits
    teng.model.compute_logits = lambda *a: next(replay)
    try:
        got = teng.generate(_seeded(Request, SamplingParams))
    finally:
        teng.model.compute_logits = real
    assert got == want
    assert next(replay, None) is None
    _trackers_equal(teng, jeng)


SPEC = {"spec_round": dict(spec_k=4),
        "everything_on": dict(spec_k=4, num_scheduler_steps=4,
                              async_scheduling=True),
        "everything_on_fixed": dict(spec_k=4, num_scheduler_steps=4,
                                    async_scheduling=True,
                                    spec_fixed_accept=0.8)}


@pytest.mark.parametrize("name", sorted(SPEC))
def test_engine_collects_as_jax_spec_paths(name, monkeypatch):
    """The fused spec round and N = 4 everything-on (real verification
    and fixed acceptance 0.8), int8 experts: on the JAX rounds' hidden
    states and expert choice (the replay helpers), the tokens each request
    gets each step and its drafted / accepted counts equal the JAX
    engine's, and the trackers, fed the JAX rounds' routed ids under the
    accepted-aware masks, equal too; without the replay the port's tokens
    equal its own with EPLB off.  The engines and requests are
    ``test_n_round_body_matches_jax_fms_fn_round_by_round``'s (block size
    4, a greedy and a seeded request of its set), on which the replay's
    forward check holds."""
    kw = dict(EON_MLA_KW, **SPEC[name])
    jeng = JEngineCore(JEngineConfig(**kw, **EPLB))
    replay = FmsReplay(jeng)
    teng = _port(jeng, dict(kw, **EPLB))

    def spec_reqs(R, SP, tag=""):
        return [greedy_req(tag + "a", [1, 5, 9, 200, 3, 17, 42], 10, R=R,
                           SP=SP),
                seeded_req(tag + "s", [3, 1, 4, 1, 5], 8, R=R, SP=SP)]

    reqs = spec_reqs(JRequest, JSamplingParams)
    jlog = step_log(jeng, reqs)
    replay.serve(teng, monkeypatch)
    treqs = spec_reqs(Request, SamplingParams)
    tlog = step_log(teng, treqs)
    assert next(replay.left, None) is None
    assert tlog == jlog
    assert [(r.spec_drafted, r.spec_accepted, list(r.output_token_ids))
            for r in treqs] == [(r.spec_drafted, r.spec_accepted,
                                 list(r.output_token_ids)) for r in reqs]
    assert sum(r.spec_drafted for r in treqs) > 0
    _trackers_equal(teng, jeng)
    monkeypatch.undo()
    on, off = _port(jeng, dict(kw, **EPLB)), _port(jeng, kw)
    assert on.generate(spec_reqs(Request, SamplingParams, "h")) == \
        off.generate(spec_reqs(Request, SamplingParams, "h"))
    assert on.eplb.tracker.load.sum() > 0


def test_bench_eplb_skew_sequence_migrates_nothing():
    """bench_eplb_skew's sequence on one device (spec K = 4 at fixed
    acceptance 0.7, window 512, interval 32): a Zipf(1.2) trace recorded
    before the run dominates the window, and the interval is crossed, yet
    every plan aligns to the identity at ep = 1, so neither engine
    migrates or moves a byte."""
    eplb = dict(enable_eplb=True,
                eplb_config={"window_size": 512, "step_interval": 32})
    kw = dict(MLA_KW, quantization="int8", spec_k=4, spec_fixed_accept=0.7,
              num_blocks=128)
    jeng = JEngineCore(JEngineConfig(**kw, **eplb))
    teng = _port(jeng, dict(kw, **eplb))
    p = np.arange(1, 9, dtype=np.float64) ** -1.2
    p /= p.sum()
    for eng, R, SP in ((jeng, JRequest, JSamplingParams),
                       (teng, Request, SamplingParams)):
        rng = np.random.RandomState(1234)
        ids = rng.choice(eng.eplb.E, size=(eng.eplb.n_layers, 4096, 2), p=p)
        eng.eplb.tracker.record(ids)
        # One row: few program shapes, and more than 32 engine steps.
        eng.generate([R("z", [7, 3, 9, 1] * 4, SP(
            temperature=0.0, max_tokens=100, ignore_eos=True))])
        assert eng._step_count > 32
        assert eng.eplb.tracker.imbalance() > 1.5
        assert eng.eplb.num_rebalances == 0
        assert eng.eplb.migrated_bytes == 0
        assert not eng.eplb.migrating
