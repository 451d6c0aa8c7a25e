"""Port parity: the wide-EP recipe's MoE features on a ``MeshConfig(dp=2,
tp=2)`` mesh (ep = 4) against the JAX package's stacked engine on its
4-device mesh; the port's ranks are 4 gloo processes spawned once for the
file, each call with a deadline.

* DBO (``tests/test_dbo.py``): the EP exchange's chunk count equals the
  JAX op's above and below the threshold, from the env fallback and with
  it defeated (a chunk is one dispatch and one combine exchange); the
  output equals JAX's; greedy tokens of a DBO engine equal the JAX DBO
  engine's on ``tiny-moe`` and ``tiny-mla`` (int8 experts and latent);
  the engine picks the decode / prefill threshold by phase, DBO off
  ignores the env, a dense model is refused.
* EPLB at ep = 4 (``tests/test_eplb_integration.py``): each rank's
  installed slots are JAX's physical table's, bit for bit, and the
  replica tables JAX's; through a live migration forced by a skewed load
  window the tables after every flip equal JAX's on every rank, each
  moved slot holds its source slot's bytes, bytes cross ranks, and the
  greedy tokens equal JAX's EPLB engine's and the port's EPLB-off mesh's.
"""

import numpy as np
import pytest
import torch

from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import params_from_numpy
from llm_d_tpu_torch.ops import moe as TMoeOps
from llm_d_tpu_torch.ops.sampling import SamplingParams
from llm_d_tpu_torch.parallel.launch import RankPool
from llm_d_tpu_torch.parallel.mesh import AXIS_EP, Mesh, MeshConfig

from test_torch_spmd_dp import DP, TP, WORLD
from test_torch_spmd_dp import PROMPTS as SPMD_PROMPTS
from test_torch_tp import ENGINE

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

TOL = dict(atol=3e-2, rtol=3e-2)
# Steps run 32 rows over the mesh (16-row shards): the prefill splits,
# the decode does not.
DBO = dict(enable_dbo=True, dbo_decode_token_threshold=64,
           dbo_prefill_token_threshold=16)
EPLB = dict(enable_eplb=True,
            eplb_config={"num_redundant_experts": 4, "window_size": 100,
                         "step_interval": 4})
PROMPTS = {"e1": [3, 1, 4, 1, 5, 9], "e2": [2, 7, 1, 8],
           "e3": [100, 200, 300, 400, 500], "e4": [9, 8, 7, 6, 5, 4, 3]}
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def pool():
    with RankPool(WORLD, timeout_s=120) as p:
        yield p


def _jmesh(devices):
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from llm_d_tpu.parallel.mesh import make_mesh
    return make_mesh(JMeshConfig(dp=DP, tp=TP), list(devices)[:WORLD])


# ---------- DBO: the op ----------

# (global tokens, dbo_min_tokens, LLMD_MOE_DBO / LLMD_DBO_TOKEN_THRESHOLD)
DBO_CASES = {
    "above the threshold": (64, 4, None),
    "below the threshold": (64, 128, None),
    "at 2 * ep": (8, 1, None),
    "one row a rank": (4, 1, None),
    "env fallback": (64, None, ("1", "4")),
    "env defeated": (64, -1, ("1", "4")),
    "no env": (64, None, None),
}


def _op_case(T, E=16, H=32, I=16):
    import jax.numpy as jnp
    from llm_d_tpu.models.config import ModelConfig
    from llm_d_tpu.ops import moe as JMoeOps
    rng = np.random.default_rng(T)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    x = bf(rng.standard_normal((T, H)))
    router = rng.standard_normal((H, E)).astype(np.float32)
    ws = [bf(rng.standard_normal(s) * 0.2)
          for s in ((E, H, I), (E, H, I), (E, I, H))]
    cfg = ModelConfig(name="dbo-test", num_experts=E, num_experts_per_tok=2,
                      moe_renormalize=True)
    w, idx = JMoeOps.route(jnp.dot(jnp.asarray(x), jnp.asarray(router)), cfg)
    return x, np.asarray(w), np.asarray(idx), ws


def _set_env(env):
    import os
    for k in ("LLMD_MOE_DBO", "LLMD_DBO_TOKEN_THRESHOLD"):
        os.environ.pop(k, None)
    if env is not None:
        os.environ["LLMD_MOE_DBO"], os.environ["LLMD_DBO_TOKEN_THRESHOLD"] = env


def rank_dbo_op(cases):
    """Rank side: each case through ``expert_ffn_a2a`` on the dp x tp mesh
    (this rank's dp shard of the rows, its quarter of the experts):
    (chunks = all_to_all calls / 2, the shard's output)."""
    m = Mesh.from_process_group(MeshConfig(dp=DP, tp=TP),
                                torch.device("cpu"))
    out = []
    for x, w, idx, ws, thr, env in cases:
        _set_env(env)
        T_l = x.shape[0] // DP
        rows = slice(m.coord["dp"] * T_l, (m.coord["dp"] + 1) * T_l)
        E = ws[0].shape[0]
        sl = slice(m.rank * E // WORLD, (m.rank + 1) * E // WORLD)
        before = m.calls.get("all_to_all", 0)
        y = TMoeOps.expert_ffn_a2a(
            torch.from_numpy(x[rows]).to(torch.bfloat16),
            torch.from_numpy(w[rows]), torch.from_numpy(idx[rows]),
            *[torch.from_numpy(a[sl]).to(torch.bfloat16) for a in ws], m,
            dbo_min_tokens=thr)
        _set_env(None)
        out.append(((m.calls["all_to_all"] - before) // 2,
                    y.float().numpy()))
    return out


def _jax_dbo(devices, x, w, idx, ws, thr, env, monkeypatch):
    """JAX's op on its 4-device dp x tp mesh: (chunks traced, output)."""
    import jax
    import jax.numpy as jnp
    from llm_d_tpu.ops import moe as JMoeOps
    for k in ("LLMD_MOE_DBO", "LLMD_DBO_TOKEN_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    if env is not None:
        monkeypatch.setenv("LLMD_MOE_DBO", env[0])
        monkeypatch.setenv("LLMD_DBO_TOKEN_THRESHOLD", env[1])
    calls = []
    real = JMoeOps._a2a_moe_chunk
    monkeypatch.setattr(JMoeOps, "_a2a_moe_chunk",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fn = jax.jit(lambda x, w, i, *ws: JMoeOps.expert_ffn_a2a(
        x, w, i, *ws, _jmesh(devices), dbo_min_tokens=thr))
    y = fn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(idx),
           *[jnp.asarray(a, jnp.bfloat16) for a in ws])
    monkeypatch.setattr(JMoeOps, "_a2a_moe_chunk", real)
    return len(calls), np.asarray(y, np.float32)


@pytest.fixture(scope="module")
def dbo_op(pool):
    cases = {name: _op_case(T) + (thr, env)
             for name, (T, thr, env) in DBO_CASES.items()}
    got = pool.run(rank_dbo_op, list(cases.values()))
    return cases, {name: [g[i] for g in got]
                   for i, name in enumerate(cases)}


@pytest.mark.parametrize("name", sorted(DBO_CASES))
def test_dbo_chunk_counts_and_output_equal_jax(dbo_op, devices, name,
                                               monkeypatch):
    cases, got = dbo_op
    x, w, idx, ws, thr, env = cases[name]
    chunks, want = _jax_dbo(devices, x, w, idx, ws, thr, env, monkeypatch)
    assert [g[0] for g in got[name]] == [chunks] * WORLD
    if name in ("above the threshold", "env fallback"):
        assert chunks >= 2
    if name in ("below the threshold", "env defeated", "no env",
                "one row a rank"):
        assert chunks == 1
    T_l = x.shape[0] // DP
    for r, (_, y) in enumerate(got[name]):
        d = r // TP
        np.testing.assert_allclose(y, want[d * T_l:(d + 1) * T_l], **TOL)


# ---------- DBO: the engine ----------

def _requests(cls_req, cls_sp, n=5, prompts=PROMPTS):
    return [cls_req(request_id=r, prompt_token_ids=list(p),
                    sampling=cls_sp(temperature=0.0, max_tokens=n,
                                    ignore_eos=True))
            for r, p in prompts.items()]


def jax_engine(devices, model, kw, params=None):
    from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
    from llm_d_tpu.engine.engine import EngineCore as JEngineCore
    from llm_d_tpu.parallel.mesh import MeshConfig as JMeshConfig
    return JEngineCore(JEngineConfig(
        model=model, mesh=JMeshConfig(dp=DP, tp=TP),
        allow_device_subset=True, **ENGINE, **kw),
        params=params, devices=list(devices)[:WORLD])


def jax_tokens(eng, n=5, prompts=PROMPTS):
    from llm_d_tpu.engine.request import Request as JRequest
    from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
    return eng.generate(_requests(JRequest, JSamplingParams, n, prompts))


def rank_engine_tokens(model, tree, kw, prompts):
    """Rank side: the dp x tp engine on the JAX tree: (tokens, the chunk
    counts its exchanges ran, its all_to_all calls)."""
    chunks = []
    real = TMoeOps.dbo_chunk_tokens

    def counted(T, ep, chunk, thr):
        c = real(T, ep, chunk, thr)
        chunks.append(T // ep // c)
        return c
    TMoeOps.dbo_chunk_tokens = counted
    try:
        eng = EngineCore(EngineConfig(model=model, device="cpu",
                                      mesh=MeshConfig(dp=DP, tp=TP),
                                      **ENGINE, **kw),
                         params=params_from_numpy(tree, "cpu"))
        if eng.mesh.rank != 0:
            out = eng.follow()
        else:
            out = eng.generate(_requests(Request, SamplingParams,
                                         prompts=prompts))
            eng.stop_mesh()
    finally:
        TMoeOps.dbo_chunk_tokens = real
    return out, sorted(set(chunks)), eng.mesh.calls.get("all_to_all", 0)


@pytest.mark.parametrize("model,kw", [
    ("tiny-moe", {}),
    ("tiny-mla", dict(quantization="int8", kv_cache_dtype="int8"))])
def test_dbo_engine_tokens_equal_the_jax_dbo_engine(pool, devices, model,
                                                    kw):
    """On the dp mesh's parity prompts (``test_torch_spmd_dp``); on this
    file's prompts DBO on and off give the same tokens (at ``tiny-mla``'s
    int8 near tie of ``e3``'s fifth token, both the mesh's)."""
    import jax
    jeng = jax_engine(devices, model, dict(kw, **DBO))
    want = jax_tokens(jeng, prompts=SPMD_PROMPTS)
    tree = jax.tree.map(np.asarray, jeng.params)
    out = pool.run(rank_engine_tokens, model, tree, dict(kw, **DBO),
                   SPMD_PROMPTS)
    assert [o[0] for o in out] == [want] * WORLD
    # The prefill step splits (>= 2 chunks), the decode steps do not.
    assert all(o[1] == [1, 2] for o in out)
    on = pool.run(rank_engine_tokens, model, tree, dict(kw, **DBO), PROMPTS)
    off = pool.run(rank_engine_tokens, model, tree, kw, PROMPTS)
    assert [o[0] for o in on] == [off[0][0]] * WORLD
    assert all(o[1] == [1] for o in off)
    # Twice the exchanges where the prefill runs two chunks a layer.
    assert on[0][2] > off[0][2]


def _phase_engine(monkeypatch, **kw):
    seen = []
    real = TMoeOps.expert_ffn
    monkeypatch.setattr(
        TMoeOps, "expert_ffn",
        lambda *a, **k: seen.append(k.get("dbo_min_tokens")) or real(*a, **k))
    eng = EngineCore(EngineConfig(
        model="tiny-moe", device="cpu", block_size=4, num_blocks=32,
        max_num_seqs=2, max_num_batched_tokens=32, min_token_bucket=8,
        min_seq_bucket=2, **kw))
    eng.generate([Request("p", [1, 2, 3, 4, 5], SamplingParams(
        temperature=0.0, max_tokens=3, ignore_eos=True))])
    return seen


def test_the_engine_picks_the_dbo_threshold_by_phase(monkeypatch):
    """A prefill batch (Q > 1) gets the prefill threshold, a pure-decode
    batch the decode one; one device accepts DBO (nothing to overlap)."""
    seen = _phase_engine(monkeypatch, enable_dbo=True,
                         dbo_decode_token_threshold=7,
                         dbo_prefill_token_threshold=99)
    assert 99 in seen and 7 in seen and set(seen) == {7, 99}


def test_dbo_off_passes_minus_one_past_the_env(monkeypatch):
    monkeypatch.setenv("LLMD_MOE_DBO", "1")
    seen = _phase_engine(monkeypatch, enable_dbo=False)
    assert seen and all(v == -1 for v in seen)


def test_dbo_on_a_dense_model_is_refused():
    with pytest.raises(ValueError, match="dense"):
        EngineCore(EngineConfig(model="tiny", enable_dbo=True, device="cpu",
                                block_size=4, num_blocks=16))


# ---------- EPLB at ep = 4 ----------

def _full_slots(eng, ml):
    """Every rank's slots of each expert key, gathered: [Lm, P, ...]."""
    return {k: eng.mesh.all_gather(ml[k], AXIS_EP, dim=1).clone()
            for k in ml if k.startswith(EXPERT_KEYS)}


def rank_eplb(tree, kw, skew):
    """Rank side: the EPLB engine at ep = 4 on the JAX tree.  Returns
    (tokens, this rank's installed slots and tables, per flip: (tables,
    whether every moved slot holds its source's bytes, this rank's slots),
    bytes sent / received across ranks, flips)."""
    from llm_d_tpu_torch.parallel.eplb import plan_delta
    eng = EngineCore(EngineConfig(model="tiny-moe", device="cpu",
                                  mesh=MeshConfig(dp=DP, tp=TP), **ENGINE,
                                  **kw),
                     params=params_from_numpy(tree, "cpu"))
    ml = eng.params["moe_layers"]
    installed = {k: v.clone().numpy() if v.dtype != torch.bfloat16
                 else v.view(torch.uint16).clone().numpy()
                 for k, v in ml.items()
                 if k.startswith(EXPERT_KEYS)
                 or k in ("replica_table", "num_replicas")}
    flips = []
    ctl = eng.eplb
    if ctl is not None:
        ctl.tracker.record(np.full((ctl.n_layers, 4096, 2), skew, np.int64))
        real_flip = ctl._flip

        def flip(params):
            m = ctl._migration
            moves = [(li, dst, src) for li, t in enumerate(m.plans)
                     for dst, src in plan_delta(ctl.plans[li], t)]
            before = _full_slots(eng, params["moe_layers"])
            out = real_flip(params)
            after = _full_slots(eng, out["moe_layers"])
            same = all(torch.equal(after[k][li, dst], before[k][li, src])
                       for k in after for li, dst, src in moves)
            ml_ = out["moe_layers"]
            flips.append((ml_["replica_table"].numpy().copy(),
                          ml_["num_replicas"].numpy().copy(), same,
                          len(moves),
                          {k: (v.view(torch.uint16) if v.dtype ==
                               torch.bfloat16 else v).numpy().copy()
                           for k, v in ml_.items()
                           if k.startswith(EXPERT_KEYS)}))
            return out
        ctl._flip = flip
    if eng.mesh.rank != 0:
        out = eng.follow()
    else:
        out = eng.generate(_requests(Request, SamplingParams, 8))
        eng.stop_mesh()
    moved = (ctl.sent_bytes, ctl.received_bytes) if ctl else None
    return out, installed, flips, moved


@pytest.fixture(scope="module")
def eplb_runs(pool, devices):
    """The JAX EPLB engine through a forced migration (its installed
    table, its tables after each flip, its tokens), and the port's EPLB
    and EPLB-off meshes on its weights."""
    import jax
    base = jax_engine(devices, "tiny-moe", {})
    tree = jax.tree.map(np.asarray, base.params)
    jeng = jax_engine(devices, "tiny-moe", EPLB, params=base.params)
    ml = jeng.params["moe_layers"]
    jinstalled = {k: np.asarray(v) for k, v in ml.items()
                  if k.startswith(EXPERT_KEYS)
                  or k in ("replica_table", "num_replicas")}
    jflips = []
    real_flip = jeng.eplb._flip

    def flip(params, mesh):
        out = real_flip(params, mesh)
        jml = out["moe_layers"]
        jflips.append((np.asarray(jml["replica_table"]),
                       np.asarray(jml["num_replicas"]),
                       {k: np.asarray(v) for k, v in jml.items()
                        if k.startswith(EXPERT_KEYS)}))
        return out
    jeng.eplb._flip = flip
    jeng.eplb.tracker.record(np.full((jeng.eplb.n_layers, 4096, 2), 0,
                                     np.int64))
    want = jax_tokens(jeng, 8)
    port = pool.run(rank_eplb, tree, EPLB, 0)
    off = pool.run(rank_eplb, tree, {}, 0)
    return dict(jinstalled=jinstalled, jflips=jflips, want=want, port=port,
                off=off)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_eplb_installs_each_ranks_slots_of_the_jax_physical_table(
        eplb_runs):
    j = eplb_runs["jinstalled"]
    P = j["w_gate"].shape[1]
    spp = P // WORLD
    assert P == 8 + 4
    for r, (_, installed, _, _) in enumerate(eplb_runs["port"]):
        for k in ("replica_table", "num_replicas"):
            np.testing.assert_array_equal(installed[k], j[k])
        for k, v in installed.items():
            if k.startswith(EXPERT_KEYS):
                np.testing.assert_array_equal(
                    v, _bits(j[k])[:, r * spp:(r + 1) * spp], err_msg=k)


def test_eplb_tables_after_every_flip_equal_jax_on_every_rank(eplb_runs):
    jflips = eplb_runs["jflips"]
    port = eplb_runs["port"]
    n = len(port[0][2])
    assert n >= 1 and all(len(p[2]) == n for p in port)
    # Rank 0 carries out its last decision at the top of the next step:
    # a flip JAX makes at the run's final retire has no step after it.
    assert len(jflips) - 1 <= n <= len(jflips)
    spp = jflips[0][2]["w_gate"].shape[1] // WORLD
    for i in range(n):
        rt, nr, jw = jflips[i]
        for r, p in enumerate(port):
            prt, pnr, same, nmoves, slots = p[2][i]
            np.testing.assert_array_equal(prt, rt)
            np.testing.assert_array_equal(pnr, nr)
            assert same and nmoves > 0
            for k, v in slots.items():
                np.testing.assert_array_equal(
                    v, _bits(jw[k])[:, r * spp:(r + 1) * spp], err_msg=k)


def test_eplb_tokens_through_a_live_migration_equal_jax_and_eplb_off(
        eplb_runs):
    want = eplb_runs["want"]
    assert all(p[0] == want for p in eplb_runs["port"])
    assert all(o[0] == want for o in eplb_runs["off"])
    assert all(o[2] == [] for o in eplb_runs["off"])


def test_eplb_migrations_move_bytes_between_ranks(eplb_runs):
    moved = [p[3] for p in eplb_runs["port"]]
    assert sum(s for s, _ in moved) == sum(g for _, g in moved) > 0
