"""Port parity: the fused multistep pipeline ("everything-on": spec decode
composed with multistep and async scheduling) in the port's EngineCore
against the JAX engine, on the CPU (the single-device cases of
``tests/test_everything_on.py``).

On CPU tensors an N-round dispatch runs its body (``_fms_body``)
eagerly; on the card it is one CUDA graph replay
(``tests/test_torch_gpu.py``).

* The parity matrix on ``tiny`` (spec only, multistep only, async only,
  spec + multistep, everything-on at N = 2 and N = 4): greedy and seeded
  tokens equal to the JAX engine's in the same composition and to the
  all-off engine's, exactly; every block back in the pool.
* Staggered prefill joins ride the N-round dispatches (chunk rounds and
  decode rounds in one program) with the all-off tokens; a logprobs row
  drafts and gets one logprob (atol 1e-2 against all-off, the JAX
  suite's bar) and one top-N dict per token; steps per dispatch exceed
  1.5 at N = 2 and the step/dispatch counters and their metrics equal
  the JAX engine's.
* On ``tiny-mla`` (int8 experts and latent) the two forwards differ by
  one bf16 ulp and flip near ties (ROADMAP §3), so the N-round body is
  held to the JAX ``fms_fn`` round by round (``FmsReplay``: the JAX
  program split at the forward, one round at a time): each round's
  forward batch equals the JAX round's at every query token (pad and
  dead tokens write block-0 trash in both), the port's forward, on the
  JAX round's cache and expert choice, is held to the JAX hidden states
  at atol = rtol = 2e-2, and the port continues on the JAX hidden
  states: its tokens per step then equal the JAX engine's exactly.
* Each dispatch's N round keys are ``jax.random.split(step_key, N)`` of
  the JAX engine's dispatch key, and its N fixed-acceptance coins are
  ``jax.random.uniform`` at each round's engine step, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_d_tpu.engine.engine import EngineConfig as JEngineConfig
from llm_d_tpu.engine.engine import EngineCore as JEngineCore
from llm_d_tpu.engine.request import Request as JRequest
from llm_d_tpu.ops import sampling as JSampling
from llm_d_tpu.ops.sampling import SamplingParams as JSamplingParams
from llm_d_tpu_torch.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request
from llm_d_tpu_torch.models.convert import (
    params_from_numpy, tensor_from_numpy)
from llm_d_tpu_torch.ops import moe as TMoeOps
from llm_d_tpu_torch.ops.sampling import SamplingParams
from test_torch_spec import HiddenReplay, step_log

# One intra-op thread: these tests' tensors are tiny, and the suite's
# parallel workers, each with a thread pool as wide as the machine, would
# oversubscribe its cores (the pools' waiting threads spin).
torch.set_num_threads(1)

K = 4
ENGINE_KW = dict(model="tiny", block_size=4, num_blocks=64, max_num_seqs=8,
                 max_num_batched_tokens=64, min_token_bucket=16,
                 min_seq_bucket=4)
EVERYTHING = dict(spec_k=K, num_scheduler_steps=2, async_scheduling=True)
COMPOSITIONS = {
    "spec_only": dict(spec_k=K),
    "multistep_only": dict(num_scheduler_steps=2),
    "async_only": dict(num_scheduler_steps=2, async_scheduling=True),
    "spec_multistep": dict(spec_k=K, num_scheduler_steps=2),
    "everything_on": EVERYTHING,
    "everything_on_n4": dict(spec_k=K, num_scheduler_steps=4,
                             async_scheduling=True),
}
MLA_KW = dict(ENGINE_KW, model="tiny-mla", quantization="int8",
              kv_cache_dtype="int8")


def greedy_req(rid, prompt, n=12, R=Request, SP=SamplingParams, **kw):
    return R(request_id=rid, prompt_token_ids=list(prompt),
             sampling=SP(temperature=0.0, max_tokens=n, ignore_eos=True,
                         **kw))


def seeded_req(rid, prompt, n=12, seed=7, R=Request, SP=SamplingParams):
    return R(request_id=rid, prompt_token_ids=list(prompt),
             sampling=SP(temperature=0.9, top_p=0.95, top_k=20,
                         max_tokens=n, seed=seed, ignore_eos=True))


def workload(R=Request, SP=SamplingParams):
    """Greedy and seeded rows, mixed prompt lengths (the JAX suite's)."""
    return [greedy_req("g0", [1, 5, 9, 200, 3, 17, 42], R=R, SP=SP),
            greedy_req("g1", [4, 4, 4, 8], R=R, SP=SP),
            greedy_req("g2", list(range(40, 55)), n=8, R=R, SP=SP),
            seeded_req("s0", [7, 7, 2, 300], seed=123, R=R, SP=SP),
            seeded_req("s1", [9, 1, 9, 1, 9], seed=31337, n=10, R=R,
                       SP=SP)]


def _tree(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def port_of(jeng, kw, **over):
    """The port's engine on ``jeng``'s weights and drafter."""
    return EngineCore(EngineConfig(device="cpu", **kw, **over),
                      params=_tree(jeng.params),
                      draft_params=(_tree(jeng.draft_params)
                                    if jeng.draft_params is not None
                                    else None))


def _free(engine):
    return engine.kv_manager.num_free_blocks


@pytest.fixture(scope="module")
def base():
    """The JAX spec engine (its weights and drafter serve every port
    engine below), and the all-off tokens of the workload."""
    jspec = JEngineCore(JEngineConfig(spec_k=K, **ENGINE_KW))
    want = JEngineCore(JEngineConfig(**ENGINE_KW)).generate(
        workload(JRequest, JSamplingParams))
    assert port_of(jspec, ENGINE_KW).generate(workload()) == want
    return jspec, want


# ---------------------------------------------------------------------------
# the parity matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_parity_matrix_byte_identical(name, base):
    """Each composition, the ones the port used to refuse included,
    emits the all-off engine's greedy and seeded tokens and the JAX
    engine's in the same composition; the pool ends whole."""
    jspec, want = base
    cfg = COMPOSITIONS[name]
    jeng = JEngineCore(JEngineConfig(**cfg, **ENGINE_KW))
    eng = port_of(jspec, ENGINE_KW, **cfg)
    assert eng.spec_k == jeng.spec_k == cfg.get("spec_k", 0)
    free0 = _free(eng)
    got = eng.generate(workload())
    assert got == jeng.generate(workload(JRequest, JSamplingParams))
    assert got == want
    assert _free(eng) == free0 and not eng.has_work()
    if cfg.get("spec_k") and cfg.get("num_scheduler_steps", 1) > 1:
        assert eng._step_count > eng._dispatch_count


def test_everything_on_leaves_pool_leak_free(base):
    """After the workload every block is back (the N-round program's
    implicit rollback and the one trim a row at retire settle all the
    speculative over-allocation), and no reference counts linger."""
    eng = port_of(base[0], ENGINE_KW, **EVERYTHING)
    before = _free(eng)
    eng.generate(workload())
    assert _free(eng) == before
    assert eng.scheduler.num_running == 0 and not eng.has_work()
    assert all(r == 0 for r in eng.kv_manager._ref.values())


# ---------------------------------------------------------------------------
# mixed rounds, logprobs rows, counters
# ---------------------------------------------------------------------------

def _staggered(engine, R=Request, SP=SamplingParams):
    """A resident decode, then three greedy joiners and a seeded one
    added one per step: the tokens per request, and whether a pass
    scheduled prefill chunks beside draft-verify rows."""
    first = greedy_req("first", [1, 5, 9, 200, 3], n=14, R=R, SP=SP)
    rest = [greedy_req(f"j{i}", list(range(10 + i, 26 + i)), n=6, R=R,
                       SP=SP) for i in range(3)]
    rest.append(seeded_req("js", [3, 1, 4, 1, 5, 9, 2, 6], seed=99, n=8,
                           R=R, SP=SP))
    outs, mixed = [], False
    engine.add_request(first)
    for _ in range(4):
        outs.extend(engine.step())
    while engine.has_work() or rest:
        if rest:
            engine.add_request(rest.pop(0))
        outs.extend(engine.step())
        s = engine.scheduler.last_schedule_stats
        mixed |= (s.get("prefill_tokens", 0) > 0
                  and s.get("spec_tokens", 0) > 0)
    tokens = {}
    for o in outs:
        tokens.setdefault(o.request_id, []).extend(o.new_token_ids)
    return tokens, mixed, first


def test_staggered_prefill_joins_byte_identical(base):
    """Joiners' prefill chunks ride the same N-round dispatches as the
    resident decode, which keeps drafting; the tokens equal the all-off
    engine's and the JAX everything-on engine's."""
    want, _, _ = _staggered(port_of(base[0], ENGINE_KW))
    jwant, _, _ = _staggered(JEngineCore(JEngineConfig(**EVERYTHING,
                                                       **ENGINE_KW)),
                             JRequest, JSamplingParams)
    eng = port_of(base[0], ENGINE_KW, **EVERYTHING)
    free0 = _free(eng)
    got, mixed, first = _staggered(eng)
    assert mixed, "no pass scheduled prefill chunks beside spec decodes"
    assert first.spec_drafted > 0, "the resident decode stopped drafting"
    assert got == want == jwant
    assert _free(eng) == free0


def test_logprobs_rows_on_spec_path_everything_on(base):
    """A logprobs request under the full composition drafts, emits the
    all-off tokens with one logprob per token (within 1e-2 of all-off's
    and of the JAX everything-on engine's) and one top-5 dict holding
    the token."""
    def run(engine, R=Request, SP=SamplingParams):
        req = R(request_id="lp", prompt_token_ids=[5, 6, 7],
                sampling=SP(temperature=0.0, max_tokens=6, ignore_eos=True,
                            logprobs=5))
        engine.add_request(req)
        outs = []
        while engine.has_work():
            outs.extend(engine.step())
        return (req, [t for o in outs for t in o.new_token_ids],
                [v for o in outs for v in (o.logprobs or [])],
                [t for o in outs for t in (o.top_logprobs or [])])

    _, want_t, want_lp, _ = run(port_of(base[0], ENGINE_KW))
    _, j_t, j_lp, _ = run(JEngineCore(JEngineConfig(**EVERYTHING,
                                                    **ENGINE_KW)),
                          JRequest, JSamplingParams)
    req, got_t, got_lp, got_top = run(port_of(base[0], ENGINE_KW,
                                              **EVERYTHING))
    assert req.spec_drafted > 0, "the logprobs row left the spec path"
    assert got_t == want_t == j_t
    assert len(got_lp) == len(got_top) == 6
    np.testing.assert_allclose(got_lp, want_lp, atol=1e-2)
    np.testing.assert_allclose(got_lp, j_lp, atol=1e-2)
    for tok, top in zip(got_t, got_top):
        assert tok in top and len(top) == 5


def _metric(text, name):
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_dispatch_amortization_counters(base):
    """N = 2 rounds per dispatch: engine steps exceed 1.5 x dispatches,
    equal the JAX engine's counts on the same requests, and are what
    ``llmd_tpu:engine_steps_total`` / ``engine_dispatch_total`` export;
    the classic engine stays 1:1."""
    def reqs(R=Request, SP=SamplingParams):
        return [greedy_req(f"d{i}", [1 + i, 2, 3], n=16, R=R, SP=SP)
                for i in range(3)]

    eng = port_of(base[0], ENGINE_KW, **EVERYTHING)
    eng.generate(reqs())
    jeng = JEngineCore(JEngineConfig(**EVERYTHING, **ENGINE_KW))
    jeng.generate(reqs(JRequest, JSamplingParams))
    steps, dispatches = eng._step_count, eng._dispatch_count
    assert dispatches > 0 and steps > 1.5 * dispatches, (steps, dispatches)
    assert (steps, dispatches) == (jeng._step_count, jeng._dispatch_count)
    text = eng.metrics.render().decode()
    assert _metric(text, "llmd_tpu:engine_steps_total") == steps
    assert _metric(text, "llmd_tpu:engine_dispatch_total") == dispatches
    classic = port_of(base[0], ENGINE_KW)
    classic.generate(reqs())
    assert classic._step_count == classic._dispatch_count


# ---------------------------------------------------------------------------
# tiny-mla: the N-round body against the JAX fms_fn, round by round
# ---------------------------------------------------------------------------

class FmsReplay(HiddenReplay):
    """``HiddenReplay`` for the fused multistep pipeline: the JAX
    engine's N-round program (its body as
    ``EngineCore._build_fused_multistep_fn`` writes it, one device) runs
    round by round, split at the model forward, and each round's batch,
    cache and hidden states are recorded; single fused rounds (a plan
    that falls back) are split as ``HiddenReplay`` splits them.  ``serve``
    feeds the recorded rounds to the port's forward in order."""

    def __init__(self, jeng) -> None:
        super().__init__(jeng)
        fns = {}
        replay = self

        class Fns(dict):
            def get(self, key, default=None):
                if key not in fns:
                    fns[key] = replay._split_fms(*key)
                return fns[key]

        jeng._fms_fns = Fns()
        self.keys, self.coins = [], []

    def _split_fms(self, want_lp, want_top):
        e = self.jeng
        jm, jc, bs = e.model, e.model_config, e.config.block_size
        fixed, mesh, opts = e.config.spec_fixed_accept, e.mesh, e._moe_opts()
        backend = e.config.attn_backend
        Kd = e.spec_k

        @jax.jit
        def fwd(params, kv, batch):
            if not jc.is_moe:
                return (*jm.forward(params, kv, batch, jc, bs, backend,
                                    mesh=mesh, moe_opts=opts), None)
            return jm.forward(params, kv, batch, jc, bs, backend, mesh=mesh,
                              moe_opts=opts, collect_routed=True)

        @jax.jit
        def patch(sb, x, pos, last, drafts):
            slot_row, slot_q, active = sb["slot_row"], sb["slot_q"], \
                sb["active"]
            nd, is_dec = x["spec_n"], x["is_dec"]
            patch_t = is_dec[slot_row]
            qi = jnp.clip(slot_q - 1, 0, max(Kd - 1, 0))
            tok_dec = jnp.where(slot_q == 0, last[slot_row],
                                drafts[slot_row, qi])
            pos_t = jnp.where(patch_t, pos[slot_row] + slot_q,
                              x["positions"])
            dead = x["dead"] | (patch_t & (slot_q > nd[slot_row])) \
                | ~active[slot_row]
            rowbt = sb["block_tables"][slot_row]
            blk = jnp.take_along_axis(rowbt, (pos_t // bs)[:, None],
                                      axis=-1)[:, 0]
            slot = blk * bs + pos_t % bs
            slot_mapping = jnp.where(dead, pos_t % bs, jnp.where(
                patch_t, slot, x["slot_mapping"]))
            seq_lens = jnp.where(is_dec, pos + nd + 1, x["seq_lens"])
            return dict(
                token_ids=jnp.where(patch_t, tok_dec, x["token_ids"]),
                positions=pos_t, token_seq_ids=slot_row, token_qpos=slot_q,
                slot_mapping=slot_mapping, block_tables=sb["block_tables"],
                seq_lens=jnp.where(active, seq_lens, 0),
                sample_idx=x["sample_idx"], qtok_idx=x["qtok_idx"])

        @jax.jit
        def rest(params, dparams, hidden, sb, x, carry, key):
            pos, last, drafts, gen0 = carry
            logits = jm.compute_logits(params, hidden, jc)
            ids, accepted = JSampling.spec_verify(
                logits, drafts, x["spec_n"], sb["temperature"], sb["top_k"],
                sb["top_p"], key, seeds=sb["seeds"], gen0=gen0,
                fixed_accept=fixed, step=x["spec_step"])
            S = accepted.shape[0]
            h = hidden.reshape(S, Kd + 1, hidden.shape[-1])
            h_a = jnp.take_along_axis(h, accepted[:, None, None],
                                      axis=1)[:, 0]
            bonus = jnp.take_along_axis(ids, accepted[:, None], axis=1)[:, 0]
            new_drafts = jm.draft_propose(params, dparams, h_a, bonus, Kd,
                                          jc)
            act, is_dec, comp = sb["active"], x["is_dec"], x["completing"]
            emitted = jnp.where(act & is_dec, accepted + 1,
                                jnp.where(act & comp, 1, 0))
            sampled = act & (is_dec | comp)
            tok_at = jnp.where(is_dec, accepted, 0)
            last = jnp.where(sampled, jnp.take_along_axis(
                ids, tok_at[:, None], axis=1)[:, 0], last)
            drafts = jnp.where(sampled[:, None], new_drafts, drafts)
            pos = jnp.where(act & is_dec, pos + emitted,
                            jnp.where(act, x["next_pos"], pos))
            ys = dict(ids=ids, accepted=accepted)
            if want_top:
                lp, t_ids, t_lps = JSampling.verify_logprobs(logits, ids,
                                                             top_n=20)
                ys.update(lp=lp, top_ids=t_ids, top_lps=t_lps)
            elif want_lp:
                ys["lp"] = JSampling.verify_logprobs(logits, ids)
            return ys, (pos, last, drafts, gen0 + emitted)

        def fn(params, dparams, kv, carry0, sb, xs, rng):
            N = xs["spec_n"].shape[0]
            keys = jax.random.split(rng, N)
            self.keys.append(np.asarray(jax.random.key_data(keys)))
            self.coins.append(np.asarray(xs["spec_step"]))
            carry = tuple(carry0[k] for k in ("pos", "last", "drafts",
                                               "gen0"))
            ys = []
            for r in range(N):
                x = {k: v[r] for k, v in xs.items()}
                batch = patch(sb, x, *carry[:3])
                cache = jax.tree.map(np.asarray, kv)
                hidden, kv, routed = fwd(params, kv, batch)
                self.steps.append((jax.tree.map(np.asarray, batch), cache,
                                   np.asarray(hidden),
                                   None if routed is None
                                   else np.asarray(routed)))
                y, carry = rest(params, dparams, hidden, sb, x, carry,
                                keys[r])
                if e.eplb is not None:
                    y["routed"] = routed      # as the JAX program's ys
                ys.append(y)
            ys = {k: jnp.stack([y[k] for y in ys]) for k in ys[0]}
            return ys, dict(zip(("pos", "last", "drafts", "gen0"), carry)), kv

        return fn

    def serve(self, teng, monkeypatch) -> None:
        """Patch ``teng``'s model forward to replay the recorded rounds.
        The batches must be equal at every query token (the tokens
        ``qtok_idx`` gathers) and in every other plane; the other tokens
        (pads, dead draft slots) must write block-0 trash in both.  In an
        N-round dispatch the port's forward also takes the JAX round's
        expert choice (gate weights from its own scores): a one-ulp
        difference in a router input flips a top-8 near tie otherwise,
        which moves a token's hidden state far past the tolerance."""
        steps = iter(self.steps)
        real = teng.model.forward
        bs = teng.config.block_size
        real_route = TMoeOps.route
        routing = dict(ids=None, layer=0)

        def route(logits, c, e_bias=None):
            w, idx = real_route(logits, c, e_bias=e_bias)
            if routing["ids"] is None:
                return w, idx
            idx = torch.from_numpy(routing["ids"][routing["layer"]].astype(
                np.int32))
            routing["layer"] += 1
            scores, _ = TMoeOps.route_scores(logits, c, e_bias)
            return TMoeOps.gate_weights(scores, idx, c), idx

        def forward(params, kv, batch, *a, **kw):
            jbatch, jcache, jhidden, *routed = next(steps)
            for k, v in kv.items():
                v.copy_(tensor_from_numpy(jcache[k], "cpu"))
            routing.update(ids=routed[0] if routed else None, layer=0)
            got = real(params, kv, batch, *a, **kw)
            if kw.get("collect_routed"):
                # The port's routed ids are the JAX round's expert choice.
                got, got_routed = got
                np.testing.assert_array_equal(got_routed.numpy(), routed[0])
            T = batch["token_ids"].shape[0]
            qtok = batch["qtok_idx"].numpy().reshape(-1)
            live = np.zeros(T, bool)
            live[qtok[qtok < T]] = True
            for k, v in batch.items():
                v = v.numpy()
                if v.shape == (T,):
                    np.testing.assert_array_equal(v[live], jbatch[k][live],
                                                  err_msg=k)
                else:
                    np.testing.assert_array_equal(v, jbatch[k], err_msg=k)
            for sm in (batch["slot_mapping"].numpy(), jbatch["slot_mapping"]):
                assert (sm[~live] < bs).all()
            np.testing.assert_allclose(got.float().numpy(),
                                       jhidden.astype(np.float32),
                                       atol=2e-2, rtol=2e-2)
            hidden = tensor_from_numpy(jhidden, "cpu")
            if kw.get("collect_routed"):
                return hidden, got_routed
            return hidden

        monkeypatch.setattr(teng.model, "forward", forward)
        monkeypatch.setattr(TMoeOps, "route", route)
        self.left = steps


def _mla_requests(R, SP):
    reqs = [greedy_req(r, p, 14, R=R, SP=SP) for r, p in (
        ("a", [1, 5, 9, 200, 3, 17, 42]), ("b", [4, 4, 4, 8]),
        ("c", list(range(40, 55))))]
    reqs.append(seeded_req("s", [3, 1, 4, 1, 5], 12, R=R, SP=SP))
    return reqs


@pytest.mark.parametrize("N,async_,fixed", [(2, False, None),
                                            (4, True, None),
                                            (4, True, 0.8)])
def test_n_round_body_matches_jax_fms_fn_round_by_round(N, async_, fixed,
                                                        monkeypatch):
    """``tiny-mla`` through N-round dispatches (real verification, then
    fixed acceptance): every round's forward batch is the JAX round's,
    the forward is within 2e-2 of it, and on the JAX hidden states the
    tokens each request gets each step, its tokens and its drafted /
    accepted counts equal the JAX engine's; the pool ends whole."""
    over = dict(spec_k=K, num_scheduler_steps=N, async_scheduling=async_,
                spec_fixed_accept=fixed)
    jeng = JEngineCore(JEngineConfig(**MLA_KW, **over))
    replay = FmsReplay(jeng)
    teng = port_of(jeng, MLA_KW, **over)
    free0 = _free(teng)
    jreqs = _mla_requests(JRequest, JSamplingParams)
    jlog = step_log(jeng, jreqs)
    replay.serve(teng, monkeypatch)
    treqs = _mla_requests(Request, SamplingParams)
    tlog = step_log(teng, treqs)
    assert next(replay.left, None) is None
    assert tlog == jlog
    assert [(r.spec_drafted, r.spec_accepted, list(r.output_token_ids))
            for r in treqs] == [(r.spec_drafted, r.spec_accepted,
                                 list(r.output_token_ids)) for r in jreqs]
    assert teng._step_count > teng._dispatch_count
    assert sum(r.spec_drafted for r in treqs) > 0
    assert _free(teng) == free0


def test_round_keys_and_coins_are_jax():
    """Every dispatch's N round keys are ``jax.random.split(step_key,
    N)`` of the key the JAX engine hands its N-round program, and its N
    coins are ``jax.random.uniform(fold_in(PRNGKey(0x5BEC), step), (S,
    K))`` at the JAX rounds' ``spec_step``, bit for bit."""
    over = dict(spec_k=K, num_scheduler_steps=4, async_scheduling=True,
                spec_fixed_accept=0.8, seed=11)
    jeng = JEngineCore(JEngineConfig(**ENGINE_KW, **over))
    replay = FmsReplay(jeng)
    jeng.generate(workload(JRequest, JSamplingParams))
    eng = port_of(jeng, ENGINE_KW, **over)
    got = []
    body = eng._fms_body

    def spy(inp, out, n, *a):
        if n > 1:
            got.append((inp["keys"].numpy().copy(),
                        inp["coin"].numpy().copy()))
        return body(inp, out, n, *a)

    eng._fms_body = spy
    eng.generate(workload())
    assert len(got) == len(replay.keys) > 1
    for (keys, coin), wkeys, steps in zip(got, replay.keys, replay.coins):
        np.testing.assert_array_equal(keys, wkeys.astype(np.int64))
        S = coin.shape[1]
        want = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(
            jax.random.PRNGKey(0x5BEC), int(s)), (S, K))) for s in steps])
        np.testing.assert_array_equal(coin.view(np.int32),
                                      want.view(np.int32))
