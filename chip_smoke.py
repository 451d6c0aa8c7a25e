#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``llm_d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. build    compile the eight CUDA kernels from llm_d_tpu_torch/csrc
            (six sources, one nvcc each, in parallel: D, E and F share
            moe_streamed_int8.cu) and load them;
2. path (i) serve deepseek-v3-bench at full width and depth (random
            weights from a seed) through EngineCore as bench.py configures
            it: int8 experts, int8 latent cache, block size 64, steps of
            up to 8192 tokens, 32 scheduler steps per dispatch with async
            scheduling (each decode block one CUDA graph replay), the
            block pool sized as bench.py sizes it.  Wave 1 (8 x 128-token
            prompts, 32 new tokens), wave 2 (96 x 32, 16 new), wave 3 (64
            x 128, 16 new: the bench's prefill, one 8192-token step), wave
            1 again (must repeat token for token) and wave 3 under
            LLMD_MOE_PREFILL_KERNEL=grouped; every wave's decode must run
            in blocks of 32 steps.  Kernels A-F (MLA decode and prefill,
            dense / routed / streamed / grouped int8 MoE) must all
            launch, and A, C and D inside graph replays.  Then a sampled
            block (8 rows at temperature 0.7, half seeded); one replay of
            the S = 8 and S = 128 greedy graphs and of the sampled one,
            each bit-equal to the block's eager body on the same inputs
            and cache; and waves 1-3 served in alternating rounds (5 a
            side) by the classic loop (one step per dispatch, the same
            weights) and the bench-configured engine: greedy tokens
            identical, decode tok/s and prefill seconds of each side;
3. path(ii) serve llama3-1b at full width and depth, block size 64,
            8192-token steps: 64 x 128-token prompts with 32 new tokens on
            a bf16 cache (twice: must repeat token for token; then with
            32 scheduler steps per dispatch and async scheduling on the
            same weights: the classic run's tokens), then once on an int8
            cache with one scale per row and once with one per KV head.
            Kernels G and H (dense paged decode, dense flash prefill)
            must launch, and G inside graph replays;
4. kernels  each kernel against its plain PyTorch version on the inputs
            of its first launch in phases 2-3 (A: of each batch size S;
            B: of each (S, Q); C and E: of each token count T -- E's
            T=8192 is the bench's step at the default 512-token chunks;
            G and H: of each cache mode; A and G also on 8 sequences x
            4096 keys made from a seed; E also on the bench's 8192-token
            step as one chunk; C also at T = 8, D at T = 256 and 512,
            its 64-row blocks, and F at 128-row tiles, made from a seed),
            then timed
            against it; G and H on the bf16 cache also timed as one
            torch scaled_dot_product_attention call on the same K/V
            gathered to contiguous rows (``library_ms``, a yardstick the
            port never calls);
5. check    logits of the first two layers at full width through the
            kernels against the CPU reference path with the same weights:
            deepseek-v3-bench on a 100-token and on a 1024-token prompt
            (kernels B, D / B, E, then A, C), llama3-1b on a bf16 cache
            (H, then G);
6. parity   the port's repairs against the reference: kernel A on bf16
            latents in 128-row pages and int8 ones in 256-row pages (key
            tiles of 64 and 128 rows) against its plain version, splices
            exact, then phase 5's deepseek-v3-bench check (a 1024-token
            prompt, then a decode step through A) on each; kernels G and
            H at 256-row pages and D = 128 on a bf16 cache and an int8
            one with a scale per KV head against their plain versions,
            then phase 5's check on a 2-layer llama3-8b (D = 128) in
            256-row pages (a 300-token prompt: two pages through H, then
            a decode step through G; both must launch); ``tiny`` (rows too
            narrow for any kernel) served on the card through the chunked
            attention path, a greedy wave twice (must repeat) with first
            tokens equal to the CPU engine's on attn_backend="chunked";
            a soft-capped decode batch through the chunked path against
            the full-softmax reference (atol = rtol = 2e-2); Gumbel noise
            of the threefry sampler drawn on the card for fixed seeds,
            gen_idx values and step keys, bit-equal to the same draw on
            the CPU;
7. server   (a) the port's OpenAI server (``ModelServer``) in this
            process over path (i)'s engine, on a local socket, with a
            tokenizer that writes each token id as decimal text: wave 1's
            prompts as token-id lists one at a time (streamed and not in
            turn), each reply the direct engine's tokens for that prompt
            alone; then all eight at once, each ending by length with 32
            tokens (the count equal to the direct wave's is reported).
            Kernels A-E must launch in this run.  (b) With this process's
            engines freed, ``python -m llm_d_tpu_torch.server.openai``
            with bench.py's flags as a subprocess: readiness on
            /v1/models, wave 3's shape as 64 concurrent requests (half
            streamed: client-side TTFT, TPOT, decode tokens/s) twice, a
            cold load (the process's first prefill and graph capture)
            and a warm one, /metrics against what was served,
            /admin/drain (readiness 503), then SIGTERM: exit code 0
            within the drain time.

Launch counts: every count is set to 0 just before a path is driven and
read just after it; kernels A-F count path (i), G and H path (ii), and
each row adds the in-process server's run (phase 7(a), also given as
``server_launches``).  A
count is the wrapper's own (eager launches, graph warm-ups included)
plus the launches inside graph replays: a capture records each graph's
launches, and every replay adds them (``engine/cuda_graph.py``); the
``kernels`` line gives the latter as ``graph_launches``.

Output, in this order: a ``{"bounds": [...]}`` line (the bytes and flops
each kernel's bound is derived from), a ``{"variants": [...]}`` line (the
fields of the kernels line for the other inputs of phase 4), an
``{"engine": ...}`` line, a ``{"server": ...}`` line (phase 7, with the
card's name and power limit), a ``{"kernels": [...]}`` line (one row per
kernel at its first launch: measured launches, errors and times, with
``bound_ms``), the card's name and power limit, and last ``{"ok": true,
"device": ...}``.  The engine line
holds the classic-against-multistep rounds, the graph checks and the
graphs' shared pool (``pool_bytes``, device memory the captures
reserved).  A kernel's ``ms``
is the event-timed mean of 20 eager calls of its wrapper, so the
wrapper's host cost is in it where it exceeds the kernel's; ``device_ms``
is the same calls queued behind a device sleep, the kernels' device time
alone.

    python3 chip_smoke.py --profile

adds a ``{"profile": ...}`` line: four wave-1 and four wave-2 decode
steps of the classic loop, one multistep block (32 decode iterations,
one graph replay) of wave 1 and of wave 2, and the 8192-token wave-3
prefill step of deepseek-v3-bench, and
llama3-1b's 8192-token prefill step and four of its decode steps (bf16
cache), under ``torch.profiler``, with the device's busy time, kernel
launches and the largest kernels per step (a measurement, not part of
the smoke's pass/fail contract).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak

WAVE1 = dict(n=8, prompt=128, new=32)
WAVE2 = dict(n=96, prompt=32, new=16)
WAVE3 = dict(n=64, prompt=128, new=16)       # bench.py's prefill shape
DENSE_WAVE = dict(n=64, prompt=128, new=32)
BENCH_T = WAVE3["n"] * WAVE3["prompt"]       # 8192-token prefill step
BENCH_K = 32                                 # bench.py's num_scheduler_steps
ROUNDS = 5                                   # classic vs multistep, a side
WAVE2_S = 128                                # wave 2's sequence bucket
DENSE_MODES = (("bf16", None), ("int8", "token"), ("int8", "head"))
# Phase 7(b): the server entry point with path (i)'s configuration
# (bench.py:156-173), and its drain bound.
SERVER_FLAGS = ["--model", "deepseek-v3-bench", "--quantization", "int8",
                "--kv-cache-dtype", "int8", "--block-size", "64",
                "--num-blocks", "576", "--max-num-seqs", "128",
                "--max-num-batched-tokens", str(BENCH_T),
                "--num-scheduler-steps", str(BENCH_K), "--async-scheduling"]
DRAIN_S = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def clone(obj, keep=frozenset()):
    """Deep copy of the tensors in ``obj``, except those whose storage is
    in ``keep`` (the model's weights, which nothing mutates)."""
    import torch
    if isinstance(obj, torch.Tensor):
        if obj.data_ptr() in keep:
            return obj
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: clone(v, keep) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(clone(v, keep) for v in obj)
    return obj


def tensor_ptrs(tree) -> frozenset:
    if isinstance(tree, dict):
        return frozenset().union(*(tensor_ptrs(v) for v in tree.values()))
    return frozenset([tree.data_ptr()])


def cache_mode(args, kw) -> str:
    """Cache mode of a dense attention launch: bf16, int8-token or
    int8-head (the scale planes' width)."""
    ks = kw.get("k_scale")
    if ks is None:
        return "bf16"
    return "int8-token" if ks.shape[-1] == 1 else "int8-head"


class Recorder:
    """Wraps a kernel wrapper (a module attribute the model calls through)
    and keeps a copy of the inputs of its first call of each label
    (``label(args, kw)``), taken before the call so in-place cache updates
    do not leak into the copy.  A wrapper bumps the ``launches`` of
    whatever its module name is bound to, so the count lives on the
    recording wrapper while it is installed."""

    def __init__(self, module, name: str, keep: frozenset, label=None):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.keep = keep
        self.calls = {}

        def wrapped(*args, **kw):
            key = label(args, kw) if label else "first"
            if key not in self.calls:
                self.calls[key] = (clone(args, keep), clone(kw, keep))
            return self.fn(*args, **kw)

        wrapped.launches = 0
        self.wrapped = wrapped
        setattr(module, name, wrapped)


@contextlib.contextmanager
def capture(module, name: str):
    """Records the arguments of the calls to ``module.name`` inside the
    block (the call itself goes through)."""
    seen = []
    inner = getattr(module, name)

    def spy(*args, **kw):
        seen.append((args, kw))
        return inner(*args, **kw)

    spy.launches = 0        # a wrapper bumps what its module name holds
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, inner)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 2):
    """``(device ms, host ms)`` per call of ``fn``: the ``iters`` calls
    are enqueued behind a device sleep, so they run back to back and the
    host's cost of issuing them (Python, allocation, launch), timed on the
    host clock meanwhile, is not in the device time.  The sleep is
    lengthened until it outlasts the enqueueing."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    cycles = 20_000_000
    while True:
        ev[0].record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        ev[1].record()
        for _ in range(iters):
            fn()
        ev[2].record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1.5 * host_ms:
            return ev[1].elapsed_time(ev[2]) / iters, host_ms / iters
        cycles *= 4


def run_wave(engine, prompts, max_new: int, tag: str):
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    import torch
    reqs = [Request(f"{tag}-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=max_new, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    prefill_s = decode_s = 0.0
    decode_tokens = decode_steps = steps = 0
    counts0 = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work():
        all_prefilled = all(r.output_token_ids for r in reqs)
        if all_prefilled and counts0 is None:
            counts0 = (engine._dispatch_count, engine._step_count)
        ts = time.perf_counter()
        outs = engine.step()
        dt = time.perf_counter() - ts
        steps += 1
        if all_prefilled:
            decode_s += dt
            decode_steps += 1
            decode_tokens += sum(len(o.new_token_ids) for o in outs)
        else:
            prefill_s += dt
    torch.cuda.synchronize()
    counts0 = counts0 or (engine._dispatch_count, engine._step_count)
    total_s = time.perf_counter() - t0
    tokens = [list(r.output_token_ids) for r in reqs]
    vocab = engine.model_config.vocab_size
    for r, toks in zip(reqs, tokens):
        if len(toks) != max_new or not all(0 <= t < vocab for t in toks):
            raise RuntimeError(f"{r.request_id}: got {len(toks)} tokens "
                               f"(want {max_new} in [0, {vocab}))")
    return tokens, dict(requests=len(prompts), steps=steps,
                        seconds=total_s, prefill_seconds=prefill_s,
                        decode_steps=decode_steps, decode_seconds=decode_s,
                        decode_tokens=decode_tokens,
                        decode_tok_s=(decode_tokens / decode_s
                                      if decode_s else None),
                        # Device dispatches and engine steps of the decode
                        # phase: K steps per dispatch under multistep.
                        decode_dispatches=engine._dispatch_count
                        - counts0[0],
                        decode_engine_steps=engine._step_count - counts0[1])


def prompts_for(rng, vocab: int, wave: dict):
    return [rng.integers(1, vocab, wave["prompt"]).tolist()
            for _ in range(wave["n"])]


def clone_to(tree, device):
    if isinstance(tree, dict):
        return {k: clone_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def reference_check(mc, params, engine_kw, prompt_lens, seed: int) -> dict:
    """The first two layers at full width (``mc``, ``params`` on the card),
    through the kernels and through the CPU reference path with the same
    weights: one prefill step of ``prompt_lens`` and one decode step.
    Deeper random-weight stacks amplify the expected bf16 rounding
    differences chaotically, so depth is cut here, not width; the context
    is cut to what the prompts need, because the reference path gathers
    every key of a sequence's block table for every query row."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, mc.vocab_size, n).tolist()
               for n in prompt_lens]
    logits = {}
    for dev in ("cpu", "cuda"):
        eng = EngineCore(EngineConfig(model_config=mc, device=dev,
                                      **engine_kw),
                         params=params if dev == "cuda"
                         else clone_to(params, "cpu"))
        reqs = [Request(f"ref{i}", p, SamplingParams(
            temperature=0.0, max_tokens=2, ignore_eos=True))
            for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        steps = []
        for step in range(2):
            sched = eng.scheduler.schedule()
            batch, _ = eng._build_batch(sched)
            hidden = eng.model.forward(eng.params, eng.kv_cache, batch, mc,
                                       engine_kw["block_size"])
            n = len(sched.scheduled)
            steps.append(eng.model.compute_logits(
                eng.params, hidden, mc)[:n].float().cpu())
            for sr in sched.scheduled:
                sr.request.num_computed_tokens += sr.num_new_tokens
            # Both sides decode the tokens the CPU reference picked.
            ref = logits["cpu"][step] if dev == "cuda" else steps[-1]
            for r, tok in zip(reqs, ref.argmax(-1).tolist()):
                r.output_token_ids.append(tok)
        logits[dev] = torch.stack(steps)
        del eng
    got, want = logits["cuda"], logits["cpu"]
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite logits from the kernel path")
    rel = float((got - want).abs().max() / want.abs().max())
    top = bool((got.argmax(-1) == want.argmax(-1)).all())
    return dict(model=mc.name, layers=mc.num_layers, prompts=prompt_lens,
                rel_max_err=rel, top1_agree=top, shape=list(got.shape))


def _profile_steps(engine, steps: int, drain: bool = False) -> dict:
    """``steps`` engine steps under ``torch.profiler`` (with ``drain``,
    every step until the engine is idle, counted as ``steps``): wall and
    device time per step, launches and the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if drain:
            while engine.has_work():
                engine.step()
        else:
            for _ in range(steps):
                engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            kernels.append((ev.key, dev_us / 1e3 / steps, ev.count / steps))
    device_ms = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    return dict(
        steps=steps, wall_ms_per_step=wall_ms,
        device_ms_per_step=device_ms if kernels else None,
        device_busy_share=device_ms / wall_ms if kernels else None,
        kernel_launches_per_step=sum(k[2] for k in kernels),
        top=[dict(name=n[:80], ms_per_step=m, launches_per_step=c)
             for n, m, c in kernels[:12]])


def add_requests(engine, prompts, tag: str, n: int):
    """Greedy requests for ``prompts`` (``n`` new tokens each), added to
    ``engine``."""
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    reqs = [Request(f"{tag}-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=n, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    return reqs


def profile_dense(engine, prompts) -> dict:
    """Device busy time of the single prefill step of ``prompts`` (an
    8192-token step through kernel H) and of four decode steps (kernel G)
    after one untraced one."""
    add_requests(engine, prompts, "profd", 8)
    out = {"prefill": dict(_profile_steps(engine, 1),
                           tokens=sum(map(len, prompts)))}
    engine.step()                         # one decode step outside the trace
    out["decode"] = dict(_profile_steps(engine, 4), batch=len(prompts))
    while engine.has_work():
        engine.step()
    return out


def profile_waves(engine, decode_prompts, routed_prompts,
                  prefill_prompts) -> dict:
    """Device busy time of four decode steps of ``decode_prompts`` and of
    ``routed_prompts`` (wave 2: kernel D) after their prefill and one
    untraced decode step, and of the single prefill step of
    ``prefill_prompts``."""
    out = {}
    for key, prompts in (("decode", decode_prompts),
                         ("decode_routed", routed_prompts)):
        reqs = add_requests(engine, prompts, f"prof-{key}", 8)
        while not all(r.output_token_ids for r in reqs):
            engine.step()
        engine.step()                     # one decode step outside the trace
        out[key] = dict(_profile_steps(engine, 4), batch=len(prompts))
        while engine.has_work():
            engine.step()
    add_requests(engine, prefill_prompts, "profp", 2)
    out["prefill"] = dict(_profile_steps(engine, 1),
                          tokens=sum(map(len, prefill_prompts)))
    while engine.has_work():
        engine.step()
    return out


def profile_blocks(engine, waves) -> dict:
    """Device busy time of one multistep block (``BENCH_K`` decode
    iterations, one graph replay) of each of ``waves`` ({name: prompts})
    after its prefill step: the dispatching step and the retiring one,
    until the engine is idle (one block: each request asks for
    ``1 + BENCH_K`` tokens)."""
    out = {}
    for key, prompts in waves.items():
        reqs = add_requests(engine, prompts, f"profb-{key}", 1 + BENCH_K)
        while not all(r.output_token_ids for r in reqs):
            engine.step()
        d0 = engine._dispatch_count
        out[key] = dict(_profile_steps(engine, 1, drain=True),
                        batch=len(prompts), engine_steps=BENCH_K,
                        dispatches=engine._dispatch_count - d0)
    return out


def path_i_engine(steps: int = BENCH_K, params=None):
    """deepseek-v3-bench as bench.py serves it, random weights from seed 0
    (or ``params``): int8 experts, int8 latent cache, block size 64, steps
    of up to ``BENCH_T`` tokens, ``steps`` scheduler steps per dispatch
    with async scheduling (the classic loop at ``steps`` = 1), and the
    block pool sized as bench.py:157-163 sizes it: room for every
    sequence's prompt, its new tokens and one more block of steps."""
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    max_seqs, bs = 128, 64
    per_seq = -(-(WAVE1["prompt"] + WAVE1["new"] + BENCH_K + 1) // bs)
    return EngineCore(EngineConfig(
        model="deepseek-v3-bench", quantization="int8",
        kv_cache_dtype="int8", block_size=bs,
        num_blocks=max_seqs * per_seq + bs, max_num_seqs=max_seqs,
        max_num_batched_tokens=BENCH_T, num_scheduler_steps=steps,
        async_scheduling=steps > 1, enable_prefix_caching=False,
        device="cuda", seed=0), params=params)


def path_ii_engine(kv: str, gran, steps: int = 1, params=None):
    """llama3-1b at full width and depth, random weights from seed 1 (or
    ``params``), on a ``kv`` cache (bf16, or int8 with scales per
    ``gran``: token or head): block size 64, steps of up to ``BENCH_T``
    tokens, 64 sequences, ``steps`` scheduler steps per dispatch (async
    scheduling when more than one)."""
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    return EngineCore(EngineConfig(
        model="llama3-1b", kv_cache_dtype=kv, kv_scale_granularity=gran,
        block_size=64, num_blocks=256, max_num_seqs=64,
        max_num_batched_tokens=BENCH_T, num_scheduler_steps=steps,
        async_scheduling=steps > 1, enable_prefix_caching=False,
        device="cuda", seed=1), params=params)


def check_multistep(stats: dict, tag: str) -> None:
    """Every decode dispatch of a wave served by a multistep engine was a
    block of ``BENCH_K`` engine steps."""
    d, n = stats["decode_dispatches"], stats["decode_engine_steps"]
    if d == 0 or n != BENCH_K * d:
        raise RuntimeError(f"{tag}: decode ran {n} engine steps in {d} "
                           f"dispatches, not blocks of {BENCH_K}")


def spread(values) -> dict:
    """Median, quartiles and range of ``values``."""
    import numpy as np
    v = np.asarray(values, dtype=float)
    return dict(median=float(np.median(v)), q1=float(np.percentile(v, 25)),
                q3=float(np.percentile(v, 75)), min=float(v.min()),
                max=float(v.max()), n=len(v))


def classic_rounds(classic, bench, waves: dict, rounds: int) -> dict:
    """Each of ``waves`` ({name: (wave, prompts)}) served by the classic
    engine and by the bench-configured one in alternating rounds (the
    side that goes first alternates too).  Greedy tokens must be identical
    between the two sides in every round.  Per wave and side: the spread
    of decode tok/s and prefill seconds, and whether the multistep side's
    decode tok/s is resolved above the classic side's (every multistep
    round above every classic round)."""
    runs = {w: {"classic": [], "multistep": []} for w in waves}
    for r in range(rounds):
        sides = [("classic", classic), ("multistep", bench)]
        if r % 2:
            sides.reverse()
        for w, (wave, prompts) in waves.items():
            tokens = {}
            for side, eng in sides:
                tokens[side], st = run_wave(eng, prompts, wave["new"],
                                            f"{side[0]}{r}{w}")
                if side == "multistep":
                    check_multistep(st, f"round {r} {w}")
                runs[w][side].append(st)
            if tokens["classic"] != tokens["multistep"]:
                diff = sum(a != b for x, y in zip(tokens["classic"],
                                                  tokens["multistep"])
                           for a, b in zip(x, y))
                raise RuntimeError(f"round {r} {w}: multistep tokens differ "
                                   f"from the classic loop's in {diff}")
    out = {}
    for w, sides in runs.items():
        out[w] = {side: dict(
            decode_tok_s=spread([st["decode_tok_s"] for st in sts]),
            prefill_s=spread([st["prefill_seconds"] for st in sts]))
            for side, sts in sides.items()}
        out[w]["same_tokens"] = True
        out[w]["decode_resolved"] = (
            out[w]["multistep"]["decode_tok_s"]["min"]
            > out[w]["classic"]["decode_tok_s"]["max"])
    return out


def graph_equals_eager(engine, key) -> dict:
    """The decode-block graph of ``key`` ((S, random rows)) replayed on its
    static inputs against the block's eager body
    (``EngineCore._ms_body``) on the same inputs from the same cache:
    ids and cache planes bit-equal."""
    import torch
    g = engine._graphs.graphs[key]
    snap = {k: v.clone() for k, v in engine.kv_cache.items()}
    g.graph.replay()
    torch.cuda.synchronize()
    ids_graph = g.ids.clone()
    kv_graph = {k: v.clone() for k, v in engine.kv_cache.items()}
    for k, v in engine.kv_cache.items():
        v.copy_(snap[k])
    ids_eager = torch.empty_like(g.ids)
    engine._ms_body(g.inputs, g.inputs["keys"], ids_eager, key[1])
    torch.cuda.synchronize()
    res = dict(S=key[0], random_rows=key[1], K=g.ids.shape[0],
               live_rows=int(g.inputs["active"].sum()),
               ids_equal=torch.equal(ids_graph, ids_eager),
               cache_equal=all(torch.equal(v, kv_graph[k])
                               for k, v in engine.kv_cache.items()))
    del snap, kv_graph
    if not (res["ids_equal"] and res["cache_equal"]):
        raise RuntimeError(f"graph replay differs from the eager body: {res}")
    return res


def sampled_block(engine, vocab: int) -> list:
    """Eight requests at temperature 0.7 (top-p 0.9; every other one
    seeded) served by the multistep engine: a prefill step and one block
    with random rows."""
    import numpy as np
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    rng = np.random.default_rng(4)
    reqs = [Request(f"smp-{i}", rng.integers(1, vocab, 64).tolist(),
                    SamplingParams(temperature=0.7, top_p=0.9,
                                   seed=1234 + i if i % 2 else None,
                                   max_tokens=1 + BENCH_K, ignore_eos=True))
            for i in range(8)]
    out = engine.generate(reqs)
    toks = [out[r.request_id] for r in reqs]
    if any(len(t) != 1 + BENCH_K for t in toks) or \
            len({t for row in toks for t in row}) < 2:
        raise RuntimeError(f"sampled block: {toks}")
    return toks


def dense_prompts(vocab: int):
    """The path (ii) wave's prompts (the same in every cache mode)."""
    import numpy as np
    return prompts_for(np.random.default_rng(2), vocab, DENSE_WAVE)


def long_decode_inputs(args, kw, S: int, keys: int, seed: int):
    """Kernel A's inputs at long context, from a seed: S sequences of
    ``keys`` keys each on one int8 layer plane, at the row width, heads,
    block size, block-table width and scale of the recorded launch
    ``(args, kw)``."""
    q0, _, cache, bt0 = args[:4]
    return decode_inputs(True, kw["block_size"], [keys] * S, seed,
                         H=q0.shape[1], F=cache.shape[-1], scale=kw["scale"],
                         B=bt0.shape[1])


def decode_inputs(quantized: bool, bs: int, seq_lens, seed: int,
                  H: int = 16, F: int = 640, scale: float = 0.1,
                  B: int = 0):
    """Kernel A's inputs from a seed: ``seq_lens`` sequences on one latent
    layer plane (int8 with a row scale, or bf16) holding just their pages
    of ``bs`` rows, in random order; block tables ``B`` entries wide, or
    as wide as the longest sequence needs."""
    import torch
    from llm_d_tpu_torch.ops.quant import quantize_kv_block
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(seq_lens)
    pages = [-(-n // bs) for n in seq_lens]
    nblk = sum(pages) + 1
    kv = torch.randn((1, nblk * bs, F), generator=g, device=dev).bfloat16()
    row = torch.randn((S, F), generator=g, device=dev).bfloat16()
    ks = row_s = None
    if quantized:
        kv, ks = quantize_kv_block(kv, 1)
        row, row_s = quantize_kv_block(row, 1)
    bt = random_tables(g, pages, B)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    q = torch.randn((S, H, F), generator=g, device=dev).bfloat16()
    return (q, row, kv, bt, lens), dict(
        block_size=bs, scale=scale, layer=0, kv_scale=ks,
        row_scale_new=row_s)


def random_tables(g, pages, B: int = 0):
    """Block tables of sequences holding ``pages[i]`` pages each, drawn
    in random order from blocks 1 .. sum(pages) (block 0 stays the trash
    block), ``B`` entries wide or as wide as the longest needs."""
    import torch
    dev = torch.device("cuda")
    nblk = sum(pages) + 1
    perm = (torch.randperm(nblk - 1, generator=g, device=dev) + 1).to(
        torch.int32)
    bt = torch.zeros((len(pages), max(B, max(pages))), dtype=torch.int32,
                     device=dev)
    for s, (start, n) in enumerate(zip(
            [sum(pages[:i]) for i in range(len(pages))], pages)):
        bt[s, :n] = perm[start:start + n]
    return bt


def dense_rows(g, shape, sw: int):
    """bf16 rows from ``g``, or int8 ones with ``sw`` f32 scale columns:
    ``(rows, scales or None)``."""
    import torch
    from llm_d_tpu_torch.ops.quant import quantize_kv_block
    rows = torch.randn(shape, generator=g, device="cuda").bfloat16()
    return (rows, None) if sw == 0 else quantize_kv_block(rows, sw)


def dense_decode_inputs(sw: int, bs: int, seq_lens, seed: int, H: int = 32,
                        KVH: int = 8, D: int = 64, scale: float = 0.125,
                        B: int = 0):
    """Kernel G's inputs from a seed: ``seq_lens`` sequences on one K and
    one V layer plane (bf16, or int8 with ``sw`` scale columns) holding
    just their pages of ``bs`` rows, in random order, and each sequence's
    new K/V rows; block tables ``B`` entries wide, or as wide as the
    longest sequence needs."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, F = len(seq_lens), KVH * D
    pages = [-(-n // bs) for n in seq_lens]
    slots = (sum(pages) + 1) * bs
    (kc, ks), (vc, vs) = (dense_rows(g, (1, slots, F), sw) for _ in range(2))
    (kn, kns), (vn, vns) = (dense_rows(g, (S, F), sw) for _ in range(2))
    bt = random_tables(g, pages, B)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    q = torch.randn((S, H, D), generator=g, device="cuda").bfloat16()
    return (q, kn, vn, kc, vc, bt, lens), dict(
        block_size=bs, num_kv_heads=KVH, scale=scale, layer=0, k_scale=ks,
        v_scale=vs, k_scale_new=kns, v_scale_new=vns)


def long_dense_decode_inputs(args, kw, S: int, keys: int, seed: int):
    """Kernel G's inputs at long context, from a seed: S sequences of
    ``keys`` keys each on a bf16 layer plane, at the heads, block size,
    block-table width and scale of the recorded launch ``(args, kw)``."""
    q0, bt0 = args[0], args[5]
    return dense_decode_inputs(0, kw["block_size"], [keys] * S, seed,
                               H=q0.shape[1], KVH=kw["num_kv_heads"],
                               D=q0.shape[2], scale=kw["scale"],
                               B=bt0.shape[1])


def dense_prefill_inputs(sw: int, bs: int, seq_lens, q_lens, seed: int,
                         H: int = 32, KVH: int = 8, D: int = 128,
                         scale: float = 0.09):
    """Kernel H's inputs from a seed: sequence i's last ``q_lens[i]``
    positions are the queries (padded to the longest, pad rows at
    position -1) over a bf16 or int8 (``sw`` scale columns) layer plane
    holding just its pages of ``bs`` rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    S, F, Q = len(seq_lens), KVH * D, max(q_lens)
    pages = [max(-(-n // bs), 1) for n in seq_lens]
    slots = (sum(pages) + 1) * bs
    (kc, ks), (vc, vs) = (dense_rows(g, (1, slots, F), sw) for _ in range(2))
    bt = random_tables(g, pages)
    q_pos = torch.full((S, Q), -1, dtype=torch.int32, device="cuda")
    for i, (n, m) in enumerate(zip(seq_lens, q_lens)):
        q_pos[i, :m] = torch.arange(n - m, n, device="cuda")
    qs = torch.randn((S, Q, H, D), generator=g, device="cuda").bfloat16()
    qs[q_pos < 0] = 0
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return (qs, q_pos, kc, vc, bt, lens), dict(
        block_size=bs, num_kv_heads=KVH, scale=scale, layer=0, k_scale=ks,
        v_scale=vs)


def sdpa_ms(name: str, args, kw) -> float:
    """Eager ms of one ``torch.nn.functional.scaled_dot_product_attention``
    call computing kernel G's (``paged_decode``) or H's
    (``flash_prefill``) attention on a bf16 cache: the same queries, and
    K/V gathered (untimed) from the cache into contiguous [S, KVH, L, D]
    rows of each sequence's live keys, causal where every query row
    attends its own prefix.  A yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as Fn
    bs, KVH, scale = kw["block_size"], kw["num_kv_heads"], kw["scale"]
    if name == "paged_decode":
        q, kc, vc, bt, sl = args[0], args[3], args[4], args[5], args[6]
        q = q[:, :, None, :]                                 # [S, H, 1, D]
        q_pos = (sl.long() - 1)[:, None]                     # [S, 1]
    else:
        qs, q_pos, kc, vc, bt, sl = args[:6]
        q = qs.permute(0, 2, 1, 3).contiguous()              # [S, H, Q, D]
        q_pos = q_pos.long()
    S, H, Q, D = q.shape
    L = int(sl.max())
    keys = torch.arange(L, device=q.device)
    slots = bt.long()[:, keys // bs] * bs + keys % bs        # [S, L]
    layer = kw.get("layer") or 0

    def gather(cache):
        plane = cache[layer] if cache.ndim == 3 else cache
        return plane[slots].view(S, L, KVH, D).permute(0, 2, 1, 3).contiguous()

    k, v = gather(kc), gather(vc)
    causal = Q == L and bool((sl == L).all()) and bool(
        (q_pos == keys[None, :]).all())
    mask = None
    if not causal:
        mask = ((keys[None, None, :] <= q_pos[:, :, None])
                & (keys[None, None, :] < sl.long()[:, None, None]))[:, None]
    try:
        Fn.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                        is_causal=causal, scale=scale,
                                        enable_gqa=True)
        extra = dict(enable_gqa=True)
    except TypeError:                    # torch without enable_gqa
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
        extra = {}
    return time_ms(lambda: Fn.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, scale=scale, **extra),
        iters=20)


def moe_inputs(mc, T: int, seed: int):
    """``T`` tokens of hidden rows and top-k routing over the model's
    experts, from a seed, on the card."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    E, k = mc.num_experts, mc.num_experts_per_tok
    x = torch.randn((T, mc.hidden_size), generator=g,
                    device=dev).bfloat16()
    idx = torch.argsort(torch.rand((T, E), generator=g, device=dev),
                        dim=1)[:, :k].to(torch.int32)
    w = torch.rand((T, k), generator=g, device=dev) / k
    return x, w, idx


def large_page_reference(mc, params, quantized: bool, bs: int,
                         wrappers) -> dict:
    """``reference_check`` (a 1024-token prefill, then one decode step
    through kernel A) on a latent cache in pages of ``bs`` rows, larger
    than two of which fit A's shared memory; each of ``wrappers``
    (``(module, name)`` of kernels A and B) must launch."""
    engine_kw = dict(quantization="int8",
                     kv_cache_dtype="int8" if quantized else "bf16",
                     block_size=bs, num_blocks=1536 // bs + 1,
                     max_num_seqs=8, max_num_batched_tokens=1024,
                     enable_prefix_caching=False)
    before = [getattr(m, f).launches for m, f in wrappers]
    ref = reference_check(mc, params, engine_kw, [1024], 8)
    ref.update(latent=engine_kw["kv_cache_dtype"], block_size=bs,
               launches=[getattr(m, f).launches - b
                         for (m, f), b in zip(wrappers, before)])
    if min(ref["launches"]) == 0:
        raise RuntimeError(f"kernel A or B did not launch: {ref}")
    return ref


def dense_large_page_reference(wrappers) -> dict:
    """``reference_check`` of a 2-layer llama3-8b (D = 128, random weights
    from a seed) on a bf16 cache in 256-row pages: a 300-token prefill (two
    pages through kernel H), then one decode step through kernel G; each
    of ``wrappers`` (``(module, name)`` of G and H) must launch."""
    import dataclasses
    import torch
    from llm_d_tpu_torch.models import llama
    from llm_d_tpu_torch.models.config import get_config
    mc = dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                             max_model_len=1024)
    params = llama.init_params(
        mc, torch.Generator(device="cuda").manual_seed(4),
        torch.device("cuda"))
    engine_kw = dict(block_size=256, num_blocks=5, max_num_seqs=8,
                     max_num_batched_tokens=512, enable_prefix_caching=False)
    before = [getattr(m, f).launches for m, f in wrappers]
    ref = reference_check(mc, params, engine_kw, [300], 13)
    ref.update(block_size=256, launches=[
        getattr(m, f).launches - b for (m, f), b in zip(wrappers, before)])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if min(ref["launches"]) == 0:
        raise RuntimeError(f"kernel G or H did not launch: {ref}")
    if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
        raise RuntimeError(f"kernel path disagrees with the CPU "
                           f"reference: {ref}")
    return ref


def tiny_on_the_card() -> dict:
    """``tiny`` (KVH*D = 32: no kernel takes its rows) on the card: a
    greedy wave through the chunked attention path, served twice (must
    repeat), first tokens against the CPU engine on the 'chunked'
    backend."""
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.ops import attention
    kw = dict(model="tiny", block_size=32, num_blocks=128, max_num_seqs=16,
              max_num_batched_tokens=512, enable_prefix_caching=False)
    card = EngineCore(EngineConfig(device="cuda", **kw))
    host = EngineCore(EngineConfig(device="cpu", attn_backend="chunked",
                                   **kw),
                      params=clone_to(card.params, "cpu"))
    prompts = [np.random.default_rng(3).integers(
        1, card.model_config.vocab_size, n).tolist()
        for n in (7, 40, 100, 3, 64, 33)]
    with capture(attention, "ragged_paged_attention_chunked") as seen:
        tok, stats = run_wave(card, prompts, 16, "tiny")
    tok2, _ = run_wave(card, prompts, 16, "tiny2")
    ref = cpu_tokens(host, prompts, 16)
    res = dict(wave=stats, repeat=tok2 == tok,
               first_tokens_match_cpu=[t[0] for t in tok]
               == [t[0] for t in ref],
               tokens_match_cpu=tok == ref,
               chunked_calls=len(seen),
               chunked_on_cuda=all(a[0].is_cuda for a, _ in seen))
    if not (res["repeat"] and res["first_tokens_match_cpu"] and seen
            and res["chunked_on_cuda"]):
        raise RuntimeError(f"tiny on the card: {res}")
    return res


def cpu_tokens(engine, prompts, max_new: int):
    """Greedy tokens of ``prompts`` from a CPU engine."""
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    reqs = [Request(f"cpu-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=max_new, ignore_eos=True))
        for i, p in enumerate(prompts)]
    out = engine.generate(reqs)
    return [out[r.request_id] for r in reqs]


def soft_cap_through_chunked() -> dict:
    """A soft-capped decode batch (no kernel takes one) through
    ``attention_with_kv_update`` on the card, which sends it to the
    chunked path, against the full-softmax reference on the same cache:
    atol = rtol = 2e-2, the K/V rows written identically outside the
    trash block."""
    import torch
    from llm_d_tpu_torch.ops import attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    H, KVH, D, bs, L = 32, 8, 64, 64, 2
    lens = [1, 63, 64, 65, 700, 2000, 0, 0]
    S, B = len(lens), 32
    T = S
    nblk = S * B + 1
    caches = [torch.randn((L, nblk * bs, KVH * D), generator=g,
                          device=dev).bfloat16() for _ in range(2)]
    bt = (torch.randperm(nblk - 1, generator=g, device=dev)[:S * B] + 1
          ).reshape(S, B).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    bt[sl == 0] = 0
    pos = (sl - 1).clamp(min=0)
    rows = torch.arange(S, device=dev)
    slot = torch.where(sl > 0, bt[rows, pos // bs] * bs + pos % bs, 0)
    batch = dict(positions=pos.int(), token_seq_ids=rows.int(),
                 token_qpos=torch.zeros(T, dtype=torch.int32, device=dev),
                 slot_mapping=slot.int(), block_tables=bt.contiguous(),
                 seq_lens=sl,
                 qtok_idx=torch.where(sl > 0, rows, T).int()[:, None])
    q = torch.randn((T, H, D), generator=g, device=dev).bfloat16()
    kn = torch.randn((T, KVH, D), generator=g, device=dev).bfloat16()
    vn = torch.randn((T, KVH, D), generator=g, device=dev).bfloat16()
    outs = []
    with capture(attention, "ragged_paged_attention_chunked") as seen:
        for backend in ("kernel", "reference"):
            kc, vc = (c.clone() for c in caches)
            outs.append((attention.attention_with_kv_update(
                q, kn, vn, kc, vc, batch, block_size=bs, scale=0.125,
                soft_cap=30.0, backend=backend, layer=1)))
    torch.cuda.synchronize()
    live = sl > 0
    got, want = outs[0][0][live].float(), outs[1][0][live].float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    # Block 0 is the trash block: the pad rows all write slot 0, in no
    # fixed order, and no unmasked read touches it.
    for a, b in zip(outs[0][1:], outs[1][1:]):
        if not torch.equal(a[:, bs:], b[:, bs:]):
            raise RuntimeError("soft-capped batch: cache writes differ")
    if len(seen) != 1 or not torch.isfinite(outs[0][0]).all():
        raise RuntimeError(f"soft-capped batch: {len(seen)} chunked calls")
    return dict(shape=[T, H, D], seq_lens=lens, chunked_calls=len(seen),
                max_abs_err=float((got - want).abs().max()))


def noise_on_the_card() -> dict:
    """The sampler's Gumbel noise drawn on the card and on the CPU for the
    same rows: seeded (seeds 0, 7, 2**31 - 1 at several gen_idx) and
    unseeded (step keys split from the engine key of seeds 0 and 3), bit
    for bit."""
    import torch
    from llm_d_tpu_torch.ops import prng, sampling
    seeds = torch.tensor([0, 7, 2**31 - 1, -1, 7, -1, 0, -1],
                         dtype=torch.int32)
    gen = torch.tensor([0, 1, 1000, 5, 15, 0, 3, 2], dtype=torch.int32)
    rows = 0
    for engine_seed in (0, 3):
        key = prng.prng_key(engine_seed)
        for _ in range(3):
            key, step = prng.split(key)
            cpu = sampling.row_noise(8, 64, torch.device("cpu"), step,
                                     seeds, gen)
            card = sampling.row_noise(8, 64, torch.device("cuda"), step,
                                      seeds.cuda(), gen.cuda()).cpu()
            if not torch.equal(cpu.view(torch.int32),
                               card.view(torch.int32)):
                bad = int((cpu.view(torch.int32)
                           != card.view(torch.int32)).sum())
                raise RuntimeError(f"Gumbel noise differs on the card in "
                                   f"{bad} of {cpu.numel()} values")
            rows += 8
    return dict(rows=rows, values_per_row=64, bit_equal=True)


class DecimalTokenizer:
    """Decodes each id as its decimal text and a space (so a reply's text
    carries its token ids, and the text of a prefix is a prefix of the
    text); no special tokens."""
    bos_token_id = eos_token_id = pad_token_id = None

    def encode(self, text: str, add_bos: bool = True):
        return [int(t) for t in text.split()]

    def decode(self, ids) -> str:
        return "".join(f"{i} " for i in ids)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(url: str, path: str, body=None, timeout: float = 600.0):
    """``(status, headers, reply)`` of one call (a POST when ``body`` is
    given); a JSON reply is parsed, any other is text.  ``headers`` look
    names up without regard to case."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, headers, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, headers, raw = e.code, e.headers, e.read()
    if headers.get("Content-Type", "").startswith("application/json"):
        return status, headers, json.loads(raw)
    return status, headers, raw.decode()


def completion(url: str, body: dict, timeout: float = 600.0) -> dict:
    """One /v1/completions call, streamed or not: its token count (from
    the usage block of a whole reply), its token ids (a stream's from each
    chunk's ``llmd`` meta; a whole reply's from its text, read as the
    ``DecimalTokenizer`` writes it, when the server uses that tokenizer),
    finish reason, and client-side clock readings (``perf_counter``) at
    the send, the first and the last token chunk, and the end."""
    import urllib.request
    t_send = time.perf_counter()
    if not body.get("stream"):
        status, _, reply = http_call(url, "/v1/completions", body, timeout)
        if status != 200:
            raise RuntimeError(f"completion: HTTP {status}: {reply}")
        choice = reply["choices"][0]
        words = choice["text"].split()
        return dict(n=reply["usage"]["completion_tokens"],
                    tokens=([int(t) for t in words]
                            if all(w.isdigit() for w in words) else None),
                    finish=choice["finish_reason"], t_send=t_send,
                    t_first=None, t_last=None, t_end=time.perf_counter())
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    tokens, finish, t_first, t_last, done = [], None, None, None, False
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):].strip()
            if data == b"[DONE]":
                done = True
                break
            chunk = json.loads(data)
            now = time.perf_counter()
            if chunk["llmd"]["tok"]:
                t_first = t_first or now
                t_last = now
            tokens += chunk["llmd"]["tok"]
            finish = chunk["choices"][0]["finish_reason"] or finish
    if not done:
        raise RuntimeError("completion: the stream ended before [DONE]")
    return dict(n=len(tokens), tokens=tokens, finish=finish, t_send=t_send,
                t_first=t_first, t_last=t_last, t_end=time.perf_counter())


def concurrently(url: str, bodies) -> list:
    """``completion`` of every body at once, one thread each."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(bodies)) as ex:
        return list(ex.map(lambda b: completion(url, b), bodies))


def serve_in_thread(server):
    """Start ``server`` (a ``ModelServer``) on a local socket, on an event
    loop in its own thread; returns ``(url, close)``."""
    import asyncio
    import threading
    loop = asyncio.new_event_loop()
    app = server.build_app()
    box = {}
    ready = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        try:
            box["port"] = loop.run_until_complete(app.start("127.0.0.1", 0))
        except BaseException as e:            # reported to the caller
            box["error"] = e
            ready.set()
            return
        ready.set()
        loop.run_forever()

    thread = threading.Thread(target=run, name="smoke-server", daemon=True)
    thread.start()
    if not ready.wait(120) or "error" in box:
        raise RuntimeError(f"the in-process server did not start: "
                           f"{box.get('error')}")

    def close():
        asyncio.run_coroutine_threadsafe(app.close(), loop).result(120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        if thread.is_alive():
            raise RuntimeError("the in-process server did not stop")

    return f"http://127.0.0.1:{box['port']}", close


def greedy_body(prompt, max_new: int, stream: bool) -> dict:
    return dict(prompt=prompt, max_tokens=max_new, temperature=0.0,
                ignore_eos=True, stream=stream)


def server_in_process(engine, prompts, max_new: int, alone, together):
    """Phase 7(a): ``ModelServer`` over ``engine`` (path (i)'s, already
    served and captured), the ``DecimalTokenizer`` as its tokenizer.
    ``prompts`` one at a time, streamed and not in turn: each reply must
    hold ``alone`` (the direct engine's tokens for that prompt alone);
    then all at once: each must end by length with ``max_new`` tokens,
    and the count of tokens equal to ``together`` (the direct engine's
    wave) is reported."""
    from llm_d_tpu_torch.server.openai import ModelServer
    server = ModelServer(engine, DecimalTokenizer(), "deepseek-v3-bench")
    url, close = serve_in_thread(server)
    try:
        got = [completion(url, greedy_body(p, max_new, bool(i % 2)))
               for i, p in enumerate(prompts)]
        bad = [i for i, (g, want) in enumerate(zip(got, alone))
               if g["tokens"] != want or g["finish"] != "length"]
        if bad:
            raise RuntimeError(f"server replies {bad} differ from the "
                               f"direct engine's tokens")
        conc = concurrently(url, [greedy_body(p, max_new, bool(i % 2))
                                  for i, p in enumerate(prompts)])
        for i, r in enumerate(conc):
            if r["finish"] != "length" or r["tokens"] is None \
                    or len(r["tokens"]) != max_new:
                raise RuntimeError(f"concurrent request {i}: {r['n']} "
                                   f"tokens, finish {r['finish']}")
        agree = sum(a == b for r, want in zip(conc, together)
                    for a, b in zip(r["tokens"], want))
        if server.async_engine.dead is not None:
            raise RuntimeError("the engine thread died") \
                from server.async_engine.dead
    finally:
        close()
    return dict(one_at_a_time=len(got), identical=True,
                concurrent=len(conc),
                concurrent_tokens_equal_to_the_wave=agree,
                concurrent_tokens=max_new * len(conc))


def scrape(url: str) -> dict:
    from llm_d_tpu_torch.utils.metrics import parse_prometheus_text
    status, _, text = http_call(url, "/metrics", timeout=60)
    if status != 200:
        raise RuntimeError(f"/metrics: HTTP {status}")
    return parse_prometheus_text(text)


def server_subprocess(root: str, vocab: int) -> dict:
    """Phase 7(b): ``python -m llm_d_tpu_torch.server.openai`` with the
    bench flags on a free port (its log in build/server.log, whose end is
    written to stderr if the phase fails).  Wave
    3's shape as concurrent requests (half streamed), a cold load and then
    a warm one, each with client-side TTFT, TPOT and decode tokens/s;
    ``/metrics`` against what was served (and scraped every 50 ms during
    the loads), then ``/admin/drain``, readiness 503, and SIGTERM: the
    process must exit 0 within the drain time."""
    import signal
    import threading
    import numpy as np
    from llm_d_tpu_torch.utils.lifecycle import DRAINING_HEADER
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    log_path = os.path.join(root, "build", "server.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    cmd = [sys.executable, "-m", "llm_d_tpu_torch.server.openai",
           *SERVER_FLAGS, "--host", "127.0.0.1", "--port", str(port)]
    env = dict(os.environ, LLMD_DRAIN_TIMEOUT_S=str(DRAIN_S))
    t0 = time.perf_counter()
    with open(log_path, "wb") as log_f:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=log_f,
                                stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"the server exited with {proc.returncode}"
                                   f" before it was ready")
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("the server was not ready in 300 s")
            try:
                if http_call(url, "/v1/models", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        startup_s = time.perf_counter() - t0
        rng = np.random.default_rng(5)
        n, new = WAVE3["n"], WAVE3["new"]
        peak = dict(running=0.0, waiting=0.0, kv_usage=0.0)
        stop = threading.Event()

        def watch():
            while not stop.wait(0.05):
                m = scrape(url)
                peak["running"] = max(peak["running"],
                                      m["vllm:num_requests_running"])
                peak["waiting"] = max(peak["waiting"],
                                      m["vllm:num_requests_waiting"])
                peak["kv_usage"] = max(peak["kv_usage"],
                                       m["vllm:kv_cache_usage_perc"])

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        loads = {}
        try:
            # The cold load meets the process's first prefill step and
            # captures the decode graph; the warm one is the steady state.
            for name in ("cold", "warm"):
                bodies = [greedy_body(
                    rng.integers(1, vocab, WAVE3["prompt"]).tolist(), new,
                    i % 2 == 0) for i in range(n)]
                loads[name] = load_stats(concurrently(url, bodies), new,
                                         vocab)
        finally:
            stop.set()
            watcher.join(30)
        n *= len(loads)
        m = scrape(url)
        model = SERVER_FLAGS[SERVER_FLAGS.index("--model") + 1]
        lab = f'{{model_name="{model}"}}'
        counts = dict(
            generation_tokens=m["vllm:generation_tokens_total" + lab],
            request_success=m['vllm:request_success_total{finished_reason='
                              f'"length",model_name="{model}"}}'],
            ttft_count=m["vllm:time_to_first_token_seconds_count" + lab],
            itl_count=m["vllm:inter_token_latency_seconds_count" + lab],
            running=m["vllm:num_requests_running" + lab],
            waiting=m["vllm:num_requests_waiting" + lab],
            kv_usage=m["vllm:kv_cache_usage_perc" + lab])
        want = dict(generation_tokens=n * new, request_success=n,
                    ttft_count=n, running=0, waiting=0, kv_usage=0)
        wrong = {k: (counts[k], v) for k, v in want.items()
                 if counts[k] != v}
        if wrong or not n <= counts["itl_count"] <= n * (new - 1):
            raise RuntimeError(f"/metrics disagrees with what was served "
                               f"(got, want): {wrong}, itl_count "
                               f"{counts['itl_count']}")
        if not (0 < peak["running"] <= n and peak["kv_usage"] > 0):
            raise RuntimeError(f"load gauges during the load: {peak}")
        status, _, reply = http_call(url, "/admin/drain", {})
        if status != 200 or reply.get("status") != "draining":
            raise RuntimeError(f"/admin/drain: HTTP {status}: {reply}")
        status, headers, _ = http_call(url, "/v1/models")
        if status != 503 or headers.get(DRAINING_HEADER) != "1":
            raise RuntimeError(f"/v1/models while draining: HTTP {status}")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=DRAIN_S + 60)
        exit_s = time.perf_counter() - t_term
        if rc != 0 or exit_s > DRAIN_S:
            raise RuntimeError(f"after SIGTERM the server exited with {rc} "
                               f"in {exit_s:.1f} s")
    except BaseException:
        with open(log_path, "rb") as log_f:
            sys.stderr.write(log_f.read()[-8000:].decode(errors="replace"))
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    return dict(startup_s=startup_s, requests=n, new_tokens=new, **loads,
                metrics=counts, load_peak=peak, drain_exit_code=rc,
                exit_s=exit_s)


def load_stats(res, new: int, vocab: int) -> dict:
    """Client-side figures of one concurrent load (``completion`` results,
    ``new`` tokens each): TTFT and TPOT of the streamed requests, and
    decode tokens/s from the last first token to the last reply."""
    for i, r in enumerate(res):
        if r["finish"] != "length" or r["n"] != new or not all(
                0 <= t < vocab for t in r["tokens"] or ()):
            raise RuntimeError(f"request {i}: {r['n']} tokens, finish "
                               f"{r['finish']}")
    streamed = [r for r in res if r["t_first"] is not None]
    t_decode = (max(r["t_end"] for r in res)
                - max(r["t_first"] for r in streamed))
    return dict(
        streamed=len(streamed),
        ttft_s=spread([r["t_first"] - r["t_send"] for r in streamed]),
        tpot_s=spread([(r["t_last"] - r["t_first"]) / (new - 1)
                       for r in streamed]),
        decode_tok_s=len(res) * (new - 1) / t_decode,
        decode_seconds=t_decode)


@contextlib.contextmanager
def env_set(name: str, value: str):
    """Sets environment variable ``name`` inside the block."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[name]
        else:
            os.environ[name] = prev


@contextlib.contextmanager
def bench_glue_recorder(moe_ops):
    """Keeps (in the dict it yields, under "args") the glue inputs of the
    first ``BENCH_T``-token streamed MoE call inside the block."""
    got = {}
    real = moe_ops._streamed_int8_kernel_path

    def glue(x, weights_, idx, quant, **kw):
        if x.shape[0] == BENCH_T and not got:
            got["args"] = (x.clone(), weights_.clone(), idx.clone(), quant)
        return real(x, weights_, idx, quant, **kw)

    moe_ops._streamed_int8_kernel_path = glue
    try:
        yield got
    finally:
        moe_ops._streamed_int8_kernel_path = real


def bench_step_as_one_chunk(moe_ops, moe_routed_stream, glue_args):
    """Kernel E's inputs for the recorded 8192-token MoE step laid out as
    one chunk of ``BENCH_T`` rows."""
    with capture(moe_routed_stream, "streamed_moe_int8") as seen:
        moe_ops._streamed_int8_kernel_path(*glue_args, chunk_t=BENCH_T)
    return seen[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import dataclasses
    import numpy as np
    from llm_d_tpu_torch.models.config import get_config
    from llm_d_tpu_torch.ops import _build, flash_prefill, mla_decode, \
        mla_prefill, moe_int8, moe_routed, moe_routed_stream, \
        paged_attention
    from llm_d_tpu_torch.ops import moe as moe_ops

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} libraries in {build_s:.1f} s")
    for src, lib in libs.items():
        # ptxas -v: registers, shared memory and spills of every kernel.
        report = lib.with_suffix(".log").read_text(errors="replace")
        usage = [ln.split(":", 1)[1].strip() for ln in report.splitlines()
                 if "Used" in ln and "registers" in ln]
        spills = [ln.strip() for ln in report.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        log(f"ptxas {src}: {len(usage)} kernels, max "
            f"{max((int(u.split()[1]) for u in usage), default=0)} "
            f"registers, spills: {spills or 'none'}")

    pallas = "llm_d_tpu/ops/pallas/"
    kernels = [
        dict(name="mla_decode", mod=mla_decode, fn="mla_paged_decode_update",
             plain="mla_paged_decode_update_plain", path="i",
             label=lambda a, kw: f"S={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/mla_decode.cu",
             replaces=pallas + "mla_attention.py:224"),
        dict(name="mla_prefill", mod=mla_prefill, fn="mla_flash_prefill",
             plain="mla_flash_prefill_plain", path="i",
             label=lambda a, kw: f"S={a[0].shape[0]} Q={a[0].shape[1]}",
             source="llm_d_tpu_torch/csrc/mla_prefill.cu",
             replaces=pallas + "mla_prefill.py:165"),
        dict(name="moe_dense_int8", mod=moe_int8, fn="dense_moe_int8",
             plain="dense_moe_int8_plain", path="i",
             label=lambda a, kw: f"T={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/moe_dense_int8.cu",
             replaces=pallas + "moe_int8.py:182"),
        dict(name="moe_routed_int8", mod=moe_routed, fn="routed_moe_int8",
             plain="routed_moe_int8_plain", path="i",
             label=lambda a, kw: f"T={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/moe_streamed_int8.cu",
             replaces=pallas + "moe_routed.py:183"),
        dict(name="moe_streamed_int8", mod=moe_routed_stream,
             fn="streamed_moe_int8", plain="streamed_moe_int8_plain",
             path="i", label=lambda a, kw: f"T={a[0].shape[0]}",
             source="llm_d_tpu_torch/csrc/moe_streamed_int8.cu",
             replaces=pallas + "moe_routed_stream.py:124"),
        dict(name="moe_grouped_int8", mod=moe_int8, fn="grouped_moe_int8",
             plain="grouped_moe_int8_plain", path="i",
             source="llm_d_tpu_torch/csrc/moe_streamed_int8.cu",
             replaces=pallas + "moe_int8.py:78"),
        dict(name="paged_decode", mod=paged_attention,
             fn="paged_attention_decode_update",
             plain="paged_attention_decode_update_plain", path="ii",
             label=cache_mode, source="llm_d_tpu_torch/csrc/paged_decode.cu",
             replaces=pallas + "paged_attention.py:282"),
        dict(name="flash_prefill", mod=flash_prefill,
             fn="flash_prefill_paged", plain="flash_prefill_paged_plain",
             path="ii", label=cache_mode,
             source="llm_d_tpu_torch/csrc/flash_prefill.cu",
             replaces=pallas + "flash_prefill.py:188"),
    ]

    # 2. path (i): deepseek-v3-bench as bench.py serves it ------------------
    t0 = time.perf_counter()
    engine = path_i_engine()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # The classic loop (one step per dispatch) on the same weights: the
    # yardstick of the rounds below, not the path.
    classic = path_i_engine(1, engine.params)
    log(f"engine: init {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{engine.config.num_blocks} blocks")
    weights = tensor_ptrs(engine.params)
    recorders = {k["name"]: Recorder(k["mod"], k["fn"], weights,
                                     k.get("label"))
                 for k in kernels}
    def reset_counts():
        for rec in recorders.values():
            rec.wrapped.launches = 0

    def read_counts(path, replayed):
        """Each kernel's launches on ``path``: its wrapper's count (eager
        launches, graph warm-ups included) plus its launches inside graph
        replays (``replayed``: the ``DecodeGraphs.launches`` of the path's
        multistep engines, by wrapper name)."""
        in_graphs = {k["name"]: sum(r[k["fn"]] for r in replayed)
                     for k in kernels if k["path"] == path}
        counts = {n: recorders[n].wrapped.launches + c
                  for n, c in in_graphs.items()}
        missing = [n for n, c in counts.items() if c == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on path ({path}): "
                               f"{missing}")
        return counts, in_graphs

    rng = np.random.default_rng(0)
    vocab = engine.model_config.vocab_size
    p1 = prompts_for(rng, vocab, WAVE1)
    p2 = prompts_for(rng, vocab, WAVE2)
    p3 = prompts_for(rng, vocab, WAVE3)
    waves_i = {}
    reset_counts()
    # The glue inputs of the bench's 8192-token step, to run kernel E on
    # it as one chunk in phase 4.
    with bench_glue_recorder(moe_ops) as bench_glue:
        tok1, waves_i["wave1"] = run_wave(engine, p1, WAVE1["new"], "w1")
        log(f"wave 1: {json.dumps(waves_i['wave1'])}")
        _, waves_i["wave2"] = run_wave(engine, p2, WAVE2["new"], "w2")
        log(f"wave 2: {json.dumps(waves_i['wave2'])}")
        tok3, waves_i["wave3"] = run_wave(engine, p3, WAVE3["new"], "w3")
        log(f"wave 3: {json.dumps(waves_i['wave3'])}")
        tok1b, waves_i["wave1_repeat"] = run_wave(engine, p1, WAVE1["new"],
                                                  "w1b")
        log(f"wave 1 again: {json.dumps(waves_i['wave1_repeat'])}")
        with env_set("LLMD_MOE_PREFILL_KERNEL", "grouped"):
            tok3g, waves_i["wave3_grouped"] = run_wave(engine, p3, WAVE3["new"],
                                                       "w3g")
        waves_i["wave3_grouped"]["same_tokens_as_streamed"] = tok3g == tok3
        log(f"wave 3 grouped: {json.dumps(waves_i['wave3_grouped'])}")
    launches, graph_launches = read_counts(
        "i", [dict(engine._graphs.launches)])
    log(f"launches (i): {json.dumps(launches)}, inside graph replays: "
        f"{json.dumps(graph_launches)}")
    for w, st in waves_i.items():
        check_multistep(st, w)
    if tok1b != tok1:
        raise RuntimeError("wave 1 did not repeat token for token")
    if not bench_glue:
        raise RuntimeError(f"no {BENCH_T}-token MoE step was recorded")
    for name in ("mla_decode", "moe_dense_int8", "moe_routed_int8"):
        if graph_launches[name] == 0:
            raise RuntimeError(f"{name} never launched inside a graph")

    # Graph replays against the eager body; the multistep engine against
    # the classic loop.
    sampled_block(engine, vocab)
    graphs_i = [graph_equals_eager(engine, key)
                for key in ((8, False), (WAVE2_S, False), (8, True))]
    log(f"graph vs eager: {json.dumps(graphs_i)}")
    rounds_i = classic_rounds(classic, engine, {
        "wave1": (WAVE1, p1), "wave2": (WAVE2, p2), "wave3": (WAVE3, p3)},
        ROUNDS)
    log(f"classic vs multistep: {json.dumps(rounds_i)}")
    graphs_info = dict(
        pool_bytes=engine._graphs.pool_bytes,
        graphs=[dict(S=k[0], random_rows=k[1], launches=g.launches)
                for k, g in engine._graphs.graphs.items()],
        replays=engine._graphs.replays)
    log(f"graphs (i): {json.dumps(graphs_info)}")

    prof = None
    if "--profile" in sys.argv[1:]:
        prof = profile_waves(classic, p1, p2, p3)
        prof["blocks"] = profile_blocks(engine, {"wave1": p1, "wave2": p2})
        log(f"profile: {json.dumps(prof)}")
    del classic
    gc.collect()
    torch.cuda.empty_cache()

    # 3. path (ii): llama3-1b on a bf16 and on int8 caches ------------------
    waves_ii = {}
    graphs_ii = []
    llama_params2 = None
    reset_counts()
    for kv, gran in DENSE_MODES:
        tag = kv if gran is None else f"{kv}-{gran}"
        t0 = time.perf_counter()
        eng = path_ii_engine(kv, gran)
        torch.cuda.synchronize()
        log(f"llama3-1b {tag}: init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        pd = dense_prompts(eng.model_config.vocab_size)
        tokd, waves_ii[tag] = run_wave(eng, pd, DENSE_WAVE["new"], tag)
        log(f"llama3-1b {tag} wave: {json.dumps(waves_ii[tag])}")
        if kv == "bf16":
            tokd2, waves_ii["bf16_repeat"] = run_wave(
                eng, pd, DENSE_WAVE["new"], "bf16b")
            log(f"llama3-1b bf16 wave again: "
                f"{json.dumps(waves_ii['bf16_repeat'])}")
            if tokd2 != tokd:
                raise RuntimeError("llama3-1b bf16 wave did not repeat "
                                   "token for token")
            # The same wave through multistep blocks (as bench.py would
            # serve it), on the same weights, twice: the classic run's
            # tokens.
            ms = path_ii_engine(kv, gran, BENCH_K, eng.params)
            tokm, waves_ii["bf16_multistep"] = run_wave(
                ms, pd, DENSE_WAVE["new"], "bf16m")
            waves_ii["bf16_multistep"]["same_tokens_as_classic"] = \
                tokm == tokd
            log(f"llama3-1b bf16 multistep wave: "
                f"{json.dumps(waves_ii['bf16_multistep'])}")
            # Again, with the graph captured: the steady state.
            tokm2, waves_ii["bf16_multistep_repeat"] = run_wave(
                ms, pd, DENSE_WAVE["new"], "bf16m2")
            log(f"llama3-1b bf16 multistep wave again: "
                f"{json.dumps(waves_ii['bf16_multistep_repeat'])}")
            for w in ("bf16_multistep", "bf16_multistep_repeat"):
                check_multistep(waves_ii[w], f"llama3-1b {w}")
            if tokm != tokd or tokm2 != tokd:
                raise RuntimeError("llama3-1b bf16 multistep tokens differ "
                                   "from the classic loop's")
            graphs_ii.append(dict(ms._graphs.launches))
            graphs_info["llama3-1b"] = dict(
                pool_bytes=ms._graphs.pool_bytes,
                graphs=[dict(S=k[0], random_rows=k[1], launches=g.launches)
                        for k, g in ms._graphs.graphs.items()])
            del ms
            if prof is not None:
                # The profiled steps are not the path's run: their launches
                # do not count.
                held = {n: r.wrapped.launches for n, r in recorders.items()}
                prof["llama3-1b"] = profile_dense(eng, pd)
                log(f"profile llama3-1b: {json.dumps(prof['llama3-1b'])}")
                for n, r in recorders.items():
                    r.wrapped.launches = held[n]
            # The first two layers, for phase 5 (copies: a slice would
            # keep every layer alive).
            llama_params2 = {
                k: ({kk: vv[:2].clone() for kk, vv in v.items()}
                    if k == "layers" else v)
                for k, v in eng.params.items()}
        del eng                       # free each engine before the next
        gc.collect()
        torch.cuda.empty_cache()
    counts_ii, graph_ii = read_counts("ii", graphs_ii)
    launches.update(counts_ii)
    graph_launches.update(graph_ii)
    log(f"launches (ii): {json.dumps(counts_ii)}, inside graph replays: "
        f"{json.dumps(graph_ii)}")
    if graph_launches["paged_decode"] == 0:
        raise RuntimeError("paged_decode never launched inside a graph")

    # 4. kernels against their plain versions --------------------------------
    rows, variants, bounds = [], [], []

    def check(k, label, args, kw, count: bool, library: bool = False):
        fn, plain = recorders[k["name"]].fn, getattr(k["mod"], k["plain"])
        a_k, kw_k = clone(args, weights), clone(kw, weights)
        a_p, kw_p = clone(args, weights), clone(kw, weights)
        got = fn(*a_k, **kw_k)
        want = plain(*a_p, **kw_p)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        name = f"{k['name']} [{label}]"
        if k["name"] in ("mla_decode", "mla_prefill", "paged_decode",
                         "flash_prefill"):
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=2e-2, rtol=2e-2)
            # The in-place splices: cache and scale planes exactly.
            spliced = {"mla_decode": ([2], ["kv_scale"]),
                       "paged_decode": ([3, 4], ["k_scale", "v_scale"])}
            pos, names = spliced.get(k["name"], ([], []))
            for i in pos:
                if not torch.equal(a_k[i], a_p[i]):
                    raise RuntimeError(f"{name}: cache planes differ")
            for n in names:
                if kw_k.get(n) is not None and \
                        not torch.equal(kw_k[n], kw_p[n]):
                    raise RuntimeError(f"{name}: {n} planes differ")
        else:
            scale = float(want.abs().max()) + 1e-9
            if err / scale > 1e-2:
                raise RuntimeError(f"{name}: error {err} / scale "
                                   f"{scale} > 1e-2")
        ms = time_ms(lambda: fn(*a_k, **kw_k), iters=20)
        dev_ms, _ = device_ms(lambda: fn(*a_k, **kw_k))
        plain_ms = time_ms(lambda: plain(*a_p, **kw_p), iters=3, warmup=1)
        nbytes, flops = work(k["name"], args, kw, got)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        row = dict(
            name=k["name"], route="cuda", source=k["source"],
            replaces=k["replaces"], launches=launches[k["name"]],
            graph_launches=graph_launches[k["name"]],
            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        if (count or library) and k["name"] in ("paged_decode",
                                                "flash_prefill") \
                and kw.get("k_scale") is None:
            row["library_ms"] = sdpa_ms(k["name"], a_k, kw_k)
        if count:
            rows.append(row)
        else:
            variants.append(dict(row, variant=label))
        bounds.append(dict(name=k["name"], variant=label,
                           shape=shape_of(args), bytes=nbytes, flops=flops,
                           bytes_ms=t_bytes, ops_ms=t_ops))
        log(f"{name}: err {err:.3g}, {ms:.4f} ms ({dev_ms:.4f} on the "
            f"device) vs plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms, library {row['library_ms']}")

    for k in kernels:
        calls = recorders[k["name"]].calls
        if not calls:
            raise RuntimeError(f"{k['name']}: no recorded launch")
        for i, (label, (args, kw)) in enumerate(calls.items()):
            check(k, label, args, kw, count=i == 0)
    # Kernel A at long context: 8 sequences x 4096 keys.
    decode = next(k for k in kernels if k["name"] == "mla_decode")
    first = next(iter(recorders["mla_decode"].calls.values()))
    check(decode, "S=8 keys=4096",
          *long_decode_inputs(*first, S=8, keys=4096, seed=11), count=False)
    # Kernel G at long context: 8 sequences x 4096 keys, split over blocks.
    dense_decode = next(k for k in kernels if k["name"] == "paged_decode")
    first = next(iter(recorders["paged_decode"].calls.values()))
    check(dense_decode, "S=8 keys=4096",
          *long_dense_decode_inputs(*first, S=8, keys=4096, seed=12),
          count=False)
    # Kernel E on the bench's 8192-token step as one chunk (the default
    # chunks are its recorded T=8192 launch).
    streamed = next(k for k in kernels if k["name"] == "moe_streamed_int8")
    args, kw = bench_step_as_one_chunk(moe_ops, moe_routed_stream,
                                       bench_glue["args"])
    check(streamed, f"T={BENCH_T} chunk_t={BENCH_T}", clone(args, weights),
          clone(kw, weights), count=False)
    # Kernels C-F at other shapes, on the engine's first MoE layer with
    # routing from a seed: C at T = 8 (a decode block of 8 rows), D at T =
    # 256 and 512 (64-row blocks; the waves' T = 128 runs 32-row ones), F
    # at 128-row tiles (the waves' grouped step runs 256-row ones).
    quant = {n: engine.params["moe_layers"][n] for n in
             ("w_gate_q", "w_gate_s", "w_up_q", "w_up_s", "w_down_q",
              "w_down_s")}
    quant["layer"] = 0
    for name, glue, T, kwg in (
            ("moe_dense_int8", moe_ops._dense_int8_kernel_path, 8, {}),
            ("moe_routed_int8", moe_ops._routed_int8_kernel_path, 256, {}),
            ("moe_routed_int8", moe_ops._routed_int8_kernel_path, 512, {}),
            ("moe_grouped_int8", moe_ops._grouped_int8_kernel_path, 1024,
             dict(row_tile=128))):
        k = next(kk for kk in kernels if kk["name"] == name)
        x, w, idx = moe_inputs(engine.model_config, T, seed=T)
        with capture(k["mod"], k["fn"]) as seen:
            glue(x, w, idx, quant, **kwg)
        check(k, f"T={T}" + (" rt=128" if kwg else ""),
              *clone(seen[0], weights), count=False)
    for rec in recorders.values():
        setattr(rec.module, rec.name, rec.fn)

    # 5. reference checks ----------------------------------------------------
    mc = dataclasses.replace(engine.model_config, num_layers=2,
                             max_model_len=1152)
    Lm = mc.num_layers - mc.first_dense_layers
    params = dict(engine.params)
    params["moe_layers"] = {k: v[:Lm] for k, v in
                            engine.params["moe_layers"].items()}
    moe_kw = dict(quantization="int8", kv_cache_dtype="int8", block_size=64,
                  num_blocks=24, max_num_seqs=8,
                  max_num_batched_tokens=1024, enable_prefix_caching=False)
    refs = [reference_check(mc, params, moe_kw, lens, seed)
            for lens, seed in (([100], 7), ([1024], 8))]
    lc = dataclasses.replace(get_config("llama3-1b"), num_layers=2,
                             max_model_len=1152)
    dense_kw = dict(block_size=64, num_blocks=24, max_num_seqs=8,
                    max_num_batched_tokens=1024, enable_prefix_caching=False)
    refs.append(reference_check(lc, llama_params2, dense_kw, [100, 37], 9))
    for ref in refs:
        log(f"reference: {json.dumps(ref)}")
        if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
            raise RuntimeError(f"kernel path disagrees with the CPU "
                               f"reference: {ref}")

    # 6. parity repairs ------------------------------------------------------
    parity = dict(decode_pages=[], engines=[])
    for quantized, bs in ((False, 128), (True, 256)):
        label = f"{'int8' if quantized else 'bf16'} bs={bs}"
        kt = mla_decode.decode_key_tile(640, bs, 1, quantized)
        if not 0 < kt < bs:
            raise RuntimeError(f"{label}: key tile {kt}")
        a_args, a_kw = decode_inputs(quantized, bs, [5, kt, bs, 2 * bs + 3,
                                                     9 * bs + 1, 0, 1, 0],
                                     seed=bs)
        check(decode, f"{label} kt={kt}", a_args, a_kw, count=False)
        parity["decode_pages"].append(dict(label=label, key_tile=kt))
        ref = large_page_reference(
            mc, params, quantized, bs,
            [(mla_decode, "mla_paged_decode_update"),
             (mla_prefill, "mla_flash_prefill")])
        log(f"reference: {json.dumps(ref)}")
        if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
            raise RuntimeError(f"kernel path disagrees with the CPU "
                               f"reference: {ref}")
        parity["engines"].append(ref)
    dense_prefill = next(k for k in kernels if k["name"] == "flash_prefill")
    parity["dense_pages"] = []
    for sw in (0, 8):
        label = f"{'int8-head' if sw else 'bf16'} bs=256 D=128"
        check(dense_decode, label,
              *dense_decode_inputs(sw, 256, [5, 256, 300, 769, 1, 0],
                                   seed=20 + sw, D=128, scale=0.09),
              count=False, library=True)
        check(dense_prefill, label,
              *dense_prefill_inputs(sw, 256, [300, 256, 600, 0],
                                    [300, 44, 72, 0], seed=30 + sw),
              count=False, library=True)
        parity["dense_pages"].append(label)
    parity["llama3-8b"] = dense_large_page_reference(
        [(paged_attention, "paged_attention_decode_update"),
         (flash_prefill, "flash_prefill_paged")])
    log(f"reference: {json.dumps(parity['llama3-8b'])}")
    parity["tiny"] = tiny_on_the_card()
    log(f"parity: tiny {json.dumps(parity['tiny'])}")
    parity["soft_cap"] = soft_cap_through_chunked()
    log(f"parity: soft cap {json.dumps(parity['soft_cap'])}")
    parity["noise"] = noise_on_the_card()
    log(f"parity: noise {json.dumps(parity['noise'])}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    # 7. the server ----------------------------------------------------------
    # (a) In process, over path (i)'s engine: the direct engine's tokens
    # for each wave-1 prompt alone first (not the server's run), then the
    # server's run, its launches counted from 0.
    alone = [run_wave(engine, [p], WAVE1["new"], f"alone{i}")[0][0]
             for i, p in enumerate(p1)]
    for k in kernels:
        getattr(k["mod"], k["fn"]).launches = 0
    replayed0 = dict(engine._graphs.launches)
    server = {"card": smi}
    server["in_process"] = server_in_process(engine, p1, WAVE1["new"],
                                             alone, tok1)
    in_graphs = {k["name"]: engine._graphs.launches[k["fn"]]
                 - replayed0[k["fn"]] for k in kernels}
    server_counts = {k["name"]: getattr(k["mod"], k["fn"]).launches
                     + in_graphs[k["name"]] for k in kernels}
    log(f"server (in process): {json.dumps(server['in_process'])}, "
        f"launches {json.dumps(server_counts)}, inside graph replays "
        f"{json.dumps(in_graphs)}")
    missing = [n for n in ("mla_decode", "mla_prefill", "moe_dense_int8",
                           "moe_routed_int8", "moe_streamed_int8")
               if server_counts[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched by the server: {missing}")
    for row in rows:
        row["server_launches"] = server_counts[row["name"]]
        row["launches"] += server_counts[row["name"]]
        row["graph_launches"] += in_graphs[row["name"]]
    # (b) The entry point as a subprocess, with this process's engines and
    # recorded inputs freed first.
    del engine, params, quant, recorders, rec, bench_glue, llama_params2, \
        decode, dense_decode, dense_prefill, streamed, first, args, kw, \
        x, w, idx, seen
    gc.collect()
    torch.cuda.empty_cache()
    log(f"server: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated in this process")
    server["entry_point"] = server_subprocess(root, vocab)
    # The direct engine's steady wave 3 in the same call (the rounds).
    server["direct_engine_wave3_decode_tok_s"] = \
        rounds_i["wave3"]["multistep"]["decode_tok_s"]
    log(f"server (entry point): {json.dumps(server['entry_point'])}")
    # The bound's inputs, derived from the recorded launches (not timed).
    print(json.dumps({"bounds": bounds}))
    print(json.dumps({"variants": variants}))
    print(json.dumps({"engine": {
        "build_s": build_s, "init_s": init_s,
        "deepseek-v3-bench": waves_i, "llama3-1b": waves_ii,
        "classic_vs_multistep": rounds_i, "graph_vs_eager": graphs_i,
        "graphs": graphs_info, "reference": refs}}))
    if prof is not None:
        print(json.dumps({"profile": prof}))
    print(json.dumps({"server": server}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def shape_of(args):
    return [list(a.shape) for a in args if hasattr(a, "shape")][:2]


def _kv_row_bytes(cache, scale) -> int:
    """One cache row with its scales."""
    return cache.shape[-1] * cache.element_size() + (
        scale.shape[-1] * 4 if scale is not None else 0)


def _expert_bytes(E: int, H: int, I: int, experts: int) -> int:
    """int8 weights and f32 scales of ``experts`` experts."""
    return experts * (3 * H * I + (2 * I + H) * 4)


def work(name: str, args, kw, out):
    """(bytes moved, flops) the function needs on these inputs: each input
    it uses read once, each output written once.  Data-dependent parts
    count what this run's data needs: live query rows, the keys and
    block-table entries below each causal bound, the experts with a
    routed token (each expert's weights once per launch) and the routed
    (token, expert) pairs."""
    import torch
    if name in ("mla_decode", "mla_prefill"):
        q, _, cache, _, sl = args[:5]
        bs = kw["block_size"]
        row_b = _kv_row_bytes(cache, kw.get("kv_scale"))
        H, F = q.shape[-2], cache.shape[-1]
        q_row_b = H * F * q.element_size()
    if name == "mla_decode":
        S = q.shape[0]
        sl = sl.long().clamp(min=0)
        keys = int(sl.sum())
        live = int((sl > 0).sum())
        pages = int(((sl + bs - 1) // bs).sum())
        # Position seq_len-1 comes from the new row, not from the cache.
        nbytes = (live * q_row_b + live * row_b + S * 4 + pages * 4
                  + (keys - live) * row_b
                  + out.numel() * out.element_size() + live * row_b)
        return nbytes, 4 * H * F * keys
    if name == "mla_prefill":
        q_pos = args[1]
        S = q.shape[0]
        n_keys = torch.minimum(sl.long()[:, None],
                               q_pos.long() + 1).clamp(min=0)     # [S, Q]
        live_rows = int((n_keys > 0).sum())
        seq_keys = n_keys.max(dim=1).values
        pages = int(((seq_keys + bs - 1) // bs).sum())
        nbytes = (live_rows * q_row_b + q_pos.numel() * 4 + S * 4
                  + pages * 4 + int(seq_keys.sum()) * row_b
                  + out.numel() * out.element_size())
        return nbytes, 4 * H * F * int(n_keys.sum())
    if name == "moe_dense_int8":
        x, comb = args[:2]
        _, E, H, I = args[3].shape
        routed = comb != 0                                         # [T, E]
        experts = int(routed.any(dim=0).sum())
        pairs = int(routed.sum())
        nbytes = (x.numel() * x.element_size() + comb.numel() * 4
                  + _expert_bytes(E, H, I, experts) + out.numel() * 4)
        return nbytes, 2 * 3 * pairs * H * I
    if name == "moe_routed_int8":
        x, tok_pad, wslot, tile_expert, num_tiles, pos = args[:6]
        _, E, H, I = args[7].shape
        T, k = pos.shape
        nt = int(num_tiles.reshape(-1)[0])
        slots = nt * kw["row_tile"]
        experts = int(torch.unique(tile_expert[:nt]).numel())
        nbytes = (T * H * x.element_size() + slots * (tok_pad.element_size()
                  + wslot.element_size()) + nt * 4 + 4 + pos.numel() * 4
                  + _expert_bytes(E, H, I, experts) + out.numel() * 4)
        return nbytes, 2 * 3 * T * k * H * I
    if name == "moe_streamed_int8":
        x, tok_pad, wslot, tile_expert, num_tiles, pos = args[:6]
        _, E, H, I = args[7].shape
        Tp, k = pos.shape
        C, NT = num_tiles.numel(), tile_expert.numel()
        tiles = torch.arange(NT, device=tile_expert.device)
        live = (tiles % (NT // C)) < num_tiles.long()[tiles // (NT // C)]
        n_live = int(live.sum())
        experts = int(torch.unique(tile_expert[live]).numel())
        nbytes = (Tp * H * x.element_size() + n_live * kw["row_tile"] * 8
                  + n_live * 4 + C * 4 + pos.numel() * 4
                  + _expert_bytes(E, H, I, experts) + out.numel() * 4)
        return nbytes, 2 * 3 * Tp * k * H * I
    if name == "moe_grouped_int8":
        x_pad, wslot, tile_expert, num_tiles = args[:4]
        _, E, H, I = args[5].shape
        nt = int(num_tiles.reshape(-1)[0])
        routed = int((wslot != 0).sum())
        experts = int(torch.unique(tile_expert[:nt]).numel())
        # The whole padded output is written (zeros past the live tiles).
        nbytes = (routed * (H * x_pad.element_size() + 4) + nt * 4 + 4
                  + _expert_bytes(E, H, I, experts)
                  + out.numel() * out.element_size())
        return nbytes, 2 * 3 * routed * H * I
    if name == "paged_decode":
        q, k_new, v_new, kc, vc, bt, sl = args[:7]
        bs = kw["block_size"]
        S, H, D = q.shape
        row_b = _kv_row_bytes(kc, kw.get("k_scale"))
        sl = sl.long().clamp(min=0)
        keys = int(sl.sum())
        live = int((sl > 0).sum())
        pages = int(((sl + bs - 1) // bs).sum())
        # K and V: the cached keys below the new position, the new rows
        # read from the input and written to their slots.
        nbytes = (live * H * D * q.element_size() + S * 4 + pages * 4
                  + 2 * (keys - live) * row_b + 2 * 2 * live * row_b
                  + out.numel() * out.element_size())
        return nbytes, 4 * H * D * keys
    if name == "flash_prefill":
        qs, q_pos, kc, vc, bt, sl = args[:6]
        bs = kw["block_size"]
        S, Q, H, D = qs.shape
        row_b = _kv_row_bytes(kc, kw.get("k_scale"))
        n_keys = torch.minimum(sl.long()[:, None],
                               q_pos.long() + 1).clamp(min=0)     # [S, Q]
        live_rows = int((n_keys > 0).sum())
        seq_keys = n_keys.max(dim=1).values
        pages = int(((seq_keys + bs - 1) // bs).sum())
        nbytes = (live_rows * H * D * qs.element_size() + q_pos.numel() * 4
                  + S * 4 + pages * 4 + 2 * int(seq_keys.sum()) * row_b
                  + out.numel() * out.element_size())
        return nbytes, 4 * H * D * int(n_keys.sum())
    raise KeyError(name)


if __name__ == "__main__":
    sys.exit(main())
