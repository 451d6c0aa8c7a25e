#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``llm_d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. build    compile the four CUDA kernels from llm_d_tpu_torch/csrc
            (one nvcc per source, in parallel) and load them;
2. engine   serve deepseek-v3-bench at full width and depth (random
            weights from a seed) through EngineCore with int8 experts, an
            int8 latent cache, block size 64 and 512-token steps:
            wave 1 (8 x 128-token prompts, 32 new tokens), wave 2
            (96 x 32-token prompts, 16 new tokens), then wave 1 again,
            which must repeat token for token.  Every kernel's launch
            count must rise during these waves;
3. kernels  each kernel against its plain PyTorch version on the inputs
            of its first launch in phase 2, then timed against it;
4. check    logits of the first two layers at full width through the
            kernels against the CPU reference path with the same weights.

Output: a ``{"bounds": [...]}`` line (the bytes and flops each kernel's
bound is derived from), a ``{"kernels": [...]}`` line (measured launches,
errors and times, with ``bound_ms``), an ``{"engine": ...}`` line, the
card's name and power limit, and last ``{"ok": true, "device": ...}``.

    python3 chip_smoke.py --profile

adds a ``{"profile": ...}`` line: four wave-1 decode steps under
``torch.profiler``, with the device's busy time, kernel launches and the
largest kernels per step (a measurement, not part of the smoke's
pass/fail contract).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak

WAVE1 = dict(n=8, prompt=128, new=32)
WAVE2 = dict(n=96, prompt=32, new=16)


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


class Recorder:
    """Wraps a kernel wrapper (a module attribute the model calls through)
    and keeps a copy of the inputs of its first call, taken before the
    call so in-place cache updates do not leak into the copy.  A wrapper
    bumps the ``launches`` of whatever its module name is bound to, so
    the count lives on the recording wrapper while it is installed."""

    def __init__(self, module, name: str, keep: frozenset):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.keep = keep
        self.first = None

        def wrapped(*args, **kw):
            if self.first is None:
                self.first = (clone(args, keep), clone(kw, keep))
            return self.fn(*args, **kw)

        wrapped.launches = 0
        self.wrapped = wrapped
        setattr(module, name, wrapped)


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


def run_wave(engine, prompts, max_new: int, tag: str):
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    import torch
    reqs = [Request(f"{tag}-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=max_new, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    decode_s = 0.0
    decode_tokens = 0
    decode_steps = 0
    steps = 0
    t0 = time.perf_counter()
    while engine.has_work():
        all_prefilled = all(r.output_token_ids for r in reqs)
        ts = time.perf_counter()
        outs = engine.step()
        dt = time.perf_counter() - ts
        steps += 1
        if all_prefilled:
            decode_s += dt
            decode_steps += 1
            decode_tokens += sum(len(o.new_token_ids) for o in outs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    tokens = [list(r.output_token_ids) for r in reqs]
    vocab = engine.model_config.vocab_size
    for r, toks in zip(reqs, tokens):
        if len(toks) != max_new or not all(0 <= t < vocab for t in toks):
            raise RuntimeError(f"{r.request_id}: got {len(toks)} tokens "
                               f"(want {max_new} in [0, {vocab}))")
    return tokens, dict(steps=steps, seconds=total_s,
                        decode_steps=decode_steps, decode_seconds=decode_s,
                        decode_tokens=decode_tokens,
                        decode_tok_s=(decode_tokens / decode_s
                                      if decode_s else None))


def reference_check(engine) -> dict:
    """The first two layers (the dense one and one MoE layer) at full
    width, through the kernels and through the CPU reference path with
    the same weights: a 100-token prefill (kernels B and D) and one decode
    step (kernels A and C).  Deeper random-weight stacks amplify the
    expected bf16 rounding differences chaotically, so depth is cut here,
    not width."""
    import dataclasses
    import numpy as np
    import torch
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams

    mc = dataclasses.replace(engine.model_config, num_layers=2)
    Lm = mc.num_layers - mc.first_dense_layers
    params = dict(engine.params)
    params["moe_layers"] = {k: v[:Lm] for k, v in
                            engine.params["moe_layers"].items()}
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, mc.vocab_size, 100).tolist()
    logits = {}
    cfg = engine.config
    for dev in ("cpu", "cuda"):
        eng = EngineCore(EngineConfig(
            model_config=mc, quantization=cfg.quantization,
            kv_cache_dtype=cfg.kv_cache_dtype, block_size=cfg.block_size,
            num_blocks=8, max_num_seqs=8, max_num_batched_tokens=512,
            enable_prefix_caching=False, device=dev),
            params=clone_to(params, dev))
        req = Request("ref", prompt, SamplingParams(
            temperature=0.0, max_tokens=2, ignore_eos=True))
        eng.add_request(req)
        steps = []
        for step in range(2):
            sched = eng.scheduler.schedule()
            batch, _ = eng._build_batch(sched)
            hidden = eng.model.forward(eng.params, eng.kv_cache, batch, mc,
                                       cfg.block_size)
            steps.append(eng.model.compute_logits(
                eng.params, hidden, mc)[:1].float().cpu())
            for sr in sched.scheduled:
                sr.request.num_computed_tokens += sr.num_new_tokens
            # Both sides decode the token the CPU reference picked.
            ref = logits["cpu"][step] if dev == "cuda" else steps[-1][0]
            req.output_token_ids.append(int(ref.argmax()))
        logits[dev] = torch.cat(steps)
    got, want = logits["cuda"], logits["cpu"]
    if not torch.isfinite(got).all():
        raise RuntimeError("non-finite logits from the kernel path")
    rel = float((got - want).abs().max() / want.abs().max())
    top = bool((got.argmax(-1) == want.argmax(-1)).all())
    return dict(layers=mc.num_layers, rel_max_err=rel, top1_agree=top,
                shape=list(got.shape))


def profile_decode(engine, prompts, steps: int = 4) -> dict:
    """Device busy time per decode step: prefill ``prompts``, then run
    ``steps`` decode steps under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from llm_d_tpu_torch.engine.request import Request
    from llm_d_tpu_torch.ops.sampling import SamplingParams
    reqs = [Request(f"prof-{i}", p, SamplingParams(
        temperature=0.0, max_tokens=steps + 4, ignore_eos=True))
        for i, p in enumerate(prompts)]
    for r in reqs:
        engine.add_request(r)
    while not all(r.output_token_ids for r in reqs):
        engine.step()
    engine.step()                         # one decode step outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    while engine.has_work():
        engine.step()
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            kernels.append((ev.key, dev_us / 1e3 / steps, ev.count / steps))
    device_ms = sum(k[1] for k in kernels)
    kernels.sort(key=lambda k: -k[1])
    return dict(
        steps=steps, batch=len(prompts), wall_ms_per_step=wall_ms,
        device_ms_per_step=device_ms if kernels else None,
        device_busy_share=device_ms / wall_ms if kernels else None,
        kernel_launches_per_step=sum(k[2] for k in kernels),
        top=[dict(name=n[:80], ms_per_step=m, launches_per_step=c)
             for n, m, c in kernels[:12]])


def clone_to(tree, device):
    if isinstance(tree, dict):
        return {k: clone_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np
    from llm_d_tpu_torch.engine import EngineConfig, EngineCore
    from llm_d_tpu_torch.ops import _build, mla_decode, mla_prefill, \
        moe_int8, moe_routed

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

    kernels = [
        dict(name="mla_decode", mod=mla_decode, fn="mla_paged_decode_update",
             plain="mla_paged_decode_update_plain",
             source="llm_d_tpu_torch/csrc/mla_decode.cu",
             replaces="llm_d_tpu/ops/pallas/mla_attention.py:224"),
        dict(name="mla_prefill", mod=mla_prefill, fn="mla_flash_prefill",
             plain="mla_flash_prefill_plain",
             source="llm_d_tpu_torch/csrc/mla_prefill.cu",
             replaces="llm_d_tpu/ops/pallas/mla_prefill.py:165"),
        dict(name="moe_dense_int8", mod=moe_int8, fn="dense_moe_int8",
             plain="dense_moe_int8_plain",
             source="llm_d_tpu_torch/csrc/moe_dense_int8.cu",
             replaces="llm_d_tpu/ops/pallas/moe_int8.py:182"),
        dict(name="moe_routed_int8", mod=moe_routed, fn="routed_moe_int8",
             plain="routed_moe_int8_plain",
             source="llm_d_tpu_torch/csrc/moe_routed_int8.cu",
             replaces="llm_d_tpu/ops/pallas/moe_routed.py:183"),
    ]

    # 2. engine -----------------------------------------------------------
    t0 = time.perf_counter()
    engine = EngineCore(EngineConfig(
        model="deepseek-v3-bench", quantization="int8",
        kv_cache_dtype="int8", block_size=64, num_blocks=256,
        max_num_seqs=128, max_num_batched_tokens=512,
        enable_prefix_caching=False, device="cuda", seed=0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"engine: init {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    weights = tensor_ptrs(engine.params)
    recorders = {k["name"]: Recorder(k["mod"], k["fn"], weights)
                 for k in kernels}

    rng = np.random.default_rng(0)
    vocab = engine.model_config.vocab_size
    p1 = [rng.integers(1, vocab, WAVE1["prompt"]).tolist()
          for _ in range(WAVE1["n"])]
    p2 = [rng.integers(1, vocab, WAVE2["prompt"]).tolist()
          for _ in range(WAVE2["n"])]
    for k in kernels:
        recorders[k["name"]].wrapped.launches = 0
    tok1, st1 = run_wave(engine, p1, WAVE1["new"], "w1")
    log(f"wave 1: {json.dumps(st1)}")
    tok2, st2 = run_wave(engine, p2, WAVE2["new"], "w2")
    log(f"wave 2: {json.dumps(st2)}")
    tok1b, st1b = run_wave(engine, p1, WAVE1["new"], "w1b")
    log(f"wave 1 again: {json.dumps(st1b)}")
    launches = {k["name"]: recorders[k["name"]].wrapped.launches
                for k in kernels}
    log(f"launches: {json.dumps(launches)}")
    if tok1b != tok1:
        raise RuntimeError("wave 1 did not repeat token for token")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")

    # 3. kernels against their plain versions --------------------------------
    rows, bounds = [], []
    for k in kernels:
        rec = recorders[k["name"]]
        if rec.first is None:
            raise RuntimeError(f"{k['name']}: no recorded launch")
        args, kw = rec.first
        fn, plain = rec.fn, getattr(k["mod"], k["plain"])
        a_k, kw_k = clone(args, weights), clone(kw, weights)
        a_p, kw_p = clone(args, weights), clone(kw, weights)
        got = fn(*a_k, **kw_k)
        want = plain(*a_p, **kw_p)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if k["name"].startswith("mla"):
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=2e-2, rtol=2e-2)
            if k["name"] == "mla_decode":
                # The in-place splice: cache and scale planes exactly.
                for idx in (2,):
                    if not torch.equal(a_k[idx], a_p[idx]):
                        raise RuntimeError("mla_decode: cache planes differ")
                if not torch.equal(kw_k["kv_scale"], kw_p["kv_scale"]):
                    raise RuntimeError("mla_decode: scale planes differ")
        else:
            scale = float(want.abs().max()) + 1e-9
            if err / scale > 1e-2:
                raise RuntimeError(f"{k['name']}: error {err} / scale "
                                   f"{scale} > 1e-2")
        ms = time_ms(lambda: fn(*a_k, **kw_k), iters=20)
        plain_ms = time_ms(lambda: plain(*a_p, **kw_p), iters=3, warmup=1)
        nbytes, flops = work(k["name"], args, kw, got)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        rows.append(dict(
            name=k["name"], route="cuda", source=k["source"],
            replaces=k["replaces"], launches=launches[k["name"]],
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
        bounds.append(dict(name=k["name"], shape=shape_of(args),
                           bytes=nbytes, flops=flops, bytes_ms=t_bytes,
                           ops_ms=t_ops))
        log(f"{k['name']}: err {err:.3g}, {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms")

    # 4. reference check ---------------------------------------------------
    ref = reference_check(engine)
    log(f"reference: {json.dumps(ref)}")
    if not ref["top1_agree"] or ref["rel_max_err"] > 5e-2:
        raise RuntimeError(f"kernel path disagrees with the CPU reference: "
                           f"{ref}")

    prof = None
    if "--profile" in sys.argv[1:]:
        prof = profile_decode(engine, p1)
        log(f"profile: {json.dumps(prof)}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    # The bound's inputs, derived from the recorded launches (not timed).
    print(json.dumps({"bounds": bounds}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"engine": {
        "model": "deepseek-v3-bench", "build_s": build_s, "init_s": init_s,
        "wave1": st1, "wave2": st2, "wave1_repeat": st1b,
        "reference": ref}}))
    if prof is not None:
        print(json.dumps({"profile": prof}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def shape_of(args):
    return [list(a.shape) for a in args if hasattr(a, "shape")][:2]


def work(name: str, args, kw, out):
    """(bytes moved, flops) the function needs on these inputs: each input
    it uses read once, each output written once.  Data-dependent parts
    count what this run's data needs: live query rows, the keys and
    block-table entries below each causal bound, the experts with a
    routed token and the routed (token, expert) pairs."""
    import torch
    if name in ("mla_decode", "mla_prefill"):
        q, _, cache, _, sl = args[:5]
        bs = kw["block_size"]
        kv_scale = kw.get("kv_scale")
        F = cache.shape[-1]
        H = q.shape[-2]
        # One latent row with its scales.
        row_b = F * cache.element_size() + (
            kv_scale.shape[-1] * 4 if kv_scale is not None else 0)
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
                  + experts * (3 * H * I + (2 * I + H) * 4)
                  + out.numel() * 4)
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
                  + experts * (3 * H * I + (2 * I + H) * 4)
                  + out.numel() * 4)
        return nbytes, 2 * 3 * T * k * H * I
    raise KeyError(name)


if __name__ == "__main__":
    sys.exit(main())
