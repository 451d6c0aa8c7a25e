#!/usr/bin/env python3
"""This checkout of the port against another, on one CUDA card, on the
same weights and inputs and in turns: its engine serving the waves, and
kernels A-H.

    git archive <commit> llm_d_tpu_torch | tar -x -C _scratch_parent
    python3 chip_ab.py _scratch_parent

(``_scratch*`` directories are gitignored.)  Serves deepseek-v3-bench as
``chip_smoke.py`` does, but through the classic loop (one step per
dispatch: the rounds swap the wrappers, and a captured decode graph
would keep the ones it was captured with), (waves 1-3, then wave 3 under
``LLMD_MOE_PREFILL_KERNEL=grouped``) and llama3-1b on a bf16 cache and on
int8 caches with one scale per row and one per KV head (``chip_smoke``'s
path (ii) wave each), and records the inputs of the first launch of A
for each batch size S, of B for each (S, Q), of C, D and E for each token
count T (D at [128, 2048] in wave 2), of F (x_pad [81920, 2048] in the
grouped wave 3) and of G and H for each cache mode.  Then:

1. waves: ``ROUNDS`` rounds of the seven waves, each round served by
   this checkout's engines or by the other's (the other checkout's
   modules throughout: engine, models, glue and the wrappers of A-H), on
   the same weights, in the order this, other, other, this, ...: prefill
   seconds and decode tok/s of every run, their medians, quartiles and
   ranges, whether each side's greedy tokens repeated across its rounds,
   and whether the two sides' tokens are the same wave by wave;
2. kernels: each recorded input (and A and G on 8 sequences x 4096 keys,
   E on the 8192-token step as one chunk) through both checkouts'
   wrappers: for A-F whether the outputs (and A's cache splice) are
   bit-equal between the two, as they must be; for G and H, whose
   arithmetic this tree may change, each side's max error against the
   plain version; then eight timings in the same order: eager ms
   (``chip_smoke.py``'s ``ms``: 20 calls back to back, event-timed, host
   cost included where it exceeds the kernel's), device ms and host ms
   per call (``chip_smoke.device_ms``).

Prints ``{"ab_waves": ...}``, ``{"ab_kernels": ...}`` and the card's name
and power limit.  The other checkout builds its kernels into its own
``build/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys

ROUNDS = 20
ORDER = ("this", "other", "other", "this")
TARGETS = {            # name: (module under llm_d_tpu_torch.ops, wrapper)
    "mla_decode": ("mla_decode", "mla_paged_decode_update"),
    "mla_prefill": ("mla_prefill", "mla_flash_prefill"),
    "moe_dense_int8": ("moe_int8", "dense_moe_int8"),
    "moe_routed_int8": ("moe_routed", "routed_moe_int8"),
    "moe_streamed_int8": ("moe_routed_stream", "streamed_moe_int8"),
    "moe_grouped_int8": ("moe_int8", "grouped_moe_int8"),
    "paged_decode": ("paged_attention", "paged_attention_decode_update"),
    "flash_prefill": ("flash_prefill", "flash_prefill_paged"),
}
LABELS = {
    "mla_decode": lambda a, kw: f"S={a[0].shape[0]}",
    "mla_prefill": lambda a, kw: f"S={a[0].shape[0]} Q={a[0].shape[1]}",
    "moe_dense_int8": lambda a, kw: f"T={a[0].shape[0]}",
    "moe_routed_int8": lambda a, kw: f"T={a[0].shape[0]}",
    "moe_streamed_int8": lambda a, kw: f"T={a[0].shape[0]}",
}
GROUPED = "wave3_grouped"      # wave 3 under LLMD_MOE_PREFILL_KERNEL=grouped
# G and H are held to their plain versions; A-F to the other checkout.
PLAIN = {"paged_decode": "paged_attention_decode_update_plain",
         "flash_prefill": "flash_prefill_paged_plain"}


def same_results(fns, args, kw, weights) -> bool:
    """Whether the two wrappers ``fns`` give bit-equal outputs and leave
    bit-equal inputs (kernel A splices the cache in place) on copies of
    ``(args, kw)``."""
    import torch
    import chip_smoke as cs
    res = []
    for fn in fns:
        a, k = cs.clone(args, weights), cs.clone(kw, weights)
        res.append((fn(*a, **k), a, k))
    torch.cuda.synchronize()
    (o0, a0, k0), (o1, a1, k1) = res

    def eq(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, dict):
            return all(eq(x[n], y[n]) for n in x)
        if isinstance(x, (list, tuple)):
            return all(eq(u, v) for u, v in zip(x, y))
        return x == y

    return eq(o0, o1) and eq(a0, a1) and eq(k0, k1)


def plain_errors(fns, plain, args, kw, weights) -> dict:
    """Each wrapper of ``fns`` (side: wrapper) against ``plain`` on copies
    of ``(args, kw)``: the max absolute error of its output."""
    import torch
    import chip_smoke as cs
    want = plain(*cs.clone(args, weights), **cs.clone(kw, weights)).float()
    errs = {}
    for side, fn in fns.items():
        got = fn(*cs.clone(args, weights), **cs.clone(kw, weights))
        errs[side] = float((got.float() - want).abs().max())
    torch.cuda.synchronize()
    return errs


def _ours(name: str) -> bool:
    return name == "llm_d_tpu_torch" or name.startswith("llm_d_tpu_torch.")


@contextlib.contextmanager
def swapped(modules: dict):
    """``sys.modules`` holds ``modules`` in place of this checkout's
    ``llm_d_tpu_torch`` modules inside the block, so imports made at call
    time (``chip_smoke``'s, the engine's lazy ones) resolve to them."""
    saved = {k: v for k, v in sys.modules.items() if _ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.modules.update(modules)
    try:
        yield
    finally:
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def load_other(root: str):
    """The checkout at ``root``: every module of its ``llm_d_tpu_torch``
    imported beside this checkout's under their own module objects
    (``{name: module}``, for ``swapped``), its kernels built, and its
    wrappers of ``TARGETS``."""
    import importlib
    import pkgutil
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    try:
        with swapped({}):
            pkg = importlib.import_module("llm_d_tpu_torch")
            for info in pkgutil.walk_packages(pkg.__path__,
                                              "llm_d_tpu_torch."):
                importlib.import_module(info.name)
            modules = {k: v for k, v in sys.modules.items() if _ours(k)}
    finally:
        sys.path.remove(root)
    for name, m in modules.items():
        if not os.path.abspath(m.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{name} loaded from {m.__file__}")
    with swapped(modules):
        modules["llm_d_tpu_torch.ops._build"].build_all()
    fns = {name: getattr(modules[f"llm_d_tpu_torch.ops.{mod}"], fn)
           for name, (mod, fn) in TARGETS.items()}
    return modules, fns


def spread(xs) -> dict:
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return dict(median=statistics.median(xs), q1=q1, q3=q3, min=min(xs),
                max=max(xs), runs=xs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import importlib
    import numpy as np
    import chip_smoke as cs
    from llm_d_tpu_torch.ops import _build
    from llm_d_tpu_torch.ops import moe as moe_ops

    _build.build_all()
    other_modules, other = load_other(sys.argv[1])
    mods = {n: importlib.import_module(f"llm_d_tpu_torch.ops.{m}")
            for n, (m, _) in TARGETS.items()}

    engine = cs.path_i_engine(1)
    weights = cs.tensor_ptrs(engine.params)
    recs = {n: cs.Recorder(mods[n], fn, weights,
                           cs.cache_mode if n in PLAIN else LABELS.get(n))
            for n, (_, fn) in TARGETS.items()}
    rng = np.random.default_rng(0)
    vocab = engine.model_config.vocab_size
    # Each wave's engine on each side: the other checkout's engines are
    # built from its own modules, on this side's weights.
    with swapped(other_modules):
        other_engine = cs.path_i_engine(1, engine.params)
    waves = {"wave1": cs.WAVE1, "wave2": cs.WAVE2, "wave3": cs.WAVE3,
             GROUPED: cs.WAVE3}
    engines = {"this": dict.fromkeys(waves, engine),
               "other": dict.fromkeys(waves, other_engine)}
    prompts = {w: cs.prompts_for(rng, vocab, spec)
               for w, spec in waves.items() if w != GROUPED}
    prompts[GROUPED] = prompts["wave3"]
    for kv, gran in cs.DENSE_MODES:
        w = "llama3-1b " + (kv if gran is None else f"{kv}-{gran}")
        dense = cs.path_ii_engine(kv, gran)
        with swapped(other_modules):
            engines["other"][w] = cs.path_ii_engine(kv, gran,
                                                    params=dense.params)
        engines["this"][w] = dense
        waves[w] = cs.DENSE_WAVE
        prompts[w] = cs.dense_prompts(dense.model_config.vocab_size)
    fns = {"this": {n: r.fn for n, r in recs.items()}, "other": other}

    def run(side, w, tag):
        kernel = "grouped" if w == GROUPED else "streamed"
        modules = (swapped(other_modules) if side == "other"
                   else contextlib.nullcontext())
        with cs.env_set("LLMD_MOE_PREFILL_KERNEL", kernel), modules:
            return cs.run_wave(engines[side][w], prompts[w],
                               waves[w]["new"], tag)

    with cs.bench_glue_recorder(moe_ops) as bench_glue:
        for w in waves:
            run("this", w, f"rec-{w}")
    for n, (_, fn) in TARGETS.items():          # the recording is done
        setattr(mods[n], fn, recs[n].fn)

    # 1. waves, in turns ----------------------------------------------------
    runs = {side: {w: {"prefill_seconds": [], "decode_tok_s": []}
                   for w in waves} for side in fns}
    tokens = {side: {} for side in fns}
    repeat = {side: True for side in fns}
    for i in range(ROUNDS):
        side = ORDER[i % len(ORDER)]
        for w in waves:
            tok, stats = run(side, w, f"{side}{i}-{w}")
            runs[side][w]["prefill_seconds"].append(stats["prefill_seconds"])
            runs[side][w]["decode_tok_s"].append(stats["decode_tok_s"])
            repeat[side] &= tokens[side].setdefault(w, tok) == tok
    ab_waves = {side: {w: {m: spread(v) for m, v in ms.items()}
                       for w, ms in runs[side].items()} for side in fns}
    for side in fns:
        ab_waves[side]["tokens_repeat"] = repeat[side]
    ab_waves["same_tokens"] = {w: tokens["this"][w] == tokens["other"][w]
                               for w in waves}
    cs.log(f"waves: {json.dumps(ab_waves)}")
    for w in waves:
        cs.log(f"{w}: " + "; ".join(
            f"{side} prefill s {d['median']:.4f} [{d['q1']:.4f}-"
            f"{d['q3']:.4f}] decode tok/s {t['median']:.1f} [{t['q1']:.1f}-"
            f"{t['q3']:.1f}]" for side in fns
            for d, t in [(ab_waves[side][w]["prefill_seconds"],
                          ab_waves[side][w]["decode_tok_s"])]))

    # 2. kernels on the recorded inputs, in turns ---------------------------
    inputs = [(n, label, args, kw) for n, r in recs.items()
              for label, (args, kw) in r.calls.items()]
    first = next(iter(recs["mla_decode"].calls.values()))
    inputs.append(("mla_decode", "S=8 keys=4096",
                   *cs.long_decode_inputs(*first, S=8, keys=4096, seed=11)))
    first = next(iter(recs["paged_decode"].calls.values()))
    inputs.append(("paged_decode", "S=8 keys=4096",
                   *cs.long_dense_decode_inputs(*first, S=8, keys=4096,
                                                seed=12)))
    one_chunk = cs.bench_step_as_one_chunk(
        moe_ops, mods["moe_streamed_int8"], bench_glue["args"])
    inputs.append(("moe_streamed_int8",
                   f"T={cs.BENCH_T} chunk_t={cs.BENCH_T}", *one_chunk))
    ab_kernels = []
    for n, label, args, kw in inputs:
        sides = {side: fns[side][n] for side in fns}
        if n in PLAIN:
            check = dict(max_err_vs_plain=plain_errors(
                sides, getattr(mods[n], PLAIN[n]), args, kw, weights))
        else:
            check = dict(bit_equal=same_results(list(sides.values()), args,
                                                kw, weights))
            if not check["bit_equal"]:
                raise RuntimeError(f"{n} [{label}]: outputs differ from the "
                                   f"other checkout's")
        res = {side: {"ms": [], "device_ms": [], "host_ms": []}
               for side in fns}
        copies = {side: (cs.clone(args, weights), cs.clone(kw, weights))
                  for side in fns}
        for side in ORDER * 2:
            fn, (a, k) = fns[side][n], copies[side]
            res[side]["ms"].append(cs.time_ms(lambda: fn(*a, **k), iters=20))
            dev, host = cs.device_ms(lambda: fn(*a, **k))
            res[side]["device_ms"].append(dev)
            res[side]["host_ms"].append(host)
        row = dict(name=n, variant=label, **check, **{
            side: {m: spread(v) for m, v in r.items()}
            for side, r in res.items()})
        ab_kernels.append(row)
        cs.log(f"{n} [{label}]: {json.dumps(check)}; " + "; ".join(
            f"{side} ms {row[side]['ms']['median']:.4f} device "
            f"{row[side]['device_ms']['median']:.4f} host "
            f"{row[side]['host_ms']['median']:.4f}" for side in fns))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"ab_waves": {"other": sys.argv[1], "rounds": ROUNDS,
                                   **ab_waves}}))
    print(json.dumps({"ab_kernels": ab_kernels}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
