"""EngineCore: the serving engine on one device (port of the classic
single-device step of ``llm_d_tpu.engine.engine``).

Owns the device state (parameters and the paged KV cache), turns
scheduler output into bucketed ragged batches, runs one forward + sample
per step, and advances request state.  The model runs eagerly; the
step's one host sync is the fetch of the sampled ids.

Multistep and async scheduling (``num_scheduler_steps`` > 1,
``async_scheduling``), as the JAX engine's classic pipeline runs them: a
pure-decode round runs K decode iterations as one block with one host
fetch, and under async scheduling the next block is queued before the
current one is retired.  On the card each block is one replay of a
captured CUDA graph (``engine/cuda_graph.py``); on the CPU its body runs
eagerly.

``self.metrics`` (``utils/metrics.EngineMetrics``) is updated at the JAX
engine's points with the same counts, from host-side state only: after
the host fetch a classic step or a block's retire already makes, never
inside a step or a captured graph.

Speculative decode (``spec_k`` > 0, MTP draft-and-verify), as the JAX
engine's single-round path runs it: every step is one fused mixed round
(``_run_fused``).  Prefill chunks, plain decodes and K+1-position
draft-verify rows share one forward over the ragged batch; ``spec_verify``
accepts drafts and samples; the drafter proposes the next drafts from
the accepted position's hidden state; rejected tails go back to the
pool the same step; one batched host fetch.  Greedy and seeded output
is the non-spec engine's, token for token.  ``spec_fixed_accept``
(bench only) replaces verification with a seeded coin.

Not ported yet (later slices): the fused multistep pipeline
(``spec_k`` > 0 with ``num_scheduler_steps`` > 1 raises), EPLB, KV
offload, the KV connector, ``stub_components`` and tracing.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from llm_d_tpu_torch.engine.cuda_graph import DecodeGraphs
from llm_d_tpu_torch.engine.kv_cache import KVCacheManager
from llm_d_tpu_torch.engine.request import Request, RequestOutput, RequestState
from llm_d_tpu_torch.engine.scheduler import Scheduler, SchedulerOutput
from llm_d_tpu_torch.models import get_model
from llm_d_tpu_torch.models.config import ModelConfig, get_config
from llm_d_tpu_torch.ops import prng
from llm_d_tpu_torch.ops import sampling as sampling_ops
from llm_d_tpu_torch.ops.quant import (
    KV_CACHE_DTYPES, KV_SCALE_GRANULARITIES, MLA_LATENT_DTYPES,
    kv_scale_width, quantize_moe_experts)
from llm_d_tpu_torch.utils.config import env_choice, env_float, env_int
from llm_d_tpu_torch.utils.device import resolve_device
from llm_d_tpu_torch.utils.metrics import EngineMetrics
from llm_d_tpu_torch.utils.predictor import (
    SpecAcceptanceTracker, StepTimeModel)

logger = logging.getLogger(__name__)

SPEC_DECODE_MODES = ("auto", "off")


def _next_bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def kv_bytes_per_token(layout: Dict[str, int], kv_cache_dtype: str = "bf16",
                       scale_width: int = 1) -> int:
    """Bytes one token's KV costs per layer: payload rows plus, for int8,
    ``scale_width`` f32 scale columns per buffer."""
    per = sum(layout.values()) * (1 if kv_cache_dtype == "int8" else 2)
    if kv_cache_dtype == "int8":
        per += len(layout) * scale_width * 4
    return per


def derive_num_blocks(hbm_budget_bytes: int, layout: Dict[str, int],
                      num_layers: int, block_size: int,
                      kv_cache_dtype: str = "bf16",
                      scale_width: int = 1) -> int:
    """How many paged-KV blocks fit a device-memory budget."""
    per_block = num_layers * block_size * kv_bytes_per_token(
        layout, kv_cache_dtype, scale_width)
    return max(hbm_budget_bytes // per_block, 2)


@dataclasses.dataclass
class EngineConfig:
    model: str = "tiny-mla"                  # preset name
    model_config: Optional[ModelConfig] = None
    block_size: int = 32
    num_blocks: int = 256                    # KV blocks incl. null block 0
    max_num_seqs: int = 64
    max_num_batched_tokens: int = 1024
    enable_prefix_caching: bool = True
    attn_backend: str = "auto"     # auto | kernel | chunked | reference
    seed: int = 0
    min_token_bucket: int = 16
    min_seq_bucket: int = 8
    # Multistep decode: a pure-decode round runs this many decode
    # iterations as one block, sampled ids fed back on the device, with
    # one host fetch per block.
    num_scheduler_steps: int = 1
    # Async scheduling: keep one decode block in flight and queue its
    # successor (last ids taken from the in-flight block on the device)
    # before retiring it, so the host's token processing overlaps the
    # device.  New arrivals drain the pipeline.
    async_scheduling: bool = False
    # MoE expert-weight quantization: "int8" or None.
    quantization: Optional[str] = None
    # Paged-KV cache dtype: "bf16" or "int8".  None resolves
    # LLMD_KV_CACHE_DTYPE (default bf16).
    kv_cache_dtype: Optional[str] = None
    # int8 scale granularity of a dense cache: "token" (one f32 scale per
    # row) or "head" (one per KV head).  None resolves LLMD_KV_SCALE_GRAN
    # (default "token").  MLA's latent row always has one scale.
    kv_scale_granularity: Optional[str] = None
    # MLA latent dtype gate: "auto" follows kv_cache_dtype; "bf16"/"int8"
    # pin it.  None resolves LLMD_MLA_LATENT_DTYPE (default auto).
    mla_latent_dtype: Optional[str] = None
    # None = the first CUDA device (raises without one); "cpu" must be
    # asked for explicitly.
    device: Optional[str] = None
    # Speculative decode (MTP draft-and-verify): "auto" runs the fused
    # mixed round whenever spec_k > 0; "off" is today's engine.  None
    # resolves LLMD_SPEC_DECODE.
    spec_decode: Optional[str] = None
    # Draft tokens per step (K); 0 = off.  None resolves LLMD_SPEC_K.
    spec_k: Optional[int] = None
    # Bench only: accept each live draft by a seeded coin at this rate
    # instead of verifying it (changes the output).  Read every step, so
    # a bench may switch it between waves (``set_spec_fixed_accept``).
    spec_fixed_accept: Optional[float] = None

    def resolve_model(self) -> ModelConfig:
        return self.model_config or get_config(self.model)


class EngineCore:
    def __init__(self, config: EngineConfig,
                 params: Optional[Dict[str, Any]] = None,
                 draft_params: Optional[Dict[str, Any]] = None) -> None:
        """``params`` and ``draft_params`` (e.g. from
        ``models.convert.params_from_numpy``) must already live on the
        engine's device; ``None`` random-initializes them from
        ``config.seed`` and, for the drafter, ``config.seed + 1``."""
        self.config = config
        self.device = resolve_device(config.device)
        self.model_config = config.resolve_model()
        c = self.model_config
        self.model = get_model(c)

        # An explicit value wins; None resolves the environment knob (an
        # invalid environment value falls back with a warning, an invalid
        # explicit one raises).
        self.kv_cache_dtype = config.kv_cache_dtype or env_choice(
            "LLMD_KV_CACHE_DTYPE", "bf16", KV_CACHE_DTYPES)
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"unknown kv_cache_dtype {self.kv_cache_dtype!r}"
                             f" (choices: {KV_CACHE_DTYPES})")
        if c.use_mla:
            latent = config.mla_latent_dtype or env_choice(
                "LLMD_MLA_LATENT_DTYPE", "auto", MLA_LATENT_DTYPES)
            if latent not in MLA_LATENT_DTYPES:
                raise ValueError(f"unknown mla_latent_dtype {latent!r} "
                                 f"(choices: {MLA_LATENT_DTYPES})")
            if latent != "auto":
                self.kv_cache_dtype = latent
        self.kv_quantized = self.kv_cache_dtype == "int8"
        gran = config.kv_scale_granularity or env_choice(
            "LLMD_KV_SCALE_GRAN", "token", KV_SCALE_GRANULARITIES)
        if gran not in KV_SCALE_GRANULARITIES:
            raise ValueError(f"unknown kv_scale_granularity {gran!r} "
                             f"(choices: {KV_SCALE_GRANULARITIES})")
        self.kv_scale_granularity = gran
        # The MLA latent row is MQA-shared: one f32 scale per row; dense
        # K/V rows may carry one per KV head.
        if not self.kv_quantized:
            self.kv_scale_width = 0
        elif c.use_mla:
            self.kv_scale_width = 1
        else:
            self.kv_scale_width = kv_scale_width(c.num_kv_heads, gran)

        if config.quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {config.quantization!r}")
        if config.async_scheduling and config.num_scheduler_steps <= 1:
            # The pipeline operates on multistep blocks; without them the
            # flag would be a silent no-op.
            raise ValueError(
                "async_scheduling requires num_scheduler_steps > 1 "
                "(it pipelines fused decode blocks)")

        self.kv_manager = KVCacheManager(
            config.num_blocks, config.block_size,
            enable_prefix_caching=config.enable_prefix_caching)
        self.scheduler = Scheduler(
            self.kv_manager,
            max_num_seqs=config.max_num_seqs,
            max_num_batched_tokens=config.max_num_batched_tokens,
            max_model_len=c.max_model_len)
        # Decode-priority chunk budgeting: LLMD_PREFILL_CHUNK pins a
        # per-chunk prefill cap; "auto" (the default) sizes chunks from the
        # step-latency model against LLMD_STEP_TIME_TARGET_MS, and with no
        # target the cap stays off (chunks are budget-bound only).
        raw_chunk = os.environ.get("LLMD_PREFILL_CHUNK", "auto")
        self._prefill_chunk_fixed: Optional[int] = None
        if raw_chunk != "auto":
            try:
                self._prefill_chunk_fixed = max(1, int(raw_chunk))
            except ValueError:
                logger.warning("LLMD_PREFILL_CHUNK=%r is neither 'auto' nor "
                               "an integer; using 'auto'", raw_chunk)
        self._step_time_target_ms = env_float("LLMD_STEP_TIME_TARGET_MS", 0.0)
        self.step_time_model = StepTimeModel()
        self.scheduler.prefill_chunk_cap = self._prefill_chunk_cap

        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(config.seed)
            params = self.model.init_params(c, init_gen, self.device)
        if config.quantization == "int8" and "moe_layers" in params \
                and "w_gate_q" not in params["moe_layers"]:
            params = quantize_moe_experts(params)
        self.params = params

        num_slots = config.num_blocks * config.block_size
        layout = self.model.kv_cache_layout(c)
        payload = torch.int8 if self.kv_quantized else torch.bfloat16
        self.kv_cache: Dict[str, torch.Tensor] = {}
        for name, width in layout.items():
            self.kv_cache[name] = torch.zeros(
                (c.num_layers, num_slots, width), dtype=payload,
                device=self.device)
            if self.kv_quantized:
                self.kv_cache[f"{name}_scale"] = torch.zeros(
                    (c.num_layers, num_slots, self.kv_scale_width),
                    dtype=torch.float32, device=self.device)

        self.max_blocks_per_seq = -(-c.max_model_len // config.block_size)
        # The sampling key, split once per step as the JAX engine splits
        # its own, so unseeded rows draw the JAX package's bits too.
        self._rng = prng.prng_key(config.seed)
        # Engine steps taken and device dispatches made: K steps per
        # dispatch under multistep, one classic.
        self._step_count = 0
        self._dispatch_count = 0
        # Async scheduling: the one in-flight decode block.
        self._inflight: Optional[Dict[str, Any]] = None
        # The decode blocks' CUDA graphs (none on the CPU, where a block's
        # body runs eagerly).
        self._graphs = (DecodeGraphs(self.device)
                        if config.num_scheduler_steps > 1
                        and self.device.type == "cuda" else None)
        self._rejected: List[RequestOutput] = []
        self.metrics = EngineMetrics(c.name)
        self._disabled_seen: set = set()

        # Speculative decode: on when the mode is "auto" and K > 0 (the
        # default K of 0 keeps today's engine).
        spec_mode = config.spec_decode or env_choice(
            "LLMD_SPEC_DECODE", "auto", SPEC_DECODE_MODES)
        if spec_mode not in SPEC_DECODE_MODES:
            raise ValueError(f"unknown spec_decode {spec_mode!r} "
                             f"(choices: {SPEC_DECODE_MODES})")
        spec_k = (config.spec_k if config.spec_k is not None
                  else env_int("LLMD_SPEC_K", 0))
        self.spec_k = 0
        self.draft_params = None
        self.spec_tracker: Optional[SpecAcceptanceTracker] = None
        if spec_mode != "off" and spec_k > 0:
            if config.num_scheduler_steps > 1:
                raise ValueError(
                    "spec_k > 0 with num_scheduler_steps > 1 runs the fused "
                    "multistep pipeline, which the PyTorch port does not "
                    "serve yet; use num_scheduler_steps=1 or spec_k=0")
            self.spec_k = int(spec_k)
            if draft_params is None:
                draft_gen = torch.Generator(device=self.device)
                draft_gen.manual_seed(config.seed + 1)
                draft_params = self.model.init_draft_params(
                    c, draft_gen, self.device)
            self.draft_params = draft_params
            self.spec_tracker = SpecAcceptanceTracker(self.spec_k)
            self.scheduler.spec_lookahead = self._spec_lookahead
            logger.info("spec decode on: K=%d%s", self.spec_k,
                        f" (fixed acceptance {config.spec_fixed_accept})"
                        if config.spec_fixed_accept is not None else "")
        self._last_evictions = 0
        self._last_preemptions = 0
        self.eos_token_id: Optional[int] = None
        # Optional tokenizer enables engine-side stop-string detection.
        self.tokenizer = None

    # ---------- public API ----------

    def add_request(self, request: Request) -> None:
        if request.do_remote_decode or request.kv_transfer_params:
            # No KV connector in the port yet: a disaggregated request
            # served locally would look healthy while defeating PD.
            request.state = RequestState.FINISHED_ABORTED
            self._rejected.append(RequestOutput(
                request.request_id, [], True,
                finish_reason=RequestState.FINISHED_ABORTED.value))
            return
        self.scheduler.add_request(request)

    def abort_request(self, request_id: str) -> None:
        self.scheduler.abort_request(request_id)
        self._spec_forget(request_id)

    def has_work(self) -> bool:
        return (self.scheduler.has_work() or bool(self._rejected)
                or self._inflight is not None)

    # ---------- feature composition and chunk budgeting ----------

    def _disable_feature(self, feature: str, blocker: str) -> None:
        """Count a feature demotion (``engine_feature_disabled_total``)
        and log it once."""
        self.metrics.inc_feature_disabled(feature, blocker)
        if (feature, blocker) not in self._disabled_seen:
            self._disabled_seen.add((feature, blocker))
            logger.warning("%s demoted: %s", feature, blocker)

    def set_spec_fixed_accept(self, rate: Optional[float]) -> None:
        """Bench only: verify drafts (``rate`` None) or accept them by the
        seeded coin at ``rate`` from the next step on."""
        self.config = dataclasses.replace(self.config,
                                          spec_fixed_accept=rate)

    def _spec_forget(self, request_id: str) -> None:
        """Drop a finished request's acceptance state (every finish
        path), so live requests are never evicted from the bounded
        table by stale ones."""
        if self.spec_tracker is not None:
            self.spec_tracker.forget(request_id)

    def _prefill_chunk_cap(self, decode_tokens: int) -> Optional[int]:
        """Per-chunk prefill token cap of one schedule pass (the
        scheduler's callback, after ``decode_tokens`` of decode and spec
        lookahead are funded): LLMD_PREFILL_CHUNK when fixed, else the
        step-latency model's chunk under LLMD_STEP_TIME_TARGET_MS, else
        None (budget-bound only)."""
        if self._prefill_chunk_fixed is not None:
            return self._prefill_chunk_fixed
        if self._step_time_target_ms <= 0.0 \
                or not self.step_time_model.trained:
            return None
        return self.step_time_model.chunk_for(
            decode_tokens, self._step_time_target_ms,
            lo=self.config.min_token_bucket,
            hi=self.config.max_num_batched_tokens)

    # ---------- batch building ----------

    def _empty_batch_np(self, T: int, S: int, Q: int,
                        B: int) -> Dict[str, np.ndarray]:
        return dict(
            token_ids=np.zeros(T, np.int32),
            positions=np.zeros(T, np.int32),
            token_seq_ids=np.zeros(T, np.int32),
            token_qpos=np.zeros(T, np.int32),
            slot_mapping=np.zeros(T, np.int32),  # block 0 = trash
            block_tables=np.zeros((S, B), np.int32),
            seq_lens=np.zeros(S, np.int32),
            sample_idx=np.zeros(S, np.int32),
            qtok_idx=np.full((S, Q), T, np.int32),  # T = padded-q sentinel
            temperature=np.zeros(S, np.float32),
            top_k=np.zeros(S, np.int32),
            top_p=np.ones(S, np.float32),
            seeds=np.full(S, -1, np.int32),
            gen_idx=np.zeros(S, np.int32))

    def _fill_batch(self, arrs: Dict[str, np.ndarray], scheduled) -> None:
        bs = self.config.block_size
        t = 0
        for s, sr in enumerate(scheduled):
            req, n = sr.request, sr.num_new_tokens
            start = req.num_computed_tokens
            arrs["token_ids"][t:t + n] = req.all_token_ids[start:start + n]
            pos_arr = np.arange(start, start + n)
            arrs["positions"][t:t + n] = pos_arr
            arrs["token_seq_ids"][t:t + n] = s
            blocks = np.asarray(req.block_ids, np.int32)
            arrs["slot_mapping"][t:t + n] = \
                blocks[pos_arr // bs] * bs + pos_arr % bs
            arrs["token_qpos"][t:t + n] = np.arange(n)
            arrs["qtok_idx"][s, :n] = np.arange(t, t + n)
            arrs["block_tables"][s, :len(blocks)] = blocks
            arrs["seq_lens"][s] = start + n
            arrs["sample_idx"][s] = t + n - 1
            sp = req.sampling
            arrs["temperature"][s] = sp.temperature
            arrs["top_k"][s] = sp.top_k
            arrs["top_p"][s] = sp.top_p
            if sp.seed is not None:
                arrs["seeds"][s] = int(sp.seed) & 0x7FFFFFFF
            arrs["gen_idx"][s] = len(req.output_token_ids)
            t += n

    _HOST_KEYS = ("temperature", "top_k", "top_p", "seeds", "gen_idx")

    def _build_batch(self, out: SchedulerOutput
                     ) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
        """(device batch, host sampling rows).  T, S and Q bucket to powers
        of two as in the JAX engine, so the kernels see the same shapes."""
        cfg = self.config
        max_q = max((sr.num_new_tokens for sr in out.scheduled), default=1)
        T = _next_bucket(out.total_tokens, cfg.min_token_bucket,
                         cfg.max_num_batched_tokens)
        S = _next_bucket(len(out.scheduled),
                         min(cfg.min_seq_bucket, cfg.max_num_seqs),
                         cfg.max_num_seqs)
        Q = 1 if max_q == 1 else _next_bucket(
            max_q, cfg.min_token_bucket, cfg.max_num_batched_tokens)
        arrs = self._empty_batch_np(T, S, Q, self.max_blocks_per_seq)
        self._fill_batch(arrs, out.scheduled)
        host = {k: torch.from_numpy(arrs.pop(k)) for k in self._HOST_KEYS}
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in arrs.items()}
        return batch, host

    # ---------- multistep decode ----------

    def _ms_body(self, mb: Dict[str, torch.Tensor], keys: torch.Tensor,
                 ids: torch.Tensor, random_rows: bool) -> None:
        """``ids.shape[0]`` decode iterations of the block ``mb`` (the
        JAX engine's ``_build_multistep_fn`` body), sampled ids fed to
        the next iteration on the device; iteration ``it`` draws with
        key ``keys[it]`` and writes its ids to ``ids[it]``.  A plain
        function of tensors that never syncs the host: on the card it is
        what a block's graph captures.  ``random_rows`` says whether any
        row samples at random (decided on the host, per block).

        Sequence row ``s`` decodes token row ``s``.  The token rows are
        padded to the classic step's token bucket (``min_token_bucket``,
        where the JAX block runs T == S) with the classic step's pad
        tokens, so a decode row meets the same matrix shapes whichever
        path serves it: cuBLAS picks its GEMM by the row count, and an
        8-row product rounds otherwise than a 16-row one."""
        c, cfg = self.model_config, self.config
        bs = cfg.block_size
        bt = mb["block_tables"]
        active = mb["active"]
        S, B = bt.shape
        T = _next_bucket(S, cfg.min_token_bucket, cfg.max_num_batched_tokens)

        def tokens(v):                   # [S] -> [T], pad tokens 0
            return torch.nn.functional.pad(v, (0, T - S)) if T > S else v

        seq_ids = torch.arange(S, dtype=torch.int32, device=bt.device)
        tok_seq_ids = tokens(seq_ids)
        qpos = torch.zeros(T, dtype=torch.int32, device=bt.device)
        last_ids, pos0 = mb["last_ids"], mb["pos0"]
        for it in range(ids.shape[0]):
            # One token per sequence.  Rows past their table (finished
            # rows keep advancing) are clamped; they are inactive and
            # write the trash block.
            page = (pos0 // bs).clamp(max=B - 1).long()
            slot = torch.gather(bt, 1, page[:, None])[:, 0] * bs + pos0 % bs
            batch = dict(
                token_ids=tokens(last_ids), positions=tokens(pos0),
                token_seq_ids=tok_seq_ids, token_qpos=qpos,
                slot_mapping=tokens(torch.where(active, slot, pos0 % bs)),
                block_tables=bt,
                seq_lens=torch.where(active, pos0 + 1, 0),
                sample_idx=seq_ids, qtok_idx=seq_ids[:, None])
            hidden = self.model.forward(self.params, self.kv_cache, batch, c,
                                        bs, self.config.attn_backend)
            logits = self.model.compute_logits(self.params, hidden, c)
            tok = sampling_ops.sample(
                logits, mb["temperature"], mb["top_k"], mb["top_p"],
                key=(keys[it, 0], keys[it, 1]), seeds=mb["seeds"],
                gen_idx=mb["gen0"] + it, random_rows=random_rows)
            ids[it] = torch.where(active, tok, 0)
            last_ids, pos0 = ids[it], pos0 + 1

    def _ms_static(self, S: int, K: int
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """A block graph's static inputs and output ``ids [K, S]``."""
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        i32 = torch.int32
        inputs = dict(
            last_ids=z(S, i32), pos0=z(S, i32),
            block_tables=z((S, self.max_blocks_per_seq), i32),
            active=z(S, torch.bool), temperature=z(S, torch.float32),
            top_k=z(S, i32), top_p=z(S, torch.float32), seeds=z(S, i32),
            gen0=z(S, i32), keys=z((K, 2), torch.int64))
        return inputs, z((K, S), i32)

    def _try_multistep(self, sched: SchedulerOutput) -> Optional[int]:
        """If this is a pure-decode round eligible for multistep,
        pre-allocate K tokens per request and return K; else None."""
        K = self.config.num_scheduler_steps
        if K <= 1 or not sched.scheduled:
            return None
        for sr in sched.scheduled:
            req = sr.request
            if (sr.num_new_tokens != 1
                    or req.num_computed_tokens != req.num_tokens - 1
                    or req.do_remote_decode
                    or req.sampling.logprobs is not None):
                return None
            if req.num_tokens + K >= self.model_config.max_model_len:
                return None
        # Pre-allocate blocks to cover K new tokens for every request.
        allocated: List[Tuple[Request, List[int]]] = []
        for sr in sched.scheduled:
            req = sr.request
            ok = self.kv_manager.allocate(req, req.num_computed_tokens + K)
            if ok is None:
                # Roll back earlier requests' tail blocks: holding them
                # until finish fragments the pool under exactly the
                # pressure that made allocation fail.
                for r, blocks in reversed(allocated):
                    self.kv_manager.release_tail(r, blocks)
                return None   # fall back to the single step
            allocated.append((req, ok))
        return K

    def _ms_meta(self, scheduled) -> Tuple[Dict[str, np.ndarray], List,
                                           np.ndarray]:
        """Host arrays of a multistep block: (meta, scheduled in row
        order, row of each scheduled entry).  S buckets alone, as in the
        JAX engine; ``_ms_body`` pads the token rows."""
        cfg = self.config
        S = _next_bucket(len(scheduled),
                         min(cfg.min_seq_bucket, cfg.max_num_seqs),
                         cfg.max_num_seqs)
        B = self.max_blocks_per_seq
        last_ids = np.zeros(S, np.int32)
        pos0 = np.zeros(S, np.int32)
        block_tables = np.zeros((S, B), np.int32)
        active = np.zeros(S, bool)
        temperature = np.zeros(S, np.float32)
        top_k = np.zeros(S, np.int32)
        top_p = np.ones(S, np.float32)
        seeds = np.full(S, -1, np.int32)
        gen0 = np.zeros(S, np.int32)
        for s, sr in enumerate(scheduled):
            req = sr.request
            last_ids[s] = req.all_token_ids[req.num_computed_tokens]
            pos0[s] = req.num_computed_tokens
            block_tables[s, :len(req.block_ids)] = req.block_ids
            active[s] = True
            temperature[s] = req.sampling.temperature
            top_k[s] = req.sampling.top_k
            top_p[s] = req.sampling.top_p
            if req.sampling.seed is not None:
                seeds[s] = int(req.sampling.seed) & 0x7FFFFFFF
            gen0[s] = len(req.output_token_ids)
        meta = dict(last_ids=last_ids, pos0=pos0, block_tables=block_tables,
                    active=active, temperature=temperature, top_k=top_k,
                    top_p=top_p, seeds=seeds, gen0=gen0)
        return meta, list(scheduled), np.arange(len(scheduled),
                                                dtype=np.int32)

    def _ms_dispatch(self, meta: Dict[str, Any], scheduled, K: int,
                     rows: np.ndarray) -> Dict[str, Any]:
        """Queue one multistep block; returns the in-flight record
        without synchronizing (ids reach the host at retire).
        ``meta["last_ids"]`` may be a device tensor: a predecessor
        block's last ids, copied in stream order."""
        self._rng, step_key = prng.split(self._rng)
        keys = np.asarray(prng.split(step_key, K), np.int64)    # [K, 2]
        random_rows = bool((meta["temperature"] > 0).any())
        S = meta["pos0"].shape[0]
        rec = dict(scheduled=list(scheduled), K=K, meta=meta, rows=rows)
        if self._graphs is None:
            mb = {k: torch.as_tensor(v, device=self.device)
                  for k, v in meta.items()}
            ids = torch.empty((K, S), dtype=torch.int32, device=self.device)
            self._ms_body(mb, torch.as_tensor(keys, device=self.device),
                          ids, random_rows)
            rec.update(ids_dev=ids, ids_host=ids, done=None)
        else:
            g = self._graphs.block((S, random_rows),
                                   lambda: self._ms_static(S, K))
            self._graphs.load(g, dict(meta, keys=keys))
            if g.graph is None:
                self._graphs.capture(
                    g, lambda n: self._ms_body(
                        g.inputs, g.inputs["keys"][:n], g.ids[:n],
                        random_rows), K)
            host, done = self._graphs.replay(g)
            rec.update(ids_dev=g.ids, ids_host=host, done=done)
        self._dispatch_count += 1
        self.metrics.engine_dispatches.inc()
        return rec

    def _ms_retire(self, inflight: Dict[str, Any]) -> List[RequestOutput]:
        """Wait for one in-flight block and advance request state."""
        scheduled, K = inflight["scheduled"], inflight["K"]
        if inflight["done"] is not None:
            # The block's own copy: a successor queued after it runs on.
            inflight["done"].synchronize()
        ids_ks = inflight["ids_host"].numpy()
        self._step_count += K
        self.metrics.engine_steps.inc(K)
        outputs: List[RequestOutput] = []
        now = time.monotonic()
        for s, sr in zip(inflight["rows"], scheduled):
            req = sr.request
            if req.state is not RequestState.RUNNING:
                # Finished (a stop at an earlier retire) or aborted while
                # this block was in flight: its tokens are discarded.  Its
                # KV writes landed past every live reader's length, and
                # stream order puts them before any reallocation's.
                continue
            new_tokens: List[int] = []
            finish = None
            for k in range(K):
                token = int(ids_ks[k, s])
                req.num_computed_tokens += 1
                req.output_token_ids.append(token)
                new_tokens.append(token)
                finish = self._check_stop(req, token)
                if finish is not None:
                    break
            # Tokens past a stop are discarded; their KV writes live in
            # already-allocated blocks and are freed with the request.
            self.metrics.generation_tokens.inc(len(new_tokens))
            if req.last_token_time is not None:
                self.metrics.inter_token_latency.observe(
                    (now - req.last_token_time) / max(1, len(new_tokens)))
            req.last_token_time = now
            self.kv_manager.cache_full_blocks(req)
            outputs.append(RequestOutput(
                req.request_id, new_tokens, finish is not None,
                finish_reason=finish))
            if finish is not None:
                self.scheduler.finish(req, RequestState(finish))
                self._count_success(req, finish, now)
        self._update_queue_metrics()
        return outputs

    def _ms_try_extend(self, inflight: Dict[str, Any]
                       ) -> Optional[Dict[str, Any]]:
        """Dispatch the in-flight block's successor before the in-flight
        tokens are known: last ids come from the device, positions
        advance by K, fresh blocks are pre-allocated.  Returns the new
        in-flight record, or None when the pipeline must drain (new
        arrivals, rejections, an expired deadline, allocation failure,
        or every request ending within the current block)."""
        if self._rejected or self.scheduler.waiting:
            return None
        scheduled, K = inflight["scheduled"], inflight["K"]
        meta = inflight["meta"]
        rows = inflight["rows"]
        max_len = self.model_config.max_model_len
        live = 0
        for s, sr in zip(rows, scheduled):
            req = sr.request
            if req.state is not RequestState.RUNNING:
                continue
            if req.deadline_expired():
                # Drain so the next schedule() pass evicts the expired
                # request and frees its blocks.
                return None
            if int(meta["pos0"][s]) + 2 * K >= max_len:
                return None
            if int(meta["gen0"][s]) + K < req.sampling.max_tokens:
                live += 1
        if live == 0:
            return None     # everything finishes within the in-flight block
        # Pre-allocate blocks covering the successor's K tokens.  Requests
        # certain to finish (by length) inside the in-flight block get no
        # allocation: they become pad rows below.
        finishing = [int(meta["gen0"][s]) + K >= sr.request.sampling.max_tokens
                     for s, sr in zip(rows, scheduled)]
        allocated: List[Tuple[Request, List[int]]] = []
        for (s, sr), fin in zip(zip(rows, scheduled), finishing):
            req = sr.request
            if req.state is not RequestState.RUNNING or fin:
                continue
            ok = self.kv_manager.allocate(req, int(meta["pos0"][s]) + 2 * K)
            if ok is None:
                for r, blocks in reversed(allocated):
                    self.kv_manager.release_tail(r, blocks)
                return None
            allocated.append((req, ok))

        bt = meta["block_tables"]
        next_bt = bt
        next_active = meta["active"]
        for (s, sr), fin in zip(zip(rows, scheduled), finishing):
            if sr.request.state is not RequestState.RUNNING or fin:
                # Stopped at an earlier retire, or stopping at its length
                # limit in the in-flight block: a pad row (seq_len 0, no
                # attention, trash-block writes).
                if next_active is meta["active"]:
                    next_active = next_active.copy()
                next_active[s] = False
                continue
            local = np.asarray(sr.request.block_ids, np.int32)
            nb = len(local)
            if nb and bt[s, nb - 1] != local[-1]:
                if next_bt is bt:
                    next_bt = bt.copy()
                next_bt[s, :nb] = local
        next_meta = dict(
            meta,
            last_ids=inflight["ids_dev"][K - 1],   # device tensor, no sync
            pos0=meta["pos0"] + np.int32(K),
            gen0=meta["gen0"] + np.int32(K),
            block_tables=next_bt,
            active=next_active)
        return self._ms_dispatch(next_meta, scheduled, K, rows)

    def _run_multistep(self, sched: SchedulerOutput,
                       K: int) -> List[RequestOutput]:
        meta, ordered, rows = self._ms_meta(sched.scheduled)
        return self._ms_retire(self._ms_dispatch(meta, ordered, K, rows))

    # ---------- speculative decode: the fused mixed round ----------

    def _spec_lookahead(self, req: Request) -> int:
        """Draft tokens worth scheduling for this decode entry (the
        scheduler's spec callback): fresh drafts only, at the tracker's
        adaptive depth, never past ``max_model_len`` nor past the
        request's own ``max_tokens`` (verify work that could never
        emit)."""
        if req.do_remote_decode:
            self._disable_feature("spec_decode", "do_remote_decode")
            return 0
        if req.spec_drafts_at != req.num_tokens or not req.spec_drafts:
            return 0                      # stale or absent: plain decode
        k = min(self.spec_tracker.suggest_k(req.request_id),
                len(req.spec_drafts), self.spec_k)
        k = min(k, self.model_config.max_model_len - req.num_tokens - 1)
        k = min(k, req.sampling.max_tokens - len(req.output_token_ids) - 1)
        return max(0, k)

    def _empty_fused_np(self, T: int, S: int, Q: int,
                        B: int) -> Dict[str, np.ndarray]:
        arrs = self._empty_batch_np(T, S, Q, B)
        del arrs["gen_idx"]     # spec_verify takes gen0 and the verify rows
        K = self.spec_k
        arrs["sample_idx"] = np.zeros(S * (K + 1), np.int32)
        arrs["gen0"] = np.zeros(S, np.int32)
        arrs["draft_tokens"] = np.zeros((S, K), np.int32)
        arrs["spec_n"] = np.zeros(S, np.int32)
        return arrs

    def _fill_fused_batch(self, arrs: Dict[str, np.ndarray],
                          scheduled) -> None:
        """The ragged token layout of a mixed round (each row packs its
        real length: a prefill chunk's n tokens, or a decode row's last
        accepted token and its nd drafts) plus a fixed ``[S*(K+1)]``
        verify-stride ``sample_idx``, whatever the row mix.  A decode
        row's slot q gathers token ``t0 + min(q, nd)`` (slots past nd are
        masked by ``spec_n``); a prefill row's slots all gather its
        chunk's last token (slot 0 is the classic first-token sample);
        pad rows gather token 0 at temperature 0 and are discarded."""
        K = self.spec_k
        Qv = K + 1
        bs = self.config.block_size
        t = 0
        for s, sr in enumerate(scheduled):
            req, n = sr.request, sr.num_new_tokens
            nd = sr.num_draft_tokens
            n_row = n + nd
            p0 = req.num_computed_tokens
            if nd:
                # Decode row: the last accepted token and the live drafts.
                arrs["token_ids"][t] = req.all_token_ids[p0]
                arrs["token_ids"][t + 1:t + n_row] = req.spec_drafts[:nd]
                arrs["draft_tokens"][s, :nd] = req.spec_drafts[:nd]
            else:
                # Plain decode (n == 1) or a prefill chunk.
                arrs["token_ids"][t:t + n_row] = \
                    req.all_token_ids[p0:p0 + n]
            pos = np.arange(p0, p0 + n_row)
            arrs["positions"][t:t + n_row] = pos
            arrs["token_seq_ids"][t:t + n_row] = s
            arrs["token_qpos"][t:t + n_row] = np.arange(n_row)
            blocks = np.asarray(req.block_ids, np.int32)
            arrs["slot_mapping"][t:t + n_row] = \
                blocks[pos // bs] * bs + pos % bs
            arrs["block_tables"][s, :len(blocks)] = blocks
            arrs["seq_lens"][s] = p0 + n_row
            arrs["qtok_idx"][s, :n_row] = np.arange(t, t + n_row)
            if nd:
                arrs["sample_idx"][s * Qv:(s + 1) * Qv] = \
                    t + np.minimum(np.arange(Qv), nd)
            else:
                arrs["sample_idx"][s * Qv:(s + 1) * Qv] = t + n - 1
            sp = req.sampling
            arrs["temperature"][s] = sp.temperature
            arrs["top_k"][s] = sp.top_k
            arrs["top_p"][s] = sp.top_p
            if sp.seed is not None:
                arrs["seeds"][s] = int(sp.seed) & 0x7FFFFFFF
            arrs["gen0"][s] = len(req.output_token_ids)
            arrs["spec_n"][s] = nd
            t += n_row

    _VERIFY_KEYS = ("temperature", "top_k", "top_p", "seeds", "gen0",
                    "draft_tokens", "spec_n")

    def _build_fused_batch(self, scheduled
                           ) -> Tuple[Dict[str, torch.Tensor],
                                      Dict[str, torch.Tensor]]:
        """(device batch of the forward, host verify rows) of a mixed
        round.  T, S and Q bucket as in the JAX engine: drafts are
        budgeted like real tokens, so T covers them."""
        cfg = self.config
        n_rows = [sr.num_new_tokens + sr.num_draft_tokens
                  for sr in scheduled]
        max_q = max(n_rows, default=1)
        Q = 1 if max_q == 1 else _next_bucket(
            max_q, cfg.min_token_bucket, cfg.max_num_batched_tokens)
        S = _next_bucket(len(scheduled),
                         min(cfg.min_seq_bucket, cfg.max_num_seqs),
                         cfg.max_num_seqs)
        T = _next_bucket(sum(n_rows), cfg.min_token_bucket,
                         cfg.max_num_batched_tokens)
        arrs = self._empty_fused_np(T, S, Q, self.max_blocks_per_seq)
        self._fill_fused_batch(arrs, scheduled)
        verify = {k: torch.from_numpy(arrs.pop(k)) for k in self._VERIFY_KEYS}
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in arrs.items()}
        return batch, verify

    def _fused_body(self, batch: Dict[str, torch.Tensor],
                    verify: Dict[str, torch.Tensor], key: prng.Key,
                    want_lp: bool, want_top: bool) -> List[torch.Tensor]:
        """The fused mixed round as a function of tensors (the JAX
        engine's ``fused_fn``): forward over the ragged batch, logits of
        every verify position, ``spec_verify``, the hidden state gathered
        at each row's accepted position, ``draft_propose`` from it and
        the bonus token, and the logprobs of every verify position when
        a row asks for them.  Returns ``[ids [S, K+1], accepted [S],
        drafts [S, K]]`` (+ ``lp [S, K+1]``, + top-20 ids and logprobs
        ``[S, K+1, 20]``), all still on the device."""
        c, K = self.model_config, self.spec_k
        hidden = self.model.forward(
            self.params, self.kv_cache, batch, c, self.config.block_size,
            self.config.attn_backend)                    # [S*(K+1), D]
        logits = self.model.compute_logits(self.params, hidden, c)
        ids, accepted = sampling_ops.spec_verify(
            logits, verify["draft_tokens"], verify["spec_n"],
            verify["temperature"], verify["top_k"], verify["top_p"], key,
            seeds=verify["seeds"], gen0=verify["gen0"],
            fixed_accept=self.config.spec_fixed_accept,
            step=self._step_count)
        S = accepted.shape[0]
        rows = torch.arange(S, device=ids.device)
        h_a = hidden.reshape(S, K + 1, -1)[rows, accepted]
        bonus = ids[rows, accepted]
        drafts = self.model.draft_propose(self.params, self.draft_params,
                                          h_a, bonus, K, c)
        out = [ids, accepted, drafts]
        if want_top:
            out.extend(sampling_ops.verify_logprobs(logits, ids, top_n=20))
        elif want_lp:
            out.append(sampling_ops.verify_logprobs(logits, ids))
        return out

    def _run_fused(self, sched: SchedulerOutput) -> List[RequestOutput]:
        """One fused mixed-round step, whatever the row mix.  Decode rows
        emit their accepted drafts and the correction or bonus token (1
        to K+1 tokens) and trim the rejected tail's blocks back to the
        pool this step; prefill rows advance their chunk with the classic
        bookkeeping and, when the chunk completes the prompt, emit slot
        0's first token and keep the drafts proposed from it, so the
        request's first decode step is already spec-armed.  Logprobs rows
        get one value (and one top-N dict) per emitted token."""
        scheduled = sched.scheduled
        step_t0 = time.monotonic()
        want_top = any((sr.request.sampling.logprobs or 0) > 0
                       for sr in scheduled)
        want_lp = any(sr.request.sampling.logprobs is not None
                      for sr in scheduled)
        batch, verify = self._build_fused_batch(scheduled)
        self._rng, step_key = prng.split(self._rng)
        fetch = self._fused_body(batch, verify, step_key, want_lp, want_top)
        # The step's one host sync: the first copy waits for the device.
        fetched = [t.cpu().numpy() for t in fetch]
        self._dispatch_count += 1
        self._step_count += 1
        self.metrics.engine_dispatches.inc()
        self.metrics.engine_steps.inc()
        ids, accepted, drafts = fetched[:3]
        logprobs = fetched[3] if want_lp else None
        top = (fetched[4], fetched[5]) if want_top else None

        outputs: List[RequestOutput] = []
        now = time.monotonic()
        for s, sr in enumerate(scheduled):
            req, n = sr.request, sr.num_new_tokens
            nd = sr.num_draft_tokens
            # A decode entry has sampled at least one token: a 1-token
            # final prefill chunk is otherwise indistinguishable.
            is_decode = (n == 1 and bool(req.output_token_ids)
                         and req.num_computed_tokens == req.num_tokens - 1)
            if not is_decode:
                # ---- prefill chunk (classic bookkeeping) ----
                req.num_computed_tokens += n
                self.kv_manager.cache_full_blocks(req)
                if req.num_computed_tokens != req.num_tokens:
                    continue          # mid-prefill chunk: sample discarded
                if req.num_computed_tokens <= req.num_prompt_tokens:
                    self._count_prefill_done(req, now)
                elif req.last_token_time is not None:
                    self.metrics.inter_token_latency.observe(
                        now - req.last_token_time)
                req.last_token_time = now
                new_tokens = [int(ids[s, 0])]
                req.output_token_ids.append(new_tokens[0])
                self.metrics.generation_tokens.inc()
                finish = self._check_stop(req, new_tokens[0])
            else:
                # ---- decode row (draft-and-verify bookkeeping) ----
                a = min(int(accepted[s]), nd)
                req.spec_drafted += nd
                req.spec_accepted += a
                if nd:
                    self.metrics.spec_draft_tokens.inc(nd)
                    if a:
                        self.metrics.spec_accepted_tokens.inc(a)
                    self.spec_tracker.observe(req.request_id, nd, a)
                new_tokens = []
                finish = None
                for q in range(a + 1):
                    token = int(ids[s, q])
                    req.num_computed_tokens += 1
                    req.output_token_ids.append(token)
                    new_tokens.append(token)
                    finish = self._check_stop(req, token)
                    if finish is not None:
                        break           # tokens past a stop are discarded
                self.metrics.generation_tokens.inc(len(new_tokens))
                if req.last_token_time is not None:
                    self.metrics.inter_token_latency.observe(
                        (now - req.last_token_time) / len(new_tokens))
                req.last_token_time = now
                self.kv_manager.cache_full_blocks(req)
            top_lp = None
            if top is not None and (req.sampling.logprobs or 0) > 0:
                k = min(int(req.sampling.logprobs), top[0].shape[-1])
                top_lp = [{int(top[0][s, q, j]): float(top[1][s, q, j])
                           for j in range(k)}
                          for q in range(len(new_tokens))]
            outputs.append(RequestOutput(
                req.request_id, new_tokens, finish is not None,
                finish_reason=finish,
                logprobs=([float(logprobs[s, q])
                           for q in range(len(new_tokens))]
                          if req.sampling.logprobs is not None else None),
                top_logprobs=top_lp))
            if finish is not None:
                self.scheduler.finish(req, RequestState(finish))
                self._spec_forget(req.request_id)
                self._count_success(req, finish, now)
                continue
            # The next step's drafts, proposed on the device from this
            # step's accepted position; the tag makes them stale if any
            # other path appends a token first.
            req.spec_drafts = [int(t) for t in drafts[s]]
            req.spec_drafts_at = req.num_tokens
            if is_decode:
                # Rejection rollback: blocks past the accepted content
                # (and the pending token's slot) go back this step.
                self.kv_manager.trim_request(req, req.num_tokens)
        # Step composition: the decode load counts the verify rows.
        decode_load = sched.decode_tokens + sched.spec_tokens
        if sched.prefill_tokens:
            self.metrics.step_prefill_tokens.inc(sched.prefill_tokens)
        if decode_load:
            self.metrics.step_decode_tokens.inc(decode_load)
        self.step_time_model.observe(
            sched.prefill_tokens, decode_load, (now - step_t0) * 1e3)
        self._update_queue_metrics()
        return outputs

    # ---------- step ----------

    def step(self) -> List[RequestOutput]:
        outputs: List[RequestOutput] = list(self._rejected)
        self._rejected.clear()
        if self._inflight is not None:
            # Pipelined decode: queue the successor block on the device
            # first, then retire the in-flight one, so the host's token
            # processing runs while the device computes the successor.
            rec = self._inflight
            nxt = self._ms_try_extend(rec)
            outputs.extend(self._ms_retire(rec))
            self._inflight = nxt
            return outputs
        sched = self.scheduler.schedule()
        sched_now = time.monotonic()
        for sr in sched.scheduled:
            if sr.is_first_schedule and not sr.request.queue_wait_observed:
                sr.request.queue_wait_observed = True
                self.metrics.observe_queue_wait(
                    sr.request.criticality,
                    max(0.0, sched_now - sr.request.arrival_time))
        for req in sched.preempted:      # requests finished by the scheduler
            if req.state is RequestState.FINISHED_DEADLINE:
                self.metrics.inc_deadline_exceeded(req.criticality)
            self._spec_forget(req.request_id)
            outputs.append(RequestOutput(
                req.request_id, [], True, finish_reason=req.state.value))
        if sched.empty:
            self._update_queue_metrics()
            return outputs

        if self.spec_k > 0:
            # Whatever this pass scheduled (prefill chunks, plain decodes,
            # draft-verify rows, logprobs rows) runs as one fused round.
            outputs.extend(self._run_fused(sched))
            return outputs

        K = self._try_multistep(sched)
        if K is not None:
            if self.config.async_scheduling:
                meta, ordered, rows = self._ms_meta(sched.scheduled)
                self._inflight = self._ms_dispatch(meta, ordered, K, rows)
                return outputs    # this block's tokens arrive next step
            outputs.extend(self._run_multistep(sched, K))
            return outputs

        batch, host = self._build_batch(sched)
        scheduled = sched.scheduled
        step_t0 = time.monotonic()
        self._rng, step_key = prng.split(self._rng)
        hidden = self.model.forward(
            self.params, self.kv_cache, batch, self.model_config,
            self.config.block_size, self.config.attn_backend)
        logits = self.model.compute_logits(self.params, hidden,
                                           self.model_config)
        ids = sampling_ops.sample(
            logits, host["temperature"], host["top_k"], host["top_p"],
            key=step_key, seeds=host["seeds"],
            gen_idx=host["gen_idx"])
        want_lp = any(sr.request.sampling.logprobs is not None
                      for sr in scheduled)
        want_top = any((sr.request.sampling.logprobs or 0) > 0
                       for sr in scheduled)
        fetch = [ids]
        if want_top:
            fetch.extend(sampling_ops.compute_top_logprobs(logits, ids))
        elif want_lp:
            fetch.append(sampling_ops.compute_logprobs(logits, ids))
        # The step's one host sync: the first copy waits for the device;
        # the rest are already computed.
        fetched = [t.cpu() for t in fetch]
        self._dispatch_count += 1
        self._step_count += 1
        self.metrics.engine_dispatches.inc()
        self.metrics.engine_steps.inc()
        ids_h = fetched[0].numpy()
        logprobs = fetched[1].numpy() if want_lp else None
        top = ((fetched[2].numpy(), fetched[3].numpy())
               if want_top else None)

        now = time.monotonic()
        for s, sr in enumerate(scheduled):
            req, n = sr.request, sr.num_new_tokens
            req.num_computed_tokens += n
            self.kv_manager.cache_full_blocks(req)
            if req.num_computed_tokens != req.num_tokens:
                continue                  # mid-prefill chunk: no sampling yet
            if req.num_computed_tokens <= req.num_prompt_tokens:
                self._count_prefill_done(req, now)
            elif req.last_token_time is not None:
                self.metrics.inter_token_latency.observe(
                    now - req.last_token_time)
            req.last_token_time = now
            token = int(ids_h[s])
            req.output_token_ids.append(token)
            self.metrics.generation_tokens.inc()
            finish = self._check_stop(req, token)
            top_lp = None
            if top is not None and (req.sampling.logprobs or 0) > 0:
                k = min(int(req.sampling.logprobs), top[0].shape[1])
                top_lp = [{int(top[0][s, j]): float(top[1][s, j])
                           for j in range(k)}]
            outputs.append(RequestOutput(
                req.request_id, [token], finish is not None,
                finish_reason=finish,
                logprobs=([float(logprobs[s])]
                          if req.sampling.logprobs is not None else None),
                top_logprobs=top_lp))
            if finish is not None:
                self.scheduler.finish(req, RequestState(finish))
                self._count_success(req, finish, now)
        # Step composition, from scheduler metadata.
        if sched.prefill_tokens:
            self.metrics.step_prefill_tokens.inc(sched.prefill_tokens)
        if sched.decode_tokens:
            self.metrics.step_decode_tokens.inc(sched.decode_tokens)
        self.step_time_model.observe(
            sched.prefill_tokens, sched.decode_tokens, (now - step_t0) * 1e3)
        self._update_queue_metrics()
        return outputs

    def _count_prefill_done(self, req: Request, now: float) -> None:
        """Prompt, prefix-cache and TTFT counts of a finished prefill."""
        self.metrics.prompt_tokens.inc(req.num_prompt_tokens)
        if req.num_cached_prompt_tokens:
            self.metrics.prefix_cache_hits.inc(req.num_cached_prompt_tokens)
        self.metrics.prefix_cache_queries.inc(req.num_prompt_tokens)
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.time_to_first_token.observe(now - req.arrival_time)

    def _count_success(self, req: Request, finish: str, now: float) -> None:
        self.metrics.request_success.labels(
            model_name=self.metrics.model_name,
            finished_reason=finish).inc()
        self.metrics.e2e_request_latency.observe(now - req.arrival_time)

    def _update_queue_metrics(self) -> None:
        self.metrics.num_requests_waiting.set(self.scheduler.num_waiting)
        self.metrics.num_requests_running.set(self.scheduler.num_running)
        self.metrics.kv_cache_usage_perc.set(self.kv_manager.usage)
        if self.kv_manager.eviction_count > self._last_evictions:
            self.metrics.kv_cache_evictions.inc(
                self.kv_manager.eviction_count - self._last_evictions)
            self._last_evictions = self.kv_manager.eviction_count
        if self.scheduler.num_preemptions > self._last_preemptions:
            self.metrics.preemptions.inc(
                self.scheduler.num_preemptions - self._last_preemptions)
            self._last_preemptions = self.scheduler.num_preemptions

    def _check_stop(self, req: Request, token: int) -> Optional[str]:
        sp = req.sampling
        if not sp.ignore_eos and self.eos_token_id is not None \
                and token == self.eos_token_id \
                and len(req.output_token_ids) >= sp.min_tokens:
            return RequestState.FINISHED_STOPPED.value
        # Engine-side stop strings: decode a tail window (a stop string can
        # span token boundaries).
        if sp.stop and self.tokenizer is not None \
                and len(req.output_token_ids) >= sp.min_tokens:
            max_stop = max(len(s) for s in sp.stop)
            window = req.output_token_ids[-(max_stop + 8):]
            tail = self.tokenizer.decode(window)
            if any(s in tail for s in sp.stop):
                return RequestState.FINISHED_STOPPED.value
        if len(req.output_token_ids) >= sp.max_tokens:
            return RequestState.FINISHED_LENGTH.value
        if req.num_tokens >= self.model_config.max_model_len:
            return RequestState.FINISHED_LENGTH.value
        return None

    # ---------- convenience (tests / smoke) ----------

    def generate(self, requests: List[Request], max_steps: int = 10000
                 ) -> Dict[str, List[int]]:
        """Run requests to completion synchronously; returns output ids."""
        for r in requests:
            self.add_request(r)
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
        return {r.request_id: list(r.output_token_ids) for r in requests}
