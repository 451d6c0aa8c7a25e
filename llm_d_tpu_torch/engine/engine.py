"""EngineCore: the serving engine on one device (port of the classic
single-device step of ``llm_d_tpu.engine.engine``).

Owns the device state (parameters and the paged KV cache), turns
scheduler output into bucketed ragged batches, runs one forward + sample
per step, and advances request state.  The model runs eagerly; the
step's one host sync is the fetch of the sampled ids.

Not ported yet (later slices): multistep and async scheduling,
speculative decode, fused mixed rounds, EPLB, KV offload, the KV
connector, metrics and tracing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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
from llm_d_tpu_torch.utils.config import env_choice
from llm_d_tpu_torch.utils.device import resolve_device


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
    # MoE expert-weight quantization: "int8" or None.
    quantization: Optional[str] = None
    # Paged-KV cache dtype: "bf16" or "int8" (None = bf16).
    kv_cache_dtype: Optional[str] = None
    # int8 scale granularity of a dense cache: "token" (one f32 scale per
    # row) or "head" (one per KV head).  None resolves LLMD_KV_SCALE_GRAN
    # (default "token").  MLA's latent row always has one scale.
    kv_scale_granularity: Optional[str] = None
    # MLA latent dtype gate: "auto" follows kv_cache_dtype; "bf16"/"int8"
    # pin it (None = auto).
    mla_latent_dtype: Optional[str] = None
    # None = the first CUDA device (raises without one); "cpu" must be
    # asked for explicitly.
    device: Optional[str] = None

    def resolve_model(self) -> ModelConfig:
        return self.model_config or get_config(self.model)


class EngineCore:
    def __init__(self, config: EngineConfig,
                 params: Optional[Dict[str, Any]] = None) -> None:
        """``params`` (e.g. from ``models.convert.params_from_numpy``) must
        already live on the engine's device; ``None`` random-initializes
        from ``config.seed``."""
        self.config = config
        self.device = resolve_device(config.device)
        self.model_config = config.resolve_model()
        c = self.model_config
        self.model = get_model(c)

        self.kv_cache_dtype = config.kv_cache_dtype or "bf16"
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"unknown kv_cache_dtype {self.kv_cache_dtype!r}"
                             f" (choices: {KV_CACHE_DTYPES})")
        latent = config.mla_latent_dtype or "auto"
        if latent not in MLA_LATENT_DTYPES:
            raise ValueError(f"unknown mla_latent_dtype {latent!r} "
                             f"(choices: {MLA_LATENT_DTYPES})")
        if latent != "auto" and c.use_mla:
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

        self.kv_manager = KVCacheManager(
            config.num_blocks, config.block_size,
            enable_prefix_caching=config.enable_prefix_caching)
        self.scheduler = Scheduler(
            self.kv_manager,
            max_num_seqs=config.max_num_seqs,
            max_num_batched_tokens=config.max_num_batched_tokens,
            max_model_len=c.max_model_len)

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
        self._rejected: List[RequestOutput] = []
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

    def has_work(self) -> bool:
        return self.scheduler.has_work() or bool(self._rejected)

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

    # ---------- step ----------

    def step(self) -> List[RequestOutput]:
        outputs: List[RequestOutput] = list(self._rejected)
        self._rejected.clear()
        sched = self.scheduler.schedule()
        for req in sched.preempted:      # requests finished by the scheduler
            outputs.append(RequestOutput(
                req.request_id, [], True, finish_reason=req.state.value))
        if sched.empty:
            return outputs

        batch, host = self._build_batch(sched)
        scheduled = sched.scheduled
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
                if req.first_token_time is None:
                    req.first_token_time = now
            req.last_token_time = now
            token = int(ids_h[s])
            req.output_token_ids.append(token)
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
        return outputs

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
