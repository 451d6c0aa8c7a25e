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
engine runs it: every step is one fused mixed round (``_run_fused``) or,
with ``num_scheduler_steps`` = N > 1, N fused rounds as one dispatch
(the fused multistep pipeline, ``_fms_*``), pipelined under async
scheduling.  Prefill chunks, plain decodes and K+1-position draft-verify
rows share one forward over the ragged batch; ``spec_verify`` accepts
drafts and samples; the drafter proposes the next drafts from the
accepted position's hidden state; rejected tails go back to the pool at
retire; one batched host fetch per dispatch.  Greedy and seeded output
is the non-spec engine's, token for token.  ``spec_fixed_accept``
(bench only) replaces verification with a seeded coin.  On the card the
single round and each N-round dispatch are CUDA graph replays too.

P/D disaggregation and the tiered prefix cache, as the JAX engine runs
them: a ``kv_connector`` (``transfer/connector.TpuConnector``) makes the
engine a producer (a ``do_remote_decode`` request stops after its
prefill, its blocks pinned and served over the transfer wire until the
consumer pulls them) or a consumer (a request with ``kv_transfer_params``
pulls the producer's blocks, scatters them into fresh local blocks and
recomputes only its last prompt token); ``kv_offload_blocks`` > 0 adds a
host-RAM tier under the device prefix cache (``engine/offload.py``),
shared with peer pods through ``kv_shared_tier_port`` /
``kv_shared_tier_peers``.  The connector is polled at the top of every
step, before an in-flight block is extended or retired; the tier is
flushed at the end of each step.  On the CPU these run against the JAX
package in ``tests/test_torch_pd.py`` and ``tests/test_torch_offload.py``;
on the card ``chip_smoke.py`` path (v) serves ``deepseek-v3-bench``
disaggregated (two engines over the native transport), through the tier,
and as a pair of server processes.

EPLB (``enable_eplb``, ``eplb_config``), as the JAX engine runs it on
one device: the ``parallel/eplb.EplbController`` (ep = 1) installs the
physical expert table into ``params["moe_layers"]``, and every retire
point (the classic step, a decode block, a fused round or an N-round
dispatch) hands it the routed logical ids of the real tokens (pad rows,
rejected drafts and rounds past a stop dropped, with the JAX engine's
masks).  The ids ride the step's one batched host fetch: a decode block
and a fused dispatch write them into a static output of their graph.
A migration's flip writes the serving tensors in place, so captured
graphs stay valid.  ``stub_components`` drops components from every
step body for the attribution sweep; ``kv_cache_hbm_bytes`` sizes the
block pool from a memory budget; ``spec_strict`` refuses to start where
a feature would be demoted at startup.

Tracing (``utils/tracing.py``), as the JAX engine records it: every
request's ``queue``, ``prefill`` (``first_decode`` on a P/D consumer) and
``decode`` phases go into ``llmd_tpu:request_phase_seconds``, and, for a
request that carries a trace context (``Request.trace_ctx``), into
``engine.*`` spans under it; each retire point (the classic step, a
decode block, a fused round or an N-round dispatch) records one
``engine.step`` span parented on its first traced request.  Spans are
stamped from the clock reads that already bracket a dispatch and its
retire, on the host: nothing is added to a step body or a captured
graph, and no host sync.  ``step`` checks the ``engine.step`` fault point
(``utils/faultinject.py``) first, as the JAX engine does.

Tensor and expert parallelism (``mesh=MeshConfig(tp=N)``), as the JAX
engine serves a mesh: every rank of the ranks' process group builds an
``EngineCore`` with the same config; each holds its shard of the model's
``sharding_rules`` and the KV pool of ``kv_cache_spec`` (the MLA latent
replicated, GQA K/V by KV head), and the model runs the collectives
(``parallel/mesh.py``).  Rank 0 owns the requests: every add and abort
goes to the other ranks with the order of the step that sees it
(``parallel.mesh.StepChannel``), together with rank 0's clock for
deadlines; the others run ``follow()``, the same schedule step by step,
and sample the same all-gathered logits with the same keys, so every
rank holds the same tokens.  ``llmd_tpu:collective_bytes_total`` charges
each computed token's EP exchange bytes (the JAX byte model).  Refused
by name on a mesh: DP and SP axes, spec decode, P/D, the host tier,
EPLB at ep > 1, a step-time target, and captured decode blocks where
the collectives cannot be captured (gloo on CUDA); DBO everywhere.
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
from llm_d_tpu_torch.models.llama import local_config
from llm_d_tpu_torch.ops import prng
from llm_d_tpu_torch.ops import sampling as sampling_ops
from llm_d_tpu_torch.ops.moe import DENSE_DISPATCH_MAX_T
from llm_d_tpu_torch.ops.quant import (
    KV_CACHE_DTYPES, KV_SCALE_GRANULARITIES, MLA_LATENT_DTYPES,
    kv_scale_width, quantize_moe_experts)
from llm_d_tpu_torch.parallel.mesh import (Mesh, MeshConfig, StepChannel,
                                           check_served)
from llm_d_tpu_torch.parallel.sharding import (shard_shape, shard_tree,
                                               validate_divisibility)
from llm_d_tpu_torch.utils import tracing
from llm_d_tpu_torch.utils.config import env_choice, env_float, env_int
from llm_d_tpu_torch.utils.device import resolve_device
from llm_d_tpu_torch.utils.faultinject import get_injector
from llm_d_tpu_torch.utils.metrics import EngineMetrics
from llm_d_tpu_torch.utils.predictor import (
    SpecAcceptanceTracker, StepTimeModel)

logger = logging.getLogger(__name__)

SPEC_DECODE_MODES = ("auto", "off")

# Graphs an engine keeps (the least recently used goes first): path
# (iii)'s bench_spec and bench_mixed traffic, the server's mixed requests
# included, captures fewer.
CUDA_GRAPH_MAX_KEYS = 64


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


def kv_block_bytes(layout: Dict[str, int], num_layers: int, block_size: int,
                   kv_cache_dtype: str = "bf16", scale_width: int = 1) -> int:
    """Device bytes one KV block costs across all layers and cache
    buffers, scale planes included."""
    return num_layers * block_size * kv_bytes_per_token(
        layout, kv_cache_dtype, scale_width)


def derive_num_blocks(hbm_budget_bytes: int, layout: Dict[str, int],
                      num_layers: int, block_size: int,
                      kv_cache_dtype: str = "bf16",
                      scale_width: int = 1) -> int:
    """How many paged-KV blocks fit a device-memory budget."""
    per_block = kv_block_bytes(layout, num_layers, block_size,
                               kv_cache_dtype, scale_width)
    return max(hbm_budget_bytes // per_block, 2)


@dataclasses.dataclass
class EngineConfig:
    model: str = "tiny"                      # preset name
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
    # EPLB (MoE models): redundant-expert load balancing (reference:
    # --enable-eplb --eplb-config, decode.yaml:79,100-104).  On one
    # device the placement stays the identity; the routed ids are
    # collected and the imbalance published.
    enable_eplb: bool = False
    eplb_config: Optional[Dict[str, Any]] = None
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
    # Size the block pool from a device-memory budget instead of
    # num_blocks (dtype-aware: an int8 cache fits ~2x the blocks).
    kv_cache_hbm_bytes: Optional[int] = None
    # Attribution harness only: components dropped from every step body
    # ("attn", "moe_ffn", "shared_expert"), so their cost is measured by
    # difference.  Changes the output.
    stub_components: Tuple[str, ...] = ()
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
    # Strict composition (--spec-strict): a feature that would be demoted
    # at startup refuses to start instead.  None resolves
    # LLMD_SPEC_STRICT (default 0).
    spec_strict: Optional[bool] = None
    # Tiered prefix cache: host-RAM blocks surviving device eviction
    # (reference: tiered-prefix-cache/cpu, OffloadingConnector role).
    kv_offload_blocks: int = 0            # 0 = off
    # Cross-pod shared tier (the LMCache role): serve host-tier blocks to
    # peers over a transfer server / consult peers on local miss.
    kv_shared_tier_port: Optional[int] = None   # None = don't serve; 0 = ephemeral
    kv_shared_tier_peers: Tuple[str, ...] = ()  # "host:port" peer servers
    # The mesh this engine is one rank of (None = one device): every rank
    # joins the process group first, then builds an EngineCore with this
    # config (``parallel/launch.py`` starts them).
    mesh: Optional[MeshConfig] = None
    # Permit a mesh smaller than the host's card count (tests / dryruns).
    # Otherwise idle cards are a misconfiguration that fails fast.
    allow_device_subset: bool = False
    # DBO (dual-batch overlap; reference --enable-dbo): refused by name
    # until the port serves it.
    enable_dbo: bool = False

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
        if config.enable_dbo:
            raise ValueError(
                "enable_dbo (dual-batch overlap of the EP exchange with the "
                "expert GEMMs) is not served by the port yet")
        self.model_config = config.resolve_model()
        c = self.model_config
        self.model = get_model(c)
        self.mesh: Optional[Mesh] = None
        if config.mesh is not None and config.mesh.num_devices > 1:
            import torch.distributed as dist
            check_served(config.mesh)
            if not dist.is_initialized():
                raise RuntimeError(
                    f"mesh {config.mesh}: join the ranks' process group "
                    "first (parallel.mesh.init_distributed)")
            self.device = resolve_device(config.device, dist.get_rank())
            self.mesh = Mesh.from_process_group(
                config.mesh, self.device, config.allow_device_subset)
            self._check_cards(config)
        else:
            self.device = resolve_device(config.device)

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
        if config.kv_cache_hbm_bytes:
            # Dtype-aware pool sizing: the same budget holds ~2x the int8
            # blocks.
            derived = derive_num_blocks(
                config.kv_cache_hbm_bytes, self.model.kv_cache_layout(c),
                c.num_layers, config.block_size, self.kv_cache_dtype,
                self.kv_scale_width)
            logger.info("kv pool auto-sized: %d blocks (%s, %.2f GiB "
                        "budget)", derived, self.kv_cache_dtype,
                        config.kv_cache_hbm_bytes / 2**30)
            config = dataclasses.replace(config, num_blocks=derived)
            self.config = config

        if config.quantization == "int8" and not c.is_moe:
            # Serving bf16 weights while the operator believes the
            # experts were quantized is a misconfiguration.
            raise ValueError(
                "quantization='int8' quantizes MoE expert weights; "
                f"model {c.name!r} is dense")
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

        if self.mesh is not None:
            self._check_mesh()
            # Heads that do not divide over tp are refused here, by name.
            local_config(c, self.mesh)
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(config.seed)
            # int8 experts are drawn and quantized plane by plane: no bf16
            # expert stack is ever held (58 GB at qwen3-30b-a3b).  On a
            # mesh each rank keeps its shards of the same draws.
            kw = (dict(quantize_experts=True)
                  if config.quantization == "int8" else {})
            if self.mesh is not None:
                kw["mesh"] = self.mesh
            params = self.model.init_params(c, init_gen, self.device, **kw)
        else:
            if self.mesh is not None:
                # The caller's full tree: this rank's shards.
                rules = self.model.sharding_rules(c)
                problems = validate_divisibility(rules, params, self.mesh)
                if problems:
                    raise ValueError(f"parameters do not shard over "
                                     f"{config.mesh}: {problems}")
                params = shard_tree(params, rules, self.mesh)
            if config.quantization == "int8" \
                    and "w_gate_q" not in params.get("moe_layers", {}):
                # Drops each bf16 stack from the tree as it goes.
                params = quantize_moe_experts(params)
        self.params = params
        # EPLB on the engine's one device (ep = 1): the physical expert
        # table replaces the logical weights (copies the controller owns).
        self.eplb = None
        if config.enable_eplb and c.is_moe:
            from llm_d_tpu_torch.parallel.eplb import (EplbConfig,
                                                       EplbController)
            self.eplb = EplbController(
                c.num_experts, 1, EplbConfig.from_dict(config.eplb_config))
            self.params = self.eplb.install(self.params)

        num_slots = config.num_blocks * config.block_size
        layout = self.model.kv_cache_layout(c)
        specs = self.model.kv_cache_spec(c)
        payload = torch.int8 if self.kv_quantized else torch.bfloat16
        self.kv_cache: Dict[str, torch.Tensor] = {}
        # On a mesh each rank holds its shard of ``kv_cache_spec``; per-head
        # scales shard like the payload's folded head dim, one scale per
        # row is replicated.
        mesh_shape = self.mesh or MeshConfig()
        for name, width in layout.items():
            self.kv_cache[name] = torch.zeros(
                shard_shape((c.num_layers, num_slots, width), specs[name],
                            mesh_shape), dtype=payload, device=self.device)
            if self.kv_quantized:
                s_spec = specs[name] if self.kv_scale_width > 1 else ()
                self.kv_cache[f"{name}_scale"] = torch.zeros(
                    shard_shape((c.num_layers, num_slots,
                                 self.kv_scale_width), s_spec, mesh_shape),
                    dtype=torch.float32, device=self.device)
        self._collective_setup()

        self.max_blocks_per_seq = -(-c.max_model_len // config.block_size)
        # The sampling key, split once per step as the JAX engine splits
        # its own, so unseeded rows draw the JAX package's bits too.
        self._rng = prng.prng_key(config.seed)
        # Engine steps taken and device dispatches made: K steps per
        # dispatch under multistep, one classic.
        self._step_count = 0
        self._dispatch_count = 0
        # Async scheduling: the one in-flight decode block or fused
        # dispatch.
        self._inflight: Optional[Dict[str, Any]] = None
        self._rejected: List[RequestOutput] = []
        self.metrics = EngineMetrics(c.name)
        # Phase and step spans (``_trace_phase``; no-ops for untraced
        # requests, stamped at retire points from clock reads already
        # taken).
        self.tracer = tracing.get_tracer("engine")
        if self.eplb is not None:
            self.eplb.metrics = self.metrics
        # PD producer: finished prefills whose blocks stay pinned until the
        # consumer pulls them (reference contract: README.tpu.md:182-189);
        # a stalled-request abort must wait for them.
        self.pinned_transfers: Dict[str, Request] = {}
        self.scheduler.external_pinned_blocks = lambda: sum(
            len(r.block_ids) for r in self.pinned_transfers.values())
        # Optional KV connector (set by the server / PD wiring).
        self.kv_connector = None
        self.host_tier = None
        if config.kv_offload_blocks > 0:
            from llm_d_tpu_torch.engine.offload import HostKVTier
            self.host_tier = HostKVTier(
                self, config.kv_offload_blocks,
                serve_port=config.kv_shared_tier_port,
                peers=list(config.kv_shared_tier_peers))
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
        self.spec_strict = (bool(config.spec_strict)
                            if config.spec_strict is not None
                            else env_int("LLMD_SPEC_STRICT", 0) != 0)
        blockers = (self._spec_blockers()
                    if spec_mode != "off" and spec_k > 0 else [])
        for blocker in blockers:
            self._disable_feature("spec_decode", blocker, startup=True)
        if spec_mode != "off" and spec_k > 0 and not blockers:
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
        # A mesh: rank 0's orders to the other ranks; every rank reads
        # deadlines against rank 0's clock at the step's order.
        self._channel: Optional[StepChannel] = None
        self._pending_ops: List[Tuple[str, bytes]] = []
        self._followed: Dict[str, Request] = {}
        self._record_followed = True
        if self.mesh is not None:
            self._channel = StepChannel(self.mesh)
            self._step_now = time.monotonic()
            self.scheduler.clock = lambda: self._step_now
        # The CUDA graphs of the decode blocks and of the fused rounds and
        # dispatches (none on the CPU, where their bodies run eagerly):
        # at most CUDA_GRAPH_MAX_KEYS graphs, their pool at most half the
        # card's memory still free beside the weights and the KV pool.
        self._graphs = None
        if self.device.type == "cuda" \
                and (config.num_scheduler_steps > 1 or self.spec_k):
            self._check_capturable()
            self._graphs = DecodeGraphs(
                self.device, max_graphs=CUDA_GRAPH_MAX_KEYS,
                max_pool_bytes=torch.cuda.mem_get_info(self.device)[0] // 2)
        self._last_evictions = 0
        self._last_preemptions = 0
        self.eos_token_id: Optional[int] = None
        # Optional tokenizer enables engine-side stop-string detection.
        self.tokenizer = None

    def _check_capturable(self) -> None:
        """Refuse a configuration whose captured steps would reach a
        host read.  bf16 experts over ``DENSE_DISPATCH_MAX_T`` tokens run
        the grouped plain path, which reads its group sizes to the host;
        a decode block captures up to the row bucket's tokens, a fused
        round up to ``max_num_batched_tokens``."""
        cfg = self.config
        if not self.model_config.is_moe \
                or "w_gate_q" in self.params.get("moe_layers", {}):
            return
        t_max = cfg.max_num_batched_tokens if self.spec_k else _next_bucket(
            cfg.max_num_seqs, cfg.min_token_bucket,
            cfg.max_num_batched_tokens)
        if t_max > DENSE_DISPATCH_MAX_T:
            raise ValueError(
                f"bf16 experts cannot be captured in a CUDA graph over "
                f"{DENSE_DISPATCH_MAX_T} tokens (this configuration "
                f"captures steps of up to {t_max}): use "
                f"quantization='int8', or max_num_batched_tokens <= "
                f"{DENSE_DISPATCH_MAX_T}"
                + ("" if self.spec_k else " or max_num_seqs <= "
                   f"{DENSE_DISPATCH_MAX_T}"))

    def _check_cards(self, config: EngineConfig) -> None:
        """A mesh smaller than the host's card count idles cards: refused
        unless ``allow_device_subset`` (ranks that share one card idle
        none)."""
        if self.device.type != "cuda" or config.allow_device_subset:
            return
        cards = torch.cuda.device_count()
        if cards > config.mesh.num_devices:
            raise ValueError(
                f"mesh {config.mesh} needs {config.mesh.num_devices} "
                f"devices, got {cards}")

    def _check_mesh(self) -> None:
        """Refuse, by name, what this slice does not serve on a mesh."""
        cfg, mesh = self.config, self.mesh
        refused = []
        spec_mode = cfg.spec_decode or env_choice(
            "LLMD_SPEC_DECODE", "auto", SPEC_DECODE_MODES)
        spec_k = (cfg.spec_k if cfg.spec_k is not None
                  else env_int("LLMD_SPEC_K", 0))
        if spec_mode != "off" and spec_k > 0:
            refused.append("spec decode (spec_k > 0) and the fused rounds")
        if cfg.kv_offload_blocks > 0 or cfg.kv_shared_tier_port is not None \
                or cfg.kv_shared_tier_peers:
            refused.append("the host and shared KV tiers")
        if cfg.enable_eplb and mesh.config.ep > 1:
            refused.append(f"EPLB at ep = {mesh.config.ep} (cross-device "
                           "expert migrations)")
        if self._step_time_target_ms > 0:
            refused.append("LLMD_STEP_TIME_TARGET_MS (each rank would size "
                           "its prefill chunks from its own step times)")
        if mesh.stage_host and cfg.num_scheduler_steps > 1:
            refused.append(
                "captured decode blocks (num_scheduler_steps > 1) on a gloo "
                "mesh on CUDA: gloo collectives cannot be captured in a "
                "CUDA graph")
        if refused:
            raise ValueError(f"not served on mesh {mesh.config}: "
                             + "; ".join(refused))

    def _collective_setup(self) -> None:
        """EP wire accounting (the JAX engine's): on a multi-device MoE
        mesh each computed token's k routed copies cross the dispatch and
        combine exchanges once per MoE layer, charged at the resolved
        wire dtype to ``llmd_tpu:collective_bytes_total``; where every
        step runs the psum fallback (ep not a power of two), the
        all-reduce model instead."""
        c = self.model_config
        self._collective_wire = None
        if not c.is_moe or self.mesh is None:
            return
        from llm_d_tpu_torch.parallel.quant_collectives import (
            a2a_row_bytes, psum_bytes_per_token, resolve_collective_dtype)
        self._collective_wire = resolve_collective_dtype(
            backend=self.device.type)
        Lm = c.num_layers - c.first_dense_layers
        ep = self.mesh.config.ep
        if c.num_experts % ep == 0 and ep & (ep - 1) == 0:
            row = a2a_row_bytes(c.hidden_size, self._collective_wire)
            self._a2a_token_bytes = {
                phase: b * c.num_experts_per_tok * Lm
                for phase, b in row.items()}
        else:
            self._a2a_token_bytes = {"allreduce": psum_bytes_per_token(
                c.hidden_size, self._collective_wire) * Lm}

    def _account_collective_bytes(self, n_tokens: int) -> None:
        """Charge ``n_tokens`` computed tokens' EP exchange bytes (no-op
        off the multi-device MoE path)."""
        if self._collective_wire is None or not n_tokens:
            return
        for phase, b in self._a2a_token_bytes.items():
            self.metrics.add_collective_bytes(
                phase, self._collective_wire, n_tokens * b)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        kw = {} if self.mesh is None else dict(mesh=self.mesh)
        return self.model.compute_logits(self.params, hidden,
                                         self.model_config, **kw)

    def _moe_opts(self) -> Optional[Dict[str, Any]]:
        """MoE forward knobs every step body passes: the attribution stubs
        (None on a dense model, and when nothing is stubbed)."""
        if not self.model_config.is_moe or not self.config.stub_components:
            return None
        return dict(stub_components=tuple(self.config.stub_components))

    def _forward(self, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The model forward of a step body: (hidden states of the
        sampling rows, routed logical expert ids ``[Lm, T, k]`` when EPLB
        collects them, else None)."""
        c, cfg = self.model_config, self.config
        args = (self.params, self.kv_cache, batch, c, cfg.block_size,
                cfg.attn_backend)
        opts = self._moe_opts()
        kw = {} if opts is None else dict(moe_opts=opts)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        if self.eplb is None:
            return self.model.forward(*args, **kw), None
        return self.model.forward(*args, collect_routed=True, **kw)

    def _routed_shape(self, T: int) -> Tuple[int, int, int]:
        c = self.model_config
        return (c.num_layers - c.first_dense_layers, T,
                c.num_experts_per_tok)

    # ---------- public API ----------

    def add_request(self, request: Request) -> None:
        if self._channel is not None:
            self._order("add", request)
        if request.do_remote_decode and (
                self.kv_connector is None
                or getattr(self.kv_connector, "server", None) is None):
            # The producer contract needs a serving connector: without one
            # the prefill would pin blocks forever (no release pump).
            logger.error(
                "request %s asks for remote decode but this engine has no "
                "producer-role KV connector; rejecting", request.request_id)
            self._reject(request)
            return
        if request.kv_transfer_params:
            if self.kv_connector is None:
                # A silent local prefill would defeat disaggregation while
                # looking healthy: fail the request loudly instead.
                logger.error(
                    "request %s carries kv_transfer_params but no KV "
                    "connector is configured; rejecting", request.request_id)
                self._reject(request)
                return
            # PD consumer: pull remote KV before the request is schedulable.
            self.kv_connector.start_load_kv(self, request)
            return
        self.scheduler.add_request(request)

    def _reject(self, request: Request) -> None:
        request.state = RequestState.FINISHED_ABORTED
        self._rejected.append(RequestOutput(
            request.request_id, [], True,
            finish_reason=RequestState.FINISHED_ABORTED.value))

    def abort_request(self, request_id: str) -> None:
        if self._channel is not None:
            self._order("abort", request_id)
        self.scheduler.abort_request(request_id)
        self._spec_forget(request_id)
        # Aborting a finished remote prefill (PD producer) frees its pinned
        # blocks, or the usable cache shrinks for good.
        self.release_pinned(request_id)
        if self.kv_connector is not None:
            # Consumer side: the request may only exist as an in-flight KV
            # pull; poll() then drops it instead of admitting it.
            self.kv_connector.abort(request_id)

    # ---------- the ranks of a mesh ----------

    def _order(self, kind: str, arg) -> None:
        """Rank 0 queues an add or abort for the other ranks (sent with
        the next step's order); the other ranks record the requests they
        follow."""
        if self._channel.leader:
            if kind == "add":
                import pickle
                arg = pickle.dumps(dataclasses.replace(arg, trace_ctx=None))
            self._pending_ops.append((kind, arg))
        elif kind == "add" and self._record_followed:
            self._followed[arg.request_id] = arg

    def _send_step(self) -> None:
        """Rank 0: order the other ranks to take this step, with the adds
        and aborts since the last one and rank 0's clock."""
        self._step_now = time.monotonic()
        self._channel.send((self._pending_ops, self._step_now))
        self._pending_ops = []

    def follow(self, record: bool = True) -> Dict[str, List[int]]:
        """A rank other than 0: apply rank 0's orders and take its steps
        until it stops the mesh (:meth:`stop_mesh`).  Returns the output
        ids of every request this rank followed (with ``record``; a
        server's ranks keep none)."""
        import pickle
        if self._channel is None or self._channel.leader:
            raise RuntimeError("follow() runs on the ranks other than 0")
        self._record_followed = record
        self._followed = {}
        while True:
            msg = self._channel.recv()
            if msg is None:
                break
            ops, self._step_now = msg
            for kind, arg in ops:
                if kind == "add":
                    self.add_request(pickle.loads(arg))
                else:
                    self.abort_request(arg)
            self.step()
        return {rid: list(r.output_token_ids)
                for rid, r in self._followed.items()}

    def stop_mesh(self) -> None:
        """Rank 0: end the other ranks' :meth:`follow` loops.  The mesh
        stays whole: steps ordered after this wait for the ranks' next
        :meth:`follow`."""
        if self._channel is not None and self._channel.leader:
            self._channel.send(None)

    def has_work(self) -> bool:
        return (self.scheduler.has_work() or bool(self._rejected)
                or self._inflight is not None or self._connector_pending())

    def release_pinned(self, request_id: str) -> None:
        """Producer side: transfer complete, free the pinned prefill blocks."""
        req = self.pinned_transfers.pop(request_id, None)
        if req is not None:
            self.kv_manager.free(req)

    def _connector_pending(self) -> bool:
        return self.kv_connector is not None and self.kv_connector.has_pending()

    # ---------- feature composition and chunk budgeting ----------

    def _spec_blockers(self) -> List[str]:
        """Startup conditions that would force spec decode off: none, as
        in the JAX engine (spec composes with multistep, async
        scheduling and EPLB).  The one place a future incompatibility is
        declared, so ``_disable_feature`` governs it."""
        return []

    def _disable_feature(self, feature: str, blocker: str,
                         startup: bool = False) -> None:
        """Count a feature demotion (``engine_feature_disabled_total``)
        and log it once; a STARTUP demotion under ``spec_strict`` refuses
        to start instead."""
        self.metrics.inc_feature_disabled(feature, blocker)
        if startup and self.spec_strict:
            raise ValueError(
                f"{feature} requested but unavailable ({blocker}) and "
                f"LLMD_SPEC_STRICT/--spec-strict is set: refusing to "
                f"start with a silently degraded config")
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
        # Under the fused multistep pipeline the funded chunk runs once a
        # round, N rounds between host looks: size it per round.
        rounds = max(1, self.config.num_scheduler_steps) if self.spec_k else 1
        return self.step_time_model.chunk_for(
            decode_tokens, self._step_time_target_ms,
            lo=self.config.min_token_bucket,
            hi=self.config.max_num_batched_tokens, rounds=rounds)

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
                 ids: torch.Tensor, random_rows: bool,
                 routed: Optional[torch.Tensor] = None) -> None:
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
        8-row product rounds otherwise than a 16-row one.

        Under EPLB iteration ``it`` writes its routed logical ids to
        ``routed[it]`` (``[Lm, T, k]``)."""
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
            hidden, r = self._forward(batch)
            if routed is not None:
                routed[it] = r
            logits = self._logits(hidden)
            tok = sampling_ops.sample(
                logits, mb["temperature"], mb["top_k"], mb["top_p"],
                key=(keys[it, 0], keys[it, 1]), seeds=mb["seeds"],
                gen_idx=mb["gen0"] + it, random_rows=random_rows)
            ids[it] = torch.where(active, tok, 0)
            last_ids, pos0 = ids[it], pos0 + 1

    def _ms_static(self, S: int, K: int
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
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
        outputs = dict(ids=z((K, S), i32))
        if self.eplb is not None:
            T = _next_bucket(S, self.config.min_token_bucket,
                             self.config.max_num_batched_tokens)
            outputs["routed"] = z((K,) + self._routed_shape(T), i32)
        return inputs, outputs

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
            if req.do_remote_prefill and not req.output_token_ids:
                # A PD consumer's admitted row recomputes its last prompt
                # token: a 1-token prefill (first-token counts and TTFT in
                # the classic retire); its first decode joins the blocks.
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
        rec = dict(kind="ms", scheduled=list(scheduled), K=K, meta=meta,
                   rows=rows, t0=time.monotonic())
        if self._graphs is None:
            mb = {k: torch.as_tensor(v, device=self.device)
                  for k, v in meta.items()}
            _, out = self._ms_static(S, K)
            ids, routed = out["ids"], out.get("routed")
            self._ms_body(mb, torch.as_tensor(keys, device=self.device),
                          ids, random_rows,
                          **({} if routed is None else dict(routed=routed)))
            # Eager on a card only when its graphs are set aside (a
            # smoke's witness run): the host copy waits for the block.
            rec.update(ids_dev=ids, ids_host=ids.cpu(), done=None,
                       routed_host=None if routed is None else routed.cpu())
        else:
            g = self._graphs.block((S, random_rows),
                                   lambda: self._ms_static(S, K))
            self._graphs.load(g, dict(meta, keys=keys))
            routed = g.outputs.get("routed")
            if g.graph is None:
                self._graphs.capture(
                    g, lambda n: self._ms_body(
                        g.inputs, g.inputs["keys"][:n], g.outputs["ids"][:n],
                        random_rows, **({} if routed is None
                                        else dict(routed=routed[:n]))), K)
            host, done = self._graphs.replay(g)
            rec.update(ids_dev=g.outputs["ids"], ids_host=host["ids"],
                       done=done, routed_host=host.get("routed"))
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
        if self.eplb is not None:
            # The block's real rows only, [K, Lm, T, k] -> the
            # layer-leading [Lm, K*S, k] the tracker takes.
            routed = inflight["routed_host"].numpy()[:, :, inflight["rows"]]
            routed = np.moveaxis(routed, 1, 0)
            self.params = self.eplb.on_step(
                routed.reshape(routed.shape[0], -1, routed.shape[-1]),
                self._step_count, self.params)
        outputs: List[RequestOutput] = []
        now = time.monotonic()
        # The block's step span, from the dispatch's and this retire's
        # clock reads (no sync of its own).
        traced = next((sr.request for sr in scheduled
                       if sr.request.trace_ctx is not None), None)
        if traced is not None:
            self.tracer.record_span(
                "engine.step", self._mono_to_epoch(inflight["t0"]),
                self._mono_to_epoch(now), parent=traced.trace_ctx,
                step=self._step_count, kind="decode", fused=K,
                n_seqs=len(scheduled))
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
            # The block computed all K steps of the row whatever its stop:
            # all K crossed the EP wire.
            self._account_collective_bytes(K)
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
        if self._rejected or self.scheduler.waiting \
                or self._connector_pending():
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
        adaptive depth, so that a dispatch (``num_scheduler_steps``
        rounds, each advancing up to k+1 tokens) never runs past
        ``max_model_len``, and never past the request's own
        ``max_tokens`` (verify work that could never emit)."""
        if req.do_remote_decode:
            self._disable_feature("spec_decode", "do_remote_decode")
            return 0
        if req.spec_drafts_at != req.num_tokens or not req.spec_drafts:
            return 0                      # stale or absent: plain decode
        rounds = max(1, self.config.num_scheduler_steps)
        k = min(self.spec_tracker.suggest_k(req.request_id),
                len(req.spec_drafts), self.spec_k)
        k = min(k, (self.model_config.max_model_len - req.num_tokens)
                // rounds - 1)
        k = min(k, req.sampling.max_tokens - len(req.output_token_ids) - 1)
        return max(0, k)

    def _fused_body(self, batch: Dict[str, torch.Tensor],
                    verify: Dict[str, torch.Tensor], key: prng.Key,
                    want_lp: bool, want_top: bool,
                    random_rows: bool
                    ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """The fused mixed round as a function of tensors (the JAX
        engine's ``fused_fn``): forward over the ragged batch, logits of
        every verify position, ``spec_verify``, the hidden state gathered
        at each row's accepted position, ``draft_propose`` from it and
        the bonus token, and the logprobs of every verify position when
        a row asks for them.  ``verify`` holds the rows' sampling
        parameters, ``gen0``, ``draft_tokens``, ``spec_n``, the round's
        acceptance ``coin [S, K]`` and the ``rate`` (negative: verify).
        Returns ``[ids [S, K+1], accepted [S], drafts [S, K]]`` (+ ``lp
        [S, K+1]``, + top-20 ids and logprobs ``[S, K+1, 20]``) and the
        routed logical ids ``[Lm, T, k]`` under EPLB (else None), all
        still on the device."""
        c, K = self.model_config, self.spec_k
        hidden, routed = self._forward(batch)            # [S*(K+1), D]
        logits = self.model.compute_logits(self.params, hidden, c)
        ids, accepted = sampling_ops.spec_verify(
            logits, verify["draft_tokens"], verify["spec_n"],
            verify["temperature"], verify["top_k"], verify["top_p"], key,
            seeds=verify["seeds"], gen0=verify["gen0"],
            fixed_accept=verify["rate"], coin=verify["coin"],
            random_rows=random_rows)
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
        return out, routed

    # ---------- the fused multistep pipeline ----------

    def _fms_round_batch(self, inp: Dict[str, torch.Tensor], r: int,
                         pos: torch.Tensor, last: torch.Tensor,
                         drafts: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Round ``r``'s forward batch of a fused dispatch: the plan's
        precomputed round ``inp[...][r]`` with the decode rows' token
        ids, positions, slots and ``seq_lens`` patched from the carry
        (``pos``, ``last``, ``drafts``).  A decode row's slot 0 feeds its
        last token, slots 1..nd its drafts; slots past nd and pad tokens
        write block-0 trash.  Tokens past every row's stride are left as
        the plan laid them out (token 0 at position 0, slot 0: the single
        round's pad tokens; the JAX program patches them as row 0's)."""
        K, bs = self.spec_k, self.config.block_size
        bt = inp["block_tables"]
        row = inp["slot_row"].long()
        sq = inp["slot_q"]
        nd, is_dec = inp["spec_n"][r], inp["is_dec"][r]
        patch = is_dec[row] & inp["in_row"]
        qi = (sq.long() - 1).clamp(0, max(K - 1, 0))
        tok_dec = torch.where(sq == 0, last[row], drafts[row, qi])
        pos_t = torch.where(patch, pos[row] + sq, inp["positions"][r])
        dead = inp["dead"][r] | (patch & (sq > nd[row])) \
            | ~inp["active"][row]
        # Dead slots may sit past the table (they write trash anyway).
        page = (pos_t // bs).long().clamp(max=bt.shape[1] - 1)
        slot = bt[row, page] * bs + pos_t % bs
        slot_mapping = torch.where(dead, pos_t % bs, torch.where(
            patch, slot, inp["slot_mapping"][r]))
        seq_lens = torch.where(is_dec, pos + nd + 1, inp["seq_lens"][r])
        return dict(
            token_ids=torch.where(patch, tok_dec, inp["token_ids"][r]),
            positions=pos_t, token_seq_ids=inp["slot_row"], token_qpos=sq,
            slot_mapping=slot_mapping, block_tables=bt,
            seq_lens=torch.where(inp["active"], seq_lens, 0),
            sample_idx=inp["sample_idx"][r], qtok_idx=inp["qtok_idx"][r])

    def _fms_body(self, inp: Dict[str, torch.Tensor],
                  out: Dict[str, torch.Tensor], n: int, want_lp: bool,
                  want_top: bool, random_rows: bool) -> None:
        """``n`` fused mixed rounds of one dispatch (the JAX engine's
        ``fms_fn``, one ``lax.scan`` step a round) as a plain function
        of tensors that never syncs the host: on the card it is what a
        fused graph captures, on the CPU it runs eagerly.  Every round is
        ``_fused_body`` on ``_fms_round_batch``; the carry (``pos``,
        ``last``, ``drafts``, ``gen0``) stays on the device between
        rounds.  Round ``r`` samples with key ``inp["keys"][r]`` and
        accepts by ``inp["coin"][r]`` against ``inp["rate"]``; it writes
        ``out["ids"][r]``, ``out["accepted"][r]`` (and the logprobs, and
        under EPLB the round's routed ids ``out["routed"][r]``), and
        the final carry lands in ``out``'s carry tensors (the inputs are
        left as they were).  Rows are flat ``[S]``: the port has one
        device, so the JAX program's stacked ``[dp, S_l]`` rows do not
        arise."""
        active = inp["active"]
        pos, last, drafts, gen0 = (inp[k] for k in
                                   ("pos", "last", "drafts", "gen0"))
        keys = inp["keys"]
        params = {k: inp[k] for k in ("temperature", "top_k", "top_p",
                                      "seeds")}
        for r in range(n):
            is_dec, comp = inp["is_dec"][r], inp["completing"][r]
            batch = self._fms_round_batch(inp, r, pos, last, drafts)
            res, routed = self._fused_body(
                batch, dict(params, gen0=gen0, draft_tokens=drafts,
                            spec_n=inp["spec_n"][r], coin=inp["coin"][r],
                            rate=inp["rate"]),
                (keys[r, 0], keys[r, 1]), want_lp, want_top, random_rows)
            if routed is not None:
                out["routed"][r] = routed
            ids, accepted, new_drafts = res[:3]
            accepted = accepted.to(torch.int32)
            # Row state: a decode row advances by its accepted prefix and
            # the bonus token; a completing prefill row emits its first
            # token and enters decode spec-armed; a mid-prompt row moves
            # its chunk pointer; inactive rows hold.
            dec = active & is_dec
            emitted = torch.where(dec, accepted + 1,
                                  (active & comp).to(torch.int32))
            sampled = active & (is_dec | comp)
            at = torch.where(is_dec, accepted, 0).long()
            last = torch.where(sampled, ids.gather(1, at[:, None])[:, 0]
                               .to(torch.int32), last)
            drafts = torch.where(sampled[:, None], new_drafts, drafts)
            gen0 = gen0 + emitted
            pos = torch.where(dec, pos + emitted,
                              torch.where(active, inp["next_pos"][r], pos))
            out["ids"][r] = ids
            out["accepted"][r] = accepted
            for name, t in zip(("lp", "top_ids", "top_lps"), res[3:]):
                out[name][r] = t
        for name, t in (("pos", pos), ("last", last), ("drafts", drafts),
                        ("gen0", gen0)):
            out[name].copy_(t)

    def _fms_outputs(self, S: int, T: int, N: int, want_lp: bool,
                     want_top: bool) -> Dict[str, torch.Tensor]:
        """The output tensors of an N-round dispatch over ``S`` rows and
        ``T`` token slots."""
        Qv = self.spec_k + 1

        def z(shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        out = dict(ids=z((N, S, Qv)), accepted=z((N, S)), pos=z(S),
                   last=z(S), drafts=z((S, self.spec_k)), gen0=z(S))
        if want_lp or want_top:
            out["lp"] = z((N, S, Qv), torch.float32)
        if want_top:
            out["top_ids"] = z((N, S, Qv, 20))
            out["top_lps"] = z((N, S, Qv, 20), torch.float32)
        if self.eplb is not None:
            out["routed"] = z((N,) + self._routed_shape(T))
        return out

    def _fms_plan(self, sched: SchedulerOutput,
                  N: int) -> Optional[Dict[str, Any]]:
        """Plan ``N`` fused rounds from one schedule pass (the JAX
        engine's ``_fms_plan``), or None to fall back to a single round.

        Per row: a decode entry runs N draft-verify rounds at its funded
        depth (stride 1+nd: ``_spec_lookahead`` divided the
        ``max_model_len`` headroom by N); a prefill entry consumes its
        prompt in stride-sized chunks (round 0's chunk is the scheduler's)
        and, once complete, continues as decode with up to min(K,
        stride-1) drafts in the same slots.  The worst-case KV tail
        (every draft accepted every round) is allocated here and trimmed
        once a row at retire.  A row that cannot be covered (a
        ``max_model_len`` horizon, pool pressure) bails the whole plan,
        counted in ``engine_feature_disabled_total``.  With N = 1 this
        is the single fused round, which the scheduler already funded."""
        K = self.spec_k
        max_len = self.model_config.max_model_len
        specs: List[Dict[str, Any]] = []
        for sr in sched.scheduled:
            req, n = sr.request, sr.num_new_tokens
            nd = sr.num_draft_tokens
            if req.do_remote_decode and N > 1:
                # A PD producer's row stops after its prefill: the single
                # fused round (N = 1) serves it.
                self._disable_feature("fused_multistep", "do_remote_decode")
                return None
            is_decode = (n == 1 and bool(req.output_token_ids)
                         and req.num_computed_tokens == req.num_tokens - 1)
            computed = req.num_computed_tokens
            rounds: List[Tuple[str, int]] = []
            if is_decode:
                stride = 1 + nd
                rounds = [("dec", nd)] * N
                cover = computed + N * stride
                min_emit = N
            else:
                stride = n
                nd_post = min(K, stride - 1)
                cover = done = computed
                min_emit = 0
                for _ in range(N):
                    left = req.num_tokens - done
                    if left > 0:
                        c_r = min(stride, left)
                        rounds.append(("chunk", c_r))
                        done += c_r
                        if done == req.num_tokens:
                            min_emit += 1       # completion emits 1
                        cover = max(cover, done)
                    else:
                        rounds.append(("dec", nd_post))
                        cover = max(cover, done + nd_post + 1)
                        done += nd_post + 1
                        min_emit += 1
            if cover > max_len:
                self._disable_feature("fused_multistep", "max_model_len")
                return None
            specs.append(dict(req=req, active=True, stride=stride,
                              rounds=rounds, cover=cover, min_emit=min_emit,
                              gen0=len(req.output_token_ids)))
        allocated: List[Tuple[Request, List[int]]] = []
        for spec in specs:
            got = self.kv_manager.allocate(spec["req"], spec["cover"])
            if got is None:
                for r_, blocks in reversed(allocated):
                    self.kv_manager.release_tail(r_, blocks)
                self._disable_feature("fused_multistep", "kv_allocation")
                return None
            allocated.append((spec["req"], got))
        return self._fms_build(specs, N, self._step_count)

    def _fms_build(self, specs: List[Dict[str, Any]], N: int,
                   step_base: int, S: Optional[int] = None
                   ) -> Dict[str, Any]:
        """Host arrays of an N-round dispatch (the JAX engine's
        ``_fms_build`` with one shard): per-row statics (``sbatch``:
        sampling parameters, block tables, the fixed ``slot_row`` /
        ``slot_q`` token layout and ``in_row``, the tokens inside a live
        row's stride), per-round content (``xs``, leading dim N) and the
        initial carry.  Inactive specs keep their row (a successor's
        carry is positional) but add no tokens.  ``S`` pins the row
        bucket of a successor whose carry stays on the device."""
        cfg = self.config
        K = self.spec_k
        Qv = K + 1
        B = self.max_blocks_per_seq
        bs = cfg.block_size
        live = [sp_ for sp_ in specs if sp_["active"]]
        if S is None:
            S = _next_bucket(len(specs),
                             min(cfg.min_seq_bucket, cfg.max_num_seqs),
                             cfg.max_num_seqs)
        T = _next_bucket(sum(sp_["stride"] for sp_ in live)
                         or cfg.min_token_bucket,
                         cfg.min_token_bucket, cfg.max_num_batched_tokens)
        max_q = max((sp_["stride"] for sp_ in live), default=1)
        Q = 1 if max_q == 1 else _next_bucket(
            max_q, cfg.min_token_bucket, cfg.max_num_batched_tokens)
        sb = dict(
            temperature=np.zeros(S, np.float32), top_k=np.zeros(S, np.int32),
            top_p=np.ones(S, np.float32), seeds=np.full(S, -1, np.int32),
            block_tables=np.zeros((S, B), np.int32),
            active=np.zeros(S, bool), slot_row=np.zeros(T, np.int32),
            slot_q=np.zeros(T, np.int32), in_row=np.zeros(T, bool))
        x = dict(
            token_ids=np.zeros((N, T), np.int32),
            positions=np.zeros((N, T), np.int32),
            slot_mapping=np.zeros((N, T), np.int32),
            dead=np.ones((N, T), bool),
            seq_lens=np.zeros((N, S), np.int32),
            sample_idx=np.zeros((N, S * Qv), np.int32),
            qtok_idx=np.full((N, S, Q), T, np.int32),
            spec_n=np.zeros((N, S), np.int32),
            is_dec=np.zeros((N, S), bool),
            completing=np.zeros((N, S), bool),
            next_pos=np.zeros((N, S), np.int32))
        carry = dict(pos=np.zeros(S, np.int32), last=np.zeros(S, np.int32),
                     drafts=np.zeros((S, K), np.int32),
                     gen0=np.zeros(S, np.int32))
        t = 0
        offs = np.zeros(len(specs), np.int64)
        for i, sp_ in enumerate(specs):
            if not sp_["active"]:
                continue
            offs[i] = t
            req, stride = sp_["req"], sp_["stride"]
            sampling = req.sampling
            sb["temperature"][i] = sampling.temperature
            sb["top_k"][i] = sampling.top_k
            sb["top_p"][i] = sampling.top_p
            if sampling.seed is not None:
                sb["seeds"][i] = int(sampling.seed) & 0x7FFFFFFF
            blocks = np.asarray(req.block_ids, np.int32)
            sb["block_tables"][i, :len(blocks)] = blocks
            sb["active"][i] = True
            sb["slot_row"][t:t + stride] = i
            sb["slot_q"][t:t + stride] = np.arange(stride)
            sb["in_row"][t:t + stride] = True
            done = req.num_computed_tokens
            carry["pos"][i] = done
            carry["gen0"][i] = len(req.output_token_ids)
            if sp_["rounds"][0][0] == "dec" and req.output_token_ids:
                carry["last"][i] = req.all_token_ids[done]
                d = req.spec_drafts[:K]
                carry["drafts"][i, :len(d)] = d
            for rno, (kind, val) in enumerate(sp_["rounds"]):
                if kind == "chunk":
                    pos = np.arange(done, done + val)
                    x["token_ids"][rno, t:t + val] = \
                        req.all_token_ids[done:done + val]
                    x["positions"][rno, t:t + val] = pos
                    x["slot_mapping"][rno, t:t + val] = \
                        blocks[pos // bs] * bs + pos % bs
                    x["dead"][rno, t:t + val] = False
                    x["seq_lens"][rno, i] = done + val
                    x["sample_idx"][rno, i * Qv:(i + 1) * Qv] = t + val - 1
                    x["qtok_idx"][rno, i, :val] = np.arange(t, t + val)
                    done += val
                    x["completing"][rno, i] = done == req.num_tokens
                    x["next_pos"][rno, i] = done
                else:
                    used = val + 1
                    x["dead"][rno, t:t + used] = False
                    x["is_dec"][rno, i] = True
                    x["spec_n"][rno, i] = val
                    x["sample_idx"][rno, i * Qv:(i + 1) * Qv] = \
                        t + np.minimum(np.arange(Qv), val)
                    x["qtok_idx"][rno, i, :used] = np.arange(t, t + used)
            t += stride
        return dict(
            kind="fms", N=N, S=S, T=T, Q=Q, step_base=step_base,
            specs=specs, offs=offs, sbatch=sb, xs=x, carry=carry,
            covers={sp_["req"].request_id: sp_["cover"] for sp_ in live})

    def _fms_coins(self, plan: Dict[str, Any]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(coin [N, S, K], rate [1]) of a dispatch: each round's
        fixed-acceptance coin, keyed on its engine step (``accept_coin``
        on the host, so the graph takes it as an input), and the rate,
        read now (-1 verifies; the coin is then unused)."""
        N, S, K = plan["N"], plan["S"], self.spec_k
        rate = self.config.spec_fixed_accept
        if rate is None:
            return np.zeros((N, S, K), np.float32), np.full(1, -1.0,
                                                             np.float32)
        coin = np.stack([sampling_ops.accept_coin(
            plan["step_base"] + r, S, K, "cpu").numpy() for r in range(N)])
        return coin, np.full(1, rate, np.float32)

    def _fms_dispatch(self, plan: Dict[str, Any],
                      carry_dev: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, Any]:
        """Queue one N-round dispatch (N = 1: the single fused round);
        returns the in-flight record without synchronizing (its outputs
        reach the host at retire).  ``carry_dev`` chains a successor from
        its predecessor's device carry.  On the card the dispatch is one
        replay of the graph of its key: every shape the body bakes in
        (rows, tokens, query width, verify stride, block-table width, N,
        the logprobs it returns, any random row)."""
        t0 = time.monotonic()
        live = [sp_ for sp_ in plan["specs"] if sp_["active"]]
        want_top = any((sp_["req"].sampling.logprobs or 0) > 0
                       for sp_ in live)
        want_lp = any(sp_["req"].sampling.logprobs is not None
                      for sp_ in live)
        N, S = plan["N"], plan["S"]
        random_rows = bool((plan["sbatch"]["temperature"] > 0).any())
        self._rng, step_key = prng.split(self._rng)
        # The single round samples with the step key itself, as the JAX
        # engine's fused round does; N rounds with its N splits.
        keys = np.asarray(prng.split(step_key, N) if N > 1 else [step_key],
                          np.int64)
        coin, rate = self._fms_coins(plan)
        values = dict(plan["sbatch"], **plan["xs"], keys=keys, coin=coin,
                      rate=rate, **(carry_dev or plan["carry"]))
        rec = dict(kind="fms", plan=plan, want_lp=want_lp,
                   want_top=want_top, t0=t0)
        if self._graphs is None:
            inp = {k: torch.as_tensor(v, device=self.device)
                   for k, v in values.items()}
            out = self._fms_outputs(S, plan["T"], N, want_lp, want_top)
            self._fms_body(inp, out, N, want_lp, want_top, random_rows)
            rec.update(out_dev=out, done=None,
                       out_host={k: v.cpu() for k, v in out.items()})
        else:
            key = ("fms", S, plan["T"], plan["Q"], self.spec_k + 1,
                   self.max_blocks_per_seq, N, want_lp, want_top,
                   random_rows)
            g = self._graphs.block(key, lambda: (
                {k: torch.empty_like(torch.as_tensor(v), device=self.device)
                 for k, v in values.items()},
                self._fms_outputs(S, plan["T"], N, want_lp, want_top)))
            self._graphs.load(g, values)
            if g.graph is None:
                self._graphs.capture(
                    g, lambda n: self._fms_body(g.inputs, g.outputs, n,
                                                want_lp, want_top,
                                                random_rows), N)
            host, done = self._graphs.replay(g)
            rec.update(out_dev=g.outputs, out_host=host, done=done)
        self._dispatch_count += 1
        self.metrics.engine_dispatches.inc()
        return rec

    def _fms_retire(self, rec: Dict[str, Any],
                    successor: Optional[Dict[str, Any]] = None
                    ) -> List[RequestOutput]:
        """Wait for one fused dispatch and replay its rounds through the
        per-request bookkeeping (the JAX engine's ``_fms_retire``): chunk
        rounds advance prefill (a completing chunk does the first-token
        bookkeeping), decode rounds walk the accepted prefix with the
        stop checks; tokens computed past a stop are discarded.  Each
        row then takes its next drafts from the final carry and gets one
        ``trim_request``: to its content, or with ``successor`` in
        flight to the successor's worst-case cover.  Logprobs rows get
        one value (and one top-N dict) per emitted token."""
        plan = rec["plan"]
        N = plan["N"]
        if rec["done"] is not None:
            # The dispatch's own copy: a successor queued after it runs on.
            rec["done"].synchronize()
        h = {k: v.numpy() for k, v in rec["out_host"].items()}
        ids, acc, drafts_f = h["ids"], h["accepted"], h["drafts"]
        lp = h.get("lp")
        top = (h["top_ids"], h["top_lps"]) if rec["want_top"] else None
        self._step_count += N
        self.metrics.engine_steps.inc(N)

        outputs: List[RequestOutput] = []
        now = time.monotonic()
        pre_toks = dec_toks = total_drafted = total_accepted = 0
        # EPLB: the token slots whose routing counts, round by round.
        valid = (np.zeros((N, plan["T"]), bool)
                 if self.eplb is not None else None)
        for s, sp_ in enumerate(plan["specs"]):
            if not sp_["active"]:
                continue
            req = sp_["req"]
            off = int(plan["offs"][s])
            pre_toks += sum(v for k, v in sp_["rounds"] if k == "chunk")
            dec_toks += sum(v + 1 for k, v in sp_["rounds"] if k == "dec")
            if req.state is not RequestState.RUNNING:
                continue    # finished at an earlier retire or aborted
            new_tokens: List[int] = []
            lp_list: List[float] = []
            top_at: List[Tuple[int, int]] = []
            finish = None
            for rno, (kind, val) in enumerate(sp_["rounds"]):
                if finish is not None:
                    break
                if kind == "chunk":
                    req.num_computed_tokens += val
                    if valid is not None:
                        valid[rno, off:off + val] = True
                    if req.num_computed_tokens != req.num_tokens:
                        continue          # mid-prompt round
                    if req.num_computed_tokens <= req.num_prompt_tokens:
                        self._count_prefill_done(req, now)
                        if req.do_remote_decode:
                            # PD producer: stop here, pin the blocks,
                            # publish the transfer params.
                            outputs.append(self._finish_remote_prefill(
                                req, int(ids[rno, s, 0])))
                            finish = "remote"
                            break
                    token = int(ids[rno, s, 0])
                    req.output_token_ids.append(token)
                    new_tokens.append(token)
                    top_at.append((rno, 0))
                    finish = self._check_stop(req, token)
                    continue
                a = min(int(acc[rno, s]), val)
                if valid is not None:
                    # The accepted prefix and the bonus slot: rejected
                    # drafts' routing must not skew the balance stats,
                    # as their KV is trimmed.
                    valid[rno, off:off + a + 1] = True
                total_drafted += val
                total_accepted += a
                req.spec_drafted += val
                req.spec_accepted += a
                if val:
                    self.metrics.spec_draft_tokens.inc(val)
                    if a:
                        self.metrics.spec_accepted_tokens.inc(a)
                    self.spec_tracker.observe(req.request_id, val, a)
                for q in range(a + 1):
                    token = int(ids[rno, s, q])
                    req.num_computed_tokens += 1
                    req.output_token_ids.append(token)
                    new_tokens.append(token)
                    top_at.append((rno, q))
                    finish = self._check_stop(req, token)
                    if finish is not None:
                        break         # tokens past a stop are discarded
            if finish == "remote":
                self.kv_manager.cache_full_blocks(req)
                continue
            self.metrics.generation_tokens.inc(len(new_tokens))
            if new_tokens:
                if req.last_token_time is not None:
                    self.metrics.inter_token_latency.observe(
                        (now - req.last_token_time) / len(new_tokens))
                req.last_token_time = now
            # The next dispatch's drafts, from the final carry; the tag
            # makes them stale if any other path appends a token first.
            req.spec_drafts = [int(t) for t in drafts_f[s]]
            req.spec_drafts_at = req.num_tokens
            self.kv_manager.cache_full_blocks(req)
            sampling = req.sampling
            top_lp = None
            if top is not None and (sampling.logprobs or 0) > 0:
                k = min(int(sampling.logprobs), top[0].shape[-1])
                top_lp = [{int(top[0][rno, s, q, j]):
                           float(top[1][rno, s, q, j]) for j in range(k)}
                          for rno, q in top_at]
            if new_tokens:
                outputs.append(RequestOutput(
                    req.request_id, new_tokens, finish is not None,
                    finish_reason=finish,
                    logprobs=([float(lp[rno, s, q]) for rno, q in top_at]
                              if sampling.logprobs is not None else None),
                    top_logprobs=top_lp))
            if finish is not None:
                self.scheduler.finish(req, RequestState(finish))
                self._spec_forget(req.request_id)
                self._count_success(req, finish, now)
                continue
            # Rejection rollback, once a dispatch: blocks past the
            # surviving content (and the pending token's slot) go back,
            # except those a successor in flight writes.
            keep = req.num_tokens
            if successor is not None:
                keep = max(keep, successor["plan"]["covers"].get(
                    req.request_id, keep))
            self.kv_manager.trim_request(req, keep)
        if valid is not None:
            routed = h["routed"]                         # [N, Lm, T, k]
            self.params = self.eplb.on_step(np.concatenate(
                [routed[rno][:, np.flatnonzero(valid[rno]), :]
                 for rno in range(N)], axis=1), self._step_count, self.params)
        if pre_toks:
            self.metrics.step_prefill_tokens.inc(pre_toks)
        if dec_toks:
            self.metrics.step_decode_tokens.inc(dec_toks)
        # One sample a round, as the chunk cap sizes chunks per round.
        self.step_time_model.observe(pre_toks / N, dec_toks / N,
                                     (now - rec["t0"]) * 1e3 / N)
        traced = next((sp_["req"] for sp_ in plan["specs"]
                       if sp_["active"] and sp_["req"].trace_ctx is not None),
                      None)
        if traced is not None:
            self.tracer.record_span(
                "engine.step", self._mono_to_epoch(rec["t0"]),
                self._mono_to_epoch(now), parent=traced.trace_ctx,
                step=self._step_count,
                kind=("decode" if pre_toks == 0
                      else "prefill" if dec_toks == 0 else "mixed"),
                spec=True, fused=N,
                n_seqs=sum(1 for sp_ in plan["specs"] if sp_["active"]),
                prefill_tokens=pre_toks, decode_tokens=dec_toks,
                drafted=total_drafted, accepted=total_accepted)
        self._update_queue_metrics()
        return outputs

    def _fms_try_extend(self, rec: Dict[str, Any]
                        ) -> Optional[Dict[str, Any]]:
        """Dispatch the in-flight fused dispatch's successor from its
        device carry (``_ms_try_extend``'s double buffering, the JAX
        engine's ``_fms_try_extend``): rows continue as N decode rounds
        at their last depth, their worst-case tails allocated now.  A
        row still mid-prompt, new arrivals, rejections, an expired
        deadline, pool pressure or a ``max_model_len`` horizon drain the
        pipeline (None), so the next step's schedule pass re-plans."""
        if self._rejected or self.scheduler.waiting \
                or self._connector_pending():
            return None
        plan = rec["plan"]
        N = plan["N"]
        max_len = self.model_config.max_model_len
        next_specs: List[Dict[str, Any]] = []
        for sp_ in plan["specs"]:
            nxt = dict(sp_, active=False)
            next_specs.append(nxt)
            req = sp_["req"]
            if not sp_["active"] or req.state is not RequestState.RUNNING:
                continue
            if req.deadline_expired():
                return None
            if sp_["rounds"][-1][0] != "dec":
                return None     # still mid-prompt after N rounds
            gen_min = sp_["gen0"] + sp_["min_emit"]
            if gen_min >= req.sampling.max_tokens:
                continue        # certain to finish in flight: a pad row
            nd = sp_["rounds"][-1][1]
            cover = sp_["cover"] + N * (nd + 1)
            if cover > max_len:
                return None
            nxt.update(active=True, stride=nd + 1, rounds=[("dec", nd)] * N,
                       cover=cover, gen0=gen_min, min_emit=N)
        if not any(nxt["active"] for nxt in next_specs):
            return None
        allocated: List[Tuple[Request, List[int]]] = []
        for nxt in next_specs:
            if not nxt["active"]:
                continue
            got = self.kv_manager.allocate(nxt["req"], nxt["cover"])
            if got is None:
                for r_, blocks in reversed(allocated):
                    self.kv_manager.release_tail(r_, blocks)
                return None
            allocated.append((nxt["req"], got))
        nplan = self._fms_build(next_specs, N, self._step_count + N,
                                S=plan["S"])
        return self._fms_dispatch(nplan, carry_dev={
            k: rec["out_dev"][k] for k in ("pos", "last", "drafts", "gen0")})

    def _run_fused(self, sched: SchedulerOutput) -> List[RequestOutput]:
        """One fused mixed-round step, whatever the row mix: the fused
        pipeline's one-round dispatch, retired at once.  Decode rows emit
        their accepted drafts and the correction or bonus token (1 to
        K+1 tokens) and trim the rejected tail's blocks back to the pool
        this step; prefill rows advance their chunk and, when the chunk
        completes the prompt, emit slot 0's first token and keep the
        drafts proposed from it, so the request's first decode step is
        already spec-armed."""
        # The scheduler funded this round's tokens: the plan always fits.
        return self._fms_retire(self._fms_dispatch(self._fms_plan(sched, 1)))

    # ---------- step ----------

    def step(self) -> List[RequestOutput]:
        # Chaos fault point: a raised fault is an engine death (the async
        # engine fails every stream, /health turns 500).  Keyed by model
        # name, so a harness can kill one replica of several.
        get_injector().check("engine.step", key=str(self.config.model))
        if self._channel is not None and self._channel.leader:
            if self.kv_connector is not None:
                raise ValueError("P/D (a KV connector) is not served on "
                                 f"mesh {self.mesh.config}")
            self._send_step()
        outputs: List[RequestOutput] = list(self._rejected)
        self._rejected.clear()
        if self.kv_connector is not None:
            # Pump the connector before an in-flight block is extended or
            # retired: admit finished KV pulls (their scatter queued behind
            # the in-flight replay), surface failed ones, release producer
            # pins the consumer acknowledged.
            outputs.extend(self.kv_connector.poll(self))
        if self._inflight is not None:
            # Pipelined decode: queue the successor block on the device
            # first, then retire the in-flight one, so the host's token
            # processing runs while the device computes the successor.
            rec = self._inflight
            if rec["kind"] == "fms":
                nxt = self._fms_try_extend(rec)
                outputs.extend(self._fms_retire(rec, successor=nxt))
            else:
                nxt = self._ms_try_extend(rec)
                outputs.extend(self._ms_retire(rec))
            self._inflight = nxt
            return outputs
        sched = self.scheduler.schedule()
        sched_now = time.monotonic()
        for sr in sched.scheduled:
            if sr.is_first_schedule and not sr.request.queue_wait_observed:
                sr.request.queue_wait_observed = True
                sr.request.first_schedule_time = sched_now
                self.metrics.observe_queue_wait(
                    sr.request.criticality,
                    max(0.0, sched_now - sr.request.arrival_time))
                self._trace_phase(
                    sr.request, "engine.queue", "queue",
                    min(sr.request.arrival_time, sched_now), sched_now)
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
            # draft-verify rows, logprobs rows) runs as one fused round,
            # or with num_scheduler_steps = N > 1 as N rounds in one
            # dispatch, pipelined under async scheduling.
            N = self.config.num_scheduler_steps
            plan = self._fms_plan(sched, N) if N > 1 else None
            if plan is not None:
                rec = self._fms_dispatch(plan)
                if self.config.async_scheduling:
                    self._inflight = rec
                    return outputs   # this dispatch retires next step
                outputs.extend(self._fms_retire(rec))
                return outputs
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
        hidden, routed = self._forward(batch)
        logits = self._logits(hidden)
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
        if routed is not None:
            fetch.append(routed)
        # The step's one host sync: the first copy waits for the device;
        # the rest are already computed.
        fetched = [t.cpu() for t in fetch]
        self._dispatch_count += 1
        self._step_count += 1
        self.metrics.engine_dispatches.inc()
        self.metrics.engine_steps.inc()
        if routed is not None:
            # The real tokens' routing (the bucket's pad rows would skew
            # the load toward the pad token's favorite experts).
            self.params = self.eplb.on_step(
                fetched.pop().numpy()[:, :sched.total_tokens, :],
                self._step_count, self.params)
        ids_h = fetched[0].numpy()
        logprobs = fetched[1].numpy() if want_lp else None
        top = ((fetched[2].numpy(), fetched[3].numpy())
               if want_top else None)

        now = time.monotonic()
        traced = next((sr.request for sr in scheduled
                       if sr.request.trace_ctx is not None), None)
        if traced is not None:
            max_new = max(sr.num_new_tokens for sr in scheduled)
            self.tracer.record_span(
                "engine.step", self._mono_to_epoch(step_t0),
                self._mono_to_epoch(now), parent=traced.trace_ctx,
                step=self._step_count,
                kind="decode" if max_new == 1 else "prefill",
                n_seqs=len(scheduled), n_tokens=sched.total_tokens,
                prefill_tokens=sched.prefill_tokens,
                decode_tokens=sched.decode_tokens, fused=False)
        for s, sr in enumerate(scheduled):
            req, n = sr.request, sr.num_new_tokens
            req.num_computed_tokens += n
            self._account_collective_bytes(n)
            self.kv_manager.cache_full_blocks(req)
            if req.num_computed_tokens != req.num_tokens:
                continue                  # mid-prefill chunk: no sampling yet
            if req.num_computed_tokens <= req.num_prompt_tokens:
                self._count_prefill_done(req, now)
                if req.do_remote_decode:
                    # PD producer: stop here, pin blocks, publish params.
                    outputs.append(self._finish_remote_prefill(
                        req, int(ids_h[s])))
                    continue
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

    def _finish_remote_prefill(self, req: Request,
                               first_token: int) -> RequestOutput:
        """PD producer: the prefill is done; pin the request's blocks, serve
        their KV under the request uuid and answer with the transfer
        params the consumer pulls by."""
        req.state = RequestState.FINISHED_REMOTE_PREFILL
        self.scheduler.running.remove(req)
        self.pinned_transfers[req.request_id] = req
        if self.kv_connector is not None:
            self.kv_connector.register_transfer(self, req)
        params: Dict[str, Any] = {
            "remote_block_ids": list(req.block_ids),
            "remote_host": getattr(self.kv_connector, "host", "localhost"),
            "remote_port": getattr(self.kv_connector, "port", 0),
            "uuid": req.request_id,
            "first_token": first_token,
        }
        req.kv_transfer_params = params
        return RequestOutput(
            req.request_id, [first_token], True,
            finish_reason=RequestState.FINISHED_REMOTE_PREFILL.value,
            kv_transfer_params=params)

    def _count_prefill_done(self, req: Request, now: float) -> None:
        """Prompt, prefix-cache and TTFT counts of a finished prefill, and
        its phase (a P/D consumer's one local token is the first-decode
        leg of the TTFT split)."""
        self.metrics.prompt_tokens.inc(req.num_prompt_tokens)
        if req.num_cached_prompt_tokens:
            self.metrics.prefix_cache_hits.inc(req.num_cached_prompt_tokens)
        self.metrics.prefix_cache_queries.inc(req.num_prompt_tokens)
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.time_to_first_token.observe(now - req.arrival_time)
            self._trace_phase(
                req, "engine.prefill",
                "first_decode" if req.do_remote_prefill else "prefill",
                req.first_schedule_time or req.arrival_time, now,
                cached_tokens=req.num_cached_prompt_tokens or None,
                resume_offset=req.resume_offset or None,
                restored_tokens=req.resume_restored_tokens or None)

    def _count_success(self, req: Request, finish: str, now: float) -> None:
        self.metrics.request_success.labels(
            model_name=self.metrics.model_name,
            finished_reason=finish).inc()
        self.metrics.e2e_request_latency.observe(now - req.arrival_time)
        self._trace_phase(
            req, "engine.decode", "decode", req.first_token_time or now, now,
            n_tokens=len(req.output_token_ids), finish=finish)

    @staticmethod
    def _mono_to_epoch(mono: float) -> float:
        """Engine-clock (monotonic) stamp -> epoch, for spans recorded
        after the fact (request stamps live on the monotonic clock)."""
        return time.time() - (time.monotonic() - mono)

    def _trace_phase(self, req: Request, name: str, phase: str,
                     start_mono: float, end_mono: float, **attrs) -> None:
        """Observe one request phase in ``request_phase_seconds`` and, for
        a traced request, record its span."""
        self.metrics.observe_phase(phase, req.criticality,
                                   end_mono - start_mono)
        if req.trace_ctx is None:
            return
        self.tracer.record_span(
            name, self._mono_to_epoch(start_mono),
            self._mono_to_epoch(end_mono), parent=req.trace_ctx,
            request_id=req.request_id, phase=phase, **attrs)

    def _update_queue_metrics(self) -> None:
        if self.host_tier is not None:
            # One device->host copy for all blocks cached this step.
            self.host_tier.flush()
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
            if not self.scheduler.has_work() and self.has_work():
                time.sleep(0.001)   # only async connector work pending
        return {r.request_id: list(r.output_token_ids) for r in requests}
