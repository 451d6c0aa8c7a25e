"""KV connector: P->D disaggregation's engine-side halves (port of
``llm_d_tpu.transfer.connector``; the same wire, so a port engine and a
JAX engine serve each other).

Mirrors the reference's vLLM KV-connector contract
(``--kv-transfer-config '{"kv_connector":"TPUConnector","kv_role":...}'``,
ms-pd/values_tpu.yaml:44,131; response params README.tpu.md:182-189):

  producer ("kv_producer"/"kv_both"): after a ``do_remote_decode`` prefill
    the engine pins the request's blocks; the connector gathers their KV
    (one ``index_select`` a cache buffer and one copy to the host) and
    registers the host slab with the native transfer server under the
    request uuid.  The response's ``kv_transfer_params`` advertises
    {remote_block_ids, remote_host, remote_port, uuid}.

  consumer ("kv_consumer"/"kv_both"): a request arriving with
    ``kv_transfer_params`` is diverted before scheduling; a worker thread
    fetches the slab, then the engine thread allocates local blocks,
    scatters the KV in, marks all but the last prompt token computed, and
    enqueues the request: only the final prompt token is recomputed
    locally to produce sampling logits.

The scatter writes the cache tensors in place (``index_copy_`` on a block
view): the engine's CUDA graphs captured those tensors, so rebinding
``engine.kv_cache[name]`` would leave every captured decode block reading
the old memory.  It is queued on the current stream behind any in-flight
graph replay, from pinned host memory, and the host does not wait for it.

``kv_load_failure_policy`` follows decode.yaml:96: "fail" aborts the request
loudly; "recompute" falls back to a full local prefill.

On a ``dp x tp`` mesh (the JAX package's stacked caches) a request's
blocks lie in its KV region's plane, on that region's ranks (``[L, slots
/ dp, W]``, W split over tp where the cache shards), and the connector,
its transport server and the scheduler are rank 0's.  The producer's
gather runs on every rank at the retire that finishes the prefill: the
request's region gathers its tp shards and its first rank sends the rows
to rank 0.  The consumer's admission (``EngineCore.admit_pulled``, on
every rank) rides rank 0's step order, so every rank allocates the same
blocks, and at the top of that step rank 0 sends the slab to the
region's ranks, which write their shard of it.  Neither runs on a connector thread.  The
wire is the one-device engine's, so a mesh and one device serve each
other both ways.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_d_tpu_torch.engine.request import Request, RequestOutput, RequestState
from llm_d_tpu_torch.transfer import transport
from llm_d_tpu_torch.utils import tracing
from llm_d_tpu_torch.utils.config import env_float, env_int
from llm_d_tpu_torch.utils.faultinject import FaultInjected, get_injector

logger = logging.getLogger(__name__)

_MAGIC = 0x4B565442  # "KVTB"
# Wire version 2 (kv_cache_dtype era): every buffer segment carries a
# dtype code so a consumer REJECTS a producer whose cache dtype differs
# (a bf16 decoder must never silently reinterpret an int8+scales slab --
# wrong page bytes would decode as garbage attention, not an error).
_WIRE_VERSION = 2
# magic, version, num_layers, block_size, num_buffers, nb
_HEADER = struct.Struct("<IIIIII")
_BUF_HEADER = struct.Struct("<IB")   # (row width, dtype code) per segment


@dataclasses.dataclass
class KVConnectorConfig:
    kv_role: str = "kv_both"            # kv_producer | kv_consumer | kv_both
    host: str = "127.0.0.1"             # address advertised to consumers
    port: int = 0                        # 0 = ephemeral
    kv_load_failure_policy: str = "fail"  # fail | recompute
    timeout_ms: int = 30000
    # Producer-side safety valve: pinned blocks whose consumer never pulled
    # are released after this long (an engine must not leak cache to a
    # dead peer).
    pin_timeout_s: float = 120.0
    # Consumer-side retry budget BEFORE kv_load_failure_policy applies: a
    # transient drop costs one short backoff instead of an abort or a full
    # local recompute.
    pull_retries: int = dataclasses.field(
        default_factory=lambda: env_int("LLMD_KV_PULL_RETRIES", 2))
    pull_backoff_s: float = dataclasses.field(
        default_factory=lambda: env_float("LLMD_KV_PULL_BACKOFF_S", 0.05))


class TpuConnector:
    """Both halves of the P->D transfer, bound to one EngineCore.  The
    name is the reference contract's (``"kv_connector": "TPUConnector"``),
    kept on the GPU so a deployment's transfer config carries over."""

    def __init__(self, config: KVConnectorConfig) -> None:
        self.config = config
        self.host = config.host
        self.server = None
        self.port = 0
        if config.kv_role in ("kv_producer", "kv_both"):
            self.server = transport.make_server("0.0.0.0", config.port)
            self.port = self.server.port
        # consumer side: fetches finished by worker threads, drained by the
        # engine thread in poll().
        self._loaded: "queue.Queue[Tuple[Request, Optional[bytes], Optional[str], float]]" = (
            queue.Queue())
        self._inflight = 0
        self._inflight_mu = threading.Lock()
        self._retry: List[Tuple[Request, bytes]] = []
        self._pin_times: Dict[str, float] = {}
        # Requests aborted while their KV pull was in flight: dropped at
        # poll() instead of being admitted for a disconnected client.
        # Only ids with a live pull are tracked.
        self._aborted: set = set()
        self._pending_ids: set = set()
        # request_id -> (host, port, uuid) for pulls that may still hold a
        # PRODUCER pin: cancellation sends the release so the producer's
        # blocks free immediately instead of waiting out its pin timeout.
        self._pending_params: Dict[str, Tuple[str, int, str]] = {}

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------

    def register_transfer(self, engine, req: Request) -> None:
        """Gather the pinned blocks' KV to host and serve them under the
        uuid.  The gather blocks the engine thread: a ``do_remote_decode``
        row runs no multistep block or fused plan, so nothing is in flight
        behind it."""
        assert self.server is not None, \
            "register_transfer on a consumer-only connector"
        blob = _pack_blocks(engine, req.block_ids)
        self.server.register(req.request_id, blob)
        self._pin_times[req.request_id] = time.monotonic()
        tracing.trace_event("engine", "kv.stage", parent=req.trace_ctx,
                            request_id=req.request_id, bytes=len(blob),
                            blocks=len(req.block_ids))

    def _poll_producer(self, engine) -> None:
        if self.server is None:
            return
        for uuid in self.server.drain_released():
            self._pin_times.pop(uuid, None)
            engine.release_pinned(uuid)
        if self._pin_times:
            now = time.monotonic()
            expired = [u for u, t in self._pin_times.items()
                       if now - t > self.config.pin_timeout_s]
            for uuid in expired:
                logger.warning("pinned transfer %s expired; releasing", uuid)
                self._pin_times.pop(uuid, None)
                self.server.unregister(uuid)
                engine.release_pinned(uuid)

    # ------------------------------------------------------------------
    # consumer side
    # ------------------------------------------------------------------

    def start_load_kv(self, engine, req: Request) -> None:
        """Begin the remote pull; the request joins the scheduler via poll()."""
        params = req.kv_transfer_params or {}
        with self._inflight_mu:
            self._inflight += 1
            self._pending_ids.add(req.request_id)
            try:
                self._pending_params[req.request_id] = (
                    str(params["remote_host"]), int(params["remote_port"]),
                    str(params.get("uuid", req.request_id)))
            except (KeyError, TypeError, ValueError):
                pass    # malformed params fail in the fetch worker anyway
        threading.Thread(
            target=self._fetch_worker, args=(req, params),
            name=f"kv-pull-{req.request_id[:8]}", daemon=True).start()

    def _fetch_worker(self, req: Request, params: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        wall0 = time.time()
        blob: Optional[bytes] = None
        error: Optional[str] = None
        retries = max(0, self.config.pull_retries)
        try:
            # Malformed params are PERMANENT: fail straight to policy, no
            # retry/backoff (only transport-level failures are transient).
            host = params["remote_host"]
            port = int(params["remote_port"])
            uuid = params.get("uuid", req.request_id)
        except (KeyError, TypeError, ValueError) as e:
            self._loaded.put((req, None, f"{type(e).__name__}: {e}",
                              time.perf_counter() - t0))
            return
        for attempt in range(retries + 1):
            error = None
            try:
                get_injector().check("kv.pull", key=f"{host}:{port}")
                blob = transport.fetch(host, port, uuid,
                                       timeout_ms=self.config.timeout_ms)
            except (transport.TransferNotFound, KeyError) as e:
                # Slab absent on a REACHABLE producer: the pin expired or
                # the uuid is stale -- permanent.
                error = f"{type(e).__name__}: {e}"
                break
            except (transport.TransferError, OSError, ValueError,
                    FaultInjected) as e:
                error = f"{type(e).__name__}: {e}"
                if attempt < retries:
                    logger.warning(
                        "kv pull for %s failed (%s); retry %d/%d",
                        req.request_id, error, attempt + 1, retries)
                    tracing.trace_event(
                        "engine", "kv.pull_retry", parent=req.trace_ctx,
                        request_id=req.request_id, attempt=attempt + 1,
                        error=error)
                    time.sleep(self.config.pull_backoff_s * (2 ** attempt))
                continue
            try:
                # The slab is on this host now; free the producer at once.
                # A failed release must NOT fail the load: the producer's
                # pin timeout reclaims the blocks.
                transport.release(host, port, uuid,
                                  timeout_ms=self.config.timeout_ms)
            except (transport.TransferError, OSError, ValueError) as e:
                logger.warning("kv release for %s failed (%s); producer "
                               "pin timeout will reclaim", req.request_id, e)
            break
        # P->D wire span (phase "transfer"), with the byte count.
        tracing.get_tracer("engine").record_span(
            "kv.transfer", wall0, time.time(), parent=req.trace_ctx,
            request_id=req.request_id, phase="transfer",
            bytes=len(blob) if blob else 0,
            source=f"{host}:{port}", error=error)
        self._loaded.put((req, blob, error, time.perf_counter() - t0))

    def abort(self, request_id: str) -> None:
        """Mark an in-flight pull's request aborted (dropped at poll) and
        release the PRODUCER's pinned blocks eagerly."""
        with self._inflight_mu:
            if request_id not in self._pending_ids:
                return
            self._aborted.add(request_id)
            remote = self._pending_params.get(request_id)
        if remote is not None:
            self._release_remote(request_id, remote)

    def _release_remote(self, request_id: str,
                        remote: Tuple[str, int, str]) -> None:
        """Best-effort producer release off the engine thread (the
        producer's pin timeout is the backstop when this fails)."""
        host, port, uuid = remote

        def _release():
            try:
                transport.release(host, port, uuid,
                                  timeout_ms=self.config.timeout_ms)
            except (transport.TransferError, OSError, ValueError) as e:
                logger.warning(
                    "cancel-release for %s failed (%s); producer pin "
                    "timeout will reclaim", request_id, e)
        threading.Thread(target=_release,
                         name=f"kv-cancel-{request_id[:8]}",
                         daemon=True).start()

    @property
    def num_pending_loads(self) -> int:
        """In-flight and retry-parked KV pulls: load the scheduler cannot
        see yet (a DP group's dispatcher counts these, or every P/D
        request would pile onto one rank while its pulls are in
        flight)."""
        with self._inflight_mu:
            return self._inflight + len(self._retry)

    def has_pending(self) -> bool:
        with self._inflight_mu:
            if self._inflight > 0:
                return True
        return bool(self._retry) or bool(self._pin_times)

    def poll(self, engine) -> List[RequestOutput]:
        """Engine-thread pump: finish loads, admit requests, drain releases."""
        self._poll_producer(engine)
        outputs: List[RequestOutput] = []

        ready: List[Tuple[Request, bytes]] = list(self._retry)
        self._retry.clear()
        while True:
            try:
                req, blob, error, dt = self._loaded.get_nowait()
            except queue.Empty:
                break
            with self._inflight_mu:
                self._inflight -= 1
                self._pending_ids.discard(req.request_id)
                self._pending_params.pop(req.request_id, None)
            if req.request_id in self._aborted:
                self._aborted.discard(req.request_id)
                req.state = RequestState.FINISHED_ABORTED
                continue
            if error is not None or blob is None:
                outputs.extend(self._load_failed(engine, req, error or "empty"))
                continue
            engine.metrics.kv_transfer_time.observe(dt)
            engine.metrics.observe_phase("transfer", req.criticality, dt)
            ready.append((req, blob))
        if self._aborted:
            dropped = [r for r, _ in ready if r.request_id in self._aborted]
            for r in dropped:
                r.state = RequestState.FINISHED_ABORTED
                self._aborted.discard(r.request_id)
                with self._inflight_mu:
                    self._pending_ids.discard(r.request_id)
            ready = [(r, b) for r, b in ready
                     if r.state is not RequestState.FINISHED_ABORTED]

        for req, blob in ready:
            with self._inflight_mu:
                self._pending_ids.discard(req.request_id)
            if req.deadline_expired():
                # Budget blew while the KV slab was in flight / parked:
                # drop before allocating a single local block.
                req.state = RequestState.FINISHED_DEADLINE
                engine.metrics.inc_deadline_exceeded(req.criticality)
                outputs.append(RequestOutput(
                    req.request_id, [], True,
                    finish_reason=RequestState.FINISHED_DEADLINE.value))
                continue
            out = self._admit(engine, req, blob)   # re-adds if retried
            if out is not None:
                outputs.append(out)
        return outputs

    def _admit(self, engine, req: Request, blob: bytes) -> Optional[RequestOutput]:
        """Hand the fetched KV to the engine (``EngineCore.admit_pulled``:
        local blocks, the scatter, the scheduler); park it for the next
        poll under cache pressure, or apply the failure policy to a slab
        the cache cannot take."""
        try:
            admitted = engine.admit_pulled(req, blob)
        except (ValueError, struct.error) as e:
            return_list = self._load_failed(engine, req, f"bad slab: {e}")
            return return_list[0] if return_list else None
        if not admitted:
            # Cache pressure: hold the slab and retry next poll (the blocks
            # will free as running requests finish). Still abortable.
            self._retry.append((req, blob))
            with self._inflight_mu:
                self._pending_ids.add(req.request_id)
        return None

    def _load_failed(self, engine, req: Request, error: str
                     ) -> List[RequestOutput]:
        if self.config.kv_load_failure_policy == "recompute":
            logger.warning("kv load failed for %s (%s); recomputing locally",
                           req.request_id, error)
            req.do_remote_prefill = False
            req.kv_transfer_params = None
            engine.readmit(req)
            return []
        logger.error("kv load failed for %s: %s", req.request_id, error)
        req.state = RequestState.FINISHED_ABORTED
        return [RequestOutput(req.request_id, [], True,
                              finish_reason=RequestState.FINISHED_ABORTED.value)]

    def close(self) -> None:
        if self.server is not None:
            self.server.close()


# ---------------------------------------------------------------------------
# Device <-> host slab marshalling: gather and scatter the [L, slots, W]
# cache buffers at whole-block granularity, each through a [L, nb, bs, W]
# view of the buffer (plain PyTorch; the JAX version is jitted XLA, not a
# Pallas kernel).
# ---------------------------------------------------------------------------

def _cache_items(engine) -> List[Tuple[str, torch.Tensor]]:
    """Deterministically ordered cache buffers ({k, v} dense, {kv} MLA,
    with their ``*_scale`` planes on int8 caches)."""
    return sorted(engine.kv_cache.items())


def _blocks(buf: torch.Tensor, bs: int) -> torch.Tensor:
    """``[L, slots, W]`` -> the ``[L, blocks, bs, W]`` view of the same
    memory."""
    L, slots, W = buf.shape
    return buf.view(L, slots // bs, bs, W)


def to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the stream: on a
    card the copy goes through pinned memory, queued in stream order."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def block_ids_on(device: torch.device, block_ids: Sequence[int]) -> torch.Tensor:
    return to_device(torch.tensor(list(block_ids), dtype=torch.long), device)


def _local_blocks(engine, block_ids: Sequence[int]) -> Tuple[int, List[int]]:
    """Global block ids of one request -> (its KV region, the ids in the
    region's plane); region 0 and the ids themselves off dp."""
    km = engine.kv_manager
    regions = {km.region_of_block(b) for b in block_ids} or {0}
    if len(regions) != 1:
        raise ValueError(f"transfer blocks span KV regions {sorted(regions)}")
    r = regions.pop()
    return r, [b - r * km.blocks_per_region for b in block_ids]


def _tp_sharded(engine, name: str) -> bool:
    """Whether cache buffer ``name`` splits its row width over tp on the
    engine's mesh (GQA K/V, and per-head scales beside them)."""
    mesh = engine.mesh
    if mesh is None or mesh.axis_size("tp") == 1:
        return False
    spec = engine.model.kv_cache_spec(engine.model_config).get(
        name.replace("_scale", ""), ())
    if name.endswith("_scale") and engine.kv_scale_width <= 1:
        return False
    return "tp" in spec


def gather_blocks(engine, block_ids: Sequence[int]
                  ) -> List[Tuple[str, torch.Tensor]]:
    """Every cache buffer's rows of ``block_ids``, on the device:
    ``[(name, [L, nb, bs, W])]`` in wire order.  On a mesh a collective
    of the request's region and rank 0, which every rank calls: the
    region's ranks gather their tp shards where the buffer shards, and
    the region's first rank sends the rows to rank 0 (region 0's first);
    the rows are rank 0's, an empty list elsewhere."""
    from llm_d_tpu_torch.parallel.mesh import AXIS_TP
    r, local = _local_blocks(engine, block_ids)
    ids = block_ids_on(engine.device, local)
    bs = engine.config.block_size
    mesh = engine.mesh
    if mesh is None:
        return [(name, _blocks(buf, bs).index_select(1, ids))
                for name, buf in _cache_items(engine)]
    here = engine.dp_index == r
    first = mesh.region_ranks(r)[0]
    if not here and mesh.rank != 0:
        return []
    out = []
    for name, buf in _cache_items(engine):
        sharded = _tp_sharded(engine, name)
        rows = None
        if not here:
            width = buf.shape[2] * (mesh.axis_size(AXIS_TP) if sharded
                                    else 1)
            rows = mesh.recv((buf.shape[0], len(local), bs, width),
                             buf.dtype, first)
        elif sharded or mesh.rank == first:
            rows = _blocks(buf, bs).index_select(1, ids)
            if sharded:
                rows = mesh.all_gather(rows, AXIS_TP, dim=3)
            if mesh.rank == first and first != 0:
                mesh.send(rows, 0)
        out.append((name, rows))
    return out if mesh.rank == 0 else []


def scatter_block_rows(engine, name: str, block_ids: torch.Tensor,
                       rows: torch.Tensor) -> None:
    """Write ``rows [L, nb, bs, W]`` (on the device) into blocks
    ``block_ids`` of cache buffer ``name``, in place."""
    _blocks(engine.kv_cache[name], engine.config.block_size).index_copy_(
        1, block_ids, rows)


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's bytes in C order (bf16 as its 2-byte bits)."""
    t = t.contiguous()
    return t.view(-1).view(torch.uint8).numpy().tobytes()


def host_tensor(blob, offset: int, count: int, dtype: torch.dtype,
                pin: bool) -> torch.Tensor:
    """``count`` elements of ``dtype`` at ``offset`` of ``blob``, copied
    into a fresh (pinned, with ``pin``) host tensor."""
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    out.numpy()[:] = np.frombuffer(blob, np.uint8, count=nbytes,
                                   offset=offset)
    return out.view(dtype)


def _pack_blocks(engine, block_ids: List[int]) -> bytes:
    """Wire v2 of ``block_ids``: the header, then for every cache buffer
    (sorted by name) its row width, dtype code and ``[L, nb * bs, W]``
    rows.  The JAX package's ``_pack_blocks`` writes the same bytes."""
    bs = engine.config.block_size
    nb = len(block_ids)
    items = gather_blocks(engine, block_ids)
    L = items[0][1].shape[0]
    parts = [_HEADER.pack(_MAGIC, _WIRE_VERSION, L, bs, len(items), nb)]
    # int8 caches ship int8 rows + their f32 scale planes as ordinary
    # buffer segments: the P->D payload is ~half the bf16 bytes.
    for _, rows in items:
        parts.append(_BUF_HEADER.pack(
            rows.shape[-1], transport.wire_dtype_code(rows.dtype)))
        parts.append(tensor_bytes(rows.cpu()))
    return b"".join(parts)


def check_slab(engine, blob: bytes, nb: int) -> List[Tuple]:
    """Validate wire v2 ``blob`` against the engine's cache for ``nb``
    blocks (``ValueError`` on a layout, version, width or dtype the cache
    does not have); returns each buffer's segment ``(name, offset, count,
    dtype, full width)``.  Widths are the whole rows the wire carries (a
    tp rank's buffer holds its share of them)."""
    bs = engine.config.block_size
    magic, ver, bL, bbs, n_bufs, bnb = _HEADER.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise ValueError("bad magic")
    if ver != _WIRE_VERSION:
        raise ValueError(
            f"KV wire version {ver} != {_WIRE_VERSION} (peer running an "
            "incompatible build; refusing to reinterpret the slab)")
    items = _cache_items(engine)
    L = items[0][1].shape[0]
    if (bL, bbs, n_bufs) != (L, bs, len(items)):
        raise ValueError(
            f"slab layout {(bL, bbs, n_bufs)} != cache layout "
            f"{(L, bs, len(items))} (kv_cache_dtype mismatch between "
            "producer and consumer changes the buffer set)")
    if bnb < nb:
        raise ValueError(f"slab has {bnb} blocks, need {nb}")
    tp = engine.mesh.axis_size("tp") if engine.mesh is not None else 1
    off = _HEADER.size
    segments = []
    for name, buf in items:
        width, code = _BUF_HEADER.unpack_from(blob, off)
        off += _BUF_HEADER.size
        have = buf.shape[2] * (tp if _tp_sharded(engine, name) else 1)
        if width != have:
            raise ValueError(
                f"buffer {name!r}: slab width {width} != cache {have}")
        try:
            dtype = transport.wire_dtype(code)
        except transport.TransferError as e:
            raise ValueError(str(e)) from e
        if dtype != buf.dtype:
            # A bf16 decoder never silently reinterprets an int8
            # producer's blocks (or vice versa).
            raise ValueError(
                f"buffer {name!r}: producer shipped {dtype} but the local "
                f"cache is {buf.dtype} -- kv_cache_dtype mismatch, "
                "refusing to reinterpret")
        count = L * bnb * bs * width
        segments.append((name, off, count, dtype, width))
        off += count * buf.element_size()
    if off > len(blob):
        raise ValueError(f"slab truncated: {len(blob)} bytes, need {off}")
    return segments


def scatter_blocks(engine, block_ids: List[int], blob: bytes) -> None:
    """Write wire v2 ``blob`` into ``block_ids`` of the engine's cache;
    ``ValueError`` on a layout, version or dtype the cache does not
    have (nothing is written then).  On a mesh only the ranks of the
    blocks' region write, each its tp shard of a sharded buffer's rows."""
    bs = engine.config.block_size
    nb = len(block_ids)
    segments = check_slab(engine, blob, nb)
    _, _, L, _, _, bnb = _HEADER.unpack_from(blob, 0)
    r, local = _local_blocks(engine, block_ids)
    if r != engine.dp_index:
        return
    dev = engine.device
    ids = block_ids_on(dev, local)
    for name, seg_off, count, dtype, width in segments:
        rows = host_tensor(blob, seg_off, count, dtype, dev.type == "cuda")
        rows = rows.view(L, bnb, bs, width)[:, :nb]
        if _tp_sharded(engine, name):
            w = engine.kv_cache[name].shape[2]
            t = engine.mesh.axis_index("tp")
            rows = rows[..., t * w:(t + 1) * w].contiguous()
        scatter_block_rows(engine, name, ids, to_device(rows, dev))
