"""Tiered prefix cache: host-RAM KV offload + cross-pod shared tier (port of
``llm_d_tpu.engine.offload``; the same slab and key space, so a port pod
and a JAX pod serve each other's blocks).

The reference's tiered-prefix-cache path offloads KV to CPU RAM via vLLM's
``OffloadingConnector`` / ``LMCacheConnectorV1``
(tiered-prefix-cache/cpu/README.md:111-117,235-239).  Here:

  - every block that becomes prefix-cached on device is also staged to a
    host-RAM LRU (``on_block_stored`` hook).  The engine flushes once a
    step: one ``index_select`` a cache buffer, copied into pinned host
    memory without waiting (``non_blocking``), an event recorded behind
    it; the blocks are packed into slabs once that event has completed
    (at a later flush, or when a restore needs them).  Under async
    scheduling the successor block is already queued when the flush
    runs, so a blocking copy would wait for it and lose the overlap;
  - when a prefix lookup misses the device cache, the host tier restores
    the block into a freshly taken device block (written in place, queued
    on the current stream) and re-registers it: the request then
    prefix-hits as if it had never been evicted
    (``KVCacheManager.secondary_lookup``);
  - device eviction does NOT remove the host copy.

On a mesh (``EngineCore`` over a dp x tp mesh) every rank runs the same
scheduler, so every rank stores, flushes and looks up the same blocks in
the same order.  The host copy lives on rank 0, whose scheduler decides:
a flush gathers each block's rows from the ranks of its region (the
gather P/D uses, ``transfer.connector.gather_blocks``) at the step's end,
which every rank takes part in, and the other ranks keep only the key
set, in the same LRU order.  A restore is rank 0's verdict, sent on the
engine's step channel: the slab's size and where it came from (this
tier, a peer, or a miss); its slab goes to the ranks of the requesting
request's region, which write their tp shard of it.  A rank whose key
set lacks a block rank 0 restores from this tier raises; on a peer hit
every rank adds the key, in rank 0's LRU order.

Cross-pod sharing (the LMCache/InfiniStore role): with ``serve_port`` set,
the tier registers every host-resident block with a transfer server under
its CHAIN HASH (sha256, deterministic across pods), and with ``peers`` set,
a local miss falls through to the peers' servers before recompute.  A
blob holds whole rows whatever the pod's tp (the JAX stacked flush's
layout), so pods of either package and any mesh read each other's.  Peers
are static ``host:port`` entries and discovery specs (``dns:`` /
``k8s:``, ``utils/discovery.py``), the latter re-resolved every
``PEER_REFRESH_S`` on a thread of their own: static peers first, then the
resolved ones sorted, departed peers' health dropped.  On a mesh only
rank 0 serves, resolves and dials peers (with the peers' health, backoff
and the ``kv.peer_fetch`` fault point); the other ranks never open a
connection, and rank 0's verdict makes a failed or faulted fetch a miss
on every rank.

Wire metrics: ``llmd_tpu:kv_offload_{saved,loaded}_blocks_total`` and
``llmd_tpu:kv_shared_tier_{hits,misses}_total``.
"""

from __future__ import annotations

import collections
import errno
import logging
import struct
import threading
import time
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from llm_d_tpu_torch.transfer import transport
from llm_d_tpu_torch.transfer.connector import (
    _cache_items, _local_blocks, _tp_sharded, block_ids_on, gather_blocks,
    host_tensor, scatter_block_rows, tensor_bytes, to_device)
from llm_d_tpu_torch.utils import discovery, tracing
from llm_d_tpu_torch.utils.config import env_float, env_int
from llm_d_tpu_torch.utils.faultinject import FaultInjected, get_injector

logger = logging.getLogger(__name__)

# Slab version 2 (kv_cache_dtype era): per-buffer dtype codes -- int8
# caches stage int8 rows + f32 scale planes, and a pod whose cache dtype
# differs REJECTS the blob instead of reinterpreting it.  Codes live in
# transfer/transport.py, the registry the P->D wire uses.
_SLAB_VERSION = 2
_SLAB_HEADER = struct.Struct("<IIII")   # version, num_buffers, L, bs
_SLAB_BUF = struct.Struct("<IB")        # (row width, dtype code)


def _shared_key(block_hash: bytes) -> str:
    return "b:" + block_hash.hex()


def _slab_layout(engine) -> List[tuple]:
    """Expected slab segments, sorted by name: (name, width, dtype)."""
    return [(name, buf.shape[2], buf.dtype)
            for name, buf in _cache_items(engine)]


def _pack_block_slab(slab: Dict[str, torch.Tensor]) -> bytes:
    """One block's slab: the header, then for every buffer (sorted by
    name) its width, dtype code and ``[L, bs, W]`` rows (host tensors).
    The JAX package's ``_pack_block_slab`` writes the same bytes."""
    names = sorted(slab)
    L, bs, _ = slab[names[0]].shape
    parts = [_SLAB_HEADER.pack(_SLAB_VERSION, len(names), L, bs)]
    for n in names:
        parts.append(_SLAB_BUF.pack(
            slab[n].shape[2], transport.wire_dtype_code(slab[n].dtype)))
        parts.append(tensor_bytes(slab[n]))
    return b"".join(parts)


def _unpack_block_slab(blob: bytes, layout: List[tuple], L: int, bs: int,
                       pin: bool = False) -> Dict[str, torch.Tensor]:
    """A slab's buffers as host tensors ``[L, bs, W]`` (pinned with
    ``pin``); ``ValueError`` on a version, layout or dtype this pod's
    cache does not have."""
    ver, nb, bL, bbs = _SLAB_HEADER.unpack_from(blob, 0)
    if ver != _SLAB_VERSION:
        raise ValueError(f"KV slab version {ver} != {_SLAB_VERSION} "
                         "(peer running an incompatible build)")
    if (nb, bL, bbs) != (len(layout), L, bs):
        raise ValueError(f"slab layout {(nb, bL, bbs)} != "
                         f"{(len(layout), L, bs)}")
    off = _SLAB_HEADER.size
    out = {}
    for name, width, dtype in layout:
        w, code = _SLAB_BUF.unpack_from(blob, off)
        off += _SLAB_BUF.size
        if w != width:
            raise ValueError(
                f"buffer {name!r}: slab width {w} != cache {width}")
        try:
            blob_dtype = transport.wire_dtype(code)
        except transport.TransferError as e:
            raise ValueError(str(e)) from e
        if blob_dtype != dtype:
            # A bf16 pod must not reinterpret an int8 peer's blocks (and
            # vice versa): kv_cache_dtype is part of the tier contract.
            raise ValueError(
                f"buffer {name!r}: slab holds {blob_dtype} but this pod's "
                f"cache is {dtype} -- kv_cache_dtype mismatch, rejecting")
        count = L * bs * w
        end = off + count * torch.empty((), dtype=dtype).element_size()
        if end > len(blob):
            raise ValueError(f"slab truncated: {len(blob)} bytes, "
                             f"need {end}")
        out[name] = host_tensor(blob, off, count, dtype, pin).view(L, bs, w)
        off = end
    return out


class HostKVTier:
    """Host-RAM block store between the device prefix cache and recompute.

    ``serve_port``: also serve host-resident blocks to peer pods (0 =
    ephemeral port, None = don't serve).  ``peers``: shared-tier servers
    consulted on local miss, static "host:port" entries and discovery
    specs ("dns:<name>:<port>" / "k8s:[ns/]<svc>:<port>"), the latter
    re-resolved every ``PEER_REFRESH_S``.  A pod may resolve itself; its
    own fetches are loopback misses.  On a mesh only rank 0 serves and
    dials.
    """

    # A peer with this many consecutive transport failures is skipped for
    # the backoff window (a dead peer's blackholed IP would otherwise stall
    # the engine thread peer_timeout_ms per uncached block).  Instances
    # read the LLMD_PEER_FAILURE_LIMIT / LLMD_PEER_BACKOFF_S knobs.
    PEER_FAILURE_LIMIT = 3
    PEER_BACKOFF_S = 30.0
    # Seconds between two resolves of the discovery specs.
    PEER_REFRESH_S = 5.0

    def __init__(self, engine, capacity_blocks: int,
                 serve_port: Optional[int] = None,
                 peers: Optional[List[str]] = None,
                 peer_timeout_ms: int = 500) -> None:
        self.engine = engine
        # On a mesh rank 0 holds the bytes, serves and dials; the others
        # hold the key set.
        self.leader = engine.mesh is None or engine.mesh.rank == 0
        self.capacity_blocks = capacity_blocks
        # hash -> PACKED block bytes (LRU, oldest first).  The shared-tier
        # server's registry holds the same bytes objects, so host memory
        # stays at 1x capacity.
        self._store: "collections.OrderedDict[bytes, bytes]" = (
            collections.OrderedDict())
        # Stored-this-step blocks awaiting the step's gather.
        self._pending: List[Tuple[bytes, int]] = []
        # Gathers queued on the device and not yet packed, oldest first:
        # (event or None, [(hash, block)], {name: host [L, nb, bs, W]}).
        self._gathers: Deque[tuple] = collections.deque()
        # Hashes pending or gathering (not in _store yet).
        self._staged: Set[bytes] = set()
        self.saves = 0
        self.loads = 0
        self.remote_hits = 0
        self.remote_misses = 0
        self.server = None
        if serve_port is not None and self.leader:
            self.server = transport.PyTransferServer("0.0.0.0", serve_port)
        self.peer_failure_limit = env_int("LLMD_PEER_FAILURE_LIMIT",
                                          self.PEER_FAILURE_LIMIT)
        self.peer_backoff_s = env_float("LLMD_PEER_BACKOFF_S",
                                        self.PEER_BACKOFF_S)
        entries = list(peers or []) if self.leader else []
        specs = [p for p in entries if discovery.is_dynamic(p)]
        self._static_peers = [p for p in entries
                              if not discovery.is_dynamic(p)]
        self.peers = list(self._static_peers)
        self.peer_timeout_ms = peer_timeout_ms
        # peer -> (consecutive_failures, retry_after_monotonic)
        self._peer_health: Dict[str, tuple] = {}
        self._peer_resolver = None
        self._stop: Optional[threading.Event] = None
        if specs:
            rs = [discovery.parse_discover_spec(s) for s in specs]
            self._peer_resolver = (rs[0] if len(rs) == 1
                                   else discovery.MultiResolver(rs))
            self._refresh_peers()            # the first resolve, here
            self._stop = threading.Event()
            self._refresh_thread = threading.Thread(
                target=self._refresh_loop, name="kv-peer-refresh",
                daemon=True)
            self._refresh_thread.start()
        km = engine.kv_manager
        km.on_block_stored.append(self._on_stored)
        km.secondary_lookup = self._restore

    def _refresh_peers(self) -> None:
        """One resolve of the discovery specs: the static peers, then the
        resolved ones sorted; an outage (None) keeps the last view."""
        try:
            resolved = self._peer_resolver.resolve()
        except Exception as exc:
            logger.warning("shared-tier peer resolve failed: %s", exc)
            return
        if resolved is None:
            return
        addrs = sorted({addr for addr, _role in resolved}
                       - set(self._static_peers))
        new = self._static_peers + addrs
        if new != self.peers:
            logger.info("shared-tier peers: %s", new)
            self.peers = new
            # Departed peers' health goes with them.
            self._peer_health = {p: v for p, v in self._peer_health.items()
                                 if p in new}

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.PEER_REFRESH_S):
            self._refresh_peers()

    @property
    def port(self) -> int:
        return self.server.port if self.server is not None else 0

    def close(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._refresh_thread.join(timeout=2 * self.PEER_REFRESH_S)
        if self.server is not None:
            self.server.close()

    # ---------- device -> host (store path) ----------

    def _on_stored(self, block_hash: bytes, block_id: int) -> None:
        if block_hash in self._store:
            self._store.move_to_end(block_hash)
            return
        if block_hash in self._staged:
            return
        # Defer the copy: one gather per STEP (flush), not one per block.
        self._pending.append((block_hash, block_id))
        self._staged.add(block_hash)

    def flush(self) -> None:
        """Queue the device->host copy of this step's newly cached blocks,
        and pack the earlier copies that have landed.

        Called by the engine at the end of each step.  Order: the gather
        is queued on the current stream now, before this engine's next
        allocation can hand any of these blocks to another request, so
        whatever later rewrites a reused block is queued after it.  Work
        already in flight (an async successor block or fused dispatch
        queued before this step's retire) writes only past each row's
        computed length, never into a full block cached at this retire."""
        self.complete(wait=False)
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        if self.engine.mesh is not None:
            self._flush_mesh(pending)
            return
        cuda = self.engine.device.type == "cuda"
        hosts = {}
        for name, rows in gather_blocks(self.engine, [b for _, b in pending]):
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=cuda)
            host.copy_(rows, non_blocking=cuda)
            hosts[name] = host
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        self._gathers.append((event, pending, hosts))
        if not cuda:
            self.complete()

    def _flush_mesh(self, pending: List[Tuple[bytes, int]]) -> None:
        """A mesh's flush, on every rank: one gather of each region's
        blocks (a collective of the region's ranks and rank 0, region by
        region), packed on rank 0 at once; the other ranks record the
        keys.  Each gather's rows are read to the host at once, so
        nothing is left in flight."""
        e = self.engine
        km = e.kv_manager
        for r in range(e.dp):
            group = [(h, b) for h, b in pending if km.region_of_block(b) == r]
            if not group:
                continue
            hosts = {name: rows.cpu() for name, rows in
                     gather_blocks(e, [b for _, b in group])}
            for i, (h, _) in enumerate(group):
                self._staged.discard(h)
                self._insert(h, _pack_block_slab(
                    {name: arr[:, i] for name, arr in hosts.items()})
                    if self.leader else None)
                self.saves += 1
                e.metrics.kv_offload_saves.inc()

    def complete(self, wait: bool = False) -> None:
        """Pack every queued gather whose copy has landed into the store
        (oldest first; with ``wait``, wait for all of them)."""
        m = self.engine.metrics
        while self._gathers:
            event, pending, hosts = self._gathers[0]
            if event is not None and not event.query():
                if not wait:
                    return
                event.synchronize()
            self._gathers.popleft()
            for i, (h, _) in enumerate(pending):
                self._staged.discard(h)
                self._insert(h, _pack_block_slab(
                    {name: arr[:, i] for name, arr in hosts.items()}))
                self.saves += 1
                m.kv_offload_saves.inc()

    def _insert(self, block_hash: bytes, blob: bytes) -> None:
        """Local store insert mirrored to the shared-tier server; capacity
        eviction unregisters (the served key set IS the local store)."""
        self._store[block_hash] = blob
        if self.server is not None:
            self.server.register(_shared_key(block_hash), blob)
        while len(self._store) > self.capacity_blocks:
            evicted_hash, _ = self._store.popitem(last=False)
            if self.server is not None:
                self.server.unregister(_shared_key(evicted_hash))

    # ---------- host -> device (restore path) ----------

    def _restore(self, block_hash: bytes,
                 protected: frozenset = frozenset(),
                 region: int = 0) -> Optional[int]:
        """Secondary prefix lookup: bring a host-tier block back on device.

        Returns a device block id registered in the prefix cache (parked
        in the evictor with refcount 0, like a freed cached block), or
        None when the tier misses too.  ``protected`` holds the chain's
        already-matched blocks: they MUST NOT be chosen as the restore
        target."""
        t0 = time.time()
        if self.engine.mesh is not None:
            return self._restore_mesh(block_hash, protected, region, t0)
        try:
            # A fired fault IS a miss: the caller recomputes.
            get_injector().check("kv.restore", key=block_hash.hex()[:16])
        except FaultInjected as exc:
            logger.warning("kv.restore fault: treating tier restore as a "
                           "miss (%s)", exc)
            tracing.trace_event("engine", "kv.restore",
                                block=block_hash.hex()[:16],
                                verdict="fault_miss")
            return None
        if block_hash in self._staged:
            # Copied (or about to be) but not packed yet: land it first.
            self.flush()
            self.complete(wait=True)
        local = block_hash in self._store
        blob = self._store.get(block_hash)
        if blob is None and self.peers:
            blob = self._fetch_from_peers(block_hash)
        if blob is None:
            tracing.trace_event("engine", "kv.restore",
                                block=block_hash.hex()[:16],
                                verdict="miss")
            return None
        e = self.engine
        km = e.kv_manager
        bs = e.config.block_size
        L = _cache_items(e)[0][1].shape[0]
        try:
            # Unpack BEFORE claiming a device block: a corrupt or stale
            # blob is a tier miss, not an engine error.
            slab = _unpack_block_slab(blob, _slab_layout(e), L, bs,
                                      pin=e.device.type == "cuda")
        except (ValueError, struct.error) as exc:
            logger.warning("host-tier blob %s unusable (%s); dropping it "
                           "and recomputing", block_hash.hex()[:16], exc)
            self._store.pop(block_hash, None)
            if self.server is not None:
                self.server.unregister(_shared_key(block_hash))
            return None
        b = km.take_block(protected, region=region)
        if b is None:
            return None          # everything free is protected; recompute
        try:
            ids = block_ids_on(e.device, [b])
            for name, arr in slab.items():
                scatter_block_rows(e, name, ids,
                                   to_device(arr, e.device)[:, None])
        except Exception:
            # The taken block is not registered anywhere yet: hand it back.
            km._release(b)
            raise
        self._register(block_hash, b, t0, "host" if local else "peer",
                       len(blob))
        return b

    def _register(self, block_hash: bytes, b: int, t0: float, tier: str,
                  nbytes: int) -> None:
        """A restored block enters the prefix cache, parked in the
        evictor like a freed cached block."""
        km = self.engine.kv_manager
        self._store.move_to_end(block_hash)
        km._hash_of[b] = block_hash
        km._cached[block_hash] = b
        km._evictor[km.region_of_block(b)][b] = None
        self.loads += 1
        self.engine.metrics.kv_offload_loads.inc()
        tracing.get_tracer("engine").record_span(
            "kv.restore", t0, time.time(),
            block=block_hash.hex()[:16], verdict="hit", tier=tier,
            bytes=nbytes)

    def _restore_mesh(self, block_hash: bytes, protected: frozenset,
                      region: int, t0: float) -> Optional[int]:
        """A mesh's restore, on every rank at the same lookup: rank 0's
        verdict on the step channel, the slab's size and its tier
        ("host", "peer", or None: a miss; rank 0 alone looks in its store
        and asks the peers); on a peer hit every rank adds the key to its
        key set, as rank 0's store took the blob.  On a hit every rank
        takes the same block of ``region``, rank 0 sends the slab to the
        region's ranks and each writes its tp shard.  A rank whose key
        set lacks a block rank 0 restores from this tier raises; a slab
        that cannot be written raises (no fallback)."""
        e = self.engine
        mesh, km, channel = e.mesh, e.kv_manager, e._channel
        if block_hash in self._staged:
            self.flush()                 # every rank stages alike
        if self.leader:
            blob, tier = None, None
            try:
                get_injector().check("kv.restore", key=block_hash.hex()[:16])
                blob = self._store.get(block_hash)
                tier = "host"
                if blob is None and self.peers:
                    blob, tier = self._fetch_from_peers(block_hash), "peer"
            except FaultInjected as exc:
                logger.warning("kv.restore fault: treating tier restore as "
                               "a miss (%s)", exc)
            nbytes = None if blob is None else len(blob)
            tier = None if blob is None else tier
            channel.send(("restore", block_hash, nbytes, tier))
        else:
            what, h, nbytes, tier = channel.recv()
            if (what, h) != ("restore", block_hash):
                raise RuntimeError(
                    f"rank {mesh.rank}: rank 0 sent {(what, h.hex()[:16])}"
                    f" where this rank restores {block_hash.hex()[:16]}")
            if tier == "peer":
                self._insert(block_hash, None)
            elif tier == "host" and block_hash not in self._store:
                raise RuntimeError(
                    f"rank {mesh.rank}: rank 0 restores block "
                    f"{block_hash.hex()[:16]}, which this rank's host-tier "
                    "key set does not hold")
        if nbytes is None:
            tracing.trace_event("engine", "kv.restore",
                                block=block_hash.hex()[:16], verdict="miss")
            return None
        b = km.take_block(protected, region=region)
        if b is None:
            return None          # everything free is protected; recompute
        ranks = mesh.region_ranks(region)
        if self.leader:
            t = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
            for dst in ranks:
                if dst != 0:
                    mesh.send(t, dst)
        elif mesh.rank in ranks:
            blob = mesh.recv((nbytes,), torch.uint8,
                             0).cpu().numpy().tobytes()
        if mesh.rank in ranks:
            try:
                self._write_slab(blob, b)
            except Exception:
                km._release(b)
                raise
        self._register(block_hash, b, t0, tier, nbytes)
        return b

    def _write_slab(self, blob: bytes, b: int) -> None:
        """Write a packed slab into global block ``b`` of this rank's
        plane, its tp shard of each sharded buffer."""
        e = self.engine
        L = _cache_items(e)[0][1].shape[0]
        slab = _unpack_block_slab(blob, self._full_layout(), L,
                                  e.config.block_size,
                                  pin=e.device.type == "cuda")
        _, local = _local_blocks(e, [b])
        ids = block_ids_on(e.device, local)
        for name, arr in slab.items():
            if _tp_sharded(e, name):
                w = e.kv_cache[name].shape[2]
                t = e.mesh.axis_index("tp")
                arr = arr[..., t * w:(t + 1) * w].contiguous()
            scatter_block_rows(e, name, ids, to_device(arr, e.device)[:, None])

    def _full_layout(self) -> List[tuple]:
        """The slab's segments as the wire carries them: whole rows (a tp
        rank's buffer holds its share of a sharded one)."""
        e = self.engine
        tp = e.mesh.axis_size("tp") if e.mesh is not None else 1
        return [(name, width * (tp if _tp_sharded(e, name) else 1), dtype)
                for name, width, dtype in _slab_layout(e)]

    def _fetch_from_peers(self, block_hash: bytes) -> Optional[bytes]:
        """Shared-tier lookup before recompute: try each peer's server.
        Hits also enter the local host tier.  Returns the PACKED blob
        (validated)."""
        e = self.engine
        key = _shared_key(block_hash)
        # Whole rows, whatever this pod's tp: a peer's blob is the JAX
        # stacked flush's layout.
        layout = self._full_layout()
        L = _cache_items(e)[0][1].shape[0]
        bs = e.config.block_size
        now = time.monotonic()
        for peer in self.peers:
            fails, retry_after = self._peer_health.get(peer, (0, 0.0))
            if fails >= self.peer_failure_limit and now < retry_after:
                continue                      # dead peer in backoff
            host, _, port = peer.rpartition(":")
            try:
                get_injector().check("kv.peer_fetch", key=peer)
                # A resolved IPv6 peer is bracketed ("[::1]:8700").
                blob = transport.fetch(host.strip("[]"), int(port), key,
                                       timeout_ms=self.peer_timeout_ms)
                # Validate layout AND dtype: a mismatched peer's blob is a
                # ValueError here, counted as a peer failure below.
                _unpack_block_slab(blob, layout, L, bs)
            except transport.TransferNotFound:
                # Peer alive, block absent: a healthy miss.
                self._peer_health.pop(peer, None)
                continue
            except (transport.TransferError, ValueError, struct.error,
                    OSError, FaultInjected) as exc:
                # Unreachability (refused / no route / timed out) means the
                # PEER is down: straight into backoff, so a dead peer costs
                # one timeout, not one per uncached block.
                conn_err = isinstance(exc, OSError) and exc.errno in (
                    errno.ECONNREFUSED, errno.EHOSTUNREACH,
                    errno.ENETUNREACH, errno.ETIMEDOUT)
                conn_err = conn_err or isinstance(exc, TimeoutError) \
                    or "timed out" in str(exc).lower() \
                    or "refused" in str(exc).lower()
                fails = self.peer_failure_limit if conn_err else fails + 1
                self._peer_health[peer] = (
                    fails, time.monotonic() + self.peer_backoff_s)
                log = (logger.warning
                       if fails >= self.peer_failure_limit else logger.debug)
                log("shared-tier peer %s failed (%s): %s", peer,
                    "unreachable, backing off" if conn_err
                    else f"{fails} consecutive", exc)
                continue
            self._peer_health.pop(peer, None)
            self.remote_hits += 1
            e.metrics.kv_shared_tier_hits.inc()
            tracing.trace_event("engine", "kv.peer_fetch", peer=peer,
                                block=block_hash.hex()[:16],
                                verdict="hit", bytes=len(blob))
            self._insert(block_hash, blob)
            return blob
        self.remote_misses += 1
        e.metrics.kv_shared_tier_misses.inc()
        tracing.trace_event("engine", "kv.peer_fetch",
                            block=block_hash.hex()[:16], verdict="miss",
                            peers=len(self.peers))
        return None

    @property
    def num_blocks(self) -> int:
        return len(self._store)
