"""Cluster-wide precise prefix index (llm-d-kv-cache indexer equivalent;
port of ``llm_d_tpu.epp.indexer``, fed by the port's
``events/kv_events.py`` publisher).

Consumes KV block events published by model-server replicas and maintains
block-hash -> endpoints residency, so the precise-prefix-cache-scorer can
rank replicas by how much of a request's prefix is ACTUALLY cached there
(reference: gaie-kv-events/values.yaml:49-57 ``kvCacheIndexConfig`` /
``kvEventsConfig``, ms-kv-events/values.yaml:29-48 the engine-side
publisher wiring).

Each residency entry carries the block's byte size and storage tier
(``device`` vs ``host`` offload) per owner, so the kv-placement-scorer can
price a peer restore (bytes over a link) against recompute (prefill
FLOPs) instead of treating residency as a binary affinity signal.

Transport is ZMQ pub/sub with msgpack batches, mirroring the reference's
``--kv-events-config {"publisher":"zmq", "topic":"kv@<pod>@<model>"}``;
``attach_inproc`` offers a same-process fast path for tests, the
all-in-one gateway, and the cluster simulator (virtual clock, no sockets).
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

DEVICE_TIER = "device"
HOST_TIER = "host"


@dataclass
class RestorePlan:
    """``restorable_prefix`` answer: how much of a request's leading
    blocks the candidate already holds (``local_blocks``), how many MORE
    contiguous blocks could be restored from the best peer replica or
    shared host tier (``peer_blocks`` from ``source``), and what a
    restore would move (``nbytes``, ``tier``)."""

    local_blocks: int = 0
    peer_blocks: int = 0
    source: Optional[str] = None
    tier: str = DEVICE_TIER
    nbytes: int = 0

    @property
    def total_blocks(self) -> int:
        return self.local_blocks + self.peer_blocks


class PrefixIndex:
    """block_hash -> owners holding it (LRU-bounded).

    Owners map ``endpoint -> (nbytes, tier)`` so placement can price a
    restore; plain residency queries ignore the extras.
    """

    def __init__(self, capacity: int = 500_000,
                 metrics=None) -> None:
        self.capacity = capacity
        self.metrics = metrics
        self._lock = threading.Lock()
        # OrderedDict for LRU on block hash; value = owner -> (nbytes, tier).
        self._blocks: "OrderedDict[bytes, Dict[str, Tuple[int, str]]]" = \
            OrderedDict()
        self._hits = 0
        self._queries = 0

    # ---------- event ingest ----------

    def on_event(self, endpoint: str, event_type: str,
                 block_hashes: Sequence[bytes],
                 nbytes: int = 0, tier: str = DEVICE_TIER) -> None:
        with self._lock:
            if event_type == "BlockStored":
                for h in block_hashes:
                    owners = self._blocks.pop(h, {})
                    owners[endpoint] = (nbytes, tier)
                    self._blocks[h] = owners
                while len(self._blocks) > self.capacity:
                    self._blocks.popitem(last=False)
            elif event_type == "BlockRemoved":
                for h in block_hashes:
                    owners = self._blocks.get(h)
                    if owners is not None:
                        owners.pop(endpoint, None)
                        if not owners:
                            self._blocks.pop(h, None)
            elif event_type == "AllBlocksCleared":
                for h, owners in list(self._blocks.items()):
                    owners.pop(endpoint, None)
                    if not owners:
                        self._blocks.pop(h, None)
            if self.metrics is not None:
                self.metrics.prefix_indexer_size.set(len(self._blocks))
                kv_events = getattr(self.metrics, "kv_events", None)
                if kv_events is not None:
                    kv_events.labels(type=event_type).inc(
                        max(len(block_hashes), 1))

    def attach_inproc(self, endpoint: str, block_nbytes: int = 0,
                      tier: str = DEVICE_TIER
                      ) -> Callable[[str, Sequence[bytes]], None]:
        """Same-process event path (no sockets): a ``(event_type,
        block_hashes)`` callable a replica's KV event hook can call
        directly — the cluster simulator's sink shape."""

        def sink(event_type: str, block_hashes: Sequence[bytes]) -> None:
            self.on_event(endpoint, event_type, block_hashes,
                          nbytes=block_nbytes, tier=tier)

        return sink

    # ---------- queries ----------

    def longest_prefix(self, keys: Sequence[bytes], endpoint: str) -> int:
        """How many leading blocks of ``keys`` are resident on ``endpoint``."""
        n = 0
        with self._lock:
            self._queries += 1
            for k in keys:
                owners = self._blocks.get(k)
                if owners is None or endpoint not in owners:
                    break
                # A query hit IS recency: without this touch the hottest
                # prefix blocks (queried every schedule, re-stored never)
                # sit at the cold end of the LRU and evict first.
                self._blocks.move_to_end(k)
                n += 1
            if n:
                self._hits += 1
            if self.metrics is not None and self._queries:
                self.metrics.prefix_indexer_hit_ratio.set(
                    self._hits / self._queries)
        return n

    def restorable_prefix(self, keys: Sequence[bytes],
                          endpoint: str) -> RestorePlan:
        """Local + peer-restorable coverage of ``keys`` for ``endpoint``.

        Leading blocks already on ``endpoint`` are local hits; the
        contiguous continuation is restorable if SOME owner holds it —
        the best source is the single owner covering the longest
        contiguous run (device tier preferred on ties, then lexicographic
        for determinism).  Returned ``nbytes`` prices the peer span from
        that source's per-block sizes.
        """
        plan = RestorePlan()
        with self._lock:
            self._queries += 1
            i = 0
            for k in keys:
                owners = self._blocks.get(k)
                if owners is None or endpoint not in owners:
                    break
                self._blocks.move_to_end(k)
                i += 1
            plan.local_blocks = i
            # Per-candidate-source contiguous coverage of the continuation.
            coverage: Dict[str, List[Tuple[int, str]]] = {}
            for k in keys[i:]:
                owners = self._blocks.get(k)
                if not owners:
                    break
                self._blocks.move_to_end(k)
                live = {src: meta for src, meta in owners.items()
                        if src != endpoint}
                if not coverage:
                    for src, meta in live.items():
                        coverage[src] = [meta]
                else:
                    still = {}
                    for src, blocks in coverage.items():
                        if src in live:
                            blocks.append(live[src])
                            still[src] = blocks
                    if not still:
                        break
                    coverage = still
            if coverage:
                def rank(item):
                    src, blocks = item
                    tier_penalty = sum(
                        1 for _, t in blocks if t != DEVICE_TIER)
                    return (-len(blocks), tier_penalty, src)

                src, blocks = min(coverage.items(), key=rank)
                plan.peer_blocks = len(blocks)
                plan.source = src
                plan.nbytes = sum(b for b, _ in blocks)
                plan.tier = HOST_TIER if any(
                    t != DEVICE_TIER for _, t in blocks) else DEVICE_TIER
            if plan.total_blocks:
                self._hits += 1
            if self.metrics is not None and self._queries:
                self.metrics.prefix_indexer_hit_ratio.set(
                    self._hits / self._queries)
        return plan

    def remove_endpoint(self, endpoint: str) -> None:
        """Drop every entry owned by a departed endpoint (discovery leave):
        stale ownership would keep pulling prefix-affine traffic toward a
        pod that no longer exists."""
        self.on_event(endpoint, "AllBlocksCleared", ())

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._blocks)


class ZmqEventSubscriber:
    """SUB socket pulling msgpack KV-event batches into a PrefixIndex.

    Topic format ``kv@<endpoint>@<model>`` (reference:
    ms-kv-events/values.yaml:40); the endpoint segment attributes events.
    """

    def __init__(self, index: PrefixIndex, bind: str = "tcp://*:5557") -> None:
        self.index = index
        self.bind = bind
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> None:
        import zmq

        ctx = zmq.Context.instance()
        sock = ctx.socket(zmq.SUB)
        sock.bind(self.bind)
        sock.setsockopt(zmq.SUBSCRIBE, b"kv@")
        sock.setsockopt(zmq.RCVTIMEO, 200)
        self._sock = sock
        self._thread = threading.Thread(
            target=self._loop, name="kv-event-sub", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        import msgpack
        import zmq

        while not self._stop.is_set():
            try:
                topic, payload = self._sock.recv_multipart()
            except zmq.Again:
                continue
            except Exception:
                if self._stop.is_set():
                    return
                logger.exception("kv-event recv failed")
                continue
            try:
                endpoint = topic.decode().split("@")[1]
                batch = msgpack.unpackb(payload, raw=False)
                for ev in batch.get("events", []):
                    self.index.on_event(
                        endpoint, ev["type"],
                        [bytes(h) for h in ev["block_hashes"]],
                        nbytes=int(ev.get("nbytes", 0)),
                        tier=str(ev.get("tier", DEVICE_TIER)))
            except Exception:
                logger.exception("kv-event decode failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        try:
            self._sock.close(0)
        except Exception:
            pass
