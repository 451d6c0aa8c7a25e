"""KV-cache event publisher (port of ``llm_d_tpu.events.kv_events``).

Attaches to ``KVCacheManager``'s block hooks and publishes batched
BlockStored / BlockRemoved events, so the EPP's precise prefix index
knows which replica holds which prefix blocks (the engine side of
``--kv-events-config '{"publisher":"zmq","endpoint":"tcp://<epp>:5557",
"topic":"kv@$POD_IP@<model>"}'``).

Events are batched on a short flush interval, so the engine thread never
waits on the network; the publisher thread owns the ZMQ socket.  ``zmq``
and ``msgpack`` are imported when the publisher starts (the server
refuses ``--kv-events-endpoint`` by name where either is missing).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

# How often the publisher thread drains its queue, and the most events
# one message carries.
FLUSH_INTERVAL_S = 0.05
MAX_BATCH = 512


class ZmqKvEventPublisher:
    def __init__(
        self,
        endpoint: str,              # e.g. "tcp://epp-host:5557"
        pod_identity: str,          # this replica's address, e.g. "10.0.0.3:8200"
        model: str = "model",
    ) -> None:
        self.endpoint = endpoint
        self.topic = f"kv@{pod_identity}@{model}".encode()
        self._q: "queue.Queue[Tuple[str, bytes]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock = None

    # ---------- KVCacheManager hooks ----------

    def on_block_stored(self, block_hash: bytes, block_id: int) -> None:
        self._q.put(("BlockStored", block_hash))

    def on_block_removed(self, block_hash: bytes, block_id: int) -> None:
        self._q.put(("BlockRemoved", block_hash))

    def attach(self, kv_manager) -> None:
        kv_manager.on_block_stored.append(self.on_block_stored)
        kv_manager.on_block_removed.append(self.on_block_removed)

    # ---------- publisher thread ----------

    def start(self) -> None:
        import zmq

        ctx = zmq.Context.instance()
        sock = ctx.socket(zmq.PUB)
        sock.connect(self.endpoint)
        self._sock = sock
        self._thread = threading.Thread(
            target=self._loop, name="kv-event-pub", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        import msgpack

        while not self._stop.is_set():
            time.sleep(FLUSH_INTERVAL_S)
            events: List[Tuple[str, bytes]] = []
            while len(events) < MAX_BATCH:
                try:
                    events.append(self._q.get_nowait())
                except queue.Empty:
                    break
            if not events:
                continue
            # Consecutive events of one type go out as one batch entry.
            grouped: List[dict] = []
            for etype, h in events:
                if grouped and grouped[-1]["type"] == etype:
                    grouped[-1]["block_hashes"].append(h)
                else:
                    grouped.append({"type": etype, "block_hashes": [h]})
            payload = msgpack.packb(
                {"ts": time.time(), "events": grouped})
            try:
                self._sock.send_multipart([self.topic, payload])
            except Exception:
                logger.exception("kv-event publish failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self._sock is not None:
            self._sock.close(0)


class InprocKvEventSink:
    """The same events without sockets: straight into an index with the
    EPP's ``on_event(pod, type, hashes)`` (tests and single-process
    deployments)."""

    def __init__(self, index, pod_identity: str) -> None:
        self.index = index
        self.pod_identity = pod_identity

    def on_block_stored(self, block_hash: bytes, block_id: int) -> None:
        self.index.on_event(self.pod_identity, "BlockStored", [block_hash])

    def on_block_removed(self, block_hash: bytes, block_id: int) -> None:
        self.index.on_event(self.pod_identity, "BlockRemoved", [block_hash])

    def attach(self, kv_manager) -> None:
        kv_manager.on_block_stored.append(self.on_block_stored)
        kv_manager.on_block_removed.append(self.on_block_removed)
