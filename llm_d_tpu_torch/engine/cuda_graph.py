"""K-step decode blocks and fused spec rounds captured and replayed as CUDA
graphs.

The JAX engine runs a block of K decode iterations, and N fused mixed
rounds of spec decode, as one ``lax.scan`` program each: one dispatch and
one host fetch per block.  PyTorch runs eagerly, so the port captures a
block's K iterations (a few thousand kernel launches at the bench's size)
into one CUDA graph per block key and replays it: one launch from the
host per block.  The fused rounds go the same way: one graph per key of
an N-round dispatch, the single fused round being its N = 1 case.

A graph reads and writes fixed addresses, so every block of one key goes
through the same static tensors: the inputs (``BlockGraph.inputs``,
allocated outside the capture and refilled before each replay) and the
outputs (``BlockGraph.outputs``: a decode block's ids ``[K, S]``; a fused
dispatch's per-round ids, acceptance and logprobs and its final carry).
The weights and the KV cache are captured by address too: the engine
never reassigns them after a capture (every cache write is in place).

Before its capture a block's body runs one iteration eagerly on a side
stream, on the block's real inputs.  That builds and loads the kernels
and settles every cache a wrapper keeps (kernel A's ``num_splits``,
cuBLAS handles); its cache writes are the ones the replay then repeats,
bit for bit.  Intermediates of every capture share one memory pool:
replays run one after another on one stream.

Nothing here falls back to eager execution: a capture or a replay that
fails raises (a failed capture leaves no graph under its key).

Bounds.  Every key adds a graph, and may grow the pool.  ``max_graphs``
caps the graphs held: a new key past it drops the least recently used
one.  ``max_pool_bytes`` caps the pool: a shared pool returns its memory
to the device only when its last graph goes, so a new key that finds the
pool past the cap drops every graph and starts a fresh pool; the keys
still in use are then captured again.  Each drop first waits for the
card, so no replay in flight loses its graph.

Cold cost.  A key's first dispatch pays for its capture, which a user's
first request of that shape waits for: ``BlockGraph.cold`` keeps its
parts in host seconds (the eager warm-up and its sync, entering the
capture, recording the body's launches, instantiating the graph on
exit, the first replay's launch) and the pool bytes it added, and each
capture logs them with its key.

Launch counts.  A kernel wrapper counts its launch when its Python code
runs, which under capture is once per captured launch and never on a
replay.  The capture's counts are therefore taken back out of the
wrappers' counters and kept per graph (``BlockGraph.launches``); every
replay adds them to ``DecodeGraphs.launches``, by wrapper name.  A
wrapper's launches on a path are its counter (eager launches, the
warm-up's included) plus that sum.

The cyclic garbage collector is off while a body is recorded.  Engines
live in reference cycles (the scheduler holds their callbacks), so a
dead engine's tensors, pinned host buffers among them, are freed by the
collector whenever it runs; a pinned buffer freed inside a capture
queries CUDA events, which a capture forbids, and the process aborts.
PyTorch's ``torch.cuda.graph`` no longer collects on entry, so the
collector is held off here and runs after the capture instead.
"""

from __future__ import annotations

import gc
import logging
import time
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from llm_d_tpu_torch.ops import (flash_prefill, mla_decode, mla_prefill,
                                 moe_int8, moe_routed, moe_routed_stream,
                                 paged_attention)

# The kernel wrappers, by the (module, attribute) their callers look them
# up through (a test or the smoke may install a recording wrapper there,
# which then carries the count).
KERNEL_WRAPPERS = (
    (mla_decode, "mla_paged_decode_update"),
    (mla_prefill, "mla_flash_prefill"),
    (moe_int8, "dense_moe_int8"),
    (moe_routed, "routed_moe_int8"),
    (moe_routed_stream, "streamed_moe_int8"),
    (moe_int8, "grouped_moe_int8"),
    (paged_attention, "paged_attention_decode_update"),
    (flash_prefill, "flash_prefill_paged"),
)


def kernel_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count in this process, by name."""
    return {name: getattr(mod, name).launches
            for mod, name in KERNEL_WRAPPERS}


logger = logging.getLogger(__name__)


class BlockGraph:
    """One captured block: its static inputs and outputs, the launches it
    holds, and two pinned host copies of its outputs that alternate
    between dispatches (a retiring block reads its own copy while its
    successor's replay overwrites the outputs)."""

    def __init__(self, key: Hashable, inputs: Dict[str, torch.Tensor],
                 outputs: Dict[str, torch.Tensor]) -> None:
        self.key = key
        self.inputs = inputs
        self.outputs = outputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.cold: Dict[str, float] = {}
        self.host = [{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                      for k, v in outputs.items()} for _ in range(2)]
        self.turn = 0


class DecodeGraphs:
    """The block graphs of one engine, one per key, at most
    ``max_graphs`` of them in at most ``max_pool_bytes`` of pool (0: no
    cap)."""

    def __init__(self, device: torch.device, max_graphs: int = 0,
                 max_pool_bytes: int = 0) -> None:
        self.device = device
        self.max_graphs = max_graphs
        self.max_pool_bytes = max_pool_bytes
        self.pool = torch.cuda.graph_pool_handle()
        # In order of last use, the least recent first.
        self.graphs: "OrderedDict[Hashable, BlockGraph]" = OrderedDict()
        # Kernel launches made by replays, by wrapper name.
        self.launches: Dict[str, int] = {name: 0
                                         for _, name in KERNEL_WRAPPERS}
        self.replays = 0
        # Device memory reserved by the captures (the shared pool's
        # growth, measured around each capture, since it was last reset).
        self.pool_bytes = 0
        self.evictions = 0        # graphs dropped for a new key
        self.pool_resets = 0

    def block(self, key: Hashable,
              make: Callable[[], Tuple[Dict[str, torch.Tensor],
                                       Dict[str, torch.Tensor]]]
              ) -> BlockGraph:
        """The block graph of ``key``; ``make()`` allocates its static
        inputs and outputs the first time (not captured yet)."""
        g = self.graphs.get(key)
        if g is None:
            self._make_room()
            g = self.graphs[key] = BlockGraph(key, *make())
        else:
            self.graphs.move_to_end(key)
        return g

    def _make_room(self) -> None:
        """Before a new key: drop every graph and the pool if the pool is
        past ``max_pool_bytes``, else the least recently used graph if
        ``max_graphs`` are held."""
        full = bool(self.max_pool_bytes) \
            and self.pool_bytes > self.max_pool_bytes
        if not full and not (self.max_graphs
                             and len(self.graphs) >= self.max_graphs):
            return
        torch.cuda.synchronize(self.device)
        if full:
            logger.warning("graph pool at %d bytes, past its cap of %d: "
                           "dropping %d graphs", self.pool_bytes,
                           self.max_pool_bytes, len(self.graphs))
            self.evictions += len(self.graphs)
            self.graphs.clear()
            self.pool = torch.cuda.graph_pool_handle()
            self.pool_bytes = 0
            self.pool_resets += 1
            torch.cuda.empty_cache()
        else:
            self.graphs.popitem(last=False)
            self.evictions += 1

    @staticmethod
    def load(g: BlockGraph, values: Dict[str, object]) -> None:
        """Queue copies of ``values`` into ``g``'s static inputs on the
        current stream.  Host arrays go through pinned buffers that the
        caching host allocator keeps until their copy has run, so the
        caller may reuse its arrays at once; a device tensor (a
        predecessor block's ids or carry) is copied in stream order,
        after the replay that wrote it."""
        for name, v in values.items():
            dst = g.inputs[name]
            if isinstance(v, torch.Tensor):
                if v is not dst:
                    dst.copy_(v)
            else:
                src = torch.from_numpy(np.ascontiguousarray(v))
                dst.copy_(src.pin_memory(), non_blocking=True)

    def capture(self, g: BlockGraph, body: Callable[[int], None],
                K: int) -> None:
        """Warm ``body`` up (one iteration, eagerly, on a side stream),
        then capture its ``K`` iterations into ``g``.  Raises whatever the
        warm-up or the capture raises, and then drops ``g``'s key."""
        try:
            self._capture(g, body, K)
        except BaseException:
            self.graphs.pop(g.key, None)
            raise

    def _capture(self, g: BlockGraph, body: Callable[[int], None],
                 K: int) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body(1)
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        before = kernel_counts()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        t1 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                t2 = time.perf_counter()
                body(K)
                t3 = time.perf_counter()
        finally:
            if collecting:
                gc.enable()
            after = kernel_counts()
            for mod, name in KERNEL_WRAPPERS:
                getattr(mod, name).launches = before[name]
        t4 = time.perf_counter()
        grown = torch.cuda.memory_reserved(self.device) - reserved
        self.pool_bytes += grown
        g.launches = {n: after[n] - before[n] for n in after
                      if after[n] != before[n]}
        g.graph = graph
        g.cold = dict(warm_s=t1 - t0, enter_s=t2 - t1, record_s=t3 - t2,
                      instantiate_s=t4 - t3, pool_bytes=grown)
        logger.info("captured graph %s: %s", g.key, g.cold)

    def replay(self, g: BlockGraph) -> Tuple[Dict[str, torch.Tensor],
                                             torch.cuda.Event]:
        """Replay ``g`` on the current stream, then queue the copies of its
        outputs into the next of its pinned host buffers.  Returns those
        buffers and an event recorded after the copies: waiting on it
        waits for this block only, not for a successor queued after it."""
        t0 = time.perf_counter()
        g.graph.replay()
        if "first_replay_s" not in g.cold:
            g.cold["first_replay_s"] = time.perf_counter() - t0
        host = g.host[g.turn]
        g.turn ^= 1
        for name, out in g.outputs.items():
            host[name].copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        for name, n in g.launches.items():
            self.launches[name] += n
        g.replays += 1
        self.replays += 1
        return host, done


def replay_equals_eager(g: BlockGraph, cache: Dict[str, torch.Tensor],
                        eager: Callable[[Dict[str, torch.Tensor]], None],
                        trash_rows: int = 0) -> Dict[str, bool]:
    """Replays ``g`` on its static inputs, then runs ``eager`` (its body,
    writing into fresh outputs) on the same inputs from the same
    ``cache``: whether every output, and every cache row past the first
    ``trash_rows`` of each plane (block 0, which dead slots may write in
    any order), are bit-equal.  The cache is left as the body left it."""
    snap = {k: v.clone() for k, v in cache.items()}
    g.graph.replay()
    torch.cuda.synchronize()
    got = {k: v.clone() for k, v in g.outputs.items()}
    after = {k: v.clone() for k, v in cache.items()}
    for k, v in cache.items():
        v.copy_(snap[k])
    del snap
    out = {k: torch.empty_like(v) for k, v in g.outputs.items()}
    eager(out)
    torch.cuda.synchronize()
    return dict(
        outputs_equal=all(torch.equal(got[k], out[k]) for k in got),
        cache_equal=all(torch.equal(v[:, trash_rows:],
                                    after[k][:, trash_rows:])
                        for k, v in cache.items()))
