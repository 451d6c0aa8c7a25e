"""K-step decode blocks captured and replayed as CUDA graphs.

The JAX engine runs a block of K decode iterations as one ``lax.scan``
program: one dispatch and one host fetch per block.  PyTorch runs
eagerly, so the port captures the block's K iterations (a few thousand
kernel launches at the bench's size) into one CUDA graph per block key
and replays it: one launch from the host per block.

A graph reads and writes fixed addresses, so every block of one key goes
through the same static tensors: the inputs (``BlockGraph.inputs``,
allocated outside the capture and refilled before each replay) and the
output ids ``[K, S]`` (``BlockGraph.ids``).  The weights and the KV cache
are captured by address too: the engine never reassigns them after a
capture (every cache write is in place).

Before its capture a block's body runs one iteration eagerly on a side
stream, on the block's real inputs.  That builds and loads the kernels
and settles every cache a wrapper keeps (kernel A's ``num_splits``,
cuBLAS handles); its cache writes are the ones the replay then repeats,
bit for bit.  Intermediates of every capture share one memory pool:
replays run one after another on one stream.

Nothing here falls back to eager execution: a capture or a replay that
fails raises.

Launch counts.  A kernel wrapper counts its launch when its Python code
runs, which under capture is once per captured launch and never on a
replay.  The capture's counts are therefore taken back out of the
wrappers' counters and kept per graph (``BlockGraph.launches``); every
replay adds them to ``DecodeGraphs.launches``, by wrapper name.  A
wrapper's launches on a path are its counter (eager launches, the
warm-up's included) plus that sum.
"""

from __future__ import annotations

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


def _counts() -> Dict[str, int]:
    return {name: getattr(mod, name).launches
            for mod, name in KERNEL_WRAPPERS}


class BlockGraph:
    """One captured decode block: its static inputs and output, the
    launches it holds, and two pinned host copies of its output that
    alternate between dispatches (a retiring block reads its own copy
    while its successor's replay overwrites ``ids``)."""

    def __init__(self, inputs: Dict[str, torch.Tensor],
                 ids: torch.Tensor) -> None:
        self.inputs = inputs
        self.ids = ids
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.host = [torch.empty(ids.shape, dtype=ids.dtype,
                                 pin_memory=True) for _ in range(2)]
        self.turn = 0


class DecodeGraphs:
    """The decode-block graphs of one engine, one per key."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Hashable, BlockGraph] = {}
        # Kernel launches made by replays, by wrapper name.
        self.launches: Dict[str, int] = {name: 0
                                         for _, name in KERNEL_WRAPPERS}
        self.replays = 0
        # Device memory reserved by the captures (the shared pool's
        # growth, measured around each capture).
        self.pool_bytes = 0

    def block(self, key: Hashable,
              make: Callable[[], Tuple[Dict[str, torch.Tensor],
                                       torch.Tensor]]) -> BlockGraph:
        """The block graph of ``key``; ``make()`` allocates its static
        inputs and output the first time (not captured yet)."""
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = BlockGraph(*make())
        return g

    @staticmethod
    def load(g: BlockGraph, values: Dict[str, object]) -> None:
        """Queue copies of ``values`` into ``g``'s static inputs on the
        current stream.  Host arrays go through pinned buffers that the
        caching host allocator keeps until their copy has run, so the
        caller may reuse its arrays at once; a device tensor (a
        predecessor block's ids) is copied in stream order, after the
        replay that wrote it."""
        for name, v in values.items():
            dst = g.inputs[name]
            if isinstance(v, torch.Tensor):
                dst.copy_(v)
            else:
                src = torch.from_numpy(np.ascontiguousarray(v))
                dst.copy_(src.pin_memory(), non_blocking=True)

    def capture(self, g: BlockGraph, body: Callable[[int], None],
                K: int) -> None:
        """Warm ``body`` up (one iteration, eagerly, on a side stream),
        then capture its ``K`` iterations into ``g``.  Raises whatever the
        capture raises."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body(1)
        cur.wait_stream(side)
        torch.cuda.synchronize(self.device)
        before = _counts()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                body(K)
        finally:
            after = _counts()
            for mod, name in KERNEL_WRAPPERS:
                getattr(mod, name).launches = before[name]
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        g.launches = {n: after[n] - before[n] for n in after
                      if after[n] != before[n]}
        g.graph = graph

    def replay(self, g: BlockGraph) -> Tuple[torch.Tensor,
                                             torch.cuda.Event]:
        """Replay ``g`` on the current stream, then queue the copy of its
        ids into the next of its pinned host buffers.  Returns that buffer
        and an event recorded after the copy: waiting on it waits for
        this block only, not for a successor queued after it."""
        g.graph.replay()
        host = g.host[g.turn]
        g.turn ^= 1
        host.copy_(g.ids, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        for name, n in g.launches.items():
            self.launches[name] += n
        self.replays += 1
        return host, done
