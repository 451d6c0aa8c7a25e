"""Data-parallel engine group: one-device engine cores behind a local
dispatcher (port of ``llm_d_tpu.engine.dp_group``).

The reference's DP is N independent engine cores, each with its own
scheduler and KV cache, behind a local load balancer
(``--data-parallel-size`` with ``--data-parallel-mode ranks``).  Each rank
here is an :class:`EngineCore` on a device of its own (or a card shared
with other ranks, where the host has fewer cards than ranks), so a rank
holds only its own requests' KV.  The SPMD form, one engine over a ``(dp,
tp)`` mesh, is ``EngineConfig.mesh`` (``--data-parallel-mode spmd``).

Dispatch is least outstanding work (waiting + running sequences, plus
KV pulls in flight), the engine-level counterpart of the EPP's queue
scorer; prefix affinity across replicas stays the EPP's job.  This port
serves one device a rank: ``tp > 1`` per rank needs a process group per
rank's submesh and is refused by name.

Across hosts (``--data-parallel-size-local`` below the size) each host
runs a group of its local ranks, ``start_rank`` naming the first one's
global rank; the leader host's server proxies requests to the others
(``server/openai.py``, ``DPWorkerPool``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

from llm_d_tpu_torch.engine.engine import EngineConfig, EngineCore
from llm_d_tpu_torch.engine.request import Request, RequestOutput
from llm_d_tpu_torch.utils.device import resolve_device
from llm_d_tpu_torch.utils.metrics import EngineMetrics

logger = logging.getLogger(__name__)


def _indexed(device) -> torch.device:
    """``device`` with its card's index (an unindexed ``cuda`` is the
    current card): ranks compare and select cards by index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on_device(tree, device: torch.device):
    """``tree``'s tensors on ``device`` (the same tensors where they are
    already there)."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class DPEngineGroup:
    """``EngineCore``-compatible facade over ``dp_size`` one-device engine
    cores."""

    def __init__(self, config: EngineConfig, dp_size: int, params=None,
                 metrics: Optional[EngineMetrics] = None,
                 devices: Optional[List[torch.device]] = None,
                 start_rank: int = 0) -> None:
        """``start_rank`` is this host's first global rank in a multi-host
        deployment (``--data-parallel-start-rank``): it names the host's
        range of ranks, and the host with rank 0 is the leader that
        dispatches across hosts (the server's ``DPWorkerPool``).  Local
        resources, such as the offset of a rank's shared-tier port, stay
        offset by the local rank ``r``: ports are a namespace of the host,
        so a global offset would only set peers' configs apart across
        hosts.  The devices are this host's: ranks on different hosts are
        independent engines, never one mesh.

        ``devices`` are the ranks' devices, one a rank (the same card
        may come more than once: those ranks share it); by default rank
        ``r`` takes ``cuda:r % cards`` (``"cpu"`` for every rank with
        ``config.device="cpu"``).  A list of another length than
        ``dp_size`` is an error unless ``allow_device_subset`` (then the
        first ``dp_size`` serve), as is a default that idles cards.
        ``params`` (a tree of tensors, or ``None``: ``config.seed``'s
        draws) builds rank 0, whose weights go to the other ranks'
        devices (shared where the device is the same)."""
        if dp_size < 1:
            raise ValueError(f"dp_size must be >= 1, got {dp_size}")
        self.start_rank = start_rank
        tp = config.mesh.tp if config.mesh else 1
        sp = config.mesh.sp if config.mesh else 1
        if tp * sp > 1:
            raise ValueError(
                f"a DP group of dp={dp_size} ranks with tp={tp} x sp={sp} "
                "per rank is not served by the port: each rank's submesh "
                "needs a process group of its own (serve --data-parallel-"
                "mode spmd, or one device a rank)")
        if devices is None:
            devices = [resolve_device(config.device, r)
                       for r in range(dp_size)]
            cards = (torch.cuda.device_count()
                     if devices[0].type == "cuda" else 0)
            if cards > dp_size and not config.allow_device_subset:
                raise ValueError(
                    f"dp={dp_size} x tp=1 needs {dp_size} devices, host has "
                    f"{cards} (pass allow_device_subset to idle cards "
                    "deliberately)")
        devices = [_indexed(d) for d in devices]
        if len(devices) != dp_size and not (
                config.allow_device_subset and len(devices) > dp_size):
            raise ValueError(
                f"dp={dp_size} x tp=1 needs {dp_size} devices, got "
                f"{len(devices)} (pass allow_device_subset to idle devices "
                "deliberately)")
        devices = devices[:dp_size]
        self.config = config
        self.model_config = config.resolve_model()
        self.metrics = metrics or EngineMetrics(self.model_config.name)
        self.engines: List[EngineCore] = []
        for r, dev in enumerate(devices):
            rank_cfg = dataclasses.replace(
                config, mesh=None, device=str(dev),
                # A fixed shared-tier port would collide across ranks
                # (each rank's host tier binds its own server): offset it
                # by the rank; 0 / None stay as they are.
                kv_shared_tier_port=(
                    config.kv_shared_tier_port + r
                    if config.kv_shared_tier_port else
                    config.kv_shared_tier_port),
                allow_device_subset=True)
            shared = params
            if self.engines and not config.enable_eplb:
                # The other ranks serve rank 0's weights (its draws, or the
                # caller's tree as rank 0 quantized it); under EPLB each
                # rank installs a physical table of its own.
                shared = self.engines[0].params
            self.engines.append(EngineCore(
                rank_cfg, metrics=self.metrics,
                params=None if shared is None else _on_device(shared, dev)))
        self._rank_of: Dict[str, int] = {}
        # Ranks on devices of their own step concurrently (one rank's
        # prefill does not hold up the others' decodes); ranks sharing a
        # card step one after another, since a graph capture records the
        # whole card (global capture mode).
        cuda = [e.device for e in self.engines if e.device.type == "cuda"]
        self._concurrent = dp_size > 1 and len(set(cuda)) == len(cuda)
        self._pool = (ThreadPoolExecutor(
            max_workers=dp_size, thread_name_prefix="dp-rank")
            if self._concurrent else None)

    # ---------- EngineCore-compatible surface ----------

    @property
    def device(self) -> torch.device:
        return self.engines[0].device

    @property
    def tokenizer(self):
        return self.engines[0].tokenizer

    @tokenizer.setter
    def tokenizer(self, tok) -> None:
        for e in self.engines:
            e.tokenizer = tok

    @property
    def eos_token_id(self):
        return self.engines[0].eos_token_id

    @eos_token_id.setter
    def eos_token_id(self, tid) -> None:
        for e in self.engines:
            e.eos_token_id = tid

    @property
    def kv_manager(self):
        # KV events and offload hooks attach per rank: rank 0's here for
        # one-engine callers, every rank's in ``kv_managers``.
        return self.engines[0].kv_manager

    @property
    def kv_managers(self):
        return [e.kv_manager for e in self.engines]

    @property
    def kv_connector(self):
        return self.engines[0].kv_connector

    @kv_connector.setter
    def kv_connector(self, conn) -> None:
        if conn is not None and len(self.engines) > 1:
            # Each rank needs its own transfer server and completion
            # pump: a shared connector would admit rank A's pulls into
            # rank B.
            raise ValueError(
                "P/D connector on a dp > 1 group: pass the config to "
                "set_kv_connectors() for a connector a rank")
        self.engines[0].kv_connector = conn

    def set_kv_connectors(self, config) -> None:
        """One transfer server and connector a rank, explicit ports
        offset by the rank (0: each rank an ephemeral port).  Each rank
        advertises its own connector's port, so a consumer pulls from the
        rank that holds the blocks."""
        from llm_d_tpu_torch.transfer import TpuConnector
        for r, engine in enumerate(self.engines):
            engine.kv_connector = TpuConnector(dataclasses.replace(
                config, port=config.port + r if config.port else 0))

    @property
    def kv_connectors(self):
        return [e.kv_connector for e in self.engines]

    def close_kv_connectors(self) -> None:
        for e in self.engines:
            if e.kv_connector is not None:
                e.kv_connector.close()

    @property
    def scheduler(self):
        """The async engine's idle probe: a view over every rank's."""
        return _SchedulerView(self.engines)

    # ---------- dispatch ----------

    def _pick_rank(self) -> int:
        loads = []
        for e in self.engines:
            load = e.scheduler.num_waiting + e.scheduler.num_running
            if e.kv_connector is not None:
                load += e.kv_connector.num_pending_loads
            loads.append(load)
        return loads.index(min(loads))

    def add_request(self, request: Request) -> None:
        rank = self._pick_rank()
        self._rank_of[request.request_id] = rank
        self.engines[rank].add_request(request)

    def abort_request(self, request_id: str) -> None:
        rank = self._rank_of.get(request_id)
        if rank is None:
            for e in self.engines:
                e.abort_request(request_id)
        else:
            self.engines[rank].abort_request(request_id)

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    @staticmethod
    def _step_rank(engine: EngineCore) -> List[RequestOutput]:
        if engine.device.type == "cuda":
            # PyTorch keeps the current card per thread.
            torch.cuda.set_device(engine.device)
        return engine.step()

    def step(self) -> List[RequestOutput]:
        outputs: List[RequestOutput] = []
        busy = [e for e in self.engines if e.has_work()]
        if self._pool is not None and len(busy) > 1:
            # Every future's result is read: a rank's failure raises here.
            for outs in self._pool.map(self._step_rank, busy):
                outputs.extend(outs)
        else:
            for e in busy:
                outputs.extend(self._step_rank(e))
        for out in outputs:
            if out.finished:
                self._rank_of.pop(out.request_id, None)
        self._update_gauges()
        return outputs

    def _update_gauges(self) -> None:
        """Gauges over every rank (each rank's step set its own)."""
        self.metrics.num_requests_waiting.set(
            sum(e.scheduler.num_waiting for e in self.engines))
        self.metrics.num_requests_running.set(
            sum(e.scheduler.num_running for e in self.engines))
        self.metrics.kv_cache_usage_perc.set(
            sum(e.kv_manager.usage for e in self.engines) / len(self.engines))

    def generate(self, requests: List[Request], max_steps: int = 10000
                 ) -> Dict[str, List[int]]:
        for r in requests:
            self.add_request(r)
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
            if not self.scheduler.has_work() and self.has_work():
                time.sleep(0.001)
        return {r.request_id: list(r.output_token_ids) for r in requests}

    def close(self) -> None:
        """Stop the ranks' step threads."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class _SchedulerView:
    def __init__(self, engines: List[EngineCore]) -> None:
        self._engines = engines

    def has_work(self) -> bool:
        return any(e.scheduler.has_work() for e in self._engines)

    @property
    def num_waiting(self) -> int:
        return sum(e.scheduler.num_waiting for e in self._engines)

    @property
    def num_running(self) -> int:
        return sum(e.scheduler.num_running for e in self._engines)
