"""Device mesh of the port (port of ``llm_d_tpu.parallel.mesh``).

The JAX package builds one ``jax.sharding.Mesh`` and lets XLA insert the
collectives.  The port runs one process per mesh position (a *rank*),
joined by ``torch.distributed``, and calls the collectives itself:
:class:`Mesh` holds this rank's ``(dp, sp, tp)`` coordinate and one
process group per axis plus the EP group (every rank), and runs each
collective the model needs over them.

Axes, as in JAX:
  - ``dp``: data parallelism over requests (DP attention);
  - ``sp``: sequence parallelism (ring attention);
  - ``tp``: tensor parallelism within a replica.
Expert parallelism runs over the flattened ``(dp, sp, tp)`` axes, so the
EP degree is the whole mesh.  This slice serves ``dp = sp = 1``: DP
attention and ring attention are refused by name.

Backend rule (logged, and no knob): ``nccl`` when every rank has a CUDA
card of its own, ``gloo`` on the CPU and when ranks share a card (NCCL
refuses two ranks on one GPU).  Under gloo on CUDA tensors every
collective is staged through host memory (``Mesh.stage_host``): that is
the transport of ranks that share a card.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

AXIS_DP = "dp"
AXIS_SP = "sp"
AXIS_TP = "tp"
# Logical EP axis = all mesh axes flattened (a spec entry tuple).
AXIS_EP: Tuple[str, ...] = (AXIS_DP, AXIS_SP, AXIS_TP)
MESH_AXES = (AXIS_DP, AXIS_SP, AXIS_TP)

# Collective timeout of a rank: a peer that dies or hangs fails the
# collective after this long instead of hanging the rank for good.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.sp * self.tp

    @property
    def ep(self) -> int:
        """Expert-parallel degree: all devices participate in MoE EP."""
        return self.num_devices


def select_devices(config: Optional[MeshConfig], devices: Sequence,
                   allow_subset: bool = False) -> np.ndarray:
    """``devices`` arranged as the ``(dp, sp, tp)`` grid, row-major, as
    JAX's ``make_mesh`` arranges them (same defaults, same errors): no
    config puts every device on ``tp``; a config smaller than the device
    list is an error unless ``allow_subset``."""
    devices = list(devices)
    if config is None:
        config = MeshConfig(tp=len(devices))
    if allow_subset and config.num_devices < len(devices):
        devices = devices[:config.num_devices]
    if config.num_devices != len(devices):
        raise ValueError(
            f"mesh {config} needs {config.num_devices} devices, got "
            f"{len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return arr.reshape(config.dp, config.sp, config.tp)


def check_served(config: MeshConfig) -> None:
    """Refuse the mesh axes this slice does not serve, by name."""
    if config.dp > 1:
        raise ValueError(
            f"mesh {config}: dp > 1 (DP attention, the stacked KV pool) is "
            "not served by the port yet")
    if config.sp > 1:
        raise ValueError(
            f"mesh {config}: sp > 1 (ring attention) is not served by the "
            "port yet")


def backend_for(device: torch.device, world: int) -> str:
    """The process-group backend: ``nccl`` when every rank has its own
    CUDA card, ``gloo`` on the CPU or when ranks share a card."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def lws_distributed_args(env: Optional[dict] = None,
                         coordinator_port: int = 8476) -> Optional[dict]:
    """LeaderWorkerSet rank bootstrap -> ``init_process_group`` arguments
    (the JAX function's, from the same environment: ``LWS_LEADER_ADDRESS``,
    ``LWS_GROUP_SIZE``, ``LWS_WORKER_INDEX``).  None outside LWS."""
    env = env if env is not None else os.environ
    leader = env.get("LWS_LEADER_ADDRESS")
    if not leader:
        return None
    if ":" not in leader:
        leader = f"{leader}:{coordinator_port}"
    return dict(
        init_method=f"tcp://{leader}",
        world_size=int(env.get("LWS_GROUP_SIZE", "1")),
        rank=int(env.get("LWS_WORKER_INDEX", "0")))


def init_distributed(rank: int, world: int, address: str,
                     device: torch.device,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the ranks' process group at ``address`` ("host:port"; rank 0
    hosts it) on the backend :func:`backend_for` picks; returns it."""
    import torch.distributed as dist
    backend = backend_for(device, world)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    if rank == 0:
        logger.info("mesh: %d ranks on %s (%s)", world, backend,
                    "each rank its own card" if backend == "nccl" else
                    "ranks share a card, collectives staged through host "
                    "memory" if device.type == "cuda" else "CPU")
    return backend


class Mesh:
    """This rank's view of the mesh: its coordinate, the process group of
    each axis and of EP, and the collectives over them.

    Every collective runs in the same order on every rank of its group
    (they are SPMD calls); results are identical on every rank."""

    def __init__(self, config: MeshConfig, rank: int, world: int,
                 device: torch.device, backend: str = "gloo",
                 allow_subset: bool = False, groups: Optional[Dict] = None):
        check_served(config)
        grid = select_devices(config, list(range(world)), allow_subset)
        if rank >= config.num_devices:
            raise ValueError(f"rank {rank} lies outside mesh {config}")
        self.config = config
        self.rank = rank
        self.world = config.num_devices
        self.device = torch.device(device)
        self.backend = backend
        # gloo on CUDA tensors: stage each collective through the host.
        self.stage_host = backend == "gloo" and self.device.type == "cuda"
        pos = np.argwhere(grid == rank)[0]
        self.coord = dict(zip(MESH_AXES, (int(p) for p in pos)))
        self.shape = dict(zip(MESH_AXES, grid.shape))
        self._groups = groups if groups is not None else {}
        # Bytes each rank put on the wire, by collective (host counts).
        self.wire_bytes: Dict[str, int] = {}

    @classmethod
    def from_process_group(cls, config: MeshConfig, device: torch.device,
                           allow_subset: bool = False) -> "Mesh":
        """The mesh over the initialized default process group; creates
        the axis groups (a collective call on every rank)."""
        import torch.distributed as dist
        world, rank = dist.get_world_size(), dist.get_rank()
        grid = select_devices(config, list(range(world)), allow_subset)
        groups = {}
        for axis_i, axis in enumerate(MESH_AXES):
            size = grid.shape[axis_i]
            if size == 1 or size == grid.size:
                continue          # trivial, or the whole world
            moved = np.moveaxis(grid, axis_i, -1).reshape(-1, size)
            for ranks in moved:
                g = dist.new_group([int(r) for r in ranks])
                if rank in ranks:
                    groups[axis] = g
        return cls(config, rank, world, device,
                   backend=dist.get_backend(), allow_subset=allow_subset,
                   groups=groups)

    # ---------- axes ----------

    @property
    def size(self) -> int:
        return self.world

    def axis_size(self, axis) -> int:
        axes = axis if isinstance(axis, tuple) else (axis,)
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def axis_index(self, axis) -> int:
        """Row-major index of this rank along ``axis`` (a name or a tuple
        of names, as a spec entry flattens them)."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord[a]
        return i

    def group(self, axis):
        axes = axis if isinstance(axis, tuple) else (axis,)
        if self.axis_size(axes) == self.world:
            return None                       # the default (world) group
        if len(axes) == 1:
            return self._groups[axes[0]]
        raise ValueError(f"no process group for axes {axes}")

    # ---------- collectives ----------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.stage_host else t

    def _count(self, kind: str, t: torch.Tensor, factor: float) -> None:
        self.wire_bytes[kind] = self.wire_bytes.get(kind, 0) + int(
            t.numel() * t.element_size() * factor)

    def all_reduce(self, x: torch.Tensor, axis=AXIS_TP,
                   op: str = "sum") -> torch.Tensor:
        """Sum (or max) of ``x`` over ``axis``; a new tensor on x's
        device."""
        import torch.distributed as dist
        n = self.axis_size(axis)
        if n == 1:
            return x
        y = self._wire(x).clone()
        self._count("all_reduce", y, 2 * (n - 1) / n)
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group(axis))
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor, axis=AXIS_TP,
                   dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in axis order
        (JAX's tiled ``all_gather``)."""
        import torch.distributed as dist
        n = self.axis_size(axis)
        if n == 1:
            return x
        xs = self._wire(x)
        outs = [torch.empty_like(xs) for _ in range(n)]
        self._count("all_gather", xs, n - 1)
        dist.all_gather(outs, xs, group=self.group(axis))
        return torch.cat(outs, dim=dim).to(x.device)

    def all_to_all(self, x: torch.Tensor, axis=AXIS_EP) -> torch.Tensor:
        """Equal split of dim 0 over ``axis``: chunk ``i`` goes to rank
        ``i``, and the chunks received land in source order (JAX's tiled
        ``all_to_all`` with split and concat axis 0)."""
        import torch.distributed as dist
        n = self.axis_size(axis)
        if n == 1:
            return x
        xs = self._wire(x)
        out = torch.empty_like(xs)
        self._count("all_to_all", xs, (n - 1) / n)
        dist.all_to_all_single(out, xs, group=self.group(axis))
        return out.to(x.device)


# A follower's wait for rank 0's next step is cut into waits this long
# (a wait returns as soon as the step is posted), so an idle server's
# ranks wait past any store timeout.
STEP_POLL_S = 60.0


class StepChannel:
    """Rank 0's orders to the other ranks of an engine mesh, one message
    per engine step, through the process group's store (so an idle
    server's ranks wait without a collective timing out).  A message is
    pickled; the last rank to read it deletes it.  ``None`` stops the
    followers."""

    def __init__(self, mesh: Mesh):
        import torch.distributed as dist
        from torch.distributed import distributed_c10d
        self._store = dist.PrefixStore(
            "llmd_steps/", distributed_c10d._get_default_store())
        self._readers = mesh.world - 1
        self._seq = 0
        self.leader = mesh.rank == 0

    def send(self, msg) -> None:
        import pickle
        self._store.set(str(self._seq), pickle.dumps(msg))
        self._seq += 1

    def recv(self):
        import pickle
        key = str(self._seq)
        while True:
            try:
                self._store.wait(
                    [key], datetime.timedelta(seconds=STEP_POLL_S))
                break
            except Exception as e:       # a poll ran out: wait on
                if "timeout" not in f"{type(e).__name__} {e}".lower():
                    raise
        msg = pickle.loads(self._store.get(key))
        if self._store.add(f"read/{key}", 1) == self._readers:
            self._store.delete_key(key)
            self._store.delete_key(f"read/{key}")
        self._seq += 1
        return msg
