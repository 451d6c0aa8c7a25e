"""Device mesh of the port (port of ``llm_d_tpu.parallel.mesh``).

The JAX package builds one ``jax.sharding.Mesh`` and lets XLA insert the
collectives.  The port runs one process per mesh position (a *rank*),
joined by ``torch.distributed``, and calls the collectives itself:
:class:`Mesh` holds this rank's ``(dp, sp, tp)`` coordinate and one
process group per axis plus the EP group (every rank), and runs each
collective the model needs over them.

Axes, as in JAX:
  - ``dp``: data parallelism over requests (DP attention): each dp index
    serves its own requests' attention over its own KV plane
    (``parallel/dp_attention.py``);
  - ``sp``: sequence parallelism (ring attention);
  - ``tp``: tensor parallelism within a replica.
Expert parallelism runs over the flattened ``(dp, sp, tp)`` axes, so the
EP degree is the whole mesh.  The ranks lie on the grid row-major, as
:func:`select_devices` (JAX's ``make_mesh``) arranges them: rank ``d * tp
+ t`` is dp index ``d``, tp index ``t``.  :meth:`Mesh.from_process_group`
makes one process group for each line of ranks along each axis (the tp
ranks of one ``(dp, sp)`` index, the sp ranks of one ``(dp, tp)`` index,
...), and the EP group is every rank (the default group).  A mesh with an
sp axis carries ring attention (``ops/ring_attention.py``); the engine
serves ``sp > 1`` by the JAX engine's rule (:func:`check_served`).

Across hosts (a LeaderWorkerSet group) every host runs its share of the
ranks, joined into one process group at the leader's address
(:func:`lws_distributed_args`, :func:`lws_rank_layout`).

Backend rule (logged, and no knob): ``nccl`` when every rank of this host
has a CUDA card of its own, ``gloo`` on the CPU and when ranks share a
card (NCCL refuses two ranks on one GPU).  Under gloo on CUDA tensors every
collective is staged through host memory (``Mesh.stage_host``): that is
the transport of ranks that share a card.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

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
    """The engine's rule, the JAX engine's (``engine/engine.py``): dp and
    sp on one mesh are refused, in its words; either alone is served."""
    if config.dp > 1 and config.sp > 1:
        raise ValueError(
            "SPMD dp and sp are mutually exclusive in-engine (ring "
            "attention shards sequences, dp shards requests)")


def backend_for(device: torch.device, local_ranks: int) -> str:
    """The process-group backend: ``nccl`` when each of this host's
    ``local_ranks`` ranks has its own CUDA card, ``gloo`` on the CPU or
    when ranks share a card."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_ranks:
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


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Where this host's ranks lie in a mesh of ``world`` ranks: ``local``
    ranks, global ranks ``first .. first + local - 1``, joined at
    ``address`` ("host:port"; global rank 0 hosts the store)."""
    world: int
    local: int
    first: int
    address: str
    hosts: int

    @property
    def leader(self) -> bool:
        """This host holds global rank 0."""
        return self.first == 0


def lws_rank_layout(world: int, env: Optional[dict] = None
                    ) -> Optional[RankLayout]:
    """The rank layout of a mesh of ``world`` ranks across the hosts of a
    LeaderWorkerSet group (:func:`lws_distributed_args`): each of the
    ``LWS_GROUP_SIZE`` hosts runs ``world / LWS_GROUP_SIZE`` ranks, host
    ``LWS_WORKER_INDEX`` global ranks ``index * local + r``, all joined at
    the leader's address (JAX's coordinator port 8476 unless it names
    one).  None outside a group of more than one host; a mesh that does not
    divide over the hosts raises, by name."""
    lws = lws_distributed_args(env)
    if lws is None or lws["world_size"] <= 1:
        return None
    hosts, index = lws["world_size"], lws["rank"]
    if world % hosts:
        raise ValueError(
            f"a mesh of {world} ranks does not divide over the "
            f"LWS_GROUP_SIZE={hosts} hosts of the LeaderWorkerSet group")
    if not 0 <= index < hosts:
        raise ValueError(f"LWS_WORKER_INDEX={index} lies outside the "
                         f"LWS_GROUP_SIZE={hosts} hosts")
    local = world // hosts
    return RankLayout(world=world, local=local, first=index * local,
                      address=lws["init_method"][len("tcp://"):],
                      hosts=hosts)


# This process's rank among its host's ranks (set by init_distributed).
_local_rank: Optional[int] = None


def local_rank() -> int:
    """This process's rank among its host's ranks: the index that picks
    its card (the global rank when one host runs the whole mesh)."""
    if _local_rank is not None:
        return _local_rank
    import torch.distributed as dist
    return dist.get_rank()


def init_distributed(rank: int, world: int, address: str,
                     device: torch.device,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     local: Optional[Tuple[int, int]] = None) -> str:
    """Join the ranks' process group at ``address`` ("host:port"; rank 0
    hosts its store, which listens on every interface) on the backend
    :func:`backend_for` picks for this host's ranks; returns it.
    ``local`` is ``(this process's rank on its host, the host's rank
    count)``, by default ``(rank, world)``: one host runs the mesh."""
    import torch.distributed as dist
    global _local_rank
    _local_rank, local_ranks = local if local is not None else (rank, world)
    backend = backend_for(device, local_ranks)
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
        self._grid = grid
        pos = np.argwhere(grid == rank)[0]
        self.coord = dict(zip(MESH_AXES, (int(p) for p in pos)))
        self.shape = dict(zip(MESH_AXES, grid.shape))
        self._groups = groups if groups is not None else {}
        # Bytes each rank put on the wire, and the calls it made, by
        # collective (host counts).
        self.wire_bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

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
        axes = tuple(a for a in axes if self.shape[a] > 1)
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
        self.calls[kind] = self.calls.get(kind, 0) + 1

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

    def all_to_all(self, x: torch.Tensor, axis=AXIS_EP,
                   in_splits: Optional[Sequence[int]] = None,
                   out_splits: Optional[Sequence[int]] = None
                   ) -> torch.Tensor:
        """Equal split of dim 0 over ``axis``: chunk ``i`` goes to rank
        ``i``, and the chunks received land in source order (JAX's tiled
        ``all_to_all`` with split and concat axis 0).  ``in_splits`` /
        ``out_splits`` (rows sent to / received from each rank, known on
        both sides) make the split uneven."""
        return self.all_to_all_async(x, axis, in_splits, out_splits).wait()

    def all_to_all_async(self, x: torch.Tensor, axis=AXIS_EP,
                         in_splits: Optional[Sequence[int]] = None,
                         out_splits: Optional[Sequence[int]] = None
                         ) -> "PendingExchange":
        """:meth:`all_to_all` issued without waiting for it: ``.wait()``
        on the result returns what :meth:`all_to_all` would.  Under gloo
        on CUDA tensors the copy to the host runs before the issue (the
        caller waits for it), the copy back after the wait.  The same
        bytes are counted."""
        import torch.distributed as dist
        n = self.axis_size(axis)
        if n == 1:
            return PendingExchange(None, x, x.device)
        xs = self._wire(x)
        if out_splits is None:
            out = torch.empty_like(xs)
            self._count("all_to_all", xs, (n - 1) / n)
        else:
            out = xs.new_empty((sum(out_splits),) + tuple(xs.shape[1:]))
            me = self.axis_index(axis)
            row = xs[0].numel() * xs.element_size() if xs.shape[0] else 0
            sent = sum(c for i, c in enumerate(in_splits) if i != me)
            self.wire_bytes["all_to_all"] = \
                self.wire_bytes.get("all_to_all", 0) + sent * row
            self.calls["all_to_all"] = self.calls.get("all_to_all", 0) + 1
        work = dist.all_to_all_single(
            out, xs, output_split_sizes=None if out_splits is None
            else list(out_splits), input_split_sizes=None
            if in_splits is None else list(in_splits),
            group=self.group(axis), async_op=True)
        return PendingExchange(work, out, x.device)

    def region_ranks(self, dp_index: int) -> List[int]:
        """The ranks of dp shard ``dp_index``, in tp order."""
        return [int(r) for r in self._grid[dp_index].reshape(-1)]

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Point to point: ``x`` (on the host or this rank's device) to
        rank ``dst``, which calls :meth:`recv` with its shape and dtype."""
        import torch.distributed as dist
        xs = x.contiguous().to("cpu" if self.stage_host else self.device)
        self._count("send", xs, 1)
        dist.send(xs, dst)

    def recv(self, shape, dtype: torch.dtype, src: int) -> torch.Tensor:
        """Point to point: the tensor rank ``src`` sends, on this rank's
        device."""
        import torch.distributed as dist
        out = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if self.stage_host else self.device)
        dist.recv(out, src)
        return out.to(self.device)

    def ring_shift(self, x: torch.Tensor, axis=AXIS_SP) -> torch.Tensor:
        """``x`` to the next rank along ``axis`` (index ``i`` to ``i + 1``
        mod n, the other coordinates kept), and the previous rank's ``x``
        back (JAX's ``ppermute`` with ``[(i, (i + 1) % n)]``).  Both are
        posted at once, so the ring cannot deadlock."""
        import torch.distributed as dist
        i = MESH_AXES.index(axis)
        n = self._grid.shape[i]
        if n == 1:
            return x
        pos = [self.coord[a] for a in MESH_AXES]
        nxt, prv = list(pos), list(pos)
        nxt[i], prv[i] = (pos[i] + 1) % n, (pos[i] - 1) % n
        xs = self._wire(x)
        out = torch.empty_like(xs)
        self._count("ring_shift", xs, 1)
        works = [dist.isend(xs, int(self._grid[tuple(nxt)])),
                 dist.irecv(out, int(self._grid[tuple(prv)]))]
        for w in works:
            w.wait()
        return out.to(x.device)


class PendingExchange:
    """An issued :meth:`Mesh.all_to_all_async`: :meth:`wait` blocks until
    the exchange is done and returns the rows received, on the caller's
    device.  A failed exchange raises there."""

    def __init__(self, work, out: torch.Tensor, device: torch.device):
        self._work, self._out, self._device = work, out, device

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out.to(self._device)


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
        store = distributed_c10d._get_default_store()
        # The channel's key: rank 0 draws it from the store's counter and
        # broadcasts it, so every rank addresses the same messages however
        # many channels (a P/D pair on the same ranks builds two) this
        # process made before.
        key = torch.zeros(1, dtype=torch.int64, device=mesh.device
                          if mesh.backend == "nccl" else "cpu")
        if mesh.rank == 0:
            key += store.add("llmd_steps/channels", 1)
        dist.broadcast(key, src=0)
        self._store = dist.PrefixStore(f"llmd_steps/{int(key)}/", store)
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
