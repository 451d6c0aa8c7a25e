"""EPLB: expert-parallel load balancing with redundant experts (port of
``llm_d_tpu.parallel.eplb``).

The reference enables this via ``--enable-eplb --eplb-config '{"window_size":
1000, "step_interval": 3000, "num_redundant_experts": 32, ...}'`` (reference:
guides/wide-ep-lws/manifests/modelserver/base/decode.yaml:79,100-104): hot
experts get extra physical replicas so per-device work evens out, with the
divisibility constraint (E + redundant) % n_devices == 0.

The planner (``plan_placement``, ``align_plan``, ``plan_delta``,
``LoadTracker``, ``EplbConfig``) is the JAX package's, line for line: it is
host-side numpy.  The controller keeps the JAX controller's arguments,
clamping, counters and metrics, and applies a placement change as a LIVE
MIGRATION on the engine's one device:

  1. **delta plans** — a fresh greedy placement is ALIGNED to the current
     one (``align_plan``) and only the changed slots become moves, gated
     by imbalance-threshold hysteresis (``LLMD_EPLB_IMBALANCE_THRESHOLD``)
     and min-delta suppression;
  2. **background staging** — each engine tick copies at most
     ``LLMD_EPLB_MOVE_BUDGET`` changed slots (int8 ``_q``/``_s`` planes
     included) from the serving weights into a spare slab that holds the
     moved slots only.  On a card the copies run on a side CUDA stream
     after everything already queued on the compute stream (a previous
     flip's writes included) and record an event; on the CPU they are
     plain copies.  The serving weights are read-only sources throughout;
  3. **in-place flip** — once every move is staged and the slab is ready
     (``torch.cuda.Event.query``, never a host block), the compute stream
     waits on the staging event and the staged slots and the new
     ``replica_table`` / ``num_replicas`` are written INTO the serving
     tensors (``index_copy_`` / ``copy_``).  Their addresses never change,
     so every captured CUDA graph stays valid.  A dispatch already queued
     on the stream runs before the copies and keeps the old consistent
     table-and-weights pair; the next dispatch sees the new pair — the
     JAX flip's guarantee, given here by stream order.  The host time of
     the flip is ``last_flip_stall_s`` and the
     ``llmd_tpu:eplb_migration_stall_seconds`` metric.

Plans are PER LAYER (the replica tables are stacked ``[Lm, E, max_r]``).
On one device ``ep`` is 1: the redundancy clamps to 0 and every plan aligns
to the identity, so the engine's controller records routed ids, publishes
the imbalance gauge and suppresses; the staging and the flip are exercised
at ``ep`` > 1 on one device by the tests and the smoke.

On a mesh (``EplbController(..., mesh=)``, the JAX controller's install
and staging over an EP-sharded array): each rank holds its ``P / ep``
physical slots ``[Lm, P / ep, ...]`` and the replicated tables.
``install`` moves each slot's logical expert to its rank, and a move
whose source slot lies on another rank ships that slot's rows (every
expert-major key: the int8 planes and their scales) by one uneven
``all_to_all`` a staging tick (:func:`exchange_slots`); the bytes each
rank sends and receives across ranks are counted.  The schedule is rank
0's alone: at each retire it decides (``on_step``) whether the next step
begins a migration (shipping its target plans), stages a batch or
flips, and every rank, rank 0 included, carries the decision out at the
top of the next step (``apply``), when rank 0's step message has
brought it.  The staging exchange runs on the compute stream, so the
flip that follows a tick's last batch needs no event.

Plan algorithm (greedy, deterministic):
  1. replicas per logical expert ∝ load (largest-remainder rounding, every
     expert gets ≥ 1);
  2. physical slots pack onto shards with longest-processing-time binning
     under the fixed slots-per-shard capacity.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_d_tpu_torch.utils.config import env_float, env_int

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EplbPlan:
    num_logical: int
    phys_to_logical: np.ndarray      # [P] i32: physical slot -> logical expert
    replica_table: np.ndarray        # [E, max_r] i32: logical -> phys slots
    num_replicas: np.ndarray         # [E] i32
    slots_per_shard: int             # P // ep

    @property
    def num_physical(self) -> int:
        return len(self.phys_to_logical)


def _plan_from_p2l(phys_to_logical: np.ndarray, num_logical: int,
                   slots_per_shard: int) -> EplbPlan:
    """Rebuild the replica table/counts from a slot assignment."""
    E = num_logical
    counts = np.bincount(phys_to_logical, minlength=E)
    max_r = int(counts.max())
    replica_table = np.zeros((E, max_r), np.int32)
    num_replicas = np.zeros(E, np.int32)
    for p, e in enumerate(phys_to_logical):
        replica_table[e, num_replicas[e]] = p
        num_replicas[e] += 1
    for e in range(E):                           # pad with first replica
        replica_table[e, num_replicas[e]:] = replica_table[e, 0]
    return EplbPlan(E, phys_to_logical.astype(np.int32), replica_table,
                    num_replicas, slots_per_shard)


def plan_placement(
    load: Sequence[float],           # per-logical-expert observed load
    num_redundant: int,
    ep: int,
) -> EplbPlan:
    """Place E + num_redundant physical experts over ``ep`` shards."""
    load = np.asarray(load, np.float64)
    E = len(load)
    P = E + num_redundant
    if P % ep:
        raise ValueError(
            f"(experts {E} + redundant {num_redundant}) must divide over "
            f"ep={ep} (reference constraint, decode.yaml:100-104)")
    spp = P // ep

    # 1. Replica counts: proportional to load, in [1, ep] each, sum = P.
    # (More than ep replicas of one expert adds no parallelism — extras
    # would share a shard with themselves.)
    total = max(load.sum(), 1e-12)
    ideal = load / total * P
    counts = np.clip(np.floor(ideal).astype(int), 1, ep)
    while counts.sum() > P:                      # too many: trim coldest >1
        cand = np.where(counts > 1)[0]
        counts[cand[np.argmin(load[cand])]] -= 1
    rema = ideal - np.floor(ideal)
    while counts.sum() < P:                      # largest remainder first
        order = np.argsort(-rema)
        progressed = False
        for e in order:
            if counts.sum() >= P:
                break
            if counts[e] >= ep:
                continue
            counts[e] += 1
            rema[e] = -1                         # one bonus per round
            progressed = True
        if not progressed:
            rema = ideal - np.floor(ideal)
            if (counts >= ep).all():
                raise ValueError("num_redundant too large: every expert "
                                 "already has ep replicas")

    # 2. Pack replicas onto shards: heaviest replica first into the least
    # loaded shard with a free slot.
    per_replica = load / counts                  # load a single replica carries
    replicas: List[tuple] = []                   # (weight, logical)
    for e in range(E):
        replicas += [(per_replica[e], e)] * counts[e]
    replicas.sort(key=lambda t: -t[0])

    shard_load = np.zeros(ep)
    shard_slots: List[List[int]] = [[] for _ in range(ep)]
    for w, e in replicas:
        open_shards = [s for s in range(ep) if len(shard_slots[s]) < spp]
        s = min(open_shards, key=lambda s: (shard_load[s], s))
        shard_slots[s].append(e)
        shard_load[s] += w

    phys_to_logical = np.asarray(
        [e for s in range(ep) for e in shard_slots[s]], np.int32)
    return _plan_from_p2l(phys_to_logical, E, spp)


def gather_physical(logical_weights, plan: EplbPlan):
    """The physical expert-weight array ``[P, ...]`` of logical weights
    ``[E, ...]`` (numpy or torch) by the plan."""
    if isinstance(logical_weights, torch.Tensor):
        return logical_weights.index_select(0, torch.as_tensor(
            plan.phys_to_logical, dtype=torch.long,
            device=logical_weights.device))
    return logical_weights[plan.phys_to_logical]


# ---------------------------------------------------------------------------
# Delta planning: align a fresh placement to the serving one, then diff.
# ---------------------------------------------------------------------------


def align_plan(new_plan: EplbPlan, cur_plan: EplbPlan) -> EplbPlan:
    """Permute ``new_plan``'s slot assignment WITHIN each shard so slots
    that already hold the right expert keep it.

    A shard's slot order is semantically arbitrary (the replica table is
    rebuilt from the assignment), so any intra-shard permutation serves
    the same placement.  Aligning before diffing is what makes delta
    plans small: a fresh greedy pack of near-identical load would
    otherwise reshuffle every slot.  An identical placement aligns to
    ZERO moves."""
    spp = new_plan.slots_per_shard
    if cur_plan.slots_per_shard != spp or \
            cur_plan.num_logical != new_plan.num_logical:
        raise ValueError("align_plan: plans have different geometry")
    ep = new_plan.num_physical // spp
    aligned = np.full(new_plan.num_physical, -1, np.int32)
    for s in range(ep):
        lo = s * spp
        cur = cur_plan.phys_to_logical[lo:lo + spp]
        want = collections.Counter(
            new_plan.phys_to_logical[lo:lo + spp].tolist())
        free: List[int] = []
        for i in range(spp):
            e = int(cur[i])
            if want.get(e, 0) > 0:               # keep the occupant
                aligned[lo + i] = e
                want[e] -= 1
            else:
                free.append(lo + i)
        rest = sorted(e for e, n in want.items() for _ in range(n))
        for i, e in zip(free, rest):
            aligned[i] = e
    return _plan_from_p2l(aligned, new_plan.num_logical, spp)


def plan_delta(cur_plan: EplbPlan,
               new_plan: EplbPlan) -> List[Tuple[int, int]]:
    """``(dst_slot, src_slot)`` moves turning ``cur_plan`` into
    ``new_plan``.  The source is the CURRENT canonical replica of the
    expert the destination slot will hold — valid for the whole
    migration because staging only reads the serving weights, which
    change only at the flip; unchanged slots produce no move."""
    moves: List[Tuple[int, int]] = []
    for p, e in enumerate(new_plan.phys_to_logical):
        if cur_plan.phys_to_logical[p] != e:
            moves.append((p, int(cur_plan.replica_table[e, 0])))
    return moves


# ---------------------------------------------------------------------------
# Load tracking
# ---------------------------------------------------------------------------


class LoadTracker:
    """Sliding-window per-expert token counts (the ``window_size`` /
    ``step_interval`` knobs of the reference's eplb-config).

    The window counts ENGINE STEPS, not samples: each record carries the
    number of steps it represents (1 on the classic path, K for a fused
    K-round retire, ``record_interval`` when sampling), so sampling or
    fused dispatch never silently widens the window.  Eviction is O(1)
    amortized (deque).  Samples with a leading layer axis (``[Lm, ...,
    k]``) additionally accumulate per-layer counts for per-layer plans;
    ``load`` stays the layer-aggregated view."""

    def __init__(self, num_experts: int, window_size: int = 1000):
        self.num_experts = num_experts
        self.window_size = window_size
        self._counts = np.zeros(num_experts, np.int64)
        self._layer_counts: Optional[np.ndarray] = None   # [Lm, E]
        self._history: Deque[Tuple[int, np.ndarray,
                                   Optional[np.ndarray]]] = \
            collections.deque()
        self._steps = 0                     # total steps in the window

    def record(self, expert_ids: np.ndarray, steps: int = 1) -> None:
        """Record routed expert ids covering ``steps`` engine steps.

        ``expert_ids`` with ndim >= 3 is layer-leading (``[Lm, ..., k]``,
        the model's ``collect_routed`` stack) and feeds per-layer counts;
        flatter shapes count aggregate-only."""
        ids = np.asarray(expert_ids)
        E = self.num_experts
        flat = np.bincount(ids.reshape(-1), minlength=E).astype(np.int64)
        layer = None
        if ids.ndim >= 3 and ids.shape[0] > 0:
            Lm = ids.shape[0]
            off = (np.arange(Lm, dtype=np.int64)[:, None]
                   * E + ids.reshape(Lm, -1))
            layer = np.bincount(off.reshape(-1),
                                minlength=Lm * E).astype(np.int64)
            layer = layer.reshape(Lm, E)
            if self._layer_counts is None \
                    or self._layer_counts.shape[0] != Lm:
                self._layer_counts = np.zeros((Lm, E), np.int64)
            self._layer_counts += layer
        self._history.append((max(1, int(steps)), flat, layer))
        self._counts += flat
        self._steps += max(1, int(steps))
        while self._steps > self.window_size and len(self._history) > 1:
            n, old_flat, old_layer = self._history.popleft()
            self._steps -= n
            self._counts -= old_flat
            if old_layer is not None and self._layer_counts is not None \
                    and self._layer_counts.shape == old_layer.shape:
                self._layer_counts -= old_layer

    @property
    def load(self) -> np.ndarray:
        return self._counts.astype(np.float64)

    @property
    def layer_load(self) -> Optional[np.ndarray]:
        """[Lm, E] per-layer load, or None before any layer-resolved
        sample arrived."""
        if self._layer_counts is None:
            return None
        return self._layer_counts.astype(np.float64)

    def imbalance(self) -> float:
        """max/mean per-expert load (1.0 = perfectly even)."""
        mean = self.load.mean()
        return float(self.load.max() / mean) if mean > 0 else 1.0


def _expert_major_keys(moe_layers: Dict[str, Any]) -> List[str]:
    """Keys of [L, E, ...] expert-major arrays (incl. int8 _q/_s pairs)."""
    return [n for n in moe_layers
            if n.startswith(("w_gate", "w_up", "w_down"))]


@dataclasses.dataclass
class EplbConfig:
    """Engine-facing knobs mirroring the reference's ``--eplb-config``
    (decode.yaml:79,100-104).  ``imbalance_threshold`` / ``move_budget``
    default to the env knobs (``LLMD_EPLB_IMBALANCE_THRESHOLD`` /
    ``LLMD_EPLB_MOVE_BUDGET``) when unset."""
    num_redundant_experts: int = 0       # 0 -> auto: pad E to ep multiple + ep
    window_size: int = 1000
    step_interval: int = 3000            # engine steps between rebalances
    record_interval: int = 1             # sample routed ids every N steps
    imbalance_threshold: Optional[float] = None   # hysteresis gate (None=env)
    move_budget: Optional[int] = None    # slot copies staged per tick (None=env)
    min_delta_slots: int = 1             # suppress plans moving fewer slots

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "EplbConfig":
        d = d or {}
        thr = d.get("imbalance_threshold")
        budget = d.get("move_budget")
        return cls(
            num_redundant_experts=int(d.get("num_redundant_experts", 0)),
            window_size=int(d.get("window_size", 1000)),
            step_interval=int(d.get("step_interval", 3000)),
            record_interval=int(d.get("record_interval", 1)),
            imbalance_threshold=None if thr is None else float(thr),
            move_budget=None if budget is None else int(budget),
            min_delta_slots=int(d.get("min_delta_slots", 1)))


# ---------------------------------------------------------------------------
# Live migration state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Migration:
    """One in-flight placement change: target per-layer plans, the move
    queue still to stage, and the spare slab being built (one row per
    move, ``targets[i]`` the (layer, dst_slot) row i lands in)."""
    plans: List[EplbPlan]                      # target plan per layer
    moves: Deque[Tuple[int, int, int]]         # (layer, dst_slot, src_slot)
    total_moves: int
    staged: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    targets: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    staged_bytes: int = 0
    started_step: int = 0
    event: Any = None                          # staging done (CUDA only)


def exchange_slots(mesh, planes: Sequence[torch.Tensor],
                   moves: Sequence[Tuple[int, int, int]],
                   src_per_rank: int, dst_per_rank: int
                   ) -> Tuple[List[torch.Tensor], int, int]:
    """The rows of slot moves ``(layer, dst_slot, src_slot)`` (global
    slot ids) whose destination lies on this rank, in move order, for
    every plane: ``planes`` are this rank's ``[Lm * src_per_rank, ...]``
    row views of the source layout (``src_per_rank`` slots a rank), the
    destination layout has ``dst_per_rank`` slots a rank.  One uneven
    ``all_to_all`` over the EP group carries every plane's rows packed;
    a move within a rank crosses no wire.  Every rank runs it with the
    same moves.  Returns (rows per plane, bytes sent to other ranks,
    bytes received from them)."""
    from llm_d_tpu_torch.ops.moe import _pack_rows, _unpack_rows
    from llm_d_tpu_torch.parallel.mesh import AXIS_EP
    ep = mesh.axis_size(AXIS_EP)
    me = mesh.axis_index(AXIS_EP)
    send: List[List[int]] = [[] for _ in range(ep)]
    recv: List[List[int]] = [[] for _ in range(ep)]
    for i, (li, dst, src) in enumerate(moves):
        s_rank, d_rank = src // src_per_rank, dst // dst_per_rank
        if s_rank == me:
            send[d_rank].append(li * src_per_rank + src % src_per_rank)
        if d_rank == me:
            recv[s_rank].append(i)
    dev = planes[0].device
    rows = _index([r for d in send for r in d], dev)
    packed = _pack_rows(*(p.index_select(0, rows) for p in planes))
    got = mesh.all_to_all(packed, AXIS_EP, [len(d) for d in send],
                          [len(r) for r in recv])
    # Received source-major; back to move order.
    arrival = [i for r in recv for i in r]
    got = got.index_select(0, _index(np.argsort(arrival, kind="stable"),
                                     dev))
    row_bytes = packed.shape[1]
    sent = sum(len(d) for r, d in enumerate(send) if r != me) * row_bytes
    received = sum(len(x) for r, x in enumerate(recv) if r != me) * row_bytes
    widths = [(p.dtype, p[0].numel()) for p in planes]
    out = [u.reshape((-1,) + tuple(p.shape[1:]))
           for u, p in zip(_unpack_rows(got, *widths), planes)]
    return out, sent, received


def _index(values: Sequence[int], device) -> torch.Tensor:
    """int64 index tensor on ``device`` (through pinned memory on a card,
    so the copy queues without a host wait)."""
    t = torch.tensor(list(values), dtype=torch.long)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class EplbController:
    """Serving-path EPLB: installs the physical expert table into a MoE
    model's params, records routed logical ids, and applies placement
    changes as live migrations (no logical-weight copy is kept: every
    logical expert always has >= 1 physical replica, so any new placement
    is reachable by slot-to-slot copies of current physical weights).

    Plans are per MoE layer; one move budget is amortized across layers.
    ``metrics`` (utils.metrics.EngineMetrics) is an optional sink the
    engine wires after construction.  Without ``mesh`` the physical table
    lives on the engine's one device, and ``ep`` only shapes the plans;
    with it, ``ep`` is the mesh's and each rank holds its slots (module
    docstring)."""

    def __init__(self, num_experts: int, ep: int, config: EplbConfig,
                 mesh=None) -> None:
        self.E = num_experts
        self.ep = ep
        self.config = config
        self.mesh = mesh
        if mesh is not None and mesh.size != ep:
            raise ValueError(f"eplb: ep {ep} is not the mesh's {mesh.size}")
        # Bytes this rank sent to / received from other ranks (mesh).
        self.sent_bytes = 0
        self.received_bytes = 0
        # Rank 0's decision for the next step (mesh): None, ("tick",) or
        # ("begin", step, [phys_to_logical per layer]).
        self._decision: Optional[tuple] = None
        r = config.num_redundant_experts
        if r <= 0:
            # Auto: one extra slot per shard after padding E up to a multiple.
            r = (-num_experts) % ep + ep
        # Feasibility: every replica of one expert must land on a distinct
        # shard (c <= ep), so at most E*(ep-1) redundant slots exist — on a
        # single shard (ep=1) redundancy is meaningless and clamps to 0.
        r_max = num_experts * (ep - 1)
        if r > r_max:
            logger.warning("eplb: clamping num_redundant_experts %d -> %d "
                           "(E=%d, ep=%d)", r, r_max, num_experts, ep)
            r = r_max
        r -= (num_experts + r) % ep     # keep the divisibility constraint
        if r < 0 or (num_experts + r) % ep:
            raise ValueError(
                f"(experts {num_experts} + redundant {r}) must divide over "
                f"ep={ep} (reference constraint, decode.yaml:100-104)")
        self.num_redundant = r
        # Static replica-table width: an expert with c replicas consumes
        # c - 1 redundant slots, so c <= r + 1 (and > ep adds nothing).
        self.max_r = min(ep, r + 1)
        self.plans: List[EplbPlan] = [
            plan_placement(np.ones(num_experts), r, ep)]
        self.n_layers = 1               # install() sets the real count
        self.tracker = LoadTracker(num_experts, config.window_size)
        self.imbalance_threshold = (
            config.imbalance_threshold
            if config.imbalance_threshold is not None
            else env_float("LLMD_EPLB_IMBALANCE_THRESHOLD", 1.0))
        self.move_budget = max(1, (
            config.move_budget if config.move_budget is not None
            else env_int("LLMD_EPLB_MOVE_BUDGET", 64)))
        self.num_rebalances = 0         # completed migrations (flips)
        self.num_suppressed = 0         # plans skipped by hysteresis/min-delta
        self.migrated_bytes = 0
        self.last_flip_stall_s = 0.0
        self.metrics = None             # EngineMetrics (engine wires it)
        self._migration: Optional[_Migration] = None
        self._last_rebalance_step = 0
        self._last_record_step = 0
        self._side: Optional[torch.cuda.Stream] = None

    @property
    def plan(self) -> EplbPlan:
        """First layer's plan (the whole table before any migration —
        kept as the single-plan view for tools/tests)."""
        return self.plans[0]

    @property
    def migrating(self) -> bool:
        return self._migration is not None

    # ---------- param plumbing ----------

    def _stacked_tables(self, n_layers: int,
                        plans: Optional[List[EplbPlan]] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(replica_table [Lm, E, max_r], num_replicas [Lm, E]) int32."""
        plans = self.plans if plans is None else plans
        if len(plans) != n_layers:
            plans = [plans[0]] * n_layers
        rt = np.zeros((n_layers, self.E, self.max_r), np.int32)
        nr = np.zeros((n_layers, self.E), np.int32)
        for li, plan in enumerate(plans):
            w = plan.replica_table.shape[1]
            rt[li, :, :w] = plan.replica_table
            for e in range(self.E):
                rt[li, e, plan.num_replicas[e]:] = rt[li, e, 0]
            nr[li] = plan.num_replicas
        return rt, nr

    def install(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Replace logical expert weights with the physical table.

        ``params['moe_layers']['w_{gate,up,down}*']`` (int8 ``_q``/``_s``
        planes included): [Lm, E, ...] -> [Lm, P, ...] gathered by the
        initial plan into tensors of the controller's own (a flip writes
        them in place, so they never alias the caller's weights);
        ``replica_table`` [Lm, E, max_r] and ``num_replicas`` [Lm, E]
        (int32) join the layer stack.  Returns a new params dict; the
        caller's is left as it was."""
        ml = dict(params["moe_layers"])
        n_layers = ml["router"].shape[0]
        dev = ml["router"].device
        self.n_layers = n_layers
        self.plans = [self.plans[0]] * n_layers
        p2l = self.plans[0].phys_to_logical
        if self.mesh is not None:
            # This rank's slots, layer by layer, from the logical
            # experts' ranks ([Lm, E / ep, ...] -> [Lm, P / ep, ...]).
            e_loc = self.E // self.ep
            spp = self.plans[0].slots_per_shard
            names = _expert_major_keys(ml)
            out = {n: torch.empty((n_layers, spp) + tuple(ml[n].shape[2:]),
                                  dtype=ml[n].dtype, device=dev)
                   for n in names}
            moves = [(0, p, int(e)) for p, e in enumerate(p2l)]
            for li in range(n_layers):
                rows, sent, got = exchange_slots(
                    self.mesh, [ml[n][li] for n in names], moves, e_loc,
                    spp)
                for n, r in zip(names, rows):
                    out[n][li] = r
                self.sent_bytes += sent
                self.received_bytes += got
            ml.update(out)
        else:
            phys = torch.as_tensor(p2l, dtype=torch.long, device=dev)
            for name in _expert_major_keys(ml):
                ml[name] = ml[name].index_select(1, phys).contiguous()
        rt, nr = self._stacked_tables(n_layers)
        ml["replica_table"] = torch.tensor(rt, device=dev)
        ml["num_replicas"] = torch.tensor(nr, device=dev)
        out = dict(params)
        out["moe_layers"] = ml
        return out

    # ---------- serving loop hooks ----------

    def on_step(self, routed_ids, step: int,
                params: Dict[str, Any]) -> Dict[str, Any]:
        """The per-retire-boundary EPLB tick: record this boundary's
        routed logical ids (host data: the step's batched fetch), advance
        an in-flight migration by one staging budget (or flip it), and
        start a new migration on the interval.  Returns ``params``; the
        flip is the ONLY point where the tensors in it change (in place)."""
        if isinstance(routed_ids, torch.Tensor) and routed_ids.is_cuda:
            # Reading it here would sync the host on the device.
            raise TypeError("on_step takes routed ids on the host (from "
                            "the step's batched fetch), not a CUDA tensor")
        c = self.config
        # Interval CROSSING, not modulo: fused multi-step decode advances
        # the step counter by K, which would skip `step % interval == 0`
        # forever and silently disable recording/rebalancing.
        if routed_ids is not None \
                and step - self._last_record_step >= c.record_interval:
            self.tracker.record(np.asarray(routed_ids),
                                steps=step - self._last_record_step)
            self._last_record_step = step
        imb = self.tracker.imbalance()
        if self.metrics is not None:
            self.metrics.eplb_imbalance.set(imb)
        if self.mesh is None:
            # One device: decide and act at this retire.
            return self.apply(self._decide(step, imb), params)
        if self.mesh.rank == 0:
            self._decision = self._decide(step, imb)
        return params

    # ---------- the schedule (on a mesh rank 0 decides, every rank acts) --

    def _decide(self, step: int, imb: float) -> Optional[tuple]:
        """At a retire: advance an in-flight migration (``("tick",)``), or
        on the interval begin one to freshly planned targets (``("begin",
        step, [phys_to_logical per layer])``), or nothing (None).  One
        device acts on it at once; on a mesh rank 0 decides and every rank
        acts at the top of the next step."""
        if self._migration is not None:
            return ("tick",)
        if step - self._last_rebalance_step < self.config.step_interval \
                or self.tracker.load.sum() <= 0:
            return None
        self._last_rebalance_step = step
        if imb < self.imbalance_threshold:
            # Hysteresis: already balanced enough -- re-check next
            # interval instead of churning weights for noise.
            self.num_suppressed += 1
            logger.debug("eplb: imbalance %.3f < threshold %.3f, skipping "
                         "rebalance", imb, self.imbalance_threshold)
            return None
        targets = self._plan()
        moves = sum(len(plan_delta(p, t)) for p, t in zip(self.plans,
                                                            targets))
        if moves < max(1, self.config.min_delta_slots):
            # Min-delta suppression: an identity (or near-identity) plan
            # performs zero moves and costs nothing.
            if moves:
                self.num_suppressed += 1
            logger.debug("eplb: delta of %d move(s) below min %d, "
                         "suppressed", moves, self.config.min_delta_slots)
            return None
        return ("begin", step, [t.phys_to_logical for t in targets])

    def take_decision(self) -> Optional[tuple]:
        """Rank 0: the decision its next step message carries (once)."""
        d, self._decision = self._decision, None
        return d

    def apply(self, decision: Optional[tuple],
              params: Dict[str, Any]) -> Dict[str, Any]:
        """Carry out a decision (:meth:`_decide`; on a mesh every rank at
        the top of a step, in rank 0's order): begin a migration to the
        given plans (and stage its first batch), or stage the next batch;
        a tick whose staged slab is ready after its last batch flips."""
        if decision is None:
            return params
        if decision[0] == "begin":
            if self._migration is not None:
                raise RuntimeError("eplb: rank 0 began a migration while "
                                   "this rank has one in flight")
            _, step, p2ls = decision
            spp = self.plans[0].slots_per_shard
            targets = [_plan_from_p2l(np.asarray(p), self.E, spp)
                       for p in p2ls]
            self._start(targets, step)
        elif self._migration is None:
            raise RuntimeError("eplb: rank 0 ordered a staging tick but "
                               "this rank has no migration in flight")
        return self._migration_tick(params)

    # ---------- migration machinery ----------

    def _plan(self) -> List[EplbPlan]:
        """Per-layer targets from the observed (per-layer when available)
        load, each aligned to its serving plan."""
        n_layers = self.n_layers
        layer_load = self.tracker.layer_load
        if layer_load is None or layer_load.shape[0] != n_layers:
            layer_load = np.broadcast_to(
                self.tracker.load, (n_layers, self.E))
        return [align_plan(plan_placement(layer_load[li] + 1e-9,
                                          self.num_redundant, self.ep),
                           self.plans[li]) for li in range(n_layers)]

    def _start(self, targets: List[EplbPlan], step: int) -> None:
        """Queue the delta moves from the serving plans to ``targets``."""
        moves: Deque[Tuple[int, int, int]] = collections.deque(
            (li, dst, src) for li, t in enumerate(targets)
            for dst, src in plan_delta(self.plans[li], t))
        n_layers = self.n_layers
        self._migration = _Migration(
            plans=targets, moves=moves, total_moves=len(moves),
            started_step=step)
        logger.info("EPLB migration started: %d slot move(s) over %d "
                    "layer(s), budget %d/tick (imbalance %.2f)",
                    len(moves), n_layers, self.move_budget,
                    self.tracker.imbalance())

    def _migration_tick(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """One retire-boundary advance: stage up to ``move_budget`` moves
        (queued device copies), then flip once everything staged is
        ready.  NEVER host-blocks — an unready slab just defers the flip
        one tick."""
        m = self._migration
        assert m is not None
        if m.moves:
            batch = [m.moves.popleft()
                     for _ in range(min(self.move_budget, len(m.moves)))]
            staged_bytes = (self._stage(batch, params) if self.mesh is None
                            else self._stage_mesh(batch, params))
            m.staged_bytes += staged_bytes
            if self.metrics is not None:
                self.metrics.eplb_migrated_bytes.inc(staged_bytes)
        if not m.moves and self._staged_ready(m):
            return self._flip(params)
        return params

    def _side_stream(self, device) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(device)
        return self._side

    def _stage(self, batch: List[Tuple[int, int, int]],
               params: Dict[str, Any]) -> int:
        """Stage one batch of (layer, dst, src) slot copies into the spare
        slab (one row per move, allocated at the migration's first
        batch).  Sources always read the CURRENT serving weights, which
        change only at the flip, so staged rows are consistent whatever
        order the copies retire in.  The batch is padded to the budget by
        repeating its last move (an idempotent re-copy), as the JAX
        controller pads it.  Returns bytes staged."""
        m = self._migration
        assert m is not None
        ml = params["moe_layers"]
        names = _expert_major_keys(ml)
        dev = ml[names[0]].device
        base = len(m.targets)
        m.targets.extend((li, dst) for li, dst, _ in batch)
        pad = self.move_budget - len(batch)
        padded = batch + [batch[-1]] * pad
        rows = list(range(base, base + len(batch))) \
            + [base + len(batch) - 1] * pad
        if not m.staged:
            # The slab lives on the compute stream's pool: the side stream
            # writes it only after waiting for the compute stream, and the
            # compute stream reads it only after the staging event.
            for name in names:
                cur = ml[name]
                m.staged[name] = torch.empty(
                    (m.total_moves,) + tuple(cur.shape[2:]), dtype=cur.dtype,
                    device=dev)
        side = self._side_stream(dev) if dev.type == "cuda" else None
        ctx = contextlib.nullcontext()
        if side is not None:
            # After everything queued so far, a previous flip's in-place
            # writes included.
            side.wait_stream(torch.cuda.current_stream(dev))
            ctx = torch.cuda.stream(side)
        nbytes = 0
        P = ml[names[0]].shape[1]
        with ctx:
            # Each move's source slot as a row of the [Lm * P, ...] view.
            src = _index([li * P + s_ for li, _, s_ in padded], dev)
            slab_rows = _index(rows, dev)
            for name in names:
                cur = ml[name]
                if side is not None:
                    cur.record_stream(side)
                m.staged[name].index_copy_(0, slab_rows, cur.view(
                    (-1,) + tuple(cur.shape[2:])).index_select(0, src))
                per_slot = cur.element_size() * cur[0, 0].numel()
                nbytes += per_slot * len(batch)
            if side is not None:
                m.event = torch.cuda.Event()
                m.event.record(side)
        return nbytes

    def _stage_mesh(self, batch: List[Tuple[int, int, int]],
                    params: Dict[str, Any]) -> int:
        """:meth:`_stage` on a mesh: the batch's rows that land on this
        rank come from their source slots' ranks by
        :func:`exchange_slots` into the slab, in move order; each move is
        shipped once (the budget's padding would only re-ship a row).
        Runs on the compute stream.  Returns the bytes staged here."""
        m = self._migration
        assert m is not None
        ml = params["moe_layers"]
        names = _expert_major_keys(ml)
        spp = ml[names[0]].shape[1]
        me = self.mesh.rank
        mine = [(li, dst - me * spp) for li, dst, _ in batch
                if dst // spp == me]
        if not m.staged:
            n_mine = len(mine) + sum(1 for _, dst, _ in m.moves
                                     if dst // spp == me)
            for name in names:
                cur = ml[name]
                m.staged[name] = torch.empty(
                    (n_mine,) + tuple(cur.shape[2:]), dtype=cur.dtype,
                    device=cur.device)
        planes = [ml[n].view((-1,) + tuple(ml[n].shape[2:])) for n in names]
        rows, sent, got = exchange_slots(self.mesh, planes, batch, spp, spp)
        base = len(m.targets)
        for name, r in zip(names, rows):
            m.staged[name][base:base + len(mine)] = r
        m.targets.extend(mine)
        self.sent_bytes += sent
        self.received_bytes += got
        return sum(ml[n][0, 0].numel() * ml[n].element_size()
                   for n in names) * len(mine)

    @staticmethod
    def _staged_ready(m: _Migration) -> bool:
        """True when every staging copy has retired on the device —
        ``Event.query`` is a non-blocking poll, so the serving loop never
        waits on a weight copy."""
        return m.event is None or m.event.query()

    def _flip(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Write the staged slots and the new stacked tables into the
        serving tensors, in place, on the compute stream after the
        staging event: dispatches queued before it keep the old
        consistent table-and-weights pair, the next sees the new one, and
        every tensor keeps its address (captured graphs stay valid).
        Host time here is the stall metric (queued copies only)."""
        m = self._migration
        assert m is not None
        t0 = time.monotonic()
        ml = params["moe_layers"]
        names = list(m.staged)
        dev = ml[names[0]].device
        if m.event is not None:
            torch.cuda.current_stream(dev).wait_event(m.event)
        P = ml[names[0]].shape[1]
        flat = _index([li * P + dst for li, dst in m.targets], dev)
        for name in names:
            serving = ml[name]
            serving.view((-1,) + tuple(serving.shape[2:])).index_copy_(
                0, flat, m.staged[name])
        self.plans = list(m.plans)
        rt, nr = self._stacked_tables(self.n_layers)
        for name, host in (("replica_table", rt), ("num_replicas", nr)):
            src = torch.from_numpy(host)
            if dev.type == "cuda":
                src = src.pin_memory()
            ml[name].copy_(src, non_blocking=dev.type == "cuda")
        stall = time.monotonic() - t0
        self.num_rebalances += 1
        self.migrated_bytes += m.staged_bytes
        self.last_flip_stall_s = stall
        if self.metrics is not None:
            self.metrics.eplb_migrations.inc()
            self.metrics.eplb_migration_stall.observe(stall)
        self._migration = None
        logger.info("EPLB migration #%d flipped: %d move(s), %d bytes, "
                    "stall %.3f ms (imbalance %.2f)",
                    self.num_rebalances, m.total_moves, m.staged_bytes,
                    stall * 1e3, self.tracker.imbalance())
        return params
