"""Parameter sharding rules (port of ``llm_d_tpu.parallel.sharding``).

A rule table is ``(regex over the "/"-joined parameter path, spec)``, the
JAX package's tables verbatim, where a spec is a tuple with one entry per
leading dimension: ``None`` (replicated), an axis name, or a tuple of
axis names (flattened row-major, as the EP entry ``("dp", "sp", "tp")``).
Dimensions past the spec are replicated, as with a JAX ``PartitionSpec``.

Where JAX hands the table to ``jax.jit`` and XLA inserts collectives, the
port slices each rank's shard out of the full tensor
(:func:`shard_tensor`, :func:`shard_tree`): each rank's shard shape is
JAX's ``NamedSharding(mesh, spec).shard_shape`` for the same table,
shape and mesh, and its values JAX's addressable shard on that device.
The model modules run the collectives those tables imply.

The rules name ``dp`` and ``sp`` only in the routed experts' EP entry
``("dp", "sp", "tp")``: those shard ``1/(dp*sp*tp)`` over every rank,
while dense weights, attention and the shared expert shard over ``tp``
and are replicated over ``dp`` and ``sp`` (each ``(dp, sp)`` index holds
the same tp shards), as JAX places them.  The KV pool's dp split is the
engine's (``[L, slots / dp, W]`` a rank, ``engine/engine.py``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, List, Mapping, Sequence, \
    Tuple

import torch

Spec = Tuple[Any, ...]
# One rule: (regex over "/"-joined param path, spec).
ShardingRules = Sequence[Tuple[str, Spec]]


def spec_for_path(rules: ShardingRules, path: str, leaf: Any) -> Spec:
    if len(getattr(leaf, "shape", ())) == 0:
        return ()
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    return ()  # replicate by default


def tree_leaves(params: Mapping, prefix: str = ""
                ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested mapping, paths "/"-joined as JAX joins
    its pytree keys."""
    for k, v in params.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from tree_leaves(v, p)
        else:
            yield p, v


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _mesh_shape(mesh) -> Dict[str, int]:
    """Axis sizes of a port ``Mesh``, a ``MeshConfig`` or a dict."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if hasattr(mesh, "shape") and isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return {"dp": mesh.dp, "sp": mesh.sp, "tp": mesh.tp}


def validate_divisibility(rules: ShardingRules, params: Mapping,
                          mesh) -> List[str]:
    """Human-readable problems where a sharded dim doesn't divide (the
    JAX function's messages)."""
    shape = _mesh_shape(mesh)
    problems: List[str] = []
    for p, leaf in tree_leaves(params):
        spec = spec_for_path(rules, p, leaf)
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = _axes(entry)
            size = 1
            for a in axes:
                size *= shape[a]
            if leaf.shape[dim] % size:
                problems.append(
                    f"{p}: dim {dim} ({leaf.shape[dim]}) % mesh{axes}="
                    f"{size} != 0")
    return problems


def shard_slices(full_shape: Sequence[int], spec: Spec, mesh_shape: Mapping,
                 coord: Mapping) -> Tuple[slice, ...]:
    """The slice of a full tensor that the rank at ``coord`` holds."""
    out = []
    for dim, n in enumerate(full_shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = _axes(entry)
        size, idx = 1, 0
        for a in axes:
            size *= mesh_shape[a]
            idx = idx * mesh_shape[a] + coord[a]
        step = n // size
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_shape(full_shape: Sequence[int], spec: Spec,
                mesh) -> Tuple[int, ...]:
    shape = _mesh_shape(mesh)
    zero = {a: 0 for a in shape}
    return tuple(s.stop - s.start
                 for s in shard_slices(full_shape, spec, shape, zero))


def shard_tensor(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` (a contiguous copy
    when the shard is smaller than ``x``)."""
    sl = shard_slices(x.shape, spec, mesh.shape, mesh.coord)
    if all(s.stop - s.start == n for s, n in zip(sl, x.shape)):
        return x
    return x[sl].contiguous()


def shard_tree(params: Mapping, rules: ShardingRules, mesh,
               convert: Callable[[Any], torch.Tensor] = None) -> Dict:
    """This rank's shards of a nested tree of full tensors (or, with
    ``convert``, of arrays ``convert`` turns into tensors after slicing,
    so only the shard is converted)."""
    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                out[k] = walk(v, p)
                continue
            spec = spec_for_path(rules, p, v)
            sl = shard_slices(v.shape, spec, mesh.shape, mesh.coord)
            part = v[sl] if len(v.shape) else v
            out[k] = convert(part) if convert is not None else (
                part.contiguous() if part is not v else v)
        return out
    return walk(params, "")
