"""Weight bridge: a parameter tree of numpy arrays -> the port's tensors.

The tree has the JAX package's layout (``embed``, ``dense_layers``,
``moe_layers``, ...), e.g. ``jax.tree.map(np.asarray, params)``.  bf16
arrays (``ml_dtypes.bfloat16``) cross as raw ``uint16`` bits, so values
are bit-identical on both sides; int8 payloads and f32 scales (from
``quantize_moe_experts``) cross as they are.  The MTP drafter's tree
(``init_draft_params``; the JAX engine's ``draft_params``) crosses the
same way and goes to ``EngineCore(..., draft_params=...)``.

On a mesh, :func:`params_from_numpy` with ``mesh`` and the model's
``sharding_rules`` gives this rank's shards (each array sliced before it
is converted): JAX's addressable shards of the same tree on the rank's
device.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C", copy=True)   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Mapping[str, Any], device, mesh=None,
                      rules=None) -> dict:
    """Nested mapping of numpy arrays -> the same nesting of tensors on
    ``device``; with ``mesh`` and ``rules``, this rank's shards."""
    if mesh is not None:
        from llm_d_tpu_torch.parallel.sharding import shard_tree
        return shard_tree(tree, rules, mesh, convert=lambda a:
                          tensor_from_numpy(np.asarray(a), device))
    return {k: (params_from_numpy(v, device) if isinstance(v, Mapping)
                else tensor_from_numpy(np.asarray(v), device))
            for k, v in tree.items()}
