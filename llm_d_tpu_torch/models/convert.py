"""Weight bridge: a parameter tree of numpy arrays -> the port's tensors.

The tree has the JAX package's layout (``embed``, ``dense_layers``,
``moe_layers``, ...), e.g. ``jax.tree.map(np.asarray, params)``.  bf16
arrays (``ml_dtypes.bfloat16``) cross as raw ``uint16`` bits, so values
are bit-identical on both sides; int8 payloads and f32 scales (from
``quantize_moe_experts``) cross as they are.  The MTP drafter's tree
(``init_draft_params``; the JAX engine's ``draft_params``) crosses the
same way and goes to ``EngineCore(..., draft_params=...)``.
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


def params_from_numpy(tree: Mapping[str, Any], device) -> dict:
    """Nested mapping of numpy arrays -> the same nesting of tensors on
    ``device``."""
    return {k: (params_from_numpy(v, device) if isinstance(v, Mapping)
                else tensor_from_numpy(np.asarray(v), device))
            for k, v in tree.items()}
