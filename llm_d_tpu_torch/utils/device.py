"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  A box
without a GPU raises instead of quietly serving on the CPU: the CPU path
exists for the parity tests, not for serving.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None,
                   local_rank: Optional[int] = None) -> torch.device:
    """``None`` means the first CUDA device, or for the rank
    ``local_rank`` of a mesh the card ``local_rank % device_count``
    (ranks share cards when there are fewer cards than ranks); ``"cpu"``
    must be explicit.

    On CUDA, bf16 matrix products are held to f32 reductions (cuBLAS may
    otherwise reduce split-K partials in bf16), as ``jnp.dot(...,
    preferred_element_type=f32)`` accumulates."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path explicitly")
        dev = torch.device("cuda", torch.cuda.current_device()
                           if local_rank is None
                           else local_rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is unavailable")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev
