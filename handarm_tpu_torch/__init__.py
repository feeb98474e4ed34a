"""PyTorch + CUDA port of handarm_tpu for NVIDIA Hopper (H100).

The JAX package `handarm_tpu` stays the reference; this package imports
neither it nor JAX. Entry points run on `cuda` unless the caller passes
`device="cpu"`; kernels written by hand for sm_90a live in `csrc/` and are
reached through the wrappers in `ops/`, which take their plain PyTorch
versions only for tensors on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the card. Asking for CUDA where there is none raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
