"""Where the port's tensors live when the caller does not say.

The port is built for one NVIDIA card: an entry point given no device puts
its tensors on ``cuda``.  A host without a card gets an error, never a
quiet fallback to the CPU; CPU use is asked for with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; None means the CUDA card, and raises
    on a host without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: diskann_tpu_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def generator(seed: int = 0, gen: torch.Generator | None = None,
              device=None) -> torch.Generator:
    """``gen`` if given, else a new generator on ``device`` seeded with
    ``seed``.  Every random draw of the port goes through one."""
    if gen is not None:
        return gen
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(seed)
