"""Device resolution for the port's entry points (no counterpart in
``ray_tpu``, where JAX picks the backend).

The port runs on the card by default. The CPU is used only when the
caller asks for it explicitly (the tests do); nothing falls back to
the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


class NoCudaError(RuntimeError):
    """CUDA was requested (explicitly or by default) but no card is
    visible to this process."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device; ``"cpu"`` -> the
    CPU. Raises :class:`NoCudaError` when CUDA is wanted but absent,
    and ``ValueError`` for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}: the port runs on "
                         f"'cuda' (default) or, when asked, 'cpu'")
    if not torch.cuda.is_available():
        raise NoCudaError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
