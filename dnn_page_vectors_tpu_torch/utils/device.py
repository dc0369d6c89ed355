"""Device resolution for the port's entry points.

``device=None`` means the GPU. There is no silent fallback to the CPU: the
CPU runs only when the caller asks for it by name (the tests do), and a
request for ``cuda`` with no GPU present raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def set_precision() -> None:
    """Full-precision float32 matmuls and convolutions. The JAX top-k scorer
    runs at Precision.HIGHEST because ranking fidelity depends on it; TF32
    keeps about three decimal digits, so it stays off everywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and none
    is present. Only an explicit ``"cpu"`` selects the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run on the CPU")
    set_precision()
    return dev
