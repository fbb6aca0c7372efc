"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (the default) and no card is present:
    the port never falls back to the CPU on its own.  Also turns TF32 off,
    since the CDF math and the 1x1 matmul need full fp32 (the reference
    uses ``Precision.HIGHEST`` there).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
