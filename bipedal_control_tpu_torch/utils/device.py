"""Where the port computes: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``torch.device("cuda")``).  Raises
    RuntimeError for a CUDA device where CUDA is absent, so nothing quietly
    runs on the CPU instead; the CPU is taken only when asked for
    (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the card by default and torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
