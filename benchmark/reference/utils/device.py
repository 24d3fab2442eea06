"""Where the port computes: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import functools

import numpy as np
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


def constant(values, dtype, device) -> torch.Tensor:
    """A tensor of fixed values (numbers, nested sequences or a numpy
    array), made once per (values, dtype, device) and then reused: code that
    a CUDA graph captures may not copy from pageable host memory, so model
    functions take their constant masks and vectors from here.  The tensor
    is shared: callers never write to it."""
    a = np.ascontiguousarray(values, dtype=np.float64)
    return _constant(a.tobytes(), a.shape, dtype, torch.device(device))


@functools.cache
def _constant(data: bytes, shape: tuple, dtype, device) -> torch.Tensor:
    # one entry per distinct constant of a model, dtype and device
    return torch.as_tensor(np.frombuffer(data, dtype=np.float64).reshape(shape).copy(), dtype=dtype, device=device)
