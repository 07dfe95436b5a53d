"""The port's one device rule.

Entry points that build tensors take ``device=`` and resolve it here.  The
default is the CUDA card (``cuda:<LOCAL_RANK>`` under ``torchrun``, one
rank per card); when there is none this raises rather than quietly
running on the host — the CPU is used only when a caller asks for it
(``device="cpu"``, as the tests do).
"""
from __future__ import annotations

import functools
import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")`` (``cuda:<LOCAL_RANK>`` when
    the environment names a local rank); anything else is taken as given.
    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and no CUDA device is present."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda" if local is None else f"cuda:{local}")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the host")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the launchers
    size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
