"""Device selection for the entry points."""

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is none.

    The entry points default to ``"cuda"``; they never fall back to the
    CPU on their own, so a caller that wants the CPU says so.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device

