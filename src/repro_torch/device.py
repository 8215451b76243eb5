"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the
    caller names another. With no GPU and no explicit device this raises —
    nothing carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           "available")
    return dev


def generator(gen: Union[torch.Generator, int],
              device: torch.device) -> torch.Generator:
    """``gen`` itself, or a generator on ``device`` seeded with it. Draws
    happen on the device that keeps the result."""
    if isinstance(gen, int):
        return torch.Generator(device=device).manual_seed(gen)
    if gen.device.type != device.type:
        raise ValueError(f"generator lives on {gen.device}, the result on "
                         f"{device}: draw on the device that keeps it")
    return gen


def on_device(data: dict, device: torch.device) -> dict:
    """A flat dict of tensors or numpy arrays, as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in data.items()}
