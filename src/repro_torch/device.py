"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    ``cpu``. Asking for ``cuda`` where there is no card raises; nothing ever
    carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device cpu) "
                "to run on the CPU")
        return dev if dev.index is not None else torch.device("cuda", 0)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
