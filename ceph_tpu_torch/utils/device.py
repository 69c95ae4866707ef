"""Device selection for the port's entry points.

Everything runs on CUDA unless the caller asks for the CPU by name
(``device="cpu"``, or the profile key ``device=cpu``). With no CUDA
device and no such request, ``resolve`` raises: a run never carries on
quietly on the CPU and reports the CPU's speed as the card's.
"""

from __future__ import annotations

import torch


def resolve(requested: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``requested``, or ``cuda`` when it is None."""
    dev = torch.device("cuda" if requested in (None, "") else requested)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(profile key device=cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev


def describe(dev: torch.device) -> tuple[str, str]:
    """(platform, device name) for a result record: ("gpu", the CUDA
    device's name) or ("cpu", "cpu")."""
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"
