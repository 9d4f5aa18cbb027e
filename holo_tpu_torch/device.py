"""Default-device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; with no card present this raises instead
    of dropping to the CPU.  Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels on the host (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
