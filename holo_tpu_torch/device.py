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


class HostCopy:
    """Device tensors' copies to the host, queued behind the work that makes
    them: each CUDA tensor of ``tensors`` (name -> tensor) is copied into a
    fresh pinned host tensor with ``non_blocking=True`` on the current
    stream, and an event is recorded after the copies.  :meth:`wait` waits on
    that event and returns name -> host tensor.  CPU tensors are kept as
    they are.  The source tensors are held until the wait, so their memory
    cannot be reused before the copies read it.  ``queue=False`` queues
    nothing: :meth:`wait` reads each tensor back with ``.cpu()``, for a
    finish that follows its launch at once."""

    def __init__(self, tensors: dict, queue: bool = True):
        self._src = tensors
        self._event = self._host = None
        if not queue or not any(t.is_cuda for t in tensors.values()):
            return
        self._host = {}
        for name, t in tensors.items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host[name] = h.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def wait(self) -> dict:
        from holo_tpu_torch.analysis.runtime import sanctioned_transfer

        if self._src is None:  # waited already
            return self._host
        with sanctioned_transfer("host_copy.wait"):
            if self._host is None:
                self._host = {name: t.cpu() for name, t in self._src.items()}
            if self._event is not None:
                self._event.synchronize()
                self._event = None
        self._src = None
        return self._host
