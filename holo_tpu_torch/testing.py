"""Test and dry-run helpers (``holo_tpu.testing``'s runtime checks).

``holo_tpu``'s ``force_virtual_cpu_mesh`` has its counterpart in the dispatch
mesh's device lists: ``holo_tpu_torch.parallel.mesh`` builds a mesh over any
list of torch devices, the CPU's or one card's repeated, so no platform
needs forcing.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def no_implicit_transfers():
    """Run the enclosed block under the transfer sanitizer: a synchronizing
    CUDA call outside the port's sanctioned windows
    (``analysis.runtime.sanctioned_transfer``: the flag reads, readbacks,
    uploads and host-copy waits) raises."""
    from holo_tpu_torch.analysis.runtime import transfer_sanitizer

    with transfer_sanitizer():
        yield


@contextlib.contextmanager
def donation_guarded():
    """Run the enclosed block under the donation guard: a dispatch whose
    finish reads a resident that an in-place seam moved since its launch,
    or that holds another generation, raises ``DonatedBufferError``."""
    from holo_tpu_torch.analysis.runtime import donation_guard

    with donation_guard():
        yield
