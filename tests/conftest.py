"""Test config: force a deterministic 8-device virtual CPU mesh.

Must set env before the first `import jax` anywhere in the test process
(SURVEY-mandated determinism; mirrors the reference's `testing`/
`deterministic` feature discipline, holo-ospf/Cargo.toml:49-52).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from holo_tpu.testing import force_virtual_cpu_mesh  # noqa: E402

force_virtual_cpu_mesh(8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips when none is present"
    )
