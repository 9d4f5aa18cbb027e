"""The port's dispatch mesh (``holo_tpu.parallel``'s counterpart): a (batch,
node) grid of torch devices in one process.  The batch axis splits every
lane batch across its devices; the node axis fixes the row padding of the
residents and splits nothing yet (see :mod:`holo_tpu_torch.parallel.mesh`)."""

from holo_tpu_torch.parallel.mesh import (  # noqa: F401 (public API)
    Mesh,
    configure_process_mesh,
    make_spf_mesh,
    mesh_cache_key,
    mesh_stats,
    pad_graph_rows,
    process_mesh,
    reset_process_mesh,
    shard_repair_rows,
    shard_roots,
    shard_scenarios,
    sharded_whatif_program,
    virtual_devices,
)
