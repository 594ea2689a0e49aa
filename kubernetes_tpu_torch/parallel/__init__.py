"""The node-axis mesh of the scan (port of ``kubernetes_tpu/parallel``)."""

from .mesh import (
    NODE_AXIS,
    Mesh,
    assert_collective_structure,
    loop_in_specs,
    loop_out_specs,
    make_mesh,
    match_partition_rules,
    mesh_dispatch_span,
    place_state,
    place_static,
    schedule_batch_sharded,
    schedule_batch_sharded_verified,
    sharded_hlo,
    state_specs,
    static_specs,
    unplace_state,
)
