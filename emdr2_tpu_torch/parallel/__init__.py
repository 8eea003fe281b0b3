"""Data and tensor parallelism across processes, one per rank
(``torch.distributed``)."""

from emdr2_tpu_torch.parallel.distributed import (  # noqa: F401
    HostLayout,
    default_backend,
    host_layout,
    init_distributed,
    init_process_group,
    is_coordinator,
    process_count,
    process_index,
    rank_device,
)
from emdr2_tpu_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    Group,
    check_mesh_config,
    check_tp_divides,
    embed_devices,
    row_range,
    tp_groups_span_hosts,
)
