"""Multi-problem and intra-image execution over device slots (counterpart
of acmmp_spherical_tpu/parallel): the mesh, the view-parallel step, the
tile-parallel pass, sharded fusion and synthetic batches."""

from acmmp_spherical_torch.parallel.mesh import (  # noqa: F401
    ViewMesh,
    ViewTileMesh,
    make_view_mesh,
    make_view_tile_mesh,
    shard_batch_over_views,
)
from acmmp_spherical_torch.parallel.tile import (  # noqa: F401
    make_state_sharder,
    make_tile_mesh,
    tile_parallel_pass,
)
from acmmp_spherical_torch.parallel.view_parallel import (  # noqa: F401
    ProblemBatch,
    multichip_step,
)
