"""Multi-problem execution over device slots (counterpart of
acmmp_spherical_tpu/parallel): the mesh, the view-parallel step, sharded
fusion and synthetic batches.  The tile-parallel pass is not ported yet."""

from acmmp_spherical_torch.parallel.mesh import (  # noqa: F401
    ViewMesh,
    make_view_mesh,
    shard_batch_over_views,
)
from acmmp_spherical_torch.parallel.view_parallel import (  # noqa: F401
    ProblemBatch,
    multichip_step,
)
