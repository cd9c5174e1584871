"""Scene io: .dmb rasters, PLY clouds, camera and pair files, images and
the resume manifest (counterpart of acmmp_spherical_tpu/io)."""

from acmmp_spherical_torch.io.dmb import (  # noqa: F401
    read_depth_dmb, read_dmb, read_normal_dmb, write_dmb,
)
from acmmp_spherical_torch.io.ply import read_ply, write_ply  # noqa: F401
from acmmp_spherical_torch.io.scene import (  # noqa: F401
    Problem, ScenePaths, load_image_color, load_image_gray, read_camera_file,
    read_pair_file, write_camera_file, write_pair_file,
)
