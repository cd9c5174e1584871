"""The port's hierarchy half-step against the reference: on the golden
problem (96x64x3src, both bf16 packs off) on the exact, windowed and
rectified paths (the reference's Pallas kernels in interpret mode), one
hierarchy half-step of each package from the reference's seeded init (the
ground-truth depth x (1 + 0.2 sin i) and normals): accept masks, the
hierarchy commit guard included, equal on >= 99.5% of pixels, as
test_torch_pass.py, with some pixels committing."""

import pytest

pytest.importorskip("torch")

from test_torch_prior_pass import PATHS, check_halfstep  # noqa: E402
from torch_port_util import golden_scene  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


@pytest.mark.parametrize("path", PATHS)
def test_hier_halfstep_from_identical_state(scene, path):
    check_halfstep(scene, path, "hier")
