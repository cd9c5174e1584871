"""The port's hierarchy half-step against the reference: on the golden
problem (96x64x3src, both bf16 packs off) on the exact, windowed and
rectified paths (the reference's Pallas kernels in interpret mode), one
hierarchy half-step of each package from the reference's seeded init (the
ground-truth depth x (1 + 0.2 sin i) and normals): accept masks, the
hierarchy commit guard included, equal on >= 99.5% of pixels, as
test_torch_pass.py, with some pixels committing.

The reference's side is stored in tests/fixtures/ref_hier_{exact,window,
rect}.npz (``test_torch_prior_pass.build_reference``).  Regenerate them
(CPU, interpret mode, about 8 minutes):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_hier_pass.py --regen
"""

import sys

import pytest

pytest.importorskip("torch")

from test_torch_prior_pass import PATHS, check_halfstep, references  # noqa: E402
from torch_port_util import golden_scene, regen_references  # noqa: E402

REFERENCES = references("hier", PATHS)


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


@pytest.mark.parametrize("path", PATHS)
def test_hier_halfstep_from_identical_state(scene, path):
    check_halfstep(scene, path, "hier")


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen_references(REFERENCES)
