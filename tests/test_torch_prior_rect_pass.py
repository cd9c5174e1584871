"""The port's planar-prior init and half-step on the rectified path (rect +
warp transport, inverse attribution, both bf16 packs off) against the
reference in interpret mode, as test_torch_prior_pass.py holds the exact
and windowed paths: prior-init draws equal (offsets equal, normals within
1e-6), and one prior half-step from the reference's state with accept
masks equal on >= 99.5% of pixels."""

import pytest

pytest.importorskip("torch")

from test_torch_prior_pass import check_halfstep, check_prior_init_draws  # noqa: E402
from torch_port_util import golden_scene  # noqa: E402


@pytest.fixture(scope="module")
def scene():
    return golden_scene()


def test_prior_init_draws_match_reference_rect(scene):
    check_prior_init_draws(scene, "rect")


def test_prior_halfstep_from_identical_state_rect(scene):
    check_halfstep(scene, "rect", "prior")
