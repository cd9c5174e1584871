"""The JAX package's outputs that the port's parity tests read from
tests/fixtures/ref_*.npz, against the JAX package itself.

* every stored reference has a build, and every build its file;
* (slow) each build, run anew -- the JAX package with its Pallas kernels
  interpreted, as the tests ran it before they read the files -- equals
  its file bit for bit: the same keys, dtypes, shapes and bits.  About
  half an hour on a CPU in all.

The files and the tests that read them (each test file's ``--regen``
rebuilds its own; ref_golden_context.npz, the reference's contexts that the
others' builds check theirs against, comes from
test_torch_prior_pass.py's):

* ref_golden_context, ref_prior_{exact,window}: test_torch_prior_pass.py
* ref_prior_rect: test_torch_prior_rect_pass.py
* ref_hier_{exact,window,rect}: test_torch_hier_pass.py
* ref_rect_halfstep: test_torch_pass.py
* ref_geom_init: test_torch_geom_pass.py
* ref_prescreen: test_torch_prescreen.py
* ref_window_halfstep, ref_window_two_iterations: test_torch_window.py
* ref_geom_batched_ncc: test_torch_geom_kernels.py
* ref_tile_pass: test_torch_tile.py

Regenerate all of them (CPU, interpret mode, about half an hour):
    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_reference_fixtures.py --regen
"""

import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

import test_torch_geom_kernels  # noqa: E402
import test_torch_geom_pass  # noqa: E402
import test_torch_hier_pass  # noqa: E402
import test_torch_pass  # noqa: E402
import test_torch_prescreen  # noqa: E402
import test_torch_prior_pass  # noqa: E402
import test_torch_prior_rect_pass  # noqa: E402
import test_torch_tile  # noqa: E402
import test_torch_window  # noqa: E402
from torch_port_util import (  # noqa: E402
    FIXTURES, assert_tree_equal, load_tree, regen_references,
)

# test_torch_prior_pass's first: its golden context is the others' check
REFERENCES = {name: build for module in (
    test_torch_prior_pass, test_torch_prior_rect_pass, test_torch_hier_pass,
    test_torch_pass, test_torch_geom_pass, test_torch_prescreen,
    test_torch_window, test_torch_geom_kernels, test_torch_tile)
    for name, build in module.REFERENCES.items()}


def test_every_stored_reference_has_a_build():
    stored = {p.stem for p in FIXTURES.glob("ref_*.npz")}
    assert stored == set(REFERENCES), stored ^ set(REFERENCES)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(REFERENCES))
def test_stored_reference_is_fresh(name):
    try:
        assert_tree_equal(REFERENCES[name](),
                          load_tree(FIXTURES / f"{name}.npz"), name)
    finally:
        jax.clear_caches()


if __name__ == "__main__":
    if "--regen" in sys.argv:
        regen_references(REFERENCES)
