"""Port parity: ops/sampling.py, ops/candidates.py, ops/view_select.py,
ops/filter.py and ops/ncc.py (topk_cost_and_selection).

Inputs from a numpy seed go through both packages.  Tolerances: grid,
checkerboard and shift ops, candidate selection, median filter and top-k
selection exact; costs and bicubic samples within 1e-5 relative (sums may
round in another order); view-selection votes identical (same threefry
stream) on >= 99.9% of pixels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from acmmp_spherical_tpu.config import PatchMatchParams  # noqa: E402
from acmmp_spherical_tpu.ops import candidates as JCd  # noqa: E402
from acmmp_spherical_tpu.ops import filter as JF  # noqa: E402
from acmmp_spherical_tpu.ops import ncc as JN  # noqa: E402
from acmmp_spherical_tpu.ops import sampling as JS  # noqa: E402
from acmmp_spherical_tpu.ops import view_select as JV  # noqa: E402
from acmmp_spherical_torch.ops import candidates as TCd  # noqa: E402
from acmmp_spherical_torch.ops import filter as TF  # noqa: E402
from acmmp_spherical_torch.ops import ncc as TN  # noqa: E402
from acmmp_spherical_torch.ops import rng as TR  # noqa: E402
from acmmp_spherical_torch.ops import sampling as TS  # noqa: E402
from acmmp_spherical_torch.ops import view_select as TV  # noqa: E402

H, W, S = 24, 40, 5
P = PatchMatchParams()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(2024)


def test_grid_and_checkerboard(rng):
    jx, jy = JS.grid_coords(H, W)
    tx, ty = TS.grid_coords(H, W, "cpu")
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    a = rng.normal(size=(3, H, W)).astype(np.float32)
    for p in (0, 1):
        jp = JS.checkerboard_pack(jnp.asarray(a), p)
        tp = TS.checkerboard_pack(torch.from_numpy(a), p)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        new = rng.normal(size=tp.shape).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(JS.checkerboard_unpack(jnp.asarray(new), jnp.asarray(a), p)),
            TS.checkerboard_unpack(torch.from_numpy(new), torch.from_numpy(a),
                                   p).numpy())
        for j, t in zip(JS.checkerboard_coords(H, W, p),
                        TS.checkerboard_coords(H, W, p, "cpu")):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("dy,dx", [(0, 3), (-2, 0), (5, -7), (-23, 23)])
@pytest.mark.parametrize("fill", [None, np.inf])
def test_shift2d_and_mask(rng, dy, dx, fill):
    a = rng.normal(size=(2, H, W)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(JS.shift2d(jnp.asarray(a), dy, dx, fill=fill)),
        TS.shift2d(torch.from_numpy(a), dy, dx, fill=fill).numpy())
    np.testing.assert_array_equal(
        np.asarray(JS.shift_valid_mask(H, W, dy, dx)),
        TS.shift_valid_mask(H, W, dy, dx, "cpu").numpy())


def test_bicubic_matches_packed16(rng):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    x = rng.uniform(-3, W + 3, (50, 60)).astype(np.float32)
    y = rng.uniform(-3, H + 3, (50, 60)).astype(np.float32)
    pk = JS.pack_bicubic(jnp.asarray(img), jnp.float32(W), jnp.float32(H))
    jv, jok = JS.sample_bicubic_packed16(pk, W, jnp.asarray(x), jnp.asarray(y),
                                         jnp.float32(W), jnp.float32(H))
    tv, tok = TS.sample_bicubic(torch.from_numpy(img), torch.from_numpy(x),
                                torch.from_numpy(y), W, H)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-5, atol=1e-4)


def _plane_field(rng):
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = rng.uniform(-8, -1, (H, W)).astype(np.float32)
    cost = rng.uniform(0, 2, (H, W)).astype(np.float32)
    return n, w, cost


def test_gather_candidates(rng):
    n, w, cost = _plane_field(rng)
    cost[3, 4] = cost[3, 6]                     # a tie: first minimum wins
    j = JCd.gather_candidates(jnp.asarray(n), jnp.asarray(w), jnp.asarray(cost),
                              wrap_x=False)
    t = TCd.gather_candidates(torch.from_numpy(n), torch.from_numpy(w),
                              torch.from_numpy(cost))
    for f in ("normal", "w", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)


def test_view_selection(rng):
    sel_prev = rng.uniform(size=(S, H, W)) > 0.5
    near_valid = rng.uniform(size=(4, H, W)) > 0.1
    jpri = JV.view_selection_priors(jnp.asarray(sel_prev),
                                    jnp.asarray(near_valid), P, wrap_x=False)
    tpri = TV.view_selection_priors(torch.from_numpy(sel_prev),
                                    torch.from_numpy(near_valid), P)
    np.testing.assert_allclose(np.asarray(jpri), tpri.numpy(), rtol=1e-6)
    costs = rng.uniform(0, 2, (8, S, H, W)).astype(np.float32)
    cvalid = rng.uniform(size=(8, H, W)) > 0.05
    src_valid = np.array([True, True, False, True, True])
    for it in (0, 2):
        j = JV.joint_view_selection(jnp.asarray(costs), jnp.asarray(cvalid),
                                    jpri, jnp.asarray(src_valid), P,
                                    jax.random.key(9), it)
        t = TV.joint_view_selection(torch.from_numpy(costs),
                                    torch.from_numpy(cvalid),
                                    torch.tensor(np.asarray(jpri)),
                                    torch.from_numpy(src_valid), P,
                                    TR.key(9), it)
        same = (np.asarray(j.weights) == t.weights.numpy()).all(0)
        assert same.mean() >= 0.999, same.mean()
        assert not t.temp_selected[2].any()


def test_median_filter(rng):
    d = rng.uniform(1, 10, (H, W)).astype(np.float32)
    c = rng.uniform(0, 0.01, (H, W)).astype(np.float32)
    jd = JF.checkerboard_median_filter(jnp.asarray(d), jnp.asarray(c))
    td = TF.checkerboard_median_filter(torch.from_numpy(d), torch.from_numpy(c))
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_topk_cost_and_selection(rng):
    cv = rng.uniform(0, 2, (S, H, W)).astype(np.float32)
    cv[:, :4] = 2.0                                  # no valid view
    cv[1:, 4:8] = 2.0                                # one valid view
    src_valid = np.array([True, True, True, False, True])
    jc, js = JN.topk_cost_and_selection(jnp.asarray(cv), jnp.asarray(src_valid), P)
    tc, ts = TN.topk_cost_and_selection(torch.from_numpy(cv),
                                        torch.from_numpy(src_valid), P)
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
