"""The port's 5-NN scan-to-map Gauss-Newton (msst_torch.ops.registration:
``_corner_coeffs``, ``_surf_coeffs``, ``scan_to_map``) against msst_tpu's, on
the scenes of tests/test_registration.py: a room corner (two walls, a floor,
four poles) and a floor-only map that leaves x, y and yaw unobservable.

Both scenes are regular grids, so the five neighbours of a point span a
well-conditioned plane or line and the two packages agree to float32
rounding: coefficients to 1e-4 (normals compared up to sign: the sign of an
eigenvector cancels in J^T J and J^T r), poses to 1e-4 m/rad, with equal
iteration counts, degeneracy flags and inlier counts.  (On sparse lidar
maps the neighbours of a point are often collinear along a ring, the
plane's normal is then set by rounding, and the packages differ more: see
tests/test_torch_slice.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rs

from msst_torch.ops import knn as tknn
from msst_torch.ops import registration as treg
from msst_tpu.ops import knn as jknn
from msst_tpu.ops import registration as jreg

POSE_ATOL = 1e-4
COEFF_ATOL = 1e-4
C = 48   # candidates per cell, as tests/test_registration.py


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def _world():
    """Two perpendicular walls + floor (surf) and 4 vertical poles (corner)."""
    g = np.arange(-10, 10, 0.25, dtype=np.float32)
    xx, zz = np.meshgrid(g, np.arange(0, 4, 0.25, dtype=np.float32))
    surf = [np.stack([xx.ravel(), np.full(xx.size, 10.0), zz.ravel()], 1),
            np.stack([np.full(xx.size, 10.0), xx.ravel(), zz.ravel()], 1)]
    xx, yy = np.meshgrid(g, g)
    surf.append(np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], 1))
    poles = []
    for px, py in [(5, 5), (-5, 5), (5, -5), (-6, -3)]:
        z = np.arange(0, 4, 0.05, dtype=np.float32)
        poles.append(np.stack([np.full(z.size, px, np.float32),
                               np.full(z.size, py, np.float32), z], 1))
    return (np.concatenate(poles).astype(np.float32),
            np.concatenate(surf).astype(np.float32))


def _subsample(arr, n, rng):
    idx = rng.choice(len(arr), size=n, replace=False)
    return (arr[idx] + rng.normal(scale=0.005, size=(n, 3))).astype(np.float32)


def _scene(name):
    """dict(corner_scan, corner_mask, surf_scan, surf_mask, corner_map,
    corner_map_mask, surf_map, surf_map_mask, tables) as numpy arrays."""
    rng = np.random.default_rng(7)
    if name == "room":
        corner_map, surf_map = _world()
        gt = np.array([0.02, -0.015, 0.05, 0.3, -0.2, 0.1], np.float32)
        R = Rs.from_euler("xyz", gt[:3]).as_matrix().astype(np.float32)
        corner_scan = (_subsample(corner_map, 300, rng) - gt[3:]) @ R
        surf_scan = (_subsample(surf_map, 2000, rng) - gt[3:]) @ R
        # padded scan slots, as the step's fixed-capacity clouds have them
        corner_scan = np.concatenate([corner_scan, np.zeros((20, 3), np.float32)])
        corner_mask = np.arange(320) < 300
        return dict(corner_scan=corner_scan.astype(np.float32),
                    corner_mask=corner_mask,
                    surf_scan=surf_scan.astype(np.float32),
                    surf_mask=np.ones(2000, bool),
                    corner_map=corner_map,
                    corner_map_mask=np.ones(len(corner_map), bool),
                    surf_map=surf_map,
                    surf_map_mask=np.ones(len(surf_map), bool),
                    tables=(4096, 16384), gt=gt)
    g = np.arange(-10, 10, 0.2, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    floor = np.stack([xx.ravel(), yy.ravel(),
                      np.zeros(xx.size, np.float32)], 1)
    surf_scan = _subsample(floor, 2000, rng) + np.array([0, 0, -0.3], np.float32)
    return dict(corner_scan=np.zeros((8, 3), np.float32),
                corner_mask=np.zeros(8, bool),
                surf_scan=surf_scan.astype(np.float32),
                surf_mask=np.ones(2000, bool),
                corner_map=np.zeros((8, 3), np.float32),
                corner_map_mask=np.zeros(8, bool),
                surf_map=floor, surf_map_mask=np.ones(len(floor), bool),
                tables=(64, 16384), gt=np.array([0, 0, 0, 0, 0, 0.3], np.float32))


def _grids(s, build, conv):
    return (build(conv(s["corner_map"]), conv(s["corner_map_mask"]), 1.0,
                  s["tables"][0]),
            build(conv(s["surf_map"]), conv(s["surf_map_mask"]), 1.0,
                  s["tables"][1]))


def _align_sign(got, want):
    """Flip rows of `got` whose direction opposes `want`'s."""
    sign = np.where(np.sum(got * want, axis=1) < 0, -1.0, 1.0)
    return got * sign[:, None], sign


def test_corner_coeffs_match_jax():
    s = _scene("room")
    jcg, _ = _grids(s, jknn.build, J)
    tcg, _ = _grids(s, tknn.build, T)
    # the scan under a small pose error, as the first iteration sees it
    pw = (s["corner_scan"] + np.array([0.25, -0.15, 0.05], np.float32))
    want = jreg._corner_coeffs(J(pw), J(s["corner_mask"]), jcg,
                               J(s["corner_map"]), C)
    got = treg._corner_coeffs(T(pw), T(s["corner_mask"]), tcg,
                              T(s["corner_map"]), C)
    keep = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), keep)
    assert keep.sum() > 200 and not keep[300:].any()
    np.testing.assert_allclose(got[0].numpy()[keep], np.asarray(want[0])[keep],
                               atol=COEFF_ATOL)
    np.testing.assert_allclose(got[1].numpy()[keep], np.asarray(want[1])[keep],
                               atol=COEFF_ATOL)


def test_surf_coeffs_match_jax():
    s = _scene("room")
    _, jsg = _grids(s, jknn.build, J)
    _, tsg = _grids(s, tknn.build, T)
    pw = (s["surf_scan"] + np.array([0.25, -0.15, 0.05], np.float32))
    want = jreg._surf_coeffs(J(pw), J(s["surf_scan"]), J(s["surf_mask"]), jsg,
                             J(s["surf_map"]), C)
    got = treg._surf_coeffs(T(pw), T(s["surf_scan"]), T(s["surf_mask"]), tsg,
                            T(s["surf_map"]), C)
    keep = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), keep)
    assert keep.sum() > 1500
    n_got, sign = _align_sign(got[0].numpy()[keep], np.asarray(want[0])[keep])
    np.testing.assert_allclose(n_got, np.asarray(want[0])[keep],
                               atol=COEFF_ATOL)
    np.testing.assert_allclose(got[1].numpy()[keep] * sign,
                               np.asarray(want[1])[keep], atol=COEFF_ATOL)


@pytest.mark.parametrize("scene", ["room", "floor_only"])
def test_scan_to_map_matches_jax(scene):
    s = _scene(scene)
    jcg, jsg = _grids(s, jknn.build, J)
    tcg, tsg = _grids(s, tknn.build, T)
    init = np.zeros(6, np.float32)
    want = jreg.scan_to_map(
        J(s["corner_scan"]), J(s["corner_mask"]), J(s["surf_scan"]),
        J(s["surf_mask"]), jcg, J(s["corner_map"]), jsg, J(s["surf_map"]),
        init_pose=J(init), candidates_per_cell=C)
    got = treg.scan_to_map(
        T(s["corner_scan"]), T(s["corner_mask"]), T(s["surf_scan"]),
        T(s["surf_mask"]), tcg, T(s["corner_map"]), tsg, T(s["surf_map"]),
        init_pose=T(init), candidates_per_cell=C)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose),
                               atol=POSE_ATOL)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.degenerate) == bool(want.degenerate)
    assert bool(got.converged) == bool(want.converged)
    assert int(got.n_corner) == int(want.n_corner)
    assert int(got.n_surf) == int(want.n_surf)
    pose = got.pose.numpy()
    if scene == "room":
        # the oracle of tests/test_registration.py: the true pose recovered
        np.testing.assert_allclose(pose[:3], s["gt"][:3], atol=5e-3)
        np.testing.assert_allclose(pose[3:], s["gt"][3:], atol=2e-2)
        assert not bool(got.degenerate) and int(got.n_surf) > 500
    else:
        assert bool(got.degenerate)
        assert abs(pose[5] - 0.3) < 0.02                      # z recovered
        assert abs(pose[3]) < 1e-3 and abs(pose[4]) < 1e-3    # x/y frozen


def test_scan_to_map_too_few_points_stops_at_once():
    """Fewer than min_points inliers: no update, done after one iteration
    (msst_tpu's ``converged | ~enough``)."""
    s = _scene("room")
    jcg, jsg = _grids(s, jknn.build, J)
    tcg, tsg = _grids(s, tknn.build, T)
    sm = np.arange(2000) < 20
    cm = np.zeros(320, bool)
    init = np.array([0.0, 0.0, 0.0, 0.1, 0.0, 0.0], np.float32)
    want = jreg.scan_to_map(
        J(s["corner_scan"]), J(cm), J(s["surf_scan"]), J(sm), jcg,
        J(s["corner_map"]), jsg, J(s["surf_map"]), init_pose=J(init),
        candidates_per_cell=C)
    got = treg.scan_to_map(
        T(s["corner_scan"]), T(cm), T(s["surf_scan"]), T(sm), tcg,
        T(s["corner_map"]), tsg, T(s["surf_map"]), init_pose=T(init),
        candidates_per_cell=C)
    assert int(got.iterations) == int(want.iterations) == 1
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_array_equal(got.pose.numpy(), init)
    np.testing.assert_array_equal(np.asarray(want.pose), init)
    assert int(got.n_surf) == int(want.n_surf) <= 20
