"""The port's base layer against msst_tpu: parameters, se3, linalg, the pose
graph, the simulator copy, the numpy bridge, and that msst_torch never
imports jax.

Tolerances: both packages compute in float32 with the same formulas, but
XLA and PyTorch round transcendental functions and reductions differently
in the last bit or two, so elementwise results agree to a few float32 ULPs
of their magnitude (atol 1e-5 on O(1) values unless stated)."""

import dataclasses
import filecmp
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msst_torch import convert
from msst_torch.models.liosam import params as tparams
from msst_torch.ops import graph as tgraph
from msst_torch.ops import imu as timu
from msst_torch.ops import linalg as tlinalg
from msst_torch.ops import se3 as tse3
from msst_torch.utils import sim as tsim
from msst_tpu.models.liosam import params as jparams
from msst_tpu.ops import graph as jgraph
from msst_tpu.ops import linalg as jlinalg
from msst_tpu.ops import se3 as jse3
from msst_tpu.utils import sim as jsim

REPO = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)


def T(x):
    return torch.from_numpy(np.asarray(x))


def J(x):
    return jnp.asarray(np.asarray(x))


def rand_rpy(n=64):
    rpy = RNG.uniform(-np.pi, np.pi, size=(n, 3)).astype(np.float32)
    rpy[:, 1] = RNG.uniform(-1.4, 1.4, size=n)
    return rpy


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def test_lio_params_fields_and_defaults_match():
    """Same field names, order, types and defaults (exact)."""
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(jparams.LioParams)]
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(tparams.LioParams)]
    assert tf == jf


def test_tiny_params_match():
    over = dict(loop_closure_enabled=False, max_keyframes=32)
    assert (dataclasses.asdict(tparams.tiny_params(**over))
            == dataclasses.asdict(jparams.tiny_params(**over)))


def test_imu_params_are_the_ports():
    p = tparams.tiny_params()
    assert isinstance(p.imu_params, timu.ImuParams)
    assert tuple(p.imu_params) == tuple(jparams.tiny_params().imu_params)


def test_n_scan_bound_refused():
    with pytest.raises(ValueError):
        tparams.LioParams(n_scan=129)


# ---------------------------------------------------------------------------
# se3 oracles: same inputs through both packages
# ---------------------------------------------------------------------------


def _pose_pair(n=32):
    rpy, t = rand_rpy(n), RNG.normal(size=(n, 3)).astype(np.float32) * 5
    v6 = np.concatenate([rpy, t], axis=1)
    return (jse3.Pose.from_vec6(J(v6)), tse3.Pose.from_vec6(T(v6)))


_SE3_CASES = {
    "rpy_to_matrix": (lambda m, x: m.rpy_to_matrix(x), rand_rpy),
    "matrix_to_rpy": (lambda m, x: m.matrix_to_rpy(m.rpy_to_matrix(x)), rand_rpy),
    "quat_from_rpy": (lambda m, x: m.quat_from_rpy(x), rand_rpy),
    "quat_to_rpy": (lambda m, x: m.quat_to_rpy(m.quat_from_rpy(x)), rand_rpy),
    "quat_to_matrix": (lambda m, x: m.quat_to_matrix(m.quat_from_rpy(x)), rand_rpy),
    "quat_mul": (lambda m, x: m.quat_mul(m.quat_from_rpy(x),
                                         m.quat_from_rpy(x * 0.5)), rand_rpy),
    "quat_rotate": (lambda m, x: m.quat_rotate(m.quat_from_rpy(x), x * 3.0),
                    rand_rpy),
    "so3_exp_quat": (lambda m, x: m.so3_exp_quat(x),
                     lambda: np.concatenate([rand_rpy(32), np.zeros((2, 3), np.float32),
                                             np.full((1, 3), 1e-7, np.float32)])),
    "so3_log": (lambda m, x: m.so3_log(m.so3_exp_quat(x)),
                lambda: RNG.normal(size=(64, 3)).astype(np.float32)),
    "so3_left_jacobian": (lambda m, x: m.so3_left_jacobian(x),
                          lambda: np.concatenate([rand_rpy(32), np.zeros((1, 3), np.float32)])),
    "skew": (lambda m, x: m.skew(x), rand_rpy),
    "slerp_angle": (lambda m, x: m.slerp_angle(x[:, 0], x[:, 2], 0.3), rand_rpy),
}


@pytest.mark.parametrize("name", sorted(_SE3_CASES))
def test_se3_function_matches_jax(name):
    fn, make = _SE3_CASES[name]
    x = make()
    want = np.asarray(fn(jse3, J(x)))
    got = fn(tse3, T(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("op", ["compose", "between", "inverse", "apply",
                                "to_matrix", "to_vec6", "retract"])
def test_pose_ops_match_jax(op):
    (ja, ta), (jb, tb) = _pose_pair(), _pose_pair()
    pts = RNG.normal(size=(32, 3)).astype(np.float32) * 10
    delta = RNG.normal(size=(32, 6)).astype(np.float32) * 0.1
    if op == "compose":
        want, got = ja.compose(jb), ta.compose(tb)
    elif op == "between":
        want, got = ja.between(jb), ta.between(tb)
    elif op == "inverse":
        want, got = ja.inverse(), ta.inverse()
    elif op == "apply":
        want, got = ja.apply(J(pts)), ta.apply(T(pts))
    elif op == "to_matrix":
        want, got = ja.to_matrix(), ta.to_matrix()
    elif op == "to_vec6":
        want, got = ja.to_vec6(), ta.to_vec6()
    else:
        want, got = jse3.pose_retract(ja, J(delta)), tse3.pose_retract(ta, T(delta))
    want = jax.tree.map(np.asarray, want)
    got = convert.to_numpy(got) if isinstance(got, tuple) else got.numpy()
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------


def _sym_batch():
    A = RNG.normal(size=(256, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2)
    # repeated-eigenvalue cases: a line (rank 1), a disc (two equal), identity
    v = np.array([1.0, 2.0, 0.5], np.float32)
    line = np.outer(v, v)
    disc = np.eye(3, dtype=np.float32) - np.outer(v, v) / (v @ v)
    return np.concatenate([A, line[None], disc[None], np.eye(3, dtype=np.float32)[None]])


def test_sym3x3_eigh_matches_jax():
    """Eigenvalues to 1e-4 relative; eigenvectors equal up to sign where the
    eigenvalue is simple (repeated-root vectors are defined only by the
    repair rule and compared as spans: |dot| with JAX's >= 0.999 for the
    well-separated ones)."""
    A = _sym_batch()
    jv, jV = (np.asarray(x) for x in jlinalg.sym3x3_eigh(J(A)))
    tv, tV = (x.numpy() for x in tlinalg.sym3x3_eigh(T(A)))
    scale = np.abs(jv).max(axis=1, keepdims=True) + 1e-6
    np.testing.assert_allclose(tv / scale, jv / scale, atol=1e-4)
    gap_lo = (jv[:, 1] - jv[:, 0]) / scale[:, 0]
    gap_hi = (jv[:, 2] - jv[:, 1]) / scale[:, 0]
    for k, gap in ((0, gap_lo), (2, gap_hi)):
        ok = gap > 1e-2
        dots = np.abs(np.sum(jV[:, k] * tV[:, k], axis=1))
        assert np.all(dots[ok] > 0.999)
    # every returned frame is orthonormal
    np.testing.assert_allclose(tV @ np.swapaxes(tV, 1, 2),
                               np.broadcast_to(np.eye(3), tV.shape), atol=1e-4)


def test_solve_psd_matches_jax():
    A = RNG.normal(size=(6, 6)).astype(np.float32)
    A = A @ A.T + 0.1 * np.eye(6, dtype=np.float32)
    b = RNG.normal(size=6).astype(np.float32)
    want = np.asarray(jlinalg.solve_psd(J(A), J(b), damping=1e-6))
    got = tlinalg.solve_psd(T(A), T(b), damping=1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------


def _graph_np(K=12):
    """A small graph (prior, noisy chain, one loop, two GPS fixes) as numpy
    leaves of msst_tpu's PoseGraph."""
    g = jgraph.empty_graph(K, 1, K + 2, 4)
    gt6 = np.zeros((K, 6), np.float32)
    gt6[:, 2] = np.linspace(0, 1.0, K)
    gt6[:, 3] = np.arange(K, dtype=np.float32)
    gt6[:, 4] = 0.2 * np.arange(K, dtype=np.float32)
    gt = jse3.Pose.from_vec6(J(gt6))
    init = jse3.Pose.from_vec6(J(gt6 + RNG.normal(scale=0.05, size=gt6.shape)
                                 .astype(np.float32)))
    i = np.concatenate([np.arange(K - 1), [0, 0, 0]]).astype(np.int32)
    j = np.concatenate([np.arange(1, K), [K - 1, 0, 0]]).astype(np.int32)
    pi = jax.tree.map(lambda a: a[i], gt)
    pj = jax.tree.map(lambda a: a[j], gt)
    meas = pi.between(pj)
    mask = np.arange(K + 2) < K
    g = g._replace(
        poses=init, pose_mask=jnp.ones(K, bool),
        priors=g.priors._replace(idx=jnp.zeros(1, jnp.int32),
                                 meas=jse3.Pose(gt.q[:1], gt.t[:1]),
                                 sqrt_info=jnp.full((1, 6), 100.0),
                                 mask=jnp.ones(1, bool)),
        betweens=jgraph.BetweenFactor(J(i), J(j), meas,
                                      jnp.full((K + 2, 6), 50.0), J(mask)),
        gps=jgraph.GpsFactor(jnp.asarray([3, 7, 0, 0], jnp.int32),
                             J(gt6[[3, 7, 0, 0], 3:]),
                             jnp.full((4, 3), 2.0),
                             jnp.asarray([True, True, False, False])),
    )
    return jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("term", ["prior", "between", "gps"])
def test_graph_terms_match_jax(term):
    """Whitened residuals and autodiff Jacobians of each factor type."""
    gnp = _graph_np()
    jg = jax.tree.map(jnp.asarray, gnp)
    tg = convert.from_numpy(gnp, "cpu")
    jfn = getattr(jgraph, f"_{term}_terms")
    tfn = getattr(tgraph, f"_{term}_terms")
    field = {"prior": "priors", "between": "betweens", "gps": "gps"}[term]
    want = jfn(jg.poses, getattr(jg, field))
    got = tfn(tg.poses, getattr(tg, field))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-4)


def test_graph_optimize_matches_jax():
    """Dense Gauss-Newton: same poses after 3 iterations (1e-4 m / rad: the
    normal equations are solved by different Cholesky implementations)."""
    gnp = _graph_np()
    free = np.ones(12, bool)
    free[0] = False
    want = jgraph.optimize(jax.tree.map(jnp.asarray, gnp), free_mask=J(free),
                           iters=3)
    got = tgraph.optimize(convert.from_numpy(gnp, "cpu"), free_mask=T(free),
                          iters=3)
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t),
                               atol=1e-4)
    dots = np.abs(np.sum(got.poses.q.numpy() * np.asarray(want.poses.q), axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# simulator copy, numpy bridge, no jax
# ---------------------------------------------------------------------------


def test_sim_copy_is_identical():
    """msst_torch/utils/sim.py is a verbatim copy of msst_tpu's, and gives
    identical arrays for the same seed."""
    assert filecmp.cmp(REPO / "msst_torch/utils/sim.py",
                       REPO / "msst_tpu/utils/sim.py", shallow=False)
    args = dict(n_scans=3, scan_dt=0.1, n_scan=8, horizon=90, seed=4)
    a = jsim.make_dataset(jsim.World(), jsim.SimTrajectory(), **args)
    b = tsim.make_dataset(tsim.World(), tsim.SimTrajectory(), **args)
    for sa, sb in zip(a, b):
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]))


def test_convert_round_trip_keeps_dtypes():
    gnp = _graph_np()
    tg = convert.from_numpy(gnp, "cpu")
    assert tg.pose_mask.dtype == torch.bool
    assert tg.betweens.i.dtype == torch.int32
    back = convert.to_numpy(tg)
    for w, g in zip(jax.tree.leaves(gnp), jax.tree.leaves(back)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def test_msst_torch_imports_no_jax():
    """Import every module of msst_torch in a fresh interpreter: jax (and so
    msst_tpu) must never load."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import msst_torch\n"
        "for m in pkgutil.walk_packages(msst_torch.__path__, 'msst_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'msst_torch.ops.knn' in sys.modules\n"
        "import torch\n"
        "from msst_torch.models.liosam import params, state\n"
        "from msst_torch.ops import knn\n"
        # the knn path's own code runs without jax too: a knn-mode state
        # and one query of its (empty) surf grid
        "st = state.init_state(params.tiny_params(scan2map_method='knn'),\n"
        "                      'cpu')\n"
        "res = knn.query(st.local_map.surf_grid, torch.zeros(4, 3),\n"
        "                torch.ones(4, dtype=torch.bool))\n"
        "assert res.idx.shape == (4, 5) and not bool(res.valid.any())\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(k.startswith('msst_tpu') for k in sys.modules)\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
