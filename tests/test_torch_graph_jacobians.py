"""The pose graph's closed-form factor Jacobians (``graph._prior_terms``,
``_between_terms``, ``_gps_terms``) against their twin: forward-mode
autodiff of the retraction, ``vmap(jacfwd(...))``, as the port took them
before (and msst_tpu takes them with ``jax.jacfwd``).

Tolerances: whitened residuals equal (``torch.equal``: the same float32
ops on the same values); Jacobians within 1e-5 of the table's largest
entry (two float32 roundings of one derivative); poses after 3 solver
iterations with either form within 1e-5 m and rad.  The launch guard
counts the aten ops one dense Gauss-Newton iteration dispatches at K = 256
(6,596 with the autodiff twin)."""

import pytest
import torch
from torch.func import jacfwd, vmap
from torch.utils._python_dispatch import TorchDispatchMode

from msst_torch.ops import graph as tgraph
from msst_torch.ops import se3
from msst_torch.ops.se3 import Pose
from msst_torch.utils import profiling
from msst_torch.utils.ring_graph import make_ring_graph


# ---------------------------------------------------------------------------
# the twin: the factor terms by vmap(jacfwd) of the residuals
# ---------------------------------------------------------------------------


def _prior_residual(delta, pose, meas):
    d = meas.between(se3.pose_retract(pose, delta))
    return torch.cat([se3.so3_log(d.q), d.t])


def _between_residual(di, dj, pi, pj, meas):
    a = se3.pose_retract(pi, di)
    b = se3.pose_retract(pj, dj)
    d = meas.between(a.between(b))
    return torch.cat([se3.so3_log(d.q), d.t])


def _gps_residual(delta, pose, z):
    return se3.pose_retract(pose, delta).t - z


def _take(poses, idx):
    idx = idx.long()
    return Pose(poses.q[idx], poses.t[idx])


def twin_prior_terms(poses, f):
    pi = _take(poses, f.idx)
    z = torch.zeros(6, device=f.sqrt_info.device)
    r = vmap(_prior_residual, in_dims=(None, 0, 0))(z, pi, f.meas)
    J = vmap(jacfwd(_prior_residual), in_dims=(None, 0, 0))(z, pi, f.meas)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, J * w[:, :, None]


def twin_between_terms(poses, f):
    pi, pj = _take(poses, f.i), _take(poses, f.j)
    z = torch.zeros(6, device=f.sqrt_info.device)
    dims = (None, None, 0, 0, 0)
    r = vmap(_between_residual, in_dims=dims)(z, z, pi, pj, f.meas)
    Ji = vmap(jacfwd(_between_residual, argnums=0), in_dims=dims)(
        z, z, pi, pj, f.meas)
    Jj = vmap(jacfwd(_between_residual, argnums=1), in_dims=dims)(
        z, z, pi, pj, f.meas)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, Ji * w[:, :, None], Jj * w[:, :, None]


def twin_gps_terms(poses, f):
    pi = _take(poses, f.idx)
    z = torch.zeros(6, device=f.sqrt_info.device)
    r = vmap(_gps_residual, in_dims=(None, 0, 0))(z, pi, f.xyz)
    J = vmap(jacfwd(_gps_residual), in_dims=(None, 0, 0))(z, pi, f.xyz)
    w = f.mask.to(r.dtype)[:, None] * f.sqrt_info
    return r * w, J * w[:, :, None]


TWINS = {"_prior_terms": twin_prior_terms,
         "_between_terms": twin_between_terms,
         "_gps_terms": twin_gps_terms}


# ---------------------------------------------------------------------------
# factor tables whose residual rotation has a chosen size
# ---------------------------------------------------------------------------

K, N = 24, 40


def _unit_quats(gen, n, negative_w):
    q = se3.quat_normalize(torch.randn(n, 4, generator=gen))
    return -q if negative_w else q


def _axis_angles(gen, n, lo, hi):
    axis = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen),
                                         dim=-1)
    return axis * (lo + (hi - lo) * torch.rand(n, 1, generator=gen))


def _tables(case: str, seed: int):
    """A pose table and a prior, between and GPS table of N rows each.  Each
    measurement is the poses' own relative pose less a rotation of the
    case's size, so that the residual's rotation phi has that size:
    ``near_identity`` |phi| < 1e-4 (so3_right_jacobian_inv's Taylor
    branch), ``moderate`` 0.1-1 rad, ``large`` 2.5-3.1 rad.
    ``negative_w``: the poses' and measurements' quaternions with w < 0
    (every pose, so both ends of each between row).  ``masked`` and
    ``zero_info``: rows off by the mask, or with zero information in
    all or some of their components."""
    gen = torch.Generator().manual_seed(seed)
    lo, hi = {"near_identity": (1e-6, 5e-5), "large": (2.5, 3.1)}.get(
        case, (0.1, 1.0))
    neg = case == "negative_w"
    poses = Pose(_unit_quats(gen, K, neg),
                 10.0 * torch.randn(K, 3, generator=gen))
    sqrt_info = torch.exp(torch.empty(N, 6).uniform_(
        0.0, 7.0, generator=gen))                  # 1 to ~1100
    mask = torch.ones(N, dtype=torch.bool)
    if case == "masked":
        mask = torch.rand(N, generator=gen) < 0.5
    if case == "zero_info":
        sqrt_info[::3] = 0.0
        sqrt_info[1::3, 3:] = 0.0

    def off(p):
        """p less a rotation of the case's size, and 5 cm of noise."""
        e = Pose(se3.so3_exp_quat(_axis_angles(gen, N, lo, hi)),
                 0.05 * torch.randn(N, 3, generator=gen))
        m = p.compose(e.inverse())
        return Pose(-m.q if neg else m.q, m.t)

    i = torch.randint(0, K, (N,), generator=gen, dtype=torch.int32)
    j = torch.randint(0, K, (N,), generator=gen, dtype=torch.int32)
    pi, pj = _take(poses, i), _take(poses, j)
    prior = tgraph.PriorFactor(i, off(pi), sqrt_info, mask)
    between = tgraph.BetweenFactor(i, j, off(pi.between(pj)), sqrt_info,
                                   mask)
    gps = tgraph.GpsFactor(j, pj.t + torch.randn(N, 3, generator=gen),
                           sqrt_info[:, :3], mask)
    return poses, {"_prior_terms": prior, "_between_terms": between,
                   "_gps_terms": gps}


CASES = ["near_identity", "moderate", "large", "negative_w", "masked",
         "zero_info"]


@pytest.mark.parametrize("term", sorted(TWINS))
@pytest.mark.parametrize("case", CASES)
def test_closed_form_terms_match_jacfwd(case, term):
    poses, tables = _tables(case, seed=CASES.index(case))
    f = tables[term]
    if term == "_between_terms":
        want_phi = se3.so3_log(f.meas.between(
            _take(poses, f.i).between(_take(poses, f.j))).q)
    elif term == "_prior_terms":
        want_phi = se3.so3_log(f.meas.between(_take(poses, f.idx)).q)
    if term != "_gps_terms":                    # the case's size held
        theta = torch.linalg.norm(want_phi, dim=-1)
        lo, hi = {"near_identity": (0, 1e-4), "large": (2.4, 3.15)}.get(
            case, (0.09, 1.01))
        assert float(theta.min()) >= lo and float(theta.max()) < hi
    got = getattr(tgraph, term)(poses, f)
    want = TWINS[term](poses, f)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale
        if case in ("masked", "zero_info"):
            assert torch.equal(g == 0, w == 0)


# ---------------------------------------------------------------------------
# the solvers with either form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["optimize", "optimize_cg"])
def test_solvers_match_the_jacfwd_form(solver, monkeypatch):
    g = make_ring_graph(64)
    got = getattr(tgraph, solver)(g, iters=3)
    for name, twin in TWINS.items():
        monkeypatch.setattr(tgraph, name, twin)
    want = getattr(tgraph, solver)(g, iters=3)
    assert float((got.poses.t - want.poses.t).abs().max()) < 1e-5
    rot = se3.so3_log(se3.quat_mul(se3.quat_conj(want.poses.q),
                                   got.poses.q))
    assert float(torch.linalg.norm(rot, dim=-1).max()) < 1e-5


def test_solves_count_their_iterations():
    """Each solve's span carries its iteration count, and the counter
    graph_gn_iters adds one an iteration."""
    g = make_ring_graph(16)
    profiling.drain()
    with profiling.tracing():
        tgraph.optimize(g, iters=3)
        tgraph.optimize_cg(g, iters=2, cg_iters=4)
    lg = profiling.drain()
    solves = [r for r in lg["spans"] if r["name"] == "graph_solve"]
    assert [(r["args"]["solver"], r["args"]["iters"]) for r in solves] == [
        ("dense", 3), ("cg", 2)]
    assert [r["counts"]["graph_gn_iters"] for r in solves] == [3, 2]
    assert profiling.counter_total(lg, "graph_gn_iters") == 5


# ---------------------------------------------------------------------------
# launch guard
# ---------------------------------------------------------------------------


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_dense_iteration_launches_at_most_1000_ops():
    """One dense GN iteration at K = 256 (scatters, assembly, Cholesky,
    retraction) dispatches at most 1,000 aten ops: each is a launch on the
    card, whatever K."""
    g = make_ring_graph(256)
    with _CountOps() as c:
        tgraph.optimize(g, iters=1)
    assert 0 < c.n <= 1000
