"""The port's multi-session mapping (``msst_torch.parallel``) against
msst_tpu's (``msst_tpu.parallel``) on the CPU: msst_tpu over conftest's 8
virtual CPU devices, the port over 8 session slots of the CPU.  The mesh,
the batched state, the frame-offset injection, the drive's step input,
both merges and the align, on the hand-built stores of
tests/test_parallel.py; the batched step and the drive are in
test_torch_multisession_step.py and test_torch_multisession_drive.py.

Tolerances, each measured on these inputs:

* ``make_batched_state`` equal bit for bit; ``_pack_step_input`` equal.
* ``inject_frame_offsets``: masks and the untouched rows equal, rotations
  and positions to 2e-6 (rpy -> quaternion -> rpy: XLA's and torch's sin,
  cos and atan2 round differently in the last bit).
* the merges: each session's voxel maps compared cell by cell, not row
  by row: the occupied cells, their point counts and which are usable
  (``mask & valid``, the occupied-voxel count of tests/test_parallel.py)
  equal, usable cells' means to 1e-4 m, except where a centroid lies on a
  cell face.  The centroid downsample before the fit sums in another order
  than msst_tpu's prefix sums, and the sim room's floor is the plane z = 0:
  for a session standing at z = 0 the floor's centroids lie within 1e-4 m
  of a face of its map's grid, and fall on either side by rounding.  Such a
  point moves from one cell to a neighbour (both counts differ, in
  opposite directions, which the check requires), and it reorders the hash
  table.  Measured: at most 2 cells of a map.
* the align: ``found`` and ``candidate_session`` equal, fitness to 1e-4,
  anchors and corrected keyframe poses to 2e-3 (the 50-iteration ICP and
  the 8-iteration anchor solve amplify float32 rounding; measured worst
  ~7e-4 m); the rebaked maps' anchors to the same, their usable voxel
  counts within 2 %.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import msst_tpu.parallel
from msst_torch import convert
from msst_torch.models.liosam import mapping as tmap
from msst_torch.models.liosam.params import LioParams
from msst_torch.parallel import mesh as tmesh
from msst_torch.parallel import multisession as tms
from msst_tpu.parallel import make_mesh, shard_batch
from msst_tpu.parallel import multisession as jms
from msst_tpu.utils import sim
from tests.test_parallel import _two_session_overlap_states

S = 8
VOX_MEAN_TOL = 1e-4
ALIGN_TOL = 2e-3
FIT_TOL = 1e-4
INJECT_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops, many of them: one torch thread per xdist worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _compiled_batched_state():
    """tests/test_parallel.py's store helper calls msst_tpu's
    ``make_batched_state`` eagerly; give it the jitted form (below)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(msst_tpu.parallel, "make_batched_state", jax_batched_state)
    yield
    mp.undo()


def _np(x):
    return jax.tree.map(np.asarray, x)


def _port_params(jp) -> LioParams:
    return LioParams(**dataclasses.asdict(jp))


def _port_state(jstate):
    """msst_tpu's (batched) state as the port's: every leaf carried, and on
    the voxel path the knn hash grids msst_tpu keeps but never reads
    dropped (the port holds None there)."""
    st = convert.from_numpy(_np(jstate), "cpu")
    return st._replace(local_map=st.local_map._replace(corner_grid=None,
                                                       surf_grid=None))


# msst_tpu's make_batched_state compiled once: eagerly its ~100 small ops
# take ~20 s of compiles on the CPU
jax_batched_state = jax.jit(jms.make_batched_state, static_argnums=(0, 1))


def _tiny():
    jp = ge._tiny_p(horizon=90)
    return jp, _port_params(jp)


def _meshes():
    return make_mesh(S), tmesh.make_mesh(S, device="cpu")


def _leaves_equal(got, want, path=""):
    """Every tensor of the port's tree equal to msst_tpu's leaf of the same
    field, bit for bit (fields the port holds as None are skipped)."""
    if got is None:
        return
    if isinstance(got, tuple) and hasattr(got, "_fields"):
        for f in got._fields:
            _leaves_equal(getattr(got, f), getattr(want, f), f"{path}.{f}")
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype, path
    np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# the mesh, the batched state and the drive's pieces
# ---------------------------------------------------------------------------


def test_mesh_slots_and_no_card():
    mesh = tmesh.make_mesh(4, device="cpu")
    assert (mesh.size, mesh.axis, mesh.device.type) == (4, "session", "cpu")
    x = torch.zeros(8, 3)
    assert tmesh.shard_batch({"x": x}, mesh)["x"].shape == (8, 3)
    with pytest.raises(ValueError):
        tmesh.shard_batch(torch.zeros(6, 3), mesh)
    assert tmesh.replicated(torch.zeros(6), mesh).shape == (6,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tms.make_batched_state(_tiny()[1], 4)


def test_make_batched_state_is_msst_tpus():
    jp, tp = _tiny()
    _leaves_equal(tms.make_batched_state(tp, S, "cpu"),
                  jax_batched_state(jp, S))


def _offset_states(jp):
    """The overlap stores of tests/test_parallel.py with graph poses, a
    moving filter and a valid map, so that every field the injection
    touches is non-trivial."""
    from msst_tpu.ops import se3

    st = _two_session_overlap_states(jp)
    rng = np.random.default_rng(21)
    K = jp.max_keyframes
    kvalid = np.arange(K)[None] < np.asarray(st.kf.count)[:, None]
    poses = se3.Pose.from_vec6(st.kf.pose6)
    q = rng.normal(size=(S, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    nav = st.filter.nav._replace(
        q=jnp.asarray(q), p=jnp.asarray(rng.normal(size=(S, 3)), jnp.float32),
        v=jnp.asarray(rng.normal(size=(S, 3)), jnp.float32))
    return st._replace(
        graph=st.graph._replace(poses=poses, pose_mask=jnp.asarray(kvalid)),
        filter=st.filter._replace(nav=nav),
        local_map=st.local_map._replace(valid=jnp.ones(S, bool)))


def test_inject_frame_offsets_matches():
    jp, _ = _tiny()
    st = _offset_states(jp)
    rng = np.random.default_rng(99)
    offs = np.zeros((S, 6), np.float32)
    offs[1:, :3] = rng.uniform(-0.03, 0.03, (S - 1, 3))
    offs[1:, 3:] = rng.uniform(-0.6, 0.6, (S - 1, 3))
    want = _np(jms.inject_frame_offsets(st, jnp.asarray(offs)))
    got = convert.to_numpy(tms.inject_frame_offsets(_port_state(st),
                                                    torch.from_numpy(offs)))
    for path, g, w in [("kf.pose6", got.kf.pose6, want.kf.pose6),
                       ("graph.q", got.graph.poses.q, want.graph.poses.q),
                       ("graph.t", got.graph.poses.t, want.graph.poses.t),
                       ("pose6", got.pose6, want.pose6),
                       ("nav.q", got.filter.nav.q, want.filter.nav.q),
                       ("nav.p", got.filter.nav.p, want.filter.nav.p),
                       ("nav.v", got.filter.nav.v, want.filter.nav.v)]:
        np.testing.assert_allclose(g, w, atol=INJECT_TOL, err_msg=path)
    # the rows past each store's count and the masks are untouched, equal
    kvalid = np.arange(jp.max_keyframes)[None] < want.kf.count[:, None]
    np.testing.assert_array_equal(got.kf.pose6[~kvalid], want.kf.pose6[~kvalid])
    np.testing.assert_array_equal(got.kf.baked, want.kf.baked)
    np.testing.assert_array_equal(got.local_map.valid, want.local_map.valid)
    np.testing.assert_array_equal(got.graph.pose_mask, want.graph.pose_mask)


# ---------------------------------------------------------------------------
# the merges
# ---------------------------------------------------------------------------


def _coop_states(jp):
    """tests/test_parallel.py:50-75: session 0 mapped a plane around the
    origin (2 keyframes); session 1 stands there with no keyframes."""
    states = jax_batched_state(jp, S)
    rng = np.random.default_rng(0)
    kf = states.kf
    pose6, times = np.array(kf.pose6), np.array(kf.time)
    surf, smask = np.array(kf.surf_xyz), np.array(kf.surf_mask)
    counts = np.array(kf.count)
    for k in range(2):
        pose6[0, k] = [0, 0, 0, 2.0 * k, 0, 0]
        times[0, k] = 100.0 + k
        pts = rng.uniform(-5, 5, (jp.kf_surf_cap, 3)).astype(np.float32)
        pts[:, 2] = 0.1 * rng.standard_normal(jp.kf_surf_cap)
        surf[0, k] = pts
        smask[0, k] = True
    counts[0] = 2
    cur = np.array(states.pose6)
    cur[1] = [0, 0, 0, 1.0, 0.5, 0]
    return states._replace(
        kf=kf._replace(pose6=jnp.asarray(pose6), time=jnp.asarray(times),
                       surf_xyz=jnp.asarray(surf), surf_mask=jnp.asarray(smask),
                       count=jnp.asarray(counts)),
        pose6=jnp.asarray(cur))


def _selective_states(jp):
    """tests/test_parallel.py:173-181: session 1 keeps its position, not
    its keyframes."""
    st = _two_session_overlap_states(jp)
    counts, smask = np.array(st.kf.count), np.array(st.kf.surf_mask)
    counts[1] = 0
    smask[1] = False
    return st._replace(kf=st.kf._replace(count=jnp.asarray(counts),
                                         surf_mask=jnp.asarray(smask)))


def _tie_states(jp):
    """Session 0 holds 6 keyframes at ONE position, each with its own patch
    of floor: every receiver's distances to them tie, so which `budget`
    of them ride the ring is the tie order alone (the lower slot first,
    lax.top_k's), and the merged maps differ if the order does."""
    states = jax_batched_state(jp, S)
    rng = np.random.default_rng(7)
    kf = states.kf
    pose6, times = np.array(kf.pose6), np.array(kf.time)
    surf, smask = np.array(kf.surf_xyz), np.array(kf.surf_mask)
    counts = np.array(kf.count)
    for k in range(6):
        pose6[0, k] = [0, 0, 0, 1.0, 1.0, 0]
        times[0, k] = 100.0 + k
        pts = rng.uniform(-1.5, 1.5, (jp.kf_surf_cap, 3)).astype(np.float32)
        pts[:, 0] += 4.0 * (k - 2.5)
        pts[:, 2] = 0.05 * rng.standard_normal(jp.kf_surf_cap)
        surf[0, k] = pts - pose6[0, k, 3:]
        smask[0, k] = True
    counts[0] = 6
    cur = np.array(states.pose6)
    cur[:, 3:] = [1.0, 1.0, 0.0]
    return states._replace(
        kf=kf._replace(pose6=jnp.asarray(pose6), time=jnp.asarray(times),
                       surf_xyz=jnp.asarray(surf), surf_mask=jnp.asarray(smask),
                       count=jnp.asarray(counts)),
        pose6=jnp.asarray(cur))


def _cells(vox, f):
    """{cell: (count, usable, mean)} of session f's occupied voxels
    (usable: ``mask & valid``, the occupied-voxel count of
    tests/test_parallel.py)."""
    v = _np(vox) if not isinstance(vox.mask, torch.Tensor) else \
        convert.to_numpy(vox)
    m = v.mask[f]
    return {tuple(int(x) for x in c): (int(n), bool(ok), mu) for c, n, ok, mu
            in zip(v.coords[f][m], v.count[f][m], v.valid[f][m],
                   v.mean[f][m])}


_NEIGHBOURS = [np.array(d) for d in np.ndindex(3, 3, 3) if d != (1, 1, 1)]


def _assert_maps_match(got, want):
    """Each session's voxel maps cell by cell.  A centroid on a cell face
    (the sim room's floor is the plane z = 0, and a session standing at
    z = 0 puts it on a face of its map's grid) falls on either side by
    rounding: a cell whose point count differs must have a neighbour whose
    count differs the other way, and such cells are few.  Every other cell
    is equal in count and usability, its mean to 1e-4 m.  Returns the
    usable voxels of each (map, session)."""
    n = []
    for name in ("corner_vox", "surf_vox"):
        for f in range(S):
            g = _cells(getattr(got, name), f)
            w = _cells(getattr(want, name), f)
            gap = {c: g.get(c, (0,))[0] - w.get(c, (0,))[0]
                   for c in g.keys() | w.keys()}
            moved = {c for c, d in gap.items() if d}
            for c in moved:
                assert any(gap.get(tuple(np.array(c) - 1 + d), 0)
                           * gap[c] < 0 for d in _NEIGHBOURS), (name, f, c)
            assert len(moved) <= max(4, len(w) // 50), (name, f, len(moved))
            for c in w.keys() - moved:
                assert g[c][1] == w[c][1], (name, f, c)
                if w[c][1]:
                    np.testing.assert_allclose(g[c][2], w[c][2],
                                               atol=VOX_MEAN_TOL)
            n.append(sum(ok for _, ok, _ in w.values()))
    return n


_MERGES = {
    "full": (_coop_states, "cooperative_map_merge", {}),
    "selective": (_selective_states, "cooperative_map_merge_selective",
                  {"budget": 4}),
    "selective_ties": (_tie_states, "cooperative_map_merge_selective",
                       {"budget": 2}),
}


@pytest.mark.parametrize("case", sorted(_MERGES))
def test_merge_matches(case):
    """Both merges on tests/test_parallel.py's hand-built stores, and the
    ring's tie order: each session's usable voxels and their means."""
    make, fn, kw = _MERGES[case]
    jp, tp = _tiny()
    mesh, tmesh_ = _meshes()
    st = make(jp)
    scan_time = jnp.full((S,), 101.0 if case != "selective_ties" else 105.0,
                         jnp.float32)
    want = getattr(jms, fn)(shard_batch(st, mesh), shard_batch(scan_time, mesh),
                            jp, mesh, **kw)
    got = getattr(tms, fn)(_port_state(st), torch.from_numpy(
        np.asarray(scan_time)), tp, tmesh_, **kw)
    n = _assert_maps_match(got.local_map, want.local_map)
    assert n[S + 1] > 20   # session 1's surf map: shared keyframes
    if case == "selective_ties":
        # the patches that reached session 3 (patch k lies around x = 4k - 9
        # m): the first two slots of the tie, as lax.top_k orders them
        means = np.stack([mu for _, ok, mu in _cells(
            got.local_map.surf_vox, 3).values() if ok])
        assert set(np.round(means[:, 0] / 4.0 + 2.5).astype(int)) == {0, 1}
    # the solo rebuild (no exchange): session 1 sees nothing
    solo = tmap._rebuild_local_map(tms._row(_port_state(st).kf, 1),
                                   torch.from_numpy(np.asarray(st.pose6[1, 3:])),
                                   torch.tensor(101.0), tp)
    assert int(torch.sum(solo.surf_vox.mask & solo.surf_vox.valid)) == 0


# ---------------------------------------------------------------------------
# the align
# ---------------------------------------------------------------------------


def _rows_states(jp):
    """tests/test_parallel.py:208-261: batch 16 over 8 slots (b = 2), rows
    0 and 1 each a fleet, flat 2 and 3 offset differently."""
    import scipy.spatial.transform as sst

    from msst_tpu.ops import se3

    states = jax_batched_state(jp, 16)
    world = sim.World()
    rng = np.random.default_rng(5)
    kf = states.kf
    pose6, times = np.array(kf.pose6), np.array(kf.time)
    surf, smask = np.array(kf.surf_xyz), np.array(kf.surf_mask)
    counts, cur = np.array(kf.count), np.array(states.pose6)
    offsets = {2: np.array([0, 0, 0.04, 0.4, -0.25, 0.0], np.float32),
               3: np.array([0, 0, -0.04, -0.35, 0.3, 0.0], np.float32)}
    for flat in (0, 1, 2, 3):
        dev = flat // 2
        for k in range(2):
            pos = np.array([1.0 * k + 0.5 * dev, 0.3 * dev, 1.5])
            T = np.eye(4)
            T[:3, :3] = sst.Rotation.from_euler("z", 0.2 * k).as_matrix()
            T[:3, 3] = pos
            xyz, _, _, _ = sim.raycast_scan(world, T, n_scan=8, horizon=180,
                                            noise=0.005, rng=rng)
            keep = (np.isfinite(xyz).all(axis=1)
                    & (np.linalg.norm(xyz, axis=1) < 60))
            pts = xyz[keep][:surf.shape[2]]
            rpy = sst.Rotation.from_matrix(T[:3, :3]).as_euler("xyz")
            p6 = np.concatenate([rpy, T[:3, 3]]).astype(np.float32)
            if flat in offsets:
                off = se3.Pose.from_vec6(jnp.asarray(offsets[flat]))
                p6 = np.asarray(off.compose(
                    se3.Pose.from_vec6(jnp.asarray(p6))).to_vec6())
            pose6[flat, k] = p6
            times[flat, k] = 100.0 + k
            surf[flat, k, :len(pts)] = pts
            smask[flat, k, :len(pts)] = True
        counts[flat] = 2
        cur[flat] = pose6[flat, 1]
    return states._replace(
        kf=kf._replace(pose6=jnp.asarray(pose6), time=jnp.asarray(times),
                       surf_xyz=jnp.asarray(surf), surf_mask=jnp.asarray(smask),
                       count=jnp.asarray(counts)),
        pose6=jnp.asarray(cur))


_ALIGNS = {
    "offset": lambda jp: _two_session_overlap_states(
        jp, offset=np.array([0.0, 0.0, 0.04, 0.4, -0.25, 0.0], np.float32)),
    "rows_b2": _rows_states,
}


@pytest.mark.parametrize("case", sorted(_ALIGNS))
def test_cross_session_align_matches(case):
    """tests/test_parallel.py:283-308 (one offset session) and :194-280
    (b = 2 rows, each its own fleet): the same rendezvous, candidates and
    anchors, and the same corrected keyframes."""
    jp, tp = _tiny()
    mesh, tmesh_ = _meshes()
    st = _ALIGNS[case](jp)
    want_st, want = jms.cross_session_align(shard_batch(st, mesh), jp, mesh)
    got_st, got = tms.cross_session_align(_port_state(st), tp, tmesh_)
    want, want_st = _np(want), _np(want_st)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["found"].numpy(), want["found"])
    np.testing.assert_array_equal(got["candidate_session"].numpy(),
                                  want["candidate_session"])
    assert got["candidate_session"].dtype == torch.int32
    np.testing.assert_allclose(got["fitness"].numpy(), want["fitness"],
                               atol=FIT_TOL)
    np.testing.assert_allclose(got["anchor_pose6"].numpy(),
                               want["anchor_pose6"], atol=ALIGN_TOL)
    assert want["found"].sum() >= (2 if case == "rows_b2" else 1)
    np.testing.assert_allclose(got_st.kf.pose6.numpy(), want_st.kf.pose6,
                               atol=ALIGN_TOL)
    np.testing.assert_allclose(got_st.pose6.numpy(), want_st.pose6,
                               atol=ALIGN_TOL)
    np.testing.assert_array_equal(got_st.kf.baked.numpy(), want_st.kf.baked)
    # the rebaked maps, from keyframe poses ~1e-4 m apart: same anchors, and
    # usable voxel counts within 2 % (points near faces and the moment
    # tables' overflow order move a few cells)
    np.testing.assert_array_equal(got_st.local_map.valid.numpy(),
                                  want_st.local_map.valid)
    np.testing.assert_allclose(got_st.local_map.anchor.numpy(),
                               want_st.local_map.anchor, atol=ALIGN_TOL)
    for name in ("corner_vox", "surf_vox"):
        gv, wv = getattr(got_st.local_map, name), getattr(want_st.local_map,
                                                            name)
        n_got = (gv.mask & gv.valid).sum(1).numpy()
        n_want = (wv.mask & wv.valid).sum(1)
        np.testing.assert_allclose(n_got, n_want, rtol=0.02, atol=2)
