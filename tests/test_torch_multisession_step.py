"""The port's ``batched_odometry_step`` over 8 sessions against msst_tpu's
on the CPU.

msst_tpu's ``odometry_core`` reads an undefined name ``inp`` where it means
its prepared scan ``ps`` (mapping.py:1295-1301), so its
``batched_odometry_step`` raises NameError.  The reference here is a
test-local jitted ``vmap`` of msst_tpu's step that binds ``mapping.inp =
ps`` while it traces (tests/test_torch_slice.py does the same for one
session): the same function as ``batched_odometry_step`` without its
sharding constraints.  Under ``vmap`` each session's ``lax.cond`` selects
its own branch and each ``while_loop`` keeps a finished session's carry,
which is what the port's session-by-session step computes.

Each of msst_tpu's 6 steps of 8 moving sessions (16 x 180, the graft-entry
tiny profile's sizes; horizon 90 gives too few corners to register) goes
through the port's step from msst_tpu's own states: keyframe decisions,
keyframe counts, Gauss-Newton iterations, feature counts and degeneracy
flags equal; poses to 1e-4 m/rad and velocities to 1e-3 m/s (as the
one-session slice test); the fleet statistics to the same.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from msst_torch import convert
from msst_torch.parallel import mesh as tmesh
from msst_torch.parallel import multisession as tms
from msst_tpu.models.liosam import mapping as jmap
from msst_tpu.parallel import multisession as jms
from msst_tpu.utils import sim
from tests.test_torch_multisession import (_np, _port_params, _port_state,
                                          jax_batched_state)

S = 8
N_STEPS = 6
POSE_TOL = 1e-4
VEL_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops, many of them: one torch thread per xdist worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bound_step(state, inp, p):
    ps = jmap.prepare_scan(inp, p)
    jmap.inp = ps   # the name msst_tpu's odometry_core reads; see docstring
    try:
        return jmap.odometry_core(state, ps, p)
    finally:
        del jmap.inp


def strong(tree):
    """`tree` with every leaf a strongly typed array: msst_tpu's
    ``make_batched_state`` gives weakly typed leaves where its step gives
    strong ones, and each change of type costs a compile of the step."""
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)


@functools.partial(jax.jit, static_argnames=("p",))
def reference_batched_step(states, inputs, p):
    """msst_tpu's ``batched_odometry_step`` through the binding step (give
    it :func:`strong` states: one compile for every step)."""
    new_states, outs = jax.vmap(lambda s, i: _bound_step(s, i, p))(states,
                                                                   inputs)
    stats = {
        "total_keyframes": jnp.sum(outs.kf_count),
        "degenerate_sessions": jnp.sum(outs.degenerate.astype(jnp.int32)),
        "mean_speed": jnp.mean(jnp.linalg.norm(outs.velocity, axis=-1)),
    }
    return new_states, outs, stats


def _fleet_scans(jp):
    world = sim.World()
    return [sim.make_dataset(
        world, sim.SimTrajectory(kind="circle", radius=8.0,
                                 speed=1.6 + 1.4 * j / (S - 1)),
        n_scans=N_STEPS, scan_dt=0.1, n_scan=jp.n_scan,
        horizon=jp.horizon_scan, seed=30 + j) for j in range(S)]


def _packed(pack, p, data, i):
    prev = None if i == 0 else data[0][i - 1]["scan_start"]
    return [pack(p, data[j][i], prev,
                 init_vel=np.array([1.5, 0.1, 0.0]) if i == 0 else None)
            for j in range(S)]


def test_pack_step_input_is_msst_tpus():
    jp = ge._tiny_p(horizon=180)
    data = _fleet_scans(jp)
    for i in range(2):
        for w, g in zip(_packed(jms._pack_step_input, jp, data, i),
                        _packed(tms._pack_step_input, _port_params(jp), data,
                                i)):
            for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(g)):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.fixture(scope="module")
def step_reference():
    """msst_tpu's batched step over 8 sessions and 6 scans: its inputs and
    the states before and after each step."""
    jp = ge._tiny_p(horizon=180)
    data = _fleet_scans(jp)
    states = strong(jax_batched_state(jp, S))
    record = []
    for i in range(N_STEPS):
        rows = _packed(jms._pack_step_input, jp, data, i)
        inputs = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *rows)
        new, outs, stats = reference_batched_step(states, inputs, jp)
        record.append((_np(states), _np(inputs), _np(new), _np(outs),
                       _np(stats)))
        states = new
    return jp, record


def test_batched_step_matches(step_reference):
    """Each of msst_tpu's steps from its own states through the port's
    batched step: the same per-session decisions, poses, velocities and
    fleet statistics, and the stepped states' keyframes and poses."""
    jp, record = step_reference
    tp = _port_params(jp)
    mesh = tmesh.make_mesh(S, device="cpu")
    registered = keyframes = 0
    for state, inputs, new, outs, stats in record:
        got_st, got, got_stats = tms.batched_odometry_step(
            _port_state(state), convert.from_numpy(inputs, "cpu"), tp, mesh)
        for f in ("is_keyframe", "kf_count", "degenerate", "s2m_iterations",
                  "n_corner", "n_surf"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          getattr(outs, f), err_msg=f)
        np.testing.assert_allclose(got.pose6.numpy(), outs.pose6,
                                   atol=POSE_TOL)
        np.testing.assert_allclose(got.velocity.numpy(), outs.velocity,
                                   atol=VEL_TOL)
        for k in ("total_keyframes", "degenerate_sessions"):
            assert int(got_stats[k]) == int(stats[k]), k
        np.testing.assert_allclose(float(got_stats["mean_speed"]),
                                   float(stats["mean_speed"]), atol=VEL_TOL)
        np.testing.assert_array_equal(got_st.kf.count.numpy(), new.kf.count)
        np.testing.assert_allclose(got_st.kf.pose6.numpy(), new.kf.pose6,
                                   atol=POSE_TOL)
        np.testing.assert_allclose(got_st.pose6.numpy(), new.pose6,
                                   atol=POSE_TOL)
        np.testing.assert_array_equal(got_st.local_map.valid.numpy(),
                                      new.local_map.valid)
        registered += int(np.sum(outs.s2m_iterations > 0))
        keyframes += int(np.sum(outs.is_keyframe))
    # every session registered from its second step on, and the fleet
    # inserted keyframes past the first
    assert registered == S * (N_STEPS - 1), registered
    assert keyframes > S, keyframes
