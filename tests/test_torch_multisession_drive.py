"""The port's multi-session drive (``msst_torch.parallel.multisession_drive``)
against msst_tpu's on the CPU: 4 session slots, 30 scans of 16 x 360
(``drive_params``), the frame offsets injected at scan 20 and an align
every 6 scans (tests/test_parallel.py's drive, cut as __graft_entry__'s
dry run cuts it, on 4 slots).

msst_tpu's drive runs its ``batched_odometry_step``, which raises NameError
(``odometry_core`` reads an undefined ``inp``); inside this test that name
is monkeypatched to the binding step of test_torch_multisession_step.py,
the same function.  Each package threads its own states through the
whole drive, so the two drives drift apart by float32 rounding amplified
over 30 scans and 2 aligns: the errors to 0.03 m (measured 0.005-0.013 m),
the mean speeds to 0.01 m/s, the same number of verified rendezvous.  (At
8 slots over 56 scans and 5 aligns the two drives end ~0.15 m apart: the
drive amplifies rounding chaotically there, see
scripts/torch_vs_ref_multisession.py.)
"""

import pytest
import torch

from msst_torch.parallel import mesh as tmesh
from msst_torch.parallel import multisession as tms
from msst_tpu.parallel import make_mesh
from msst_tpu.parallel import multisession as jms
from tests.test_torch_multisession import jax_batched_state
from tests.test_torch_multisession_step import reference_batched_step, strong

SLOTS = 4
DRIVE = dict(n_scans=30, n_warm=20, align_every=6)
ERR_TOL_M = 0.03
SPEED_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops, many of them: one torch thread per xdist worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drives():
    """Both packages' aligned drives: {package: result}."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jms, "batched_odometry_step",
               lambda states, inputs, p, mesh, axis="session":
               reference_batched_step(strong(states), inputs, p))
    mp.setattr(jms, "make_batched_state", jax_batched_state)
    try:
        jp = jms.drive_params()
        want = jms.multisession_drive(jp, make_mesh(SLOTS), **DRIVE)
    finally:
        mp.undo()
    tp = tms.drive_params()
    mesh = tmesh.make_mesh(SLOTS, device="cpu")
    got = tms.multisession_drive(tp, mesh, **DRIVE)
    return {"msst_tpu": want, "msst_torch": got}


def test_drive_matches(drives):
    want, got = drives["msst_tpu"], drives["msst_torch"]
    assert sorted(got) == sorted(want)
    assert got["injected_offset_m"] == want["injected_offset_m"]
    assert got["loops_total"] == want["loops_total"]
    for k in ("err_at_injection", "err_final", "err_datum_final"):
        assert abs(got[k] - want[k]) <= ERR_TOL_M, (k, got, want)
    assert abs(got["mean_speed"] - want["mean_speed"]) <= SPEED_TOL


def test_drive_align_reduces_disagreement(drives):
    """The dry run's gates (__graft_entry__.py:220-224) on the port's
    drive: the sessions move, the align closes rendezvous and pulls the
    perturbed sessions back."""
    got = drives["msst_torch"]
    assert got["mean_speed"] > 1.0
    assert got["loops_total"] > 0
    assert got["err_final"] < got["err_at_injection"]
