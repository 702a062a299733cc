"""The session mesh on one card (port of ``msst_tpu.parallel.mesh``).

msst_tpu lays sessions out over a ``jax.sharding.Mesh`` of devices, one
session (or ``b`` batch rows of sessions) per device.  The port runs on one
GPU, so a mesh is ``n_devices`` session *slots* on that one device: a
batched state keeps msst_tpu's flat, slot-major order (flat row ``slot * b
+ row``, as ``PartitionSpec("session")`` lays it out), and each collective
of msst_tpu becomes a tensor op on the leading axis (see
``multisession``).  No process is started and no NCCL is used.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Mesh(NamedTuple):
    """`size` session slots of `axis` on one `device`."""

    size: int
    axis: str
    device: torch.device


def card(device) -> torch.device:
    """`device` as a torch.device; raises where it names CUDA and no CUDA
    device is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"multi-session runs on device={str(device)!r} and no CUDA device "
            "is present; pass device='cpu' to run on the CPU")
    return device


def make_mesh(n_devices: int, axis: str = "session", device=None) -> Mesh:
    """A mesh of `n_devices` session slots on one device: the card unless
    the caller passes ``device="cpu"``.  Unlike msst_tpu's ``make_mesh``,
    `n_devices` is required: one card has no device list to count."""
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: need at least one slot")
    return Mesh(int(n_devices), axis, card("cuda" if device is None
                                           else device))


def _tree_map(fn, *trees):
    """`fn` over the matching leaves of one or more trees of one structure
    (NamedTuples, dicts, lists, tuples; None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *vs) for vs in zip(*trees)))
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *vs) for vs in zip(*trees))
    return fn(*trees)


def shard_batch(tree, mesh: Mesh, axis: str = "session"):
    """Move a tree whose leading axis is ``S * b`` onto the mesh's device
    (slot-major, as msst_tpu's ``P(axis)`` sharding lays it out); raises
    where the mesh's `S` slots do not divide a leading axis."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r}: the mesh's axis is {mesh.axis!r}")

    def put(x):
        x = torch.as_tensor(x)
        if x.ndim == 0 or x.shape[0] % mesh.size:
            raise ValueError(
                f"leading axis of shape {tuple(x.shape)} is not a multiple "
                f"of the mesh's {mesh.size} slots")
        return x.to(mesh.device)

    return _tree_map(put, tree)


def replicated(tree, mesh: Mesh):
    """Move a tree onto the mesh's device whole (msst_tpu's ``P()``)."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)
