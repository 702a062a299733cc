"""Carry maps and estimator state between msst_tpu and the port.

``from_numpy(tree, device)`` takes a msst_tpu NamedTuple whose leaves were
turned into numpy arrays (``jax.tree.map(np.asarray, x)``) and builds the
port's NamedTuple of the same name and fields, with tensors on `device`
(a field only the port has, ``LoopResult.tried``, keeps its default);
``to_numpy(obj)`` turns the port's tensors back into numpy arrays.  Dtypes
are kept (bool stays bool, int32 stays int32).  Every leaf is carried,
the knn hash grids of ``LocalMap`` included, so a state of either
scan-to-map method taken from msst_tpu is a state the port can step from;
so is a heading estimator's ``HeadingState`` or a target tracker's
``TrackerState`` (with its ``KalmanState``), and a step's ``StepInput``
and ``StepOutput``, batched or not.

``config_from(cfg)`` takes a msst_tpu config (``MultiLicaConfig``,
``AutoCalibConfig``, ``NdtCalibConfig``, ``HeadingConfig``,
``TargetConfig``, ``FusionConfig``) to the port's, field by field and by
name; ``ndt_calibrator_from(cal, device)`` builds the port's
``NdtCalibrator`` with msst_tpu's config, carried pose and score history, so
that both packages go on from the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import fusion, heading, target_tracker
from .models.calibration import auto_calib, multi_lica, ndt_calib
from .models.liosam import frontend, imu_fusion, loop, mapping, state
from .ops import (graph, imu, kalman, knn, pointcloud, registration, se3,
                  voxelmap)

_TYPES = {cls.__name__: cls for cls in (
    voxelmap.VoxelFeatureMap, voxelmap.VoxelMoments, knn.HashGrid,
    graph.PoseGraph, graph.PriorFactor, graph.BetweenFactor, graph.GpsFactor,
    se3.Pose, imu_fusion.FilterState, imu.NavState, imu.ImuBias,
    state.LioState, state.KeyframeStore, state.LocalMap,
    mapping.StepInput, mapping.StepOutput, frontend.ScanInput,
    loop.LoopResult, registration.IcpResult, registration.NdtMap,
    pointcloud.Cloud, kalman.KalmanState, target_tracker.TrackerState,
    heading.HeadingState,
)}
_CONFIGS = {cls.__name__: cls for cls in (
    multi_lica.MultiLicaConfig, auto_calib.AutoCalibConfig,
    ndt_calib.NdtCalibConfig, heading.HeadingConfig,
    target_tracker.TargetConfig, fusion.FusionConfig,
)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy(tree, device):
    """msst_tpu NamedTuple of numpy arrays -> the port's NamedTuple (None
    stays None, so ``from_numpy(to_numpy(x), device)`` copies a state of
    the port to another device)."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        cls = _TYPES[type(tree).__name__]
        # a field of the port's own (it has a default) that msst_tpu lacks
        # takes its default
        return cls(**{f: from_numpy(getattr(tree, f), device)
                      for f in cls._fields if hasattr(tree, f)})
    return torch.from_numpy(np.array(tree)).to(device)


def to_numpy(obj):
    """The port's NamedTuple of tensors -> the same NamedTuple of numpy
    arrays (None stays None)."""
    if _is_namedtuple(obj):
        return type(obj)(*(to_numpy(v) for v in obj))
    if obj is None:
        return None
    return obj.detach().cpu().numpy()


def config_from(cfg):
    """A msst_tpu config -> the port's config of the same name, every field
    carried by name."""
    cls = _CONFIGS[type(cfg).__name__]
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})


def ndt_calibrator_from(cal, device) -> ndt_calib.NdtCalibrator:
    """msst_tpu's ``NdtCalibrator`` -> the port's on `device`: its config,
    the pose it carries into the next frame and its score history."""
    out = ndt_calib.NdtCalibrator(config_from(cal.cfg), device=device)
    out.pose = from_numpy(cal.pose, out.device)
    out.history = [float(h) for h in cal.history]
    return out
