"""msst_torch — the PyTorch and CUDA port of msst_tpu.

The LIO-SAM pipeline (deskew, LOAM features, IMU preintegration, ESKF
propagation, scan-to-map Gauss-Newton against the incremental voxel-feature
map or the 5-NN map clouds, keyframe and pose-graph update with the dense
or the CG solver, and loop closure) runs here on PyTorch tensors.  Each
Pallas kernel of msst_tpu is a CUDA C++ kernel written for Hopper in
``msst_torch/csrc``: the voxel-feature lookup and the hash-grid 5-NN query
of the Gauss-Newton loop, and the row gather through which loop closure
reads the keyframe store; every other op is plain PyTorch.  ``msst_tpu``
stays beside this package as the reference the tests hold it against.

Package layout mirrors ``msst_tpu``:

* ``msst_torch.ops``            — geometry and compute ops (+ kernel wrappers)
* ``msst_torch.models.liosam``  — the LIO-SAM estimator
* ``msst_torch.utils``          — the numpy simulator (a copy of msst_tpu's),
                                  bench.py's ring graph, the GPU profiler
* ``msst_torch.csrc``           — CUDA sources, built with nvcc at first use
                                  into ``msst_torch/build/``
"""

import torch

__version__ = "0.1.0"


def _configure_matmul_precision():
    """Full f32 for every matmul and convolution.

    The estimator's matmuls are geometric: point transforms and Gauss-Newton
    normal equations over metric coordinates of 10-100 m, where TF32's
    10-bit mantissa steps are centimetres.  TF32 is off for cuBLAS and cuDNN
    alike, the counterpart of msst_tpu forcing HIGHEST precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


_configure_matmul_precision()
