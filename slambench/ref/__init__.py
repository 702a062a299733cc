"""The benchmark's plain reference of the LIO-SAM path: a frozen copy of the
port's ``msst_torch/models/liosam`` and the ops it runs, at commit e686079,
in which every hand-written kernel's dispatch takes its plain PyTorch twin
(the voxel lookup B1, the hash-grid k-NN query B2, the row gather B3).
Functions that no path of ``LioSam`` reaches under any ``LioParams`` option
(the calibration tools' GICP and NDT, the Allan variance, the fusion and
crop ops, unused helpers) are left out; the option-gated paths that no
cell runs yet (the k-NN scan-to-map, the other window layouts, the CG
solver) stay, so that a cell added as data files alone can use them.

It imports nothing of ``msst_torch``, ``jax`` or ``msst_tpu``, and is fed
the same host inputs as the program; the comparison in
``slambench/compare.py`` drives it after the measured window.  A later PR
changes the program, never this copy: it is the yardstick the program's
poses, keyframes and loops are held to.
"""
