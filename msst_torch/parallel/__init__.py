"""Multi-session mapping on one card (port of ``msst_tpu.parallel``).

msst_tpu scales sessions (parallel bag replays, robots building one map)
over a device mesh with the estimator state batched on the leading axis.
On one GPU the mesh is a number of session slots on that card, and each
collective is a tensor op on the leading axis (``mesh``,
``multisession``).
"""

from .mesh import make_mesh, replicated, shard_batch  # noqa: F401
from .multisession import (batched_odometry_step,  # noqa: F401
                           cooperative_map_merge,
                           cooperative_map_merge_selective,
                           cross_session_align, drive_params,
                           inject_frame_offsets, make_batched_state,
                           multisession_drive)
