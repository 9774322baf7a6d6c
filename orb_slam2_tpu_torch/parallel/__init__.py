"""Multi-device / multi-process execution: meshes and the distributed
solvers.

Port of ``orb_slam2_tpu/parallel``: the observation list of bundle
adjustment (or the point state with its observations, or the edges of
the pose graph) is split over the shards of a mesh; each shard
assembles its part of the Gauss-Newton blocks, ``psum`` closes the sums
over cameras and points, and the Schur-reduced PCG runs replicated.  A
mesh is a list of torch devices of this process (``make_mesh``; a
device may repeat) or the ranks of a ``torch.distributed`` group
(``init_multihost`` + ``make_global_mesh``).
"""
from .dist_ba import (distributed_bundle_adjust,  # noqa: F401
                      distributed_bundle_adjust_sharded_points, make_mesh)
from .dist_pose_graph import distributed_pose_graph  # noqa: F401
from .mesh import LocalMesh, ProcessGroupMesh, local_devices  # noqa: F401
from .multihost import init_multihost, make_global_mesh  # noqa: F401
