"""Stereo semi-direct visual odometry (SVO) SLAM engine in JAX.

A from-scratch JAX/XLA re-architecture of the capabilities of the
reference C++/OpenCV implementation ``eichenberger/stereo-svo-slam``
(see SURVEY.md §0 for what of the reference was available):
FAST/edgelet detection on pyramids, sparse direct image alignment,
pyramidal KLT feature tracking, recursive depth filters seeded by stereo
triangulation, Gauss-Newton pose refinement, keyframe local bundle
adjustment and pose-graph optimization — batched, fixed-capacity, masked,
fully jittable, vmap-able over sequences and shard_map-able over a device
mesh for distributed mapping.
"""

from .config import CameraConfig, SvoConfig, euroc_config, kitti_config  # noqa: F401

__version__ = "0.1.0"
