"""Device-mesh helpers for the (data, kf) parallelism axes.

SURVEY.md §2.2 / §5.8: the communication backend is the JAX runtime only —
`jax.make_mesh` + `shard_map` + XLA collectives, which XLA lowers to NCCL
over NVLink between the GPUs of one host. No MPI layer exists in the
reference (single process) or here.

Axes:
  "data" — independent sequences (DP; north-star config #4)
  "kf"   — the keyframe/map axis: landmarks and map blocks sharded for
           distributed BA / mapping (SP/CP analog; config #5)
"""

from __future__ import annotations

import jax


def make(n: int, axis_name: str = "data"):
    """1-D mesh over the first n local devices.

    Auto axis type: classic GSPMD propagation (jax 0.9 defaults to the
    explicit sharding-in-types mode, which rejects multi-axis reshape
    splits like the pyramid halfsample)."""
    return jax.make_mesh((n,), (axis_name,),
                         axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:n])


def make_2d(n_data: int, n_kf: int):
    """(data, kf) mesh: sequences × map shards."""
    return jax.make_mesh((n_data, n_kf), ("data", "kf"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[: n_data * n_kf])


def initialize_multihost():
    """Standard JAX multi-host bring-up (document-only in this sandbox:
    single-process; see SURVEY.md §5.8)."""
    jax.distributed.initialize()
