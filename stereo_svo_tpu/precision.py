"""Matmul precision of each op group, chosen in this one module.

On an NVIDIA H100 an f32 ``dot``/``einsum`` at XLA's DEFAULT precision may
run on the tensor cores in TF32, which keeps a 10-bit mantissa: about three
decimal digits. That is too coarse for the engine's small dense algebra, so
every dot in the engine names its group's precision here instead of taking
the backend default. ``HIGHEST`` is true f32 (FMA units, no tensor cores);
the dots are tiny (3x3 rotations, 6x6 normal equations, (N,P²)·(P²,6)
reductions), so none of them is bound by the tensor-core rate.

Groups:

* ``GEOMETRY`` — SE(3) compose/exp/transform, projection Jacobians,
  triangulation. A TF32 rotation compose loses ~1e-3 relative per step,
  which compounds over a trajectory of composes.
* ``SOLVER`` — Gauss-Newton / Lucas-Kanade / bundle-adjustment /
  pose-graph normal equations (JᵀWJ, Jᵀr) and their matvecs. The
  normal equations square the Jacobian's condition number; window BA
  diverged at reduced-precision inputs when it was first built.
* ``RENDER`` — the synthetic ray caster that makes the test and bench
  frames. A TF32 ray rotation shifts pixels against the exact ground
  truth the accuracy gates compare with.
* ``MATCHING`` — ZNCC scores and place-recognition descriptor
  similarities. TF32 error on unit vectors (~1e-3) is the size of the
  stereo prominence gate (0.005) and would move argmax ties.

Bilinear sampling (``ops/interp.py``) is a 4-tap gather with no dot at
all, so it is exact f32 without a setting here.
"""

from __future__ import annotations

import jax

GEOMETRY = jax.lax.Precision.HIGHEST
SOLVER = jax.lax.Precision.HIGHEST
RENDER = jax.lax.Precision.HIGHEST
MATCHING = jax.lax.Precision.HIGHEST
