"""Static-shape device state for the sliding-window estimator.

The reference keeps per-feature C++ lists (`list<FeaturePerId>`,
feature_manager.h:18-71) and Ceres parameter blocks. This design replaces
both with fixed-slot arrays + validity masks (SURVEY.md §7 hard part #2):

  * ``WindowState`` — all optimization variables for the 11-frame window.
  * ``FeatureGrid`` — the dense [F, W+1] observation grid: feature slot f
    observed in frame j. Feature churn only flips mask bits; shapes never
    change, so the solver jits once.
  * ``PriorFactor`` — the square-root marginalization prior in the *full*
    172-dim local layout (blocks with no information are zero columns).

Local (tangent) layout, matching the reference's parameter blocks
(estimator.cpp:488-530) but flattened:

  [ pose_0 (6) ... pose_W (6) | sb_0 (9) ... sb_W (9) | ex (6) | td (1) ]

pose = (δp, δθ); sb = (δv, δba, δbg). Landmark inverse ray depths are kept
out of this layout and Schur-eliminated (DENSE_SCHUR equivalent).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def register_pytree(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda c: ([getattr(c, n) for n in fields], None),
        lambda aux, ch: cls(*ch),
    )
    return cls


WINDOW = 10  # sliding-window keyframes (reference WINDOW_SIZE, parameters.h:12)
NFRAMES = WINDOW + 1


def pose_dim(n_frames: int = NFRAMES, n_cams: int = 1) -> int:
    return 6 * n_frames + 9 * n_frames + 6 * n_cams + 1


# Block offsets inside the full local layout.
def pose_off(i: int) -> int:
    return 6 * i


def sb_off(i: int, n_frames: int = NFRAMES) -> int:
    return 6 * n_frames + 9 * i


def ex_off(n_frames: int = NFRAMES) -> int:
    return 6 * n_frames + 9 * n_frames


def td_off(n_frames: int = NFRAMES, n_cams: int = 1) -> int:
    return ex_off(n_frames) + 6 * n_cams


def ex_2d(tic, qic):
    """Canonical [C, 3] / [C, 4] view of the extrinsics. Mono states keep
    the historical rank-1 [3] / [4] shapes (NUM_OF_CAM=1 in the reference,
    parameters.h:14); multi-camera rigs (dual-PAL, BASELINE ID06/ID10)
    store one row per camera."""
    if tic.ndim == 1:
        return tic[None, :], qic[None, :]
    return tic, qic


def n_cams_of(state) -> int:
    return 1 if state.tic.ndim == 1 else int(state.tic.shape[0])


@register_pytree
@dataclasses.dataclass(frozen=True)
class WindowState:
    p: Any  # [W+1, 3]
    q: Any  # [W+1, 4] wxyz
    v: Any  # [W+1, 3]
    ba: Any  # [W+1, 3]
    bg: Any  # [W+1, 3]
    tic: Any  # [3] (mono) or [C, 3]: extrinsic translation (camera in IMU)
    qic: Any  # [4] (mono) or [C, 4]: extrinsic rotation
    td: Any  # [] time offset
    inv_depth: Any  # [F] inverse ray depth per feature slot

    @staticmethod
    def zeros(n_features: int, dtype=jnp.float32, n_frames: int = NFRAMES,
              n_cams: int = 1):
        qi = jnp.tile(jnp.asarray([1.0, 0, 0, 0], dtype), (n_frames, 1))
        unit_q = jnp.asarray([1.0, 0, 0, 0], dtype)
        return WindowState(
            p=jnp.zeros((n_frames, 3), dtype),
            q=qi,
            v=jnp.zeros((n_frames, 3), dtype),
            ba=jnp.zeros((n_frames, 3), dtype),
            bg=jnp.zeros((n_frames, 3), dtype),
            tic=jnp.zeros((3,), dtype) if n_cams == 1
            else jnp.zeros((n_cams, 3), dtype),
            qic=unit_q if n_cams == 1 else jnp.tile(unit_q, (n_cams, 1)),
            td=jnp.zeros((), dtype),
            inv_depth=jnp.ones((n_features,), dtype),
        )


@register_pytree
@dataclasses.dataclass(frozen=True)
class FeatureGrid:
    """Dense observation grid for F feature slots over the window frames."""

    bearing: Any  # [F, W+1, 3] unit bearings (camera frame)
    velocity: Any  # [F, W+1, 3] 3-D bearing velocity (feature_tracker.cpp:441-504)
    td_obs: Any  # [F, W+1] per-observation time ref: td_meas - TR/ROW*(row - ROW/2)
    valid: Any  # [F, W+1] bool observation mask
    anchor: Any  # [F] int32 anchor (start) frame per slot
    used: Any  # [F] bool — participates in BA (>=2 obs, anchored before W-2)
    # Per-observation camera id (multi-camera rigs, e.g. dual-PAL up+down;
    # the reference carries a camera id per feature-message entry,
    # estimator_node.cpp:292-312). None ⇒ all observations from camera 0 —
    # mono grids keep their historical pytree structure.
    cam: Any = None  # [F, W+1] int32 or None

    @property
    def n_features(self):
        return self.bearing.shape[0]

    @property
    def n_frames(self):
        return self.bearing.shape[1]

    def anchor_onehot(self, dtype):
        return jax.nn.one_hot(self.anchor, self.n_frames, dtype=dtype)

    def cam_onehot(self, n_cams: int, dtype):
        """[F, W+1, C] one-hot of each observation's camera."""
        if self.cam is None:
            oh = jnp.zeros(
                (self.n_features, self.n_frames, n_cams), dtype
            )
            return oh.at[..., 0].set(1.0)
        return jax.nn.one_hot(self.cam, n_cams, dtype=dtype)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @staticmethod
    def empty(n_features: int, dtype=jnp.float32, n_frames: int = NFRAMES):
        z = jnp.zeros((n_features, n_frames, 3), dtype)
        unit = z.at[..., 2].set(1.0)
        return FeatureGrid(
            bearing=unit,
            velocity=z,
            td_obs=jnp.zeros((n_features, n_frames), dtype),
            valid=jnp.zeros((n_features, n_frames), bool),
            anchor=jnp.zeros((n_features,), jnp.int32),
            used=jnp.zeros((n_features,), bool),
        )


@register_pytree
@dataclasses.dataclass(frozen=True)
class PriorFactor:
    """Square-root marginalization prior: r(x) = r0 + J · (x ⊟ x0).

    J is stored over the full 172-dim layout (zero cols for uninformed
    blocks); x0 is the linearization snapshot of the pose-part state.
    Mirrors MarginalizationFactor::Evaluate
    (marginalization_factor.cpp:333-381) but with static shapes.
    """

    J: Any  # [D, D] with D = pose_dim()
    r0: Any  # [D]
    x0_p: Any  # [W+1, 3]
    x0_q: Any  # [W+1, 4]
    x0_v: Any  # [W+1, 3]
    x0_ba: Any  # [W+1, 3]
    x0_bg: Any  # [W+1, 3]
    x0_tic: Any  # [3]
    x0_qic: Any  # [4]
    x0_td: Any  # []
    valid: Any  # [] bool — False until the first marginalization

    @staticmethod
    def empty(dtype=jnp.float32, n_frames: int = NFRAMES, n_cams: int = 1):
        D = pose_dim(n_frames, n_cams)
        s = WindowState.zeros(1, dtype, n_frames, n_cams)
        return PriorFactor(
            J=jnp.zeros((D, D), dtype),
            r0=jnp.zeros((D,), dtype),
            x0_p=s.p, x0_q=s.q, x0_v=s.v, x0_ba=s.ba, x0_bg=s.bg,
            x0_tic=s.tic, x0_qic=s.qic, x0_td=s.td,
            valid=jnp.zeros((), bool),
        )

    @staticmethod
    def from_state(J, r0, state: WindowState, dtype=None):
        return PriorFactor(
            J=J, r0=r0,
            x0_p=state.p, x0_q=state.q, x0_v=state.v,
            x0_ba=state.ba, x0_bg=state.bg,
            x0_tic=state.tic, x0_qic=state.qic, x0_td=state.td,
            valid=jnp.ones((), bool),
        )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable; safe as a jit static arg)."""

    max_iterations: int = 8  # reference max_num_iterations
    focal_length: float = 160.0  # virtual focal (parameters.h:11)
    estimate_td: bool = True
    estimate_extrinsic: bool = True
    # Cameras in the rig (dual-PAL up+down = 2). Static: sets the extrinsic
    # block count in the local layout (D = 15*(W+1) + 6*n_cams + 1).
    n_cams: int = 1
    cauchy_c: float = 1.0  # CauchyLoss(1.0) (estimator.cpp:681)
    init_lambda: float = 1e-4
    min_inv_depth: float = 1e-3  # clamp; reference resets negative depths
    # Relative cost-plateau threshold for LM early exit (Ceres
    # function_tolerance analogue). Accepted steps improving the cost by
    # less than this fraction stop the iteration; remaining scan slots
    # become ~free no-ops (lax.cond). 0.0 disables.
    cost_tol: float = 1e-6

    @property
    def proj_sqrt_info(self) -> float:
        # sqrt_info = FOCAL_LENGTH / 1.5 * I2 (estimator.cpp:18)
        return self.focal_length / 1.5
