"""Sliding-window VIO estimator driver.

Host orchestration equivalent of the reference Estimator
(/root/reference/vins_estimator/src/estimator.cpp): INITIAL → NON_LINEAR
state machine, measurement handling, initialization, per-frame solve,
failure detection, marginalization, and window sliding.

Division of labor:
  * Device (jit, solver dtype, default device): preintegration of all
    window intervals, triangulation, the 8-iteration LM bundle adjustment
    and yaw-gauge fix (one solve program), then the QR square-root
    marginalization (a second program, ``_marg_old`` / ``_marg_new``).
  * Host CPU (numpy f64): policy (keyframe flag, init decisions, failure
    reset), feature bookkeeping and the window slide.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import geom
from ..geom import host as hg
from ..imu import ImuNoise, preintegrate_parallel, whiten_covariance
from ..backend import (
    WindowState,
    FeatureGrid,
    PriorFactor,
    SolverConfig,
    lm_solve,
    yaw_gauge_fix,
)
from ..backend.state import WINDOW  # default window length only
from ..backend.triangulate import triangulate_grid
from ..backend.marginalize import marginalize_old_qr, marginalize_second_new_qr
from ..vinit import solve_relative_rt, global_sfm, visual_imu_alignment
from ..vinit.alignment import AlignFrame
from .feature_manager import HostFeatureManager


@dataclasses.dataclass
class EstimatorConfig:
    n_feature_slots: int = 256
    # Sliding-window keyframes (reference WINDOW_SIZE, parameters.h:12 —
    # compile-time there, a config here; BASELINE config #4 runs 20).
    # Every downstream shape (solver layout, grids, priors, IMU buffers)
    # derives from this.
    window: int = WINDOW
    # Cameras in the rig (dual-PAL up+down = 2). tic/ric may be per-camera
    # arrays ([C,3] / [C,3,3]) when n_cams > 1.
    n_cams: int = 1
    max_imu_per_interval: int = 256
    min_parallax: float = 10.0 / 160.0  # keyframe_parallax / FOCAL_LENGTH
    imu_noise: ImuNoise = dataclasses.field(
        default_factory=lambda: ImuNoise(0.02, 0.01, 0.04, 0.001)
    )
    g_norm: float = 9.81
    estimate_td: bool = False
    estimate_extrinsic: bool = False
    # ESTIMATE_EXTRINSIC=2 flow (estimator.cpp:126-142): start with NO
    # extrinsic rotation knowledge; hand-eye calibrate online during INITIAL.
    calib_extrinsic_rotation: bool = False
    # Rolling shutter (projection_td_factor.cpp:21-22,53-56): per-observation
    # td_obs = td_meas - TR/ROW * (row - ROW/2). TR = 0 → global shutter.
    rolling_shutter_tr: float = 0.0
    image_rows: int = 480
    td0: float = 0.0
    tic: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    ric: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    max_iterations: int = 8
    # Reference wall-clock budget per solve (estimator.cpp:810-825):
    # max_solver_time seconds, ×0.8 when marginalizing old. 0 = unlimited.
    # Enforced as a DYNAMIC iteration cap (budget / measured per-iteration
    # device time, see calibrate_solver_budget) passed to the jitted solve —
    # no recompile, the capped iterations become lax.cond no-ops.
    max_solver_time: float = 0.0
    # Frames a solve result may lag before its values are integrated
    # (1 = classic: finalize before the next dispatch; 2 = deep pipeline:
    # the window slides EAGERLY at dispatch with propagated values and the
    # solved values are rebased through the slides when they arrive — the
    # device->host fetch leaves the critical path). Estimates start from one-solve-stale states at
    # lag 2; LM re-converges, accuracy validated by the e2e suite.
    solve_lag: int = 1
    # Device-resident estimator state chain (active when solve_lag > 1):
    # solve k+1's window states are computed ON DEVICE from solve k's
    # SOLVED output (slide + IMU propagation of the new frame) instead of
    # the host's stale propagated mirrors — the lag-N pipeline then starts
    # every LM from lag-1-quality states; the host mirrors remain the
    # policy/output path.
    device_chain: bool = True
    solver_dtype: object = jnp.float32


class Estimator:
    INITIAL, NON_LINEAR = 0, 1

    def __init__(self, cfg: EstimatorConfig):
        self.cfg = cfg
        # Window geometry (instance-level so one process can run several
        # estimators with different window lengths side by side).
        self.WIN = int(cfg.window)
        self.NF = self.WIN + 1
        # Optional device→host fetch submitter (tree -> future), installed
        # by VioPipeline's _FetchPool: solve-result fetches then start on a
        # worker thread at dispatch instead of a blocking device_get at
        # finalize.
        self.fetch_submit = None
        self.scfg = SolverConfig(
            max_iterations=cfg.max_iterations,
            estimate_td=cfg.estimate_td,
            estimate_extrinsic=cfg.estimate_extrinsic,
            n_cams=cfg.n_cams,
        )
        self.clear_state()

        dt = cfg.solver_dtype
        self.gravity = None  # set after init (g in world frame = [0,0,g_norm])

        # Jitted device functions: TWO async dispatches per frame — the
        # solve program (preintegration, whitening, triangulation, LM,
        # yaw-gauge fix) and the marginalization program (QR square-root
        # prior, two variants). They are kept apart because XLA's compile
        # time grows superlinearly when the linearization code is
        # instantiated twice in one program; the split costs one extra async
        # dispatch and nothing else — the prior never leaves the device.
        #
        # ALL host inputs ride ONE packed solver-dtype buffer per frame: one
        # host→device upload instead of ~22, unpacked inside the jitted
        # program (XLA fuses the slices). Whether this pays on a local card
        # is open (ROADMAP D3).
        self._solve_step = jax.jit(self._solve_step_impl)
        self._solve_packed = jax.jit(self._solve_packed_impl)
        self._solve_relo_packed = jax.jit(self._solve_relo_packed_impl)
        self._marg_old = jax.jit(self._marg_old_impl)
        self._marg_new = jax.jit(self._marg_new_impl)
        self._triangulate = jax.jit(triangulate_grid)
        self._pack_layout, self._pack_size = self._build_pack_layout()
        self._empty_prior_cache = None
        # Device-resident state chain: refs of the previous solve's SOLVED
        # window (p,q,v,ba,bg,tic,qic,td) + the marg kind of the eager
        # slide that followed it. None = next solve seeds from host state.
        self._chain = None
        self._zero_chain_cache = None

    # ------------------------------------------------------------------ state
    def clear_state(self):
        cfg = self.cfg
        W1 = self.NF
        self.Ps = np.zeros((W1, 3))
        self.Qs = np.tile(np.array([1.0, 0, 0, 0]), (W1, 1))
        self.Vs = np.zeros((W1, 3))
        self.Bas = np.zeros((W1, 3))
        self.Bgs = np.zeros((W1, 3))
        tic_in = np.asarray(cfg.tic, np.float64)
        ric_in = np.asarray(cfg.ric, np.float64)
        if cfg.n_cams > 1:
            # Canonical per-camera shapes; broadcast a single extrinsic.
            if tic_in.ndim == 1:
                tic_in = np.tile(tic_in, (cfg.n_cams, 1))
            if ric_in.ndim == 2:
                ric_in = np.tile(ric_in, (cfg.n_cams, 1, 1))
            self.tic = tic_in.copy()
            self.qic = np.stack([hg.mat_to_quat(R) for R in ric_in])
        else:
            self.tic = tic_in.copy()
            self.qic = hg.mat_to_quat(ric_in)
        self.td = cfg.td0
        self.frame_count = 0
        self.solver_flag = self.INITIAL
        self.first_imu = False
        self.acc_0 = np.zeros(3)
        self.gyr_0 = np.zeros(3)
        # Per window interval IMU buffers: list of (dt, acc, gyr) lists
        # (cold path: init-time preintegration) plus persistent padded
        # arrays mirroring them (hot path: rebuilt-free device upload).
        self.imu_buf = [[] for _ in range(W1)]
        M = cfg.max_imu_per_interval
        self._imu_dts = np.zeros((W1, M))
        self._imu_accs = np.zeros((W1, M, 3))
        self._imu_gyrs = np.zeros((W1, M, 3))
        self._imu_n = np.zeros(W1, np.int64)
        self._imu_sumdt = np.zeros(W1)
        self._imu_a0 = np.zeros((W1, 3))
        self._imu_g0 = np.zeros((W1, 3))
        self.tmp_imu_buf = []  # since last frame (for all_image_frame)
        self.fm = HostFeatureManager(cfg.n_feature_slots, W1)
        self.all_frames = []  # list of dicts (t, feats, imu, R, T, is_key)
        self.prior = None
        self.headers = np.zeros(W1)
        self.times = []
        self.traj_p = []
        self.traj_q = []
        self.failure_occur = False
        self.last_P = np.zeros(3)
        self.last_R = np.eye(3)
        self.last_P0 = np.zeros(3)
        self.last_R0 = np.eye(3)
        self.initial_timestamp = -1e18
        # Online extrinsic-rotation calibration (ESTIMATE_EXTRINSIC=2).
        from ..vinit.ex_rotation import ExtrinsicRotationCalibrator

        self.ex_calib = ExtrinsicRotationCalibrator()
        self.extrinsic_calibrated = not cfg.calib_extrinsic_rotation
        # Measured per-LM-iteration device time (calibrate_solver_budget);
        # None until calibrated -> the wall budget cannot bind.
        self._iter_time = getattr(self, "_iter_time", None)
        # Deferred-solve handles, oldest first (see process_image_arrays
        # defer_solve); length bounded by cfg.solve_lag.
        self._pending_q = []
        # Restart/failure invalidates the device state chain: the next
        # solve re-seeds from the host mirrors.
        self._chain = None
        # Relocalization hooks (estimator_node.cpp:261-285).
        self.relo_relative_t = None
        self.relo_relative_q = None
        self.relo_relative_yaw = None
        self.relo_frame_stamp = None
        self._relo_active = None  # armed loop match for the next solve

    # --------------------------------------------------------------- helpers
    def _tic0(self):
        """Primary-camera extrinsic translation (host geometry paths —
        init, relo, slide re-anchoring — operate on camera 0)."""
        return self.tic if self.tic.ndim == 1 else self.tic[0]

    def _ric0(self):
        q = self.qic if self.qic.ndim == 1 else self.qic[0]
        return hg.quat_to_mat(q)

    # ------------------------------------------------------------------- IMU
    def process_imu(self, dt, acc, gyr):
        """Estimator::processIMU (estimator.cpp:86-120): buffer + midpoint
        state propagation of the newest window frame."""
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        if not self.first_imu:
            self.first_imu = True
            self.acc_0, self.gyr_0 = acc, gyr
        j = self.frame_count
        if j != 0:
            self.imu_buf[j].append((dt, acc.copy(), gyr.copy()))
            self.tmp_imu_buf.append((dt, acc.copy(), gyr.copy()))
            n = self._imu_n[j]
            if n == 0:
                # Interval start sample = the previous stream sample
                # (IntegrationBase is seeded with carried-over acc_0/gyr_0).
                self._imu_a0[j] = self.acc_0
                self._imu_g0[j] = self.gyr_0
            if n < self._imu_dts.shape[1]:
                self._imu_dts[j, n] = dt
                self._imu_accs[j, n] = acc
                self._imu_gyrs[j, n] = gyr
                self._imu_n[j] = n + 1
            self._imu_sumdt[j] += dt
            g = np.array([0.0, 0.0, self.cfg.g_norm])
            R = hg.quat_to_mat(self.Qs[j])
            un_acc_0 = R @ (self.acc_0 - self.Bas[j]) - g
            un_gyr = 0.5 * (self.gyr_0 + gyr) - self.Bgs[j]
            q_new = hg.quat_normalize(
                hg.quat_mul(self.Qs[j], hg.so3_exp(un_gyr * dt))
            )
            un_acc_1 = hg.quat_to_mat(q_new) @ (acc - self.Bas[j]) - g
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            self.Ps[j] += dt * self.Vs[j] + 0.5 * dt * dt * un_acc
            self.Vs[j] += dt * un_acc
            self.Qs[j] = q_new
        self.acc_0, self.gyr_0 = acc, gyr

    # ------------------------------------------------------------- device fns
    def _solve_step_impl(
        self, state, grid, dts, accs, gyrs, a0, g0, imu_valid_in,
        prior, has_depth, origin_p0, origin_q0, max_iter_dyn,
    ):
        """Per-frame solve program: the reference's solveOdometry +
        double2vector (estimator.cpp:475-515, 532-626) as one XLA
        computation. Returns the solved state plus the preintegration /
        whitening intermediates the marginalization program consumes."""
        from ..backend.factors import projection_residuals_grid

        cfg = self.cfg
        sd = cfg.solver_dtype
        gravity = jnp.asarray([0.0, 0.0, cfg.g_norm], sd)

        # Preintegrate all window intervals at the current start-frame biases
        # (= repropagate every frame; the functional form makes this free of
        # the reference's bias-drift bookkeeping, integration_base.h:38-52).
        pre = jax.vmap(
            lambda d, ac, gy, a_0, g_0, ba, bg: preintegrate_parallel(
                d, ac, gy, a_0, g_0, ba, bg, cfg.imu_noise
            )
        )(dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1])
        sqrt_info, imu_valid = whiten_covariance(pre.covariance, imu_valid_in)

        inv_d = triangulate_grid(state, grid, has_depth)
        state = dataclasses.replace(state, inv_depth=inv_d)
        out, c0, c1, _ = lm_solve(
            state, grid, pre, sqrt_info, imu_valid, prior, gravity, self.scfg,
            max_iter_dyn=max_iter_dyn,
        )
        out = yaw_gauge_fix(out, origin_p0, origin_q0)

        if self.GATE_THRESH < 1e8:
            # Post-solve reprojection gate (only computed & transferred when
            # actually enabled — it ships disabled, like the reference's
            # removeOutlier, so the hot path must not pay for it).
            res, rvalid = projection_residuals_grid(
                out, grid, jnp.asarray(self.scfg.proj_sqrt_info, sd)
            )
            rn = jnp.linalg.norm(res, axis=-1)
        else:
            rn = rvalid = None
        return out, pre, sqrt_info, imu_valid, rn, rvalid, c0, c1

    def _solve_step_relo_impl(
        self, state, grid, dts, accs, gyrs, a0, g0, imu_valid_in,
        prior, has_depth, origin_p0, origin_q0, max_iter_dyn,
        relo_p0, relo_q0, relo_bearing, relo_mask,
    ):
        """Relo-augmented solve program: the per-frame solve with the loop
        pose as a free block (estimator.cpp:777-808). Separate jit from the
        hot path — compiled only when a loop match is active."""
        from ..backend.relo import lm_solve_relo
        from ..backend.gauge import yaw_gauge_transform, gauge_apply_pose

        cfg = self.cfg
        sd = cfg.solver_dtype
        gravity = jnp.asarray([0.0, 0.0, cfg.g_norm], sd)
        pre = jax.vmap(
            lambda d, ac, gy, a_0, g_0, ba, bg: preintegrate_parallel(
                d, ac, gy, a_0, g_0, ba, bg, cfg.imu_noise
            )
        )(dts, accs, gyrs, a0, g0, state.ba[:-1], state.bg[:-1])
        sqrt_info, imu_valid = whiten_covariance(pre.covariance, imu_valid_in)
        inv_d = triangulate_grid(state, grid, has_depth)
        state = dataclasses.replace(state, inv_depth=inv_d)
        out, rp, rq, c0, c1 = lm_solve_relo(
            state, grid, pre, sqrt_info, imu_valid, prior, gravity,
            self.scfg, relo_p0, relo_q0, relo_bearing, relo_mask,
            max_iter_dyn=max_iter_dyn,
        )
        # The loop pose rides the same gauge correction as the window
        # (reference rotates relo_Pose in double2vector, estimator.cpp:605-611).
        rot, pivot = yaw_gauge_transform(out, origin_p0, origin_q0)
        rp, rq = gauge_apply_pose(rot, pivot, origin_p0, rp, rq)
        out = yaw_gauge_fix(out, origin_p0, origin_q0)
        return out, pre, sqrt_info, imu_valid, rp, rq, c0, c1

    def _marg_old_impl(self, out, grid, pre, sqrt_info, imu_valid, prior):
        """MARGIN_OLD program (estimator.cpp:832-948 equivalent)."""
        gravity = jnp.asarray(
            [0.0, 0.0, self.cfg.g_norm], self.cfg.solver_dtype
        )
        return marginalize_old_qr(
            out, grid, pre, sqrt_info, imu_valid, prior, gravity, self.scfg
        )

    def _marg_new_impl(self, out, prior):
        """MARGIN_SECOND_NEW program (estimator.cpp:949-1005 equivalent)."""
        return marginalize_second_new_qr(out, prior, self.scfg)

    # ----------------------------------------------------------- preint build
    def _padded_window_arrays(self):
        """Padded IMU sample arrays for the whole window — maintained
        incrementally by process_imu / the slide ops (no per-frame list
        rebuilding; was ~10 ms/frame of host time).

        Returns COPIES, not views: the solve is dispatched asynchronously
        and ``jnp.asarray`` of a same-dtype numpy array may alias it
        (zero-copy on CPU; read while the transfer is in flight elsewhere), so
        handing out the live buffers that the slide ops mutate in place is
        a read/write race — observed as rare nondeterministic solves on the
        f64 CPU test mesh."""
        valid = (self._imu_n[1:] > 0) & (self._imu_sumdt[1:] < 10.0)
        return (
            self._imu_dts[1:].copy(), self._imu_accs[1:].copy(),
            self._imu_gyrs[1:].copy(),
            self._imu_a0[1:].copy(), self._imu_g0[1:].copy(), valid,
        )

    # ---------------------------------------------------------------- helpers
    def _device_state(self, dtype=None):
        # .copy() on every live host mirror: the dispatch is async and
        # jnp.asarray may alias/borrow the buffer (see _padded_window_arrays).
        sd = dtype or self.cfg.solver_dtype
        inv_depth = np.where(
            self.fm.depth > 0, 1.0 / np.maximum(self.fm.depth, 1e-6), 1.0
        )
        return WindowState(
            p=jnp.asarray(self.Ps.copy(), sd),
            q=jnp.asarray(self.Qs.copy(), sd),
            v=jnp.asarray(self.Vs.copy(), sd),
            ba=jnp.asarray(self.Bas.copy(), sd),
            bg=jnp.asarray(self.Bgs.copy(), sd),
            tic=jnp.asarray(self.tic.copy(), sd),
            qic=jnp.asarray(self.qic.copy(), sd),
            td=jnp.asarray(self.td, sd),
            inv_depth=jnp.asarray(inv_depth, sd),
        )

    def _device_grid(self, dtype=None):
        sd = dtype or self.cfg.solver_dtype
        b, v, tdo, val, anc, used, cam = self.fm.device_grid_arrays()
        return FeatureGrid(
            bearing=jnp.asarray(b.copy(), sd),
            velocity=jnp.asarray(v.copy(), sd),
            td_obs=jnp.asarray(tdo.copy(), sd),
            valid=jnp.asarray(val.copy()),
            anchor=jnp.asarray(anc.copy()),
            used=jnp.asarray(used),
            # Mono rigs keep cam=None: identical pytree structure (and jit
            # cache keys) as before the multi-camera extension.
            cam=jnp.asarray(cam.copy()) if self.cfg.n_cams > 1 else None,
        )

    def _empty_prior(self, dtype=None):
        if dtype is None or dtype == self.cfg.solver_dtype:
            if self._empty_prior_cache is None:
                self._empty_prior_cache = PriorFactor.empty(
                    dtype=self.cfg.solver_dtype, n_frames=self.NF,
                    n_cams=self.cfg.n_cams,
                )
            return self._empty_prior_cache
        return PriorFactor.empty(
            dtype=dtype, n_frames=self.NF, n_cams=self.cfg.n_cams
        )

    # ------------------------------------------------------------ packed args
    def _build_pack_layout(self):
        """Static layout of the ONE per-frame host→device buffer: every
        solve input (window state, feature grid, padded IMU window, gauge
        origin, dynamic iteration cap, relo extras) flattened into a single
        solver-dtype vector. One upload per dispatch instead of ~22 (saves
        ~20 transfer setups/frame). Bools ride as 0/1, int indices as exact
        small floats."""
        cfg = self.cfg
        F, W1, W, M, C = (
            cfg.n_feature_slots, self.NF, self.WIN,
            cfg.max_imu_per_interval, cfg.n_cams,
        )
        entries = [
            ("p", (W1, 3)), ("q", (W1, 4)), ("v", (W1, 3)),
            ("ba", (W1, 3)), ("bg", (W1, 3)),
            ("tic", (C, 3) if C > 1 else (3,)),
            ("qic", (C, 4) if C > 1 else (4,)),
            ("td", ()), ("inv_depth", (F,)),
            ("g_bearing", (F, W1, 3)), ("g_velocity", (F, W1, 3)),
            ("g_td_obs", (F, W1)), ("g_valid", (F, W1)),
            ("g_anchor", (F,)), ("g_used", (F,)),
            ("g_cam", (F, W1) if C > 1 else (0,)),
            ("dts", (W, M)), ("accs", (W, M, 3)), ("gyrs", (W, M, 3)),
            ("a0", (W, 3)), ("g0", (W, 3)), ("imu_valid", (W,)),
            ("has_depth", (F,)), ("origin_p0", (3,)), ("origin_q0", (4,)),
            ("max_iter", ()),
            # Device state chain controls: use_chain selects the advanced
            # previous-solve state over the packed host state; marg_prev is
            # the kind of the eager slide that followed that solve.
            ("use_chain", ()), ("marg_prev", ()),
            ("relo_p", (3,)), ("relo_q", (4,)),
            ("relo_bearing", (F, 3)), ("relo_mask", (F,)),
        ]
        layout, off = {}, 0
        for name, shape in entries:
            n = int(np.prod(shape)) if shape else 1
            layout[name] = (off, shape)
            off += n
        return layout, off

    def _pack_solve_buffer(self, origin_p0, origin_q0, relo=None,
                           chain_flags=None):
        """Fill a FRESH packed buffer from the host mirrors (fresh each
        dispatch: the upload is async and may borrow the numpy memory —
        same aliasing rule as _padded_window_arrays)."""
        cfg = self.cfg
        np_dt = np.dtype(jnp.dtype(cfg.solver_dtype).name)
        buf = np.zeros(self._pack_size, np_dt)
        L = self._pack_layout

        def put(name, val):
            off, shape = L[name]
            n = int(np.prod(shape)) if shape else 1
            buf[off : off + n] = np.asarray(val, np_dt).ravel()

        fm = self.fm
        put("p", self.Ps)
        put("q", self.Qs)
        put("v", self.Vs)
        put("ba", self.Bas)
        put("bg", self.Bgs)
        put("tic", self.tic)
        put("qic", self.qic)
        put("td", self.td)
        put("inv_depth", np.where(
            fm.depth > 0, 1.0 / np.maximum(fm.depth, 1e-6), 1.0
        ))
        put("g_bearing", fm.bearing)
        put("g_velocity", fm.velocity)
        put("g_td_obs", fm.td_obs)
        put("g_valid", fm.valid)
        put("g_anchor", fm.anchor)
        put("g_used", fm.used_mask())
        if cfg.n_cams > 1:
            put("g_cam", fm.cam)
        put("dts", self._imu_dts[1:])
        put("accs", self._imu_accs[1:])
        put("gyrs", self._imu_gyrs[1:])
        put("a0", self._imu_a0[1:])
        put("g0", self._imu_g0[1:])
        put("imu_valid", (self._imu_n[1:] > 0) & (self._imu_sumdt[1:] < 10.0))
        put("has_depth", fm.depth > 0)
        put("origin_p0", origin_p0)
        put("origin_q0", origin_q0)
        put("max_iter", self._iterations_allowed())
        if chain_flags is not None:
            put("use_chain", 1.0 if chain_flags[0] else 0.0)
            put("marg_prev", 1.0 if chain_flags[1] else 0.0)
        if relo is not None:
            put("relo_p", relo["p"])
            put("relo_q", relo["q"])
            put("relo_bearing", relo["bearing"])
            put("relo_mask", relo["mask"])
        return buf

    def _unpack(self, packed):
        """Traced unpack of the packed buffer (static slices — XLA fuses
        these into the consumers for free)."""
        cfg = self.cfg
        L = self._pack_layout

        def get(name):
            off, shape = L[name]
            n = int(np.prod(shape)) if shape else 1
            v = packed[off : off + n]
            return v.reshape(shape) if shape else v[0]

        state = WindowState(
            p=get("p"), q=get("q"), v=get("v"), ba=get("ba"), bg=get("bg"),
            tic=get("tic"), qic=get("qic"), td=get("td"),
            inv_depth=get("inv_depth"),
        )
        grid = FeatureGrid(
            bearing=get("g_bearing"), velocity=get("g_velocity"),
            td_obs=get("g_td_obs"), valid=get("g_valid") > 0.5,
            anchor=get("g_anchor").astype(jnp.int32),
            used=get("g_used") > 0.5,
            cam=get("g_cam").astype(jnp.int32) if cfg.n_cams > 1 else None,
        )
        imu = (get("dts"), get("accs"), get("gyrs"), get("a0"), get("g0"),
               get("imu_valid") > 0.5)
        misc = (get("has_depth") > 0.5, get("origin_p0"), get("origin_q0"),
                get("max_iter").astype(jnp.int32))
        relo = (get("relo_p"), get("relo_q"), get("relo_bearing"),
                get("relo_mask") > 0.5)
        return state, grid, imu, misc, relo

    def _zero_chain(self):
        """Shape/dtype-stable dummy chain state (identity rotations so the
        unused chained branch stays finite)."""
        if self._zero_chain_cache is None:
            sd = self.cfg.solver_dtype
            W1, C = self.NF, self.cfg.n_cams
            unit_q = jnp.asarray([1.0, 0, 0, 0], sd)
            z3 = jnp.zeros((W1, 3), sd)
            self._zero_chain_cache = (
                z3, jnp.tile(unit_q, (W1, 1)), z3, z3, z3,
                jnp.zeros((3,), sd) if C == 1 else jnp.zeros((C, 3), sd),
                unit_q if C == 1 else jnp.tile(unit_q, (C, 1)),
                jnp.zeros((), sd),
            )
        return self._zero_chain_cache

    def _apply_chain(self, state, packed, chain, dts, accs, gyrs, a0, g0):
        """Device-resident estimator chain: when `use_chain` is set in the
        packed buffer, replace the packed (host-mirror) window states with
        the ADVANCE of the previous solve's device output — apply the
        eager slide that followed it (shift for MARGIN_OLD, newest-merge
        for SECOND_NEW) and midpoint-propagate the new frame's state over
        the newest interval's IMU samples (packed row W−1 holds exactly
        the samples since the previous dispatch in BOTH slide kinds — the
        SECOND_NEW interval merge lands in row W−2). The lag-N pipeline's
        LM then starts from lag-1-quality states; the host mirrors stay
        the policy/output path. Returns (state, origin_p0, origin_q0)."""
        from .. import geom as g

        L = self._pack_layout
        dtype = state.p.dtype
        use = packed[L["use_chain"][0]] > 0.5
        m_prev = packed[L["marg_prev"][0]] > 0.5
        cp, cq, cv, cba, cbg, ctic, cqic, ctd = chain
        W = self.WIN

        def shift(a):
            so = jnp.concatenate([a[1:], a[-1:]], axis=0)
            sn = a.at[W - 1].set(a[W])
            return jnp.where(m_prev, so, sn)

        p2, q2, v2, ba2, bg2 = (shift(x) for x in (cp, cq, cv, cba, cbg))

        # Propagate the new frame (slot W) from the previous newest frame
        # (post-slide slot W still holds it) over the newest interval.
        ba_W = ba2[W]
        bg_W = bg2[W]
        g_vec = jnp.asarray([0.0, 0.0, self.cfg.g_norm], dtype)

        def body(carry, s):
            P, Q, V, a_prev, g_prev = carry
            dt, acc, gyr = s
            un_acc_0 = g.quat_to_mat(Q) @ (a_prev - ba_W) - g_vec
            un_gyr = 0.5 * (g_prev + gyr) - bg_W
            Q2 = g.quat_mul(Q, g.so3_exp(un_gyr * dt))
            Q2 = Q2 / jnp.linalg.norm(Q2)
            un_acc_1 = g.quat_to_mat(Q2) @ (acc - ba_W) - g_vec
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            P2 = P + dt * V + 0.5 * dt * dt * un_acc
            V2 = V + dt * un_acc
            return (P2, Q2, V2, acc, gyr), None

        # Zero-padded sample rows are exact no-ops (dt = 0).
        (P_end, Q_end, V_end, _, _), _ = jax.lax.scan(
            body,
            (p2[W], q2[W], v2[W], a0[W - 1], g0[W - 1]),
            (dts[W - 1], accs[W - 1], gyrs[W - 1]),
        )
        p2 = p2.at[W].set(P_end)
        q2 = q2.at[W].set(Q_end)
        v2 = v2.at[W].set(V_end)

        chained = WindowState(
            p=p2, q=q2, v=v2, ba=ba2, bg=bg2,
            tic=ctic, qic=cqic, td=ctd, inv_depth=state.inv_depth,
        )
        sel = lambda a, b: jnp.where(use, a, b)
        state_out = WindowState(
            p=sel(chained.p, state.p), q=sel(chained.q, state.q),
            v=sel(chained.v, state.v), ba=sel(chained.ba, state.ba),
            bg=sel(chained.bg, state.bg), tic=sel(chained.tic, state.tic),
            qic=sel(chained.qic, state.qic), td=sel(chained.td, state.td),
            inv_depth=state.inv_depth,
        )
        return state_out, chained.p[0], chained.q[0], use

    def _solve_packed_impl(self, packed, prior, chain):
        state, grid, imu, misc, _ = self._unpack(packed)
        has_depth, op0, oq0, mi = misc
        state, cp0, cq0, use = self._apply_chain(state, packed, chain, *imu[:5])
        # Gauge origin: pre-solve frame 0 of whichever state seeds the LM.
        op0 = jnp.where(use, cp0, op0)
        oq0 = jnp.where(use, cq0, oq0)
        out = self._solve_step_impl(
            state, grid, *imu, prior, has_depth, op0, oq0, mi
        )
        # Re-emit the device grid for the marginalization program (device→
        # device; no host traffic).
        return out, grid

    def _solve_relo_packed_impl(self, packed, prior):
        state, grid, imu, misc, relo = self._unpack(packed)
        has_depth, op0, oq0, mi = misc
        relo_p0, relo_q0, relo_bearing, relo_mask = relo
        out = self._solve_step_relo_impl(
            state, grid, *imu, prior, has_depth, op0, oq0, mi,
            relo_p0, relo_q0, relo_bearing, relo_mask,
        )
        return out, grid

    # ------------------------------------------------------------------ frame
    def process_image_arrays(
        self, ids, bearings, vels, rows, mask, t: float, defer_solve=False,
        td_pair=None, cams=None,
    ):
        """Estimator::processImage (estimator.cpp:122-220), array interface.

        ids/bearings/vels/rows: per-slot arrays from FrontEnd.process_arrays;
        mask selects the published observations.

        defer_solve=True dispatches the frame's device programs but leaves
        the host-side completion (write-back, failure check, window slide,
        trajectory record) pending until :meth:`finalize_solve` — the
        pipeline finalizes at the NEXT frame so the solve's device→host
        synchronization is shared with the tracker's (one wait per frame
        instead of two).
        No estimator state may be mutated between dispatch and finalize —
        the pipeline queues incoming IMU samples for replay.
        """
        cfg = self.cfg
        sel = np.where(np.asarray(mask))[0]
        ids_s = np.asarray(ids)[sel]
        b_s = np.asarray(bearings)[sel]
        v_s = np.asarray(vels)[sel]
        # td_obs per observation: td at measurement time minus the rolling-
        # shutter row term (projection_td_factor.cpp:21-22,53-56:
        # correction = (td - td_i + TR/ROW*(row - ROW/2)) * vel).
        # td_obs must record the td actually used for IMU pairing (the
        # pipeline pairs before finalize_solve may update self.td); falling
        # back to self.td covers direct callers without a pipeline.
        td_rec = self.td if td_pair is None else td_pair
        tr = cfg.rolling_shutter_tr
        if tr != 0.0:
            rows_s = np.asarray(rows, np.float64)[sel]
            tds = td_rec - (tr / cfg.image_rows) * (
                rows_s - cfg.image_rows / 2.0
            )
        else:
            tds = np.full(len(sel), td_rec)
        cams_s = None if cams is None else np.asarray(cams, np.int32)[sel]
        is_keyframe = self.fm.add_frame_arrays(
            self.frame_count, ids_s, b_s, v_s, tds, cfg.min_parallax,
            cams=cams_s,
        )
        self.marg_old = is_keyframe  # True -> MARGIN_OLD

        # Online extrinsic-rotation calibration during INITIAL
        # (estimator.cpp:126-142): hand-eye on frame-pair rotations until the
        # calibrator's excitation gate passes, then trust + refine in BA.
        if (
            not self.extrinsic_calibrated
            and self.frame_count != 0
            and self.solver_flag == self.INITIAL
        ):
            b1, b2, _ = self.fm.corresponding(
                self.frame_count - 1, self.frame_count
            )
            if len(b1) >= 9:
                pre = self._np_preint(self.imu_buf[self.frame_count])
                if pre is not None:
                    done, ric = self.ex_calib.add_pair(b1, b2, pre.delta_q)
                    if done:
                        if self.qic.ndim == 2:
                            self.qic[0] = hg.mat_to_quat(ric)
                        else:
                            self.qic = hg.mat_to_quat(ric)
                        self.extrinsic_calibrated = True

        self.headers[self.frame_count] = t
        if self.solver_flag == self.INITIAL:
            # all_frames feeds the one-shot SfM/alignment bootstrap only.
            self.all_frames.append(
                dict(t=t, feats={int(f): b for f, b in zip(ids_s, b_s)},
                     imu=list(self.tmp_imu_buf), is_key=False,
                     imu_start=(self.tmp_start[0].copy(), self.tmp_start[1].copy())
                     if getattr(self, "tmp_start", None) is not None
                     else None)
            )
        else:
            self.all_frames = []
        self.tmp_imu_buf = []
        self.tmp_start = (self.acc_0.copy(), self.gyr_0.copy())

        if self.solver_flag == self.INITIAL:
            if self.frame_count == self.WIN:
                ok = False
                # The bootstrap needs a trusted extrinsic rotation
                # (estimator.cpp:152: init waits while ESTIMATE_EXTRINSIC==2).
                if (
                    self.extrinsic_calibrated
                    and t - self.initial_timestamp > 0.1
                ):
                    ok = self._initial_structure()
                    self.initial_timestamp = t
                if ok:
                    self.solver_flag = self.NON_LINEAR
                    self._dispatch_solve(t, first=True)
                    if not defer_solve:
                        while self._pending_q:
                            self.finalize_solve()
                else:
                    self._slide_window()
            else:
                self.frame_count += 1
                # New frame starts where the previous one is.
                j = self.frame_count
                self.Ps[j] = self.Ps[j - 1]
                self.Qs[j] = self.Qs[j - 1]
                self.Vs[j] = self.Vs[j - 1]
                self.Bas[j] = self.Bas[j - 1]
                self.Bgs[j] = self.Bgs[j - 1]
        else:
            self._dispatch_solve(t, first=False)
            if not defer_solve:
                while self._pending_q:
                    self.finalize_solve()

    def process_image(self, feats: dict, t: float):
        """Dict-interface wrapper: feats id -> (bearing3, vel3, row)."""
        n = len(feats)
        ids = np.fromiter(feats.keys(), np.int64, count=n)
        bearings = (
            np.stack([np.asarray(v[0]) for v in feats.values()])
            if n else np.zeros((0, 3))
        )
        vels = (
            np.stack([np.asarray(v[1]) for v in feats.values()])
            if n else np.zeros((0, 3))
        )
        rows = np.asarray([v[2] for v in feats.values()])
        return self.process_image_arrays(
            ids, bearings, vels, rows, np.ones(n, bool), t
        )

    def _record_output(self, t):
        self.times.append(t)
        self.traj_p.append(self.Ps[self.WIN].copy())
        self.traj_q.append(self.Qs[self.WIN].copy())

    # ------------------------------------------------------------------ relo
    def set_relo_frame(
        self, frame_stamp, match_ids, match_bearings, prev_relo_p, prev_relo_q
    ):
        """Relocalization hook — the estimator side of a loop closure
        (reference setReloFrame, estimator.cpp:1133-1152, fed from
        estimator_node.cpp:261-285; the relo residuals live in
        optimization(), estimator.cpp:777-808, and the drift outputs in
        double2vector, estimator.cpp:605-624).

        Args: `frame_stamp` must match a window keyframe header;
        `match_ids`/`match_bearings` are the loop frame's matched feature
        ids and unit bearings (old camera frame); (`prev_relo_p`,
        `prev_relo_q`) is the loop frame's pose in the pose-graph world.

        Design: a bearing-space PnP of the loop frame against the
        window's triangulated landmarks seeds the loop pose immediately
        (this method's outputs), and the NEXT frame's solve runs the
        relo-augmented program (backend/relo.py): the loop pose joins the BA
        as a free 6-dim block with one relo projection row per matched
        feature, exactly the reference's joint refinement — the refined
        relative outputs land at that solve's finalize. The augmented
        program is a separate jit, so the ordinary hot path never pays.

        Returns True when a drift estimate was produced.
        """
        from ..vinit.pnp import pnp_bearing_gn

        idx = None
        for i in range(self.WIN):
            if abs(self.headers[i] - frame_stamp) < 1e-7:
                idx = i
        if idx is None or self.solver_flag != self.NON_LINEAR:
            return False

        ric = self._ric0()
        tic0 = self._tic0()
        pw, bb = [], []
        relo_bearing = np.zeros((self.cfg.n_feature_slots, 3))
        relo_mask = np.zeros(self.cfg.n_feature_slots, bool)
        match_bearings = np.asarray(match_bearings, np.float64)
        for fid, b_old in zip(np.asarray(match_ids, np.int64), match_bearings):
            s = self.fm._id2slot.get(int(fid), -1)
            if s < 0 or self.fm.depth[s] <= 0:
                continue
            a = int(self.fm.anchor[s])
            Ra = hg.quat_to_mat(self.Qs[a])
            p_cam = self.fm.bearing[s, a] * self.fm.depth[s]
            p_w = Ra @ (ric @ p_cam + tic0) + self.Ps[a]
            pw.append(p_w)
            b_u = b_old / max(np.linalg.norm(b_old), 1e-12)
            bb.append(b_u)
            relo_bearing[s] = b_u
            relo_mask[s] = True
        if len(pw) < 6:
            return False
        pw = np.stack(pw)
        bb = np.stack(bb)

        # Seed from the matched window frame (reference seeds relo_Pose with
        # para_Pose[i]); solve the loop frame's camera pose in the VIO world.
        R_wi = hg.quat_to_mat(self.Qs[idx])
        R_wc0 = R_wi @ ric
        t_wc0 = self.Ps[idx] + R_wi @ tic0
        R_cw, t_cw, ok = pnp_bearing_gn(pw, bb, R_wc0.T, -R_wc0.T @ t_wc0)
        if not ok:
            return False
        R_wc = R_cw.T
        P_wc = -R_wc @ t_cw
        relo_r = R_wc @ ric.T  # loop frame IMU pose in VIO world
        relo_t = P_wc - relo_r @ tic0

        def norm_deg(a):
            return (a + 180.0) % 360.0 - 180.0

        R_idx = hg.quat_to_mat(self.Qs[idx])
        self.relo_relative_t = relo_r.T @ (self.Ps[idx] - relo_t)
        self.relo_relative_q = hg.mat_to_quat(relo_r.T @ R_idx)
        self.relo_relative_yaw = norm_deg(
            float(hg.R_to_ypr_deg(R_idx)[0]) - float(hg.R_to_ypr_deg(relo_r)[0])
        )
        self.relo_frame_stamp = frame_stamp
        # Drift correction for the visualization/path output
        # (estimator.cpp:613-617).
        prev_relo_r = hg.quat_to_mat(np.asarray(prev_relo_q, np.float64))
        dy = norm_deg(
            float(hg.R_to_ypr_deg(prev_relo_r)[0])
            - float(hg.R_to_ypr_deg(relo_r)[0])
        )
        self.drift_correct_r = hg.ypr_deg_to_R([dy, 0.0, 0.0])
        self.drift_correct_t = (
            np.asarray(prev_relo_p, np.float64) - self.drift_correct_r @ relo_t
        )
        # Arm the relo-augmented solve for the next frame: the loop pose is
        # refined JOINTLY with the window (estimator.cpp:777-808), seeded
        # with the PnP result; one-shot like the reference
        # (relocalization_info is cleared in double2vector).
        self._relo_active = dict(
            bearing=relo_bearing, mask=relo_mask,
            p=relo_t.copy(), q=hg.mat_to_quat(relo_r),
            stamp=float(frame_stamp),
            prev_p=np.asarray(prev_relo_p, np.float64).copy(),
            prev_q=np.asarray(prev_relo_q, np.float64).copy(),
            # Feature-identity snapshot: _dispatch_solve re-checks that each
            # masked slot still holds the SAME feature before building the
            # relo rows (slots can be freed + refilled in between).
            snap_ids=self.fm.feature_id.copy(),
        )
        return True

    # ----------------------------------------------------------------- solve
    def _iterations_allowed(self) -> int:
        """Dynamic LM iteration cap implementing the reference's real-time
        wall budget (estimator.cpp:810-825): max_solver_time seconds per
        solve, ×0.8 when marginalizing old. Needs a measured per-iteration
        device time (calibrate_solver_budget); uncalibrated or budget<=0 →
        the static cap."""
        cfg = self.cfg
        if cfg.max_solver_time <= 0 or not self._iter_time:
            return cfg.max_iterations
        budget = cfg.max_solver_time * (0.8 if self.marg_old else 1.0)
        return int(np.clip(budget / self._iter_time, 1, cfg.max_iterations))

    def calibrate_solver_budget(self, n=4):
        """Measure the solve program's per-LM-iteration device time so
        max_solver_time can bind. Runs the PACKED solve program (already
        compiled by the hot path) at max_iter 1 vs max_iterations and takes
        the difference — dispatch/fixed overhead cancels. Each run perturbs
        the window positions so the iterations do real work (a converged
        window's iterations are cost-tol no-ops and would underestimate the
        per-iteration time severalfold). Read-only: safe to call with
        solves in flight; costs ~2(n+1) solve executions."""
        import time as _time

        if self.frame_count < self.WIN or self.solver_flag != self.NON_LINEAR:
            return None
        packed = self._pack_solve_buffer(self.Ps[0], self.Qs[0])
        prior = self.prior if self.prior is not None else self._empty_prior()
        L = self._pack_layout
        off_mi = L["max_iter"][0]
        off_p, shape_p = L["p"]
        n_p = int(np.prod(shape_p))

        def run(max_iter, seed):
            b = packed.copy()
            b[off_mi] = max_iter
            rng = np.random.default_rng(seed)
            b[off_p : off_p + n_p] += rng.normal(0.0, 0.05, n_p)
            return self._solve_packed(jnp.asarray(b), prior,
                                      self._zero_chain())

        for mi in (1, self.cfg.max_iterations):  # ensure compiled + warm
            out = run(mi, 0)
        jax.block_until_ready(out[0][0].p)
        t0 = _time.perf_counter()
        for i in range(n):
            o1 = run(1, 1 + i)
        jax.block_until_ready(o1[0][0].p)
        t1 = _time.perf_counter()
        for i in range(n):
            o2 = run(self.cfg.max_iterations, 1 + i)
        jax.block_until_ready(o2[0][0].p)
        t2 = _time.perf_counter()
        iters = max(self.cfg.max_iterations - 1, 1)
        self._iter_time = max(((t2 - t1) - (t1 - t0)) / (n * iters), 1e-7)
        return self._iter_time

    def _dispatch_solve(self, t: float, first: bool = False):
        """Launch the frame's solve + marginalization device programs without
        synchronizing; completion state goes to ``self._pending`` for
        :meth:`finalize_solve`."""
        if self.frame_count < self.WIN:
            return
        while len(self._pending_q) >= max(self.cfg.solve_lag, 1):
            self.finalize_solve()  # safety net for direct (non-pipeline) use
        prior = self.prior if self.prior is not None else self._empty_prior()

        # Gauge-fix origin: pre-solve frame 0 (or the last good pose after a
        # detected failure, estimator.cpp:536-547).
        if self.failure_occur:
            origin_p0 = self.last_P0
            origin_q0 = hg.mat_to_quat(self.last_R0)
            self.failure_occur = False
        else:
            origin_p0, origin_q0 = self.Ps[0], self.Qs[0]

        relo = self._relo_active if not first else None
        if relo is not None:
            # Slot-identity re-check at dispatch: between set_relo_frame and
            # this solve, finalize_solve/remove_failures can free a matched
            # slot and add_frame_arrays can refill it with a NEW feature —
            # the relo row would then bind to the wrong landmark. Only slots
            # still holding the snapshotted feature id participate.
            relo = dict(
                relo,
                mask=relo["mask"] & (self.fm.feature_id == relo["snap_ids"]),
            )
        # Device state chain: active when the deep pipeline is on, the
        # previous solve's device refs are alive, and this is an ordinary
        # (non-relo, non-first) dispatch.
        chain_on = (
            self.cfg.device_chain
            and self.cfg.solve_lag > 1
            and self._chain is not None
            and relo is None
            and not first
        )
        packed = jnp.asarray(
            self._pack_solve_buffer(
                origin_p0, origin_q0, relo=relo,
                chain_flags=(chain_on,
                             self._chain["marg"] if chain_on else False),
            )
        )
        if relo is not None:
            (out, pre, sqrt_info, imu_ok, relo_p, relo_q, c0, c1), grid = (
                self._solve_relo_packed(packed, prior)
            )
            rn = rvalid = None
            relo_refs = (relo_p, relo_q)
            relo_meta = dict(
                stamp=relo["stamp"], prev_p=relo["prev_p"],
                prev_q=relo["prev_q"],
            )
            self._relo_active = None  # one-shot, like the reference
        else:
            chain_state = (
                self._chain["state"] if chain_on else self._zero_chain()
            )
            (out, pre, sqrt_info, imu_ok, rn, rvalid, c0, c1), grid = (
                self._solve_packed(packed, prior, chain_state)
            )
            relo_refs = None
            relo_meta = None
        # Arm (or invalidate) the chain for the NEXT dispatch: its advance
        # needs this solve's output plus the kind of the eager slide below.
        if (self.cfg.device_chain and self.cfg.solve_lag > 1
                and relo is None):
            self._chain = dict(
                state=(out.p, out.q, out.v, out.ba, out.bg,
                       out.tic, out.qic, out.td),
                marg=bool(self.marg_old),
            )
        else:
            self._chain = None
        if self.marg_old:
            new_prior = self._marg_old(out, grid, pre, sqrt_info, imu_ok, prior)
        else:
            new_prior = self._marg_new(out, prior)
        # The prior stays device-resident; only the window state comes back.
        self.prior = new_prior
        pend = dict(
            device=(
                (out.p, out.q, out.v, out.ba, out.bg,
                 out.tic, out.qic, out.td, out.inv_depth),
                rn, rvalid, relo_refs,
            ),
            t=t,
            first=first,
            relo=relo_meta,
            eager_slid=self.cfg.solve_lag > 1,
            slides=[],  # slides that happened AFTER this dispatch
            # Depth write-back applicability snapshot (slots may re-anchor
            # or be reassigned between dispatch and a lagged finalize).
            snap_id=self.fm.feature_id.copy(),
            snap_anchor=self.fm.anchor.copy(),
            snap_used=np.asarray(self.fm.used_mask()).copy(),
        )
        self._pending_q.append(pend)
        # Start the device→host transfer NOW: by the time finalize_solve
        # needs these values the copy has (typically) landed.
        if self.fetch_submit is not None:
            pend["future"] = self.fetch_submit(pend["device"])
        else:
            for leaf in jax.tree_util.tree_leaves(pend["device"]):
                if hasattr(leaf, "copy_to_host_async"):
                    leaf.copy_to_host_async()
        if pend["eager_slid"]:
            # Deep-pipeline mode: slide NOW with the propagated (pre-solve)
            # mirrors so the next frame's bookkeeping proceeds without the
            # solve result; record the slide for every in-flight solve.
            marg = self.marg_old
            self._slide_window()
            for p_ in self._pending_q:
                p_["slides"].append(bool(marg))

    @property
    def _pending(self):
        # Back-compat view (checkpointing, tests): truthy while any solve
        # is in flight.
        return self._pending_q[0] if self._pending_q else None

    def pending_count(self):
        return len(self._pending_q)

    def pending_solve_refs(self):
        """Device arrays of the OLDEST pending solve (None when nothing
        pending) — for a caller-batched jax.device_get shared with other
        fetches."""
        return None if not self._pending_q else self._pending_q[0]["device"]

    def finalize_solve(self, host=None):
        """Complete the OLDEST pending solve: write-back, (optional)
        outlier gate, failure detection, window slide (unless it already
        happened eagerly at dispatch — solve_lag > 1), trajectory record.
        ``host`` may carry the already-fetched values of
        :meth:`pending_solve_refs`."""
        if not self._pending_q:
            return
        pend = self._pending_q.pop(0)
        if host is None:
            fut = pend.get("future")
            host = fut.result() if fut is not None else jax.device_get(
                pend["device"]
            )
        state_host, rn, rvalid, relo_host = host
        if pend["eager_slid"]:
            self._write_back_lagged(pend, state_host)
        else:
            self._write_back(*state_host)
        if relo_host is not None and pend.get("relo") is not None:
            self._finalize_relo(pend["relo"], *relo_host)
        if rn is not None and not pend["eager_slid"]:
            self._gate_observations(np.asarray(rn), np.asarray(rvalid))
        if not pend["first"] and self._failure_detection():
            self.failure_occur = True
            self.clear_state()
            return
        if not pend["eager_slid"]:
            self._slide_window()
        if not pend["first"]:
            self.fm.remove_failures()
        if pend["eager_slid"]:
            # The dispatched frame's solved pose (pre-slide slot W).
            p_s, q_s = state_host[0], state_host[1]
            self.times.append(pend["t"])
            self.traj_p.append(np.asarray(p_s[self.WIN], np.float64))
            self.traj_q.append(np.asarray(q_s[self.WIN], np.float64))
            self.last_R = hg.quat_to_mat(np.asarray(q_s[self.WIN], np.float64))
            self.last_P = np.asarray(p_s[self.WIN], np.float64).copy()
            if not pend["first"]:
                self.last_R0 = hg.quat_to_mat(np.asarray(q_s[0], np.float64))
                self.last_P0 = np.asarray(p_s[0], np.float64).copy()
        else:
            self._record_output(pend["t"])
            self.last_R = hg.quat_to_mat(self.Qs[self.WIN])
            self.last_P = self.Ps[self.WIN].copy()
            if not pend["first"]:
                self.last_R0 = hg.quat_to_mat(self.Qs[0])
                self.last_P0 = self.Ps[0].copy()

    def _write_back_lagged(self, pend, state_host):
        """Rebase a LAGGED solve result onto the current (already slid,
        IMU-propagated) mirrors: map each solved window slot through the
        slides that happened since dispatch, then re-propagate the trailing
        slots that were created afterwards from their corrected
        predecessors using the buffered interval IMU samples."""
        p, q, v, ba, bg, tic, qic, td, inv_depth = [
            np.asarray(a, np.float64) for a in state_host
        ]
        src = np.arange(self.NF)
        n_old = 0
        for marg_old in pend["slides"]:
            if marg_old:
                src = np.concatenate([src[1:], [-1]])
                n_old += 1
            else:
                src = np.concatenate([src[: self.WIN - 1], src[self.WIN:], [-1]])
        ok = src >= 0
        self.Ps[ok] = p[src[ok]]
        self.Qs[ok] = q[src[ok]]
        self.Vs[ok] = v[src[ok]]
        self.Bas[ok] = ba[src[ok]]
        self.Bgs[ok] = bg[src[ok]]
        if self.cfg.estimate_extrinsic:
            self.tic = tic.copy()
            self.qic = qic.copy()
        if self.cfg.estimate_td:
            self.td = float(td)
        # Trailing slots created after dispatch: re-propagate from the
        # corrected predecessor with the buffered interval samples.
        for j in np.where(~ok)[0]:
            if j > 0:
                self._propagate_slot(int(j))
        # Depths: only slots still holding the same feature at the same
        # physical anchor (anchor index shifted by the old-slides count).
        applicable = (
            pend["snap_used"]
            & (self.fm.feature_id == pend["snap_id"])
            & (self.fm.anchor == pend["snap_anchor"] - n_old)
        )
        self.fm.mark_solved_depths(inv_depth, applicable)

    def _propagate_slot(self, j):
        """Midpoint-propagate mirror slot j from slot j-1 over its buffered
        interval samples (same scheme as process_imu)."""
        n = int(self._imu_n[j])
        P = self.Ps[j - 1].copy()
        Q = self.Qs[j - 1].copy()
        V = self.Vs[j - 1].copy()
        Ba = self.Bas[j - 1].copy()
        Bg = self.Bgs[j - 1].copy()
        self.Bas[j] = Ba
        self.Bgs[j] = Bg
        g = np.array([0.0, 0.0, self.cfg.g_norm])
        acc0 = self._imu_a0[j].copy()
        gyr0 = self._imu_g0[j].copy()
        for k in range(n):
            dt = self._imu_dts[j, k]
            acc = self._imu_accs[j, k]
            gyr = self._imu_gyrs[j, k]
            un_acc_0 = hg.quat_to_mat(Q) @ (acc0 - Ba) - g
            un_gyr = 0.5 * (gyr0 + gyr) - Bg
            Q = hg.quat_normalize(hg.quat_mul(Q, hg.so3_exp(un_gyr * dt)))
            un_acc_1 = hg.quat_to_mat(Q) @ (acc - Ba) - g
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            P = P + dt * V + 0.5 * dt * dt * un_acc
            V = V + dt * un_acc
            acc0, gyr0 = acc, gyr
        self.Ps[j] = P
        self.Qs[j] = Q
        self.Vs[j] = V

    def _finalize_relo(self, meta, relo_p, relo_q):
        """Relative-pose outputs from the JOINTLY-refined loop pose
        (double2vector, estimator.cpp:605-624). Runs at the relo solve's
        finalize, before the window slides."""
        relo_p = np.asarray(relo_p, np.float64)
        relo_q = np.asarray(relo_q, np.float64)
        idx = None
        for i in range(self.NF):
            if abs(self.headers[i] - meta["stamp"]) < 1e-7:
                idx = i
        if idx is None:
            return

        def norm_deg(a):
            return (a + 180.0) % 360.0 - 180.0

        relo_r = hg.quat_to_mat(relo_q)
        R_idx = hg.quat_to_mat(self.Qs[idx])
        self.relo_relative_t = relo_r.T @ (self.Ps[idx] - relo_p)
        self.relo_relative_q = hg.mat_to_quat(relo_r.T @ R_idx)
        self.relo_relative_yaw = norm_deg(
            float(hg.R_to_ypr_deg(R_idx)[0])
            - float(hg.R_to_ypr_deg(relo_r)[0])
        )
        prev_relo_r = hg.quat_to_mat(meta["prev_q"])
        dy = norm_deg(
            float(hg.R_to_ypr_deg(prev_relo_r)[0])
            - float(hg.R_to_ypr_deg(relo_r)[0])
        )
        self.drift_correct_r = hg.ypr_deg_to_R([dy, 0.0, 0.0])
        self.drift_correct_t = (
            meta["prev_p"] - self.drift_correct_r @ relo_p
        )

    # Reprojection gate: observations with residuals beyond this (sqrt_info
    # units, 1 px ~ 0.667) could be dropped post-solve. A/B on the synthetic
    # e2e shows aggressive gating (3 px) *hurts* (drift 0.58 -> 3.1 m): the
    # re-anchoring/depth resets destabilize the window, which is presumably
    # why the reference ships removeOutlier disabled
    # (feature_manager.cpp:255-268). Effectively off by default; the Cauchy
    # loss already bounds outlier influence.
    GATE_THRESH = 1e9

    def _gate_observations(self, rn, valid):
        bad = valid & (rn > self.GATE_THRESH)
        if not bad.any():
            return
        fm = self.fm
        for f, j in zip(*np.where(bad)):
            if fm.anchor[f] == j:
                continue  # anchor rows are never residual rows
            fm.valid[f, j] = False
        # Features left with < 2 observations are dead.
        for f in np.where(fm.feature_id >= 0)[0]:
            if fm.valid[f].sum() < 2:
                fm._free(f)
            elif not fm.valid[f, fm.anchor[f]]:
                first = int(np.argmax(fm.valid[f]))
                fm.anchor[f] = first
                fm.depth[f] = -1.0

    def _write_back(self, p, q, v, ba, bg, tic, qic, td, inv_depth):
        """Copy the solved (already gauge-fixed on device) window back into
        the host mirrors. The 4-DoF yaw fix itself runs inside the fused
        device step (backend/gauge.py)."""
        self.Ps[:] = np.asarray(p, np.float64)
        self.Qs[:] = np.asarray(q, np.float64)
        self.Vs[:] = np.asarray(v, np.float64)
        self.Bas = np.asarray(ba, np.float64).copy()
        self.Bgs = np.asarray(bg, np.float64).copy()
        if self.cfg.estimate_extrinsic:
            self.tic = np.asarray(tic, np.float64).copy()
            self.qic = np.asarray(qic, np.float64).copy()
        if self.cfg.estimate_td:
            self.td = float(td)
        # Depths.
        inv_d = np.asarray(inv_depth, np.float64)
        used = np.asarray(self.fm.used_mask())
        self.fm.mark_solved_depths(inv_d, used)

    # ------------------------------------------------------------------ slide
    def _slide_window(self):
        if self.frame_count < self.WIN:
            return
        if self.marg_old:
            back_R0 = hg.quat_to_mat(self.Qs[0])
            back_P0 = self.Ps[0].copy()
            ric = self._ric0()
            tic0 = self._tic0()
            # Shift states.
            for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.headers):
                arr[:-1] = arr[1:]
            self.imu_buf = self.imu_buf[1:] + [[]]
            # Merge the first two entries' buffers is NOT needed: dropped.
            self.imu_buf[0] = []
            for arr in (
                self._imu_dts, self._imu_accs, self._imu_gyrs,
                self._imu_a0, self._imu_g0, self._imu_n, self._imu_sumdt,
            ):
                arr[:-1] = arr[1:]
                arr[-1] = 0
            self._imu_n[0] = 0
            self._imu_sumdt[0] = 0.0
            if self.solver_flag == self.NON_LINEAR:
                R0 = back_R0 @ ric
                P0 = back_P0 + back_R0 @ tic0
                Rnew0 = hg.quat_to_mat(self.Qs[0])
                R1 = Rnew0 @ ric
                P1 = self.Ps[0] + Rnew0 @ tic0
                self.fm.slide_old(R0, P0, R1, P1)
            else:
                self.fm.slide_old(np.eye(3), np.zeros(3), np.eye(3), np.zeros(3))
            # Drop consumed all_frames (everything before new frame 0).
            t0 = self.headers[0]
            self.all_frames = [f for f in self.all_frames if f["t"] >= t0]
        else:
            j = self.frame_count
            # Merge newest interval's IMU into interval j-1.
            self.imu_buf[j - 1].extend(self.imu_buf[j])
            self.imu_buf[j] = []
            M = self._imu_dts.shape[1]
            n0 = int(self._imu_n[j - 1])
            take = min(int(self._imu_n[j]), M - n0)
            if take > 0:
                self._imu_dts[j - 1, n0 : n0 + take] = self._imu_dts[j, :take]
                self._imu_accs[j - 1, n0 : n0 + take] = self._imu_accs[j, :take]
                self._imu_gyrs[j - 1, n0 : n0 + take] = self._imu_gyrs[j, :take]
                self._imu_n[j - 1] = n0 + take
            if self._imu_n[j - 1] > 0 and n0 == 0:
                self._imu_a0[j - 1] = self._imu_a0[j]
                self._imu_g0[j - 1] = self._imu_g0[j]
            self._imu_sumdt[j - 1] += self._imu_sumdt[j]
            self._imu_dts[j] = 0.0
            self._imu_accs[j] = 0.0
            self._imu_gyrs[j] = 0.0
            self._imu_n[j] = 0
            self._imu_sumdt[j] = 0.0
            for arr in (self.Ps, self.Qs, self.Vs, self.Bas, self.Bgs, self.headers):
                arr[j - 1] = arr[j]
            self.fm.slide_second_new(j)
            # Merge all_frames entries: drop the discarded frame's entry but
            # keep its IMU attached to the successor.
            if len(self.all_frames) >= 2:
                merged = self.all_frames[-2]["imu"] + self.all_frames[-1]["imu"]
                self.all_frames[-1]["imu"] = merged
                del self.all_frames[-2]

    # ------------------------------------------------------------ failure det
    def _failure_detection(self):
        """estimator.cpp:628-674 (active checks only)."""
        if np.linalg.norm(self.Bgs[self.WIN]) > 1.0:
            return True
        if np.linalg.norm(self.Ps[self.WIN] - self.last_P) > 5.0:
            return True
        if abs(self.Ps[self.WIN][2] - self.last_P[2]) > 1.0:
            return True
        return False

    # ---------------------------------------------------------------- initial
    def _np_preint(self, imu, bg=None, start=None):
        """Host (numpy, f64) midpoint preintegration of one buffer — only the
        deltas and the gyro-bias rotation Jacobian needed by the alignment
        (keeps the cold init path off the device entirely)."""
        if not imu:
            return None
        bg = np.zeros(3) if bg is None else np.asarray(bg, np.float64)
        accs = np.asarray([b[1] for b in imu], np.float64)
        gyrs = np.asarray([b[2] for b in imu], np.float64)
        dts = np.asarray([b[0] for b in imu], np.float64)
        a0, g0 = start if start is not None else (accs[0], gyrs[0])

        dp = np.zeros(3)
        dq = np.array([1.0, 0, 0, 0])
        dv = np.zeros(3)
        jac_q_bg = np.zeros((3, 3))
        sum_dt = 0.0
        acc_p, gyr_p = np.asarray(a0, np.float64), np.asarray(g0, np.float64)
        Jq = np.zeros((3, 3))  # d(theta)/d(bg) block, propagated as in F
        for dt, acc_c, gyr_c in zip(dts, accs, gyrs):
            un_acc_0 = hg.quat_to_mat(dq) @ acc_p
            un_gyr = 0.5 * (gyr_p + gyr_c) - bg
            dq_new = hg.quat_normalize(
                hg.quat_mul(dq, np.concatenate([[1.0], 0.5 * un_gyr * dt]))
            )
            un_acc_1 = hg.quat_to_mat(dq_new) @ acc_c
            un_acc = 0.5 * (un_acc_0 + un_acc_1)
            dp = dp + dv * dt + 0.5 * un_acc * dt * dt
            dv = dv + un_acc * dt
            # F(3:6,3:6) = I - [w]x dt;  F(3:6,12:15) = -I dt
            w = un_gyr
            Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            Jq = (np.eye(3) - Wx * dt) @ Jq - np.eye(3) * dt
            dq = dq_new
            sum_dt += dt
            acc_p, gyr_p = acc_c, gyr_c

        class _P:
            pass

        pre = _P()
        pre.delta_p = dp
        pre.delta_q = dq
        pre.delta_v = dv
        pre.sum_dt = sum_dt
        jac = np.zeros((15, 15))
        jac[3:6, 12:15] = Jq
        pre.jacobian = jac
        return pre

    def _initial_structure(self):
        """estimator.cpp:221-363 initialStructure."""
        ric = self._ric0()
        tic0 = self._tic0()
        # 1. relative pose pivot.
        rel = None
        for i in range(self.WIN):
            b1, b2, _ = self.fm.corresponding(i, self.WIN)
            if len(b1) > 20:
                # parallax on the z=1 plane (reference uses plane coords).
                with np.errstate(divide="ignore", invalid="ignore"):
                    p0 = b1[:, :2] / b1[:, 2:3]
                    p1 = b2[:, :2] / b2[:, 2:3]
                par = np.linalg.norm(p0 - p1, axis=-1)
                par = par[np.isfinite(par)]
                if len(par) and par.mean() * 160.0 > 30.0:
                    R, T, ok = solve_relative_rt(b1, b2)
                    if ok:
                        rel = (i, R, T)
                        break
        if rel is None:
            return False
        l, rel_R, rel_T = rel

        # 2. global SfM over the window features.
        obs = self.fm.observations_dict()
        ok, q_sfm, T_sfm, points = global_sfm(self.NF, l, rel_R, rel_T, obs)
        if not ok:
            self.marg_old = True
            return False

        # 3. PnP poses for all (non-window) frames vs sfm points.
        from ..vinit.pnp import pnp_bearing_gn

        frame_poses = []  # (R world<-imu, T) per all_frames entry
        ki = 0
        for fr in self.all_frames:
            if ki < self.NF and abs(fr["t"] - self.headers[ki]) < 1e-9:
                R_wc = hg.quat_to_mat(q_sfm[ki])
                fr["R"] = R_wc @ ric.T
                fr["T"] = T_sfm[ki]
                fr["is_key"] = True
                ki += 1
                frame_poses.append((fr["R"], fr["T"]))
                continue
            # Non-key frame: PnP against sfm points.
            ids = [fid for fid in fr["feats"] if fid in points]
            if len(ids) < 6:
                return False
            pw = np.stack([points[fid] for fid in ids])
            bb = np.stack([fr["feats"][fid] for fid in ids])
            # init from the previous solved frame.
            if frame_poses:
                R_init = frame_poses[-1][0] @ ric  # world<-cam
                t_init = frame_poses[-1][1]
            else:
                R_init, t_init = np.eye(3), np.zeros(3)
            R_cw = R_init.T
            t_cw = -R_cw @ t_init
            R_cw, t_cw, ok = pnp_bearing_gn(pw, bb, R_cw, t_cw)
            if not ok:
                return False
            R_wc = R_cw.T
            fr["R"] = R_wc @ ric.T
            fr["T"] = -R_wc @ t_cw
            fr["is_key"] = False
            frame_poses.append((fr["R"], fr["T"]))

        # 4. visual-inertial alignment.
        align_frames = []
        for fr in self.all_frames:
            af = AlignFrame(R=fr["R"], T=fr["T"], is_key_frame=fr["is_key"])
            pre = self._np_preint(fr["imu"], start=fr.get("imu_start"))
            if pre is not None:
                af.sum_dt = float(pre.sum_dt)
                af.delta_p = np.asarray(pre.delta_p)
                af.delta_q = np.asarray(pre.delta_q)
                af.delta_v = np.asarray(pre.delta_v)
                af.jac_q_bg = np.asarray(pre.jacobian[3:6, 12:15])
            else:
                af.sum_dt = 0.0
                af.delta_p = np.zeros(3)
                af.delta_q = np.array([1.0, 0, 0, 0])
                af.delta_v = np.zeros(3)
                af.jac_q_bg = np.zeros((3, 3))
            align_frames.append(af)

        def reprop(frames, dbg):
            for fr, af in zip(self.all_frames, frames):
                pre = self._np_preint(fr["imu"], bg=dbg, start=fr.get("imu_start"))
                if pre is not None:
                    af.delta_p = np.asarray(pre.delta_p)
                    af.delta_q = np.asarray(pre.delta_q)
                    af.delta_v = np.asarray(pre.delta_v)

        # Skip the degenerate first frame (no preintegration) pairings are
        # handled because frames[0].delta_* is identity and pairs use f_j's.
        ok, dbg, g_vis, x = visual_imu_alignment(
            align_frames[: None], tic0, self.cfg.g_norm, reprop
        )
        if not ok:
            return False

        # 5. visualInitialAlign (estimator.cpp:367-443).
        kf = [f for f in self.all_frames if f["is_key"]]
        for i in range(self.NF):
            self.Ps[i] = kf[i]["T"]
            self.Qs[i] = hg.mat_to_quat(np.asarray(kf[i]["R"]))
        self.Bgs[:] = self.Bgs + dbg

        s = float(x[-1])
        # Reset depths & triangulate at unscaled poses with tic=0.
        sd = self.cfg.solver_dtype
        self.fm.depth[:] = -1.0
        state_tmp = self._device_state()
        state_tmp = dataclasses.replace(
            state_tmp, tic=jnp.zeros_like(state_tmp.tic)
        )
        grid = self._device_grid()
        inv_d = np.asarray(
            self._triangulate(state_tmp, grid, jnp.zeros(grid.used.shape, bool))
        )
        used = np.asarray(grid.used)
        self.fm.depth[used] = 1.0 / np.maximum(inv_d[used], 1e-6)

        # Rescale: Ps = s*Ps - Rs*tic - (s*Ps0 - Rs0*tic); depths *= s.
        R0s = [hg.quat_to_mat(self.Qs[i]) for i in range(self.NF)]
        base = s * self.Ps[0] - R0s[0] @ tic0
        for i in range(self.NF - 1, -1, -1):
            self.Ps[i] = s * self.Ps[i] - R0s[i] @ tic0 - base
        kv = -1
        for fr, af in zip(self.all_frames, align_frames):
            if fr["is_key"]:
                kv += 1
                self.Vs[kv] = fr["R"] @ x[kv * 3 : kv * 3 + 3]
        self.fm.depth[used] *= s

        # Gravity alignment: rotate world so g -> (0,0,g_norm), yaw(R0)=0.
        R0 = hg.g2R(g_vis)
        yaw = float(hg.R_to_ypr_deg(R0 @ R0s[0])[0])
        R0 = hg.ypr_deg_to_R([-yaw, 0.0, 0.0]) @ R0
        self.gravity = R0 @ g_vis
        for i in range(self.NF):
            Ri = R0 @ R0s[i]
            self.Ps[i] = R0 @ self.Ps[i]
            self.Vs[i] = R0 @ self.Vs[i]
            self.Qs[i] = hg.mat_to_quat(Ri)
        return True
