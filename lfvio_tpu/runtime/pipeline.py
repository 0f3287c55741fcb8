"""End-to-end VIO pipeline: frontend + estimator over a measurement stream.

The process-level equivalent of the two ROS nodes + their topic plumbing
(feature_tracker_node.cpp, estimator_node.cpp). Includes the measurement
alignment of getMeasurements (estimator_node.cpp:96-134, 216-258): each frame
is paired with the IMU interval covering it, and the boundary sample is
*linearly interpolated at the frame timestamp* — without this, up to one
IMU period of rotation is misattributed across the frame boundary, which
biases the gyro-bias estimate.
"""

from __future__ import annotations

import numpy as np

from .tracker import FrontEnd
from .estimator import Estimator, EstimatorConfig


class _FetchPool:
    """Worker-thread device→host fetch pool.

    Every device→host fetch is submitted here AT DISPATCH TIME, so the main
    thread only waits on a future whose copy has been in flight for several
    frames; concurrent `jax.device_get` calls from separate threads overlap
    each other and the main thread's dispatches. PJRT device_get is
    thread-safe and read-only. Whether this pays on a local card is open
    (ROADMAP D3).
    """

    def __init__(self, n_workers: int = 6):
        import atexit
        from concurrent.futures import ThreadPoolExecutor

        self._ex = ThreadPoolExecutor(
            max_workers=n_workers, thread_name_prefix="lfvio-fetch"
        )
        atexit.register(self._ex.shutdown, wait=False, cancel_futures=True)

    def submit(self, tree):
        import jax

        return self._ex.submit(jax.device_get, tree)


class VioPipeline:
    def __init__(self, frontend: FrontEnd, estimator: Estimator, freq: float = 0.0,
                 td: float = 0.0, on_odometry=None, depth: int = 3):
        self.fe = frontend
        self.est = estimator
        self.freq = freq  # max publish rate; 0 = publish every frame
        self.td = td  # initial camera-IMU time offset (see _td_now)
        # Tracker frames in flight before host processing (device slot
        # chain advances at dispatch, so correctness is depth-independent).
        # Higher depth hides more device/transfer latency at the cost of
        # one frame period of output latency per level. depth=1 = fully
        # synchronous.
        self.depth = max(int(depth), 1)
        self.on_odometry = on_odometry  # callback(t, p, q, v) at IMU rate
        self._last_pub_t = -1e18
        self._last_pub_decision = -1e18  # dispatch-order throttle state
        self._last_imu = None  # (t, acc, gyr)
        self._last_frame_t = None
        self.n_restarts = 0
        self._pending = []  # frames waiting for a covering IMU sample
        # IMU samples bound for the estimator, replayed at the next frame:
        # the estimator may have a solve in flight (defer_solve) whose
        # finalize must see exactly the state at dispatch time.
        self._est_imu_queue = []
        self._sync_q = []  # sync times of frames whose solves are in flight
        # Depth-N frame pipeline: tracker dispatches run ahead of their
        # host processing (the device slot chain advances at dispatch, so
        # no host sync is needed in between). Each entry:
        # (handle, t, td_pair, publish, imu_batch-for-that-frame).
        self._fe_inflight = []
        self._fe_deferred = []  # unpublished frames awaiting batched harvest
        # High-rate IMU-propagated state (estimator_node.cpp predict/update):
        # the low-latency output between the ~10 Hz solver updates.
        self._recent_imu = []  # samples since the last solved frame
        self._tmp = None  # (P, Q, V, Ba, Bg, acc0, gyr0, t0)
        self.high_rate = []  # list of (t, p[3], q[4], v[3])
        # Fetch pool: all device→host fetches ride worker threads whose
        # copies overlap the main thread and each other (see _FetchPool).
        # LFVIO_FETCH_WORKERS=0 selects one combined device_get per
        # processed frame instead (A/B knob for ROADMAP D3).
        import os

        n_fetch = int(os.environ.get("LFVIO_FETCH_WORKERS", "6"))
        self._fetch_pool = _FetchPool(n_fetch) if n_fetch > 0 else None
        if self._fetch_pool is not None:
            self.est.fetch_submit = self._fetch_pool.submit

    @classmethod
    def from_yaml(cls, path, n_slots: int = 256, dtype=None, **kw):
        """Build the complete pipeline from ONE reference-format rig YAML
        (parameters.cpp:42-139 + feature_tracker/parameters.cpp:43-84)."""
        import jax.numpy as jnp

        from .config import load_rig_yaml

        rig = load_rig_yaml(path)
        return rig.make_pipeline(
            n_slots=n_slots, dtype=dtype or jnp.float32, **kw
        )

    def _solve_lag(self) -> int:
        return max(getattr(self.est.cfg, "solve_lag", 1), 1)

    def _maybe_calibrate_budget(self):
        """One-shot solver wall-budget calibration after pipeline warmup:
        the reference enforces max_solver_time on every solve
        (estimator.cpp:810-825); here the budget binds as a dynamic
        iteration cap that needs a measured per-iteration device time.
        Runs once, after a few production solves have landed (programs
        compiled, window informative)."""
        est = self.est
        if (
            est.cfg.max_solver_time <= 0
            or est._iter_time is not None
            or est.solver_flag != est.NON_LINEAR
        ):
            return
        self._n_finalized = getattr(self, "_n_finalized", 0) + 1
        if self._n_finalized >= 3:
            est.calibrate_solver_budget()

    @property
    def _td_now(self) -> float:
        """LIVE camera-IMU offset for measurement pairing. The reference's
        getMeasurements reads `estimator.td` (estimator_node.cpp:100), so an
        online td estimate immediately shifts which IMU interval covers each
        frame — without this, td corrections never feed back into the
        pairing and the estimate random-walks."""
        return float(getattr(self.est, "td", self.td))

    # ------------------------------------------------------------------ feed
    def feed_imu(self, t, acc, gyr):
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        prev = self._last_imu
        # Flush any pending frame that this sample covers.
        while self._pending and self._pending[0][0] + self._td_now <= t:
            t_f, img = self._pending.pop(0)
            t_sync = t_f + self._td_now
            if prev is not None and t_sync > prev[0]:
                # Interpolate the boundary sample at the frame time.
                w = (t_sync - prev[0]) / max(t - prev[0], 1e-12)
                acc_i = (1 - w) * prev[1] + w * acc
                gyr_i = (1 - w) * prev[2] + w * gyr
                self._est_imu_queue.append((t_sync - prev[0], acc_i, gyr_i))
                prev = (t_sync, acc_i, gyr_i)
            # Pass the PAIRING-time td along: finalize_solve may update
            # self.est.td before the frame is processed, and recording a
            # different td_obs than the one used for IMU pairing is a
            # positive-feedback loop on the td estimate (each observation's
            # correction (td - td_i)·vel under-corrects while td is moving,
            # so the estimate overshoots its equilibrium).
            self._process_frame(t_f, img, td_pair=t_sync - t_f)
        dt = 0.0 if prev is None else t - prev[0]
        self._est_imu_queue.append((dt, acc, gyr))
        self._last_imu = (t, acc, gyr)
        self._recent_imu.append((t, acc.copy(), gyr.copy()))
        self._predict(t, acc, gyr)

    def _drain_est_imu(self):
        q, self._est_imu_queue = self._est_imu_queue, []
        for dt, acc, gyr in q:
            self.est.process_imu(dt, acc, gyr)

    def feed_frame(self, t, img):
        # Stream-discontinuity detection (feature_tracker_node.cpp:38-48):
        # a gap > 1 s or a backwards timestamp restarts the whole system —
        # tracker state AND estimator (estimator_node.cpp:176-195
        # restart_callback → clearState + setParameter).
        if self._last_frame_t is not None and (
            t - self._last_frame_t > 1.0 or t < self._last_frame_t
        ):
            self.restart()
        self._last_frame_t = t
        self._pending.append((t, img))

    def restart(self):
        """Full system restart on stream discontinuity."""
        self.n_restarts += 1
        self.fe.reset()
        self.est.clear_state()
        self._pending = []
        self._est_imu_queue = []
        self._fe_inflight = []
        self._fe_deferred = []
        self._sync_q = []
        self._last_pub_decision = -1e18
        self._last_imu = None
        self._recent_imu = []
        self._tmp = None
        self._last_pub_t = -1e18

    # ---------------------------------------------------------- high-rate out
    def _predict(self, t, acc, gyr):
        """Midpoint propagation of the temporary high-rate state — the ~IMU
        rate odometry path (estimator_node.cpp:41-77, pubLatestOdometry)."""
        if self._tmp is None or self.est.solver_flag != self.est.NON_LINEAR:
            return
        P, Q, V, Ba, Bg, acc0, gyr0, t0 = self._tmp
        dt = t - t0
        if dt <= 0:
            return
        g = np.array([0.0, 0.0, self.est.cfg.g_norm])
        from ..geom import host as hg

        un_acc_0 = hg.quat_to_mat(Q) @ (acc0 - Ba) - g
        un_gyr = 0.5 * (gyr0 + gyr) - Bg
        Q = hg.quat_normalize(hg.quat_mul(Q, hg.so3_exp(un_gyr * dt)))
        un_acc_1 = hg.quat_to_mat(Q) @ (acc - Ba) - g
        un_acc = 0.5 * (un_acc_0 + un_acc_1)
        P = P + dt * V + 0.5 * dt * dt * un_acc
        V = V + dt * un_acc
        self._tmp = (P, Q, V, Ba, Bg, acc, gyr, t)
        self.high_rate.append((t, P.copy(), Q.copy(), V.copy()))
        if self.on_odometry is not None:
            self.on_odometry(t, P, Q, V)

    def _update_tmp_state(self, t_frame):
        """Re-seed the high-rate state from the freshly solved window and
        re-propagate IMU samples newer than the frame
        (estimator_node.cpp:79-94 update())."""
        est = self.est
        if est.solver_flag != est.NON_LINEAR or not est.times:
            self._tmp = None
            return
        P = est.Ps[-1].copy()
        Q = est.Qs[-1].copy()
        V = est.Vs[-1].copy()
        Ba = est.Bas[-1].copy()
        Bg = est.Bgs[-1].copy()
        remaining = [s for s in self._recent_imu if s[0] > t_frame]
        acc0 = remaining[0][1] if remaining else est.acc_0.copy()
        gyr0 = remaining[0][2] if remaining else est.gyr_0.copy()
        self._tmp = (P, Q, V, Ba, Bg, acc0, gyr0, t_frame)
        for t, acc, gyr in remaining:
            # re-propagate without re-publishing
            hold = self.on_odometry, self.high_rate
            self.on_odometry, self.high_rate = None, []
            self._predict(t, acc, gyr)
            self.on_odometry, self.high_rate = hold
        self._recent_imu = remaining

    def _process_frame(self, t, img, td_pair=None):
        """Depth-N latency-hiding schedule (shown for depth 2):

          frame k arrives:
            1. dispatch tracker k — the tracker's slot chain (positions,
               validity) is DEVICE-RESIDENT and advances at dispatch, so
               this needs nothing from frame k-1's host processing;
            2. start the device→host copy of its outputs, which proceeds
               while the host works on older frames;
            3. process frame k-1 (whose copy has been in flight for a full
               frame): ONE combined device_get of {tracker k-1 outputs,
               solve k-2 outputs} → finalize solve k-2, replay frame k-1's
               IMU batch, tracker bookkeeping, dispatch solve k-1.

        Steady state pays ~zero synchronization wait per frame: every
        harvested value was computed AND copied during the previous frame.
        Output latency grows by one frame (~1 frame period), matching what
        the reference's queued solver thread also incurs under load.

        Test-stub frontends (no ``dispatch`` attr) run the same logic
        synchronously at depth 1 — bit-identical estimator inputs, no
        device pipelining.
        """
        # Frequency throttle (feature_tracker_node.cpp:51-62). Decisions
        # are made in DISPATCH order: with deferred processing the
        # processing-time _last_pub_t lags several frames and would never
        # throttle.
        publish = True
        if self.freq > 0:
            if (t - self._last_pub_decision) < 1.0 / self.freq - 1e-9:
                publish = False
            else:
                self._last_pub_decision = t

        if not hasattr(self.fe, "dispatch"):
            # Synchronous depth-1 path for duck-typed stub frontends.
            import jax

            if self.est.pending_count() >= self._solve_lag():
                self.est.finalize_solve()  # resolves its own fetch/future
                if self._sync_q:
                    self._update_tmp_state(self._sync_q.pop(0))
                self._maybe_calibrate_budget()
            self._drain_est_imu()
            out = self.fe.process_arrays(img, t, publish=publish)
            self._publish_frame(out, t, td_pair, publish)
            return

        import jax

        handle = self.fe.dispatch(img, t, publish=publish)
        if self._fetch_pool is not None:
            fe_fut = self._fetch_pool.submit(handle[2])
        else:
            fe_fut = None
            for leaf in jax.tree_util.tree_leaves(handle[2]):
                if hasattr(leaf, "copy_to_host_async"):
                    leaf.copy_to_host_async()
        # This frame's estimator IMU batch: everything queued since the
        # previous frame event (its boundary-interpolated sample included).
        imu_batch, self._est_imu_queue = self._est_imu_queue, []
        self._fe_inflight.append((handle, t, td_pair, publish, imu_batch, fe_fut))
        if len(self._fe_inflight) >= self.depth:
            self._advance_one()

    def _advance_one(self):
        """Process the oldest in-flight frame (host side): harvest its
        tracker outputs together with the previous solve's, finalize that
        solve, replay the frame's IMU, and dispatch its own solve.

        Unpublished frames (freq throttling, the reference's `freq: 10` on
        a 15 fps stream) DEFER their host bookkeeping: their harvests batch
        into the next published frame's fetch, so a throttled stream waits
        on the device once per PUBLISHED frame, not per input frame.
        """
        import jax

        handle, t, td_pair, publish, imu_batch, fe_fut = self._fe_inflight.pop(0)
        # Fetch the oldest solve only when its result is DUE (the queue is
        # at the estimator's solve_lag): at lag 2 the fetch has been in
        # flight for two frames.
        due = self.est.pending_count() >= self._solve_lag()
        if not publish and not due:
            self._fe_deferred.append((handle, t, imu_batch, fe_fut))
            return
        pend = self.est.pending_solve_refs() if due else None
        deferred, self._fe_deferred = self._fe_deferred, []
        if self._fetch_pool is not None:
            # Every fetch was submitted to the pool at dispatch time; the
            # results are (typically) already sitting in their futures.
            def_hosts = [d[3].result() for d in deferred]
            fe_host = fe_fut.result()
            est_host = None  # finalize_solve resolves its own future
        else:
            # ONE combined fetch (all subtrees were async-copied at
            # dispatch).
            def_hosts, fe_host, est_host = jax.device_get(
                ([d[0][2] for d in deferred], handle[2], pend)
            )
        if pend is not None:
            self.est.finalize_solve(est_host)
            if self._sync_q:
                # Re-seed the high-rate propagation from the just-finalized
                # solve — the reference's update() at solve completion.
                self._update_tmp_state(self._sync_q.pop(0))
            self._maybe_calibrate_budget()
        # Replay deferred (unpublished) frames in stream order first.
        for (h, _th, batch, _f), hh in zip(deferred, def_hosts):
            for dt, acc, gyr in batch:
                self.est.process_imu(dt, acc, gyr)
            self.fe.finalize(h, hh)  # publish=False → bookkeeping only
        for dt, acc, gyr in imu_batch:
            self.est.process_imu(dt, acc, gyr)
        out = self.fe.finalize(handle, fe_host)
        self._publish_frame(out, t, td_pair, publish)

    def _publish_frame(self, out, t, td_pair, publish):
        if publish and out is not None:
            ids, bearings, vels, rows, pub = out[:5]
            cams = out[5] if len(out) > 5 else None  # multi-camera frontends
            if pub.any():
                self._last_pub_t = t
                n_before = self.est.pending_count()
                self.est.process_image_arrays(
                    ids, bearings, vels, rows, pub, t, defer_solve=True,
                    td_pair=td_pair, cams=cams,
                )
                if self.est.pending_count() > n_before:
                    self._sync_q.append(
                        t + td_pair if td_pair is not None else
                        t + self._td_now
                    )

    def flush(self):
        """Complete all in-flight work (call at stream end / before
        checkpointing — the last frames' tracker + solve are otherwise
        still pending)."""
        import jax

        while self._fe_inflight:
            self._advance_one()
        if self._fe_deferred:
            deferred, self._fe_deferred = self._fe_deferred, []
            if self._fetch_pool is not None:
                hosts = [d[3].result() for d in deferred]
            else:
                hosts = jax.device_get([d[0][2] for d in deferred])
            for (h, _th, batch, _f), hh in zip(deferred, hosts):
                for dt, acc, gyr in batch:
                    self.est.process_imu(dt, acc, gyr)
                self.fe.finalize(h, hh)
        while self.est.pending_count():
            self.est.finalize_solve()
            if self._sync_q:
                self._update_tmp_state(self._sync_q.pop(0))
        self._drain_est_imu()

    def run(self, stream, render_fn):
        for item in stream:
            kind, t = item[0], item[1]
            if kind == "imu":
                self.feed_imu(t, item[2], item[3])
            else:
                img = item[2] if item[2] is not None else render_fn(t)
                self.feed_frame(t, img)
        self.flush()
        return (
            np.asarray(self.est.times),
            np.asarray(self.est.traj_p),
            np.asarray(self.est.traj_q),
        )
