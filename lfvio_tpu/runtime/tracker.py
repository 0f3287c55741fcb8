"""Front-end orchestration: per-frame feature tracking pipeline.

The device-side equivalent of the feature_tracker node
(/root/reference/feature_tracker/src/feature_tracker.cpp readImage pipeline +
feature_tracker_node.cpp publishing): CLAHE → pyramid → pyramidal LK →
border/RANSAC rejection → masked Shi-Tomasi refill → bearing lift + 3-D
bearing velocities.

The whole per-frame device computation is ONE jitted call
(``_step``): track + reject + detect + lift fused into a single XLA
program, so a frame costs exactly one host→device image transfer and one
device→host result transfer. Id/track-count bookkeeping stays on the host
(numpy).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import (
    clahe,
    gaussian_pyramid,
    pyramidal_lk,
    shi_tomasi_response,
    select_features,
    annulus_mask,
    spherical_ransac_e,
)


class IdCounter:
    """Shared feature-id allocator: multi-camera rigs draw ids for ALL
    cameras from one sequence so the estimator's id space is global (the
    reference's dual-PAL rig publishes one feature-id namespace across both
    images, estimator_node.cpp:292-312)."""

    def __init__(self):
        self.next = 0

    def take(self, k: int) -> int:
        s = self.next
        self.next += int(k)
        return s


class FrontEnd:
    def __init__(
        self,
        camera,
        image_size,  # (H, W)
        max_cnt: int = 200,
        min_dist: int = 20,
        n_slots: int = 256,
        equalize: bool = True,
        annulus=None,  # (center_x, center_y, max_r, min_r) or None
        n_levels: int = 3,
        border: int = 1,
        dtype=jnp.float32,
        seed: int = 0,
        refine_win: int = 15,  # small-window level-0 refinement: the 41-px
        # window averages the curved PAL flow field (~0.6 px mean bias on
        # the synthetic rig, measured vs exact ray-traced flow); a final
        # 15-px pass cuts it to ~0.18 px. 0 disables (pure reference
        # behavior).
        id_counter: IdCounter | None = None,  # shared across cameras
    ):
        # Persistent array state that the jitted programs close over is
        # HOST (numpy): it is baked into the executable as a trace constant.
        # Live device state (slot chain, pyramids, keys) is passed as
        # explicit jit arguments.
        self.camera = jax.tree_util.tree_map(np.asarray, camera)
        self.H, self.W = image_size
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.N = n_slots
        self.equalize = equalize
        self.n_levels = n_levels
        self.border = border
        self.dtype = dtype
        self.refine_win = int(refine_win)
        if annulus is not None:
            self.static_mask = np.asarray(annulus_mask(
                image_size, *[float(a) for a in annulus], dtype=dtype
            ))
        else:
            self.static_mask = np.ones(image_size, bool)
        self.static_mask_np = self.static_mask

        # Host slot state (id bookkeeping; may lag the device chain by one
        # frame — see dispatch()).
        self.pos = np.zeros((self.N, 2), np.float64)
        self.ids = np.full(self.N, -1, np.int64)
        self.track_cnt = np.zeros(self.N, np.int64)
        self._ids_src = id_counter if id_counter is not None else IdCounter()
        self.prev_pyr = None
        self.prev_time = None
        self.prev_bearing = np.zeros((self.N, 3))
        self.prev_has_bearing = np.zeros(self.N, bool)
        self.key = jax.random.PRNGKey(seed)
        # Device-resident slot chain: (pos [N,2], valid [N]) live on device
        # and feed the NEXT frame's step directly, so dispatch(k+1) has no
        # data dependency on finalize(k) — the host can harvest results a
        # full frame later without stalling the dispatch path.
        self._dev_pos = None
        self._dev_valid = None

        # ONE fused program per frame: preprocessing (CLAHE + pyramid), the
        # RNG-key advance, and the full track/reject/detect/lift step — one
        # dispatch per frame instead of three.
        self._pre = jax.jit(self._preprocess)  # kept for tools/tests
        self._first = jax.jit(self._first_impl)
        self._step = jax.jit(self._step_impl, static_argnames=("publish",))

    def reset(self):
        """Drop all tracking state (stream restart — the tracker side of
        feature_tracker_node.cpp:38-48). Jitted functions stay cached."""
        self.pos[:] = 0.0
        self.ids[:] = -1
        self.track_cnt[:] = 0
        self.prev_pyr = None
        self.prev_time = None
        self.prev_bearing = np.zeros((self.N, 3))
        self.prev_has_bearing = np.zeros(self.N, bool)
        self._dev_pos = None
        self._dev_valid = None

    # ------------------------------------------------------------- device fns
    def _preprocess(self, img):
        # Accepts uint8 (preferred: 4x smaller host->device transfer) or float.
        img = img.astype(self.dtype)
        if self.equalize:
            img = clahe(img)
        return tuple(gaussian_pyramid(img, self.n_levels))

    def _lift(self, pts):
        rays = self.camera.lift_projective(pts)
        return rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)

    def _assign_slots(self, pos_tracked, status, new_pts, new_ok):
        """Vectorized device-side slot refill (the reference's
        goodFeaturesToTrack refill policy, feature_tracker.cpp:158-170):
        surviving features keep their slots; up to max_cnt − n_alive
        accepted detections fill the lowest-index free slots in detection
        order. Runs on device so the slot chain (pos, valid) never touches
        the host — dispatch(k+1) needs no finalize(k).

        Returns (pos_next [N,2], valid_next [N], new_src [N] int32 — the
        detection index placed in each slot, −1 if none)."""
        N = self.N
        M = new_pts.shape[0]
        idxN = jnp.arange(N)
        idxM = jnp.arange(M)
        n_alive = jnp.sum(status)
        n_new = jnp.clip(
            jnp.minimum(self.max_cnt - n_alive, N - n_alive), 0, None
        )
        take = jnp.minimum(n_new, jnp.sum(new_ok))
        # Free slots ascending; accepted detections in detection order.
        slot_order = jnp.argsort(jnp.where(~status, idxN, N + idxN))
        new_order = jnp.argsort(jnp.where(new_ok, idxM, M + idxM))
        r = idxM
        dst = slot_order[:M]
        src = new_order
        maskr = r < take
        pos_next = jnp.where(status[:, None], pos_tracked, 0.0)
        pos_next = pos_next.at[dst].set(
            jnp.where(maskr[:, None], new_pts[src], pos_next[dst])
        )
        valid_next = status.at[dst].set(status[dst] | maskr)
        new_src = jnp.full((N,), -1, jnp.int32).at[dst].set(
            jnp.where(maskr, src.astype(jnp.int32), -1)
        )
        return pos_next, valid_next, new_src

    def _first_impl(self, img):
        """First frame: preprocess + detect + place into slots, one fused
        program."""
        pyr = self._preprocess(img)
        static_mask = jnp.asarray(self.static_mask)  # numpy -> trace constant
        resp = shi_tomasi_response(pyr[0])
        new_pts, new_ok = select_features(
            resp, static_mask,
            jnp.zeros((1, 2), self.dtype), jnp.zeros((1,), bool),
            self.max_cnt, self.min_dist,
        )
        pos0, valid0, new_src = self._assign_slots(
            jnp.zeros((self.N, 2), self.dtype),
            jnp.zeros((self.N,), bool), new_pts, new_ok,
        )
        return pyr, pos0, valid0, (pos0, valid0, new_src)

    def _step_impl(self, pyr_prev, img, pos, valid, key, publish: bool):
        """Fused per-frame device step: preprocess (CLAHE + pyramid), RNG
        advance, pyramidal LK, rejection, refill detection, bearing lift —
        ONE program.

        Returns (pyr, pos_next, valid_next, key_next, host_outs): pyr /
        pos / valid / key continue the device-resident chain; host_outs =
        (status, new_src, pos_next, bear_next, valid_next) is everything
        the (possibly one-frame-late) host bookkeeping needs.
        """
        pyr = self._preprocess(img)
        key_next, sub = jax.random.split(key)
        pts_next, ok = pyramidal_lk(
            list(pyr_prev), list(pyr), pos, valid, self.n_levels,
            refine_win=self.refine_win,
        )
        # Border containment (inBorder, BORDER_SIZE=1) + annulus mask.
        static_mask = jnp.asarray(self.static_mask)  # numpy -> trace constant
        b = float(self.border)
        inb = (
            (pts_next[:, 0] >= b) & (pts_next[:, 0] < self.W - b)
            & (pts_next[:, 1] >= b) & (pts_next[:, 1] < self.H - b)
        )
        ix = jnp.clip(pts_next[:, 0].astype(jnp.int32), 0, self.W - 1)
        iy = jnp.clip(pts_next[:, 1].astype(jnp.int32), 0, self.H - 1)
        status = ok & inb & static_mask[iy, ix]

        if publish:
            # Spherical RANSAC on prev vs cur bearings (rejectWithF).
            b_prev = self._lift(pos)
            b_cur = self._lift(pts_next)
            _, inl = spherical_ransac_e(sub, b_prev, b_cur, status)
            enough = jnp.sum(status) >= 8
            status = jnp.where(enough, status & inl, status)

            # Refill detection on the masked response (uses post-reject pts).
            resp = shi_tomasi_response(pyr[0])
            new_pts, new_ok = select_features(
                resp, static_mask, pts_next, status,
                self.max_cnt, self.min_dist,
            )
            pos_next, valid_next, new_src = self._assign_slots(
                pts_next, status, new_pts, new_ok
            )
        else:
            pos_next = jnp.where(status[:, None], pts_next, 0.0)
            valid_next = status
            new_src = jnp.full((self.N,), -1, jnp.int32)

        bear_next = self._lift(pos_next)
        return pyr, pos_next, valid_next, key_next, (
            status, new_src, pos_next, bear_next, valid_next
        )

    # ----------------------------------------------------------------- frame
    def dispatch(self, img, t: float, publish: bool = True):
        """Launch the frame's device work WITHOUT synchronizing. Returns an
        opaque handle; pass it (plus, optionally, the already-fetched host
        values of ``handle[2]``) to :meth:`finalize`.

        The device-resident slot chain (pos, valid) advances HERE, at
        dispatch time — dispatch(k+1) consumes dispatch(k)'s device outputs
        directly, with no host round trip in between. finalize() only does
        id/track-count bookkeeping on the fetched copies and may therefore
        run a full frame later (the pipeline's depth-N schedule).
        """
        img_dev = jnp.asarray(img)
        if self._dev_pos is None:
            pyr, pos0, valid0, outs = self._first(img_dev)
            self.prev_pyr = pyr
            self._dev_pos, self._dev_valid = pos0, valid0
            return ("first", pyr, outs, t, publish)

        pyr, pos_next, valid_next, key_next, outs = self._step(
            self.prev_pyr, img_dev, self._dev_pos, self._dev_valid, self.key,
            publish=publish,
        )
        self.prev_pyr = pyr
        self.key = key_next
        self._dev_pos, self._dev_valid = pos_next, valid_next
        return ("step", pyr, outs, t, publish)

    def process_arrays(self, img: np.ndarray, t: float, publish: bool = True):
        """Run one frame synchronously. Returns (ids [N], bearings [N,3],
        vels [N,3], rows [N], pub_mask [N]) over the slot arrays — pub_mask
        selects the features the reference would publish (track_cnt > 1,
        feature_tracker_node.cpp:113-179) — or None on the first frame /
        when publish=False.

        Host bookkeeping is fully vectorized numpy; device work is one fused
        jitted call and one batched device_get.
        """
        return self.finalize(self.dispatch(img, t, publish))

    def finalize(self, handle, host_outs=None):
        """Complete a dispatched frame: device_get (unless the caller already
        fetched ``handle[2]``) + host id/track-count bookkeeping. May run a
        full frame after the dispatch — the device chain has already moved
        on; everything here operates on the fetched copies."""
        kind, pyr, outs, t, publish = handle
        if host_outs is None:
            host_outs = jax.device_get(outs)

        if kind == "first":
            pos0, valid0, new_src = host_outs
            valid0 = np.asarray(valid0)
            k = int(valid0.sum())
            slots = np.where(valid0)[0]
            self.pos = np.asarray(pos0, np.float64)
            s0 = self._ids_src.take(k)
            self.ids[slots] = np.arange(s0, s0 + k)
            self.track_cnt[slots] = 1
            self.prev_time = t
            self.prev_bearing = np.zeros((self.N, 3))
            self.prev_has_bearing = np.zeros(self.N, bool)
            return None

        status, new_src, pos_next, bear_next, valid_next = host_outs
        status = np.asarray(status) & (self.ids >= 0)
        new_src = np.asarray(new_src)
        pos_next = np.asarray(pos_next, np.float64)
        bear_next = np.asarray(bear_next, np.float64)

        # Free failed slots; advance survivors (vectorized).
        failed = (self.ids >= 0) & ~status
        self.ids[failed] = -1
        self.track_cnt[failed] = 0
        self.prev_has_bearing[failed] = False
        self.pos = pos_next
        self.track_cnt[status] += 1

        # Id assignment for device-chosen refill slots. Slots ascend with
        # detection order, so ids keep the reference's detection ordering.
        new_slots = np.where(new_src >= 0)[0]
        if publish and len(new_slots):
            s0 = self._ids_src.take(len(new_slots))
            self.ids[new_slots] = np.arange(s0, s0 + len(new_slots))
            self.track_cnt[new_slots] = 1
        valid = self.ids >= 0

        cur_bearing = np.where(valid[:, None], bear_next, 0.0)
        has_prev = self.prev_has_bearing & status

        # 3-D bearing velocities per slot (undistortedPoints semantics:
        # Δbearing/Δt for features tracked from the previous frame).
        dt = t - self.prev_time if self.prev_time is not None else 0.0
        vels = np.zeros((self.N, 3))
        if dt > 0:
            vels[has_prev] = (
                cur_bearing[has_prev] - self.prev_bearing[has_prev]
            ) / dt

        pub_mask = valid & (self.track_cnt > 1) if publish else None

        self.prev_time = t
        self.prev_bearing = cur_bearing
        self.prev_has_bearing = valid.copy()
        if not publish:
            return None
        return self.ids.copy(), cur_bearing, vels, self.pos[:, 1].copy(), pub_mask

    def process(self, img: np.ndarray, t: float, publish: bool = True):
        """Dict-interface wrapper over process_arrays: id -> (bearing3, vel3,
        row) for published features (kept for tests/tools; the pipeline uses
        the array interface)."""
        out = self.process_arrays(img, t, publish)
        if out is None:
            return None
        ids, bearings, vels, rows, pub = out
        return {
            int(ids[s]): (bearings[s].copy(), vels[s].copy(), float(rows[s]))
            for s in np.where(pub)[0]
        }


class DualFrontEnd:
    """Image-level dual-PAL (two-camera) frontend: two FrontEnds with a
    SHARED feature-id space, driven by one pipeline on (img_up, img_down)
    frame tuples. The runtime half of the BASELINE ID06/ID10 dual-PAL rigs:
    each camera runs its own full device program (CLAHE + pyramid + KLT +
    RANSAC + refill against its own annulus mask); the published arrays are
    the concatenation over cameras with a per-observation camera-id column
    (the reference's per-entry camera id protocol,
    estimator_node.cpp:292-312). Both device programs are dispatched
    back-to-back — they pipeline on the device queue like any two frames.
    """

    def __init__(self, fe0: FrontEnd, fe1: FrontEnd):
        # Rebind both trackers to one id sequence (ids already handed out
        # by fe1's own counter would collide with fe0's).
        shared = fe0._ids_src
        fe1._ids_src = shared
        self.fes = (fe0, fe1)

    def reset(self):
        for fe in self.fes:
            fe.reset()

    def dispatch(self, imgs, t: float, publish: bool = True):
        h0 = self.fes[0].dispatch(imgs[0], t, publish=publish)
        h1 = self.fes[1].dispatch(imgs[1], t, publish=publish)
        # handle[2] is the pipeline's fetch tree (both cameras' outs ride
        # one fetch).
        return ("dual", (h0, h1), (h0[2], h1[2]), t, publish)

    def finalize(self, handle, host_outs=None):
        _, (h0, h1), outs, t, publish = handle
        if host_outs is None:
            import jax

            host_outs = jax.device_get(outs)
        o0 = self.fes[0].finalize(h0, host_outs[0])
        o1 = self.fes[1].finalize(h1, host_outs[1])
        if o0 is None or o1 is None:
            return None
        ids = np.concatenate([o0[0], o1[0]])
        bearings = np.concatenate([o0[1], o1[1]])
        vels = np.concatenate([o0[2], o1[2]])
        rows = np.concatenate([o0[3], o1[3]])
        pub = np.concatenate([o0[4], o1[4]])
        cams = np.concatenate([
            np.zeros(len(o0[0]), np.int32), np.ones(len(o1[0]), np.int32),
        ])
        return ids, bearings, vels, rows, pub, cams

    def process_arrays(self, imgs, t: float, publish: bool = True):
        return self.finalize(self.dispatch(imgs, t, publish))
