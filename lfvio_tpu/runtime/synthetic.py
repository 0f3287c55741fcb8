"""Synthetic VIO world: rendered camera frames + exact IMU + ground truth.

There is no public dataset vendored in this environment, so end-to-end
validation and benchmarking use a synthetic rig: a procedurally textured
cylindrical room viewed by any of our camera models along an analytic
trajectory, with IMU measurements derived in closed form from the
trajectory — pixel-exact rendering, physically consistent inertial data,
and perfect ground truth.

Rendering is inverse-mapped on device: pixel → camera ray (the camera
model's lift) → world ray → closest cylinder/plane hit → smooth procedural
texture. The annulus of a PAL camera sees the full 360° of the room,
exercising the negative half-plane exactly like the real sensor.

All trajectory/IMU math is CLOSED-FORM numpy f64 (the trajectory is a sum
of sinusoids; body rates come from the exact SO(3) right Jacobian), so
generating a full stream costs microseconds per sample with zero device
dispatches and zero jit compiles. Only rendering runs on the device.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..cam import ScaramuzzaCamera


def _ftype():
    """Widest float the runtime allows — f64 under x64 (tests), else f32.
    Requesting f64 with x64 disabled only warns and truncates; don't."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def fit_inverse_poly(poly, max_rho=210.0, n_coeffs=20, n_samples=400):
    """Fit inv_poly(theta) -> rho for an OCAM forward polynomial, mirroring
    the reference calibration's inverse-poly refit
    (camera_model/src/camera_models/ScaramuzzaCamera.cc:224-601)."""
    rhos = np.linspace(1.0, max_rho, n_samples)
    z = np.polyval(poly[::-1], rhos)
    theta = np.arctan2(z, rhos)  # note: z here = -P_z (lift uses -z)
    ok = np.isfinite(theta)
    A = np.vander(theta[ok], n_coeffs, increasing=True)
    coef, *_ = np.linalg.lstsq(A, rhos[ok], rcond=None)
    return coef


# Annulus of the synthetic PAL rig (pixels): covers elevations from ~+40deg
# (inner radius, z>0) through the equator to ~-40deg (outer radius, z<0).
SYN_MIN_R = 64.0
SYN_MAX_R = 190.0


def make_synthetic_pal_camera(width=512, height=384, dtype=None):
    """A small Scaramuzza PAL camera with a fitted inverse polynomial.

    The forward polynomial is the mindvision PAL calibration
    (config/mindvision/mindvision.yaml) radially rescaled by 0.4 to this
    image size, so the annulus genuinely spans the negative half-plane."""
    dtype = dtype or _ftype()
    sc = 0.4
    base = np.array([-2.445239e2, 0.0, 1.748610e-3, -1.757770e-6, 4.475965e-9])
    poly = base / sc ** np.arange(5)
    inv_poly = fit_inverse_poly(poly)
    return ScaramuzzaCamera(
        poly=jnp.asarray(poly, dtype),
        inv_poly=jnp.asarray(inv_poly, dtype),
        C=jnp.asarray(1.0, dtype),
        D=jnp.asarray(0.0, dtype),
        E=jnp.asarray(0.0, dtype),
        cx=jnp.asarray(width / 2.0, dtype),
        cy=jnp.asarray(height / 2.0, dtype),
    )



# Full-scale PAL rig (BASELINE.md): the mindvision calibration at its native
# 1280×960, and the annulus (cx, cy, max_r, min_r) its tracker masks with.
MINDVISION_SIZE = (960, 1280)  # (H, W)
MINDVISION_ANNULUS = (640.0, 480.0, 500.0 * 0.95, 160.0)


def make_mindvision_pal_camera(dtype=None):
    """The mindvision PAL calibration (config/mindvision/mindvision.yaml)
    at native resolution, with a fitted inverse polynomial."""
    dtype = dtype or _ftype()
    H, W = MINDVISION_SIZE
    base = np.array([-2.445239e2, 0.0, 1.748610e-3, -1.757770e-6, 4.475965e-9])
    inv_poly = fit_inverse_poly(base, max_rho=510.0)
    return ScaramuzzaCamera(
        poly=jnp.asarray(base, dtype),
        inv_poly=jnp.asarray(inv_poly, dtype),
        C=jnp.asarray(1.0, dtype),
        D=jnp.asarray(0.0, dtype),
        E=jnp.asarray(0.0, dtype),
        cx=jnp.asarray(W / 2.0, dtype),
        cy=jnp.asarray(H / 2.0, dtype),
    )

# ------------------------------------------------------------ SO(3) (numpy)
def _np_so3_exp(th):
    """Rotation-vector exponential → quaternion (wxyz), batched [..., 3]."""
    th = np.asarray(th, np.float64)
    a = np.linalg.norm(th, axis=-1, keepdims=True)
    half = 0.5 * a
    small = a < 1e-12
    k = np.where(small, 0.5, np.sin(half) / np.where(small, 1.0, a))
    w = np.cos(half)
    return np.concatenate([w, k * th], axis=-1)


def _np_quat_to_mat(q):
    """Quaternion (wxyz) → rotation matrix, batched [..., 4] → [..., 3, 3]."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _np_so3_right_jac(th):
    """Right Jacobian of SO(3): ω_body = Jr(θ) · θ̇ for q(t)=Exp(θ(t)).
    Batched [..., 3] → [..., 3, 3]."""
    th = np.asarray(th, np.float64)
    a = np.linalg.norm(th, axis=-1)
    shape = th.shape[:-1]
    W = np.zeros(shape + (3, 3))
    W[..., 0, 1] = -th[..., 2]
    W[..., 0, 2] = th[..., 1]
    W[..., 1, 0] = th[..., 2]
    W[..., 1, 2] = -th[..., 0]
    W[..., 2, 0] = -th[..., 1]
    W[..., 2, 1] = th[..., 0]
    a2 = a * a
    small = a < 1e-6
    safe = np.where(small, 1.0, a)
    c1 = np.where(small, 0.5 - a2 / 24.0, (1 - np.cos(a)) / (safe * safe))
    c2 = np.where(
        small, 1.0 / 6.0 - a2 / 120.0, (safe - np.sin(safe)) / safe**3
    )
    eye = np.broadcast_to(np.eye(3), shape + (3, 3))
    return eye - c1[..., None, None] * W + c2[..., None, None] * (W @ W)


@dataclasses.dataclass
class SyntheticWorld:
    camera: object
    width: int = 512
    height: int = 384
    room_radius: float = 6.0
    room_half_height: float = 3.0
    g_norm: float = 9.81
    seed: int = 0
    # trajectory scale knobs
    traj_amp: float = 0.8
    traj_freq: float = 0.25

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n_waves = 24
        npft = np.dtype(jnp.dtype(_ftype()).name)
        # HOST (numpy) constants only: the render program closes over these
        # and the camera, and numpy arrays become trace constants (see
        # runtime/tracker.py FrontEnd.__init__).
        self.camera = jax.tree_util.tree_map(np.asarray, self.camera)
        self._freqs = np.asarray(rng.uniform(0.8, 6.0, (n_waves, 3)), npft)
        self._phases = np.asarray(rng.uniform(0, 2 * np.pi, n_waves), npft)
        self._amps = np.asarray(
            rng.uniform(0.5, 1.0, n_waves) / np.arange(1, n_waves + 1) ** 0.25,
            npft,
        )
        self._render = jax.jit(self._render_impl)
        self._render_u8 = jax.jit(
            lambda R, t: (self._render_impl(R, t) + 0.5).astype(jnp.uint8)
        )
        w = self.traj_freq * 2 * np.pi
        A = self.traj_amp
        # p(t) = P_AMP * sin(P_W t + P_PH) per axis (closed-form derivs).
        self._P_AMP = np.array([A, 0.8 * A, 0.3])
        self._P_W = np.array([w, 0.7 * w, 1.3 * w])
        self._P_PH = np.array([0.0, 0.5, 0.0])
        # θ(t) = T_AMP * sin(T_W t + T_PH) per axis; slow yaw sweep on z.
        self._T_AMP = np.array([0.12, 0.12, 0.8])
        self._T_W = np.array([0.9 * w, 0.6 * w, 0.33 * w])
        self._T_PH = np.array([0.0, 1.0, 0.0])

    # ------------------------------------------------------------- trajectory
    # All closed-form numpy f64; t may be a scalar or an array [...].
    def _p_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._P_AMP * np.sin(self._P_W * t + self._P_PH)

    def _v_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._P_AMP * self._P_W * np.cos(self._P_W * t + self._P_PH)

    def _a_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return -self._P_AMP * self._P_W**2 * np.sin(self._P_W * t + self._P_PH)

    def _theta_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._T_AMP * np.sin(self._T_W * t + self._T_PH)

    def _thetadot_of_t(self, t):
        t = np.asarray(t, np.float64)[..., None]
        return self._T_AMP * self._T_W * np.cos(self._T_W * t + self._T_PH)

    def pose(self, t):
        """Analytic ground truth: position, orientation quaternion (wxyz)."""
        return self._p_of_t(t), _np_so3_exp(self._theta_of_t(t))

    def pose_batch(self, ts):
        """Ground truth for many timestamps at once (numpy, exact)."""
        ts = np.asarray(ts, np.float64)
        return self._p_of_t(ts), _np_so3_exp(self._theta_of_t(ts))

    def velocity(self, t):
        return self._v_of_t(t)

    def imu_batch(self, ts):
        """Exact accelerometer & gyroscope for all timestamps ts: a_body =
        Rᵀ(a_w + g); ω_body = Jr(θ)·θ̇ (exact for q(t) = Exp(θ(t)))."""
        ts = np.asarray(ts, np.float64)
        th = self._theta_of_t(ts)
        R = _np_quat_to_mat(_np_so3_exp(th))
        a_w = self._a_of_t(ts) + np.array([0.0, 0.0, self.g_norm])
        acc_body = np.einsum("...ji,...j->...i", R, a_w)
        om = np.einsum("...ij,...j->...i", _np_so3_right_jac(th),
                       self._thetadot_of_t(ts))
        return acc_body, om

    def imu_sample(self, t):
        acc, om = self.imu_batch(np.asarray([t]))
        return acc[0], om[0]

    # --------------------------------------------------------------- texture
    def _texture(self, X):
        phase = jnp.einsum("kc,...c->...k", self._freqs, X) + self._phases
        vals = jnp.einsum("k,...k->...", self._amps, jnp.sin(phase))
        return 128.0 + 100.0 * jnp.tanh(0.3 * vals)

    # --------------------------------------------------------------- render
    def _render_impl(self, R_wc, t_wc):
        ft = _ftype()
        H, W = self.height, self.width
        yy, xx = jnp.meshgrid(
            jnp.arange(H, dtype=ft), jnp.arange(W, dtype=ft),
            indexing="ij",
        )
        pix = jnp.stack([xx, yy], axis=-1).reshape(-1, 2)
        rays = self.camera.lift_projective(pix)
        rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
        d = rays @ R_wc.T  # world directions
        o = t_wc

        # Cylinder x^2 + y^2 = R^2 intersection.
        Rc = self.room_radius
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = 2 * (o[0] * d[:, 0] + o[1] * d[:, 1])
        c = o[0] ** 2 + o[1] ** 2 - Rc * Rc
        disc = jnp.maximum(b * b - 4 * a * c, 0.0)
        s_cyl = (-b + jnp.sqrt(disc)) / jnp.maximum(2 * a, 1e-12)
        s_cyl = jnp.where((a > 1e-12) & (s_cyl > 0), s_cyl, 1e9)
        # Ceiling / floor planes z = ±h.
        h = self.room_half_height
        s_top = jnp.where(d[:, 2] > 1e-9, (h - o[2]) / d[:, 2], 1e9)
        s_bot = jnp.where(d[:, 2] < -1e-9, (-h - o[2]) / d[:, 2], 1e9)
        s = jnp.minimum(jnp.minimum(s_cyl, s_top), s_bot)
        X = o[None, :] + s[:, None] * d
        img = self._texture(X).reshape(H, W)
        return jnp.clip(img, 0.0, 255.0)

    def render(self, t):
        p, q = self.pose(t)
        ft = _ftype()
        return np.asarray(
            self._render(jnp.asarray(_np_quat_to_mat(q), ft),
                         jnp.asarray(p, ft))
        )

    def render_u8(self, t):
        """Render directly to uint8 on device (4x smaller device→host
        transfer than f32): a host frame as a camera driver hands it over."""
        p, q = self.pose(t)
        ft = _ftype()
        return np.asarray(
            self._render_u8(jnp.asarray(_np_quat_to_mat(q), ft),
                            jnp.asarray(p, ft))
        )

    def render_rig(self, t, ric, tic):
        """Render from a camera mounted at (ric, tic) in the IMU frame —
        e.g. the DOWN camera of a dual-PAL rig (ric = diag(1,-1,-1))."""
        p, q = self.pose(t)
        R_wi = _np_quat_to_mat(q)
        R_wc = R_wi @ np.asarray(ric, np.float64)
        t_wc = p + R_wi @ np.asarray(tic, np.float64)
        ft = _ftype()
        return np.asarray(
            self._render(jnp.asarray(R_wc, ft), jnp.asarray(t_wc, ft))
        )

    # ----------------------------------------------------------- full dataset
    def generate(self, duration, frame_rate=15.0, imu_rate=200.0):
        """Returns a measurement stream: ('imu', t, acc, gyr) and
        ('frame', t, None) tuples in time order. Closed-form numpy —
        generation is O(microseconds) per sample."""
        n_imu = int(duration * imu_rate) + 1
        ts = np.arange(n_imu) / imu_rate
        acc, om = self.imu_batch(ts)
        stream = [
            ("imu", float(ts[k]), acc[k], om[k]) for k in range(n_imu)
        ]
        n_frames = int(duration * frame_rate)
        for k in range(n_frames):
            t = k / frame_rate + 1e-4  # frames slightly after an IMU tick
            stream.append(("frame", t, None))
        stream.sort(key=lambda e: e[1])
        return stream
