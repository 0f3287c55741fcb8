"""lfvio_tpu — an accelerator-native visual-inertial odometry framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of LF-VIO
(flysoaryun/LF-VIO, IROS 2022): large-FoV panoramic-annular-lens VIO with
unit-bearing-sphere geometry, IMU preintegration, and sliding-window
bundle adjustment with Schur-complement marginalization.

Design principles (not a port):
  * All device state lives in pytrees with static shapes; feature churn is
    handled with fixed slots + validity masks.
  * The per-frame hot path (feature tracking, preintegration, Gauss-Newton/
    dogleg bundle adjustment) is one jitted function; data-dependent policy
    (keyframe choice, init success, failure reset) stays on the host.
  * Multi-card scaling via jax.sharding.Mesh + shard_map with psum/all_gather
    collectives; no per-node processes, no message passing runtime.
"""

__version__ = "0.1.0"
