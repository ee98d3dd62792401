"""f32-belief precision mode (GCSLAM_BELIEF_DTYPE=float32) — the gate on the
production configuration (bench.py and chip_smoke.py run f32; it is also the
precision of the fused Sinkhorn kernel).

The anchor-chart design keeps belief increments near zero, which makes f32
viable; absolute stamps stay f64 (TIME_DTYPE) so epoch-scale clocks
(~1.7e9 s) keep microsecond resolution.

Three gates:
  1. tracking parity vs f64 with epoch-scale stamps (map config);
  2. aggressive-motion stress (near-pi yaw excursions, 10x drift) stays
     finite with the certificate channel clean — no NonFiniteEvidence
     rejections, controls within declared bounds;
  3. loop-closure absorption in f32 — the late high-precision factor is the
     worst conditioning event the filter sees (1e-4 covariance against a
     drifted prior) and must still reduce drift without trigger storms.

The dtype binds at package import, so each run happens in a subprocess.
"""

import json
import os
import subprocess
import sys

import numpy as np

_RUNNER = r"""
import os, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import gcslam_tpu
import numpy as np
from gcslam_tpu.utils.xla import BELIEF_DTYPE, TIME_DTYPE, jnp
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import runner
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
from gcslam_tpu.ops.certs import TRIGGERS

MODE = os.environ["GCSLAM_PRECISION_TEST_MODE"]

if MODE == "track":
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=16, m_tile=128,
                         m_tile_view=64, n_surfel=128, surfel_voxel_size_m=0.5)
    # epoch-scale clock: exercises the TIME_DTYPE (f64 stamps) contract
    run = generate(SyntheticConfig(n_scans=30, n_points=512, t0=1.7e9))
    batches = run.batches
elif MODE == "stress":
    # aggressive motion: 1.2 rad/s yaw (near-pi excursions between scans'
    # anchor updates), fast ramp, 10x odometry drift
    cfg = PipelineConfig(with_map=False)
    run = generate(SyntheticConfig(n_scans=40, n_points=256, t0=1.7e9,
                                   speed_mps=1.5, turn_rate=1.2,
                                   odom_drift_pos_per_m=0.2,
                                   odom_drift_yaw_per_m=0.1, seed=11))
    batches = run.batches
elif MODE == "loop":
    cfg = PipelineConfig(with_map=False)
    run = generate(SyntheticConfig(n_scans=24, n_points=256, t0=1.7e9,
                                   odom_drift_pos_per_m=0.5,
                                   odom_drift_yaw_per_m=0.15, seed=9))
    batches = []
    for i, b in enumerate(run.batches):
        if i >= 18:
            b = b._replace(
                loop_pose=jnp.asarray(run.gt_poses[i], dtype=b.loop_pose.dtype),
                loop_cov=jnp.asarray(np.diag([1e-4] * 3 + [1e-5] * 3),
                                     dtype=b.loop_cov.dtype),
                loop_weight=jnp.ones((), dtype=b.loop_weight.dtype),
            )
        batches.append(b)

state, out = runner.run_bag(batches, cfg)
poses = np.asarray(out.pose)
gt = run.gt_poses[: poses.shape[0]]
err = np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1)
nonfinite_bit = TRIGGERS["NonFiniteEvidence"]
masks = np.asarray(out.tape.cert_triggers).astype(np.int64)
alpha = np.asarray(out.tape.fusion_alpha)
beta = np.asarray(out.tape.power_beta)
print(json.dumps({
    "dtype": str(jnp.dtype(BELIEF_DTYPE)),
    "time_dtype": str(jnp.dtype(TIME_DTYPE)),
    "finite": bool(np.all(np.isfinite(poses))),
    "xy_rmse": float(np.sqrt((err ** 2).mean())),
    "xy_last": float(err[-1]),
    "n_nonfinite_rejections": int(np.sum((masks & nonfinite_bit) != 0)),
    "alpha_ok": bool(np.all(np.isfinite(alpha)) and np.all(alpha > 0)),
    "beta_ok": bool(np.all(np.isfinite(beta)) and np.all(beta >= 0)
                    and np.all(beta <= 1.0 + 1e-5)),
}))
"""


def _run(belief_dtype: str, mode: str) -> dict:
    env = dict(os.environ)
    env["GCSLAM_BELIEF_DTYPE"] = belief_dtype
    env["GCSLAM_PRECISION_TEST_MODE"] = mode
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER], env=env, capture_output=True, text=True,
        timeout=900,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_f32_belief_mode_tracks_with_epoch_stamps():
    r32 = _run("float32", "track")
    assert r32["dtype"] == "float32"
    assert r32["time_dtype"] == "float64"  # stamps stay f64 regardless
    assert r32["finite"]
    assert r32["xy_last"] < 0.5, r32

    r64 = _run("float64", "track")
    assert r64["finite"]
    # f32 degradation is bounded: within 3 cm + 2x of the f64 error
    assert r32["xy_rmse"] < 2.0 * r64["xy_rmse"] + 0.03, (r32, r64)


def test_f32_stays_clean_under_aggressive_motion():
    """Near-pi yaw excursions + 10x drift: the f32 chart algebra must not
    trip the certified NaN rejection (a single false rejection means the
    f32 conditioning floor is wrong for production)."""
    r32 = _run("float32", "stress")
    assert r32["finite"], r32
    assert r32["n_nonfinite_rejections"] == 0, r32
    assert r32["alpha_ok"] and r32["beta_ok"], r32
    r64 = _run("float64", "stress")
    assert r32["xy_rmse"] < 2.0 * r64["xy_rmse"] + 0.05, (r32, r64)


def test_f32_absorbs_loop_closure():
    """A 1e-4-covariance loop factor against a drifted prior is the worst
    conditioning event in live operation; f32 must absorb it (drift drops)
    without NaN rejections, matching f64 within tolerance."""
    r32 = _run("float32", "loop")
    assert r32["finite"], r32
    assert r32["n_nonfinite_rejections"] == 0, r32
    assert r32["xy_last"] < 0.3, r32
    r64 = _run("float64", "loop")
    assert r32["xy_last"] < 2.0 * r64["xy_last"] + 0.05, (r32, r64)
