"""compute_time_alignment: recover a known offset+drift from a synthesized
bag and round-trip the profile through the frontend loader (the repo can
produce a profile, not only apply one)."""

import numpy as np

from gcslam_tpu.frontend.time_alignment import load_alignment
from gcslam_tpu.tools import compute_time_alignment as cta


def test_align_streams_recovers_offset_and_drift():
    t0 = 1000.0
    ref = t0 + np.arange(0, 60, 0.1)  # 10 Hz reference (lidar-like)
    # The nearest-stamp estimator (reference convention) senses misalignment
    # only within +-half the other stream's period (2.5 ms at 200 Hz) — use
    # a sub-period offset+accumulated drift, like the real Kimera profile.
    true_off, true_drift = 0.0015, 1e-5
    base = t0 + np.arange(0, 60, 0.005)
    other = base + true_off + true_drift * (base - t0)
    stats = cta.align_streams(ref, np.sort(other))
    assert abs(stats["offset_sec"] - (true_off + true_drift * 30)) < 5e-4
    assert abs(stats["drift_sec_per_sec"] - true_drift) < 5e-6


def test_compute_profile_roundtrip(tmp_path):
    from tests.test_rosbag import _make_bag

    bag = str(tmp_path / "a.db3")
    _make_bag(bag, n_scans=6)
    profile = cta.compute_profile(
        bag, reference="/lidar/points", topics=["/imu/data", "/odom"], duration=30.0
    )
    ta = profile["time_alignment"]
    assert ta["reference"] == "/lidar/points"
    assert set(ta["streams"]) == {"/imu/data", "/odom"}
    assert ta["t0_sec"] > 0

    out = tmp_path / "profile.yaml"
    cta.write_profile(profile, str(out))
    loaded = load_alignment(str(out))
    assert "/imu/data" in loaded
    a = loaded["/imu/data"]
    # synthetic bag is clock-consistent: offsets are sub-period
    assert abs(a.offset_sec) < 0.01
    assert a.t0_sec == ta["t0_sec"]
