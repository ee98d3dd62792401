"""Dead-end classifier tests (reference /gc/dead_end_status consumed by
frontend/audit/wiring_auditor.py:37-265)."""

import json

import numpy as np

from gcslam_tpu.models import runner
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig


def test_monitor_unit_flags():
    m = runner.DeadEndMonitor(pose_eps_m=0.02, stall_windows=2,
                              trigger_ratio=3.0, ess_floor=1.0)
    # moving pose, healthy scans (a steady high trigger baseline — every scan
    # fires dozens of DECLARED approximation triggers): no flags
    assert m.update([0.0, 0, 0], 70.0, 50.0, 100.0) == []
    assert m.update([0.5, 0, 0], 72.0, 50.0, 100.0) == []
    # pose freezes with data flowing: stall fires after `stall_windows`
    assert m.update([0.5, 0, 0], 71.0, 50.0, 100.0) == []
    assert "stalled_pose" in m.update([0.5001, 0, 0], 70.0, 50.0, 100.0)
    # movement resets the stall counter
    assert "stalled_pose" not in m.update([1.5, 0, 0], 72.0, 50.0, 100.0)
    # trigger EXPLOSION (vs the run's own baseline) + zero ESS both flag
    flags = m.update([2.5, 0, 0], 400.0, 0.1, 100.0)
    assert "exploding_triggers" in flags and "zero_ess" in flags
    # steady baseline never flags, however high in absolute terms
    m3 = runner.DeadEndMonitor()
    for k in range(6):
        assert "exploding_triggers" not in m3.update([k * 1.0, 0, 0], 500.0, 50.0, 100.0)
    # pose frozen but NO data flowing = stream starvation, not a stall
    m2 = runner.DeadEndMonitor(stall_windows=1)
    m2.update([0, 0, 0], 0.0, 50.0, 0.0)
    assert "stalled_pose" not in m2.update([0, 0, 0], 0.0, 50.0, 0.0)


def test_stalled_filter_fires_in_status_stream(tmp_path):
    """Drive the filter into a stall (odometry frozen at the origin while
    LiDAR data keeps flowing) and assert the status stream raises the flag."""
    run = generate(SyntheticConfig(n_scans=8, n_points=256))
    zero6 = np.zeros(6)
    stall_cov = np.eye(6) * 1e-4
    batches = [
        b._replace(
            odom_pose=b.odom_pose * 0.0,
            odom_rel_pose=b.odom_rel_pose * 0.0,
            odom_cov=b.odom_cov * 0.0 + np.asarray(stall_cov, b.odom_cov.dtype),
            odom_rel_cov=b.odom_rel_cov * 0.0 + np.asarray(stall_cov, b.odom_rel_cov.dtype),
            odom_twist=b.odom_twist * 0.0,
        )
        for b in run.batches
    ]
    del zero6
    cfg = PipelineConfig(with_map=False)
    status = tmp_path / "status.jsonl"
    _, out = runner.run_stream(batches, cfg, status_path=str(status), status_every=1)
    lines = [json.loads(l) for l in status.read_text().splitlines()]
    assert len(lines) == len(batches)
    assert all("dead_end" in l for l in lines)
    # pose stalls at the origin -> the flag fires on later status points
    assert any("stalled_pose" in l["dead_end"] for l in lines[2:])
    # and the healthy start is not misflagged
    assert "stalled_pose" not in lines[0]["dead_end"]
