"""Unified-config wiring: the `frontend:` section drives BagConfig, the top
level drives PipelineConfig, the alignment profile parses the reference's
schema."""

import os

import numpy as np
import pytest

from gcslam_tpu.frontend import rosbag
from gcslam_tpu.frontend.time_alignment import TopicAlignment, load_alignment
from gcslam_tpu.models.config import config_from_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIMERA_CFG = os.path.join(REPO, "configs", "gc_kimera.yaml")


def test_kimera_yaml_pipeline_config():
    cfg = config_from_file(KIMERA_CFG)
    assert cfg.with_camera is True
    assert cfg.n_surfel == 512


def test_kimera_yaml_bag_config():
    bc = rosbag.bag_config_from_file(KIMERA_CFG)
    assert bc is not None
    assert bc.lidar_topic == "/acl_jackal/lidar_points"
    assert bc.rgb_topic.endswith("/compressed")
    assert len(bc.T_base_lidar) == 6 and bc.T_base_lidar[0] != 0.0
    assert len(bc.camera_intrinsics) == 4
    assert bc.with_camera is True
    # alignment profile resolved relative to the config file and parsed
    assert bc.alignment is not None
    a = bc.alignment["/acl_jackal/forward/imu"]
    assert a.t0_sec > 1e9 and abs(a.offset_sec) < 1e-3


def test_bag_config_unknown_key_failfast():
    with pytest.raises(ValueError, match="unknown BagConfig keys"):
        rosbag.bag_config_from_dict({"lidar_topik": "/x"})
    with pytest.raises(ValueError, match="6 entries"):
        rosbag.bag_config_from_dict({"T_base_lidar": [1, 2, 3]})


def test_alignment_model_matches_reference():
    """aligned = t + offset + drift * (t - t0): at t = t0 only the offset
    applies; drift accumulates per second away from t0."""
    a = TopicAlignment(offset_sec=-0.01, drift=1e-4, t0_sec=1000.0)
    assert abs(a.apply(np.asarray(1000.0)) - 999.99) < 1e-12
    assert abs(a.apply(np.asarray(1060.0)) - (1060.0 - 0.01 + 1e-4 * 60)) < 1e-9


def test_alignment_loader_flat_schema(tmp_path):
    p = tmp_path / "flat.json"
    p.write_text('{"/imu": {"offset_sec": 0.5, "drift": 1e-6, "t0_sec": 10.0}}')
    out = load_alignment(str(p))
    assert out["/imu"].offset_sec == 0.5 and out["/imu"].t0_sec == 10.0
    bad = tmp_path / "bad.json"
    bad.write_text('{"/imu": {"offzet": 1}}')
    with pytest.raises(ValueError, match="unknown alignment"):
        load_alignment(str(bad))


def test_eval_run_with_config_and_bag(tmp_path):
    """eval.run --bag --config: BagConfig flows from YAML into load_bag."""
    from tests.test_rosbag import _make_bag

    bag = str(tmp_path / "t.db3")
    _make_bag(bag, n_scans=3)
    cfgp = tmp_path / "run.yaml"
    cfgp.write_text(
        """
with_map: true
atlas_max_tiles: 8
m_tile: 64
m_tile_view: 32
n_surfel: 64
surfel_voxel_size_m: 0.5
frontend:
  lidar_topic: /lidar/points
  imu_topic: /imu/data
  odom_topic: /odom
  T_base_lidar: [0.1, 0.0, 0.0, 0.0, 0.0, 0.0]
"""
    )
    from gcslam_tpu.eval import run as run_mod

    out = str(tmp_path / "res")
    metrics = run_mod.main([
        "--bag", bag, "--config", str(cfgp), "--out", out, "--points", "512",
    ])
    assert metrics["n_scans"] == 3
    assert os.path.exists(os.path.join(out, "trajectory.tum"))
