"""Real-bag RGB-D ingestion: synthesize a bag carrying CompressedImage RGB +
16UC1 depth next to the LiDAR/IMU/odom streams and check the camera path is
live end-to-end (cam_valid.sum() > 0 from a bag, and
the camera changes the trajectory)."""

import io
import sqlite3

import numpy as np
import pytest

from gcslam_tpu.frontend import cdr, images, rosbag
from tests.test_rosbag import _make_bag


def _checkerboard(h, w, sq=8):
    yy, xx = np.mgrid[0:h, 0:w]
    board = (((yy // sq) + (xx // sq)) % 2).astype(np.uint8) * 200 + 30
    rgb = np.stack([board, 255 - board, board], axis=-1).astype(np.uint8)
    return rgb


def _jpeg_bytes(rgb):
    from PIL import Image as PILImage

    b = io.BytesIO()
    PILImage.fromarray(rgb).save(b, "JPEG", quality=95)
    return b.getvalue()


def _add_camera_topics(path, n_frames=6, t0=100.05, dt=0.1, h=96, w=128):
    """Append /camera/color (jpeg CompressedImage) + /camera/depth (16UC1
    mm Image) to an existing bag."""
    conn = sqlite3.connect(path)
    conn.executemany(
        "INSERT INTO topics VALUES (?,?,?,?,?)",
        [
            (4, "/camera/color/compressed", "sensor_msgs/msg/CompressedImage", "cdr", ""),
            (5, "/camera/depth/image_raw", "sensor_msgs/msg/Image", "cdr", ""),
        ],
    )
    rgb = _checkerboard(h, w)
    depth_mm = np.full((h, w), 2000, dtype="<u2")  # flat wall at 2 m
    rows = []
    for i in range(n_frames):
        t = t0 + i * dt
        cm = cdr.CompressedImage(cdr.Header(t, "cam"), "rgb8; jpeg compressed bgr8",
                                 _jpeg_bytes(rgb[:, :, ::-1]))  # stored as bgr
        rows.append((4, int(t * 1e9), cdr.serialize_compressed_image(cm)))
        dm = cdr.Image(cdr.Header(t + 0.012, "cam"), h, w, "16UC1", False,
                       w * 2, depth_mm.tobytes())
        rows.append((5, int((t + 0.012) * 1e9), cdr.serialize_image(dm)))
    conn.executemany(
        "INSERT INTO messages(topic_id, timestamp, data) VALUES (?,?,?)", rows
    )
    conn.commit()
    conn.close()


INTR = (100.0, 100.0, 64.0, 48.0)


def test_image_cdr_roundtrip():
    h, w = 24, 32
    arr = (np.arange(h * w * 3) % 251).astype(np.uint8).reshape(h, w, 3)
    msg = cdr.Image(cdr.Header(7.25, "cam"), h, w, "rgb8", False, w * 3, arr.tobytes())
    out = cdr.parse_image(cdr.serialize_image(msg))
    assert out.encoding == "rgb8" and out.height == h and out.width == w
    np.testing.assert_array_equal(images.image_to_array(out), arr)
    assert abs(cdr.image_stamp(cdr.serialize_image(msg)) - 7.25) < 1e-6

    cm = cdr.CompressedImage(cdr.Header(3.5, "cam"), "jpeg", b"\xff\xd8rawbytes")
    out2 = cdr.parse_compressed_image(cdr.serialize_compressed_image(cm))
    assert out2.format == "jpeg" and out2.data == cm.data


def test_depth_decoding_paths():
    h, w = 10, 12
    mm = (np.arange(h * w) * 37 % 5000).astype("<u2").reshape(h, w)
    msg = cdr.Image(cdr.Header(0, ""), h, w, "16UC1", False, w * 2, mm.tobytes())
    d = images.depth_to_meters(msg)
    np.testing.assert_allclose(d, mm.astype(np.float32) * 0.001, rtol=1e-6)
    f = (np.arange(h * w, dtype="<f4") / 100).reshape(h, w)
    f[0, 0] = np.nan
    msg2 = cdr.Image(cdr.Header(0, ""), h, w, "32FC1", False, w * 4, f.tobytes())
    d2 = images.depth_to_meters(msg2)
    assert d2[0, 0] == 0.0 and abs(d2[5, 5] - f[5, 5]) < 1e-6


def test_jpeg_decode_native_matches_host():
    rgb = _checkerboard(32, 48)
    data = _jpeg_bytes(rgb)
    host = images._decode_host(data)
    msg = cdr.CompressedImage(cdr.Header(0, ""), "jpeg", data)
    out = images.decode_compressed(msg)
    assert out.shape == (32, 48, 3)
    # checkerboard survives jpeg q95 to within a few counts
    assert np.abs(out.astype(int) - host.astype(int)).max() <= 2


def test_pair_rgbd_greedy():
    rgb_t = np.array([0.0, 0.1, 0.2, 0.36])
    dep_t = np.array([0.01, 0.11, 0.30])
    pairs = images.pair_rgbd(rgb_t, dep_t, max_dt=0.05)
    # rgb 0.2 has no free depth within 0.05 (0.30 is 0.10 away); 0.36 lands
    # outside the window too -> only the first two pair up
    assert [(r, d) for r, d, _ in pairs] == [(0, 0), (1, 1)]


def test_load_bag_with_camera(tmp_path):
    bag = str(tmp_path / "cam.db3")
    _make_bag(bag, n_scans=4)
    _add_camera_topics(bag)
    cfg = rosbag.BagConfig(
        n_points=512, with_camera=True, camera_intrinsics=INTR,
        T_base_camera=(0.1, 0.0, 0.2, 0.0, 0.0, 0.0),
    )
    batches, _, _ = rosbag.load_bag(bag, config=cfg)
    n_valid = sum(int(np.sum(np.asarray(b.cam_valid))) for b in batches)
    assert n_valid > 0, "camera path produced zero valid features from the bag"
    # features carry information: nonzero precision on valid rows
    b = batches[0]
    ok = np.asarray(b.cam_valid)
    if ok.any():
        lam_tr = np.trace(np.asarray(b.cam_Lambdas)[ok], axis1=1, axis2=2)
        assert np.all(lam_tr > 0)


def test_load_bag_camera_failfast(tmp_path):
    bag = str(tmp_path / "nocam.db3")
    _make_bag(bag, n_scans=2)
    with pytest.raises(ValueError, match="no usable RGB-D"):
        rosbag.load_bag(bag, config=rosbag.BagConfig(
            n_points=256, with_camera=True, camera_intrinsics=INTR))
    bag2 = str(tmp_path / "noK.db3")
    _make_bag(bag2, n_scans=2)
    _add_camera_topics(bag2, n_frames=2)
    with pytest.raises(ValueError, match="camera_intrinsics"):
        rosbag.load_bag(bag2, config=rosbag.BagConfig(n_points=256, with_camera=True))


def test_camera_changes_pipeline_output(tmp_path):
    """A bag run with the camera enabled must alter the evidence stream
    (the r1 failure mode was all-zero cam slots silently 'working')."""
    bag = str(tmp_path / "cam2.db3")
    _make_bag(bag, n_scans=3)
    _add_camera_topics(bag)
    base_cfg = rosbag.BagConfig(n_points=512)
    cam_cfg = rosbag.BagConfig(
        n_points=512, with_camera=True, camera_intrinsics=INTR)
    b0, _, _ = rosbag.load_bag(bag, config=base_cfg)
    b1, _, _ = rosbag.load_bag(bag, config=cam_cfg)
    w0 = sum(float(np.sum(np.asarray(b.cam_weights))) for b in b0)
    w1 = sum(float(np.sum(np.asarray(b.cam_weights))) for b in b1)
    assert w0 == 0.0 and w1 > 0.0
