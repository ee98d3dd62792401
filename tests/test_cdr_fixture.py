"""CDR codec vs hand-assembled bytes.

The round-trip tests (test_rosbag.py) validate parse(serialize(x)) == x,
which cannot catch a SHARED misunderstanding of the XCDR1 layout. These
fixtures are assembled byte-by-byte from the OMG CDR rules (primitives align
to min(size, 8) relative to the body start; strings are u32 length +
NUL-terminated bytes; no padding at encapsulation), independently of
CdrWriter — if the codec's alignment model drifted, these would fail while
the round-trip stayed green. (Validates against bytes the repo didn't write;
no real bag ships with the repo.)
"""

import struct

import numpy as np

from gcslam_tpu.frontend import cdr


def _pad_to(buf: bytearray, body_align: int):
    rel = len(buf) - 4
    buf.extend(b"\x00" * ((-rel) % body_align))


def test_imu_hand_assembled():
    """sensor_msgs/Imu: header(stamp i32+u32, frame string), quat f64[4],
    cov f64[9], angvel f64[3], cov f64[9], linacc f64[3], cov f64[9]."""
    b = bytearray()
    b += b"\x00\x01\x00\x00"  # encapsulation: LE CDR, options 0
    b += struct.pack("<i", 1665772901)  # stamp.sec   (offset 0, aligned 4)
    b += struct.pack("<I", 500000000)  # stamp.nanosec (offset 4)
    frame = b"imu_link\x00"
    b += struct.pack("<I", len(frame)) + frame  # string (offset 8)
    _pad_to(b, 8)  # doubles align to 8 relative to body start
    quat = [0.1, 0.2, 0.3, 0.9273618495495704]
    b += struct.pack("<4d", *quat)
    b += struct.pack("<9d", *([0.0] * 9))  # orientation_covariance
    gyro = [0.01, -0.02, 0.03]
    b += struct.pack("<3d", *gyro)
    b += struct.pack("<9d", *range(9))  # angular_velocity_covariance
    acc = [0.1, 0.2, 9.81]
    b += struct.pack("<3d", *acc)
    b += struct.pack("<9d", *range(9, 18))

    msg = cdr.parse_imu(bytes(b))
    assert abs(msg.header.stamp_sec - 1665772901.5) < 1e-6
    np.testing.assert_allclose(msg.orientation, quat)
    np.testing.assert_allclose(msg.angular_velocity, gyro)
    np.testing.assert_allclose(msg.linear_acceleration, acc)
    np.testing.assert_allclose(msg.angular_velocity_cov, np.arange(9.0))

    # and the repo's serializer produces these exact bytes
    assert cdr.serialize_imu(
        cdr.Imu(cdr.Header(1665772901.5, "imu_link"), np.array(quat),
                np.array(gyro), np.array(acc),
                np.arange(9.0), np.arange(9.0, 18.0))
    ) == bytes(b)


def test_pointcloud2_hand_assembled():
    """PointCloud2 with one 16-byte point; exercises the field table and the
    u8/bool alignment (is_bigendian sits unaligned after the field array)."""
    b = bytearray()
    b += b"\x00\x01\x00\x00"
    b += struct.pack("<i", 100) + struct.pack("<I", 0)  # stamp
    b += struct.pack("<I", 6) + b"lidar\x00"  # frame_id
    _pad_to(b, 4)
    b += struct.pack("<I", 1)  # height
    b += struct.pack("<I", 2)  # width
    b += struct.pack("<I", 2)  # fields: sequence length 2
    # field 0: name "x", offset 0, datatype 7 (f32), count 1
    b += struct.pack("<I", 2) + b"x\x00"
    _pad_to(b, 4)  # u32 `offset` aligns to 4 after the string bytes
    b += struct.pack("<I", 0)
    b += struct.pack("<B", 7)
    _pad_to(b, 4)
    b += struct.pack("<I", 1)
    # field 1: name "z", offset 4, f32, count 1
    b += struct.pack("<I", 2) + b"z\x00"
    _pad_to(b, 4)
    b += struct.pack("<I", 4)
    b += struct.pack("<B", 7)
    _pad_to(b, 4)
    b += struct.pack("<I", 1)
    b += struct.pack("<B", 0)  # is_bigendian (bool, no alignment)
    _pad_to(b, 4)
    b += struct.pack("<I", 8)  # point_step
    b += struct.pack("<I", 16)  # row_step
    data = struct.pack("<4f", 1.5, -2.5, 3.25, 0.0)
    b += struct.pack("<I", 16) + data  # data byte sequence
    b += struct.pack("<B", 1)  # is_dense

    msg = cdr.parse_pointcloud2(bytes(b))
    assert msg.width == 2 and msg.point_step == 8
    assert [f.name for f in msg.fields] == ["x", "z"]
    assert msg.fields[1].offset == 4
    assert not msg.is_bigendian and msg.is_dense
    arr = np.frombuffer(msg.data, "<f4")
    np.testing.assert_allclose(arr, [1.5, -2.5, 3.25, 0.0])


def test_odometry_hand_assembled():
    b = bytearray()
    b += b"\x00\x01\x00\x00"
    b += struct.pack("<i", 7) + struct.pack("<I", 250000000)
    b += struct.pack("<I", 5) + b"odom\x00"
    # child_frame_id string aligns to 4 after header string
    _pad_to(b, 4)
    b += struct.pack("<I", 5) + b"base\x00"
    _pad_to(b, 8)
    pos = [1.0, 2.0, 3.0]
    quat = [0.0, 0.0, 0.7071067811865476, 0.7071067811865476]
    b += struct.pack("<3d", *pos) + struct.pack("<4d", *quat)
    b += struct.pack("<36d", *range(36))
    tl = [0.5, 0.0, 0.0]
    ta = [0.0, 0.0, 0.25]
    b += struct.pack("<3d", *tl) + struct.pack("<3d", *ta)
    b += struct.pack("<36d", *range(36, 72))

    msg = cdr.parse_odometry(bytes(b))
    assert msg.child_frame_id == "base"
    assert abs(msg.header.stamp_sec - 7.25) < 1e-9
    np.testing.assert_allclose(msg.position, pos)
    np.testing.assert_allclose(msg.orientation, quat)
    np.testing.assert_allclose(msg.pose_cov, np.arange(36.0))
    np.testing.assert_allclose(msg.twist_angular, ta)
    np.testing.assert_allclose(msg.twist_cov, np.arange(36.0, 72.0))


def test_native_parser_matches_fixture_bytes():
    """The C++ fast path decodes the same hand-assembled bytes."""
    from gcslam_tpu.frontend import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    b = bytearray()
    b += b"\x00\x01\x00\x00"
    b += struct.pack("<i", 50) + struct.pack("<I", 0)
    b += struct.pack("<I", 2) + b"i\x00"
    _pad_to(b, 8)
    b += struct.pack("<4d", 0, 0, 0, 1)
    b += struct.pack("<9d", *([0.0] * 9))
    b += struct.pack("<3d", 0.1, 0.2, 0.3)
    b += struct.pack("<9d", *([0.0] * 9))
    b += struct.pack("<3d", 1.0, 2.0, 9.8)
    b += struct.pack("<9d", *([0.0] * 9))
    out = native.parse_imu_batch([bytes(b)])
    assert out is not None
    st, gy, ac = out
    assert abs(st[0] - 50.0) < 1e-9
    np.testing.assert_allclose(gy[0], [0.1, 0.2, 0.3])
    np.testing.assert_allclose(ac[0], [1.0, 2.0, 9.8])
