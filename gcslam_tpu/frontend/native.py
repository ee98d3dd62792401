"""ctypes bindings for the native bag-decode library (native/gcslam_native.cpp).

Auto-builds with `make -C native` on first import if g++ is available;
callers fall back to the pure-Python CDR codec when the library is missing
(same outputs, just slower — the contract is identical and tested as such).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgcslam_native.so")

_lib: Optional[ctypes.CDLL] = None


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib
    if os.environ.get("GCSLAM_NO_NATIVE") == "1":
        # Rehearsal attribution toggle: force the pure-Python
        # decode path so native-vs-Python frontend deltas are measurable.
        return None
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-s"], check=True, capture_output=True, timeout=120
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.gcslam_parse_pointcloud2.restype = ctypes.c_int32
    lib.gcslam_parse_pointcloud2.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, f32p, f64p, i32p, i32p, f64p, ctypes.c_double,
    ]
    lib.gcslam_parse_imu_batch.restype = ctypes.c_int32
    lib.gcslam_parse_imu_batch.argtypes = [u8p, i64p, i64p, ctypes.c_int64, f64p, f64p, f64p]
    lib.gcslam_parse_odometry_batch.restype = ctypes.c_int32
    lib.gcslam_parse_odometry_batch.argtypes = [
        u8p, i64p, i64p, ctypes.c_int64, f64p, f64p, f64p, f64p, f64p, f64p,
    ]
    lib.gcslam_point_budget_range_weights.restype = ctypes.c_int32
    lib.gcslam_point_budget_range_weights.argtypes = [
        f32p, f64p, i32p, i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        f32p, f64p, f32p, i32p, i32p,
    ]
    try:
        lib.gcslam_decode_jpeg.restype = ctypes.c_int32
        lib.gcslam_decode_jpeg.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, i32p, i32p,
        ]
    except AttributeError:
        pass  # older library build; host decoders cover it
    lib.gcslam_visual_features.restype = ctypes.c_int32
    lib.gcslam_visual_features.argtypes = [
        u8p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_int32,
        f32p, f32p, f32p, f32p, f32p, f32p,
    ]
    try:
        lib.gcslam_stream_open.restype = ctypes.c_void_p
        lib.gcslam_stream_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32,
        ]
        lib.gcslam_stream_next.restype = ctypes.c_int32
        lib.gcslam_stream_next.argtypes = [
            ctypes.c_void_p, f32p, f64p, i32p, i32p, f64p, f64p,
        ]
        lib.gcslam_stream_skipped.restype = ctypes.c_int32
        lib.gcslam_stream_skipped.argtypes = [ctypes.c_void_p]
        lib.gcslam_stream_close.restype = None
        lib.gcslam_stream_close.argtypes = [ctypes.c_void_p]
    except AttributeError:
        pass  # older library build; the Python reader covers it
    _lib = lib
    return lib


def available() -> bool:
    return _try_load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def parse_pointcloud2(buf: bytes, max_points: int, sentinel: float):
    """-> (xyz (n,3) f32, t (n,) f64, ring (n,) i32, tag (n,) i32, stamp) or None."""
    lib = _try_load()
    if lib is None:
        return None
    b = np.frombuffer(buf, dtype=np.uint8)
    xyz = np.empty((max_points, 3), np.float32)  # first n entries written
    t = np.empty(max_points, np.float64)
    ring = np.empty(max_points, np.int32)
    tag = np.empty(max_points, np.int32)
    stamp = ctypes.c_double(0.0)
    n = lib.gcslam_parse_pointcloud2(
        _ptr(b, ctypes.c_uint8), len(buf), max_points,
        _ptr(xyz, ctypes.c_float), _ptr(t, ctypes.c_double),
        _ptr(ring, ctypes.c_int32), _ptr(tag, ctypes.c_int32),
        ctypes.byref(stamp), float(sentinel),
    )
    if n < 0:
        return None
    return xyz[:n], t[:n], ring[:n], tag[:n], float(stamp.value)


def _pack_blob(payloads):
    lengths = np.asarray([len(p) for p in payloads], np.int64)
    offsets = np.zeros(len(payloads), np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:]) if len(payloads) > 1 else None
    blob = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    return blob, offsets, lengths


def parse_imu_batch(payloads):
    """-> (stamps (n,), gyro (n,3), accel (n,3)) or None."""
    lib = _try_load()
    if lib is None or not payloads:
        return None
    blob, offsets, lengths = _pack_blob(payloads)
    n = len(payloads)
    stamps = np.zeros(n)
    gyro = np.zeros((n, 3))
    accel = np.zeros((n, 3))
    lib.gcslam_parse_imu_batch(
        _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int64), n,
        _ptr(stamps, ctypes.c_double), _ptr(gyro, ctypes.c_double), _ptr(accel, ctypes.c_double),
    )
    return stamps, gyro, accel


def parse_odometry_batch(payloads):
    """-> (stamps, pos (n,3), quat (n,4), pose_cov (n,36), twist (n,6),
    twist_cov (n,36)) or None."""
    lib = _try_load()
    if lib is None or not payloads:
        return None
    blob, offsets, lengths = _pack_blob(payloads)
    n = len(payloads)
    stamps = np.zeros(n)
    pos = np.zeros((n, 3))
    quat = np.zeros((n, 4))
    pcov = np.zeros((n, 36))
    twist = np.zeros((n, 6))
    tcov = np.zeros((n, 36))
    lib.gcslam_parse_odometry_batch(
        _ptr(blob, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
        _ptr(lengths, ctypes.c_int64), n,
        _ptr(stamps, ctypes.c_double), _ptr(pos, ctypes.c_double),
        _ptr(quat, ctypes.c_double), _ptr(pcov, ctypes.c_double),
        _ptr(twist, ctypes.c_double), _ptr(tcov, ctypes.c_double),
    )
    return stamps, pos, quat, pcov, twist, tcov


def decode_jpeg_rgb(data: bytes) -> Optional[np.ndarray]:
    """JPEG -> (H, W, 3) uint8 RGB via the native libjpeg fast path
    (the reference's cv::imdecode in camera_rgbd_node.cpp:145), or None
    when the library (or the symbol) is unavailable."""
    lib = _try_load()
    if lib is None or not hasattr(lib, "gcslam_decode_jpeg"):
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = 4096 * 4096 * 3
    out = np.zeros(cap, dtype=np.uint8)
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    rc = lib.gcslam_decode_jpeg(
        _ptr(buf, ctypes.c_uint8), len(data), _ptr(out, ctypes.c_uint8), cap,
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc < 0:
        return None
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def visual_features(gray_u8, depth_f32, max_feat: int = 512,
                    min_score: float = 5e-4, nms_radius: int = 6):
    """Native visual feature extraction (the reference's
    src/visual_feature_node.cpp stage: corners + robust depth + plane fit).
    Returns (n, uv (F,2), score (F,), z (F,), z_var (F,), normal_duv1 (F,3),
    gray01 (F,)) or None when the library is unavailable.

    normal_duv1 is the depth-plane normal in the (du, dv, 1) image basis;
    apply intrinsics on the Python side to get the camera-frame normal."""
    lib = _try_load()
    if lib is None:
        return None
    g = np.ascontiguousarray(gray_u8, dtype=np.uint8)
    d = np.ascontiguousarray(depth_f32, dtype=np.float32)
    H, W = g.shape
    F = int(max_feat)
    uv = np.zeros((F, 2), dtype=np.float32)
    score = np.zeros(F, dtype=np.float32)
    z = np.zeros(F, dtype=np.float32)
    zvar = np.zeros(F, dtype=np.float32)
    normal = np.zeros((F, 3), dtype=np.float32)
    color = np.zeros(F, dtype=np.float32)
    n = lib.gcslam_visual_features(
        _ptr(g, ctypes.c_uint8), _ptr(d, ctypes.c_float),
        W, H, F, ctypes.c_float(min_score), nms_radius,
        _ptr(uv, ctypes.c_float), _ptr(score, ctypes.c_float),
        _ptr(z, ctypes.c_float), _ptr(zvar, ctypes.c_float),
        _ptr(normal, ctypes.c_float), _ptr(color, ctypes.c_float),
    )
    return int(n), uv, score, z, zvar, normal, color


def stream_available() -> bool:
    lib = _try_load()
    return lib is not None and hasattr(lib, "gcslam_stream_open")


def stream_pointclouds(db_path: str, topic: str, max_points: int,
                       sentinel: float, queue_depth: int = 4):
    """Async PointCloud2 stream over a rosbag2 sqlite container: a native
    worker thread reads rows + parses CDR while the consumer assembles
    batches (the reference's async LiDAR worker analog,
    backend_node.py:1340-1388). Yields (xyz f32 (n,3), t f64 (n,), ring i32,
    tag i32, stamp, bag_t); generator close() joins the worker."""
    lib = _try_load()
    if lib is None or not hasattr(lib, "gcslam_stream_open"):
        raise RuntimeError("native streamer unavailable")
    h = lib.gcslam_stream_open(db_path.encode(), topic.encode(),
                               max_points, float(sentinel), queue_depth)
    if not h:
        raise RuntimeError("native streamer could not open libsqlite3")
    # one reusable receive buffer: per-scan max_points-sized allocations are
    # ~28 MB of mmap churn per scan; the yielded arrays are copies of the
    # filled slice only
    xyz = np.empty((max_points, 3), np.float32)
    t = np.empty(max_points, np.float64)
    ring = np.empty(max_points, np.int32)
    tag = np.empty(max_points, np.int32)
    try:
        while True:
            stamp = ctypes.c_double(0.0)
            bag_t = ctypes.c_double(0.0)
            n = lib.gcslam_stream_next(
                h, _ptr(xyz, ctypes.c_float), _ptr(t, ctypes.c_double),
                _ptr(ring, ctypes.c_int32), _ptr(tag, ctypes.c_int32),
                ctypes.byref(stamp), ctypes.byref(bag_t),
            )
            if n < 0:
                break
            yield (xyz[:n].copy(), t[:n].copy(), ring[:n].copy(),
                   tag[:n].copy(), float(stamp.value), float(bag_t.value))
    finally:
        lib.gcslam_stream_close(h)
