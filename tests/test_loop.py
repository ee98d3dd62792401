"""Loop-closure production (frontend/loop.py) + streaming injection."""

import numpy as np

from gcslam_tpu.frontend.loop import LoopDetector, LoopConfig, Keyframe
from gcslam_tpu.frontend.synthetic import generate, SyntheticConfig
from gcslam_tpu.models.config import PipelineConfig
from gcslam_tpu.models import runner

RNG = np.random.default_rng(7)


def test_register_recovers_known_transform():
    """ICP registration recovers a known relative pose between two views of
    the same cloud."""
    pts = np.c_[RNG.uniform(-3, 3, (400, 2)), RNG.uniform(0, 2, 400)]
    kf_pose = np.array([1.0, 0.5, 0.0, 0.0, 0.0, 0.3])
    cur_pose_true = np.array([1.3, 0.3, 0.0, 0.0, 0.0, 0.45])

    from gcslam_tpu.frontend.loop import _yaw_rotvec_to_R

    R_k = _yaw_rotvec_to_R(kf_pose[3:6])
    R_c = _yaw_rotvec_to_R(cur_pose_true[3:6])
    world = pts @ R_k.T + kf_pose[:3]  # keyframe body -> world
    cur_body = (world - cur_pose_true[:3]) @ R_c  # world -> cur body

    det = LoopDetector(LoopConfig())
    kf = Keyframe(index=0, pose=kf_pose, points_body=pts)
    # init guess off by 10 cm / 3 deg
    guess = cur_pose_true + np.array([0.1, -0.05, 0, 0, 0, 0.05])
    fit = det._register(cur_body, guess, kf)
    assert fit is not None
    loop_pose, cov, w = fit
    assert np.linalg.norm(loop_pose[:3] - cur_pose_true[:3]) < 0.02
    assert abs(loop_pose[5] - cur_pose_true[5]) < 0.01
    assert w > 0.5
    assert cov[0, 0] < 0.1


def _structured_scene(kind: str, n=600, seed=0):
    """Body-frame clouds with distinct structure: 'corridor' = two parallel
    walls; 'room' = four walls + tall pillar cluster."""
    rng = np.random.default_rng(seed)
    if kind == "corridor":
        x = rng.uniform(-6, 6, n)
        y = np.where(rng.random(n) < 0.5, -1.5, 1.5) + rng.normal(0, 0.03, n)
        z = rng.uniform(0, 2.5, n)
    else:
        t = rng.uniform(0, 4, n)
        side = rng.integers(0, 5, n)
        x = np.select([side == 0, side == 1, side == 2, side == 3, side == 4],
                      [t - 2, t - 2, np.full(n, -2.0), np.full(n, 2.0),
                       rng.normal(0.8, 0.1, n)])
        y = np.select([side == 0, side == 1, side == 2, side == 3, side == 4],
                      [np.full(n, -2.0), np.full(n, 2.0), t - 2, t - 2,
                       rng.normal(-0.5, 0.1, n)])
        z = np.where(side == 4, rng.uniform(0, 4.0, n), rng.uniform(0, 2.0, n))
    return np.c_[x, y, z]


def test_false_loop_rejected_by_appearance():
    """Two geometrically-near but structurally-different scenes must NOT
    produce a factor (perceptual aliasing)."""
    from gcslam_tpu.frontend.loop import scan_descriptor, descriptor_similarity

    corridor = _structured_scene("corridor", seed=1)
    room = _structured_scene("room", seed=2)
    # the descriptors themselves must distinguish the scenes...
    d_c = scan_descriptor(corridor)
    d_r = scan_descriptor(room)
    assert descriptor_similarity(d_c, d_r) < 0.6
    # ...and a same-scene pair must pass even under a yaw change
    from gcslam_tpu.frontend.loop import _yaw_rotvec_to_R

    R = _yaw_rotvec_to_R(np.array([0, 0, 0.8]))
    assert descriptor_similarity(d_c, scan_descriptor(corridor @ R.T)) > 0.6

    det = LoopDetector(LoopConfig(keyframe_every=1, min_index_gap=2,
                                  max_revisit_dist_m=5.0, cooldown_scans=0))
    w = np.ones(corridor.shape[0])
    # keyframe in the corridor at the origin
    det.store(0, np.zeros(6), corridor, w)
    # robot returns to the same XY cell but the scene is now the room
    fit = det.detect(10, np.array([0.2, 0.1, 0, 0, 0, 0.1]), room, w)
    assert fit is None, "structurally different scene produced a loop factor"
    # control: the true revisit of the corridor DOES produce a factor
    fit2 = det.detect(20, np.array([0.1, 0.0, 0, 0, 0, 0.02]), corridor, w)
    assert fit2 is not None


def test_bad_registration_rejected_by_rms_gate():
    """A registration whose post-fit residual stays large must be dropped
    even when many nearest neighbors land inside the match radius."""
    det = LoopDetector(LoopConfig(max_fit_rms_m=0.05))
    rng = np.random.default_rng(3)
    pts = np.c_[rng.uniform(-3, 3, (400, 2)), rng.uniform(0, 2, 400)]
    # keyframe cloud heavily corrupted: same support, different structure
    kf_pts = pts + rng.normal(0, 0.4, pts.shape)
    kf = Keyframe(index=0, pose=np.zeros(6), points_body=kf_pts)
    fit = det._register(pts, np.zeros(6), kf)
    assert fit is None


def test_stream_with_loops_runs_and_fires():
    run = generate(SyntheticConfig(n_scans=60, n_points=1024,
                                   odom_drift_pos_per_m=0.08,
                                   odom_drift_yaw_per_m=0.04, seed=0))
    cfg = PipelineConfig(with_map=True, atlas_max_tiles=32, m_tile=256,
                         m_tile_view=128, n_surfel=128, surfel_voxel_size_m=0.3)
    det = LoopDetector(LoopConfig(keyframe_every=5, min_index_gap=15,
                                  max_revisit_dist_m=3.0, cooldown_scans=10))
    state, out = runner.run_stream(run.batches, cfg, loop_detector=det)
    poses = np.asarray(out.pose)
    assert np.isfinite(poses).all()
    fired = np.asarray(out.tape.io_loop_weight)
    assert (fired > 0).any(), "no loop factor fired on a loitering start"
    # trajectory stays sane
    gt = run.gt_poses[:60]
    xy = np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1)
    assert xy.max() < 1.5
