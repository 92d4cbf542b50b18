"""The JAX package's tests/test_lifecycle.py::test_long_run_recycles_slots
scenario on the port: a 120-frame loitering corridor (0.05 m a frame) on a
map of 24 keyframe slots and 4096 points, keyframe culling at 0.6
redundancy, and the JAX test's bounds (at most 10 % of the frames lost,
more keyframes created than slots, no point stall, at least one
compaction, every frame exported, camera centres within 0.3 m RMS of the
ground truth with no alignment, export fallbacks only for lost frames).
Port only; shared by tests/test_torch_lifecycle.py (through System) and
tests/test_torch_lifecycle_server.py (through a one-agent
MultiAgentServer).

The run drifts chaotically: the same code gives 0.227 m with one intra-op
thread (the test workers' setting, which these tests keep) and 0.314 m
with two (another summation order), against the 0.3 m bound; the JAX
package's run gives 0.352 m (ROADMAP.md queue 3, fault 2)."""
import numpy as np

from multiagent_orb_slam2_tpu_torch.config import (Capacities, MappingConfig,
                                                   OrbConfig, Sensor,
                                                   SlamConfig, TrackingConfig)
from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu_torch.io.synthetic import (BoxScene,
                                                         corridor_trajectory)
from multiagent_orb_slam2_tpu_torch.ops import frame as frame_mod
from multiagent_orb_slam2_tpu_torch.runtime.tracker import _np_inverse
from multiagent_orb_slam2_tpu_torch.vocab import bow as bow_mod

CAM = Intrinsics(fx=230.0, fy=230.0, cx=160.0, cy=120.0, bf=115.0,
                 width=320, height=240)
CFG = SlamConfig(
    camera=CAM, sensor=Sensor.STEREO,
    orb=OrbConfig(n_features=300, n_levels=4),
    tracking=TrackingConfig(max_frames_between_kf=4, min_frames_between_kf=0,
                            th_depth=60.0),
    # deliberately tiny: the run must outlive these by recycling
    caps=Capacities(max_keyframes=24, max_points=4096, max_features=384,
                    local_points=2048),
    mapping=MappingConfig(kf_cull_redundancy=0.6),
)
N_FRAMES = 120  # 5x the keyframe capacity in keyframes, 30x in frames


def long_sequence():
    """(frames [(left, right)], ground-truth centres, vocabulary trained on
    every 20th frame)."""
    scene = BoxScene(seed=3, z_far=40.0)
    q_wc, t_wc = corridor_trajectory(N_FRAMES, step=0.05, seed=2)
    frames = [scene.render_stereo(CAM, q_wc[i], t_wc[i])[:2]
              for i in range(N_FRAMES)]
    descs = []
    for left, _ in frames[::20]:
        f = frame_mod.extract_frame(left, CFG, device="cpu")
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    vocab = bow_mod.train_vocabulary(np.concatenate(descs), k=6, depth=3,
                                     device="cpu")
    return frames, t_wc, vocab


def check_run(shared, tracker, t_wc):
    """The JAX test's bounds."""
    n_lost = sum(r.lost for r in tracker.trajectory)
    assert n_lost <= N_FRAMES // 10, f"{n_lost} lost frames"
    assert shared.n_created > CFG.caps.max_keyframes, \
        f"only {shared.n_created} keyframes created; weak test"
    assert int(shared.state.kf_valid.sum()) <= CFG.caps.max_keyframes
    assert shared.n_point_stalls == 0, f"{shared.n_point_stalls} stalls"
    assert shared.n_compactions >= 1, "compaction never triggered"
    poses = tracker.export_poses()
    assert len(poses) == N_FRAMES
    est = np.stack([_np_inverse(np.asarray(q, np.float64),
                                np.asarray(t, np.float64))[1]
                    for _, lost, q, t in poses if not lost])
    gt = t_wc[[p[0] for p in poses if not p[1]]]
    ate = np.sqrt(np.mean(np.sum((est - gt) ** 2, -1)))
    assert ate < 0.3, f"ATE {ate:.3f} m over {len(est)} frames"
    assert tracker.export_fallbacks <= n_lost + 2
