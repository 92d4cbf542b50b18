"""Single typed configuration for the whole engine.

The reference scatters configuration across three mechanisms (SURVEY.md §5):
cv::FileStorage YAML (camera + ORB + viewer, parsed in src/Tracking.cc:53-147),
getopt CLI flags, and hard-coded constants at call sites (RANSAC budgets
src/Tracking.cc:1404, matcher thresholds src/ORBmatcher.cc:37-39, consistency
threshold src/MapFusion.cc:48, covisibility edge weight th=15 in
KeyFrame::UpdateConnections, minFeat=100 src/Optimizer.cc:811). Here every
tunable is hoisted into one frozen dataclass tree; YAML files from the
reference's Examples/ can still be ingested via `from_yaml_dict`.

Capacities: because the map state is fixed-shape (SURVEY.md §7 design
stance), capacities that the reference grows dynamically (keyframes, map
points, features) are explicit here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .geometry.camera import Intrinsics


class Sensor:
    """Sensor enum (reference include/Defines.h:6-10)."""
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (reference YAML ORBextractor.*, src/Tracking.cc:103-110)."""
    n_features: int = 1000          # per frame budget (2000 for KITTI configs)
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20           # primary FAST threshold
    min_th_fast: int = 7            # fallback threshold (src/ORBextractor.cc:808-816)
    cell_size: int = 30             # detection cell (W=30, src/ORBextractor.cc:779)
    patch_radius: int = 18          # sampling patch half-size (covers rotated BRIEF)
    angle_radius: int = 15          # IC-angle circular patch (HALF_PATCH_SIZE)

    @property
    def scale_factors(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    @property
    def level_budgets(self) -> Tuple[int, ...]:
        """Per-level feature budgets: geometric series summing to n_features
        (reference ctor logic, src/ORBextractor.cc:430-446)."""
        inv = 1.0 / self.scale_factor
        n_first = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        budgets = []
        acc = 0
        for i in range(self.n_levels - 1):
            b = int(round(n_first * inv ** i))
            budgets.append(b)
            acc += b
        budgets.append(max(self.n_features - acc, 0))
        return tuple(budgets)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Binary matcher thresholds (reference src/ORBmatcher.cc:37-39 and call sites)."""
    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30          # rotation-consistency histogram bins
    nn_ratio_tracking: float = 0.9  # SearchByProjection frame-to-frame
    nn_ratio_bow: float = 0.7       # TrackReferenceKeyFrame (src/Tracking.cc:775)


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking heuristics (reference src/Tracking.cc)."""
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30         # defaults to fps (src/Tracking.cc:64)
    th_depth: float = 35.0                  # near/far stereo point split (YAML ThDepth)
    min_inliers_track_local_map: int = 30   # src/Tracking.cc:980-986
    min_inliers_after_reloc: int = 50
    min_matches_motion_model: int = 20      # src/Tracking.cc:906
    min_matches_ref_kf: int = 15            # src/Tracking.cc:779
    local_map_max_kf: int = 80              # src/Tracking.cc:1303
    reloc_min_inliers: int = 50             # src/Tracking.cc:1359-1520
    reset_lost_max_kfs: int = 5             # auto-reset when lost early
    #                                         (src/Tracking.cc:483-491)


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Local mapping heuristics (reference src/LocalMapping.cc)."""
    mp_cull_found_ratio: float = 0.25       # src/LocalMapping.cc:189
    mp_cull_min_obs: int = 3
    triangulation_neighbors: int = 10       # 20 for mono (src/LocalMapping.cc:221)
    kf_cull_redundancy: float = 0.9         # src/LocalMapping.cc:636 (90% rule)
    kf_cull_min_obs: int = 3
    covis_edge_min_weight: int = 15         # KeyFrame::UpdateConnections th


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """LM / BA schedules (reference src/Optimizer.cc)."""
    pose_opt_rounds: int = 4                # 4 rounds x 10 iters (:241-453)
    pose_opt_iters: int = 10
    local_ba_iters: Tuple[int, int] = (5, 10)
    global_ba_iters: int = 10               # fusion GBA (src/MapFusion.cc:985)
    essential_graph_iters: int = 20
    sim3_opt_iters: int = 10                # + 5/10 after inlier re-gate (:1196-1217)
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    strong_covis_min_feat: int = 100        # essential-graph extra edges (:811)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop / fusion detection (reference src/LoopClosing.cc, src/MapFusion.cc)."""
    consistency_th: int = 3                 # mnCovisibilityConsistencyTh (:48)
    min_bow_matches: int = 20               # src/MapFusion.cc:277
    sim3_ransac_iters: int = 300            # Sim3Solver RANSAC(0.99, 20, 300)
    sim3_ransac_min_inliers: int = 20
    sim3_opt_min_inliers: int = 20          # src/MapFusion.cc:336-339
    min_total_matches: int = 40             # src/MapFusion.cc:396
    refractory_kfs: int = 10                # src/LoopClosing.cc:137


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Fixed-shape capacities of the array map state (no analogue
    in the reference, which grows pointer graphs on the heap)."""
    max_keyframes: int = 512
    max_points: int = 65536
    max_obs_per_point: int = 24
    max_features: int = 1024                # padded per-frame keypoint slots
    local_points: int = 8192                # tracked local-map window slots
    max_agents: int = 4


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: Intrinsics = Intrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                    bf=200.0, width=640, height=480)
    sensor: int = Sensor.STEREO
    fps: float = 30.0
    depth_map_factor: float = 1.0           # RGB-D depth scaling (YAML)
    orb: OrbConfig = OrbConfig()
    matcher: MatcherConfig = MatcherConfig()
    tracking: TrackingConfig = TrackingConfig()
    mapping: MappingConfig = MappingConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    loop: LoopConfig = LoopConfig()
    caps: Capacities = Capacities()

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def from_yaml_dict(d: dict, sensor: int = Sensor.STEREO,
                   width: int = 640, height: int = 480) -> SlamConfig:
    """Build a SlamConfig from the reference's YAML key scheme
    (Camera.fx/..., ORBextractor.nFeatures/..., src/Tracking.cc:53-147)."""
    cam = Intrinsics(
        fx=float(d["Camera.fx"]), fy=float(d["Camera.fy"]),
        cx=float(d["Camera.cx"]), cy=float(d["Camera.cy"]),
        bf=float(d.get("Camera.bf", 0.0)),
        width=int(d.get("Camera.width", width)),
        height=int(d.get("Camera.height", height)),
        dist=(float(d.get("Camera.k1", 0.0)), float(d.get("Camera.k2", 0.0)),
              float(d.get("Camera.p1", 0.0)), float(d.get("Camera.p2", 0.0)),
              float(d.get("Camera.k3", 0.0))),
    )
    fps = float(d.get("Camera.fps", 30.0))
    orb = OrbConfig(
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
    )
    tracking = TrackingConfig(
        max_frames_between_kf=int(fps),
        th_depth=float(d.get("ThDepth", 35.0)),
    )
    return SlamConfig(camera=cam, sensor=sensor, fps=fps, orb=orb,
                      tracking=tracking,
                      depth_map_factor=float(d.get("DepthMapFactor", 1.0)))
