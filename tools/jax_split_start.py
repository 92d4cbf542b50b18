"""The first ticks of the JAX package's 2-agent split of the loop corridor,
printed tick by tick, on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_split_start.py --clip CLIP \\
        [--ticks 12] [--gates shipped own port every]

Renders the frames that the first `--ticks` ticks of trial 0's split track
(make_synth_seq seed 0, 660 frames at 512x288: agent 0 on frames 0..T-1,
agent 1 on 330..330+T-1) into CLIP, in make_synth_seq's layout: 2T frames,
agent 0's then agent 1's, with times.txt, gt_tum.txt and settings.json.
`generic_split_seq -n 2` of either package splits CLIP into exactly these
two halves, so the port runs the same ticks with

    SLAM_DIAG=diag.jsonl python -m \\
        multiagent_orb_slam2_tpu_torch.drivers.generic_split_seq \\
        -t stereo_synth -n 2 -d CLIP -s CLIP/settings.json -o OUT

Then drives the JAX MultiAgentServer over CLIP as the JAX
drivers/generic_split_seq does (default capacities, the committed
vocabulary, round robin, process_new_keyframes after every tick), once for
each view in `--gates`: `shipped` (the JAX package as it is), `own`
(tests/jax_views.OwnMapGates: the keyframe-count gates count the tracker's
own map, the port's repair of fault 9) and `port` (tests/jax_views.
port_views: that and map-point ages counted in the agent's own keyframes,
the port's repair of fault 11) and `every` (port_views with
every_agents_creations: only the agent's own points culled for age, their
age counted in every agent's keyframe creations, a smaller variant of that
repair). Prints one JSON object per
agent and tick: the state after the frame, the inliers (the decision
vector's second entry), the live keyframes of the agent's own map, the map
points this frame culled (the agent's own and the other agent's, with how
many of them had at most mapping.mp_cull_min_obs observations before it),
the keyframes created, and whether the tracker reset; then one per tick for
process_new_keyframes (relocalizations, points culled). Imports the JAX
package only. One process, a few GB; minutes on a CPU.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "analysis"))

import numpy as np  # noqa: E402

from multiagent_orb_slam2_tpu.config import Sensor, from_yaml_dict  # noqa
from multiagent_orb_slam2_tpu.drivers import common  # noqa: E402
from multiagent_orb_slam2_tpu.geometry.camera import Intrinsics  # noqa
from multiagent_orb_slam2_tpu.io import datasets, synthetic  # noqa: E402
from multiagent_orb_slam2_tpu.server import MultiAgentServer  # noqa: E402
from multiagent_orb_slam2_tpu.vocab import bow  # noqa: E402

from jax_views import own_map_gates, port_views  # noqa: E402

SEED, FRAMES, WIDTH, HEIGHT, FPS = 0, 660, 512, 288, 10.0
SETTINGS = {
    "Camera.fx": 260.0, "Camera.fy": 260.0, "Camera.cx": WIDTH / 2.0,
    "Camera.cy": HEIGHT / 2.0, "Camera.bf": 260.0 * 0.12,
    "Camera.width": WIDTH, "Camera.height": HEIGHT, "Camera.fps": FPS,
    "ThDepth": 35.0, "ORBextractor.nFeatures": 600,
    "ORBextractor.scaleFactor": 1.2, "ORBextractor.nLevels": 8,
    "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7,
}


def write_clip(clip: str, ticks: int):
    """Frames 0..ticks-1 and FRAMES/2..FRAMES/2+ticks-1 of trial 0's
    corridor, renumbered 0..2*ticks-1, in make_synth_seq's layout."""
    import make_synth_seq
    q_wc, t_wc = make_synth_seq.loop_trajectory(FRAMES, 1.0, 24.0, seed=SEED)
    cam = Intrinsics(fx=260.0, fy=260.0, cx=WIDTH / 2.0, cy=HEIGHT / 2.0,
                     bf=260.0 * 0.12, width=WIDTH, height=HEIGHT)
    scene = synthetic.BoxScene(seed=SEED, z_far=30.0)
    picked = list(range(ticks)) + list(range(FRAMES // 2,
                                             FRAMES // 2 + ticks))
    os.makedirs(clip, exist_ok=True)
    gt = []
    for j, i in enumerate(picked):
        left, right, _ = scene.render_stereo(cam, q_wc[i], t_wc[i])
        for name, img in (("left", left), ("right", right)):
            np.save(os.path.join(clip, f"{name}_{j:05d}.npy"),
                    np.clip(img, 0, 255).astype(np.uint8))
        q = q_wc[i]
        gt.append((j / FPS, *t_wc[i], q[1], q[2], q[3], q[0]))
    np.savetxt(os.path.join(clip, "times.txt"),
               np.arange(len(picked)) / FPS, fmt="%.6f")
    with open(os.path.join(clip, "gt_tum.txt"), "w") as f:
        for row in gt:
            f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
    with open(os.path.join(clip, "settings.json"), "w") as f:
        json.dump({**SETTINGS, "source_frames": picked}, f, indent=1)


def points(state):
    """(valid, agent, observation count) of every point slot, on the
    host."""
    return (np.asarray(state.mp_valid), np.asarray(state.mp_agent),
            np.asarray(state.mp_n_obs()))


def culled(before, after, agent, min_obs):
    """Points valid before and not after: [own, own with <= min_obs
    observations before, other agents', other with <= min_obs]."""
    gone = before[0] & ~after[0]
    own = before[1] == agent
    low = before[2] <= min_obs
    return [int(np.sum(gone & own)), int(np.sum(gone & own & low)),
            int(np.sum(gone & ~own)), int(np.sum(gone & ~own & low))]


def run(clip: str, gates: str, cfg, vocab):
    subs = datasets.load_synth_stereo(clip).split(2)
    server = MultiAgentServer(cfg, vocab)
    trackers = [server.register_client(a) for a in range(2)]
    if gates == "own":
        trackers = [own_map_gates(server, t) for t in trackers]
    elif gates != "shipped":
        trackers = [port_views(server, t, gates == "every")
                    for t in trackers]
    resets = [0, 0]
    for a, tr in enumerate(trackers):
        def counting(real=tr.reset, a=a):
            resets[a] += 1
            real()
        tr.reset = counting
    min_obs = cfg.mapping.mp_cull_min_obs
    offsets = (0, FRAMES // 2)
    for i in range(len(subs[0])):
        for a, (tr, sub) in enumerate(zip(trackers, subs)):
            left, right, _ = sub.load(i)
            before, r0, c0 = points(server.shared.state), resets[a], \
                server.shared.n_created
            t0 = time.perf_counter()
            tr.track_stereo(left, right, frame_id=i)
            st = server.shared.state
            after = points(st)
            map_id = server.multimap.map_of(a)
            dec = tr._last_decision
            print(json.dumps({
                "gates": gates, "tick": i, "agent": a,
                "frame": offsets[a] + i, "state": int(tr.state),
                "inliers": None if dec is None else int(dec[1]),
                "decision": None if dec is None else [int(x) for x in dec],
                "map": map_id, "ref_kf": int(tr.ref_kf),
                "own_map_live_kfs": int(np.sum(
                    np.asarray(st.kf_valid)
                    & (np.asarray(st.kf_map) == map_id))),
                "own_points": int(np.sum(after[0] & (after[1] == a))),
                "culled_own_lowobs_other_lowobs": culled(before, after, a,
                                                         min_obs),
                "kfs_created": server.shared.n_created - c0,
                "reset": resets[a] - r0,
                "s": round(time.perf_counter() - t0, 2)}), flush=True)
        before, relocs = points(server.shared.state), \
            server.n_relocalizations
        server.process_new_keyframes()
        after = points(server.shared.state)
        print(json.dumps({
            "gates": gates, "tick": i, "server": True,
            "relocalizations": server.n_relocalizations - relocs,
            "culled_agent0_agent1": [culled(before, after, 0, min_obs)[0],
                                     culled(before, after, 1, min_obs)[0]],
            "maps": server.multimap.n_maps}), flush=True)
    print(json.dumps({"gates": gates, "resets": resets,
                      "fusions": len(server.stats)}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", required=True)
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--gates", nargs="+", default=["shipped", "own", "port"],
                    choices=["shipped", "own", "port", "every"])
    args = ap.parse_args(argv)
    if not os.path.exists(os.path.join(args.clip, "settings.json")):
        t0 = time.perf_counter()
        write_clip(args.clip, args.ticks)
        print(f"rendered {2 * args.ticks} frames into {args.clip} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(os.path.join(args.clip, "settings.json")) as f:
        cfg = from_yaml_dict(json.load(f), sensor=Sensor.STEREO)
    vocab = bow.load_vocabulary(common.DEFAULT_VOCAB)
    for gates in args.gates:
        run(args.clip, gates, cfg, vocab)


if __name__ == "__main__":
    main()
