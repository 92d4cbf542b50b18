"""Map lifecycle at scale through the port's MultiAgentServer with one
agent: the sequence and bounds of tests/test_torch_lifecycle.py
(tests/torch_lifecycle_cases.py), with culled slots drained the server's
way: erased from the global and the agent's keyframe database, then
reclaimed, before any new keyframe is allocated.
"""
import pytest
import torch

from multiagent_orb_slam2_tpu_torch.server import MultiAgentServer

import torch_lifecycle_cases as cases

torch.set_num_threads(1)   # several test workers share few cores


@pytest.mark.e2e
def test_long_run_recycles_slots_server():
    frames, t_wc, vocab = cases.long_sequence()
    server = MultiAgentServer(cases.CFG, vocab, device="cpu")
    tracker = server.register_client(0)
    for i, (left, right) in enumerate(frames):
        tracker.track_stereo(left, right, frame_id=i)
        server.process_new_keyframes()
    sh = server.shared
    cases.check_run(sh, tracker, t_wc)
    n = sh.n_kf
    valid = sh.state.kf_valid[:n]
    assert (server.db.active[:n] == valid).all()
    assert (server.loop_closers[0].db.active[:n] == valid).all()
    assert not sh.pending_release and server.multimap.n_maps == 1
    assert not server.stats
