"""Map lifecycle at scale through the port's System: keyframe slot
recycling, point compaction and a long run far past the static
capacities.

The JAX package's tests/test_lifecycle.py::test_long_run_recycles_slots on
the port (tests/torch_lifecycle_cases.py: the same 120-frame loitering
corridor on 24 keyframe slots, the same bounds), through
System(CFG, vocab, enable_loop_closing=False), whose keyframe database
erases culled keyframes before their slots are reused. The JAX test fails
on its ATE bound (0.352 m); the port passes it (ROADMAP.md queue 3, fault
2). tests/test_torch_lifecycle_server.py runs the same sequence through a
one-agent MultiAgentServer.
"""
import pytest
import torch

from multiagent_orb_slam2_tpu_torch.runtime.system import System

import torch_lifecycle_cases as cases

torch.set_num_threads(1)   # several test workers share few cores


@pytest.mark.e2e
def test_long_run_recycles_slots():
    """Recycling with the keyframe database's erase path; the database
    holds exactly the live keyframes at the end."""
    frames, t_wc, vocab = cases.long_sequence()
    system = System(cases.CFG, vocab, enable_loop_closing=False,
                    device="cpu")
    for i, (left, right) in enumerate(frames):
        system.track_stereo(left, right, frame_id=i)
    sh = system.shared
    cases.check_run(sh, system.tracker, t_wc)
    n = sh.n_kf
    assert (system.loop_closer.db.active[:n] == sh.state.kf_valid[:n]).all()
    assert not sh.pending_release
