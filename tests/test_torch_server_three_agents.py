"""The port's multi-agent server against the JAX package's on the
three-agent fixture of tests/test_server.py (three agents on overlapping
thirds of a 30-frame corridor; tests/torch_server_cases.py runs it through
both servers on the JAX package's features, the port drawing the JAX
package's Sim3 RANSAC samples): one map in both, the same fusions in the
same order (agent, map ids, query and match keyframes), each of the port's
matches within 1e-4 of the JAX package's compute_sim3 on the state the port
computed it on, and within 1e-4 of the JAX run's match, but for the first
fusion; after the global BAs the fused keyframes' ATE under 0.12 m and
within 10 % or 2 mm of the JAX run's, whichever is larger (global BA is
held by outcome: CG is chaotic in float32). Kept apart from
tests/test_torch_server.py so the two fixtures run on two test workers.

The first fusion (agent 1's keyframe 9 with agent 0's keyframe 2, 15 cm
apart) is held by the per-state comparison only, because the two runs'
maps have parted by then; measured on the CPU by
tools/torch_fixture_parting.py:
- after the first local BA (tick 2) the runs' points are within 6.0e-5 m
  (the two packages' local BAs on one input: 3.2e-5 m, float32);
- on tick 3 the JAX package's own keyframe pipeline, given its run's state
  and then the port run's (everything else the JAX run's), keeps the new
  point in slot 475 on one and not the other (two observations differ)
  before local BA, which then moves 227 points by more than 1e-4 m (up to
  1.9 cm) and a keyframe by 0.59 mm; the port's pipeline does the same on
  the same two inputs, and on one input the two packages' pipelines agree
  to 6.1e-4 m with no point kept by one only. So the runs part there by the
  problem's own sensitivity, in either package;
- the first fusion's Sim3 is then 4.1e-4 apart between the runs, where on
  the port's state the JAX compute_sim3 and the port's agree to 6.0e-8;
  the second fusion's is 3.1e-6 apart between the runs.
"""
import pytest
import torch

from multiagent_orb_slam2_tpu.server import MultiAgentServer as JServer
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.server import MultiAgentServer as TServer

import torch_server_cases as cases
from torch_parity import jax_fields

torch.set_num_threads(1)   # several test workers share few cores


@pytest.mark.e2e
def test_three_agents_fuse_like_jax():
    jframes, tframes, jv, tv, t_wc, windows = cases.scenario(
        cases.THREE_AGENTS)
    js = JServer(cases.CFG, jv, run_gba=True)
    jevents = cases.run(js, jframes, windows)
    ts = TServer(cases.TCFG, tv, run_gba=True, device="cpu")
    tevents = cases.run(ts, tframes, windows)
    assert js.multimap.n_maps == ts.multimap.n_maps == 1
    assert len(tevents) == len(jevents) >= 2
    cases.assert_fusions_match(jevents, tevents, jv, parted=(0,))
    j_ate = cases.keyframe_ate(jax_fields(js.shared.state), windows, t_wc)
    t_ate = cases.keyframe_ate(convert.map_state_to_numpy(ts.shared.state),
                               windows, t_wc)
    assert t_ate < 0.12
    assert abs(t_ate - j_ate) <= max(0.1 * j_ate, 2e-3), (t_ate, j_ate)
    assert all(s["ckf"] >= 1 and s["mkf"] >= 1 for s in ts.stats)
