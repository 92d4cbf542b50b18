"""The port's multi-agent server against the JAX package's on the
three-agent fixture of tests/test_server.py (three agents on overlapping
thirds of a 30-frame corridor; tests/torch_server_cases.py runs it through
both servers on the JAX package's features): one map in both, the same
fusions in the same order (agent, map ids, query and match keyframes), each
match's Sim3 within 1e-4, and after the global BAs the fused keyframes' ATE
under 0.12 m and within 10 % or 2 mm of the JAX run's, whichever is larger
(global BA is held by outcome: CG is chaotic in float32). Kept apart from
tests/test_torch_server.py so the two fixtures run on two test workers."""
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
    cases.assert_fusions_match(jevents, tevents)
    j_ate = cases.keyframe_ate(jax_fields(js.shared.state), windows, t_wc)
    t_ate = cases.keyframe_ate(convert.map_state_to_numpy(ts.shared.state),
                               windows, t_wc)
    assert t_ate < 0.12
    assert abs(t_ate - j_ate) <= max(0.1 * j_ate, 2e-3), (t_ate, j_ate)
    assert all(s["ckf"] >= 1 and s["mkf"] >= 1 for s in ts.stats)
