"""Where the two packages' runs of the three-agent server fixture part, and
what that does to its fusions' Sim3s, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_fixture_parting.py [ticks] [fusions]

The fixture is tests/test_torch_server_three_agents.py's
(tests/torch_server_cases.THREE_AGENTS: three agents on overlapping thirds
of a 30-frame corridor, the JAX package's features given to both
packages, the JAX trackers through tests/jax_views.port_views, the port
drawing the JAX package's Sim3 RANSAC samples). Prints:

1. after each of agent 0's first four ticks, how far the two runs' map
   states are apart (points kept by one run only, the largest point and
   keyframe-translation differences);
2. at tick 3's keyframe pipeline (steps.keyframe_pipeline_step, the
   first to follow a local BA's rounding), each package's pipeline given
   the JAX run's input state and the port run's, everything else the JAX
   run's: the whole pipeline, the pipeline without local BA, and local BA
   alone on the pipeline's output; and the two packages' pipelines and
   local BAs on one input;
3. the whole runs as the test drives them: for every fusion, the gap
   between the two runs' Sim3s and between the port's Sim3 and the JAX
   package's compute_sim3 on the state the port computed it on (and the
   port's compute_sim3 there with its own RANSAC samples).

Imports both packages and the tests' helpers; one process, minutes.
"""
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from multiagent_orb_slam2_tpu.runtime import loop_closing as jlc  # noqa
from multiagent_orb_slam2_tpu.runtime import steps as jsteps  # noqa: E402
from multiagent_orb_slam2_tpu.server import MultiAgentServer as JServer  # noqa
from multiagent_orb_slam2_tpu_torch import convert  # noqa: E402
from multiagent_orb_slam2_tpu_torch.runtime import loop_closing as tlc  # noqa
from multiagent_orb_slam2_tpu_torch.runtime import steps as tsteps  # noqa
from multiagent_orb_slam2_tpu_torch.server import MultiAgentServer as TServer  # noqa

import torch_server_cases as cases  # noqa: E402
from torch_parity import (jax_fields, jax_state_from_torch, port_views,  # noqa
                          threads, torch_feats_from_jax, torch_state_from_jax)

TICKS = 4


def apart(label, a, b):
    """a, b: map-state fields (numpy) of the two sides."""
    both = a["mp_valid"] & b["mp_valid"]
    d = np.abs(a["mp_pos"] - b["mp_pos"]).max(-1)[both]
    kv = a["kf_valid"] & b["kf_valid"]
    print(f"{label}: points kept by one side only "
          f"{np.nonzero(a['mp_valid'] != b['mp_valid'])[0].tolist()}, "
          f"observations differing {int(np.sum(a['mp_obs_kf'] != b['mp_obs_kf']))}, "
          f"largest point difference {d.max():.3g} m "
          f"({int(np.sum(d > 1e-4))} above 1e-4 m), largest keyframe "
          f"translation difference "
          f"{np.abs(a['kf_t'] - b['kf_t'])[kv].max():.3g}", flush=True)


def first_ticks(scenario):
    jframes, tframes, jv, tv, _, _ = scenario
    js = JServer(cases.CFG, jv, run_gba=True)
    ts = TServer(cases.TCFG, tv, run_gba=True, device="cpu")
    calls = {"j": [], "t": []}
    real_j, real_t = jsteps.keyframe_pipeline_step, \
        tsteps.keyframe_pipeline_step

    def keep(side, real):
        def step(*args):
            calls[side].append(args)
            return real(*args)
        return step
    jsteps.keyframe_pipeline_step = keep("j", real_j)
    tsteps.keyframe_pipeline_step = keep("t", real_t)
    try:
        jtr = port_views(js, js.register_client(0))
        ttr = ts.register_client(0)
        with threads(2):
            for i in range(TICKS):
                jtr.track_features(jframes[i], frame_id=i)
                ttr.track_features(tframes[i], frame_id=i)
                js.process_new_keyframes()
                ts.process_new_keyframes()
                apart(f"tick {i}, the two runs",
                      jax_fields(js.shared.state),
                      convert.map_state_to_numpy(ts.shared.state))
    finally:
        jsteps.keyframe_pipeline_step = real_j
        tsteps.keyframe_pipeline_step = real_t
    return calls["j"][-1], calls["t"][-1]


def pipelines(jargs, targs):
    """Tick 3's pipeline on the JAX run's input and the port run's."""
    rest, run_ba = jargs[1:11], jargs[11]
    jstate, pstate = jargs[0], jax_state_from_torch(targs[0])
    apart("tick 3 pipeline inputs", jax_fields(jstate), jax_fields(pstate))

    def port(state, ba):
        st = torch_state_from_jax(state)
        args = [torch_feats_from_jax(rest[0])] + [
            torch.from_numpy(np.array(x)) for x in rest[1:4]] + [
            int(x) for x in rest[4:9]]
        with threads(2):
            out = tsteps.keyframe_pipeline_step(
                st, *args, cases.TCFG, ba, st.kf_seq.clone())
        return convert.map_state_to_numpy(out[0])

    apart("JAX pipeline, JAX run's input vs the port run's",
          jax_fields(jsteps.keyframe_pipeline_step(jstate, *rest, run_ba)[0]),
          jax_fields(jsteps.keyframe_pipeline_step(pstate, *rest, run_ba)[0]))
    pre_j = jsteps.keyframe_pipeline_step(jstate, *rest, False)[0]
    pre_p = jsteps.keyframe_pipeline_step(pstate, *rest, False)[0]
    apart("JAX pipeline without local BA, the same two inputs",
          jax_fields(pre_j), jax_fields(pre_p))
    slot = int(rest[7])
    apart("JAX local BA alone on those",
          jax_fields(jsteps.local_ba_step(pre_j, slot, cases.CFG)),
          jax_fields(jsteps.local_ba_step(pre_p, slot, cases.CFG)))
    apart("port pipeline, JAX run's input vs the port run's",
          port(jstate, run_ba), port(pstate, run_ba))
    apart("JAX pipeline vs port pipeline, the JAX run's input",
          jax_fields(jsteps.keyframe_pipeline_step(jstate, *rest, run_ba)[0]),
          port(jstate, run_ba))
    with threads(2):
        tl = tsteps.local_ba_step(torch_state_from_jax(pre_j), slot,
                                  cases.TCFG)
    apart("JAX local BA vs port local BA, one input",
          jax_fields(jsteps.local_ba_step(pre_j, slot, cases.CFG)),
          convert.map_state_to_numpy(tl))


def fusions(scenario):
    jframes, tframes, jv, tv, _, windows = scenario
    js = JServer(cases.CFG, jv, run_gba=True)
    jevents = cases.run(js, jframes, windows)
    ts = TServer(cases.TCFG, tv, run_gba=True, device="cpu")
    tevents = cases.run(ts, tframes, windows)
    for i, (je, te) in enumerate(zip(jevents, tevents)):
        shared = types.SimpleNamespace(state=te["state"],
                                       kf_uid=te["kf_uid"])
        m = jlc.LoopCloser(cases.CFG, jv).compute_sim3(
            shared, te["kf_query"], te["kf_match"])
        want = np.concatenate([[m.s], np.asarray(m.q), np.asarray(m.t)])
        # the port's compute_sim3 on the same state with its own sampler
        own = tlc.LoopCloser(cases.TCFG, tv).compute_sim3(
            types.SimpleNamespace(state=torch_state_from_jax(te["state"]),
                                  kf_uid=te["kf_uid"]),
            te["kf_query"], te["kf_match"])
        own = np.concatenate([[float(own.s)], np.asarray(own.q),
                              np.asarray(own.t)])
        print(f"fusion {i}: agent {te['agent']}, keyframes "
              f"{te['kf_query']} -> {te['kf_match']} (JAX run: "
              f"{je['agent']}, {je['kf_query']} -> {je['kf_match']}); the "
              f"runs' Sim3s apart by "
              f"{np.abs(cases._aligned(te['sim3'], je['sim3']) - je['sim3']).max():.3g}; "
              f"the port's from the JAX compute_sim3 on its state by "
              f"{np.abs(cases._aligned(te['sim3'], want) - want).max():.3g}"
              f" (with the port's own RANSAC samples "
              f"{np.abs(cases._aligned(own, want) - want).max():.3g})",
              flush=True)


def main(argv=None):
    parts = (argv if argv is not None else sys.argv[1:]) or ["ticks",
                                                           "fusions"]
    scenario = cases.scenario(cases.THREE_AGENTS)
    if "ticks" in parts:
        pipelines(*first_ticks(scenario))
    if "fusions" in parts:
        fusions(scenario)


if __name__ == "__main__":
    main()
