"""The port's multi-agent server (multiagent_orb_slam2_tpu_torch.server)
against the JAX package's, on the two-agent fixture of tests/test_server.py
(tests/torch_server_cases.py runs it through both servers on the JAX
package's features).

- MultiMap: equal registries along a scripted sequence of adds and merges.
- correct_map on the two-map state the JAX run had at its first fusion,
  with a seeded Sim3: keyframe poses and points within 1e-5;
  reverse_spanning_tree: kf_parent equal.
- merge_maps on that state with the JAX run's own match: poses and points
  within 1e-4, integer arrays equal on >= 99.9 % of their entries (the
  standing tolerances of steps / mapping), the registry equal.
- covisibility_discovery on the JAX run's merged state: the candidate masks
  and the (moved, candidate) pairs equal, the state after it as above. The
  port moves live keyframes only; the JAX package also walks culled slots
  that still carry the map's label, whose rows are asserted empty.
- The whole run: one map in both, the same fusions (agent, map ids, query
  and match keyframes), the match's Sim3 within 1e-4; after the global BA
  the fused keyframes' ATE under 0.12 m (the JAX test's bound) and within
  10 % or 2 mm of the JAX run's, whichever is larger (CG is chaotic in
  float32, so global BA is held by outcome). The stats rows: ckf counts
  live keyframes in the port; where no culled slot carries the map's label
  it equals the JAX count.
- _handle_reset: registry and consistency groups equal; the port's tracker
  restarts NOT_INITIALIZED where the JAX package's stays as it was (the
  reference's Tracking::Reset, ROADMAP.md queue 3).
"""
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from multiagent_orb_slam2_tpu.runtime.tracker import TrackerState as JState
from multiagent_orb_slam2_tpu.server import MultiAgentServer as JServer
from multiagent_orb_slam2_tpu.server import MultiMap as JMultiMap
from multiagent_orb_slam2_tpu.server import fusion as jfusion
from multiagent_orb_slam2_tpu.vocab import bow as jbow
from multiagent_orb_slam2_tpu_torch import convert
from multiagent_orb_slam2_tpu_torch.runtime.tracker import (
    TrackerState as TState)
from multiagent_orb_slam2_tpu_torch.server import MultiAgentServer as TServer
from multiagent_orb_slam2_tpu_torch.server import MultiMap as TMultiMap
from multiagent_orb_slam2_tpu_torch.server import fusion as tfusion

import torch_server_cases as cases
from torch_parity import (assert_states_match, jax_fields,
                          torch_state_from_jax)

torch.set_num_threads(1)   # several test workers share few cores


@pytest.fixture(scope="module")
def two_agents():
    """Both servers over the two-agent fixture; the JAX run also records
    its first fusion: the state and match before merge_maps, the state
    after it, and covisibility discovery's inputs, candidate masks and
    result."""
    jframes, tframes, jv, tv, t_wc, windows = cases.scenario(
        cases.TWO_AGENTS)
    seen = {}
    real_merge, real_cd = jfusion.merge_maps, jfusion.covisibility_discovery
    real_cand = jfusion._batched_cd_candidates

    def merge(shared, multimap, match, cur_map, dst_map, cfg, **kw):
        if "merge" not in seen:
            seen["merge"] = dict(state=shared.state, match=match,
                                 cur_map=cur_map, dst_map=dst_map,
                                 registry=dict(multimap.map_of_agent))
        n = real_merge(shared, multimap, match, cur_map, dst_map, cfg, **kw)
        seen.setdefault("merged", dict(
            state=shared.state, n_moved=n,
            registry=dict(multimap.map_of_agent)))
        return n

    def cand(db, vocab, desc_b, valid_b, moved_mask, covis):
        out = real_cand(db, vocab, desc_b, valid_b, moved_mask, covis)
        seen.setdefault("cand", np.asarray(out))
        return out

    def cd(shared, server_db, vocab, moved, cfg):
        first = "cd" not in seen
        if first:
            seen["cd"] = dict(db=server_db, moved=list(moved))
        out = real_cd(shared, server_db, vocab, moved, cfg)
        if first:
            seen["cd"].update(state=shared.state, n=out[0])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfusion, "merge_maps", merge)
        mp.setattr(jfusion, "covisibility_discovery", cd)
        mp.setattr(jfusion, "_batched_cd_candidates", cand)
        js = JServer(cases.CFG, jv, run_gba=True)
        jevents = cases.run(js, jframes, windows)
    ts = TServer(cases.TCFG, tv, run_gba=True, device="cpu")
    tevents = cases.run(ts, tframes, windows)
    return types.SimpleNamespace(js=js, ts=ts, jevents=jevents,
                                 tevents=tevents, seen=seen, jv=jv, tv=tv,
                                 t_wc=t_wc, windows=windows)


def test_multimap_matches_jax():
    j, t = JMultiMap(), TMultiMap()
    script = [("add", 0, 0), ("add", 1, 1), ("add", 2, 2), ("merge", 1, 0),
              ("add", 3, 3), ("merge", 0, 3), ("add", 1, 4), ("merge", 4, 2)]
    for op, a, b in script:
        getattr(j, op)(a, b)
        getattr(t, op)(a, b)
        assert t.map_of_agent == j.map_of_agent and t.n_maps == j.n_maps
        for m in range(5):
            assert t.agents_of(m) == j.agents_of(m)
    assert t.map_of(1) == j.map_of(1) == 2 and t.n_maps == 2


def _sim3(seed):
    rng = np.random.default_rng(seed)
    q = np.r_[1.0, rng.normal(0, 0.1, 3)]
    q /= np.linalg.norm(q)
    return (np.float32(rng.uniform(0.8, 1.2)), q.astype(np.float32),
            rng.normal(0, 0.5, 3).astype(np.float32))


@pytest.mark.e2e
def test_correct_map_and_spanning_tree_match_jax(two_agents):
    m = two_agents.seen["merge"]
    jst = m["state"]
    tst = torch_state_from_jax(jst)
    kf_q, kf_m = m["match"].kf_query, m["match"].kf_match
    for seed in (0, 1):
        s, q, t = _sim3(seed)
        j = jfusion.correct_map(jst, jst.kf_map == m["cur_map"],
                                jst.mp_map == m["cur_map"], kf_q,
                                jnp.asarray(s), jnp.asarray(q),
                                jnp.asarray(t))
        p = tfusion.correct_map(tst, tst.kf_map == m["cur_map"],
                                tst.mp_map == m["cur_map"], kf_q,
                                torch.tensor(s), torch.from_numpy(q),
                                torch.from_numpy(t))
        for name in ("kf_q", "kf_t", "mp_pos"):
            np.testing.assert_allclose(getattr(p, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       atol=1e-5, rtol=1e-5, err_msg=name)
    j = jfusion.reverse_spanning_tree(jst, kf_q, kf_m)
    p = tfusion.reverse_spanning_tree(tst, kf_q, kf_m)
    np.testing.assert_array_equal(p.kf_parent.numpy(),
                                  np.asarray(j.kf_parent))
    assert not np.array_equal(np.asarray(j.kf_parent),
                              np.asarray(jst.kf_parent))


@pytest.mark.e2e
def test_merge_maps_matches_jax(two_agents):
    m, after = two_agents.seen["merge"], two_agents.seen["merged"]
    match = convert.sim3_match_from_numpy(
        {k: np.asarray(getattr(m["match"], k))
         for k in ("kf_query", "kf_match", "s", "q", "t", "point_ids",
                   "n_matches")}, "cpu")
    shared = types.SimpleNamespace(state=torch_state_from_jax(m["state"]))
    multimap = TMultiMap()
    for a, mid in m["registry"].items():
        multimap.add(a, mid)
    tfusion.merge_maps(shared, multimap, match, m["cur_map"], m["dst_map"],
                       cases.TCFG)
    assert multimap.map_of_agent == after["registry"]
    assert_states_match(after["state"], shared.state, int_share=0.999,
                        atol=1e-4, float_share=1.0)
    kf_map = shared.state.kf_map.numpy()
    assert not (kf_map == m["cur_map"]).any()
    assert not shared.state.kf_fixed_origin.numpy()[
        np.asarray(m["state"].kf_map) == m["cur_map"]].any()


@pytest.mark.e2e
def test_covisibility_discovery_matches_jax(two_agents):
    cd = two_agents.seen["cd"]
    jst = two_agents.seen["merged"]["state"]
    tst = torch_state_from_jax(jst)
    db = convert.kfdb_from_numpy(jax_fields(cd["db"]), "cpu")
    valid = np.asarray(jst.kf_valid)
    moved = [k for k in cd["moved"] if valid[k]]
    jcand = two_agents.seen["cand"][:len(cd["moved"])]
    dead = [i for i, k in enumerate(cd["moved"]) if not valid[k]]
    assert not jcand[dead].any()
    live_rows = [i for i, k in enumerate(cd["moved"]) if valid[k]]
    mask = torch.zeros(tst.kf_q.shape[0], dtype=torch.bool)
    mask[moved] = True
    tcand = tfusion.cd_candidates(db, two_agents.tv, tst, moved,
                                  mask).numpy()
    np.testing.assert_array_equal(tcand, jcand[live_rows])
    kk, cc = np.nonzero(tcand)
    jk, jc = np.nonzero(jcand)
    assert list(zip(np.asarray(moved)[kk], cc)) == \
        list(zip(np.asarray(cd["moved"])[jk], jc))
    shared = types.SimpleNamespace(state=tst)
    n, per_kf = tfusion.covisibility_discovery(shared, db, two_agents.tv,
                                               moved, cases.TCFG)
    assert n == cd["n"] and len(per_kf) == len(moved)
    assert_states_match(cd["state"], shared.state, int_share=0.999,
                        atol=1e-4, float_share=1.0)


@pytest.mark.e2e
def test_two_agents_fuse_like_jax(two_agents):
    r = two_agents
    assert r.js.multimap.n_maps == r.ts.multimap.n_maps == 1
    assert len(r.tevents) == len(r.jevents) >= 1
    cases.assert_fusions_match(r.jevents, r.tevents)
    j_ate = cases.keyframe_ate(jax_fields(r.js.shared.state), r.windows,
                               r.t_wc)
    t_ate = cases.keyframe_ate(convert.map_state_to_numpy(r.ts.shared.state),
                               r.windows, r.t_wc)
    assert t_ate < 0.12
    assert abs(t_ate - j_ate) <= max(0.1 * j_ate, 2e-3), (t_ate, j_ate)
    # the stats rows: keyframe counts exact, point counts within 0.5 %
    dead_labelled = np.sum(
        (np.asarray(r.seen["merge"]["state"].kf_map) == r.jevents[0]["cur_map"])
        & ~np.asarray(r.seen["merge"]["state"].kf_valid))
    for js, ts in zip(r.js.stats, r.ts.stats):
        assert (ts["cur_map"], ts["dst_map"], ts["mkf"]) == \
            (js["cur_map"], js["dst_map"], js["mkf"])
        for k in ("cmp", "mmp"):
            assert abs(ts[k] - js[k]) <= 0.005 * js[k], k
        assert set(ts) == set(js)
    first = r.ts.stats[0]
    assert first["ckf"] == r.seen["merged"]["n_moved"] - dead_labelled
    assert first["ckf"] == len([k for k in r.seen["cd"]["moved"] if np.asarray(
        r.seen["merge"]["state"].kf_valid)[k]])


def test_handle_reset_matches_jax():
    """Two registered agents; agent 1 has consistency groups and is LOST
    when it resets."""
    descs = np.random.default_rng(3).integers(0, 2 ** 32, (200, 8),
                                              dtype=np.uint32)
    jv = jbow.train_vocabulary(descs, k=4, depth=2)
    tv = convert.vocabulary_from_numpy(
        {"centroids": [np.asarray(c) for c in jv.centroids],
         "idf": np.asarray(jv.idf), "k": jv.k, "depth": jv.depth}, "cpu")
    js = JServer(cases.CFG, jv)
    ts = TServer(cases.TCFG, tv, device="cpu")
    for server, lost in ((js, JState.LOST), (ts, TState.LOST)):
        trackers = [server.register_client(a) for a in range(2)]
        server.consistency[1] = [({3, 4}, 1)]
        server.loop_closers[1].consistency.groups = [({3}, 2)]
        trackers[1].state = lost
        trackers[1].reset()
    assert ts.multimap.map_of_agent == js.multimap.map_of_agent == {0: 0,
                                                                    1: 2}
    assert ts.trackers[1].map_id == js.trackers[1].map_id == 2
    assert ts.consistency == js.consistency == {0: [], 1: []}
    assert ts.loop_closers[1].consistency.groups == \
        js.loop_closers[1].consistency.groups == []
    # the deviation: Tracking::Reset restarts the tracker
    assert js.trackers[1].state == JState.LOST
    assert ts.trackers[1].state == TState.NOT_INITIALIZED
