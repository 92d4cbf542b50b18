"""Views of the JAX package's objects that the parity tests and the JAX-side
tools put in front of a tracker, so that a JAX run follows the reference
where the port's repairs depart from the JAX package. They import nothing
of either package; the JAX package is not changed."""
import contextlib

import jax.numpy as jnp
import numpy as np


class OwnMapGates:
    """A JAX tracker's view of its SharedMap whose `n_kf` is the number of
    live keyframes of the tracker's own map (the reference's
    Map::KeyFramesInMap), with a keyframe slot allocated and not yet
    inserted counted, as the port's SharedMap.n_kf_in_map counts it. Every
    other attribute is the SharedMap's. The JAX package's two keyframe-count
    gates (the reference keyframe's minimum-observation gate and the local-BA
    gate) read the slot high-water mark `n_kf`, counting every agent's
    keyframes and dead slots (ROADMAP.md queue 3, fault 9); through this
    view a JAX run follows the reference, and the port's repaired gates can
    be held against it run for run. The JAX package is not changed."""

    def __init__(self, shared, map_of):
        object.__setattr__(self, "_shared", shared)
        object.__setattr__(self, "_map_of", map_of)
        object.__setattr__(self, "_pending", None)

    @property
    def n_kf(self):
        st = self._shared.state
        valid = np.asarray(st.kf_valid)
        n = int(np.sum((np.asarray(st.kf_map) == self._map_of()) & valid))
        return n + int(self._pending is not None and not valid[self._pending])

    def alloc_kf(self):
        slot = self._shared.alloc_kf()
        object.__setattr__(self, "_pending", slot)
        return slot

    def __getattr__(self, name):
        return getattr(self._shared, name)

    def __setattr__(self, name, value):
        setattr(self._shared, name, value)


def own_map_gates(server, tracker):
    """Give a tracker of the JAX MultiAgentServer the reference's gates:
    its map is the one the server's registry holds for its agent."""
    tracker.shared = OwnMapGates(
        tracker.shared, lambda: server.multimap.map_of(tracker.agent))
    return tracker


# larger than any agent's keyframe creations (the port's
# mapping.AGENT_SEQ_STRIDE): two agents' encoded sequences never come within
# the culling's age window of each other
AGENT_SEQ_STRIDE = 1 << 20


class OwnAgentAges:
    """A JAX tracker's view of its SharedMap under which map-point culling
    counts a point's age in its own agent's keyframes, as the port's
    mapping.cull_points_step does. The JAX culling reads kf_seq, the
    creation uid every agent advances, and so culls another agent's young
    map (ROADMAP.md queue 3, fault 11). While one of the tracker's
    keyframes is inserted (from its slot's allocation to the next write of
    the state, the keyframe pipeline's or the initialization's result),
    kf_seq holds each live slot's ordinal among its agent's keyframe
    creations plus agent * AGENT_SEQ_STRIDE, the port's
    SharedMap.kf_agent_seq; the write restores the uids. With
    `every_agents_creations` the ordinal is the creation uid instead: only
    the agent's own points are culled for age, and their age counts every
    agent's keyframes (a variant of the repair, read by
    tools/jax_split_start.py). `registry` is shared by the views of one
    SharedMap. Every other attribute is the SharedMap's; the JAX package is
    not changed."""

    def __init__(self, shared, agent, registry,
                 every_agents_creations=False):
        object.__setattr__(self, "_shared", shared)
        object.__setattr__(self, "_agent", agent)
        object.__setattr__(self, "_registry", registry)
        object.__setattr__(self, "_uids", None)
        object.__setattr__(self, "_by_uid", every_agents_creations)

    def alloc_kf(self):
        reg = self._registry
        slot = self._shared.alloc_kf()
        n = reg["created"].get(self._agent, 0)
        reg["created"][self._agent] = n + 1
        st = self._shared.state
        seq = np.asarray(st.kf_seq)
        reg["seq"][slot] = self._agent * AGENT_SEQ_STRIDE + (
            int(seq[slot]) if self._by_uid else n)
        uids = seq if self._uids is None else self._uids
        uids = uids.copy()
        uids[slot] = seq[slot]
        object.__setattr__(self, "_uids", uids)
        self._shared.state = st._replace(kf_seq=jnp.asarray(
            np.where(uids >= 0, reg["seq"], uids).astype(seq.dtype)))
        return slot

    def __getattr__(self, name):
        return getattr(self._shared, name)

    def __setattr__(self, name, value):
        if name == "state" and self._uids is not None:
            value = value._replace(kf_seq=jnp.where(
                value.kf_seq < 0, value.kf_seq,
                jnp.asarray(self._uids, value.kf_seq.dtype)))
            object.__setattr__(self, "_uids", None)
        setattr(self._shared, name, value)


def port_views(server, tracker, every_agents_creations=False):
    """Give a tracker of the JAX MultiAgentServer the port's repairs: the
    reference's keyframe-count gates (OwnMapGates, fault 9; its map is the
    one the server's registry holds for its agent) and map-point ages in
    its own agent's keyframes (OwnAgentAges, fault 11;
    every_agents_creations as there). The agents' creation counts live on
    the SharedMap object, one registry for all its trackers."""
    shared = server.shared
    reg = shared.__dict__.setdefault("port_agent_seq", {
        "created": {},
        "seq": np.full(len(np.asarray(shared.state.kf_seq)), -1, np.int64)})
    tracker.shared = OwnAgentAges(
        OwnMapGates(shared, lambda: server.multimap.map_of(tracker.agent)),
        tracker.agent, reg, every_agents_creations)
    return tracker


@contextlib.contextmanager
def best_covisible_reference(tracker, steps):
    """While active, a JAX tracker in localization mode tracks the local map
    around the keyframe that observes the most of the frame's map points
    (the lowest slot among equals) and makes it its reference keyframe, as
    the port's tracker does in the mode (its steps.best_covisible_kf, the
    reference's UpdateLocalKeyFrames); the JAX tracker keeps the last
    keyframe it made (ROADMAP.md, fault 13). `steps` is the JAX package's
    runtime.steps, whose track_local_map_step the localization path calls
    with the reference keyframe. Enter it only around frames tracked in the
    mode: the mapping path's jitted step, traced inside it, would take the
    wrapper in. The JAX package is not changed."""
    real = steps.track_local_map_step

    def track(state, feats, q, t, frame_mp, ref_kf, cfg):
        obs = np.asarray(state.mp_obs_kf)
        fmp = np.asarray(frame_mp)
        kfs = obs[np.clip(fmp, 0, len(obs) - 1)]
        kfs = kfs[(fmp >= 0)[:, None] & (kfs >= 0)]
        if kfs.size:
            ref_kf = int(np.argmax(np.bincount(
                kfs, minlength=np.asarray(state.kf_valid).shape[0])))
            tracker.ref_kf = ref_kf
        return real(state, feats, q, t, frame_mp, ref_kf, cfg)

    steps.track_local_map_step = track
    try:
        yield
    finally:
        steps.track_local_map_step = real
