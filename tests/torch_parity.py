"""Shared helpers for the tests that hold the PyTorch port
(multiagent_orb_slam2_tpu_torch) against the JAX package: the small
configuration, a rendered stereo sequence, and numpy bridges between the two
packages' state tuples."""
import contextlib
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import torch

from multiagent_orb_slam2_tpu.config import (SlamConfig, OrbConfig, Capacities,
                                             Sensor, TrackingConfig)
from multiagent_orb_slam2_tpu.geometry.camera import Intrinsics
from multiagent_orb_slam2_tpu.io.synthetic import BoxScene, corridor_trajectory
from multiagent_orb_slam2_tpu.mapstate.state import MapState as JMapState
from multiagent_orb_slam2_tpu.ops.frame import FrameFeatures as JFrameFeatures

from multiagent_orb_slam2_tpu_torch import convert

# the suite runs several worker processes on few cores: one intra-op thread
# per process, or the workers' thread pools fight over the cores
torch.set_num_threads(1)

# the small configuration of tests/test_tracking.py
CAM = Intrinsics(fx=230.0, fy=230.0, cx=160.0, cy=120.0, bf=115.0,
                 width=320, height=240)
CFG = SlamConfig(
    camera=CAM, sensor=Sensor.STEREO,
    orb=OrbConfig(n_features=400, n_levels=4),
    tracking=TrackingConfig(max_frames_between_kf=10, th_depth=60.0),
    caps=Capacities(max_keyframes=32, max_points=8192, max_features=512,
                    local_points=4096),
)
TCFG = convert.config_from_dict({**dataclasses.asdict(CFG), "camera": CAM})
STEP = 0.15


@functools.lru_cache(maxsize=2)
def sequence(n_frames: int):
    """(frames [(left, right)], (q_wc, t_wc)) of the seed-7 corridor."""
    scene = BoxScene(seed=7, z_far=40.0)
    q_wc, t_wc = corridor_trajectory(n_frames, step=STEP, seed=1)
    frames = [scene.render_stereo(CAM, q_wc[i], t_wc[i])[:2]
              for i in range(n_frames)]
    return frames, (q_wc, t_wc)


def _jax_tuple(cls, fields: dict):
    return cls(**{k: (None if v is None else jnp.asarray(v))
                  for k, v in fields.items()})


def jax_fields(obj) -> dict:
    """A JAX NamedTuple of arrays -> {name: numpy}."""
    return {k: (None if v is None else np.asarray(v))
            for k, v in obj._asdict().items()}


def jax_state_from_torch(tstate) -> JMapState:
    return _jax_tuple(JMapState, convert.map_state_to_numpy(tstate))


def torch_state_from_jax(jstate):
    return convert.map_state_from_numpy(jax_fields(jstate), "cpu")


def jax_feats_from_torch(tfeats) -> JFrameFeatures:
    return _jax_tuple(JFrameFeatures, convert.frame_features_to_numpy(tfeats))


def torch_feats_from_jax(jfeats):
    return convert.frame_features_from_numpy(jax_fields(jfeats), "cpu")


def t2j(t):
    """torch tensor -> jnp array (descriptors must go through the state /
    feature bridges, which re-view their bits)."""
    return jnp.asarray(t.detach().cpu().numpy())


def j2t(a):
    return convert.to_tensor(np.asarray(a), "cpu")


def assert_states_match(jstate, tstate, int_share=1.0, atol=1e-5,
                        float_share=1.0, skip=()):
    """Field by field: integer / bool arrays equal on at least `int_share`
    of their entries, float arrays within atol on at least `float_share`."""
    tn = convert.map_state_to_numpy(tstate)
    for name, jv in jax_fields(jstate).items():
        if name in skip:
            continue
        tv = tn[name]
        assert jv.shape == tv.shape, name
        if jv.dtype.kind == "f":
            share = float(np.mean(np.abs(jv - tv) <= atol
                                  + 1e-5 * np.abs(jv)))
            assert share >= float_share, (name, share)
        else:
            share = float(np.mean(jv == tv))
            assert share >= int_share, (name, share)


@contextlib.contextmanager
def threads(n: int):
    """n intra-op threads for one long port run; every test worker starts
    with one (above), and gets it back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def interpreted_pallas_call():
    """While active, `pl.pallas_call` adds interpret=True and drops the TPU
    compiler parameters, so a function of the JAX package that reaches a
    Pallas kernel runs the kernel body in the Pallas interpreter on the CPU.
    Enter it before the function is first traced; nothing in the JAX package
    changes."""
    import jax.experimental.pallas as pl
    real = pl.pallas_call

    @functools.wraps(real)
    def interpreted(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    pl.pallas_call = interpreted
    try:
        yield
    finally:
        pl.pallas_call = real


@functools.lru_cache(maxsize=1)
def port_tracker_after(n_frames: int):
    """The port's tracker (CPU, own feature extraction, no local BA) after
    the first n_frames (at most 11) of the corridor; also returns the
    features of frames 0..n_frames."""
    from multiagent_orb_slam2_tpu_torch.ops import frame as tframe
    from multiagent_orb_slam2_tpu_torch.runtime import tracker as ttr
    frames, _ = sequence(12)
    shared = ttr.SharedMap(TCFG, device="cpu")
    tr = ttr.Tracker(TCFG, shared, run_local_ba=False, device="cpu")
    feats = []
    for i in range(n_frames + 1):
        left, right = frames[i]
        feats.append(tframe.extract_frame(left, TCFG, right_img=right,
                                          device="cpu"))
    for i in range(n_frames):
        tr.track_features(feats[i], i)
    return tr, shared, feats
