"""The port's offline visualizer (viz/plot.py) against the JAX package's,
the counterpart of tests/test_viz.py: the same map, frame and trajectories
drawn by both packages give PNGs of more than 5 kB each and the same
pixels (the image arrays decoded from both files compared: found equal;
asserted within 1 / 255 on every pixel, the keyframe centres coming from
two float32 inversions)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_orb_slam2_tpu import viz as jviz
from multiagent_orb_slam2_tpu.config import Capacities, OrbConfig, SlamConfig
from multiagent_orb_slam2_tpu.mapstate import state as jms
from multiagent_orb_slam2_tpu.ops.frame import FrameFeatures
from multiagent_orb_slam2_tpu_torch import convert, viz

import torch_parity  # noqa: F401  (one torch thread per test worker)

mpimg = pytest.importorskip("matplotlib.image")

CFG = SlamConfig(orb=OrbConfig(n_features=64, n_levels=2),
                 caps=Capacities(max_keyframes=8, max_points=256,
                                 max_features=64, local_points=128))


def _inputs():
    rng = np.random.default_rng(0)
    st = jms.empty_map_state(CFG)
    st = st._replace(
        kf_valid=st.kf_valid.at[:3].set(True),
        kf_agent=st.kf_agent.at[:3].set(jnp.asarray([0, 0, 1])),
        kf_t=st.kf_t.at[:3].set(jnp.asarray(rng.normal(size=(3, 3)))),
        mp_valid=st.mp_valid.at[:100].set(True),
        mp_pos=st.mp_pos.at[:100].set(jnp.asarray(rng.normal(size=(100, 3)))),
        mp_agent=st.mp_agent.at[:100].set(0),
        covis=st.covis.at[0, 1].set(30).at[1, 0].set(30))
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    F = 64
    feats = FrameFeatures(
        xy=jnp.asarray(rng.uniform(0, 150, (F, 2)), jnp.float32),
        response=jnp.zeros(F), level=jnp.zeros(F, jnp.int32),
        angle=jnp.zeros(F), desc=jnp.zeros((F, 8), jnp.uint32),
        valid=jnp.ones(F, bool), u_right=jnp.full(F, -1.0),
        depth=jnp.full(F, -1.0))
    fm = jnp.full((F,), -1, jnp.int32).at[:20].set(5)
    trajs = {"est": rng.normal(size=(50, 3))}
    gt = rng.normal(size=(50, 3))
    return st, img, feats, fm, trajs, gt


def _same_pixels(a, b):
    pa, pb = mpimg.imread(a), mpimg.imread(b)
    assert pa.shape == pb.shape
    assert np.abs(pa - pb).max() <= 1.0 / 255


def test_plot_map_frame_and_trajectories_match_jax(tmp_path):
    st, img, feats, fm, trajs, gt = _inputs()
    tst = torch_parity.torch_state_from_jax(st)
    tfeats = torch_parity.torch_feats_from_jax(feats)
    files = {}
    for pkg, args in (("jax", (jviz, st, img, feats, fm)),
                      ("torch", (viz, tst, torch.from_numpy(img), tfeats,
                                 torch.tensor(np.asarray(fm))))):
        mod, state, im, ft, frame_mp = args
        paths = [str(tmp_path / f"{pkg}_{n}.png")
                 for n in ("map", "frame", "traj")]
        mod.plot_map(state, paths[0])
        mod.draw_frame(im, ft, frame_mp, paths[1])
        mod.plot_trajectories(paths[2], trajs, gt=gt)
        files[pkg] = paths
    for a, b in zip(files["jax"], files["torch"]):
        assert os.path.getsize(b) > 5000
        _same_pixels(a, b)


def test_importing_viz_loads_no_matplotlib():
    import subprocess
    import sys
    code = ("import sys; import multiagent_orb_slam2_tpu_torch.viz; "
            "assert 'matplotlib' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr[-2000:]
