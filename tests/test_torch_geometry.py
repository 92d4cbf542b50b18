"""The port's geometry/se3.py and geometry/camera.py against the JAX ones,
function by function, on the same seeded inputs: 1e-6 absolute, plus 1e-6
relative for magnitudes above 1 (a float32 ulp at 8 is 9.5e-7)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)   # several test workers share few cores

from multiagent_orb_slam2_tpu.geometry import camera as jcam
from multiagent_orb_slam2_tpu.geometry import se3 as jse3
from multiagent_orb_slam2_tpu_torch.geometry import camera as tcam
from multiagent_orb_slam2_tpu_torch.geometry import se3 as tse3

ATOL = 1e-6
N = 64


def _rng():
    return np.random.default_rng(11)


def _quat(rng, n=N):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[:, :1] < 0, -q, q).astype(np.float32)


def _vec(rng, n=N, d=3, scale=1.0):
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


def _both(jf, tf, *args):
    jo = jf(*[jnp.asarray(a) for a in args])
    to = tf(*[torch.from_numpy(a) for a in args])
    if not isinstance(jo, tuple):
        jo, to = (jo,), (to,)
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                   rtol=1e-6)


SE3_CASES = {
    "quat_normalize": lambda r: (_vec(r, d=4),),
    "quat_mul": lambda r: (_quat(r), _quat(r)),
    "quat_conj": lambda r: (_quat(r),),
    "quat_rotate": lambda r: (_quat(r), _vec(r)),
    "quat_to_matrix": lambda r: (_quat(r),),
    "so3_exp_quat": lambda r: (_vec(r, scale=0.5),),
    "so3_log": lambda r: (_quat(r),),
    "hat": lambda r: (_vec(r),),
    "se3_exp": lambda r: (_vec(r, d=6, scale=0.3),),
    "se3_log": lambda r: (_quat(r), _vec(r)),
    "compose": lambda r: (_quat(r), _vec(r), _quat(r), _vec(r)),
    "inverse": lambda r: (_quat(r), _vec(r)),
    "apply": lambda r: (_quat(r), _vec(r), _vec(r, scale=5.0)),
    "relative": lambda r: (_quat(r), _vec(r), _quat(r), _vec(r)),
    "to_matrix44": lambda r: (_quat(r), _vec(r)),
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_function(name):
    _both(getattr(jse3, name), getattr(tse3, name), *SE3_CASES[name](_rng()))


def test_se3_small_angle_branches():
    tiny = (_vec(_rng(), d=6) * 1e-6).astype(np.float32)
    _both(jse3.se3_exp, tse3.se3_exp, tiny)
    _both(jse3.so3_exp_quat, tse3.so3_exp_quat, tiny[:, 3:])


def test_matrix_to_quat_and_from_matrix44():
    rng = _rng()
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray(_quat(rng))))
    _both(jse3.matrix_to_quat, tse3.matrix_to_quat, R)
    T = np.asarray(jse3.to_matrix44(jnp.asarray(_quat(rng)),
                                    jnp.asarray(_vec(rng))))
    _both(jse3.from_matrix44, tse3.from_matrix44, T)


def test_quat_identity():
    np.testing.assert_array_equal(
        tse3.quat_identity((3,), device="cpu").numpy(),
        np.asarray(jse3.quat_identity((3,))))


JC = jcam.Intrinsics(fx=450.0, fy=440.0, cx=320.0, cy=240.0, bf=45.0,
                     dist=(0.1, -0.05, 0.001, -0.002, 0.01))
TC = tcam.Intrinsics(*JC)


def _pc(rng):
    p = _vec(rng, scale=2.0)
    p[:, 2] = np.abs(p[:, 2]) + 1.0
    return p


def _uv(rng):
    return (rng.uniform(0, 480, size=(N, 2))).astype(np.float32)


CAM_CASES = {
    "project": lambda r: (_pc(r),),
    "project_stereo": lambda r: (_pc(r),),
    "project_world": lambda r: (_quat(r), _vec(r), _pc(r) + 4.0),
    "backproject": lambda r: (_uv(r), r.uniform(1, 20, N).astype(np.float32)),
    "unproject_world": lambda r: (_quat(r), _vec(r), _uv(r),
                                  r.uniform(1, 20, N).astype(np.float32)),
    "in_image": lambda r: (_uv(r) * 2 - 100,),
    "distort": lambda r: (_vec(r, d=2, scale=0.3),),
    "undistort_points": lambda r: (_uv(r),),
}


@pytest.mark.parametrize("name", sorted(CAM_CASES))
def test_camera_function(name):
    jf, tf = getattr(jcam, name), getattr(tcam, name)
    args = CAM_CASES[name](_rng())
    # pixel-valued outputs (1e2 .. 1e4, a float32 ulp of 6e-5 at 1e3):
    # 5e-6 relative, 1e-6 absolute below 1
    jo = jf(JC, *[jnp.asarray(a) for a in args])
    to = tf(TC, *[torch.from_numpy(a) for a in args])
    if not isinstance(jo, tuple):
        jo, to = (jo,), (to,)
    for a, b in zip(jo, to):
        a = np.asarray(a)
        if a.dtype == bool:
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=5e-6, atol=ATOL)


def test_intrinsics_K_and_baseline():
    np.testing.assert_allclose(TC.K.numpy(), np.asarray(JC.K), atol=ATOL)
    assert TC.baseline == JC.baseline
