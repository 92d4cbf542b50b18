"""The plain pose optimization against the port's plain version on a
synthetic frame: the float64 reference agrees, the TF32 control does not."""
import math

import torch

from slambench.reference import ba as ref_ba
from slambench.reference import pose as ref_pose

CAM = {"fx": 718.856, "fy": 718.856, "cx": 607.1928, "cy": 185.2157,
       "bf": 386.1448, "width": 1241, "height": 376}


def _frame(seed, n=1500):
    g = torch.Generator().manual_seed(seed)
    d = 8 + 32 * torch.rand(n, generator=g, dtype=torch.float64)
    u = 1241 * torch.rand(n, generator=g, dtype=torch.float64)
    v = 376 * torch.rand(n, generator=g, dtype=torch.float64)
    pc = torch.stack([(u - CAM["cx"]) * d / CAM["fx"],
                      (v - CAM["cy"]) * d / CAM["fy"], d], -1)
    ang = 0.3
    R = torch.tensor([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                      [-math.sin(ang), 0, math.cos(ang)]], dtype=torch.float64)
    t = torch.tensor([1.5, -0.4, 30.0], dtype=torch.float64)
    pw = (pc - t) @ R                                  # R^T (pc - t)
    level = torch.randint(0, 8, (n,), generator=g)
    isig = 1.2 ** (-2.0 * level)
    noise = torch.randn(n, 3, generator=g, dtype=torch.float64) \
        * 1.2 ** level[:, None]
    uvr = torch.stack([u, v, u - CAM["bf"] / d], -1) + noise
    uvr[: n // 20] += 40.0                             # outliers
    stereo = d < 35 * CAM["bf"] / CAM["fx"]
    q = torch.tensor([math.cos(ang / 2), 0, math.sin(ang / 2), 0],
                     dtype=torch.float64)
    q0 = q + 0.002 * torch.randn(4, generator=g, dtype=torch.float64)
    t0 = t + 0.05 * torch.randn(3, generator=g, dtype=torch.float64)
    return q0, t0, pw, uvr, isig, stereo, torch.ones(n, dtype=torch.bool)


def _port(q0, t0, pw, uvr, isig, stereo, valid):
    from multiagent_orb_slam2_tpu_torch.geometry.camera import Intrinsics
    from multiagent_orb_slam2_tpu_torch.optim import pose_opt
    obs = pose_opt.PoseObs(pw.float(), uvr.float(), isig.float(), stereo,
                           valid)
    cam = Intrinsics(**CAM)
    q, t, inl, _ = pose_opt.pose_optimize(q0.float(), t0.float(), obs, cam)
    q = q.double()
    return ref_ba.quat_to_rot(q / q.norm()), t.double(), inl


def test_reference_agrees_with_the_port_and_the_control_does_not():
    for seed in (1, 2, 3):
        f = _frame(seed)
        R_ref, t_ref, inl_ref = ref_pose.solve(*f, CAM)
        R, t, inl = _port(*f)
        gap = (ref_pose.centre(R, t) - ref_pose.centre(R_ref, t_ref)).norm()
        Rc, tc, _ = ref_pose.solve(*f, CAM, precision="tf32")
        ctl = (ref_pose.centre(Rc, tc) - ref_pose.centre(R_ref, t_ref)).norm()
        assert (inl == inl_ref).all()
        assert gap < 1e-4 and ref_pose.rotation_gap(R, R_ref) < 1e-5
        assert ctl > 3 * gap, (float(gap), float(ctl))
