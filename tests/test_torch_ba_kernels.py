"""The port's bundle-adjustment pieces that hold CUDA kernels, on the CPU:

- optim/ba_kernels.py (obs_terms_e, cost_e, sym3_inv, pcg_solve) against the
  JAX functions of the same names;
- optim/ba_prep.py: the plain version of the Schur-prep kernel against the
  Pallas body of ba_pallas.prep_terms run in interpret mode (the JAX side
  takes and gives slot-major [*, M, P] arrays, the port point-major
  [*, P, M]: the test transposes), and against its XLA twin (obs_terms_e +
  sym3_inv); hinv6 and bp only at points with an active slot, where the
  kernel writes them (0 elsewhere); the list of such points (compaction)
  against numpy;
- optim/pcg.py: the plain version of the PCG kernel against the Pallas body
  of pcg_solve_pallas in interpret mode and against pcg_solve; the row
  ownership of the cluster path (its choice by the live dimension is asked
  of the built library, on the card, with scattered live poses at
  D = 3072).

Inputs come from a seed through numpy and go to both packages. Tolerances are
relative to each output's scale (its largest magnitude): 2e-5 for the
per-observation terms (float32, the two frameworks contract multiply-adds
differently and world coordinates of tens of metres cancel against depths of
a few metres; found 1e-5), 5e-4 against the interpreted Pallas body (found
up to 1.1e-4 in Wb, Y, Ht, bt and Ybp: the interpreter fuses differently
again), 1e-4 for PCG after 32 iterations (found: 2e-6).
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiagent_orb_slam2_tpu.geometry.camera import Intrinsics as JIntr
from multiagent_orb_slam2_tpu.optim import ba_kernels as jbk
from multiagent_orb_slam2_tpu_torch.io import ba_problem
from multiagent_orb_slam2_tpu_torch.optim import ba_kernels as tbk
from multiagent_orb_slam2_tpu_torch.optim import ba_prep, pcg

import torch_ba_cases as ba_cases
from torch_parity import interpreted_pallas_call

K, P, M = ba_cases.K, ba_cases.P, ba_cases.M
D2M, D2S, LAM = ba_cases.D2M, ba_cases.D2S, ba_cases.LAM
PALLAS_TOL = 5e-4
rel_err = ba_cases.rel_err


@pytest.fixture(scope="module")
def prob():
    """_mixed_fields, plus the point-major workspace of the port."""
    fields, cam = ba_cases.mixed_fields()
    t = {k: torch.from_numpy(np.array(v)) for k, v in fields.items()}
    ws = ba_prep.prepare(t["obs_kf"], t["obs_uvr"], t["obs_inv_sigma2"],
                         t["obs_stereo"], t["obs_mask"], t["point_valid"], K)
    # point-major E = P * M arrays, as the E-major functions take them
    active = (fields["obs_mask"] & (fields["obs_kf"] >= 0)
              & fields["point_valid"][:, None])
    e = dict(kf=np.clip(fields["obs_kf"], 0, K - 1).reshape(-1),
             uvr=fields["obs_uvr"].transpose(2, 0, 1).reshape(3, -1),
             isig=fields["obs_inv_sigma2"].reshape(-1),
             stereo=fields["obs_stereo"].reshape(-1),
             active=active.reshape(-1).astype(np.float32))
    return dict(fields=fields, cam=cam, jcam=JIntr(*cam), ws=ws, e=e,
                active=active)


def _e_args(prob, to):
    e, f = prob["e"], prob["fields"]
    return [to(e[k]) for k in ("kf", "uvr", "isig", "stereo", "active")] \
        + [to(f[k]) for k in ("q", "t", "pw")]


@pytest.fixture(scope="module")
def jax_terms(prob):
    return {h: jbk.obs_terms_e(*_e_args(prob, jnp.asarray), prob["jcam"],
                               D2M, D2S, h) for h in (True, False)}


@pytest.mark.parametrize("use_huber", [True, False])
@pytest.mark.parametrize("field", ["r", "Jc", "Jp", "w", "chi2", "cost"])
def test_obs_terms_e_matches_jax(prob, jax_terms, field, use_huber):
    tt = tbk.obs_terms_e(*_e_args(prob, torch.from_numpy), prob["cam"], D2M,
                         D2S, use_huber)
    want = getattr(jax_terms[use_huber], field)
    assert tuple(getattr(tt, field).shape) == tuple(want.shape)
    assert rel_err(getattr(tt, field).numpy(), want) <= 2e-5


@pytest.mark.parametrize("use_huber", [True, False])
def test_cost_e_matches_jax(prob, use_huber):
    cj, chi2j = jbk.cost_e(*_e_args(prob, jnp.asarray), prob["jcam"], D2M,
                           D2S, use_huber)
    ct, chi2t = tbk.cost_e(*_e_args(prob, torch.from_numpy), prob["cam"],
                           D2M, D2S, use_huber)
    assert rel_err(ct.numpy(), cj) <= 2e-5
    assert rel_err(chi2t.numpy(), chi2j) <= 2e-5


def test_sym3_inv_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1)
    H[3] = 0.0                                  # a point without observations
    comps = [H[:, 0, 0], H[:, 0, 1], H[:, 0, 2], H[:, 1, 1], H[:, 1, 2],
             H[:, 2, 2]]
    want = jbk.sym3_inv(tuple(jnp.asarray(c) for c in comps), LAM)
    got = tbk.sym3_inv(tuple(torch.from_numpy(c) for c in comps), LAM)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # a damped inverse indeed: (H + lam diag H + 1e-8 I) Hinv = I
    g = [c.numpy().astype(np.float64) for c in got]
    Hi = np.stack([np.stack([g[0], g[1], g[2]], -1),
                   np.stack([g[1], g[3], g[4]], -1),
                   np.stack([g[2], g[4], g[5]], -1)], -2)
    Hd = H.astype(np.float64) + np.eye(3) * (LAM * np.einsum("pii->pi", H)
                                             + 1e-8)[:, None, :]
    ok = np.linalg.cond(Hd) < 1e4
    ok[3] = False           # determinant under the 1e-20 guard: not inverted
    assert ok.sum() > 20
    np.testing.assert_allclose((Hd @ Hi)[ok], np.broadcast_to(
        np.eye(3), Hi.shape)[ok], atol=1e-3)


def _spd_system(seed, n_poses=8, cond=50.0):
    """A dense SPD system with strong 6x6 diagonal blocks."""
    rng = np.random.default_rng(seed)
    D = 6 * n_poses
    A = rng.normal(size=(D, D))
    S = A @ A.T / D + np.diag(rng.uniform(1.0, cond, D))
    rhs = rng.normal(size=D)
    blocks = np.stack([S[6 * k:6 * k + 6, 6 * k:6 * k + 6]
                       for k in range(n_poses)])
    f32 = np.float32
    return (S.astype(f32), rhs.astype(f32),
            np.linalg.inv(blocks).astype(f32),
            (np.linalg.solve(S, rhs) * 0.7).astype(f32))


@pytest.mark.parametrize("warm", [False, True])
def test_pcg_solve_matches_jax_and_solves(warm):
    S, rhs, Dinv, x0 = _spd_system(1)
    x0 = x0 if warm else None
    want = jbk.pcg_solve(jnp.asarray(S), jnp.asarray(rhs), jnp.asarray(Dinv),
                         32, None if x0 is None else jnp.asarray(x0))
    got = tbk.pcg_solve(torch.from_numpy(S), torch.from_numpy(rhs),
                        torch.from_numpy(Dinv), 32,
                        None if x0 is None else torch.from_numpy(x0))
    assert rel_err(got.numpy(), want) <= 1e-4
    exact = np.linalg.solve(S.astype(np.float64), rhs.astype(np.float64))
    assert rel_err(got.numpy(), exact) <= 1e-4


@pytest.mark.parametrize("warm", [False, True])
def test_pcg_solve_rows_f64_matches_jax_and_float64_cg(warm):
    """rows_f64 (csrc/pcg.cu's grid-path arithmetic: each row of S p summed
    in float64, rounded once): after 32 iterations within 1e-4 of the JAX
    package's float32 solve, and after 2 within 1e-6 of a float64 CG of the
    same 2 iterations."""
    S, rhs, Dinv, x0 = _spd_system(3)
    x0 = x0 if warm else None
    want = jbk.pcg_solve(jnp.asarray(S), jnp.asarray(rhs), jnp.asarray(Dinv),
                         32, None if x0 is None else jnp.asarray(x0))
    args = [torch.from_numpy(a) for a in (S, rhs, Dinv)]
    warm32 = None if x0 is None else torch.from_numpy(x0)
    got = tbk.pcg_solve(*args, 32, warm32, rows_f64=True)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 1e-4
    two = tbk.pcg_solve(*args, 2, warm32, rows_f64=True)
    two64 = tbk.pcg_solve(*[a.double() for a in args], 2,
                          None if x0 is None else warm32.double())
    assert rel_err(two.numpy(), two64.numpy()) <= 1e-6


@pytest.mark.parametrize("warm", [False, True])
def test_plain_pcg_matches_interpreted_pallas_body(warm):
    """D = 48: the dispatcher on CPU tensors (the plain version) against
    pcg_solve_pallas with its kernel body run by the Pallas interpreter."""
    S, rhs, Dinv, x0 = _spd_system(2)
    x0 = x0 if warm else None
    with interpreted_pallas_call():
        want = jbk.pcg_solve_pallas(
            jnp.asarray(S), jnp.asarray(rhs), jnp.asarray(Dinv), 32,
            None if x0 is None else jnp.asarray(x0))
    before = pcg.pcg_solve.launches
    got = pcg.pcg_solve(torch.from_numpy(S), torch.from_numpy(rhs),
                        torch.from_numpy(Dinv), 32,
                        None if x0 is None else torch.from_numpy(x0))
    assert pcg.pcg_solve.launches == before     # CPU tensors launch nothing
    assert rel_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("n_blocks", [8, 16])
@pytest.mark.parametrize("D", [48, 384, 654, 930])
def test_cluster_rows_deal_whole_poses(D, n_blocks):
    """The cluster path's ownership: contiguous runs of whole poses (6 rows
    each, the 6x6 preconditioner block is applied by the rows' owner), every
    row owned exactly once, run lengths differing by at most one pose."""
    runs = pcg.cluster_rows(D, n_blocks)
    assert len(runs) == n_blocks
    assert runs[0][0] == 0 and runs[-1][1] == D
    for (a, b), (c, _) in zip(runs, runs[1:] + [(D, D)]):
        assert a % 6 == 0 and b % 6 == 0 and a <= b == c
    owner = np.full(D, -1)
    for blk, (a, b) in enumerate(runs):
        assert (owner[a:b] == -1).all()
        owner[a:b] = blk
    assert (owner >= 0).all()
    sizes = [(b - a) // 6 for a, b in runs]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]
    assert sum(sizes) == D // 6
    # the launcher's arithmetic: first pose of block b
    K = D // 6
    for blk, (a, _) in enumerate(runs):
        assert a == 6 * (blk * (K // n_blocks) + min(blk, K % n_blocks))


def test_cluster_rows_refuses_a_size_that_is_not_poses():
    with pytest.raises(ValueError):
        pcg.cluster_rows(50, 8)


@pytest.fixture(scope="module")
def plain_prep(prob):
    f = prob["fields"]
    before = ba_prep.prep_terms.launches
    out = ba_prep.prep_terms(
        prob["ws"], torch.from_numpy(f["q"]), torch.from_numpy(f["t"]),
        torch.from_numpy(f["pw"]), torch.tensor([LAM]), prob["cam"], D2M, D2S,
        True)
    assert ba_prep.prep_terms.launches == before   # CPU tensors launch nothing
    return out


@pytest.fixture(scope="module")
def pallas_prep(prob):
    """ba_pallas.prep_terms (pb = 1024 divides P) with its kernel body run by
    the Pallas interpreter, on the slot-major inputs the JAX package builds
    (the port's point-major workspace transposed); its outputs transposed
    back to point-major [*, P, M]."""
    from multiagent_orb_slam2_tpu.optim import ba_pallas as jbp
    f, ws = prob["fields"], prob["ws"]
    pose_t = np.concatenate([f["q"].T, f["t"].T], 0)               # [7, K]
    g = pose_t[:, ws.kf.numpy().T.reshape(-1)].reshape(7, M, P)
    with interpreted_pallas_call():
        out = jbp.prep_terms(
            LAM, jnp.asarray(g), jnp.asarray(ws.uvr.numpy().transpose(2, 1, 0)),
            jnp.asarray(ws.isig.numpy().T),
            jnp.asarray((ws.flags.numpy().T >= 2).astype(np.float32)),
            jnp.asarray(ws.active.numpy().T), jnp.asarray(f["pw"].T),
            prob["jcam"], D2M, D2S, True)
    out = [np.asarray(a) for a in out]
    # Wb, Y, Ht, bt, Ybp [*, M, P] and chi2 [M, P] to point-major
    return [np.swapaxes(a, -1, -2) if i < 5 or i == 8 else a
            for i, a in enumerate(out)]


@pytest.mark.parametrize("name", ["Wb", "Y", "Ht", "bt", "Ybp", "hinv6", "bp",
                                  "cost", "chi2"])
def test_plain_prep_matches_interpreted_pallas_body(prob, plain_prep,
                                                    pallas_prep, name):
    Wb, Y, Ht, bt, Ybp, hinv6, bp, cost, chi2 = pallas_prep
    t = plain_prep
    act = prob["active"]                                       # [P, M]
    listed = act.any(axis=1)             # points with an active slot
    assert 0 < listed.sum() < P
    if name == "Ht":
        rows = [a * 6 + b for a, b in ba_prep.TRIU6]
        got, want = t.diag[:21].numpy(), Ht[rows]
        # and the Pallas body's Ht is symmetric, so 21 rows carry all of it
        assert np.array_equal(Ht.reshape(6, 6, P, M),
                              Ht.reshape(6, 6, P, M).transpose(1, 0, 2, 3))
    elif name == "bt":
        got, want = t.diag[21:27].numpy(), bt
    elif name == "Ybp":
        got, want = t.diag[27:33].numpy(), Ybp
    elif name == "cost":
        got, want = t.cost.numpy().sum(), cost
    elif name == "chi2":
        got, want = t.chi2.numpy(), chi2 * act   # the port zeroes unused slots
    elif name in ("hinv6", "bp"):
        # written at the listed points only
        got = getattr(t, name).numpy()
        assert not got[:, ~listed].any()
        got, want = got[:, listed], locals()[name][:, listed]
    else:
        got, want = getattr(t, name).numpy(), locals()[name]
    assert np.shape(got) == np.shape(want)
    assert rel_err(got, want) <= PALLAS_TOL
    if name in ("Wb", "Y"):
        assert not got[:, ~act].any()           # unused slots hold zeros


def test_plain_prep_matches_xla_twin(prob, plain_prep, jax_terms):
    """Against obs_terms_e + sym3_inv of the JAX package: the point blocks
    and Wb = Jc^T w Jp rebuilt from the twin's Jacobians in float64."""
    tm = jax_terms[True]
    Jc, Jp, r, w = (np.asarray(a, np.float64) for a in (tm.Jc, tm.Jp, tm.r,
                                                        tm.w))
    JpP, wP = Jp.reshape(3, 3, P, M), w.reshape(P, M)
    listed = prob["active"].any(axis=1)
    H = np.einsum("rapm,rbpm,pm->abp", JpP, JpP, wP)
    H6 = tuple(jnp.asarray(H[a, b], jnp.float32)
               for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))
    hinv = np.stack([np.asarray(c) for c in jbk.sym3_inv(H6, LAM)])
    assert rel_err(plain_prep.hinv6.numpy()[:, listed], hinv[:, listed]) \
        <= 1e-4
    bp = -np.einsum("rbpm,rpm,pm->bp", JpP, r.reshape(3, P, M), wP)
    assert rel_err(plain_prep.bp.numpy()[:, listed], bp[:, listed]) <= 2e-5
    assert not plain_prep.hinv6.numpy()[:, ~listed].any()
    assert not plain_prep.bp.numpy()[:, ~listed].any()
    Wb = np.einsum("rae,rce,e->cae", Jc, Jp, w).reshape(18, P, M)
    assert rel_err(plain_prep.Wb.numpy(), Wb) <= 2e-5
    bt = -np.einsum("rae,re,e->ae", Jc, r, w).reshape(6, P, M)
    assert rel_err(plain_prep.diag[21:27].numpy(), bt) <= 2e-5
    assert rel_err(plain_prep.cost.numpy().sum(), tm.cost) <= 2e-5


def test_plain_prep_cost_only_mode(prob, plain_prep):
    f = prob["fields"]
    out = ba_prep.prep_terms(
        prob["ws"], torch.from_numpy(f["q"]), torch.from_numpy(f["t"]),
        torch.from_numpy(f["pw"]), None, prob["cam"], D2M, D2S, True,
        cost_only=True)
    assert out.Wb is None and out.diag is None
    np.testing.assert_allclose(out.cost.numpy(), plain_prep.cost.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.chi2.numpy(), plain_prep.chi2.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_prepare_lists_the_points_with_an_active_slot():
    """The compaction of prepare against numpy: the points with at least one
    active slot (point 3 with all 24, point 7 whose only slot is behind its
    camera, point 9 partly behind; not point 11), ascending, padded with
    zeros, and their count; the behind-camera slots carry chi2 but no terms
    or cost, and their points are listed and written."""
    fields, cam = ba_cases.slot_cases_fields()
    t = {k: torch.from_numpy(np.array(v)) for k, v in fields.items()}
    ws = ba_prep.prepare(t["obs_kf"], t["obs_uvr"], t["obs_inv_sigma2"],
                         t["obs_stereo"], t["obs_mask"], t["point_valid"],
                         t["q"].shape[0])
    active = (fields["obs_mask"] & (fields["obs_kf"] >= 0)
              & fields["point_valid"][:, None])
    want = np.flatnonzero(active.any(axis=1))
    n = int(ws.n_points[0])
    assert ws.points.dtype == torch.int32 and ws.n_points.dtype == torch.int32
    assert ws.points.shape == (active.shape[0],) and n == len(want)
    np.testing.assert_array_equal(ws.points[:n].numpy(), want)
    assert (np.diff(ws.points[:n].numpy()) > 0).all()
    assert not ws.points[n:].any()
    assert {3, 7, 9} <= set(want) and 11 not in set(want)
    assert active[3].all() and active[7].sum() == 1
    np.testing.assert_array_equal(ws.active.numpy(), active)
    out = ba_prep.prep_terms(ws, t["q"], t["t"], t["pw"], torch.tensor([LAM]),
                             cam, D2M, D2S, True)
    behind = [(7, 5), (9, 1), (9, 2)]
    for p, m in behind + [(9, 0)]:
        front = (p, m) == (9, 0)
        assert bool(out.Wb[:, p, m].any()) == front
        assert bool(out.diag[:, p, m].any()) == front
        assert (float(out.cost[p, m]) > 0) == front
        assert float(out.chi2[p, m]) > 0
    # point 7 has no term in its block: the inverse of the 1e-8 damping
    # floor (guarded determinant) on the diagonal, zeros off it
    assert (out.hinv6[[0, 3, 5], 7] > 0).all() and out.hinv6[:, 3].any()
    assert not out.hinv6[:, 11].any() and not out.bp[:, 11].any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BA kernels have no CPU mode; "
                    "chip_smoke.py holds them against their plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ba_cases.CARD_CASES)
def test_prep_kernel_matches_plain_on_the_card(cuda_device, case):
    """On the card: csrc/ba_prep.cu against the plain version on the same
    CUDA tensors in each case of ba_cases.CARD_CASES (see
    ba_cases.check_prep_on_card)."""
    ba_cases.check_prep_on_card(case, cuda_device)


@pytest.mark.cuda
def test_prep_kernel_refuses_more_than_32_slots(cuda_device):
    """One lane a slot: M = 40 is refused with the limit named, not run."""
    fields, cam = ba_problem.build_problem(8, 64, 40, seed=26)
    t = {k: torch.from_numpy(np.array(v)).to(cuda_device)
         for k, v in fields.items()}
    ws = ba_prep.prepare(t["obs_kf"], t["obs_uvr"], t["obs_inv_sigma2"],
                         t["obs_stereo"], t["obs_mask"], t["point_valid"], 8)
    with pytest.raises(ValueError, match="limit of 32"):
        ba_prep.prep_terms(ws, t["q"], t["t"], t["pw"],
                           torch.full((1,), LAM, device=cuda_device), cam,
                           D2M, D2S, True)


@pytest.mark.cuda
def test_pcg_kernel_matches_plain_on_the_card(cuda_device):
    """On the card: csrc/pcg.cu against ba_kernels.pcg_solve on a well
    conditioned D = 48 system that 32 iterations solve: 1e-4 of x's scale."""
    S, rhs, Dinv, x0 = (torch.from_numpy(a).to(cuda_device)
                        for a in _spd_system(3))
    for warm in (None, x0):
        before = pcg.pcg_solve.launches
        k = pcg.pcg_solve(S, rhs, Dinv, 32, warm)
        assert pcg.pcg_solve.launches == before + 1
        p = tbk.pcg_solve(S, rhs, Dinv, 32, warm)
        assert rel_err(k.cpu().numpy(), p.cpu().numpy()) <= 1e-4


def _energy_check(S, rhs, Dinv, x0, solve, plain=tbk.pcg_solve):
    """The measure of chip_smoke.py: after 32 iterations the kernel's error
    against a float64 solve, in the energy norm, is within 1.1 x the plain
    version's, the two differ by at most 0.25 of that error (+ 1e-5), and
    after 2 iterations they agree within 1e-4 of x's scale."""
    S64 = S.double()
    exact = torch.linalg.solve(S64, rhs.double())
    norm = float(torch.sqrt(exact @ (S64 @ exact)))

    def energy(d):
        d = d.double()
        return float(torch.sqrt((d @ (S64 @ d)).clamp_min(0.0))) / norm

    for warm in (None, x0):
        k2, p2 = solve(S, rhs, Dinv, 2, warm), plain(S, rhs, Dinv, 2, warm)
        assert rel_err(k2.cpu().numpy(), p2.cpu().numpy()) <= 1e-4
        xk = solve(S, rhs, Dinv, 32, warm)
        xp = plain(S, rhs, Dinv, 32, warm)
        en_p = energy(xp - exact)
        assert energy(xk - exact) <= 1.1 * en_p + 1e-6
        assert energy(xk - xp) <= 0.25 * en_p + 1e-5
        assert torch.equal(xk, solve(S, rhs, Dinv, 32, warm))


@pytest.mark.cuda
@pytest.mark.parametrize("D, DL, path", [
    (48, 48, "cluster"), (384, 384, "cluster"), (654, 654, "cluster"),
    (660, 660, "cluster"), (666, 666, "cluster"), (924, 924, "cluster"),
    (3072, 0, "none"), (3072, 48, "cluster"), (3072, 384, "cluster"),
    (3072, 600, "cluster"), (3072, 606, "resident"),
    (1536, 1536, "resident"), (3072, 2376, "resident"),
    (3072, 3072, "stream")])
def test_cluster_path_is_chosen_by_size_alone(cuda_device, D, DL, path):
    """The launcher's choice, made on the card by the live dimension DL
    alone (the rows of the poses the solve moves): the cluster path where
    one cluster holds S[live, live] in shared memory (up to DL = 924; 600
    where D > 924 sums rows in float64, above which the grid is faster),
    else the grid holding the live rows in every SM's shared memory up to
    pcg_resident_cap (2,376 at K = 512 on 132 SMs), else the grid streaming
    them; DL = 0 leaves x = x0. The cluster puts about 4 poses on a block,
    at most the 8 blocks it launches up to D = 660, else 16; the all-pose
    cluster of D <= 924 asks for what holds its rows and stays inside the
    227 KB a block may have."""
    lib = pcg.load_kernel()
    limit = 227 * 1024
    assert pcg.path_of(D, DL) == path
    assert lib.pcg_resident_cap(512) >= 2376
    active = lib.pcg_live_cluster_blocks(D, DL)
    assert (active > 0) == (path == "cluster")
    if path == "cluster":
        assert active == min(-(-DL // 24), 8 if D <= 660 else 16)
        rows = max(b - a for a, b in pcg.cluster_rows(DL, active))
        assert 4 * rows * DL <= limit
    if D <= 924:
        blocks = lib.pcg_cluster_blocks(D)
        assert blocks == (8 if D <= 660 else 16)
        need = lib.pcg_cluster_smem_bytes(D, blocks)
        rows = max(b - a for a, b in pcg.cluster_rows(D, blocks))
        assert 4 * rows * D <= need <= limit
        for n_blocks in (8, 16):
            if n_blocks < blocks:
                assert lib.pcg_cluster_smem_bytes(D, n_blocks) > limit


def _live_system(seed, K, n_live):
    """A dense SPD system on n_live poses scattered among K (strong 6x6
    diagonal blocks), identity blocks, zero coupling, rhs 0 and a warm
    start of 0 on the others: (S, rhs, Dinv, x0, live poses), float32."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(K, n_live, replace=False))
    idx = (6 * live[:, None] + np.arange(6)[None]).reshape(-1)
    n = idx.size
    A = rng.normal(size=(n, n))
    S = np.eye(6 * K)
    S[np.ix_(idx, idx)] = A @ A.T / n + np.diag(rng.uniform(1.0, 50.0, n))
    rhs = np.zeros(6 * K)
    rhs[idx] = rng.normal(size=n)
    x0 = np.zeros(6 * K)
    x0[idx] = 0.7 * np.linalg.solve(S[np.ix_(idx, idx)], rhs[idx])
    blocks = np.stack([S[6 * k:6 * k + 6, 6 * k:6 * k + 6] for k in range(K)])
    f32 = np.float32
    return (S.astype(f32), rhs.astype(f32), np.linalg.inv(blocks).astype(f32),
            x0.astype(f32), live)


@pytest.mark.cuda
@pytest.mark.parametrize("n_live, path", [(64, "cluster"),
                                          (256, "resident")])
def test_pcg_scattered_live_poses_on_the_card(cuda_device, n_live, path):
    """D = 3072 with n_live poses live, scattered: the kernel's list (left
    in its scratch) equals pcg.live_poses, the live system takes the path
    its size selects, the inert rows come back as x0 bit for bit, and the
    solve agrees with the plain version summing rows in float64 (D > 924)
    by chip_smoke.py's measure, two launches bit for bit."""
    K = 512
    S, rhs, Dinv, x0, live = (
        torch.from_numpy(a).to(cuda_device) if a.dtype == np.float32 else a
        for a in _live_system(9, K, n_live))
    assert pcg.path_of(6 * K, 6 * n_live) == path
    for warm in (None, x0):
        run, x = pcg._bind_launch(S, rhs, Dinv, 32, warm)
        run()
        poses, n = pcg.scratch_live(run.scratch, 6 * K)
        want = pcg.live_poses(S, rhs, Dinv, warm)
        assert torch.equal(poses, want[0]) and torch.equal(n, want[1])
        assert poses[:n_live].cpu().tolist() == live.tolist()
        inert = torch.ones(6 * K, dtype=torch.bool, device=cuda_device)
        inert[(6 * poses[:n_live, None].long()
               + torch.arange(6, device=cuda_device)).reshape(-1)] = False
        start = torch.zeros_like(x) if warm is None else warm
        assert torch.equal(x[inert], start[inert])
    _energy_check(S, rhs, Dinv, x0, pcg.pcg_solve,
                  plain=functools.partial(tbk.pcg_solve, rows_f64=True))


@pytest.mark.cuda
@pytest.mark.parametrize("n_poses, blocks", [(8, 8), (64, 8), (109, 8),
                                             (154, 16)])
def test_pcg_cluster_path_matches_plain_on_the_card(cuda_device, n_poses,
                                                    blocks):
    """On the card, D = 48 and 384 (rows read and sent 16 bytes at a time),
    654 (an odd number of poses: the scalar load of S and scalar sends) and
    924 (the 16-block cluster): pcg_solve takes the cluster path and agrees
    with ba_kernels.pcg_solve in the energy norm, two launches bit for bit;
    the grid path on the same system does too."""
    D = 6 * n_poses
    lib = pcg.load_kernel()
    assert lib.pcg_cluster_blocks(D) == blocks
    S, rhs, Dinv, x0 = (torch.from_numpy(a).to(cuda_device)
                        for a in _spd_system(4, n_poses=n_poses))
    before = pcg.pcg_solve.launches
    _energy_check(S, rhs, Dinv, x0, pcg.pcg_solve)
    assert pcg.pcg_solve.launches > before
    _energy_check(S, rhs, Dinv, x0,
                  lambda *a: pcg._pcg_solve_cuda(*a,
                                                 launch=lib.pcg_launch_grid))
