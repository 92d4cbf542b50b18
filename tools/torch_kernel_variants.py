#!/usr/bin/env python3
"""What each step of the Hopper designs of K1 and K3 buys, and K2's present
design against its first, in one process.

    python3 tools/torch_kernel_variants.py [k1] [k2] [k3]   (default: all)

K1 (csrc/pose_opt.cu) at N = 2048 in three mask regimes (20 %, 90 % and all
of the slots valid): the first design, then the present design by its steps
(one pass per iteration without compaction; with compaction; with a
thread-block cluster of 4 blocks per pose), each held against the plain
version (1e-5) and timed alone on the card (raw launches back to back
between two CUDA events), and beside each its own serial skeleton (the reduce-chain probe on the same threads and
blocks). K3 (csrc/pcg.cu) on seeded well-conditioned systems of D = 48, 384,
654 and 924: the grid path, the cluster path with 4, 8 and 16 blocks (a
16-block cluster is not portable: a refused launch is reported, not fatal),
the cluster path's load of S alone (0 iterations) and the barrier skeletons.
K2 (csrc/ba_prep.cu) at (K, P, M) = (64, 32768, 24) on a random 12.6
%-active mask (chip_smoke.py's main shape) and on active points packed at
low indices with low slots (as the local BA's maps have them), and at
(256, 65536, 8): the first design and the present one, each held against the
plain version and timed alone (launches replayed from a CUDA graph, and
queued by the host), the compaction alone, and the present design on an
empty list (the floor of a launch).
Prints one JSON object per kernel; needs one CUDA device and nvcc.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (seeded problems, timing helper, camera)
from multiagent_orb_slam2_tpu_torch import convert  # noqa: E402
from multiagent_orb_slam2_tpu_torch.config import OptimizerConfig  # noqa: E402
from multiagent_orb_slam2_tpu_torch.io import ba_problem  # noqa: E402
from multiagent_orb_slam2_tpu_torch.optim import ba as ba_mod  # noqa: E402
from multiagent_orb_slam2_tpu_torch.optim import ba_kernels, ba_prep, pcg  # noqa: E402
from multiagent_orb_slam2_tpu_torch.optim import pose_opt  # noqa: E402
from multiagent_orb_slam2_tpu_torch.runtime import steps  # noqa: E402
from multiagent_orb_slam2_tpu_torch.utils import cuda_build  # noqa: E402

# (label, threads, compact, blocks per pose); None: the first design
K1_VARIANTS = (("v1", None, None, None),
               ("one_pass", 256, 0, 1),
               ("one_pass+compact", 256, 1, 1),
               ("one_pass+compact+cluster4", 256, 1, 4))


def k1_rows():
    cfg = OptimizerConfig()
    cam = chip_smoke.CAM
    lib = pose_opt.load_kernel()
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for valid in (0.2, 0.9, 1.0):
        q0, t0, obs = chip_smoke.pose_problem(1, 2048, seed=3048, valid=valid)
        plain = pose_opt._pose_optimize_plain(q0, t0, obs, cam, cfg)
        for label, threads, compact, cluster in K1_VARIANTS:
            if threads is None:
                launch = lib.pose_opt_launch_v1
            else:
                def launch(*a, _v=(threads, compact, cluster)):
                    return lib.pose_opt_launch_variant(*a, *_v)

            def run():
                return pose_opt._pose_optimize_cuda(q0, t0, obs, cam, cfg,
                                                    launch=launch)
            row = {"variant": label, "valid_share": valid,
                   "n_valid": int(obs.mask.sum())}
            try:
                k = run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                row["error"] = str(e)
                rows.append(row)
                continue
            row["max_err"] = max(float((k[0] - plain[0]).abs().max()),
                                 float((k[1] - plain[1]).abs().max()))
            row["inliers_equal"] = float((k[2] == plain[2]).float().mean())
            row["n_inliers"] = [int(k[3]), int(plain[3])]
            row["bit_identical"] = all(torch.equal(a, b)
                                       for a, b in zip(k, run()))
            row["ms"] = chip_smoke.device_ms(pose_opt._bind_launch(
                q0, t0, obs, cam, cfg, launch=launch)[0])
            rows.append(row)
    # time against the number of valid observations (the first n slots)
    sweep = []
    q0, t0, obs = chip_smoke.pose_problem(1, 2048, seed=3048, valid=1.0)
    for n_valid in (0, 32, 256, 512, 1024, 2048):
        o = obs._replace(mask=torch.arange(2048, device="cuda")[None]
                         < n_valid)
        row = {"n_valid": n_valid}
        for label, threads, compact, cluster in K1_VARIANTS:
            if threads is None:
                launch = lib.pose_opt_launch_v1
            else:
                def launch(*a, _v=(threads, compact, cluster)):
                    return lib.pose_opt_launch_variant(*a, *_v)
            row[label] = chip_smoke.device_ms(pose_opt._bind_launch(
                q0, t0, o, cam, cfg, launch=launch)[0])
        sweep.append(row)
    # how far from the plain version the first design and the present one
    # end on a dozen seeded problems: where the LM's last accept decisions
    # fall within rounding of a tie, either may end a step (about 1e-5) away
    scan = []
    for valid in (0.2, 0.9):
        for seed in range(3048, 3060):
            q0, t0, o = chip_smoke.pose_problem(1, 2048, seed=seed,
                                                valid=valid)
            plain = pose_opt._pose_optimize_plain(q0, t0, o, cam, cfg)
            row = {"valid_share": valid, "seed": seed}
            for label, launch in (("v1", lib.pose_opt_launch_v1),
                                  ("present", lib.pose_opt_launch)):
                k = pose_opt._pose_optimize_cuda(q0, t0, o, cam, cfg,
                                                 launch=launch)
                row["max_err_" + label] = max(
                    float((k[0] - plain[0]).abs().max()),
                    float((k[1] - plain[1]).abs().max()))
                row["labels_differ_" + label] = int((k[2] != plain[2]).sum())
            scan.append(row)
    chains = []
    passes = cfg.pose_opt_rounds * (cfg.pose_opt_iters + 1)
    for threads, cluster in ((256, 1), (256, 4)):
        def chain(count, with_solve):
            if lib.pose_opt_reduce_chain(out.data_ptr(), count, with_solve,
                                         threads, cluster, stream) != 0:
                raise SystemExit("reduce-chain probe failed to launch")
        n = 4000
        us = {}
        for with_solve in (0, 1):
            base = chip_smoke.cuda_ms(lambda: chain(0, with_solve), 10)
            full = chip_smoke.cuda_ms(lambda: chain(n, with_solve), 10)
            us[with_solve] = (full - base) / n * 1e3
        chains.append({"threads": threads, "blocks_per_pose": cluster,
                       "reduce_us": us[0], "reduce+solve_us": us[1],
                       "serial_floor_ms": passes * us[1] * 1e-3})
    return {"kernel": "pose_opt", "rows": rows, "sweep_ms": sweep,
            "seed_scan": scan, "chains": chains}


def k3_rows():
    lib = pcg.load_kernel()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(1, device="cuda")
    rows = []
    for D in (48, 384, 654, 924):
        S, rhs, Dinv, x0 = chip_smoke.spd_system(D, seed=D)
        want = ba_kernels.pcg_solve(S, rhs, Dinv, 32, x0)
        scale = float(want.abs().max())
        paths = [("grid", lib.pcg_launch_grid)]
        for nb in (4, 8, 16):
            def launch(S_, rhs_, Dinv_, x0_, x_, scratch_, D_, K_, n_, st_,
                       _nb=nb):
                return lib.pcg_launch_cluster(S_, rhs_, Dinv_, x0_, x_, D_,
                                              K_, n_, _nb, st_)
            paths.append((f"cluster{nb}", launch, nb))
        for label, launch, *nb in paths:
            row = {"D": D, "path": label}
            if nb:
                row["smem_bytes"] = lib.pcg_cluster_smem_bytes(D, nb[0])
                row["rows_per_block"] = [
                    b - a for a, b in pcg.cluster_rows(D, nb[0])][:2]

            def run(n_iters=32, warm=x0):
                return pcg._pcg_solve_cuda(S, rhs, Dinv, n_iters, warm,
                                           launch=launch)
            try:
                got = run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                row["error"] = str(e)
                rows.append(row)
                continue
            row["err_32_iters"] = float((got - want).abs().max()) / scale
            row["err_cold"] = float(
                (run(32, None) - ba_kernels.pcg_solve(S, rhs, Dinv, 32, None)
                 ).abs().max()) / scale
            row["bit_identical"] = bool(torch.equal(got, run()))
            row["ms"] = chip_smoke.device_ms(pcg._bind_launch(
                S, rhs, Dinv, 32, x0, launch=launch)[0])
            row["ms_0_iters"] = chip_smoke.device_ms(pcg._bind_launch(
                S, rhs, Dinv, 0, x0, launch=launch)[0])
            rows.append(row)
        rows[-1]["cholesky_solve_ms"] = chip_smoke.cuda_ms(
            lambda: torch.cholesky_solve(rhs[:, None],
                                         torch.linalg.cholesky_ex(S).L), 10)
    chains = []
    n = 2000
    scratch = torch.empty(lib.pcg_scratch_floats(384), device="cuda")
    for label, fn in (
            ("grid, D = 384", lambda c: lib.pcg_barrier_chain_grid(
                scratch.data_ptr(), out.data_ptr(), 384, c, stream)),
            ("cluster4", lambda c: lib.pcg_barrier_chain_cluster(
                out.data_ptr(), c, 4, stream)),
            ("cluster8", lambda c: lib.pcg_barrier_chain_cluster(
                out.data_ptr(), c, 8, stream)),
            ("cluster16", lambda c: lib.pcg_barrier_chain_cluster(
                out.data_ptr(), c, 16, stream))):
        if fn(0) != 0:
            chains.append({"skeleton": label, "error": "launch refused"})
            torch.cuda.synchronize()
            continue
        us = (chip_smoke.cuda_ms(lambda: fn(n), 5)
              - chip_smoke.cuda_ms(lambda: fn(0), 5)) / n * 1e3
        chains.append({"skeleton": label, "barrier_pair_us": us,
                       "serial_floor_ms_33_iters": 33 * us * 1e-3})
    return {"kernel": "pcg", "rows": rows, "chains": chains}


def k2_problem(K, P, M, mask, seed):
    """(prob, cam, solve constants) on the card: a random mask, all slots
    the generator keeps, or the first P // 5 points with slots 0..4."""
    if mask == "random":
        return chip_smoke.ba_case(K, P, M, 0.15, seed=seed)
    fields, cam = ba_problem.build_problem(K, P, M, seed=seed)
    if mask == "packed_low":
        fields["obs_mask"][P // 5:] = False
        fields["obs_mask"][:, 5:] = False
    prob = convert.ba_problem_from_numpy(fields, "cuda")
    return prob, cam, ba_mod._prepare_solve(prob, steps._ba_chunk(P))


def k2_rows():
    lib = ba_prep.load_kernel()
    rows = []
    for K, P, M, mask in ((64, 32768, 24, "random"),
                          (64, 32768, 24, "packed_low"),
                          (256, 65536, 8, "all")):
        prob, cam, sc = k2_problem(K, P, M, mask, seed=K + M)
        ws = sc.ws
        lam = torch.full((1,), 1e-4, device="cuda")
        args = (prob.q, prob.t, prob.pw, lam, cam, chip_smoke.D2M,
                chip_smoke.D2S, True)
        plain = ba_prep._prep_terms_plain(ws, *args)
        listed = ws.active.amax(dim=1) > 0
        head = {"K": K, "P": P, "M": M, "mask": mask,
                "listed_points": int(ws.n_points),
                "active_slots": int(ws.active.sum()),
                "bound_ms": chip_smoke.prep_bound_ms(ws, K)[0],
                "bound_ms_listed": chip_smoke.prep_bound_ms(
                    ws, K, listed=True)[0],
                "compaction_ms": chip_smoke.graph_ms(
                    lambda: ba_prep.compact_points(ws.active > 0)),
                "plain_ms": chip_smoke.cuda_ms(
                    lambda: ba_prep._prep_terms_plain(ws, *args), 3)}
        # the floor of a launch: the present design with an empty list
        run_empty = ba_prep._bind_launch(
            ws._replace(n_points=torch.zeros_like(ws.n_points)), *args)[0]
        head["empty_list_ms"] = chip_smoke.graph_ms(run_empty)
        rows.append(head)
        for label, bind in (("v1", chip_smoke.prep_v1),
                            ("present", ba_prep._bind_launch)):
            row = {"variant": label, "K": K, "P": P, "M": M, "mask": mask}
            run, terms = bind(ws, *args)
            run()
            got = chip_smoke.point_major(terms) if label == "v1" else terms
            row["max_err"] = max(
                chip_smoke.scale_err(a[:, listed], b[:, listed])
                if n in ("hinv6", "bp") else chip_smoke.scale_err(a, b)
                for n, a, b in zip(got._fields, got, plain))
            kept = [a.clone() for a in terms]
            run()
            row["bit_identical"] = all(torch.equal(a, b)
                                       for a, b in zip(kept, terms))
            row["ms"] = chip_smoke.graph_ms(run)
            row["ms_stream"] = chip_smoke.device_ms(run)
            rows.append(row)
        del prob, sc, ws, plain
        torch.cuda.empty_cache()
    return {"kernel": "ba_prep", "rows": rows,
            "grid_blocks": lib.ba_prep_grid_blocks()}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    which = sys.argv[1:] or ["k1", "k2", "k3"]
    print(chip_smoke.card_line())
    cuda_build.load_libraries([{"k1": "pose_opt", "k2": "ba_prep",
                                "k3": "pcg"}[k] for k in which])
    print("nvcc seconds: " + json.dumps(cuda_build.build_seconds))
    for name, log in cuda_build.build_logs.items():
        used = [ln.strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln or "error" in ln]
        print(f"ptxas {name}: " + " | ".join(used))
    for key, fn in (("k1", k1_rows), ("k2", k2_rows), ("k3", k3_rows)):
        if key in which:
            print(json.dumps(fn()))
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
