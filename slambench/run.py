"""The port's benchmark: one run of one cell.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is looked up in BENCHMARK.json,
its configuration, traffic and parameters in this folder's data files
(``manifest``); the traffic's generator (``drivers/<kind>.py``) makes the
inputs from the seed, warms every shape the cell uses (set-up), measures
for ``--seconds`` and checks what the timed path produced against the
plain reference. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiled stretch by ``metrics/<name>.py``.

The last line of standard output is the result (JSON); the numbers
compared, each beside its limit, are the last lines of standard error and
the last key of the result. Without a CUDA device, with fewer devices than
the cell asks for, without the port beside this folder, or with JAX loaded
in this process once the window has closed, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# no library the port uses may pull in JAX behind its back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "multiagent_orb_slam2_tpu")
HOST_THREADS = 2


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a traffic generator gets: the cell, the run's arguments, the
    device, and ``layer_ctx``, which it fills for the per-layer readers."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device, t0: float = T0):
        import torch
        self.cell, self.seed, self.seconds, self.trace = (
            cell, seed, seconds, trace)
        self.device = torch.device(device)
        self.t0 = t0
        self.layer_ctx = {"config": cell.config}
        self.control = False       # also read the control (slambench.control)

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def result_line(cell, out: dict, trace: bool, device_info: dict) -> dict:
    """The result's JSON object; `checks` comes last."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(out["layer_ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def execute(cell, seed: int, seconds: float, trace: bool,
            device="cuda", control: bool = False) -> dict:
    """Drive one run of `cell` on `device`; the generator's output dict
    with ``layer_ctx`` (traced runs) and ``breakdown`` added. `control`
    also reads the control where the generator checks a sample after the
    window (``slambench.control``)."""
    ctx = Context(cell, seed, seconds, trace, device)
    ctx.control = control
    out = cell.driver().run(ctx)
    out["layer_ctx"] = ctx.layer_ctx
    summ = ctx.layer_ctx.get("summary")
    if summ is not None:
        out["busy_s"], out["window_s"] = summ.busy_s, summ.window_s
        out["breakdown"] = summ.breakdown
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slambench import manifest
    cell = manifest.cell(args.workload)
    import torch
    # one process with few host threads: the runs spread less
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: the cell needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    try:
        import multiagent_orb_slam2_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"slambench: the port is not importable here: {e}",
              file=sys.stderr)
        return 3

    out = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"slambench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
    line = result_line(cell, out, bool(args.trace), device)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
