"""The port stands alone: no module of multiagent_orb_slam2_tpu_torch/ (the
multi-agent server and its drivers, the two-view initializer, the
rectifier, the vocabulary trainers, the scale-out package, the visualizer,
the native loader and the five-trial protocol among them), not chip_smoke.py and not the fixtures
it and the spawned ranks import imports jax or anything of
multiagent_orb_slam2_tpu. Importing the scale-out package starts no
process group."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "multiagent_orb_slam2_tpu_torch"
FORBIDDEN = ("jax", "multiagent_orb_slam2_tpu")


def _bad(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def test_no_jax_imports_in_port_sources():
    # chip_smoke.py and the jax-free fixtures it imports on the card
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_loop_cases.py",
        ROOT / "tests" / "torch_ba_cases.py",
        ROOT / "tests" / "torch_dist_cases.py",
        ROOT / "tests" / "torch_multihost_worker.py"]
    assert len(files) > 15
    for name in ("server/multimap.py", "server/fusion.py", "server/server.py",
                 "server/__init__.py", "drivers/generic_split_seq.py",
                 "drivers/two_seq.py", "geometry/twoview.py",
                 "io/rectify.py", "drivers/train_vocab.py",
                 "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/multihost.py", "parallel/dist_ba.py",
                 "parallel/multichip.py", "parallel/dryrun.py",
                 "viz/__init__.py", "viz/plot.py", "io/native_loader.py",
                 "analysis/collect_results.py",
                 "analysis/train_offline_vocab.py"):
        assert PORT / name in files, name
    offenders = [(str(f.relative_to(ROOT)), name)
                 for f in files for name in _imports(f) if _bad(name)]
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py")) if p.name != "__init__.py"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'multiagent_orb_slam2_tpu' or "
            "m.startswith('multiagent_orb_slam2_tpu.')]\n"
            "assert not bad, bad[:5]\n"
            "import torch\n"
            "assert torch.backends.cuda.matmul.allow_tf32 is False\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT),
                       env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]


def test_importing_parallel_starts_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import multiagent_orb_slam2_tpu_torch.parallel as par\n"
            "from multiagent_orb_slam2_tpu_torch.parallel import (dist_ba, "
            "dryrun, mesh, multichip, multihost)\n"
            "assert not dist.is_initialized()\n"
            "assert par.distributed_ba_solve is dist_ba.distributed_ba_solve\n"
            "assert par.make_mesh is dist_ba.make_mesh\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT),
                       env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
