"""Nothing the benchmark runs imports JAX or the JAX package, compared by
top-level module name whole (the port's name begins with the JAX
package's); the plain references import nothing of the port; no file of
the benchmark reads the JAX benchmark's files."""
import ast

from slambench import manifest, run

JAX = {"jax", "jaxlib", "flax", "multiagent_orb_slam2_tpu"}
PORT = "multiagent_orb_slam2_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in manifest.HERE.rglob("*.py")
            if "__pycache__" not in p.parts]


def test_no_jax_anywhere():
    for p in _sources():
        assert not set(_imports(p)) & JAX, p


def test_references_import_nothing_of_the_port():
    for p in (manifest.HERE / "reference").rglob("*.py"):
        assert PORT not in set(_imports(p)), p


def test_no_jax_benchmark_file_read():
    for p in _sources():
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        assert "bench.py" not in text and "BENCH_" not in text, p


def test_runtime_check_compares_whole_names(monkeypatch):
    import sys
    import types
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "multiagent_orb_slam2_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib"]
