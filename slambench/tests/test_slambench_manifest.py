"""BENCHMARK.json against the benchmark's contract, and every file it
names found."""
import json
import re

from slambench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return manifest.load()


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(b)) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (manifest.ROOT / p).is_dir()
    assert 1 <= len(b["command"]) <= 32
    assert all(_one_line(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 180 + 1200 \
        <= 43200


def test_configs_cells_and_files():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(configs) <= 24 and len(configs) == len(b["configs"])
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"])
        assert c["file"].startswith(b["paths"][0] + "/")
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(names) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        cell = manifest.cell(w["name"])
        assert cell.driver().run
        assert cell.params["limits"]


def test_metrics():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(e2e) <= 16 and 1 <= len(b["per_layer"]) <= 128
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert _one_line(m["layer"])
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    # every cell reports setup_s, another end-to-end metric, a per-layer one
    for w in cells:
        cell = manifest.cell(w)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer


def test_files_under_paths_are_named_from_name_characters():
    for p in manifest.HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(manifest.ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
