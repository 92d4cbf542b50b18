"""A cell and a per-layer metric dropped into a copy of the data folders
are found by name, with no file edited."""
import json
import shutil

from slambench import manifest


def test_new_cell_and_metric_found_without_edits(tmp_path):
    here = tmp_path / "slambench"
    shutil.copytree(manifest.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest.load()
    (here / "traffic" / "gba_replay_8.json").write_text(json.dumps(
        {"kind": "gba_replay", "distinct_maps": 8, "iterations": 10}))
    (here / "workloads" / "kitti00_split2.gba8.json").write_text(json.dumps(
        {"checked_maps": 1, "limits": {"cost_gap": 1e-3}}))
    (here / "metrics" / "gba.solves.py").write_text(
        "def read(ctx):\n    return ctx.get('solves')\n")
    bench["workloads"].append({"name": "kitti00_split2.gba8",
                               "config": "kitti00_split2",
                               "traffic": "gba_replay_8", "chips": 1,
                               "why": "more maps"})
    bench["end_to_end"][0]["workloads"].append("kitti00_split2.gba8")
    bench["per_layer"].append({"name": "gba.solves", "unit": "solves",
                               "better": "higher", "source": "program_counter",
                               "layer": "entry", "moves": "gba_ms",
                               "workloads": ["kitti00_split2.gba8"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    cell = manifest.cell("kitti00_split2.gba8", path, here)
    assert cell.traffic["distinct_maps"] == 8
    assert cell.params["checked_maps"] == 1
    assert [m["name"] for m in cell.per_layer] == ["gba.solves"]
    assert {m["name"] for m in cell.end_to_end} == {"gba_ms", "setup_s"}
    assert cell.reader("gba.solves")({"solves": 7}) == 7
    assert cell.driver().__name__ == "slambench.drivers.gba_replay"
