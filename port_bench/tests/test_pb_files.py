"""Every file of the benchmark parses, BENCHMARK.json names files that are
there, and a cell added as files alone is found."""
import json
import shutil
import subprocess
import sys

from conftest import PB

ROOT = PB.parent


def test_every_file_parses():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        c = json.loads((ROOT / conf["file"]).read_text())
        assert c["name"] == conf["name"] and c["reduced"] == conf["reduced"]
    for w in bench["workloads"]:
        t = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PB / "drivers" / f"{t['driver']}.py").exists()
        assert json.loads((PB / "limits" / f"{w['name']}.json").read_text())["numbers"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_metric_selection():
    from harness import cell
    bench = cell.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cell.metrics_for(bench, w["name"], False)}
        layer = cell.metrics_for(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


def test_a_cell_added_as_files_is_found(tmp_path):
    shutil.copytree(PB, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = dict(bench["workloads"][0], name="dummy-cell", traffic="dummy-traffic")
    bench["workloads"].append(w)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    t = json.loads((PB / "traffic" / f"{bench['workloads'][0]['traffic']}.json").read_text())
    (tmp_path / "port_bench" / "traffic" / "dummy-traffic.json").write_text(
        json.dumps(dict(t, name="dummy-traffic", batch=2)))
    code = ("from harness import cell; b = cell.benchmark(); w, c, t = cell.resolve(b, 'dummy-cell');"
            "print(t['batch'], len(cell.metrics_for(b, 'dummy-cell', False)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path / "port_bench",
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["2", str(len([m for m in bench["end_to_end"]
                                                if "workloads" not in m
                                                or w["name"] in m["workloads"]]))]
