"""Finds a cell's files by the names in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``, whose ``driver`` names ``drivers/<driver>.py``),
its limits (``limits/<workload>.json``) and one reader per metric
(``metrics/<metric>.py``). A new cell or metric is new files and entries,
never an edit."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")     # top-level module names


def load_json(path):
    return json.loads(Path(path).read_text())


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def resolve(bench, workload: str):
    """(workload entry, configuration, traffic) of a cell."""
    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(x for x in bench["configs"] if x["name"] == w["config"])
    return w, load_json(ROOT / conf["file"]), load_json(PB / "traffic" / f"{w['traffic']}.json")


def metrics_for(bench, workload: str, trace: bool):
    """The end-to-end metrics a cell reports (trace 0), or its per-layer
    metrics (trace 1): a metric with a ``workloads`` key in the cells it
    lists, else in every cell that reports the metric it moves."""
    def here(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if here(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}",
                                                  PB / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
