"""What ``BENCHMARK.json`` names, found as files by name.

A cell ``<config>.<traffic>`` is an entry of ``workloads``; its
configuration is the file its ``configs`` entry names, its traffic is
``vorbench/traffic/<traffic>.json``, the traffic's ``entry`` names the
module ``vorbench/entries/<entry>.py`` that runs one job, and every metric
is read by ``vorbench/metrics/<metric>.py``.  Adding a cell, a
configuration, a traffic, an entry kind or a metric adds files and entries
and edits none.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench, name, root=ROOT):
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name, root=ROOT):
    with open(os.path.join(root, "vorbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _load(root, folder, name):
    path = os.path.join(root, "vorbench", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"vorbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(kind, root=ROOT):
    """The module that runs one job of the entry kind ``kind``."""
    return _load(root, "entries", kind)


def metric_reader(name, root=ROOT):
    """``read(ctx)`` of the metric ``name``: its value, or None where the
    run has nothing for it to read."""
    return _load(root, "metrics", name).read


def metrics(bench, cell, trace):
    """The metric entries that a run of ``cell`` reports: its end-to-end
    metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``.  A
    metric with a ``workloads`` key is the listed cells'; a per-layer metric
    without one is every cell's that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
