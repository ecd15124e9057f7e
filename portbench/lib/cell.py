"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell ``<name>`` is the entry of ``workloads`` with that name; its
configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its own settings (driver, precision, limits of
the correctness check) ``workloads/<name>.json``, its driver
``drivers/<driver>.py``, and, for the entry of the program it drives
(``entry`` in its file: ``predict``, ``train``), its work counts
``work/<config>.<entry>.py`` and its plain reference
``reference/<config>.<entry>.py``; each per-layer metric is
``metrics/<metric>.py``.  Nothing here names a cell: a later cell or metric
is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_module(path: str):
    """A Python file as a module, by its path (names may hold '.' or '-')."""
    name = "portbench_file_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def part(kind: str, name: str, ext: str = ".py") -> str:
    """``portbench/<kind>/<name><ext>``."""
    return os.path.join(HERE, kind, name + ext)


def load_cell(name: str, bench: dict | None = None) -> dict:
    """Everything a run of cell ``name`` needs, by name."""
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in bench['workloads']]}")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    spec = _json(part("workloads", name, ".json"))

    def listed(m):
        return m.get("workloads") is None or name in m["workloads"]

    return {
        "name": name,
        "chips": entry["chips"],
        "entry": entry,
        "spec": spec,
        "config": _json(os.path.join(ROOT, cfg["file"])),
        "traffic": _json(part("traffic", entry["traffic"], ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
        "per_layer": [m for m in bench["per_layer"] if listed(m)],
    }


def driver(cell: dict):
    return load_module(part("drivers", cell["spec"]["driver"]))


def _of_entry(cell: dict) -> str:
    return f"{cell['config']['name']}.{cell['spec']['entry']}"


def work(cell: dict):
    return load_module(part("work", _of_entry(cell)))


def reference(cell: dict):
    return load_module(part("reference", _of_entry(cell)))


def metric_reader(name: str):
    return load_module(part("metrics", name))
