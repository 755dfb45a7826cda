"""``BENCHMARK.json`` and the data files it names.

Everything of one configuration, traffic mix, cell or per-layer metric is a
file of its own, found by its name: ``configs/<config>.json`` (through the
manifest's ``file``), ``traffic/<traffic>.json``, ``limits/<cell>.json``
(the limits of the numbers that decide ``correct``) and
``metrics/<metric>.py`` (a ``read(run)`` that returns the number, or None
where the run has nothing to read).  A new cell or metric is new files and
new entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Bench:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.here = os.path.join(root, "ptbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)

    @staticmethod
    def _named(entries: list, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise KeyError(f"no {what} named {name!r}: "
                       f"{', '.join(e['name'] for e in entries)}")

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.here, *parts)) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        return self._named(self.doc["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.doc["configs"], name, "config")
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def metrics(self, kind: str, workload: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
        return [m for m in self.doc[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read``."""
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"ptbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
