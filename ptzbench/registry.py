"""Finds everything of a run by name, so that a later change adds a
configuration, a traffic mix, a per-layer metric or a cell by adding files
and entries, never by editing a file:

- ``BENCHMARK.json`` at the root: the cells, configurations and metrics;
- a configuration's file (its ``file`` entry): the deployment
  (``slam``: ``SLAMConfig``'s fields; ``frontend``; ``width``, ``height``;
  ``cameras``, the genlocked cameras on the card, one ``PTZSlam`` each,
  1 where the file has no such key);
- ``ptzbench/traffic/<traffic>.json``: a traffic mix, read by
  ``generator.Traffic``;
- ``ptzbench/metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(view)`` that returns its value, or None where it finds nothing to
  read;
- ``ptzbench/limits/<cell>.json``: the limits of the cell's check
  (``check.NUMBERS``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

PACKAGE = "ptzbench"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration's file
    mix: dict             # the traffic mix's file
    limits: dict          # the check's limits
    end_to_end: list      # BENCHMARK.json's entries of the end-to-end metrics this cell reports
    per_layer: list       # ... of the per-layer metrics


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Registry:
    """The benchmark at ``root`` (the checkout's root)."""

    def __init__(self, root):
        self.root = Path(root)
        self.bench = _json(self.root / "BENCHMARK.json")

    def _dir(self, kind: str) -> Path:
        return self.root / PACKAGE / kind

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        w = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        return Cell(
            name=name,
            chips=int(w["chips"]),
            config=_json(self.root / configs[w["config"]]["file"]),
            mix=_json(self._dir("traffic") / f"{w['traffic']}.json"),
            limits=_json(self._dir("limits") / f"{name}.json"),
            end_to_end=[m for m in self.bench["end_to_end"] if _reports(m, name)],
            per_layer=[m for m in self.bench["per_layer"] if _reports(m, name)],
        )

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self._dir("metrics") / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"{PACKAGE}_metric_{metric.replace('.', '_')}", path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(f"no reader for the metric {metric!r} at {path}")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
