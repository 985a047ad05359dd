"""Find the benchmark's parts by name.

A part is a file under one of the benchmark's folders:

- ``configs/<config>.json``: the sizes and the source of a configuration;
- ``reference/<config>.py``: its plain reference (no code of the program);
- ``models/<config>.py``: how the program builds and compiles it;
- ``traffic/<mix>.json``: a traffic mix, a data file whose ``kind`` names
  ``traffic/<kind>.py``, the driver of one kind of query;
- ``judges/<config>.<kind>.py``: the comparison that decides ``correct``;
- ``workloads/<cell>.json``: a cell's limits and its counts of checked and
  traced queries;
- ``metrics/<metric>.py``: the reader of one metric.

A later cell, configuration or metric is added as files and an entry in
BENCHMARK.json, never by editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Sequence

PKG = Path(__file__).resolve().parent
CHECKOUT = PKG.parent


class Registry:
    """Looks parts up in ``roots`` in order (the benchmark's own folder
    last; tests put a folder of small parts in front of it)."""

    def __init__(self, roots: Sequence[Path] = (PKG,)):
        self.roots = [Path(r) for r in roots]

    def path(self, folder: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            p = root / folder / f"{name}{suffix}"
            if p.is_file():
                return p
        raise KeyError(f"no {folder}/{name}{suffix} under "
                       f"{[str(r) for r in self.roots]}")

    def json(self, folder: str, name: str) -> dict:
        with open(self.path(folder, name, ".json")) as f:
            return json.load(f)

    def module(self, folder: str, name: str):
        p = self.path(folder, name, ".py")
        mod_name = "portbench_" + "_".join(
            part.replace(".", "_").replace("-", "_")
            for part in (folder, name))
        mod = sys.modules.get(mod_name)
        if mod is not None and getattr(mod, "__file__", None) == str(p):
            return mod
        spec = importlib.util.spec_from_file_location(mod_name, p)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod


def load_benchmark(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, cell: str) -> dict:
    """The cell's entry of ``workloads`` and the metrics it reports:
    ``end_to_end`` and ``per_layer`` entries whose ``workloads`` list the
    cell, or that have no such list."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"unknown workload {cell!r}; known: {sorted(cells)}")

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or cell in m["workloads"]]

    return dict(cells[cell], end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))
