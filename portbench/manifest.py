"""What a cell is made of, found by name.

`BENCHMARK.json` at the root of the checkout lists the cells (a
configuration and a traffic mix each) and the metrics.  Everything that
belongs to one configuration, mix or metric sits in a file of its own
under `portbench/`:

  * configs/<configuration>.json  the configuration as it is run (the
    `file` that BENCHMARK.json gives for it);
  * mixes/<traffic>.json          the call, the clients, the engine;
  * metrics/<metric>.py           the reader of one metric.

A later cell, mix or metric is new files and new entries; no file that is
there changes, as long as its mix stages a call the harness knows
(portbench/program.py: a prepared decode or encode of one stream or of a
container of sections, or with `shards` each rank's shard of a container
under one model).  A cell's `chips` is the number of processes it runs,
one a card: a cell of more than one runs as that many ranks of one
process group (portbench/ranks.py, portbench/run.py).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration, its
    mix and the metrics it reports.  KeyError for an unknown cell."""
    bench = load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no cell {name!r}; cells: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "portbench" / "mixes" /
                      f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, mix=mix, chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def cells(root: Path = ROOT) -> list:
    """Every cell of root/BENCHMARK.json, resolved (a missing file
    raises)."""
    return [cell(w["name"], root) for w in load(root)["workloads"]]


def reader(metric: str, root: Path = ROOT):
    """The `read(run)` function of metrics/<metric>.py."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
