"""What a cell is made of, found by name.

`BENCHMARK.json` at the root of the checkout lists the cells (a
configuration and a traffic mix each) and the metrics.  Everything that
belongs to one configuration, mix, metric or codec sits in a file of its
own under `portbench/`:

  * configs/<configuration>.json  the configuration as it is run (the
    `file` that BENCHMARK.json gives for it); its "codec" names the
    codec it runs, `lane` where it names none;
  * mixes/<traffic>.json          the call, the clients, the engine;
  * metrics/<metric>.py           the reader of one metric;
  * codecs/<codec>.py             a codec's program side: `stage(config,
    mix, xs, device)`, which stages the mix's prepared call of each array
    with the program and returns a program.Staged, and
    `decoded_values(out, n, sections)`, the n values of a decode's
    output; it may import ans_tpu_torch, inside its functions, as
    program.py does (the lookup loads the file);
  * references/<codec>.py         its reference side: `encode(method, x,
    lanes, sections, counts)`, the plain reference's encoding of an
    array (an object with `blob`, `streams` (u8 arrays), `states` (u32),
    `sigma` and `exception_bytes`, as reference.Encoded: a codec of many
    models gives the frame symbols summed over them and the states of
    every stream), and `lossy_values(x)`, the values of the control
    (portbench/control.py); it imports nothing of the program.

The codec `lane` (one stream, a container of ATFB sections, or each
rank's shard of one) is program.py and reference.py.  A later cell,
mix, metric or codec is new files and new entries; no file that is there
changes.  A cell whose codec is not `lane` needs only new files: its
configuration, its mix, its codec's two files and its entries in
BENCHMARK.json.  A cell's `chips` is the number of processes it runs, one a
card: a cell of more than one runs as that many ranks of one process
group (portbench/ranks.py, portbench/run.py).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
LANE = "lane"  # the codec of a configuration that names none


@dataclass
class Codec:
    name: str
    program: ModuleType    # stage, decoded_values
    reference: ModuleType  # encode, lossy_values


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    codec: Codec
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its configuration, its
    mix, its codec and the metrics it reports.  KeyError for an unknown
    cell, or for a codec whose file is missing."""
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
                codec=codec(config.get("codec", LANE), root),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def cells(root: Path = ROOT) -> list:
    """Every cell of root/BENCHMARK.json, resolved (a missing file
    raises)."""
    return [cell(w["name"], root) for w in load(root)["workloads"]]


def codec(name: str, root: Path = ROOT) -> Codec:
    """The codec `name`: `lane` is program.py and reference.py, any other
    codecs/<name>.py and references/<name>.py under root/portbench.
    KeyError naming a file that is missing."""
    if name == LANE:
        from . import program, reference
        return Codec(name, program, reference)
    key = name.replace(".", "_")
    return Codec(name,
                 _load(root / "portbench" / "codecs" / f"{name}.py",
                       f"portbench_codec_{key}"),
                 _load(root / "portbench" / "references" / f"{name}.py",
                       f"portbench_reference_{key}"))


def reader(metric: str, root: Path = ROOT):
    """The `read(run)` function of metrics/<metric>.py."""
    return _load(root / "portbench" / "metrics" / f"{metric}.py",
                 f"portbench_metric_{metric.replace('.', '_')}").read


def _load(path: Path, name: str) -> ModuleType:
    """The module of the file `path`, under `name` in sys.modules (where
    its dataclasses look up their module)."""
    if not path.is_file():
        raise KeyError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
