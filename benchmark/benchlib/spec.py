"""A cell's files, found by the names in ``BENCHMARK.json``.

- the configuration: the file that the ``configs`` entry names;
- the traffic mix: ``benchmark/traffic/<traffic>.json``;
- the per-layer metrics: ``benchmark/metrics/<name>.py`` for each
  ``per_layer`` entry that lists the cell (or lists no cells), each
  module defining ``name``, ``unit``, ``layer``, ``moves`` and
  ``read(trace, ctx)``;
- the limits of the check: ``benchmark/limits/<cell>.json``;
- the plain reference: ``benchmark/reference/<reference>.py``, named by
  the configuration.

``root`` is the checkout (the directory that holds ``BENCHMARK.json``);
nothing here is keyed to a cell's name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HARNESS = "benchmark"  # the folder under the root that holds the files


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: Dict[str, ModuleType]
    limits: dict
    reference: ModuleType
    root: Path


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    base = root / HARNESS
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def mine(entry):
        return "workloads" not in entry or workload in entry["workloads"]

    metrics = {}
    for i, m in enumerate(e for e in bench["per_layer"] if mine(e)):
        module = load_module(base / "metrics" / f"{m['name']}.py",
                             f"bench_metric_{i}")
        if module.name != m["name"]:
            raise ValueError(f"metrics/{m['name']}.py names itself "
                             f"{module.name!r}")
        metrics[m["name"]] = module
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    reference = load_module(
        base / "reference" / f"{config['reference']}.py",
        f"bench_reference_{config['reference']}")
    return Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=metrics, limits=limits, reference=reference,
                root=root)
