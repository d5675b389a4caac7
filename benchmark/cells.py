"""Where the benchmark finds its parts, each by the name it has in
``BENCHMARK.json``. A later change adds a part by adding its files; none of
these functions changes for it.

* a cell: ``workloads/<cell>.json``, naming its configuration, its traffic
  mix, the cards it needs and the metrics it reports;
* a configuration: ``configs/<config>.json``;
* a traffic mix: ``traffic/<mix>.json``, whose ``driver`` names a module
  ``traffic/<driver>.py`` with a ``run(ctx)`` function;
* a metric: ``metrics/<metric>.py``, with a ``read(run)`` function and a
  ``UNIT`` string.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    end_to_end: List[str]
    per_layer: List[str]
    chips: int = 1
    root: Path = ROOT

    def driver(self) -> ModuleType:
        return load_module(self.root / "traffic" / f"{self.mix['driver']}.py")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{name}.py")


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such part of the benchmark: {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_part_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` with its configuration and traffic mix."""
    root = Path(root or ROOT)
    w = read_json(root / "workloads" / f"{name}.json")
    config = read_json(root / "configs" / f"{w['config']}.json")
    mix = read_json(root / "traffic" / f"{w['traffic']}.json")
    return Cell(name, config, mix, list(w["end_to_end"]), list(w["per_layer"]),
                int(w.get("chips", 1)), root)
