"""Where the benchmark finds its parts, each by the name it has in
``BENCHMARK.json`` or in another part's file. A later change adds a part by
adding its files; none of these functions changes for it.

* a cell: ``workloads/<cell>.json``, naming its configuration, its traffic
  mix, the cards it needs and the metrics it reports;
* a configuration: ``configs/<config>.json``, whose ``kind`` names its
  model kind;
* a model kind: ``kinds/<kind>.py``, with everything the benchmark does
  differently per model: ``checkpoint(ctx)`` (the seeded weights),
  ``detector_config(ctx, model_path, buckets, warmup)`` (the engine's
  settings), ``check(config, state_dict, samples, device)`` (the
  comparison with the kind's plain reference under ``reference/``),
  ``passes(checks)`` and ``control(config)`` (the control of the check);
* a traffic mix: ``traffic/<mix>.json``, whose ``driver`` names a module
  ``traffic/<driver>.py`` with a ``run(ctx)`` function;
* a metric: ``metrics/<metric>.py``, with a ``read(run)`` function and a
  ``UNIT`` string.

A model of another kind is new files only: its kind ``kinds/<kind>.py``,
its plain reference ``reference/<model>.py`` (fp32 torch, importing neither
JAX nor the program), its configuration ``configs/<name>.json``, a driver
under ``traffic/`` where neither present one serves it, a mix, a cell and
its metrics. A module part is looked for under the cell's root, then under
the benchmark's own directory.
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
        return self._part("traffic", self.mix["driver"])

    def metric(self, name: str) -> ModuleType:
        return self._part("metrics", name)

    def kind(self) -> ModuleType:
        if "kind" not in self.config:
            raise ValueError(f"configuration {self.config.get('name')!r} names no kind")
        return self._part("kinds", self.config["kind"])

    def _part(self, directory: str, name: str) -> ModuleType:
        path = self.root / directory / f"{name}.py"
        if not path.is_file():
            path = ROOT / directory / f"{name}.py"
        return load_module(path)


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
