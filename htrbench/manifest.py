"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` is ``drivers/<driver>.py``);
its correctness limits are ``limits/<cell>.json``; a per-layer metric's
reader is ``metrics/<metric>.py``. A new cell, mix, driver or metric is a
new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (its file name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"htrbench_dyn.{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = root
        self.spec = load_json(root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.cells = {w["name"]: w for w in self.spec["workloads"]}

    def cell(self, name: str, overrides: Optional[dict] = None) -> Cell:
        """The cell ``name`` with its files read; ``overrides`` (tests) are
        merged into the configuration's ``model`` / ``optim`` and into the
        traffic."""
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(self.cells)}")
        w = self.cells[name]
        config = load_json(self.root / self.configs[w["config"]]["file"])
        traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        limits = load_json(HERE / "limits" / f"{name}.json")
        for key, value in (overrides or {}).items():
            target = traffic if key == "traffic" else config.setdefault(key, {})
            target.update(value)
        return Cell(name, int(w["chips"]), config, traffic, limits)

    def driver(self, cell: Cell):
        drv = cell.traffic["driver"]
        return load_module(HERE / "drivers" / f"{drv}.py", drv)

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.spec["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return load_module(HERE / "metrics" / f"{metric}.py", metric).read
