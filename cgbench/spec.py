"""Find a cell's pieces by name.

``BENCHMARK.json`` (beside this folder) names each cell's configuration
and traffic mix and lists the metrics. Each piece is a file of its own,
found by its name:

- ``configs/<config>.json``: the deployment (problem and size);
- ``mixes/<traffic>.json``: the solve settings, tolerance and right-hand
  sides;
- ``cells/<cell>.json``: the work count, the judged sample and the limits
  of the comparison that decides ``correct``;
- ``metrics/<metric>.py``: a reader with ``read(record) -> float | None``;
- ``work/<method>.py``: ``count(...)``, the work a method needs;
- ``problems/<problem>.py``: how the program builds its operator;
- ``reference/<problem>.py``: the plain reference of the problem.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    cell: dict
    end_to_end: list  # BENCHMARK.json's metric entries that this cell reports
    per_layer: list


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a name")
    return HERE / kind / f"{name}{suffix}"


def load_json(kind: str, name: str) -> dict:
    return json.loads(_path(kind, name, ".json").read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded from its file (a name may
    hold dots)."""
    path = _path(kind, name, ".py")
    if not path.exists():
        raise FileNotFoundError(path)
    mod_name = "cgbench._" + kind + "." + re.sub(r"[.-]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=load_json("configs", entry["config"]),
        mix=load_json("mixes", entry["traffic"]),
        cell=load_json("cells", name),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )
