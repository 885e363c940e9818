"""Everything a run finds by name: its cell in ``BENCHMARK.json``, the
cell's configuration (``configs/<config>.json`` and its module
``configs/<config>.py``), its traffic (``traffic/<traffic>.json``) and
its metrics' readers (``metrics/<metric>.py``).  Adding a configuration,
a traffic mix or a metric adds files here and edits none."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class CellError(RuntimeError):
    """The cell, or a file it names, is missing or malformed."""


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise CellError(f"{path.relative_to(ROOT)} is missing")
    name = "bench_" + path.stem.replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    config: dict         # the configuration file, as run
    config_mod: ModuleType
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]   # this cell's end-to-end metrics
    per_layer: List[dict]    # this cell's per-layer metrics
    run_seconds: int

    def reader(self, metric: str) -> ModuleType:
        return _module(BENCH_DIR / "metrics" / f"{metric}.py")


def _reports(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without a list: every cell reporting what it moves
    return metric["moves"] in e2e_of_cell


def load_cell(name: str, bench: Dict = None) -> Cell:
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json "
                        f"({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = _json(ROOT / entry["file"])
    config_mod = _module((ROOT / entry["file"]).with_suffix(".py"))
    traffic = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name=name, config=config, config_mod=config_mod,
                traffic_name=w["traffic"], traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer,
                run_seconds=int(bench["run_seconds"]))
