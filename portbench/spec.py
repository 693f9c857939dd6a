"""Find cells, configurations, traffic mixes and per-layer metrics by name.

Each lives in a file of its own under one root: this folder, or a copy of
it (the tests add a throwaway cell and metric to a copy).  Nothing here
knows any particular cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
# MLPerf Inference's scenarios: single_stream sends one sample when the one
# before it has completed; offline hands over batches back to back.
SCENARIOS = ("single_stream", "offline")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} name {name!r}: 1-64 of letters, digits, "
                         "'_', '.', '-', not starting with '.' or '-'")
    return name


def check_unit(unit: str, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise ValueError(f"{what} unit {unit!r}: 1-16 of letters, digits, "
                         "'_', '/', '%', '.', '-'")
    return unit


def _json(root: Path, kind: str, name: str) -> dict:
    check_name(name, kind)
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} entry {name!r} ({path} does not exist)")
    return json.loads(path.read_text())


def names(kind: str, root: Path = ROOT) -> list[str]:
    """Every name of one kind (``workloads``, ``configs``, ``traffic``,
    ``metrics``) that has a file under ``root``."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (Path(root) / kind).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    why: str
    limits: dict

    @property
    def scenario(self) -> str:
        return self.traffic["scenario"]

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    def arch(self) -> ModuleType:
        """``archs/<arch>.py``: layer table, weights, the port's entry."""
        return importlib.import_module(
            f"portbench.archs.{check_name(self.config['arch'], 'arch')}")

    def reference(self) -> ModuleType:
        """``reference/<arch>.py``: the plain fp32 forward."""
        return importlib.import_module(
            f"portbench.reference.{self.config['arch']}")


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = _json(root, "workloads", name)
    traffic = _json(root, "traffic", spec["traffic"])
    if traffic.get("scenario") not in SCENARIOS:
        raise ValueError(f"traffic {spec['traffic']!r}: scenario must be one "
                         f"of {SCENARIOS}")
    if traffic["pool_images"] % traffic["batch"]:
        raise ValueError(f"traffic {spec['traffic']!r}: pool_images is not a "
                         "whole number of batches")
    if spec["chips"] not in (1, 4):
        raise ValueError(f"cell {name!r}: chips must be 1 or 4")
    return Cell(name=name, config_name=spec["config"],
                config=_json(root, "configs", spec["config"]),
                traffic_name=spec["traffic"], traffic=traffic,
                chips=int(spec["chips"]), why=spec["why"],
                limits=dict(spec["limits"]))


@dataclass(frozen=True)
class Metric:
    """A per-layer metric: ``metrics/<name>.py`` declares its layer, the
    end-to-end metric it moves, its unit, direction, source and the
    scenarios whose cells it reads, and ``read(reading)`` returns its value
    or None where the run holds nothing for it to read."""
    name: str
    layer: str
    moves: str
    unit: str
    better: str
    source: str
    scenarios: tuple
    read: object

    def reports(self, c: Cell) -> bool:
        return c.scenario in self.scenarios


def metric(name: str, root: Path = ROOT) -> Metric:
    check_name(name, "metric")
    path = Path(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no metric {name!r} ({path} does not exist)")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    m = Metric(name=name, layer=mod.LAYER, moves=mod.MOVES,
               unit=check_unit(mod.UNIT, name), better=mod.BETTER,
               source=mod.SOURCE, scenarios=tuple(mod.SCENARIOS),
               read=mod.read)
    if m.better not in ("lower", "higher") or m.source not in SOURCES:
        raise ValueError(f"metric {name!r}: better {m.better!r}, source "
                         f"{m.source!r}")
    if not set(m.scenarios) <= set(SCENARIOS):
        raise ValueError(f"metric {name!r}: unknown scenarios {m.scenarios}")
    return m


def metrics(root: Path = ROOT) -> list[Metric]:
    return [metric(n, root) for n in names("metrics", root)]


def end_to_end(cell_name: str, root: Path = ROOT) -> dict[str, str]:
    """name -> unit of every end-to-end metric that ``BENCHMARK.json``, beside
    the benchmark's folder, has the cell report: those with no
    ``workloads`` key and those whose list names it."""
    bench = json.loads((Path(root).parent / "BENCHMARK.json").read_text())
    return {e["name"]: e["unit"] for e in bench["end_to_end"]
            if cell_name in e.get("workloads", [cell_name])}
