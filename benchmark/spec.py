"""Finds a cell, its configuration and its traffic by name: each is a
JSON file of its own under `benchmark/` (workloads/, configs/,
traffic/), and a cell's drive and metrics are modules found the same
way (drives/, metrics/), so a new cell, configuration, traffic mix,
drive or metric is a new file and no edit."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(kind: str, name: str) -> Dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path.relative_to(ROOT.parent)})")
    return json.loads(path.read_text())


def _module(kind: str, name: str) -> ModuleType:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> Dict:
    """The cell's file with its configuration and traffic read in:
    {"name", "config": {...}, "traffic": {...}, "drive", "chips", "why",
    "metrics"}."""
    c = _json("workloads", name)
    c["name"] = name
    c["config"] = _json("configs", c["config"])
    c["traffic"] = _json("traffic", c["traffic"])
    c.setdefault("limits", {})
    return c


def drive(name: str) -> ModuleType:
    return _module("drives", name)


def metric(name: str) -> ModuleType:
    return _module("metrics", name)


def metric_names() -> list:
    return sorted(p.stem for p in (ROOT / "metrics").glob("*.py") if not p.stem.startswith("_"))
