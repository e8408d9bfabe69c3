"""Loading BENCHMARK.json and the files it names, and building the port's
(or the reference's) config dataclasses from a configuration file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(spec_: dict, name: str) -> dict:
    for w in spec_["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_file(spec_: dict, name: str) -> dict:
    for c in spec_["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no config named {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_file(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold '-' and '.')."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no {kind} file {path.relative_to(ROOT)}")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('-', '_').replace('.', '_')}",
                                                      path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def build(cls, data: dict):
    """A config dataclass from a dict of its fields; a nested dict builds the
    field's own dataclass (its class is taken from the field's default).
    Every key must name a field."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    kwargs = {}
    for key, value in data.items():
        default = fields[key].default
        kwargs[key] = build(type(default), value) if isinstance(value, dict) else value
    return cls(**kwargs)
