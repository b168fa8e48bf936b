"""Finds a cell's pieces by the names in BENCHMARK.json: its configuration
(`configs/<config>.json`), its traffic (`traffic/<traffic>.json`), the
route the configuration names (`routes/<route>.py`), the reference decoder
it names (`reference/<reference_decoder>.py`, `decode` by default) and a
module per metric (`metrics/<metric>.py`).  A later cell, configuration,
traffic mix, reference decoder or metric is a new file here, found by its
name."""
from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def metric(name: str):
    """The reader module of metric `name`."""
    return _module("metrics", name)


def route(name: str):
    return _module("routes", name)


def reference_file(config: dict) -> pathlib.Path:
    """The file of the reference decoder module that `config` names."""
    name = config.get("reference_decoder", "decode")
    path = HERE / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference module {path}")
    return path


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    route: object
    end_to_end: list        # BENCHMARK.json entries that this cell reports
    per_layer: list


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> Cell:
    """The workload `name` of `bench` with its pieces loaded."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    config = load_json("configs", w["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=load_json("traffic", w["traffic"]),
                route=route(config["route"]),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))
