"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs[].file``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), which names the path that serves
it (``benchmark/paths/<path>.py``); a per-layer metric is read by
``benchmark/metrics/<metric>.py``.  Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from functools import lru_cache

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)  # the checkout


@lru_cache(maxsize=None)
def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _one(entries, name: str, what: str) -> dict:
    hits = [e for e in entries if e["name"] == name]
    if len(hits) != 1:
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")
    return hits[0]


def cell(name: str) -> dict:
    return _one(benchmark()["workloads"], name, "workload")


def config(name: str) -> dict:
    entry = _one(benchmark()["configs"], name, "configuration")
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    if cfg.get("name") != name:
        raise ValueError(f"{entry['file']} names {cfg.get('name')!r}, not {name!r}")
    return cfg


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names {mix.get('name')!r}")
    return mix


def metrics(kind: str, cell_name: str):
    """The ``end_to_end`` or ``per_layer`` entries that ``cell_name`` reports."""
    return [m for m in benchmark()[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


@lru_cache(maxsize=None)
def _module(folder: str, name: str):
    """``benchmark/<folder>/<name>.py``, loaded by its file's path (a name
    may hold dots)."""
    mod_name = f"benchmark_{folder}_" + "".join(c if c.isalnum() else "_" for c in name)
    mod_spec = importlib.util.spec_from_file_location(
        mod_name, os.path.join(BENCH_DIR, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(trace)`` of ``benchmark/metrics/<metric>.py``."""
    return _module("metrics", metric).read


def path(name: str):
    """The module ``benchmark/paths/<name>.py``: ``check(traffic)``,
    ``warm_up(setup, spans)``, ``window(setup, seconds, spans)``."""
    return _module("paths", name)
