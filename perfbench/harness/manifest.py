"""``BENCHMARK.json`` and the files the harness finds by name.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, under a name taken from ``BENCHMARK.json``:

    configs:   the entry's ``file`` (``perfbench/configs/<config>.json``)
    traffic:   perfbench/workloads/<traffic>.json   (its ``kind`` names the kind module)
    kinds:     perfbench/kinds/<kind>.py            (``Spec``, ``run(spec, readers) -> dict``)
    limits:    perfbench/limits/<cell>.json         (what ``correct`` holds each number to)
    metrics:   perfbench/metrics/<metric>.py        (``read(run) -> float | None``)

So a later change adds a configuration, a cell or a metric by adding files
and entries, and edits none.  ``problems`` checks the manifest against the
benchmark's rules before anything runs.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

BENCH = "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}
MAX_SECONDS = 51


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def cell(manifest: dict, name: str) -> dict:
    for c in manifest["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, manifest: dict, name: str) -> dict:
    entry = next(c for c in manifest["configs"] if c["name"] == name)
    return _json(root / entry["file"])


def traffic(root: Path, name: str) -> dict:
    return _json(root / BENCH / "workloads" / f"{name}.json")


def limits(root: Path, cell_name: str) -> dict:
    return _json(root / BENCH / "limits" / f"{cell_name}.json")


def _module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[label] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def kind_module(root: Path, kind: str) -> ModuleType:
    return _module(root / BENCH / "kinds" / f"{kind}.py", f"perfbench_kind_{kind}")


def reader(root: Path, metric: str):
    label = "perfbench_metric_" + re.sub(r"\W", "_", metric)
    return _module(root / BENCH / "metrics" / f"{metric}.py", label).read


def metrics_of(manifest: dict, cell_name: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics (``traced`` False) or per-layer ones."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def _line(text, what: str, out: list[str]) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or any(c in text for c in "\n\t"):
        out.append(f"{what}: 1 to 200 characters on one line, no tab")


def _name(text, what: str, out: list[str]) -> None:
    if not isinstance(text, str) or not NAME.match(text):
        out.append(f"{what} {text!r} is not a name")


def problems(manifest: dict, root: Path) -> list[str]:
    """Every way ``manifest`` breaks the benchmark's rules, or an empty list."""
    out: list[str] = []
    if set(manifest) != TOP_KEYS:
        return [f"top-level keys {sorted(manifest)} are not {sorted(TOP_KEYS)}"]
    if len(json.dumps(manifest).encode()) > 64 * 1024:
        out.append("BENCHMARK.json is over 64 KiB")
    paths = manifest["paths"]
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        out.append("paths: 1 to 16 directories")
        paths = []
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            out.append(f"path {p!r} is not a relative path inside the repo")
    cmd = manifest["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        out.append("command: 1 to 32 strings")
        cmd = []
    for word in cmd:
        _line(word, "command word", out)
        if word.startswith("/") or ".." in word.split("/"):
            out.append(f"command word {word!r} leads out of the checkout")
    rs = manifest["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= MAX_SECONDS):
        out.append(f"run_seconds {rs!r} is not a whole number from 1 to {MAX_SECONDS}")

    def under_paths(f: str) -> bool:
        return any(f == p or f.startswith(p.rstrip("/") + "/") for p in paths)

    configs = manifest["configs"]
    if not 1 <= len(configs) <= 24:
        out.append("configs: 1 to 24")
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            out.append(f"config {c.get('name')!r} has keys {sorted(c)}")
            continue
        _name(c["name"], "config", out)
        _line(c["source"], f"config {c['name']} source", out)
        _line(c["why"], f"config {c['name']} why", out)
        if not under_paths(c["file"]) or not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: file {c['file']!r} is not a file under paths")
        if c["file"] in files:
            out.append(f"config file {c['file']} serves two configurations")
        files.add(c["file"])
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            out.append(f"config {c['name']}: reduced is a list of at most 16 keys")
        for key in c["reduced"] if isinstance(c["reduced"], list) else []:
            _name(key, f"config {c['name']} reduced key", out)
    names = {c["name"] for c in configs}

    cells = manifest["workloads"]
    if not 1 <= len(cells) <= 24:
        out.append("workloads: 1 to 24 cells")
    seen, pairs, used = set(), set(), set()
    for w in cells:
        if set(w) != CELL_KEYS:
            out.append(f"cell {w.get('name')!r} has keys {sorted(w)}")
            continue
        for key in ("name", "config", "traffic"):
            _name(w[key], f"cell {key}", out)
        _line(w["why"], f"cell {w['name']} why", out)
        if w["name"] in seen:
            out.append(f"cell {w['name']} named twice")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']}: its config and traffic pair appears twice")
        if w["config"] not in names:
            out.append(f"cell {w['name']}: no configuration {w['config']!r}")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: chips is 1 or 4")
        for f in (f"workloads/{w['traffic']}.json", f"limits/{w['name']}.json"):
            if not (root / BENCH / f).is_file():
                out.append(f"cell {w['name']}: {BENCH}/{f} is missing")
        seen.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    if names - used:
        out.append(f"configurations used by no cell: {sorted(names - used)}")
    four = sum(w.get("chips") == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        out.append(f"{four} cells ask for four chips")

    metrics = manifest["end_to_end"] + manifest["per_layer"]
    if not 1 <= len(manifest["end_to_end"]) <= 16 or not 1 <= len(manifest["per_layer"]) <= 128:
        out.append("end_to_end: 1 to 16 metrics; per_layer: 1 to 128")
    mnames = [m.get("name") for m in metrics]
    if len(set(mnames)) != len(mnames):
        out.append("two metrics share a name")
    e2e = {m.get("name") for m in manifest["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in metrics:
        layer = m in manifest["per_layer"]
        want = LAYER_KEYS if layer else E2E_KEYS
        if set(m) - {"workloads"} != want:
            out.append(f"metric {m.get('name')!r} has keys {sorted(m)}")
            continue
        _name(m["name"], "metric", out)
        if not UNIT.match(m["unit"]):
            out.append(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better is lower or higher")
        if m["source"] not in (SOURCES if layer else E2E_SOURCES):
            out.append(f"metric {m['name']}: source {m['source']!r}")
        if layer:
            _line(m["layer"], f"metric {m['name']} layer", out)
            if m["moves"] not in e2e:
                out.append(f"metric {m['name']} moves {m['moves']!r}, no end-to-end metric")
        elif not (isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25):
            out.append(f"metric {m['name']}: bound {m['bound']!r} is not from 0.01 to 0.25")
        for c in m.get("workloads", []):
            if c not in seen:
                out.append(f"metric {m['name']} lists {c!r}, no such cell")
        if not (root / BENCH / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"metric {m['name']}: {BENCH}/metrics/{m['name']}.py is missing")
    for w in cells:
        if not isinstance(w, dict) or "name" not in w:
            continue
        own = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        if len(own) < 2 or not metrics_of(manifest, w["name"], traced=True):
            out.append(f"cell {w['name']} reports setup_s, another end-to-end metric and a "
                       f"per-layer metric")  # fmt: skip
    return out
