"""``BENCHMARK.json``: loading and the rules its names, units and sizes
keep."""
from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = SOURCES_E2E + ("program_span", "program_counter")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def problems(m: dict, root: Path = ROOT) -> list:
    """Every way ``m`` breaks the benchmark's contract (empty if none)."""
    out = []
    if set(m) != TOP_KEYS:
        out.append(f"top-level keys {sorted(m)}")
    if not 1 <= len(m["paths"]) <= 16 or not all(
            PATH.match(p) and not p.startswith("/") and ".." not in p
            for p in m["paths"]):
        out.append("paths")
    if not 1 <= len(m["command"]) <= 32 or not all(
            _line(w) for w in m["command"]):
        out.append("command")
    rs = m["run_seconds"]
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        out.append("run_seconds")
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            if not NAME.match(e["name"]):
                out.append(f"{group} name {e['name']!r}")
            names.setdefault(group, []).append(e["name"])
    for group, ns in names.items():
        if len(set(ns)) != len(ns):
            out.append(f"duplicate names in {group}")
    if len(set(names["end_to_end"]) & set(names["per_layer"])):
        out.append("a metric name is both end-to-end and per-layer")
    configs = {c["name"]: c for c in m["configs"]}
    cells = {w["name"]: w for w in m["workloads"]}
    for c in m["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c['name']} keys")
        if not (_line(c["source"]) and _line(c["why"])):
            out.append(f"config {c['name']} source / why")
        if not (root / c["file"]).is_file() or not any(
                c["file"].startswith(p.rstrip("/") + "/") for p in m["paths"]):
            out.append(f"config {c['name']} file {c['file']}")
        if len(c["reduced"]) > 16 or not all(NAME.match(k)
                                             for k in c["reduced"]):
            out.append(f"config {c['name']} reduced")
        if not any(w["config"] == c["name"] for w in m["workloads"]):
            out.append(f"config {c['name']} used by no cell")
    pairs = set()
    for w in m["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"cell {w['name']} keys")
        if w["config"] not in configs or w["chips"] not in (1, 4):
            out.append(f"cell {w['name']} config / chips")
        if not NAME.match(w["traffic"]) or not _line(w["why"]):
            out.append(f"cell {w['name']} traffic / why")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']} repeats a pair")
        pairs.add((w["config"], w["traffic"]))
    e2e = {e["name"]: e for e in m["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for e in m["end_to_end"]:
        keys = set(e) - {"workloads"}
        if keys != {"name", "unit", "better", "bound", "source"}:
            out.append(f"metric {e['name']} keys")
        if e["source"] not in SOURCES_E2E or e["better"] not in (
                "lower", "higher") or not UNIT.match(e["unit"]):
            out.append(f"metric {e['name']} source / better / unit")
        if not 0.01 <= e["bound"] <= 0.25:
            out.append(f"metric {e['name']} bound")
        if not all(c in cells for c in e.get("workloads", [])):
            out.append(f"metric {e['name']} workloads")
    for e in m["per_layer"]:
        keys = set(e) - {"workloads"}
        if keys != {"name", "unit", "better", "source", "layer", "moves"}:
            out.append(f"metric {e['name']} keys")
        if e["source"] not in SOURCES or e["better"] not in (
                "lower", "higher") or not UNIT.match(e["unit"]):
            out.append(f"metric {e['name']} source / better / unit")
        if e["moves"] not in e2e or not _line(e["layer"]):
            out.append(f"metric {e['name']} moves / layer")
        for c in e.get("workloads", list(cells)):
            moved = e2e.get(e["moves"], {})
            if c not in cells or c not in moved.get("workloads", cells):
                out.append(f"metric {e['name']} cell {c}")
        if not (root / "bench" / "metrics" / f"{e['name']}.py").is_file():
            out.append(f"metric {e['name']} has no reader")
    for w in m["workloads"]:
        if not (root / "bench" / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"cell {w['name']} has no traffic file")
        reported = [e for e in m["end_to_end"]
                    if w["name"] in e.get("workloads", [w["name"]])]
        if len(reported) < 2 or not any(
                w["name"] in e.get("workloads", [w["name"]])
                for e in m["per_layer"]):
            out.append(f"cell {w['name']} reports too few metrics")
    n4 = sum(w["chips"] == 4 for w in m["workloads"])
    if n4 > max(1, len(m["workloads"]) // 4):
        out.append("too many four-chip cells")
    full = 2 + 14 * 24
    if full * (rs + 60) + 24 * 2 * 90 + 1200 > 43200:
        out.append("run_seconds too long for 24 cells")
    if len(json.dumps(m).encode()) > 64 * 1024:
        out.append("larger than 64 KiB")
    return out
