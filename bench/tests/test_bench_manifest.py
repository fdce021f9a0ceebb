"""BENCHMARK.json keeps the contract's names, units and sizes, and every
name in it finds its file."""
from __future__ import annotations

import json

import pytest

from bench_tiny import ROOT

from bench import harness, manifest

M = manifest.load()


def test_manifest_has_no_problems():
    assert manifest.problems(M) == []


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_cuts_and_checks(conf):
    cfg = harness.load_json(ROOT / conf["file"])
    assert cfg["name"] == conf["name"]
    assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    for key in ("dim", "n_cap", "n_live", "r", "alpha", "metric",
                "quantized", "policy", "batch_updates", "data", "builder",
                "guarantees", "assumed"):
        assert key in cfg
    assert 0 < cfg["checks"]["recall_min"] <= 1
    assert cfg["checks"]["dist_gap_max"] > 0
    # a width is never cut
    assert not {"dim", "r"} & set(cfg["reduced"])


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(cell):
    c, cfg, tr = harness.cell_files(M, cell["name"])
    assert c is cell or c == cell
    assert tr["cycle"] and int(tr["query_batch"]) > 0
    assert int(tr["k"]) <= int(tr["l"])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda e: e["name"])
def test_per_layer_reader_exists(metric):
    assert callable(harness.metric_reader(metric["name"]))


def test_layers_are_named_alike():
    by_layer = {}
    for e in M["per_layer"]:
        by_layer.setdefault(e["layer"].split(":")[0], set()).add(e["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_problems_are_found():
    bad = json.loads(json.dumps(M))
    bad["end_to_end"][0]["name"] = "has space"
    bad["end_to_end"][1]["unit"] = "per second"
    bad["end_to_end"][2]["bound"] = 0.5
    bad["run_seconds"] = 52
    found = manifest.problems(bad)
    assert len(found) >= 4
