"""The benchmark's files: BENCHMARK.json against the contract's shape, and
every cell, configuration, traffic mix, limit and metric reader found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = common.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_units_and_one_line_texts():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    c = common.find_cell(cell)
    assert c.config["name"] == c.entry["config"]
    conf = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert conf["reduced"] == c.config["reduced"] and conf["source"] == c.config["source"]
    assert common.driver(c).__name__.endswith(c.traffic["driver"])
    from portbench.run import limits

    assert limits(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(common.reader(m["name"]))
        assert m["moves"] in e2e  # a per-layer metric's cell reports what it moves
    assert c.entry["chips"] == 1


def test_each_config_is_used_and_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]} and len(files) == len(set(files))
    assert all(f.startswith("portbench/") for f in files)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        common.find_cell("no.such.cell")
