"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, mix and metric it names is found by name."""

import json
import math
import re

import pytest

from benchmark import cell as C

BENCH = json.loads((C.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and \
        "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits the driver's time.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_keep_to_their_characters():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert _line(m["layer"])


def test_setup_and_one_more_end_to_end_metric_in_every_cell():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] == 0.25
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if applies(m, w["name"])]
        layer = [m["name"] for m in BENCH["per_layer"]
                 if applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_moves_target_is_reported_where_the_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in cells:
            if applies(m, cell):
                assert applies(e2e[m["moves"]], cell), (m["name"], cell)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_end_to_end_metrics_are_quantities_a_run_computes():
    from benchmark.run import base_name
    for m in BENCH["end_to_end"]:
        assert base_name(m["name"]) in {"setup_s", "fps", "frame_ms_p95",
                                        "peak_mib"}, m["name"]
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        reported = [base_name(m["name"]) for m in BENCH["end_to_end"]
                    if applies(m, cell)]
        assert len(reported) == len(set(reported)), cell


def test_cells_configurations_mixes_and_metrics_are_found_by_name():
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((C.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell, config, traffic = C.find_cell(w["name"])
        assert cell == w and config["name"] == w["config"]
        assert "trajectory" in traffic and "scene" in traffic
    for m in BENCH["per_layer"]:
        from benchmark.run import load_reader
        assert callable(load_reader(m["name"]))
    with pytest.raises(KeyError):
        C.find_cell("no.such.cell")


def test_configuration_settings_are_the_ports_defaults_or_assumed():
    from surfelmeshing_tpu_torch.config import SurfelMeshingConfig
    defaults = SurfelMeshingConfig()
    for c in BENCH["configs"]:
        cfg = json.loads((C.ROOT / c["file"]).read_text())
        settings = C.program_settings(cfg)
        changed = {k for k, v in settings.items()
                   if getattr(defaults, k) != v}
        assumed = " ".join([*cfg["assumed"], *cfg["assumed"].values()])
        for k in changed:
            assert k in assumed, k
        SurfelMeshingConfig(**settings).validate()
        assert math.isinf(settings["point_radius_clamp_factor"])


def test_files_under_paths_are_named_from_name_characters():
    for p in (C.ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(C.ROOT).as_posix()
        assert FILE.match(rel) and len(rel) <= 200, rel
