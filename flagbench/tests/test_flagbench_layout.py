"""BENCHMARK.json and every file it names: present, well formed, found by name."""

import json
import re

import pytest

from flagbench import counts, harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["flagbench"]
    assert SPEC["command"][1].startswith("flagbench/")
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("flagbench/configs/")
    loaded = harness.load_config(SPEC, config["name"])
    assert loaded["name"] == config["name"]
    assert loaded["source"] == config["source"]
    assert loaded["reduced"] == config["reduced"]
    assert loaded["rows"] == loaded["baselines"] * loaded["pols"]
    assert loaded["flagger"]["width"] in counts.NETWORK_OPS


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_and_reports(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    traffic = harness.load_traffic(cell["traffic"])
    assert traffic["loop"] in ("resident", "stream")
    harness.load_config(SPEC, cell["config"])
    e2e = {m["name"] for m in harness.end_to_end_metrics(SPEC, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_metrics(SPEC, cell["name"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert callable(harness.load_reader(metric["name"]))


def test_setup_bound():
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_config_is_used():
    used = {c["config"] for c in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_file_names_and_size():
    assert len(json.dumps(SPEC)) < 64 * 1024
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_channel_mask_covers_the_ranges():
    config = harness.load_config(SPEC, "meerkat-l-32k")
    ranges = harness.load_traffic("chanmask")["channel_ranges_mhz"]
    mask = harness.channel_mask(config, ranges, "cpu").numpy().astype(bool)
    lo, hi = config["band_mhz"]
    freq = lo + (hi - lo) * (mask.nonzero()[0]) / config["channels"]
    for f in freq:  # every masked channel lies in a range
        assert any(a <= f <= b for a, b in ranges)
    width = (hi - lo) / config["channels"]
    for a, b in ranges:  # every range is masked across its width
        inside = [(lo + c * width) for c in range(config["channels"])
                  if a <= lo + c * width <= b]
        assert len(inside) >= int((b - a) / width)
        first = int(round((inside[0] - lo) / width))
        assert mask[first:first + len(inside)].all()
    share = mask.mean()
    assert 0.28 < share < 0.30, share
    assert harness.channel_mask(config, [], "cpu") is None
