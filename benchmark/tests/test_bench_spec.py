"""``BENCHMARK.json`` against the contract's rules, and every name in it
found as a file."""

import re

import pytest

from perfkit import spec

S = spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(S) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(S["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in S["paths"])
    assert 1 <= len(S["command"]) <= 32
    assert all(TEXT.match(w) for w in S["command"])
    assert isinstance(S["run_seconds"], int) and 1 <= S["run_seconds"] <= 51
    assert spec.SPEC_FILE.stat().st_size <= 64 * 1024


def test_command_names_only_files_under_paths():
    for w in S["command"][1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in S["paths"])


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in S[group]]
        assert all(NAME.match(n) for n in names), names
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in S["end_to_end"] + S["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_configs():
    for c in S["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in S["paths"])
        body = spec.load_json(spec.ROOT / c["file"])
        assert body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        widths = ("_dim", "_rank", "size", "heads", "factor", "per_tok")
        assert not [k for k in c["reduced"] if k.endswith(widths)]
    files = [c["file"] for c in S["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in S["workloads"]}
    assert used == {c["name"] for c in S["configs"]}


def test_workloads():
    pairs = [(w["config"], w["traffic"]) for w in S["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in S["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(S["workloads"]) // 4)
    for w in S["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        cell = spec.load_cell(w["name"], S)
        assert cell.mix["driver"] in ("train", "serve")
        assert w["chips"] in spec.driver(cell.mix["driver"]).CHIPS


def test_a_driver_refuses_a_cell_of_chips_it_does_not_run():
    import dataclasses
    from perfkit import runner
    cell = spec.load_cell(S["workloads"][0]["name"], S)
    assert runner.driver_of(cell).CHIPS == (1,)
    with pytest.raises(ValueError, match="not 4"):
        runner.driver_of(dataclasses.replace(cell, chips=4))


def test_a_split_metric_reads_with_its_quantity_s_reader():
    shared = spec.BENCH / "metrics" / "idle_share.py"
    assert spec.metric_path("idle_share.train") == shared
    assert spec.metric_path("idle_share.serve") == shared
    assert spec.metric_path("mfu.train").name == "mfu.train.py"
    with pytest.raises(FileNotFoundError):
        spec.metric_path("no_such_metric.train")


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics():
    e2e = {m["name"]: m for m in S["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in S["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in S["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and TEXT.match(m["layer"])
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in S["workloads"]]):
            assert _reported(e2e[m["moves"]], cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in S["end_to_end"] + S["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert spec.metric_path(m["name"]).exists()
    cells = [w["name"] for w in S["workloads"]]
    for cell in cells:
        mine = [m for m in S["end_to_end"] if _reported(m, cell)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(_reported(m, cell) for m in S["per_layer"])
    for m in S["end_to_end"] + S["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in cells


def test_layers_are_named_in_perf_md():
    perf = (spec.ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in S["per_layer"]}:
        assert f"| {layer} |" in perf, layer


def test_every_kernel_roofline_has_a_step_mfu_beside_it():
    by_move = {}
    for m in S["per_layer"]:
        by_move.setdefault(m["moves"], []).append(m["name"])
    for move, names in by_move.items():
        if any(n.endswith("_roofline") for n in names):
            assert any("mfu" in n for n in names), move


@pytest.mark.parametrize("cell", [w["name"] for w in S["workloads"]])
def test_limits_exist(cell):
    limits = spec.load_cell(cell, S).limits
    assert limits and all(v > 0 for v in limits.values()
                          if isinstance(v, (int, float)))


def test_full_check_fits_its_time():
    rs = S["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
