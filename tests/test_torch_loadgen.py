"""The port's load generator (``serving_fast/loadgen.py``), its
perf-regression core (``observability/perfbase.py``) and the
``tools/nbd_torch_perfwatch.py`` CLI against the JAX package's.

Part 1 runs the load-generator cases of ``tests/unit/test_paged_blocks.py``
on the port (the JAX file's source compiled with its
``nbdistributed_tpu.`` imports pointed at ``nbdistributed_tpu_torch.``).
Part 2 feeds both packages the same inputs: ``synth_schedule`` must be
byte-equal for the same ``LoadConfig``; ``score_slo``,
``validate_report``, ``extract_metrics``, ``make_baseline``,
``score`` and ``format_diff`` must give the same answers on the same
reports.  Part 3 pins the perfwatch tool's exit codes, with every
baselines file in ``tmp_path``.
"""

import copy
import importlib.util
import json
import os

import jax_unit_cases
import pytest

import nbdistributed_tpu.observability.perfbase as jax_perfbase
import nbdistributed_tpu.serving_fast.loadgen as jax_loadgen
import nbdistributed_tpu_torch.observability.perfbase as t_perfbase
import nbdistributed_tpu_torch.serving_fast.loadgen as t_loadgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADGEN_CASES = (
    "test_schedule_deterministic_and_in_window",
    "test_schedule_uniform_gap", "test_config_validation",
    "test_report_schema_pinned_and_conserved",
    "test_validate_report_rejects_broken_conservation",
    "test_report_detail_per_request", "test_score_slo_hung_always_fails",
    "test_score_slo_targets", "test_percentile_nearest_rank")


CASES = jax_unit_cases.load("test_paged_blocks.py", "torch")
globals().update(jax_unit_cases.cases(CASES, LOADGEN_CASES))

LOADGEN = {"jax": jax_loadgen, "torch": t_loadgen}
PERFBASE = {"jax": jax_perfbase, "torch": t_perfbase}

CONFIGS = [
    dict(rps=3.0, duration_s=10.0, arrival="poisson", seed=0,
         prompt_len=(16, 200), max_new=(32, 32), vocab=49152),
    dict(rps=8.0, duration_s=15.0, seed=1),
    dict(rps=4.0, duration_s=2.0, arrival="uniform", seed=5,
         prompt_len=(2, 5), max_new=(4, 4)),
    dict(rps=50.0, duration_s=3.0, seed=123, prompt_len=(1, 1),
         max_new=(1, 64), vocab=2, priority=3),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_synth_schedule_byte_equal(kw):
    got = {p: json.dumps(m.synth_schedule(m.LoadConfig(**kw)),
                         sort_keys=True)
           for p, m in LOADGEN.items()}
    assert got["torch"] == got["jax"]
    assert json.dumps(t_loadgen.LoadConfig(**kw).to_dict(),
                      sort_keys=True) == json.dumps(
        jax_loadgen.LoadConfig(**kw).to_dict(), sort_keys=True)


def _report(**kw) -> dict:
    """A real report: the unit file's instant transport through the
    port's ``run_load``."""
    tr = CASES["InstantTransport"](reject_every=kw.pop("reject_every", 3))
    return t_loadgen.run_load(tr, CASES["_tiny_cfg"](**kw))


@pytest.mark.parametrize("targets", [
    {}, {"slo_ttft_p99_ms": 1e6, "slo_tpot_p99_ms": 1e6},
    {"slo_ttft_p99_ms": 1e-9}, {"slo_tpot_p99_ms": 1e-9}])
def test_score_slo_and_validate_equal(targets):
    rep = _report(seed=2)
    reports = [rep]
    hung = copy.deepcopy(rep)
    hung["hung"] = 1
    hung["completed"] -= 1
    reports.append(hung)
    for r in reports:
        got = {p: m.score_slo(r, m.LoadConfig(**targets))
               for p, m in LOADGEN.items()}
        assert got["torch"] == got["jax"]
    for p, m in LOADGEN.items():
        m.validate_report(rep)
    broken = copy.deepcopy(rep)
    broken["completed"] += 5
    errs = {}
    for p, m in LOADGEN.items():
        with pytest.raises(Exception) as ei:
            m.validate_report(broken)
        errs[p] = (type(ei.value).__name__, str(ei.value))
    assert errs["torch"] == errs["jax"]


STAGES = {"count": 10, "dropped": 0, "stages": {
    "queue": {"p50": 1.0, "p99": 4.0, "mean": 1.5, "share": 0.1},
    "prefill": {"p50": 10.0, "p99": 40.0, "mean": 15.0, "share": 0.4},
    "decode": {"p50": 20.0, "p99": 50.0, "mean": 25.0, "share": 0.5}},
    "ttft": {"p50": 30.0, "p99": 90.0}, "e2e": {"p50": 60.0, "p99": 200.0}}


def _moved(metrics: dict, factor: float) -> dict:
    out = dict(metrics)
    for k, v in metrics.items():
        if isinstance(v, (int, float)):
            out[k] = v * factor
    return out


@pytest.mark.parametrize("factor,scale", [
    (1.0, 1.0), (0.5, 1.0), (3.5, 1.0), (3.5, 4.0), (1.1, 0.01)])
def test_perfbase_score_and_diff_equal(factor, scale):
    rep = _report(seed=4, reject_every=4)
    got = {}
    for p, m in PERFBASE.items():
        metrics = m.extract_metrics(rep, STAGES)
        base = m.make_baseline(metrics, source="same run",
                               bands={"tokens_per_s": 0.3})
        res = m.score(base, _moved(metrics, factor), band_scale=scale)
        got[p] = (metrics, base, res, m.format_diff(res))
    assert got["torch"] == got["jax"]
    metrics, _base, res, _diff = got["torch"]
    assert metrics and ("pass" in res)
    if factor == 1.0:
        assert res["pass"]


def test_baselines_roundtrip_across_packages(tmp_path):
    rep = _report(seed=6)
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        path = str(tmp_path / f"{writer}.json")
        w = PERFBASE[writer]
        doc = {"baselines": {"k": w.make_baseline(
            w.extract_metrics(rep), source="x")}}
        w.save_baselines(path, doc)
        assert PERFBASE[reader].load_baselines(path) == \
            w.load_baselines(path)


# ----------------------------------------------------------------------
# the perfwatch tool


def _perfwatch():
    path = os.path.join(ROOT, "tools", "nbd_torch_perfwatch.py")
    spec = importlib.util.spec_from_file_location("nbd_torch_perfwatch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_perfwatch_exit_codes(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("NBD_PERFWATCH_BASELINE", raising=False)
    pw = _perfwatch()
    rep = _report(seed=8)
    rpath = tmp_path / "load.json"
    rpath.write_text(json.dumps(rep))
    base = str(tmp_path / "baselines.json")
    # No baselines file named: refused, whatever the repo holds.
    assert pw.main(["--report", str(rpath)]) == 2
    assert "--baseline" in capsys.readouterr().err
    # A named file that does not exist yet: nothing to gate against.
    assert pw.main(["--report", str(rpath), "--baseline", base]) == 2
    # Seed it, then gate the same report: within every band.
    assert pw.main(["--report", str(rpath), "--baseline", base,
                    "--update", "--source", "test"]) == 0
    doc = json.loads(open(base).read())
    assert doc["baselines"]["serving_smoke"]["metrics"]
    diff = tmp_path / "diff.json"
    assert pw.main(["--report", str(rpath), "--baseline", base,
                    "--diff", str(diff)]) == 0
    assert json.loads(diff.read_text())["pass"] is True
    # Half the throughput: a regression.
    slow = dict(rep, tokens_per_s=rep["tokens_per_s"] * 0.5)
    spath = tmp_path / "slow.json"
    spath.write_text(json.dumps(slow))
    assert pw.main(["--report", str(spath), "--baseline", base]) == 1
    # The knob names the file as --baseline does.
    monkeypatch.setenv("NBD_PERFWATCH_BASELINE", base)
    assert _perfwatch().main(["--report", str(rpath)]) == 0
    # An entry the file lacks, and an unreadable report.
    assert pw.main(["--report", str(rpath), "--baseline", base,
                    "--key", "nope"]) == 2
    assert pw.main(["--report", str(tmp_path / "missing.json"),
                    "--baseline", base]) == 2
