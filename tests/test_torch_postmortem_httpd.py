"""The port's postmortem bundles (``observability/postmortem.py``) and
scrape endpoint (``observability/httpd.py``) against the JAX package's.

The same flight rings (written by the port's recorder into one run
directory) and the same telemetry go through both packages' ``capture``:
the bundles hold the same files, the same manifest keys, the same
recovered events and the same report sections, and a torn final record
is flagged by both.  The endpoint's routes, token gate and collector
500 hold for both servers, and ``/metrics`` over one fake coordinator
gives the same metric names and labels in both packages.
"""

import json
import os
import re
import time
import urllib.error
import urllib.request

import pytest

from nbdistributed_tpu.observability import httpd as jax_httpd
from nbdistributed_tpu.observability import latency as jax_latency
from nbdistributed_tpu.observability import metrics as jax_metrics
from nbdistributed_tpu.observability import postmortem as jax_pm
from nbdistributed_tpu_torch.observability import flightrec
from nbdistributed_tpu_torch.observability import httpd
from nbdistributed_tpu_torch.observability import latency
from nbdistributed_tpu_torch.observability import metrics
from nbdistributed_tpu_torch.observability import postmortem

# ----------------------------------------------------------------------
# postmortem bundles


def _write_ring(directory, proc, pid, events):
    rec = flightrec.FlightRecorder(flightrec.ring_path(directory, proc, pid))
    for etype, fields in events:
        rec.record(etype, **fields)
    rec.flush()
    rec.close()
    return flightrec.ring_path(directory, proc, pid)


TELEMETRY = {0: [{"ts": 100.0, "hbm": [{"id": 0, "in_use": 2_000_000_000,
                                        "peak": 3_000_000_000,
                                        "limit": 85_000_000_000,
                                        "reserved": 2_500_000_000}],
                  "compiles": 0, "compile_s": 0.0, "dedup": 1, "msgs": 9}],
             1: [{"ts": 101.0, "compiles": 0, "compile_s": 0.0}]}


class FakeComm:
    num_workers = 2

    def telemetry_history(self, rank):
        return TELEMETRY.get(rank, [])

    def link_stats(self):
        return {"hosts": {"local": {"ranks": [0, 1], "rtt_ms": 0.2,
                                    "hb_age_s": 0.4, "retries": 0}}}


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    d = tmp_path / "run"
    d.mkdir()
    monkeypatch.setenv("NBD_RUN_DIR", str(d))
    flightrec.reset_for_tests()
    _write_ring(str(d), "rank0", 11, [
        ("worker_start", {"rank": 0, "pid": 11, "world_size": 2}),
        ("dispatch", {"msg_id": "m-died-on", "type": "execute",
                      "attempt": 0})])
    _write_ring(str(d), "rank1", 12, [
        ("worker_start", {"rank": 1, "pid": 12, "world_size": 2}),
        ("cell_end", {"msg_id": "m0", "status": "ok"})])
    _write_ring(str(d), "coordinator", 10, [
        ("send", {"msg_id": "m-died-on", "type": "execute",
                  "ranks": [0, 1]})])
    yield str(d)
    flightrec.reset_for_tests()


def _bundle(mod, run_dir, name):
    out = os.path.join(os.path.dirname(run_dir), name)
    manifest = mod.capture(FakeComm(), [0], out_dir=out,
                           reason="worker 0 exited (code -9)",
                           hang_report="doctor says: stall")
    assert manifest is not None
    files = {}
    for fname in sorted(os.listdir(out)):
        with open(os.path.join(out, fname)) as f:
            files[fname] = (json.load(f) if fname.endswith(".json")
                            else f.read())
    return manifest, files


def test_bundle_files_and_manifest_equal_jax(run_dir):
    got_m, got = _bundle(postmortem, run_dir, "torch_bundle")
    want_m, want = _bundle(jax_pm, run_dir, "jax_bundle")
    assert sorted(got) == sorted(want) == [
        "flight_coordinator.json", "flight_rank0.json",
        "flight_rank1.json", "hang_report.txt", "manifest.json",
        "report.txt", "telemetry.json", "trace.json"]
    assert sorted(got_m) == sorted(want_m)
    assert sorted(got["manifest.json"]) == sorted(want["manifest.json"])
    for key in ("dead_ranks", "ranks", "reason", "rings", "link_stats",
                "hang_report"):
        assert got_m[key] == want_m[key], key
    for name in ("flight_rank0.json", "flight_rank1.json",
                 "flight_coordinator.json", "telemetry.json"):
        assert got[name] == want[name], name
    # The dead rank's ring holds the dispatch record it died on.
    assert got["flight_rank0.json"]["events"][-1]["msg_id"] == "m-died-on"
    assert got["telemetry.json"]["0"][-1]["hbm"][0]["in_use"] == 2e9
    names = [e["name"] for e in got["trace.json"]["traceEvents"]
             if e.get("ph") == "i"]
    assert names == [e["name"] for e in want["trace.json"]["traceEvents"]
                     if e.get("ph") == "i"]
    assert "fr:dispatch" in names
    # The report: the same sections after the title (the port's names
    # the port), the same numbers.
    g, w = got["report.txt"].splitlines(), want["report.txt"].splitlines()
    assert g[0] == "nbdistributed_tpu_torch postmortem"
    assert [ln for ln in g[2:] if not ln.startswith("created")] == \
        [ln for ln in w[2:] if not ln.startswith("created")]
    assert "rank 0: hbm 2.00/85.00 GB" in got["report.txt"]
    assert postmortem.list_bundles(os.path.dirname(run_dir)) == []
    assert got["hang_report.txt"] == "doctor says: stall\n"


@pytest.mark.parametrize("damage", ["truncated", "corrupted"])
def test_torn_tail_is_flagged_by_both(run_dir, damage):
    path = _write_ring(run_dir, "rank0", 11, [
        ("dispatch", {"msg_id": f"m{i}", "type": "execute"})
        for i in range(6)])
    blob = open(path, "rb").read()
    last = blob.rfind(flightrec.REC_MAGIC)
    if damage == "truncated":
        blob = blob[:last + flightrec.REC_HEADER_SIZE + 2]
    else:
        pos = last + flightrec.REC_HEADER_SIZE + 1
        blob = blob[:pos] + bytes([blob[pos] ^ 0xFF]) + blob[pos + 1:]
    open(path, "wb").write(blob)
    got_m, got = _bundle(postmortem, run_dir, "torch_torn")
    want_m, want = _bundle(jax_pm, run_dir, "jax_torn")
    assert got_m["rings"]["0"]["torn_tail"] is True
    assert got_m["rings"]["0"]["recovered"] == 5
    assert {k: v for k, v in got_m["rings"]["0"].items() if k != "path"} \
        == {k: v for k, v in want_m["rings"]["0"].items() if k != "path"}
    assert "TORN final record" in got["report.txt"]
    assert got["flight_rank0.json"] == want["flight_rank0.json"]


def test_bundles_are_numbered_newest_last(run_dir):
    dirs = [postmortem.capture(FakeComm(), [1], reason=f"#{i}")["dir"]
            for i in range(3)]
    assert [os.path.basename(d) for d in dirs] == [
        "postmortem-000", "postmortem-001", "postmortem-002"]
    assert postmortem.list_bundles() == dirs
    assert jax_pm.list_bundles(run_dir) == dirs


def test_capture_never_raises():
    class Broken:
        num_workers = 2

        def telemetry_history(self, rank):
            raise RuntimeError("gone")

    assert postmortem.capture(Broken(), [0]) is None


# ----------------------------------------------------------------------
# the scrape endpoint


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


@pytest.fixture(params=["jax", "torch"])
def server(request):
    mod = {"jax": jax_httpd, "torch": httpd}[request.param]
    servers = []

    def make(**kw):
        kw.setdefault("collect_metrics",
                      lambda: "# TYPE up gauge\nup 1\n")
        kw.setdefault("collect_health", lambda: {"status": "ok"})
        kw.setdefault("collect_latency",
                      lambda: {"summary": {"count": 1}, "records": []})
        srv = mod.MetricsHTTPD(port=0, **kw)
        servers.append(srv)
        return f"http://127.0.0.1:{srv.port}"

    yield make
    for s in servers:
        s.close()


def test_httpd_routes(server):
    base = server()
    code, body, ctype = _get(f"{base}/metrics")
    assert code == 200 and body == b"# TYPE up gauge\nup 1\n"
    assert "version=0.0.4" in ctype
    code, body, _ = _get(f"{base}/healthz")
    assert code == 200 and json.loads(body) == {"status": "ok"}
    code, body, _ = _get(f"{base}/latency.json")
    assert code == 200 and json.loads(body)["summary"]["count"] == 1
    assert _get(f"{base}/nope")[0] == 404


def test_httpd_token_gate(server):
    base = server(token="s3cret")
    assert _get(f"{base}/metrics")[0] == 401
    assert _get(f"{base}/latency.json")[0] == 401
    assert _get(f"{base}/metrics?token=wrong")[0] == 401
    assert _get(f"{base}/metrics?token=s3cret")[0] == 200
    assert _get(f"{base}/latency.json",
                {"Authorization": "Bearer s3cret"})[0] == 200
    assert _get(f"{base}/healthz")[0] == 200


def test_httpd_collector_failure_is_500(server):
    def boom():
        raise RuntimeError("collector exploded")

    base = server(collect_metrics=boom)
    code, body, _ = _get(f"{base}/metrics")
    assert code == 500 and b"collector exploded" in body
    assert _get(f"{base}/healthz")[0] == 200


def _fake_comm(lat_mod, metrics_mod):
    class _Clock:
        @staticmethod
        def stats():
            return {0: {"offset_s": 0.001, "min_rtt_s": 0.0005,
                        "samples": 3}}

        @staticmethod
        def offset(_r):
            return 0.001

    class _Comm:
        num_workers = 2
        clock = _Clock()
        lat = lat_mod.LatencyObservatory(
            enabled=True, registry=metrics_mod.MetricsRegistry())

        @staticmethod
        def last_seen(r):
            return time.time() - 0.5

        @staticmethod
        def last_telemetry(r):
            snap = {"ts": time.time(), "compiles": 0, "compile_s": 0.0,
                    "dedup": 2, "msgs": 40}
            if r == 0:
                snap["hbm"] = [{"id": 0, "in_use": 1000, "peak": 2000,
                                "limit": 4000, "reserved": 1500}]
            return snap

        @staticmethod
        def dead_ranks():
            return {1}

        @staticmethod
        def connected_ranks():
            return [0]

        @staticmethod
        def pending_snapshot():
            return {"m1": {}}

    return _Comm()


_SERIES = re.compile(r"^(nbd_(?:worker|heartbeat|clock)\w*)(\{[^}]*\})? ")


def _series(text):
    return sorted({m.groups() for m in map(_SERIES.match,
                                           text.splitlines()) if m})


def test_metrics_names_and_labels_equal_jax(monkeypatch):
    # Fresh registries: the process-wide ones carry whatever earlier
    # clusters of this process recorded.
    for mod in (metrics, jax_metrics):
        monkeypatch.setattr(mod, "registry",
                            lambda fresh=mod.MetricsRegistry(): fresh)
    got_cm, got_ch, got_cl = httpd.collectors_for_comm(
        _fake_comm(latency, metrics))
    want_cm, want_ch, want_cl = jax_httpd.collectors_for_comm(
        _fake_comm(jax_latency, jax_metrics))
    got, want = got_cm(), want_cm()
    assert metrics.validate_prometheus_text(got) == []
    assert _series(got) == _series(want)
    assert ("nbd_worker_hbm_in_use_bytes", '{rank="0"}') in _series(got)
    assert 'nbd_worker_hbm_in_use_bytes{rank="0"} 1000' in got
    gh, wh = got_ch(), want_ch()
    assert {k: v for k, v in gh.items() if k != "ts"} == \
        {k: v for k, v in wh.items() if k != "ts"}
    assert gh["status"] == "degraded" and gh["dead"] == [1]
    assert got_cl() == want_cl() == {"summary": {"count": 0, "dropped": 0},
                                     "records": []}
