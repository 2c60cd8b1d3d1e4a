"""The generator: the same seed gives the same inputs, every seed the
same shapes of work."""

import numpy as np

from perfkit import spec, traffic

TRAIN = spec.load_json(spec.BENCH / "traffic" / "train.s8192.json")
SERVE = spec.load_json(spec.BENCH / "traffic" / "serve.docqa.json")
BIG = 2**31 + 123456789


def test_train_batch_is_deterministic_by_seed():
    a = traffic.train_batch(TRAIN, BIG, 3, 32000)
    b = traffic.train_batch(TRAIN, BIG, 3, 32000)
    c = traffic.train_batch(TRAIN, BIG + 1, 3, 32000)
    for k in ("tokens", "segments"):
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert not np.array_equal(a["tokens"],
                              traffic.train_batch(TRAIN, BIG, 4, 32000)[
                                  "tokens"])


def test_train_documents_fill_the_row_within_bounds():
    for i in range(20):
        lens = traffic.doc_lengths(TRAIN, 11, i)
        assert [sum(r) for r in lens] == [TRAIN["seq_len"]] * TRAIN["batch"]
        d = TRAIN["documents"]
        for row in lens:
            assert all(n <= d["max"] for n in row)
            assert sum(n < d["min"] for n in row) <= 1   # the one cut
        seg = traffic.train_batch(TRAIN, 11, i, 100)["segments"]
        assert np.all(np.diff(seg, axis=1) >= 0)
        assert [len(r) for r in lens] == [int(s[-1]) + 1 for s in seg]


def test_every_seed_trains_on_the_same_rows_in_its_own_order():
    R = TRAIN["row_set"]
    rows = sorted(sorted(r) for r in traffic.train_rows(TRAIN))
    orders = []
    for seed in (1, BIG):
        got = [traffic.doc_lengths(TRAIN, seed, i)[0] for i in range(R)]
        assert sorted(sorted(r) for r in got) == rows
        orders.append(got)
    assert orders[0] != orders[1]


def test_requests_are_deterministic_and_share_one_shape_set():
    a = [traffic.request(SERVE, BIG, i, 32000) for i in range(10)]
    b = [traffic.request(SERVE, BIG, i, 32000) for i in range(10)]
    assert a == b
    K = SERVE["shape_set"]
    shapes = sorted(traffic.request_shapes(SERVE))
    for seed in (1, BIG):
        got = sorted((len(r["prompt"]), r["max_new"]) for r in
                     (traffic.request(SERVE, seed, i, 32000)
                      for i in range(K, 2 * K)))
        assert got == shapes
    other = [traffic.request(SERVE, BIG + 1, i, 32000) for i in range(10)]
    assert [r["prompt"] for r in other] != [r["prompt"] for r in a]


def test_request_shapes_follow_the_mix():
    shapes = traffic.request_shapes(SERVE)
    p, o = SERVE["prompt"], SERVE["output"]
    assert len(shapes) == SERVE["shape_set"]
    assert all(p["min"] <= n <= p["max"] for n, _ in shapes)
    assert all(o["min"] <= n <= o["max"] for _, n in shapes)
    prompts = sorted(n for n, _ in shapes)
    assert abs(prompts[len(prompts) // 2] - p["median"]) < 0.05 * p["median"]
    assert all(n + m <= SERVE["server"]["max_len"] for n, m in shapes)


def test_profiled_training_steps_take_the_trace_seed_batches(monkeypatch):
    from conftest import run_small, small_train_cell
    seen = []
    real = traffic.train_batch

    def spy(mix, seed, index, vocab):
        seen.append((seed, index))
        return real(mix, seed, index, vocab)

    monkeypatch.setattr(traffic, "train_batch", spy)
    cell, cfg = small_train_cell()
    for seed in (BIG, BIG + 1):
        seen.clear()
        line, result = run_small(cell, cfg, seed=seed, seconds=0.5,
                                 trace=True)
        assert line["correct"]
        traced = [i for s, i in seen if s == cell.mix["trace_seed"]]
        assert traced == list(range(cell.mix["trace_steps"]))
        assert result["record"]["profiled_batches"] == traced
