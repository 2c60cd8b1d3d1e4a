"""A whole run with the timed path broken underneath must come out not
correct: once for each fault the cell can have.  The runs skip the look
for a chip and run small on the CPU with the cells' own limits."""

import pytest
import torch

from conftest import run_small, small_serve_cell, small_train_cell


def test_sound_runs_are_correct():
    for cell, cfg in (small_train_cell(), small_serve_cell()):
        line, res = run_small(cell, cfg)
        assert line["correct"], res["checks"]
        assert line["failed"] == 0 and line["attempted"] > 0


def test_training_step_that_leaves_the_state_unchanged(monkeypatch):
    from nbdistributed_tpu_torch.models import transformer
    monkeypatch.setattr(transformer.AdamW, "step", lambda self: None)
    line, res = run_small(*small_train_cell())
    assert not line["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_on_half_the_batch(monkeypatch):
    from nbdistributed_tpu_torch.models import transformer
    full = transformer.loss_fn

    def half(params, batch, cfg, **kw):
        S = batch["tokens"].shape[1] // 2
        return full(params, {k: v[:, :S] for k, v in batch.items()}, cfg,
                    **kw)

    monkeypatch.setattr(transformer, "loss_fn", half)
    line, res = run_small(*small_train_cell())
    assert not line["correct"], res["checks"]


def test_serving_step_that_leaves_the_state_unchanged(monkeypatch):
    from nbdistributed_tpu_torch.models.serving import DecodeServer
    monkeypatch.setattr(DecodeServer, "_decode_step",
                        lambda self: self._last.clone())
    line, res = run_small(*small_serve_cell())
    assert not line["correct"], res["checks"]


def test_serving_with_half_the_batch_left_out(monkeypatch):
    from nbdistributed_tpu_torch.models.serving import DecodeServer
    step = DecodeServer._decode_step

    def half(self):
        last = self._last.clone()
        nxt = step(self)
        keep = torch.arange(len(nxt), device=nxt.device) < len(nxt) // 2
        self._last = torch.where(keep, nxt, last)
        return self._last

    monkeypatch.setattr(DecodeServer, "_decode_step", half)
    line, res = run_small(*small_serve_cell())
    assert not line["correct"], res["checks"]


def test_serving_with_a_token_altered_where_it_is_produced(monkeypatch):
    # Every request's first token (sampled from its prefill's logits, a
    # batch of one row) is altered, so every request sampled for the
    # check holds one altered token.
    from nbdistributed_tpu_torch.models import serving
    sample = serving._sample

    def altered(logits, *a, **kw):
        t = sample(logits, *a, **kw)
        if logits.shape[0] == 1:
            t = (t + 1) % logits.shape[-1]
        return t

    monkeypatch.setattr(serving, "_sample", altered)
    line, res = run_small(*small_serve_cell())
    assert not line["correct"], res["checks"]
