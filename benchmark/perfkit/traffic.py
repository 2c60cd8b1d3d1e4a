"""The one traffic generator: every mix is a JSON file of parameters
that this module reads.  Everything is drawn from ``--seed`` with
numpy's PCG64 through a ``SeedSequence`` keyed by (seed, stream, index),
so the same seed gives the same inputs and any index can be drawn
without drawing the ones before it.

Two kinds of mix:

* ``"driver": "train"`` -- batches of ``batch`` rows of ``seq_len``
  token ids; ``segments`` numbers the documents.  The rows' document
  lengths are a fixed set (``row_set`` rows packed from the mix's
  ``documents`` distribution under its ``pairing_seed``), the same for
  every seed; each round of the stream takes the set in an order drawn
  from the seed, each row's documents in an order of its own, and every
  row's ids are drawn anew.
* ``"driver": "serve"`` -- a stream of requests (prompt ids, tokens to
  generate).  The request shapes are a fixed set (``shape_set``
  stratified quantiles of the ``prompt`` and ``output`` distributions),
  the same for every seed; each round of the stream is the set in an
  order drawn from the seed, and every prompt's ids are drawn anew.

So two seeds do the same work in another order.
"""

from __future__ import annotations

import statistics

import numpy as np

_STREAMS = {"batch": 1, "request": 2, "order": 3, "pairing": 4,
            "check": 5, "documents": 6}


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    """A generator for item ``index`` of ``stream`` under ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), _STREAMS[stream],
                                 int(index)])
    return np.random.Generator(np.random.PCG64(ss))


def clipped_lognormal(dist: dict, u):
    """Lengths at quantiles ``u`` (array in (0, 1)) of a lognormal of
    median ``dist["median"]`` and log-sd ``dist["sigma"]``, rounded and
    clipped to ``[min, max]``."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf(float(x)) for x in np.atleast_1d(u)])
    n = np.rint(dist["median"] * np.exp(dist["sigma"] * z)).astype(np.int64)
    return np.clip(n, dist["min"], dist["max"])


# ----------------------------------------------------------------------
# training batches

def _pack(mix: dict, g: np.random.Generator) -> list[int]:
    """One row's document lengths: drawn until the row is full, the last
    one cut to fit."""
    lens, left = [], mix["seq_len"]
    while left > 0:
        n = int(clipped_lognormal(mix["documents"],
                                  g.uniform(1e-9, 1 - 1e-9))[0])
        lens.append(min(n, left))
        left -= lens[-1]
    return lens


def train_rows(mix: dict) -> list[list[int]]:
    """The fixed set of rows (document lengths), packed under the mix's
    ``pairing_seed``."""
    g = rng(mix["pairing_seed"], "pairing")
    return [_pack(mix, g) for _ in range(mix["row_set"])]


def doc_lengths(mix: dict, seed: int, index: int) -> list[list[int]]:
    """The document lengths of each row of batch ``index``: row ``k`` of
    the stream is row ``k % row_set`` of its round's order, its
    documents shuffled."""
    rows, R, out = train_rows(mix), mix["row_set"], []
    for k in range(index * mix["batch"], (index + 1) * mix["batch"]):
        row = rows[rng(seed, "order", k // R).permutation(R)[k % R]]
        perm = rng(seed, "documents", k).permutation(len(row))
        out.append([row[i] for i in perm])
    return out


def train_batch(mix: dict, seed: int, index: int, vocab: int) -> dict:
    """Batch ``index``: ``tokens`` (B, S) int64 uniform over the
    vocabulary and ``segments`` (B, S) int64, the document number of
    each position (:func:`doc_lengths`)."""
    B, S = mix["batch"], mix["seq_len"]
    lens = doc_lengths(mix, seed, index)
    seg = np.zeros((B, S), dtype=np.int64)
    for b, row in enumerate(lens):
        seg[b] = np.repeat(np.arange(len(row)), row)
    tokens = rng(seed, "batch", index).integers(0, vocab, size=(B, S),
                                                dtype=np.int64)
    return {"tokens": tokens, "segments": seg}


# ----------------------------------------------------------------------
# serving requests

def request_shapes(mix: dict) -> list[tuple[int, int]]:
    """The fixed set of (prompt length, tokens to generate): stratified
    quantiles of both distributions, paired by a permutation fixed by
    the mix's ``pairing_seed``."""
    K = mix["shape_set"]
    u = (np.arange(K) + 0.5) / K
    prompts = clipped_lognormal(mix["prompt"], u)
    outputs = clipped_lognormal(mix["output"], u)
    perm = rng(mix["pairing_seed"], "pairing").permutation(K)
    return [(int(p), int(o)) for p, o in zip(prompts, outputs[perm])]


def request(mix: dict, seed: int, index: int, vocab: int) -> dict:
    """Request ``index`` of the stream: ``prompt`` (list of ids) and
    ``max_new`` (tokens to generate, the first from the prefill)."""
    shapes = request_shapes(mix)
    K = len(shapes)
    order = rng(seed, "order", index // K).permutation(K)
    plen, out = shapes[order[index % K]]
    ids = rng(seed, "request", index).integers(0, vocab, size=plen)
    return {"prompt": ids.tolist(), "max_new": out}

