"""Speculative decoding (Leviathan et al. 2022, arXiv:2211.17192;
counterpart of ``nbdistributed_tpu/models/speculative.py``).

A small draft model proposes ``gamma`` tokens autoregressively; the
target scores all of them in ONE (B, gamma+1) forward and the longest
valid prefix is accepted.  B streams share every forward: each row
keeps its own cache pointer (``forward_with_cache`` takes a per-row
``cache_len``), so rows accept different prefix lengths per round.
Rejecting tokens only moves a row's pointer back: their K/V stay in the
cache, masked by position until a later round overwrites them.

Draft steps are S = 1 forwards, so with ``cfg.use_flash`` each draft
layer launches the flash-decode kernel; the verify forward (S =
gamma+1) takes ``_cached_attention``, as the JAX package does.

Greedy mode reproduces the target's own greedy decode (the fp32 tests
hold it to :func:`~.generate.generate`), with the batched-vs-stepwise
caveat: the verify scores gamma+1 positions in one forward where
``generate`` decodes one at a time, so a near-tied top-2 logit can
round differently.  Sampled mode is the modified rejection scheme per
row: accept d_i with probability ``min(1, p_t(d_i) / p_d(d_i))``; at
the first rejection resample from ``normalize(max(0, p_t - p_d))``;
if all gamma survive, sample the bonus token from p_t.  Its draws come
from a ``torch.Generator`` (the JAX package uses ``jax.random``, so
sampled tokens match it in distribution, not draw for draw).
"""

from __future__ import annotations

import torch

from .generate import (_check_sampling, _decode_mesh, _dp_rows, _sample,
                       _token_blocks,
                       forward_with_cache, init_kv_cache, truncate_logits)
from .transformer import TransformerConfig, _as_tokens


def _first_false(ok):
    """Index of the first False of each row of ``ok`` (B, g), or g when
    every entry is True (``argmin`` over ``[ok, False]``; torch's
    ``argmin`` takes no bool, its ``argmax`` returns the first
    maximum)."""
    stop = torch.cat([~ok, torch.ones_like(ok[:, :1])], dim=1)
    return stop.to(torch.int32).argmax(dim=1)


def _accept(drafts, draft_logits, verify_logits, temperature: float,
            generator=None, top_k: int | None = None,
            top_p: float | None = None):
    """The acceptance rule of one round for B rows at once
    (``speculative.py:303``).

    drafts (B, g) proposals; draft_logits (B, g, V) the draft's logits
    at each proposal; verify_logits (B, g+1, V) the target's at
    [newest, d_1..d_g] — position i scores d_{i+1}.  Returns (n_acc (B,)
    in [0, g], next token (B,)).  Both distributions are truncated with
    the same ``top_k``/``top_p``, so the output distribution is the
    truncated target's.  Everything stays on the device."""
    B, g = drafts.shape
    rows = torch.arange(B, device=drafts.device)
    if temperature == 0.0:
        tgt = torch.argmax(verify_logits, dim=-1)             # (B, g+1)
        n_acc = _first_false(tgt[:, :g] == drafts)
        return n_acc, tgt[rows, n_acc]
    pt = torch.softmax(truncate_logits(verify_logits / temperature, top_k,
                                       top_p), dim=-1)         # (B, g+1, V)
    pd = torch.softmax(truncate_logits(draft_logits / temperature, top_k,
                                       top_p), dim=-1)         # (B, g, V)
    pt_i = pt[:, :g].gather(-1, drafts[..., None])[..., 0]
    pd_i = pd.gather(-1, drafts[..., None])[..., 0]
    u = torch.rand((B, g), generator=generator, device=drafts.device)
    ok = u < torch.clamp(pt_i / torch.clamp(pd_i, min=1e-20), max=1.0)
    n_acc = _first_false(ok)
    # The residual at the rejection position; at the bonus position
    # (all accepted) it is p_t itself.
    pt_at = pt[rows, n_acc]
    pd_at = torch.where((n_acc < g)[:, None],
                        pd[rows, torch.clamp(n_acc, max=g - 1)], 0.0)
    resid = torch.clamp(pt_at - pd_at, min=0.0)
    total = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(total > 0, resid, pt_at)   # rounding left nothing
    # Inverse-CDF draw: multinomial would refuse a row whose mass
    # rounded to zero, and checking that would read it on the host.
    cdf = torch.cumsum(resid, dim=-1)
    u2 = torch.rand((B, 1), generator=generator, device=drafts.device)
    nxt = torch.searchsorted(cdf, u2 * cdf[:, -1:])[:, 0]
    return n_acc, torch.clamp(nxt, max=resid.shape[-1] - 1)


@torch.no_grad()
def spec_round(params, draft_params, cfg, draft_cfg, *, gamma: int,
               temperature: float, cache_t, len_t, cache_d, len_d,
               last_tok, active, generator=None,
               top_k: int | None = None, top_p: float | None = None,
               mesh=None, ep_axis: str = "ep", token_blocks: int = 1):
    """ONE draft-propose / target-verify round for B streams
    (``speculative.py:69``), shared by :func:`speculative_generate` and
    the server's speculative mode.  Both caches are written in place.

    The lag-one discipline: both caches hold exactly the committed
    tokens' K/V below their pointers, and ``last_tok`` is the newest
    committed token, not yet written to either — each model re-feeds
    it first, which is why both pointers advance by ``n_acc + 1``.

    Returns ``(len_t, len_d, cand, n_acc, new_last)``: ``cand`` (B,
    gamma+1) holds each row's accepted prefix and the correction/bonus
    token at index ``n_acc`` (later entries stale); rows with
    ``active`` False keep their pointers and last token.  ``mesh``,
    ``token_blocks``: the rows and caches are this rank's
    (:func:`.generate.forward_with_cache`)."""
    fwd = dict(row_mask=active, mesh=mesh, ep_axis=ep_axis,
               token_blocks=token_blocks)
    tok, lens, drafts, dlogits = last_tok, len_d, [], []
    for _ in range(gamma):
        lg, _ = forward_with_cache(draft_params, tok[:, None], cache_d, lens,
                                   draft_cfg, **fwd)
        tok = _sample(lg[:, -1], temperature, generator, top_k, top_p)
        drafts.append(tok)
        dlogits.append(lg[:, -1])
        lens = lens + 1
    drafts = torch.stack(drafts, dim=1)                        # (B, g)
    # The loop wrote K/V for [newest, d_1..d_{g-1}]; d_g's is still
    # missing, and a round that accepts all g needs it (the pointer then
    # moves past its slot).  One more draft write, logits unused.
    forward_with_cache(draft_params, drafts[:, -1:], cache_d, lens,
                       draft_cfg, **fwd)
    verify_in = torch.cat([last_tok[:, None], drafts], dim=1)  # (B, g+1)
    logits_v, _ = forward_with_cache(params, verify_in, cache_t, len_t, cfg,
                                     **fwd)
    n_acc, next_tok = _accept(drafts, torch.stack(dlogits, dim=1), logits_v,
                              temperature, generator, top_k, top_p)
    B = last_tok.shape[0]
    cand = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    cand[torch.arange(B, device=cand.device), n_acc] = next_tok
    adv = torch.where(active, n_acc + 1, 0)
    new_last = torch.where(active, next_tok, last_tok)
    return len_t + adv, len_d + adv, cand, n_acc, new_last


@torch.no_grad()
def speculative_generate(params: dict, draft_params: dict, prompt,
                         cfg: TransformerConfig,
                         draft_cfg: TransformerConfig,
                         max_new_tokens: int, *, gamma: int = 4,
                         temperature: float = 0.0,
                         generator: torch.Generator | None = None,
                         top_k: int | None = None,
                         top_p: float | None = None,
                         max_len: int | None = None,
                         kv_quantized: bool = False, mesh=None,
                         ep_axis: str = "ep"):
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, S0)
    with draft-proposed, target-verified decoding
    (``speculative.py:143``), on the parameters' device.

    Returns (tokens (B, S0 + max_new_tokens), mean_accepted): the second
    is the mean number of draft tokens accepted per round per active
    stream (at most ``gamma``).  Each round ends in one host read (have
    all streams finished?).  With ``mesh``, every rank passes the whole
    prompt and gets the whole result: each runs its ``dp`` rows against
    its cache shards, the round loop runs until every rank's rows are
    done, and the rows are gathered over ``dp`` at the end.  Axes that
    do not divide are held whole (``generate._decode_mesh``)."""
    device = params["embed"].device
    prompt = _as_tokens(prompt, device)
    if prompt.ndim != 2 or prompt.shape[0] < 1:
        raise ValueError(f"need at least one stream, got prompt shape "
                         f"{tuple(prompt.shape)}")
    B, S0 = prompt.shape
    if S0 == 0:
        raise ValueError("cannot generate from an empty prompt (S == 0)")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    if temperature != 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a "
                         "torch.Generator")
    _check_sampling(cfg, top_k, top_p)
    # The token buffer holds one whole extra round (gamma + 1): a final
    # round may write past the target count.
    buf_len = S0 + max_new_tokens + gamma + 1
    T = max_len if max_len is not None else buf_len
    if T < buf_len:
        raise ValueError(f"max_len {T} < required {buf_len} "
                         f"(prompt + max_new_tokens + gamma + 1)")
    fwd = dict(mesh=None, ep_axis=ep_axis)
    if mesh is not None:
        full, mesh = mesh, _decode_mesh(mesh, B, T)
        fwd = dict(mesh=mesh, ep_axis=ep_axis,
                   token_blocks=_token_blocks(full, mesh))
    cache_t = init_kv_cache(cfg, B, T, quantized=kv_quantized, device=device,
                            mesh=mesh)
    cache_d = init_kv_cache(draft_cfg, B, T, quantized=kv_quantized,
                            device=device, mesh=mesh)
    if mesh is not None:
        prompt = _dp_rows(prompt, mesh)
        B = prompt.shape[0]
    logits_t, _ = forward_with_cache(params, prompt, cache_t, 0, cfg,
                                     last_only=True, **fwd)
    forward_with_cache(draft_params, prompt, cache_d, 0, draft_cfg,
                       last_only=True, **fwd)
    first = _sample(logits_t[:, -1], temperature, generator, top_k, top_p)

    toks = torch.zeros((B, buf_len), dtype=torch.long, device=device)
    toks[:, :S0] = prompt
    toks[:, S0] = first
    n = torch.ones(B, dtype=torch.long, device=device)     # generated
    len_t = torch.full((B,), S0, dtype=torch.long, device=device)
    len_d = len_t.clone()
    last = first
    acc_sum = torch.zeros((), dtype=torch.float32, device=device)
    rounds = torch.zeros((), dtype=torch.float32, device=device)
    slot = torch.arange(gamma + 1, device=device)
    while _any_rank(n < max_new_tokens, mesh):
        active = n < max_new_tokens
        len_t, len_d, cand, n_acc, last = spec_round(
            params, draft_params, cfg, draft_cfg, gamma=gamma,
            temperature=temperature, cache_t=cache_t, len_t=len_t,
            cache_d=cache_d, len_d=len_d, last_tok=last, active=active,
            generator=generator, top_k=top_k, top_p=top_p, **fwd)
        # Commit every candidate slot of an active row; only the first
        # n_acc + 1 are real, and a later round overwrites the rest
        # before the counter reaches them.  Finished rows write nothing.
        idx = torch.clamp((S0 + n)[:, None] + slot, max=buf_len - 1)
        keep = toks.gather(1, idx)
        toks.scatter_(1, idx, torch.where(active[:, None], cand, keep))
        n = n + torch.where(active, n_acc + 1, 0)
        acc_sum += torch.where(active, n_acc.float(), 0.0).sum()
        rounds += active.float().sum()
    if mesh is not None:
        acc_sum, rounds = mesh.psum(torch.stack([acc_sum, rounds]), "dp")
        toks = mesh.all_gather(toks, "dp")
    mean_acc = float(acc_sum / torch.clamp(rounds, min=1.0))
    return toks[:, :S0 + max_new_tokens], mean_acc


def _any_rank(flags, mesh) -> bool:
    """Whether any row of any ``dp`` rank is still set: every rank must
    run the same number of rounds, or their collectives part ways."""
    flag = flags.any()
    if mesh is not None:
        flag = mesh.pmax(flag.to(torch.int32)[None], "dp")[0]
    return bool(flag)
