"""Speculative multi-token decode inside the serving decode dispatch (port
of picotron_tpu/serve/spec_decode.py).

Self-drafting n-gram speculation (prompt lookup): each slot keeps a small
rolling window of its own recent tokens on the device; per decode
iteration the drafter finds the most recent earlier occurrence of the
trailing bigram inside that window and proposes the `draft_len` tokens
that followed it. One [S, 1 + draft_len] forward pass then plays both
roles at once: it IS the next-token pass the non-speculative step would
have run (column 0 consumes the real last token), and it verifies the
draft columns. The target token is sampled at EVERY position with the
same (request id, token index) keys as the non-speculative path
(`engine._keyed_sample`), and the longest draft prefix whose tokens match
the targets is accepted.

Acceptance only decides HOW MANY of the target-sampled tokens one
iteration emits, never WHICH tokens, so the emitted stream is the
non-speculative one at any temperature, under any accept/reject
pattern, preemption or slot reshuffle (up to the round-off of the wider
forward pass, whose GEMMs have other shapes).

Rejected-draft K/V writes are left in place: the next iteration always
re-writes positions from the first unconfirmed slot before anything
reads them, and the causal mask screens positions beyond the query.
"""

from __future__ import annotations

import numpy as np
import torch

from picotron_tpu_torch.generate import _decode_layers
from picotron_tpu_torch.models.llama import (
    embed, final_hidden, logits_from_hidden,
)
from picotron_tpu_torch.serve.engine import _keyed_sample

NGRAM_K = 2    # trailing gram length the drafter matches on
CTX_W = 32     # per-slot rolling context window the drafter searches

# -1 pads empty context slots; real token ids are >= 0, so padding can
# never match a gram and the drafter falls back to repeat-last-token.
CTX_PAD = -1


def max_draft_len() -> int:
    """Largest draft_len the [CTX_W]-wide context can source a
    continuation for (needs >= 1 candidate gram start)."""
    return CTX_W - NGRAM_K


def context_rows(states, slots, num_slots: int) -> np.ndarray:
    """Host-side [num_slots, CTX_W] int64 context for the drafter: per
    live slot, the last CTX_W tokens of prompt + generated, left-padded
    with CTX_PAD."""
    ctx = np.full((num_slots, CTX_W), CTX_PAD, np.int64)
    for s in slots:
        st = states[s]
        tail = (list(st.req.prompt) + list(st.generated))[-CTX_W:]
        if tail:
            ctx[s, -len(tail):] = tail
    return ctx


def _ngram_draft(ctx, last_tok, draft_len: int):
    """[S, draft_len] draft per slot by prompt lookup: match the trailing
    NGRAM_K-gram of ctx (newest token = last column) against every
    earlier window, take the LAST (most recent) match, and propose the
    tokens that followed it. Slots with no match repeat their last
    token."""
    s, w = ctx.shape
    dev = ctx.device
    tail = ctx[:, w - NGRAM_K:]                               # [S, k]
    starts = torch.arange(w - NGRAM_K - draft_len + 1, device=dev)
    gram_idx = starts[:, None] + torch.arange(NGRAM_K, device=dev)[None, :]
    grams = ctx[:, gram_idx]                                  # [S, n, k]
    ok = ((grams >= 0).all(-1)
          & (grams == tail[:, None, :]).all(-1))              # [S, n]
    has = ok.any(-1)
    best = torch.where(ok, starts + 1, 0).argmax(dim=-1)
    cont = (best[:, None] + NGRAM_K
            + torch.arange(draft_len, device=dev)[None, :])
    draft = torch.gather(ctx, 1, cont)
    return torch.where(has[:, None], draft, last_tok[:, None])


@torch.no_grad()
def _spec_decode_step_impl(model, cache, toks, positions, rids, tidx, ctx,
                           seed: int, cos, sin, *, temperature: float,
                           top_k: int, interval: int, eos_token_id,
                           draft_len: int):
    """`interval` speculative decode iterations over all slots in one
    dispatch: engine._decode_step_impl's inputs plus ctx [S, CTX_W] (the
    drafter's window). Each iteration emits 1 to 1 + draft_len tokens per
    slot, so tokens come back as [S, interval, 1 + draft_len] with a
    per-iteration valid count [S, interval] (columns past the count are
    padding the host skips). Returns (tokens, n_valid, last, positions,
    tidx, ctx), all on the device."""
    dev = toks.device
    live = positions >= 0
    offs = torch.arange(draft_len + 1, device=dev)[None, :]   # [1, 1+d]
    win = torch.arange(ctx.shape[1], device=dev)[None, :]
    done = torch.zeros_like(live)
    toks_all, n_all = [], []
    for _ in range(interval):
        draft = _ngram_draft(ctx, toks, draft_len)            # [S, d]
        seq = torch.cat([toks[:, None], draft], dim=1)        # [S, 1+d]
        pos = torch.where(live[:, None], positions[:, None] + offs, -1)
        x = _decode_layers(model, embed(model, seq), cache, pos, cos, sin)
        logits = logits_from_hidden(model, final_hidden(model, x)).float()
        # column j's token, if emitted, is output token tidx + j: key it
        # exactly as the non-speculative step would
        tgt = _keyed_sample(logits, temperature, top_k, seed,
                            rids[:, None], tidx[:, None] + offs)
        if eos_token_id is not None:
            tgt = torch.where(done[:, None], eos_token_id, tgt)
        # draft column j (= seq column j+1) is confirmed iff it equals the
        # target sampled after consuming seq[:, :j+1]
        acc = torch.cumprod((seq[:, 1:] == tgt[:, :draft_len]).long(), 1)
        n_acc = acc.sum(dim=1)
        n_emit = n_acc + 1
        if eos_token_id is not None:
            # an EOS inside the emitted window finishes the slot
            emitted = offs < n_emit[:, None]
            done = done | ((tgt == eos_token_id) & emitted).any(dim=1)
        toks = torch.gather(tgt, 1, n_acc[:, None])[:, 0]
        step = torch.where(live, n_emit, 0)
        positions = positions + step
        tidx = tidx + step
        # roll the drafter window: drop `step` oldest, append the emitted
        # targets (columns >= n_emit never enter)
        ctx = torch.gather(torch.cat([ctx, tgt], dim=1), 1,
                           step[:, None] + win)
        toks_all.append(tgt)
        n_all.append(step)
    return (torch.stack(toks_all, dim=1), torch.stack(n_all, dim=1), toks,
            positions, tidx, ctx)
