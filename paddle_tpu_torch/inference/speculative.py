"""Drafters for speculative decoding in the continuous serving engine
(port of ``paddle_tpu/inference/speculative.py``).

A drafter proposes up to ``k`` next tokens of a sequence from its token
history alone. The engine verifies the proposal in one ragged forward,
as a decode span of ``1 + k`` tokens over the paged cache (the shape a
chunked-prefill span already has), and keeps the longest prefix that
matches the target model's own choices, plus the token after it. Greedy
acceptance makes the output the target's greedy stream whatever the
drafter proposes: a bad drafter costs speed, never text.

* :class:`NGramDrafter`: prompt lookup. The continuation of the most
  recent earlier occurrence of the history's trailing n-gram, backing
  off from ``max_ngram`` to 1. No weights, no forwards.
* :class:`DraftModelDrafter`: a small causal LM sharing the target's
  vocabulary decodes ``k`` tokens greedily on the history's trailing
  ``window`` tokens, without a cache. The target model itself gives
  self-speculation (acceptance near 1), which exercises the verify path
  end to end.

Unlike the reference, no environment variable picks a drafter or its
settings: they are arguments of :func:`make_drafter` and the engine.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["NGramDrafter", "DraftModelDrafter", "make_drafter",
           "DEFAULT_SPEC_K", "DEFAULT_SPEC_NGRAM"]

#: drafted tokens a decode slot may take a tick
DEFAULT_SPEC_K = 4

#: the longest trailing n-gram the lookup drafter matches before backing
#: off to shorter ones
DEFAULT_SPEC_NGRAM = 3


class NGramDrafter:
    """Prompt-lookup drafter: the continuation of the most recent earlier
    occurrence of the history's trailing n-gram, for n from ``max_ngram``
    down to 1. An empty proposal when nothing matches: the engine then
    decodes that sequence's one token alone."""

    def __init__(self, max_ngram=DEFAULT_SPEC_NGRAM):
        self.max_ngram = max(int(max_ngram), 1)

    def propose(self, history, k):
        h = np.asarray(history).reshape(-1)
        n_hist = h.shape[0]
        k = int(k)
        if k <= 0 or n_hist < 2:
            return []
        for n in range(min(self.max_ngram, n_hist - 1), 0, -1):
            pat = h[n_hist - n:]
            # match ends (exclusive) in [n, n_hist - 1]: the trailing
            # occurrence itself is left out, the most recent comes last
            windows = np.lib.stride_tricks.sliding_window_view(
                h[:n_hist - 1], n)
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n
            out = h[start:start + k]
            if out.size:
                return [int(t) for t in out]
        return []


def _pow2_bucket(n, cap=None):
    """The smallest power of two >= ``n`` (at least 1), at most ``cap``:
    the batched draft forward's shapes, a bounded family."""
    b = 1 << max(int(n) - 1, 0).bit_length()
    if cap is not None:
        b = min(b, int(cap))
    return max(b, 1)


class DraftModelDrafter:
    """A small causal LM (the target's vocabulary) greedily decodes the
    proposal, without a cache, on the trailing ``window`` tokens of the
    history: a drafter needs recency, and the window bounds its cost.

    :meth:`propose_batch` drafts for every decode slot with one padded
    forward a draft step: rows right-padded to a power-of-two ``(rows,
    width)`` bucket (:func:`_pow2_bucket`, the width at most ``window``),
    each row's next token read at its own last position. Causal attention
    hides the padding from every row's own positions, so the proposals are
    :meth:`propose`'s. The argmax runs on the draft model's device; the
    tokens come to the host as ints. ``forwards`` counts draft forwards
    on both paths."""

    def __init__(self, model, window=64):
        if model is None:
            raise ValueError("DraftModelDrafter needs a draft model (the "
                             "engine's draft_model=)")
        self.model = model
        self.window = max(int(window), 1)
        self.forwards = 0

    def _forward(self, batch):
        """Logits of the int64 ``batch [rows, width]`` in eval mode, no
        autograd, counted in ``forwards``."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                logits = self.model.forward(batch)
        finally:
            if was_training:
                self.model.train()
        self.forwards += 1
        return logits

    def propose(self, history, k):
        h = np.asarray(history).reshape(-1)
        k = int(k)
        if k <= 0 or h.size == 0:
            return []
        ids = h[-self.window:].astype(np.int64)
        out = []
        for _ in range(k):
            logits = self._forward(ids[None])
            nxt = int(logits[0, -1].argmax())
            out.append(nxt)
            ids = np.concatenate([ids, [nxt]])[-self.window:]
        return out

    def propose_batch(self, histories, ks):
        """Up to ``ks[i]`` tokens for every ``histories[i]``, one padded
        forward a draft step for the rows still drafting. A row's proposal
        is prefix-stable in its ``k``: a caller may ask for more and
        trim."""
        ks = [int(k) for k in ks]
        rows = [np.asarray(h).reshape(-1)[-self.window:].astype(np.int64)
                for h in histories]
        outs = [[] for _ in rows]
        todo = [i for i, (r, k) in enumerate(zip(rows, ks))
                if k > 0 and r.size > 0]
        if not todo:
            return outs
        for step in range(max(ks[i] for i in todo)):
            act = [i for i in todo if ks[i] > step]
            lens = [rows[i].shape[0] for i in act]
            batch = np.zeros((_pow2_bucket(len(act)),
                              _pow2_bucket(max(lens), cap=self.window)),
                             np.int64)
            for r, i in enumerate(act):
                batch[r, :lens[r]] = rows[i]
            logits = self._forward(batch)
            last = logits[torch.arange(len(act), device=logits.device),
                          torch.as_tensor(lens, device=logits.device) - 1]
            for i, nxt in zip(act, last.argmax(-1).tolist()):
                outs[i].append(int(nxt))
                rows[i] = np.concatenate([rows[i], [nxt]])[-self.window:]
        return outs


def make_drafter(kind=None, draft_model=None, max_ngram=DEFAULT_SPEC_NGRAM,
                 window=64):
    """The engine's drafter: ``kind`` ``"ngram"`` or ``"model"`` (which
    needs ``draft_model``); ``None`` means ``"model"`` when a draft model
    is given, else ``"ngram"``. A drafter passed to the engine as
    ``drafter=`` bypasses this."""
    if kind is None:
        kind = "model" if draft_model is not None else "ngram"
    kind = str(kind).lower()
    if kind == "ngram":
        return NGramDrafter(max_ngram=max_ngram)
    if kind == "model":
        return DraftModelDrafter(draft_model, window=window)
    raise ValueError(f"unknown drafter kind {kind!r} (expected 'ngram' or "
                     f"'model')")
