"""Speculative multi-token decoding: the drafters (the port's copy of
``repro.runtime.speculate``, its serving part).

Baseline decode advances one greedy token per engine tick per slot:
every generated token pays a full weight stream.  Speculative decoding
drafts ``depth`` candidate tokens cheaply, then scores all ``depth+1``
positions in ONE verify forward against the paged or contiguous KV
cache (:meth:`repro_torch.models.api.ModelAPI.verify_step`, the chunked
prefill machinery reused as a verifier) and accepts the longest prefix
of drafts that matches the model's own greedy choices, plus the bonus
token the verifier produces after it.  Greedy accept-longest-prefix
keeps the output token for token that of tick-by-tick decode:
speculation changes the *schedule*, never the text.
:class:`~repro_torch.runtime.serve.Server` (``speculate=``,
``spec_depth=``) runs the verify and the commit.

Two drafters ship:

* :class:`NGramDrafter`: self-speculative prompt lookup.  Match the
  longest recent n-gram suffix of the slot's prompt + generated tokens
  against an earlier occurrence and propose its continuation.  No model
  cost; wins on repetitive traffic.
* :class:`DraftModelDrafter`: greedy rollout through a (smaller) draft
  model's full forward.  With the target model as its own drafter
  ("self-draft") acceptance is exact up to rounding: the upper bound
  the parity tests use.

The reference's speculation-policy tunable (``SpecDepthTunable``,
``serve.spec_depth``) is not ported yet (ROADMAP queue 1, item 16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

import torch

from ..models.common import tree_leaves

DRAFTER_KINDS = ("ngram", "draft")


@runtime_checkable
class Drafter(Protocol):
    """Anything that proposes draft tokens for a slot.

    ``propose(tokens, depth)`` receives the slot's full known history
    (prompt + generated so far, INCLUDING the pending last token) and
    returns up to ``depth`` candidate continuations.  Returning fewer,
    or none, is fine: the server verifies whatever arrives, and a slot
    without a draft takes the plain one-token decode."""

    name: str

    def propose(self, tokens: Sequence[int], depth: int) -> list[int]:
        ...


@dataclass
class NGramDrafter:
    """Self-speculative prompt-lookup drafting.

    Match the longest suffix n-gram (``ngram_max`` down to
    ``ngram_min`` tokens) of the history against its most recent
    earlier occurrence and propose the tokens that followed it.  Pure
    host-side list scanning: no model, no device work."""

    ngram_max: int = 3
    ngram_min: int = 1
    name: str = "ngram"

    def propose(self, tokens: Sequence[int], depth: int) -> list[int]:
        toks = list(tokens)
        L = len(toks)
        if depth <= 0 or L < 2:
            return []
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            key = toks[L - n:]
            for i in range(L - n - 1, -1, -1):     # most recent match wins
                if toks[i:i + n] == key:
                    return toks[i + n:i + n + depth]
        return []


class DraftModelDrafter:
    """Greedy rollout through a draft model's full forward pass.

    ``api``/``params`` name the DRAFT model (its vocab must match the
    target's); passing the target model itself gives self-draft.  Each
    forward runs on the params' device.  Sequences are padded right to
    ``bucket`` multiples, as in the reference (causal masking makes the
    padding inert); a multiple of 128 takes the flash kernel's gate in a
    model that routes through it.  Decoder-only LMs only."""

    def __init__(self, api, params, *, bucket: int = 32,
                 name: str = "draft"):
        if api.cfg.is_encdec:
            raise ValueError("DraftModelDrafter needs a decoder-only LM "
                             "draft model (enc-dec forwards need frames)")
        self.api = api
        self.params = params
        self.bucket = max(1, bucket)
        self.name = name
        self.device = next(t for t in tree_leaves(params)
                           if isinstance(t, torch.Tensor)).device

    def propose(self, tokens: Sequence[int], depth: int) -> list[int]:
        toks = list(tokens)
        out: list[int] = []
        for _ in range(max(0, depth)):
            L = len(toks)
            S = -(-L // self.bucket) * self.bucket
            buf = torch.tensor([toks + [0] * (S - L)], dtype=torch.int32,
                               device=self.device)
            logits = self.api.forward(self.params, {"tokens": buf})
            nxt = int(torch.argmax(logits[0, L - 1]))
            out.append(nxt)
            toks.append(nxt)
        return out


def make_drafter(kind: "str | Drafter", *, api=None, params=None,
                 **kw) -> Drafter:
    """Resolve a drafter spec: an existing :class:`Drafter` passes
    through; ``"ngram"`` builds the prompt-lookup drafter; ``"draft"``
    builds a :class:`DraftModelDrafter` from ``api``/``params`` (the
    target model itself, from the server: self-draft)."""

    if not isinstance(kind, str):
        if not hasattr(kind, "propose"):
            raise TypeError(f"not a Drafter: {kind!r}")
        return kind
    if kind == "ngram":
        return NGramDrafter(**kw)
    if kind == "draft":
        if api is None or params is None:
            raise ValueError("speculate='draft' needs api=/params= for "
                             "the draft model")
        return DraftModelDrafter(api, params, **kw)
    raise ValueError(f"unknown drafter {kind!r}; known: "
                     f"{', '.join(DRAFTER_KINDS)} or a Drafter instance")


__all__ = ["DRAFTER_KINDS", "Drafter", "NGramDrafter", "DraftModelDrafter",
           "make_drafter"]
