"""Speculative multi-token decoding: the drafters (the port's copy of
``repro.runtime.speculate``).

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

The policy — how deep to speculate, and with which drafter — is a
tunable like the kernels' launch parameters: :class:`SpecDepthTunable`
(``serve.spec_depth``) prices the depth × drafter lattice with a modeled
acceptance-rate curve against verify FLOPs and KV traffic (the
reference's model, against the port's platform constants), and defends
the pick with real :class:`~repro_torch.runtime.serve.Server` drains
through ``timed_server_drain`` under ``engine="measure"``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (Any, ClassVar, Mapping, Protocol, Sequence,
                    runtime_checkable)

import torch

from ..calibrate.spec import get_platform_spec
from ..core.search_space import Param, SearchSpace
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


# ---------------------------------------------------------------------------
# speculation-policy tuning (repro_torch.tune)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpecDepthTunable:
    """``repro_torch.tune`` Tunable: the speculation policy —
    ``Server(speculate=<drafter>, spec_depth=<depth>)``.

    Depth trades **expected tokens per tick** against **verify cost**:
    with per-token acceptance probability ``a``, a depth-``d`` draft
    yields ``1 + a + a² + ... + a^d`` expected tokens per tick (the
    bonus token is free), saturating at ``1 + a/(1-a)`` — while the
    verify+commit forward pays FLOPs and KV-scatter traffic linear in
    ``d+1`` every tick, and a draft-model drafter adds ``d`` draft
    forwards on top.  The optimum is interior and depends on the
    drafter's acceptance curve, which only a real drain can settle:
    ``cost()`` models the drain in microseconds from ``accept_ngram`` /
    ``accept_draft``; with ``api``/``params`` attached, ``measure(cfg)``
    drains a real mixed workload through ``timed_server_drain`` and the
    measure engine returns the measured winner.  The last measured
    drain's :meth:`Server.stats` snapshot (real proposed/accepted
    counts) lands in :attr:`last_stats` for provenance."""

    param_bytes: int
    layers: int
    d_model: int
    kv_width: int               # GQA cache width, n_kv_heads * hd
    context: int
    prompt_len: int
    requests: int
    mean_new: int
    batch: int = 4
    max_depth: int = 8
    drafters: tuple[str, ...] = DRAFTER_KINDS
    accept_ngram: float = 0.4   # modeled per-token acceptance rates
    accept_draft: float = 0.8
    draft_cost_ratio: float = 0.15  # draft forward cost vs target forward
    dispatch_s: float = 50e-6
    # hardware-in-the-loop handles: excluded from identity/caching
    api: Any = field(default=None, repr=False, compare=False)
    params: Any = field(default=None, repr=False, compare=False)
    draft_api: Any = field(default=None, repr=False, compare=False)
    draft_params: Any = field(default=None, repr=False, compare=False)
    name: ClassVar[str] = "serve.spec_depth"

    def __post_init__(self):
        # plan specs deliver JSON lists; the fingerprint and lattice
        # want a hashable tuple
        object.__setattr__(self, "drafters", tuple(self.drafters))
        unknown = [d for d in self.drafters if d not in DRAFTER_KINDS]
        if unknown or not self.drafters:
            raise ValueError(f"drafters must be drawn from "
                             f"{DRAFTER_KINDS}, got {self.drafters}")

    def space(self) -> SearchSpace:
        depths = []
        d = 1
        while d <= self.max_depth:
            depths.append(d)
            d *= 2
        return SearchSpace(params=[Param("depth", tuple(depths)),
                                   Param("drafter", tuple(self.drafters))])

    def _accept(self, drafter: str) -> float:
        return {"ngram": self.accept_ngram,
                "draft": self.accept_draft}[drafter]

    def tokens_per_tick(self, cfg: Mapping[str, Any]) -> float:
        """Modeled expected tokens per decode tick: the accepted-prefix
        geometric series plus the verifier's bonus token."""

        a = self._accept(str(cfg["drafter"]))
        d = int(cfg["depth"])
        return 1.0 + sum(a ** i for i in range(1, d + 1))

    def cost(self, cfg: Mapping[str, Any]) -> float:
        """Modeled microseconds to drain the load (same unit as
        ``measure``): decode ticks shrink by the expected tokens/tick,
        but each tick now runs TWO chunk forwards (score + commit, each
        streaming the weights once) over ``depth+1`` tokens, plus the
        drafter's own cost — ``d`` scaled-down forwards for a draft
        model, ~nothing for n-gram lookup."""

        d = int(cfg["depth"])
        drafter = str(cfg["drafter"])
        platform = get_platform_spec()
        n_params = self.param_bytes / 2            # bf16 weights
        weight_s = self.param_bytes / platform.hbm_bw
        from .tunables import kv_cache_stream_s
        kv_s = kv_cache_stream_s(self.batch, self.layers, self.context,
                                 self.kv_width)
        flops_s = (2 * n_params * (d + 1) * self.batch
                   / platform.peak_flops)
        spec_tick_s = 2 * (weight_s + flops_s) + kv_s + self.dispatch_s
        if drafter == "draft":
            draft_fwd_s = self.draft_cost_ratio * (
                weight_s
                + 2 * n_params * self.batch / platform.peak_flops)
            spec_tick_s += d * draft_fwd_s
        prefill_tick_s = (weight_s + kv_s + self.dispatch_s
                          + 2 * n_params * self.batch
                          / platform.peak_flops)
        decode_ticks = self.mean_new / self.tokens_per_tick(cfg)
        prefill_ticks = -(-self.prompt_len // 32)
        waves = -(-self.requests // self.batch)
        return waves * (prefill_ticks * prefill_tick_s
                        + decode_ticks * spec_tick_s) * 1e6

    def _build_drafter(self, drafter: str):
        if drafter == "draft":
            return make_drafter("draft", api=self.draft_api or self.api,
                                params=(self.draft_params
                                        if self.draft_api is not None
                                        else self.params))
        return make_drafter(drafter)

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 1) -> float:
        """Measured microseconds to drain the mixed workload through a
        real speculating :class:`~repro_torch.runtime.serve.Server` at this
        depth/drafter.  Prompts cycle a short pattern so the n-gram
        drafter sees the lookup structure real repetitive traffic has."""

        from .tunables import _require_model, timed_server_drain
        _require_model(self, "choose_spec_depth(..., params=...)")
        vocab = self.api.cfg.vocab
        period = 4
        prompts = [[(r + i % period) % (vocab - 1) + 1
                    for i in range(self.prompt_len)]
                   for r in range(self.requests)]
        stats: dict[str, float] = {}
        t = timed_server_drain(
            self.api, self.params, batch=self.batch, context=self.context,
            prompts=prompts, max_new=self.mean_new,
            speculate=self._build_drafter(str(cfg["drafter"])),
            spec_depth=int(cfg["depth"]), warmup=warmup, iters=iters,
            stats_out=stats)
        object.__setattr__(self, "last_stats", stats)
        return t

    def fingerprint(self) -> dict[str, Any]:
        fp = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self) if f.compare}
        fp["drafters"] = list(self.drafters)
        return {"tunable": self.name, "unit": "us", **fp}


def spec_depth_tunable(api, *, context: int, prompt_len: int,
                       requests: int, max_new: int, batch: int,
                       max_depth: int = 8, drafters=DRAFTER_KINDS,
                       params=None, draft_api=None,
                       draft_params=None) -> SpecDepthTunable:
    """The speculation-policy tunable for this model + expected load —
    the one place the sizing wiring lives (library ``choose_spec_depth``
    and the ``launch/serve --tune-spec`` CLI both build through
    here)."""

    prompt_len = max(1, min(prompt_len, context - max_new))
    return SpecDepthTunable(param_bytes=api.param_count() * 2,
                            layers=api.cfg.n_layers,
                            d_model=api.cfg.d_model,
                            kv_width=api.cfg.n_kv_heads * api.cfg.hd,
                            context=context, prompt_len=prompt_len,
                            requests=requests, mean_new=max_new,
                            batch=batch, max_depth=max_depth,
                            drafters=tuple(drafters), api=api,
                            params=params, draft_api=draft_api,
                            draft_params=draft_params)


def choose_spec_depth(api, *, context: int, prompt_len: int, requests: int,
                      max_new: int, batch: int, max_depth: int = 8,
                      drafters=DRAFTER_KINDS, cache="default", params=None,
                      draft_api=None, draft_params=None,
                      engine: str = "grid", **tune_kw):
    """Pick ``Server``'s speculation policy via ``repro_torch.tune``; returns
    ``((depth, drafter), TuneResult)``.  ``engine="measure"`` (requires
    ``params``) shortlists policy points through the acceptance-curve
    model, then times real speculating drains and returns the
    measured winner."""

    from ..tune import tune as _tune
    tb = spec_depth_tunable(api, context=context, prompt_len=prompt_len,
                            requests=requests, max_new=max_new, batch=batch,
                            max_depth=max_depth, drafters=drafters,
                            params=params, draft_api=draft_api,
                            draft_params=draft_params)
    res = _tune(tb, engine=engine, cache=cache, **tune_kw)
    return ((int(res.best_config["depth"]),
             str(res.best_config["drafter"])), res)


__all__ = ["DRAFTER_KINDS", "Drafter", "NGramDrafter", "DraftModelDrafter",
           "make_drafter", "SpecDepthTunable", "spec_depth_tunable",
           "choose_spec_depth"]
