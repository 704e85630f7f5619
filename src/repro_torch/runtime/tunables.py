"""Serving-configuration tunables + their measurement harnesses (the
port's copy of ``repro.runtime.tunables``).

Every serving knob the ``repro_torch.tune`` registry exposes lives here —
:class:`DecodeBatchTunable` (``serve.decode_batch``),
:class:`PrefillChunkTunable` (``serve.prefill_chunk``),
:class:`KVPageTunable` (``serve.kv_page``), and the policy-level
:class:`SchedulerTunable` (``serve.scheduler``) — together with the two
harnesses their ``measure(cfg)`` implementations drain through:
:func:`timed_server_drain` (a fixed prompt list) and
:func:`timed_trace_drain` (a seeded :mod:`~repro_torch.runtime.workload`
trace).  :class:`~repro_torch.runtime.speculate.SpecDepthTunable` stays
next to its drafters but measures through the same harness.

The cost models, fields and fingerprints are the reference's, so under
the same platform constants every ``cost(cfg)``, lattice and pick is
the reference's too; ``measure(cfg)`` drains the port's
:class:`~repro_torch.runtime.serve.Server` on the device its parameters
live on, and (here in every tunable, not only in the scheduler's and
the speculation policy's) leaves the last drain's engine counters in
``last_stats``.  ``repro_torch.runtime.serve`` re-exports every public name;
the :class:`~repro_torch.runtime.serve.Server` import is deferred to
call time to keep that re-export acyclic.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, ClassVar, Mapping

import torch

from ..calibrate.spec import get_platform_spec
from ..core.search_space import Param, SearchSpace
from ..models.common import tree_leaves

KV_CACHE_BYTES = 2          # bf16 cache entries
K_AND_V = 2                 # two tensors per layer

# Every cost() below prices bytes and FLOPs against the ACTIVE platform
# spec (repro_torch.calibrate) — the H100 data-sheet defaults until a
# calibration artifact exists.  The per-tunable dispatch_s fields stay
# explicit knobs (and part of the cache fingerprint), as the reference
# keeps them; so do param_bytes = 2 bytes a parameter and
# SchedulerTunable's fixed 50e-6 s a tick: the port's costs equal the
# reference's under the same spec, and changing the model is
# calibration's work.


def _params_device(params):
    """The device of the first tensor in ``params`` (``None``, the card,
    when it holds none): the drain harnesses time on the device the
    ``Server`` runs on."""

    leaf = next((t for t in tree_leaves(params)
                 if isinstance(t, torch.Tensor)), None)
    return None if leaf is None else leaf.device


def publish_drain_stats(registry, stats: Mapping[str, float], *,
                        prefix: str = "serve") -> None:
    """Publish a drain's scalar counters into a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` as ``prefix.``-dotted
    gauges (gauges, not counters: the values are per-drain snapshots,
    not monotone accumulations across drains)."""

    for key, value in stats.items():
        if isinstance(value, (int, float)):
            registry.gauge(f"{prefix}.{key}").set(float(value))


def timed_server_drain(api, params, *, batch: int, context: int,
                       prompts, max_new: int, prefill_chunk: int = 32,
                       paged: bool = False, page_size: int = 16,
                       kv_pages: int | None = None, speculate: Any = None,
                       spec_depth: int = 4, registry: Any = None,
                       stats_out: dict | None = None, warmup: int = 1,
                       iters: int = 1) -> float:
    """Median microseconds to drain ``prompts`` (a list of token lists)
    through a fresh :class:`~repro_torch.runtime.serve.Server` — the one
    measurement harness behind every serving tunable's ``measure(cfg)``
    (:class:`DecodeBatchTunable`, :class:`PrefillChunkTunable`,
    :class:`KVPageTunable`,
    :class:`~repro_torch.runtime.speculate.SpecDepthTunable`).  Warmup
    drains absorb the first calls' set-up for the batch/chunk shape.
    ``speculate``/``spec_depth`` pass through to ``Server``.

    Timed by :func:`repro_torch.kernels.common.time_fn` on the device of
    ``params``: on a card a pair of CUDA events brackets each drain.  A
    drain is host-bound and synchronises on every token it reads back,
    so the pair spans the whole drain, host time included; on the CPU
    the host clock times it.  ``params`` holding no tensor means the
    card, which raises without one.

    The last drain's ``Server.stats`` snapshot is published into
    ``registry`` (a :class:`~repro_torch.obs.metrics.MetricsRegistry`)
    as ``serve.``-prefixed gauges; ``stats_out`` (a dict) is rebuilt
    FROM the registry, so both views carry identical keys and values."""

    from ..kernels.common import time_fn
    from ..obs.metrics import MetricsRegistry
    from .serve import Server
    device = _params_device(params)
    prompts = [list(p) for p in prompts]
    reg = registry if registry is not None else MetricsRegistry()

    def drain() -> None:
        with torch.inference_mode():
            srv = Server(api, params, batch=batch, context=context,
                         prefill_chunk=prefill_chunk, paged=paged,
                         page_size=page_size, kv_pages=kv_pages,
                         speculate=speculate, spec_depth=spec_depth)
            for prompt in prompts:
                srv.submit(prompt, max_new=max_new)
            srv.run_until_drained()
        publish_drain_stats(reg, srv.stats(), prefix="serve")
        if stats_out is not None:
            stats_out.clear()
            stats_out.update(reg.collect("serve"))

    return time_fn(drain, device=device, warmup=warmup, iters=iters)


def timed_trace_drain(api, params, trace, *, batch: int, context: int,
                      prefill_chunk: int = 32, paged: bool = True,
                      page_size: int = 16, kv_pages: int | None = None,
                      scheduler: Any = None, share_prefix: bool = False,
                      obs: Any = None, registry: Any = None,
                      stats_out: dict | None = None, warmup: int = 1,
                      iters: int = 1) -> float:
    """Median microseconds to drain a
    :mod:`~repro_torch.runtime.workload` trace through a fresh
    :class:`~repro_torch.runtime.serve.Server` under ``scheduler`` — the
    harness behind :class:`SchedulerTunable.measure`.  The trace is
    pre-generated (seeded), so every policy drains the identical arrival
    sequence.  Timed as :func:`timed_server_drain` times: CUDA events on
    the card, spanning the whole host-bound drain.

    The last drain's :func:`~repro_torch.runtime.workload.summarize`
    record and selected engine counters are published into ``registry``
    as ``traffic.``-prefixed gauges; ``stats_out`` is rebuilt FROM the
    registry (plus the non-scalar ``records`` passthrough, from which
    callers read each request's tokens).  ``obs`` goes to the LAST drain
    only, as in the reference; the port's ``Server`` does not take one
    yet (ROADMAP queue 1, item 20), so passing one raises there."""

    from ..kernels.common import time_fn
    from ..obs.metrics import MetricsRegistry
    from .serve import Server
    from .workload import drive_trace, summarize

    device = _params_device(params)
    reg = registry if registry is not None else MetricsRegistry()
    total = max(0, warmup) + max(1, iters)   # time_fn's call count
    calls = 0

    def drain() -> None:
        nonlocal calls
        calls += 1
        with torch.inference_mode():
            srv = Server(api, params, batch=batch, context=context,
                         prefill_chunk=prefill_chunk, paged=paged,
                         page_size=page_size, kv_pages=kv_pages,
                         scheduler=scheduler, share_prefix=share_prefix,
                         obs=obs if calls == total else None)
            records = drive_trace(srv, trace)
        summary = summarize(records, srv.ticks)
        st = srv.stats()
        for k in ("prefill_chunks", "deferrals", "preemptions",
                  "shared_tokens", "cow_copies", "peak_active",
                  "mean_active"):
            summary[k] = st[k]
        publish_drain_stats(reg, summary, prefix="traffic")
        if stats_out is not None:
            stats_out.clear()
            stats_out.update(reg.collect("traffic"))
            stats_out["records"] = records

    return time_fn(drain, device=device, warmup=warmup, iters=iters)


def _require_model(tunable, helper: str) -> None:
    if tunable.api is None or tunable.params is None:
        raise RuntimeError(
            f"{type(tunable).__name__}.measure needs the model attached: "
            f"construct with api=/params= ({helper})")


def kv_cache_stream_s(batch: int, layers: int, cache_len: int,
                      kv_width: int) -> float:
    """Seconds to stream every slot's KV cache once (one engine tick's
    cache traffic).  GQA caches are ``n_kv_heads * hd`` elements wide —
    modeling them as ``d_model`` overestimated KV reads by the
    ``n_heads / n_kv_heads`` grouping ratio and biased slot-count picks
    low.  Shared by :class:`DecodeBatchTunable` and
    :class:`PrefillChunkTunable`."""

    return (batch * layers * cache_len * kv_width
            * K_AND_V * KV_CACHE_BYTES / get_platform_spec().hbm_bw)


@dataclass(frozen=True)
class DecodeBatchTunable:
    """``repro_torch.tune`` Tunable: the server's slot count.

    Decode is HBM-bound: each engine tick re-streams the weights once
    (amortized over every active slot) and reads each slot's KV cache.
    More slots amortize the weight stream but add KV traffic and admit
    waves of requests; the grid engine picks the drain-time optimum for
    an expected load (request count × mean new tokens).

    With ``api``/``params`` attached (``choose_batch(..., params=...)``)
    the tunable also implements ``measure(cfg)`` — a real
    :class:`~repro_torch.runtime.serve.Server` drain at that slot count — so
    ``engine="measure"`` can refine the modeled pick against a measured
    drain."""

    param_bytes: int
    layers: int
    d_model: int
    context: int
    requests: int
    mean_new: int
    max_batch: int = 64
    dispatch_s: float = 50e-6
    # GQA KV-cache width in elements (n_kv_heads * hd); 0 falls back to
    # d_model (the pre-fix overestimate) for old call sites
    kv_width: int = 0
    # hardware-in-the-loop handles: excluded from identity/caching
    api: Any = field(default=None, repr=False, compare=False)
    params: Any = field(default=None, repr=False, compare=False)
    name: ClassVar[str] = "serve.decode_batch"

    def space(self) -> SearchSpace:
        sizes = []
        b = 1
        while b <= self.max_batch:
            sizes.append(b)
            b *= 2
        return SearchSpace(params=[Param("batch", tuple(sizes))])

    def cost(self, cfg: Mapping[str, Any]) -> float:
        """Modeled microseconds to drain the expected load (same unit
        as ``measure`` so modeled/measured entries are comparable)."""

        b = cfg["batch"]
        weight_s = self.param_bytes / get_platform_spec().hbm_bw
        kv_s = kv_cache_stream_s(b, self.layers, self.context,
                                 self.kv_width or self.d_model)
        tick_s = weight_s + kv_s + self.dispatch_s
        waves = -(-self.requests // b)
        return waves * self.mean_new * tick_s * 1e6

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 1, prompt_len: int = 4) -> float:
        """Measured microseconds to drain the expected load through a
        real :class:`~repro_torch.runtime.serve.Server` at this slot
        count."""

        _require_model(self, "choose_batch(..., params=...)")
        plen = max(1, min(prompt_len, self.context - self.mean_new - 1))
        stats: dict[str, float] = {}
        t = timed_server_drain(
            self.api, self.params, batch=int(cfg["batch"]),
            context=self.context,
            prompts=[range(1, plen + 1)] * self.requests,
            max_new=self.mean_new, warmup=warmup, iters=iters,
            stats_out=stats)
        object.__setattr__(self, "last_stats", stats)
        return t

    def fingerprint(self) -> dict[str, Any]:
        fp = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self) if f.compare}
        # "unit" keys out stale entries from before cost() switched from
        # seconds to microseconds (same fields, 1e6-different meaning)
        return {"tunable": self.name, "unit": "us", **fp}


def decode_batch_tunable(api, *, context: int, requests: int,
                         max_new: int, params=None) -> DecodeBatchTunable:
    """The server-slot tunable for this model + expected load — the one
    place the sizing wiring lives (library ``choose_batch`` and the
    ``launch/serve --tune-batch`` CLI both build through here)."""

    return DecodeBatchTunable(param_bytes=api.param_count() * 2,
                              layers=api.cfg.n_layers,
                              d_model=api.cfg.d_model, context=context,
                              requests=requests, mean_new=max_new,
                              kv_width=api.cfg.n_kv_heads * api.cfg.hd,
                              api=api, params=params)


def choose_batch(api, *, context: int, requests: int,
                 max_new: int, cache="default", params=None,
                 engine: str = "grid", **tune_kw):
    """Pick the slot count for :class:`~repro_torch.runtime.serve.Server` via
    ``repro_torch.tune``; returns ``(batch, TuneResult)``.

    ``engine="measure"`` (requires ``params``) shortlists slot counts
    through the drain-time model, then times real server drains and
    returns the measured winner."""

    from ..tune import tune as _tune
    tb = decode_batch_tunable(api, context=context, requests=requests,
                              max_new=max_new, params=params)
    res = _tune(tb, engine=engine, cache=cache, **tune_kw)
    return int(res.best_config["batch"]), res


@dataclass(frozen=True)
class PrefillChunkTunable:
    """``repro_torch.tune`` Tunable: tokens per chunked-prefill tick
    (``Server(prefill_chunk=...)``).

    Chunked prefill amortizes the per-tick weight stream over ``chunk``
    prompt tokens, so a prompt costs ``ceil(len/chunk)`` ticks instead
    of ``len`` — but each tick spends chunk-linear matmul FLOPs and a
    chunk-quadratic attention-score term, so the optimum is a genuine
    tradeoff, not "as big as possible".  ``cost`` models the drain of
    the expected long-prompt load (``requests`` prompts of
    ``prompt_len`` tokens + ``mean_new`` decode steps each) in
    microseconds; with ``api``/``params`` attached, ``measure(cfg)``
    drains a real :class:`~repro_torch.runtime.serve.Server` at that chunk
    size so ``engine="measure"`` can return the measured winner."""

    param_bytes: int
    layers: int
    d_model: int
    kv_width: int               # GQA cache width, n_kv_heads * hd
    context: int
    prompt_len: int
    requests: int
    mean_new: int
    batch: int = 4
    max_chunk: int = 256
    dispatch_s: float = 50e-6
    # hardware-in-the-loop handles: excluded from identity/caching
    api: Any = field(default=None, repr=False, compare=False)
    params: Any = field(default=None, repr=False, compare=False)
    name: ClassVar[str] = "serve.prefill_chunk"

    def space(self) -> SearchSpace:
        sizes = []
        c = 1
        cap = min(self.max_chunk, self.context)
        while c <= cap:
            sizes.append(c)
            if c >= self.prompt_len:    # larger chunks cannot help
                break
            c *= 2
        return SearchSpace(params=[Param("chunk", tuple(sizes))])

    def cost(self, cfg: Mapping[str, Any]) -> float:
        """Modeled microseconds to drain the load (same unit as
        ``measure``): per prefill tick, one weight stream (amortized
        over the chunk — the term chunking exists to shrink), one KV
        stream (GQA width, shared with :class:`DecodeBatchTunable`),
        chunk-linear matmul FLOPs, and a chunk-quadratic score/HBM term;
        decode ticks follow the decode-batch model."""

        chunk = cfg["chunk"]
        spec = get_platform_spec()
        n_params = self.param_bytes / 2            # bf16 weights
        weight_s = self.param_bytes / spec.hbm_bw
        kv_s = kv_cache_stream_s(self.batch, self.layers, self.context,
                                 self.kv_width)
        flops_s = 2 * n_params * chunk * self.batch / spec.peak_flops
        score_s = (self.batch * self.layers * chunk
                   * (self.context + chunk) * 4 / spec.hbm_bw)
        prefill_tick_s = (weight_s + kv_s + flops_s + score_s
                          + self.dispatch_s)
        decode_tick_s = (weight_s + kv_s
                         + 2 * n_params * self.batch / spec.peak_flops
                         + self.dispatch_s)
        prefill_ticks = -(-self.prompt_len // chunk)
        waves = -(-self.requests // self.batch)
        return waves * (prefill_ticks * prefill_tick_s
                        + self.mean_new * decode_tick_s) * 1e6

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 1) -> float:
        """Wall-clock microseconds to drain the long-prompt load through
        a real :class:`~repro_torch.runtime.serve.Server` at this chunk
        size."""

        _require_model(self, "choose_prefill_chunk(..., params=...)")
        if self.prompt_len > self.context - self.mean_new:
            # silently clamping here would measure a different load than
            # cost() models and the cache fingerprint claims
            raise ValueError(
                f"prompt_len={self.prompt_len} + mean_new={self.mean_new} "
                f"exceeds context={self.context}; size the tunable to the "
                f"load it will actually serve (prefill_chunk_tunable "
                f"clamps for you)")
        vocab = self.api.cfg.vocab
        prompt = [i % (vocab - 1) + 1 for i in range(self.prompt_len)]
        stats: dict[str, float] = {}
        t = timed_server_drain(
            self.api, self.params, batch=self.batch, context=self.context,
            prompts=[prompt] * self.requests, max_new=self.mean_new,
            prefill_chunk=int(cfg["chunk"]), warmup=warmup, iters=iters,
            stats_out=stats)
        object.__setattr__(self, "last_stats", stats)
        return t

    def fingerprint(self) -> dict[str, Any]:
        fp = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self) if f.compare}
        return {"tunable": self.name, "unit": "us", **fp}


def prefill_chunk_tunable(api, *, context: int, prompt_len: int,
                          requests: int, max_new: int, batch: int,
                          max_chunk: int = 256,
                          params=None) -> PrefillChunkTunable:
    """The chunked-prefill tunable for this model + expected load — the
    one place the sizing wiring lives (library ``choose_prefill_chunk``
    and the ``launch/serve --tune-prefill`` CLI both build through
    here)."""

    # clamp UP FRONT so cost(), measure() and the cache fingerprint all
    # describe the same load
    prompt_len = max(1, min(prompt_len, context - max_new))
    return PrefillChunkTunable(param_bytes=api.param_count() * 2,
                               layers=api.cfg.n_layers,
                               d_model=api.cfg.d_model,
                               kv_width=api.cfg.n_kv_heads * api.cfg.hd,
                               context=context, prompt_len=prompt_len,
                               requests=requests, mean_new=max_new,
                               batch=batch, max_chunk=max_chunk,
                               api=api, params=params)


def choose_prefill_chunk(api, *, context: int, prompt_len: int,
                         requests: int, max_new: int, batch: int,
                         cache="default", params=None,
                         engine: str = "grid", **tune_kw):
    """Pick ``Server``'s ``prefill_chunk`` via ``repro_torch.tune``; returns
    ``(chunk, TuneResult)``.  ``engine="measure"`` (requires ``params``)
    shortlists chunk sizes through the drain-time model, then times real
    long-prompt server drains and returns the measured winner."""

    from ..tune import tune as _tune
    tb = prefill_chunk_tunable(api, context=context, prompt_len=prompt_len,
                               requests=requests, max_new=max_new,
                               batch=batch, params=params)
    res = _tune(tb, engine=engine, cache=cache, **tune_kw)
    return int(res.best_config["chunk"]), res


@dataclass(frozen=True)
class KVPageTunable:
    """``repro_torch.tune`` Tunable: the paged KV-cache page size
    (``Server(paged=True, page_size=...)``).

    The page size trades **internal fragmentation** against **gather
    overhead**: every live request strands the unused tail of its last
    page (~``page/2`` tokens expected), shrinking how many requests a
    fixed pool holds concurrently — so big pages mean more drain waves;
    but every attended token is reached through the page table, and
    smaller pages mean more page descriptors per tick.  ``cost`` models
    the drain of a MIXED-length load (``prompt_lens`` cycled over
    ``requests``, ``mean_new`` decode steps each, ``batch`` slots
    sharing ``pool_tokens`` of page capacity) in microseconds; with
    ``api``/``params`` attached, ``measure(cfg)`` drains the same mixed
    load through a real paged :class:`~repro_torch.runtime.serve.Server`."""

    param_bytes: int
    layers: int
    d_model: int
    kv_width: int               # GQA cache width, n_kv_heads * hd
    context: int
    prompt_lens: tuple[int, ...]
    requests: int
    mean_new: int
    batch: int = 4
    pool_tokens: int = 0        # 0 -> batch * context (contiguous parity)
    prefill_chunk: int = 32
    max_page: int = 128
    page_gather_s: float = 2e-6  # per page descriptor chased per tick
    dispatch_s: float = 50e-6
    # hardware-in-the-loop handles: excluded from identity/caching
    api: Any = field(default=None, repr=False, compare=False)
    params: Any = field(default=None, repr=False, compare=False)
    name: ClassVar[str] = "serve.kv_page"

    def __post_init__(self):
        # plan specs deliver JSON lists; the fingerprint and lattice
        # want a hashable tuple
        object.__setattr__(self, "prompt_lens", tuple(self.prompt_lens))
        if not self.prompt_lens:
            raise ValueError("prompt_lens must name at least one length")

    def _pool(self) -> int:
        return self.pool_tokens or self.batch * self.context

    def space(self) -> SearchSpace:
        sizes = []
        ps = 4
        cap = min(self.max_page, self.context)
        while ps <= cap:
            sizes.append(ps)
            ps *= 2
        return SearchSpace(params=[Param("page", tuple(sizes))])

    def cost(self, cfg: Mapping[str, Any]) -> float:
        """Modeled microseconds to drain the mixed load (same unit as
        ``measure``): requests occupy ``ceil(total/page)`` pages each —
        the page-rounding waste caps how many run concurrently in the
        pool — and each tick pays the weight stream, the live-KV
        stream, and one page-table chase per live page."""

        page = cfg["page"]
        totals = [min(L, self.context - self.mean_new) + self.mean_new
                  for L in self.prompt_lens]
        mean_total = sum(totals) / len(totals)
        # page-capacity footprint of one request, fragmentation included
        footprint = sum(-(-t // page) * page for t in totals) / len(totals)
        conc = max(1, min(self.batch, int(self._pool() // footprint)))
        waves = -(-self.requests // conc)
        mean_prompt = mean_total - self.mean_new
        ticks = -(-int(mean_prompt) // self.prefill_chunk) + self.mean_new
        weight_s = self.param_bytes / get_platform_spec().hbm_bw
        kv_s = kv_cache_stream_s(conc, self.layers, int(mean_total),
                                 self.kv_width)
        gather_s = conc * -(-int(mean_total) // page) * self.page_gather_s
        tick_s = weight_s + kv_s + gather_s + self.dispatch_s
        return waves * ticks * tick_s * 1e6

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 1) -> float:
        """Wall-clock microseconds to drain the mixed-length load
        through a real paged :class:`~repro_torch.runtime.serve.Server` at
        this page size."""

        _require_model(self, "choose_kv_page(..., params=...)")
        page = int(cfg["page"])
        vocab = self.api.cfg.vocab
        prompts = []
        for r in range(self.requests):
            plen = min(self.prompt_lens[r % len(self.prompt_lens)],
                       self.context - self.mean_new)
            prompts.append([(r + i) % (vocab - 1) + 1 for i in range(plen)])
        kv_pages = max(self._pool() // page, -(-self.context // page))
        stats: dict[str, float] = {}
        t = timed_server_drain(
            self.api, self.params, batch=self.batch, context=self.context,
            prompts=prompts, max_new=self.mean_new,
            prefill_chunk=self.prefill_chunk, paged=True, page_size=page,
            kv_pages=kv_pages, warmup=warmup, iters=iters, stats_out=stats)
        object.__setattr__(self, "last_stats", stats)
        return t

    def fingerprint(self) -> dict[str, Any]:
        fp = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self) if f.compare}
        fp["prompt_lens"] = list(self.prompt_lens)
        return {"tunable": self.name, "unit": "us", **fp}


def kv_page_tunable(api, *, context: int, prompt_lens,
                    requests: int, max_new: int, batch: int,
                    pool_tokens: int | None = None,
                    params=None) -> KVPageTunable:
    """The page-size tunable for this model + expected mixed-length
    load — the one place the sizing wiring lives (library
    ``choose_kv_page`` and the ``launch/serve --tune-page`` CLI both
    build through here)."""

    prompt_lens = tuple(max(1, min(p, context - max_new))
                        for p in prompt_lens)
    return KVPageTunable(param_bytes=api.param_count() * 2,
                         layers=api.cfg.n_layers, d_model=api.cfg.d_model,
                         kv_width=api.cfg.n_kv_heads * api.cfg.hd,
                         context=context, prompt_lens=prompt_lens,
                         requests=requests, mean_new=max_new, batch=batch,
                         pool_tokens=pool_tokens or 0,
                         api=api, params=params)


def choose_kv_page(api, *, context: int, prompt_lens,
                   requests: int, max_new: int, batch: int,
                   pool_tokens: int | None = None, cache="default",
                   params=None, engine: str = "grid", **tune_kw):
    """Pick ``Server(paged=True)``'s page size via ``repro_torch.tune``;
    returns ``(page, TuneResult)``.  ``engine="measure"`` (requires
    ``params``) shortlists page sizes through the fragmentation/gather
    model, then times real mixed-length paged drains and returns the
    measured winner."""

    from ..tune import tune as _tune
    tb = kv_page_tunable(api, context=context, prompt_lens=prompt_lens,
                         requests=requests, max_new=max_new, batch=batch,
                         pool_tokens=pool_tokens, params=params)
    res = _tune(tb, engine=engine, cache=cache, **tune_kw)
    return int(res.best_config["page"]), res


@dataclass(frozen=True)
class SchedulerTunable:
    """``repro_torch.tune`` Tunable: the serving POLICY —
    ``Server(scheduler=..., share_prefix=...)`` — tuned against a seeded
    traffic trace (:mod:`~repro_torch.runtime.workload`).

    The lattice is ``policy`` (:data:`~repro_torch.runtime.scheduler.\
SCHEDULER_KINDS`: fcfs / prefix / priority — prefix also enables
    copy-on-write prefix sharing) × ``age_limit`` (the starvation
    threshold every policy carries).  The objective is **measured
    microseconds per goodput token** — goodput being deadline-met
    output tokens — so a policy only wins by actually serving the SLO
    mix, not by finishing an unweighted drain fast.

    ``cost(cfg)`` is a small queueing model of the trace distribution:
    burst arrivals queue ``ceil(position/concurrency)`` service rounds
    deep, priority lets interactive requests requeue ahead of batch
    (shrinking their wait to their own class), prefix sharing deletes
    the shared fraction of prefill ticks.  ``measure(cfg)`` is the real
    thing: :func:`timed_trace_drain` over the identical seeded trace.
    Unlike the other serving tunables this one builds its own reduced
    float32 model from ``arch`` on first ``measure`` — a plan-registry
    job (``serve.scheduler``) can therefore run ``engine="measure"`` with
    JSON-only params.  It builds that model on ``device`` (``None``, the
    default, is the card, and raises without one; ``"cpu"`` runs the
    plain versions on the host); ``device`` enters the fingerprint only
    when set, so the card's entries keep the reference's identity."""

    arch: str = "smollm-135m"
    context: int = 64
    batch: int = 4
    page_size: int = 8
    kv_pages: int = 0           # 0 -> full per-slot backing
    prefill_chunk: int = 8
    # trace shape (mirrors workload.TraceConfig)
    requests: int = 12
    arrival: str = "bursty"
    rate: float = 1.0
    burst: int = 4
    burst_every: int = 10
    prompt_len: tuple[int, int] = (6, 20)
    max_new: tuple[int, int] = (4, 8)
    interactive_frac: float = 0.5
    shared_frac: float = 0.5
    prefix_len: int = 12
    seed: int = 0
    # lattice bounds
    policies: tuple[str, ...] = ("fcfs", "prefix", "priority")
    age_limits: tuple[int, ...] = (4, 32)
    device: str | None = None   # where measure() builds its model
    # lazily-built model handles: excluded from identity/caching
    api: Any = field(default=None, repr=False, compare=False)
    params: Any = field(default=None, repr=False, compare=False)
    last_stats: Any = field(default=None, repr=False, compare=False)
    name: ClassVar[str] = "serve.scheduler"

    def __post_init__(self):
        # plan specs deliver JSON lists; the lattice and fingerprint
        # want hashable tuples
        for f in ("prompt_len", "max_new", "policies", "age_limits"):
            object.__setattr__(self, f, tuple(getattr(self, f)))

    def space(self) -> SearchSpace:
        return SearchSpace(params=[Param("policy", self.policies),
                                   Param("age_limit", self.age_limits)])

    def trace_config(self):
        from .workload import TraceConfig
        vocab = 256
        if self.api is not None:
            vocab = self.api.cfg.vocab
        return TraceConfig(
            requests=self.requests, arrival=self.arrival, rate=self.rate,
            burst=self.burst, burst_every=self.burst_every,
            prompt_len=self.prompt_len, max_new=self.max_new,
            interactive_frac=self.interactive_frac,
            shared_frac=self.shared_frac, prefix_len=self.prefix_len,
            vocab=min(vocab, 4096), seed=self.seed)

    # -- modeled objective --------------------------------------------------

    def _trace_moments(self) -> tuple[float, float, float]:
        """(mean prompt, mean new, deadline_interactive) of the trace
        distribution — the shares cost() reasons over."""

        mean_prompt = (sum(self.prompt_len) / 2
                       + self.shared_frac * self.prefix_len)
        mean_new = sum(self.max_new) / 2
        from .workload import TraceConfig
        dl = TraceConfig().deadlines["interactive"]
        return mean_prompt, mean_new, float(dl)

    def cost(self, cfg: Mapping[str, Any]) -> float:
        """Modeled microseconds per goodput token (same unit as
        ``measure``): service time per request from the prefill/decode
        tick counts, concurrency from the page pool, queueing delay
        from burst position ÷ concurrency — priority requeues
        interactive ahead of batch, prefix deletes shared prefill."""

        policy = str(cfg["policy"])
        mean_prompt, mean_new, dl_int = self._trace_moments()
        from ..configs import get_config
        acfg = get_config(self.arch).reduced()
        layers, d, vocab = acfg.n_layers, acfg.d_model, acfg.vocab
        param_bytes = 2 * (vocab * d + layers * 12 * d * d)
        kv_width = acfg.n_kv_heads * acfg.hd

        prefill_ticks = -(-mean_prompt // self.prefill_chunk)
        if policy == "prefix":
            # the shared fraction's prefix prefills once, then maps in
            prefill_ticks *= max(0.1, 1 - self.shared_frac
                                 * self.prefix_len / mean_prompt)
        service = prefill_ticks + mean_new      # ticks per request

        pool = self.kv_pages * self.page_size if self.kv_pages \
            else self.batch * self.context
        footprint = -(-(mean_prompt + mean_new) // self.page_size) \
            * self.page_size
        if policy == "prefix":
            footprint -= self.shared_frac * self.prefix_len
        conc = max(1.0, min(self.batch, pool / max(1.0, footprint)))

        # queueing: a burst of B arrivals drains conc at a time, so the
        # k-th waits ~ (k / conc) services; priority resequences so
        # interactive requests only wait behind their own class
        burst = self.burst if self.arrival == "bursty" \
            else max(1.0, self.rate * service)
        wait_all = (burst / 2) / conc * service
        if policy == "priority":
            wait_int = (burst * self.interactive_frac / 2) / conc * service
            wait_bat = wait_all * 2 - wait_int
        else:
            wait_int = wait_bat = wait_all
        met_int = 1.0 if wait_int + service <= dl_int else \
            max(0.05, dl_int / (wait_int + service))
        met_bat = 1.0          # batch deadlines are slack by design
        met = (self.interactive_frac * met_int
               + (1 - self.interactive_frac) * met_bat)

        ticks = -(-self.requests // conc) * service
        weight_s = param_bytes / get_platform_spec().hbm_bw
        kv_s = kv_cache_stream_s(conc, layers,
                                 int(mean_prompt + mean_new), kv_width)
        tick_us = (weight_s + kv_s + 50e-6) * 1e6
        goodput = max(1.0, met * self.requests * mean_new)
        return ticks * tick_us / goodput

    # -- measured objective -------------------------------------------------

    def _model(self):
        """Build (and memoize) the reduced float32 model named by
        ``arch`` — deferred so registry-built instances stay cheap until
        a measure engine actually runs them."""

        if self.api is None or self.params is None:
            from ..configs import get_config
            from ..models import build_model
            acfg = get_config(self.arch).reduced().replace(
                logits_dtype="float32")
            api = build_model(acfg)
            params = api.init(0, device=self.device)
            object.__setattr__(self, "api", api)
            object.__setattr__(self, "params", params)
        return self.api, self.params

    def measure(self, cfg: Mapping[str, Any], *, warmup: int = 1,
                iters: int = 1) -> float:
        """Measured microseconds per goodput token draining the seeded
        trace through a real paged server under this policy."""

        from .scheduler import make_scheduler
        from .workload import generate_trace
        api, params = self._model()
        policy = str(cfg["policy"])
        sched = make_scheduler(policy, age_limit=int(cfg["age_limit"]))
        trace = generate_trace(self.trace_config())
        stats: dict[str, float] = {}
        drain_us = timed_trace_drain(
            api, params, trace, batch=self.batch, context=self.context,
            prefill_chunk=self.prefill_chunk, paged=True,
            page_size=self.page_size, kv_pages=self.kv_pages or None,
            scheduler=sched, share_prefix=(policy == "prefix"),
            stats_out=stats, warmup=warmup, iters=iters)
        object.__setattr__(self, "last_stats", stats)
        return drain_us / max(1.0, stats.get("goodput_tokens", 0.0))

    def fingerprint(self) -> dict[str, Any]:
        fp = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self) if f.compare}
        for k in ("prompt_len", "max_new", "policies", "age_limits"):
            fp[k] = list(fp[k])
        if fp["device"] is None:
            del fp["device"]
        return {"tunable": self.name, "unit": "us_per_goodput_token", **fp}


def scheduler_tunable(api=None, *, context: int = 64, batch: int = 4,
                      requests: int = 12, page_size: int = 8,
                      prefill_chunk: int = 8, params=None,
                      **trace_kw) -> SchedulerTunable:
    """The policy tunable for this model + expected traffic — the one
    place the sizing wiring lives (library ``choose_scheduler`` and the
    ``launch/serve --tune-scheduler`` CLI both build through here).
    ``api``/``params`` are optional: omitted, ``measure`` builds the
    reduced model named by ``arch`` itself."""

    arch = trace_kw.pop("arch", api.cfg.name if api is not None
                        else "smollm-135m")
    return SchedulerTunable(arch=arch, context=context, batch=batch,
                            requests=requests, page_size=page_size,
                            prefill_chunk=prefill_chunk, api=api,
                            params=params, **trace_kw)


def choose_scheduler(api=None, *, cache="default", engine: str = "measure",
                     params=None, engine_kw: Mapping[str, Any] | None = None,
                     **tunable_kw):
    """Pick the serving policy via ``repro_torch.tune``; returns
    ``((policy, age_limit), TuneResult)``.  Default engine is
    ``measure`` — policy differences are exactly what the modeled cost
    can only rank, not settle.  ``engine_kw`` (the port's addition: the
    other keywords size the tunable) goes to the engine, e.g. the
    measure engine's ``top_k`` and ``repeats``."""

    from ..tune import tune as _tune
    tb = scheduler_tunable(api, params=params, **tunable_kw)
    res = _tune(tb, engine=engine, cache=cache, **dict(engine_kw or {}))
    return (str(res.best_config["policy"]),
            int(res.best_config["age_limit"])), res


__all__ = ["KV_CACHE_BYTES", "K_AND_V", "publish_drain_stats",
           "timed_server_drain",
           "timed_trace_drain", "kv_cache_stream_s",
           "DecodeBatchTunable", "PrefillChunkTunable", "KVPageTunable",
           "SchedulerTunable", "decode_batch_tunable",
           "prefill_chunk_tunable", "kv_page_tunable", "scheduler_tunable",
           "choose_batch", "choose_prefill_chunk", "choose_kv_page",
           "choose_scheduler"]
