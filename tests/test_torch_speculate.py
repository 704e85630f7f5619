"""The port's speculative decoding against the JAX package's, and
against its own non-speculative drains.

* The drafters (``repro_torch.runtime.speculate``) against the JAX
  drafters on the same token streams.
* ``Server(speculate=...)``, contiguous and paged, against the JAX
  speculative server (tokens, ticks, speculation counters, kv_stats) and
  against the port's own non-speculative drain (greedy parity), under
  staggered admissions; partial acceptance, the paged rollback's page
  table, the max_new/context caps, and prefix sharing with speculation.

f32 params: the server mirrors the params' dtype into its KV cache, and
f32 keeps real logit gaps between the verify/commit chunks and the
one-token baseline.  Weights from the JAX package's ``init``, carried
across with ``params_from_jax``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.serve import Server as JaxServer  # noqa: E402
from repro.runtime.speculate import DraftModelDrafter as JaxDraftModelDrafter  # noqa: E402
from repro.runtime.speculate import NGramDrafter as JaxNGramDrafter  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402
from repro_torch.runtime.speculate import (DRAFTER_KINDS,  # noqa: E402
                                           DraftModelDrafter, Drafter,
                                           NGramDrafter, make_drafter)

_MODELS: dict = {}


def _models(name="smollm-135m", **overrides):
    key = (name, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        jcfg = jax_get_config(name).reduced().replace(
            logits_dtype="float32", **overrides)
        cfg = get_config(name).reduced().replace(logits_dtype="float32",
                                                 **overrides)
        japi = jax_build_model(jcfg)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          japi.init(jax.random.PRNGKey(0)))
        _MODELS[key] = ((japi, jp), (build_model(cfg), params_from_jax(
            jax.tree.map(np.asarray, jp), "cpu")))
    return _MODELS[key]


def cycled_prompts(vocab, n, length, period=4):
    return [[(r + i % period) % (vocab - 1) + 1 for i in range(length)]
            for r in range(n)]


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_ngram_drafter_matches_jax(seed):
    """Random streams over a small vocabulary (so n-grams recur), every
    depth and n-gram range: the same proposals."""

    rng = np.random.default_rng(seed)
    for _ in range(40):
        toks = rng.integers(0, 5, int(rng.integers(0, 30))).tolist()
        depth = int(rng.integers(0, 6))
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 3))
        assert NGramDrafter(hi, lo).propose(toks, depth) == \
            JaxNGramDrafter(hi, lo).propose(toks, depth)


def test_ngram_drafter_cases():
    d = NGramDrafter()
    assert d.propose([1, 7, 8, 9, 5, 7, 8], 3) == [9, 5, 7]
    assert d.propose([7, 8, 1, 7, 8, 2, 7, 8], 1) == [2]
    assert d.propose([1, 2, 3, 4], 3) == []
    assert d.propose([1, 2], 0) == []
    assert d.propose([5], 4) == []
    assert d.propose([1, 2, 3, 4, 5, 1, 2, 3], 2) == [4, 5]


@pytest.mark.parametrize("name", ["smollm-135m", "qwen1.5-4b"])
@pytest.mark.parametrize("bucket", [8, 32])
def test_draft_model_drafter_matches_jax(name, bucket):
    """Self-draft through the port's ``forward`` proposes the JAX
    drafter's tokens on the same streams (f32 reduced models)."""

    (japi, jp), (api, p) = _models(name)
    rng = np.random.default_rng(3)
    jd = JaxDraftModelDrafter(japi, jp, bucket=bucket)
    d = DraftModelDrafter(api, p, bucket=bucket)
    for L in (1, 6, 8, 19):
        toks = rng.integers(0, api.cfg.vocab, L).tolist()
        assert d.propose(toks, 3) == jd.propose(toks, 3)


def test_make_drafter_resolution_and_errors():
    assert isinstance(make_drafter("ngram"), NGramDrafter)
    d = NGramDrafter()
    assert make_drafter(d) is d
    assert isinstance(d, Drafter)
    assert DRAFTER_KINDS == ("ngram", "draft")
    _, (api, p) = _models()
    assert isinstance(make_drafter("draft", api=api, params=p),
                      DraftModelDrafter)
    with pytest.raises(ValueError, match="needs api=/params="):
        make_drafter("draft")
    with pytest.raises(ValueError, match="unknown drafter"):
        make_drafter("telepathy")
    with pytest.raises(TypeError, match="not a Drafter"):
        make_drafter(42)  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# greedy parity: speculation is a schedule change, never a text change
# ---------------------------------------------------------------------------


def _drain(cls, api, params, prompts, *, max_new, staggered=True,
           after_tick=None, **kw):
    srv = cls(api, params, batch=2, context=32, prefill_chunk=4, **kw)
    reqs = [srv.submit(prompts[0], max_new=max_new)]
    if staggered:
        for _ in range(2):
            srv.tick()           # first request mid-prefill when rest land
    reqs += [srv.submit(q, max_new=max_new) for q in prompts[1:]]
    for _ in range(1000):
        if srv.tick() == 0 and not srv.queue:
            break
        if after_tick is not None:
            after_tick(srv)
    assert all(r.done for r in reqs)
    return [r.out for r in reqs], srv


def _spec_counters(srv):
    st = srv.stats()
    return ({k: st[k] for k in ("ticks", "tokens_generated", "spec_ticks",
                                "spec_proposed", "spec_accepted",
                                "deferrals")},
            [(r.spec_proposed, r.spec_accepted) for r in
             sorted(srv.completed, key=lambda r: r.rid)],
            srv.kv_stats())


@pytest.mark.parametrize("name,window", [("smollm-135m", None),
                                         ("qwen1.5-4b", None),
                                         ("smollm-135m", 8)])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("speculate", ["ngram", "draft"])
def test_speculative_parity_staggered(name, window, paged, speculate):
    """n-gram and self-draft speculation reproduce the port's baseline
    greedy drain token for token under staggered admissions, and the
    JAX speculative server's tokens, ticks and counters."""

    (japi, jp), (api, p) = _models(name, window=window)
    prompts = cycled_prompts(api.cfg.vocab, 3, 8)
    pk = dict(paged=True, page_size=8) if paged else {}
    base, _ = _drain(Server, api, p, prompts, max_new=6, **pk)
    kw = dict(max_new=6, speculate=speculate, spec_depth=3, **pk)
    outs, srv = _drain(Server, api, p, prompts, **kw)
    assert outs == base, f"{speculate} diverged from baseline"
    want, jsrv = _drain(JaxServer, japi, jp, prompts, **kw)
    assert outs == want
    assert _spec_counters(srv) == _spec_counters(jsrv)
    st = srv.stats()
    assert st["tokens_generated"] == sum(len(o) for o in base)
    if speculate == "draft":
        assert st["accept_rate"] == 1.0
        assert st["ticks"] < 3 * 6


def test_self_draft_hits_depth_plus_one_tokens_per_tick():
    _, (api, p) = _models()
    prompts = cycled_prompts(api.cfg.vocab, 2, 8)
    base, bsrv = _drain(Server, api, p, prompts, max_new=8, staggered=False)
    outs, srv = _drain(Server, api, p, prompts, max_new=8, staggered=False,
                       speculate="draft", spec_depth=4)
    assert outs == base
    st, bst = srv.stats(), bsrv.stats()
    assert st["ticks"] < bst["ticks"]
    assert st["ticks_per_token"] < bst["ticks_per_token"]
    # every verify accepted its whole draft: depth + 1 tokens a slot
    # unless the max_new cap shortened the draft
    assert st["spec_accepted"] == st["spec_proposed"] > 0


class CorruptTailDrafter:
    """Self-draft with the tail corrupted from index ``split`` on:
    accepts exactly ``split`` tokens per verify, forcing the rejection
    and rollback path every speculative tick."""

    name = "corrupt-tail"

    def __init__(self, inner, vocab, split=1):
        self.inner, self.vocab, self.split = inner, vocab, split

    def propose(self, tokens, depth):
        out = self.inner.propose(tokens, depth)
        return [t if i < self.split else (t + 1) % self.vocab
                for i, t in enumerate(out)]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("split", [0, 1, 2])
def test_partial_acceptance_parity_and_counters(paged, split):
    (japi, jp), (api, p) = _models()
    prompts = cycled_prompts(api.cfg.vocab, 2, 8)
    pk = dict(paged=True, page_size=4) if paged else {}
    base, _ = _drain(Server, api, p, prompts, max_new=6, staggered=False,
                     **pk)
    vocab = api.cfg.vocab
    outs, srv = _drain(Server, api, p, prompts, max_new=6, staggered=False,
                       speculate=CorruptTailDrafter(
                           DraftModelDrafter(api, p, bucket=8), vocab, split),
                       spec_depth=3, **pk)
    assert outs == base
    want, jsrv = _drain(JaxServer, japi, jp, prompts, max_new=6,
                        staggered=False, speculate=CorruptTailDrafter(
                            JaxDraftModelDrafter(japi, jp, bucket=8), vocab,
                            split), spec_depth=3, **pk)
    assert outs == want
    assert _spec_counters(srv) == _spec_counters(jsrv)
    st = srv.stats()
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] < st["spec_proposed"]
    assert (st["spec_accepted"] > 0) == (split > 0)


def test_paged_rollback_page_table_matches_never_speculated_drain():
    """Pages taken for rejected draft positions come back the same tick:
    after every tick each live slot backs exactly ceil(pos / page_size)
    logical pages, as a drain that never speculated does, and after the
    drain the free count and page tables equal that drain's (the free
    list's order differs: rewound pages return in another order)."""

    _, (api, p) = _models()
    prompts = cycled_prompts(api.cfg.vocab, 2, 8)
    pk = dict(paged=True, page_size=4)
    seen = []

    def backs_its_positions(srv):
        for s in srv.live_slots():
            backed = int((srv.alloc.page_table[s] >= 0).sum())
            assert backed == -(-int(srv.slot_pos[s]) // 4), (s, backed)
        seen.append(srv.spec_ticks)

    base, bsrv = _drain(Server, api, p, prompts, max_new=6, staggered=False,
                        after_tick=backs_its_positions, **pk)
    drafter = CorruptTailDrafter(DraftModelDrafter(api, p, bucket=8),
                                 api.cfg.vocab, split=1)
    outs, srv = _drain(Server, api, p, prompts, max_new=6, staggered=False,
                       speculate=drafter, spec_depth=3,
                       after_tick=backs_its_positions, **pk)
    assert outs == base
    assert max(seen) > 0                    # speculative ticks were checked
    assert srv.alloc.free_pages == bsrv.alloc.free_pages
    assert np.array_equal(srv.alloc.page_table, bsrv.alloc.page_table)
    assert srv.alloc.used_pages == 0        # everything retired + released


@pytest.mark.parametrize("paged", [False, True])
def test_spec_never_overshoots_max_new_or_context(paged):
    """Depth caps: a deep draft near a request's max_new (or the context
    edge) is clipped, so the request stops exactly where the baseline
    does."""

    _, (api, p) = _models()
    prompts = cycled_prompts(api.cfg.vocab, 2, 8)
    pk = dict(paged=True, page_size=4) if paged else {}
    base, _ = _drain(Server, api, p, prompts, max_new=3, staggered=False,
                     **pk)
    outs, _ = _drain(Server, api, p, prompts, max_new=3, staggered=False,
                     speculate="draft", spec_depth=8, **pk)
    assert outs == base
    assert all(len(o) == 3 for o in outs)
    # the context edge: a 26-token prompt and 6 new tokens fill the
    # context of 32 exactly (the verify chunk may not pass position 31)
    long_p = [cycled_prompts(api.cfg.vocab, 1, 26)[0]]
    base, _ = _drain(Server, api, p, long_p, max_new=6, staggered=False,
                     **pk)
    outs, srv = _drain(Server, api, p, long_p, max_new=6, staggered=False,
                       speculate="draft", spec_depth=8, **pk)
    assert outs == base and len(outs[0]) == 6
    assert srv.stats()["spec_ticks"] > 0


def test_shared_prefix_parity_with_speculation():
    """Sharing composes with speculative decoding: paged + shared +
    n-gram drafts reproduce the plain contiguous stream, as the JAX
    server does."""

    (japi, jp), (api, p) = _models()
    prefix = list(range(3, 19))
    prompts = [prefix + [20 + i] for i in range(2)]
    runs = []
    for cls, a, pr in ((JaxServer, japi, jp), (Server, api, p)):
        srv = cls(a, pr, batch=3, context=48, paged=True, page_size=4,
                  prefill_chunk=8, share_prefix=True, speculate="ngram",
                  spec_depth=3)
        first = srv.submit(prompts[0], max_new=5)
        while not first.out:
            srv.tick()
        second = srv.submit(prompts[1], max_new=5)
        srv.run_until_drained()
        runs.append(([first.out, second.out], _spec_counters(srv),
                     srv.stats()["share_hits"]))
    assert runs[1] == runs[0]
    assert runs[1][2] == 1
    for q, out in zip(prompts, runs[1][0]):
        solo = Server(api, p, batch=1, context=48, prefill_chunk=8)
        r = solo.submit(q, max_new=5)
        solo.run_until_drained()
        assert out == r.out
