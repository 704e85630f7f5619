"""The port's paged KV against the JAX package's.

* The allocator (``repro_torch.runtime.kv``) op for op against
  ``repro.runtime.kv`` on seeded random operation sequences, and the
  reference's allocator cases (``tests/test_kv.py``) on the port's copy.
* Paged decode and chunked-prefill attention against the JAX functions
  on a shuffled physical page layout, f32, within 1e-5; gated-off slots
  write nothing.
* The paged ``Server`` (page pressure, OOM deferral, the SWA trim,
  ``share_prefix``) against the JAX paged ``Server``: the same tokens,
  tick counts, deferrals and ``kv_stats()``; and against the port's own
  contiguous drains.

Reduced configs in f32, weights from the JAX package's ``init`` carried
across with ``params_from_jax``; inputs from seeded numpy generators.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_row_spy import PrefillRowSpy  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.runtime import kv as jax_kv  # noqa: E402
from repro.runtime.serve import Server as JaxServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import (decode_state_from_jax, from_numpy,  # noqa: E402
                                 params_from_jax, to_numpy)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402
from repro_torch.runtime.kv import (NO_PAGE, PagedKVAllocator,  # noqa: E402
                                    PagedKVSpec)

ATOL = RTOL = 1e-5          # f32 attention, as the reference's own tests


def _models(name, **overrides):
    jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32",
                                                  **overrides)
    cfg = get_config(name).reduced().replace(logits_dtype="float32",
                                             **overrides)
    japi = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      japi.init(jax.random.PRNGKey(0)))
    return (japi, jp), (build_model(cfg),
                        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))


@pytest.fixture(scope="module")
def smollm():
    return _models("smollm-135m")


# ---------------------------------------------------------------------------
# the allocator, op for op
# ---------------------------------------------------------------------------


def _call(alloc, op, args):
    try:
        return ("ok", getattr(alloc, op)(*args))
    except ValueError as e:
        return ("raise", str(e))


@pytest.mark.parametrize("seed", range(8))
def test_allocator_matches_jax_op_for_op(seed):
    """A seeded random sequence of ensure / share / cow_pages / rewind /
    trim / release leaves both allocators with equal page tables,
    refcounts, owners, free lists, high-water marks and stats after
    every operation, with equal returns (and equal refusals)."""

    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(2, 5))
    spec = dict(n_pages=int(rng.integers(4, 14)),
                page_size=int(rng.integers(1, 6)),
                pages_per_slot=int(rng.integers(2, 6)))
    port = PagedKVAllocator(PagedKVSpec(**spec), n_slots)
    ref = jax_kv.PagedKVAllocator(jax_kv.PagedKVSpec(**spec), n_slots)
    port.trace, ref.trace = [], []
    cap = spec["page_size"] * spec["pages_per_slot"]
    ops = ("ensure", "share", "cow_pages", "rewind", "trim", "release")
    for _ in range(200):
        op = ops[int(rng.integers(len(ops)))]
        s, s2 = (int(x) for x in rng.integers(0, n_slots, 2))
        n, m = sorted(int(x) for x in rng.integers(0, cap + 2, 2))
        args = {"ensure": (s, n), "share": (s, s2, min(m, cap)),
                "cow_pages": (s, n, m), "rewind": (s, n), "trim": (s, n),
                "release": (s,)}[op]
        assert _call(port, op, args) == _call(ref, op, args), (op, args)
        assert port.project() == ref.project(), (op, args)
        live = int(rng.integers(0, cap * n_slots + 1))
        assert port.stats(live) == ref.stats(live)
        assert port.free_pages == ref.free_pages
        assert port.shared_pages == ref.shared_pages
    assert port.trace == ref.trace


def test_paged_spec_for_server_matches_jax():
    for kw in (dict(context=64, page_size=8), dict(context=50, page_size=16,
                                                   n_pages=9, batch=3),
               dict(context=64, page_size=8, batch=4)):
        assert PagedKVSpec.for_server(**kw).__dict__ == \
            jax_kv.PagedKVSpec.for_server(**kw).__dict__
    with pytest.raises(ValueError, match="degenerate"):
        PagedKVSpec(n_pages=0, page_size=4, pages_per_slot=1)


# the reference's allocator cases (tests/test_kv.py), on the port's copy


def make_alloc(n_pages=8, page_size=4, pages_per_slot=4, n_slots=3):
    spec = PagedKVSpec(n_pages=n_pages, page_size=page_size,
                       pages_per_slot=pages_per_slot)
    return PagedKVAllocator(spec, n_slots)


def _pages_never_shared_between_live_slots():
    alloc = make_alloc()
    assert alloc.ensure(0, 10) and alloc.ensure(1, 7) and alloc.ensure(2, 3)
    owned = {}
    for s in range(3):
        for p in alloc.slot_pages(s):
            assert p not in owned, f"page {p} owned by {owned[p]} and {s}"
            owned[p] = s
    for p, s in owned.items():
        assert alloc.owner[p] == s
    assert len(owned) == alloc.used_pages == 3 + 2 + 1


def _ensure_is_all_or_nothing():
    alloc = make_alloc(n_pages=4)
    assert alloc.ensure(0, 9)
    free_before = alloc.free_pages
    assert not alloc.ensure(1, 9)
    assert alloc.free_pages == free_before
    assert alloc.slot_pages(1) == []
    assert alloc.ensure(1, 4)


def _free_list_reuse_after_release():
    alloc = make_alloc()
    alloc.ensure(0, 16)
    released = set(alloc.slot_pages(0))
    assert alloc.release(0) == 4
    assert alloc.page_table[0].tolist() == [NO_PAGE] * 4
    assert alloc.free_pages == 8
    alloc.ensure(1, 16)
    assert set(alloc.slot_pages(1)) == released
    assert alloc.release(0) == 0


def _ensure_grows_monotonically():
    alloc = make_alloc()
    alloc.ensure(0, 3)
    first = alloc.slot_pages(0)
    alloc.ensure(0, 4)
    assert alloc.slot_pages(0) == first
    alloc.ensure(0, 5)
    assert len(alloc.slot_pages(0)) == 2
    assert alloc.slot_pages(0)[0] == first[0]


def _trim_frees_only_whole_dead_pages():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 16)
    assert alloc.trim(0, 3) == 0
    assert alloc.trim(0, 4) == 1
    assert alloc.page_table[0, 0] == NO_PAGE
    assert alloc.trim(0, 11) == 1
    assert alloc.ensure(0, 16)
    assert alloc.page_table[0, 0] == NO_PAGE
    assert alloc.page_table[0, 1] == NO_PAGE


def _rewind_frees_pages_above_keep():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 14)
    kept = alloc.slot_pages(0)[:2]
    assert alloc.rewind(0, 7) == 2
    assert alloc.slot_pages(0) == kept
    assert alloc.free_pages == 8 - 2
    assert alloc.ensure(0, 14)
    assert len(alloc.slot_pages(0)) == 4
    assert alloc.slot_pages(0)[:2] == kept


def _rewind_noop_within_kept_pages():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 8)
    before = alloc.slot_pages(0)
    assert alloc.rewind(0, 8) == 0
    assert alloc.rewind(0, 5) == 0
    assert alloc.slot_pages(0) == before
    assert alloc.rewind(0, 4) == 1
    assert alloc.slot_pages(0) == before[:1]
    assert alloc.rewind(0, 0) == 1
    assert alloc.rewind(0, 0) == 0
    assert alloc.slot_pages(0) == [] and alloc.free_pages == 8


def _overflowing_page_table_raises():
    alloc = make_alloc(pages_per_slot=2, page_size=4)
    with pytest.raises(ValueError, match="exceed the page table"):
        alloc.ensure(0, 9)


def _spec_rejects_pool_smaller_than_one_slot():
    with pytest.raises(ValueError, match="single request could deadlock"):
        PagedKVSpec.for_server(context=64, page_size=8, n_pages=4)


def _stats_fragmentation():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 5)
    st = alloc.stats(live_tokens=5)
    assert st["used_pages"] == 2 and st["occupancy"] == 2 / 8
    assert st["fragmentation"] == pytest.approx(3 / 8)


def _share_maps_pages_and_bumps_refcounts():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 10)
    used_before = alloc.used_pages
    assert alloc.share(0, 1, 8) == 2
    assert alloc.slot_pages(1) == alloc.slot_pages(0)[:2]
    assert alloc.used_pages == used_before
    assert alloc.shared_pages == 2
    for p in alloc.slot_pages(1):
        assert alloc.refcount[p] == 2
    assert alloc.refcount[alloc.slot_pages(0)[2]] == 1
    assert alloc.ensure(1, 12)
    assert len(alloc.slot_pages(1)) == 3
    assert alloc.slot_pages(1)[2] != alloc.slot_pages(0)[2]


def _share_rejects_bad_src_or_dst():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 10)
    alloc.ensure(1, 4)
    with pytest.raises(ValueError, match="not empty"):
        alloc.share(0, 1, 8)
    with pytest.raises(ValueError, match="does not back"):
        alloc.share(0, 2, 16)
    assert alloc.share(0, 2, 0) == 0
    assert alloc.slot_pages(2) == []


def _shared_pages_survive_source_release():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 10)
    alloc.share(0, 1, 8)
    shared = alloc.slot_pages(1)
    assert alloc.release(0) == 3
    assert alloc.free_pages == 8 - 2
    for p in shared:
        assert alloc.refcount[p] == 1
        assert alloc.owner[p] == 1
    assert alloc.release(1) == 2
    assert alloc.free_pages == 8
    assert not alloc.refcount.any()


def _sharer_release_keeps_source_pages():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 8)
    alloc.share(0, 1, 8)
    assert alloc.release(1) == 2
    assert alloc.free_pages == 8 - 2
    assert alloc.shared_pages == 0
    for p in alloc.slot_pages(0):
        assert alloc.refcount[p] == 1 and alloc.owner[p] == 0


def _cow_breaks_exactly_the_shared_pages_in_range():
    alloc = make_alloc(page_size=4, n_pages=8)
    alloc.ensure(0, 8)
    alloc.share(0, 1, 6)
    pairs = alloc.cow_pages(1, 6, 9)
    assert len(pairs) == 1
    old, new = pairs[0]
    assert old == alloc.slot_pages(0)[1]
    assert alloc.page_table[1, 1] == new
    assert alloc.refcount[old] == 1 and alloc.refcount[new] == 1
    assert alloc.owner[new] == 1
    assert alloc.shared_pages == 1
    assert alloc.cow_pages(1, 6, 9) == []


def _cow_is_all_or_nothing_under_pressure():
    alloc = make_alloc(page_size=4, n_pages=2, n_slots=2, pages_per_slot=2)
    alloc.ensure(0, 8)
    alloc.share(0, 1, 6)
    table_before = alloc.page_table.copy()
    assert alloc.cow_pages(1, 4, 6) is None
    assert (alloc.page_table == table_before).all()
    assert alloc.free_pages == 0


def _rewind_and_trim_deref_shared_pages():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 8)
    alloc.share(0, 1, 8)
    free_before = alloc.free_pages
    assert alloc.trim(0, 4) == 0
    assert alloc.free_pages == free_before
    assert alloc.refcount[alloc.slot_pages(1)[0]] == 1
    assert alloc.rewind(1, 4) == 0
    assert alloc.free_pages == free_before
    assert alloc.release(0) == 1
    assert alloc.release(1) == 1
    assert alloc.free_pages == 8


def _stats_reports_shared_pages():
    alloc = make_alloc(page_size=4)
    alloc.ensure(0, 8)
    alloc.share(0, 1, 8)
    assert alloc.stats()["shared_pages"] == 2.0


ALLOCATOR_CASES = [
    _pages_never_shared_between_live_slots, _ensure_is_all_or_nothing,
    _free_list_reuse_after_release, _ensure_grows_monotonically,
    _trim_frees_only_whole_dead_pages, _rewind_frees_pages_above_keep,
    _rewind_noop_within_kept_pages, _overflowing_page_table_raises,
    _spec_rejects_pool_smaller_than_one_slot, _stats_fragmentation,
    _share_maps_pages_and_bumps_refcounts, _share_rejects_bad_src_or_dst,
    _shared_pages_survive_source_release, _sharer_release_keeps_source_pages,
    _cow_breaks_exactly_the_shared_pages_in_range,
    _cow_is_all_or_nothing_under_pressure,
    _rewind_and_trim_deref_shared_pages, _stats_reports_shared_pages]


@pytest.mark.parametrize("case", ALLOCATOR_CASES,
                         ids=[c.__name__[1:] for c in ALLOCATOR_CASES])
def test_allocator_case(case):
    case()


# ---------------------------------------------------------------------------
# paged attention against the JAX functions, shuffled physical pages
# ---------------------------------------------------------------------------


def _layout(rng, cfg, lens, ps, M, P, cover=1):
    """Per-slot K/V of ``lens`` tokens (plus ``cover`` more positions
    backed) laid out contiguously and through a shuffled page table."""

    B = len(lens)
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    C = M * ps
    k_cont = np.zeros((B, Hkv, C, hd), np.float32)
    v_cont = np.zeros((B, Hkv, C, hd), np.float32)
    perm = rng.permutation(P)
    table = np.full((B, M), -1, np.int32)
    pool_k = rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32)
    pool_v = rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32)
    nxt = 0
    for b, n in enumerate(lens):
        k_cont[b, :, :n] = rng.standard_normal((Hkv, n, hd))
        v_cont[b, :, :n] = rng.standard_normal((Hkv, n, hd))
        for m in range(-(-int(n + cover) // ps)):
            page = int(perm[nxt])
            nxt += 1
            table[b, m] = page
            pool_k[page, :, :min(ps, max(0, n - m * ps))] = \
                k_cont[b, :, m * ps:min(n, (m + 1) * ps)]
            pool_v[page, :, :min(ps, max(0, n - m * ps))] = \
                v_cont[b, :, m * ps:min(n, (m + 1) * ps)]
    return k_cont, v_cont, pool_k, pool_v, table


def _attn_params(cfg):
    from repro.models.common import init_params
    p = init_params(jax_attn.attn_specs(cfg), jax.random.PRNGKey(1))
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    return p, params_from_jax(p, "cpu")


def _t(a):
    return from_numpy(np.asarray(a), "cpu")


def _writes(table, cur, T, gate, ps):
    """:func:`attn.paged_writes` for a step of T tokens from ``cur``."""

    pos = torch.as_tensor(np.asarray(cur), dtype=torch.long)[:, None] \
        + torch.arange(T)[None, :]
    return attn.paged_writes(torch.as_tensor(np.asarray(table)), pos, gate,
                             ps)


@pytest.mark.parametrize("name,window", [("smollm-135m", None),
                                         ("qwen1.5-4b", None),
                                         ("smollm-135m", 8)])
@pytest.mark.parametrize("active", [None, (True, False, True)])
def test_decode_attention_paged_matches_jax(name, window, active):
    """One-token paged attention against the JAX function on the same
    shuffled layout: the output and the whole pool after the write, and
    against the port's contiguous path on the same K/V."""

    cfg = get_config(name).reduced().replace(logits_dtype="float32",
                                             window=window)
    jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32",
                                                  window=window)
    jp, p = _attn_params(jcfg)
    rng = np.random.default_rng(0)
    ps, M = 8, 4
    lens = np.array([5, 0, 17], np.int32)
    k_c, v_c, pk, pv, table = _layout(rng, cfg, lens, ps, M, 3 * M)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    act = None if active is None else np.array(active)

    out_j, pool_j = jax_attn.decode_attention_paged(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(pk), "v": jnp.asarray(pv)},
        jnp.asarray(table), jnp.asarray(lens), window=window,
        active=None if act is None else jnp.asarray(act))
    pool = {"k": _t(pk), "v": _t(pv)}
    gate = torch.ones(3, dtype=torch.bool) if act is None \
        else torch.from_numpy(act)
    out, got = attn.decode_attention_paged(
        p, cfg, _t(x), pool, _t(table), _t(lens),
        _writes(table, lens, 1, gate[:, None], ps), window=window)
    assert got is pool
    np.testing.assert_allclose(to_numpy(out), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)
    for name_ in ("k", "v"):
        np.testing.assert_allclose(to_numpy(pool[name_]),
                                   np.asarray(pool_j[name_]),
                                   atol=ATOL, rtol=RTOL)

    # the contiguous path on the same K/V gives the same output (rows
    # that write; a window ring of C >= every length is the linear view)
    cache = {"k": _t(k_c), "v": _t(v_c)}
    out_c, _ = attn.decode_attention(p, cfg, _t(x), cache, _t(lens),
                                     window=window)
    rows = [b for b in range(3) if act is None or act[b]]
    np.testing.assert_allclose(to_numpy(out)[rows], to_numpy(out_c)[rows],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name,window", [("smollm-135m", None),
                                         ("qwen1.5-4b", None),
                                         ("smollm-135m", 8)])
@pytest.mark.parametrize("lengths", [(3, 0, 5), (4, 4, 1)])
def test_chunked_paged_matches_jax(name, window, lengths):
    """Chunked paged prefill against the JAX function on a shuffled
    layout (output and pool); ``write=False``, the verifier's form,
    gives the same output and leaves the pool as it was."""

    cfg = get_config(name).reduced().replace(logits_dtype="float32",
                                             window=window)
    jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32",
                                                  window=window)
    jp, p = _attn_params(jcfg)
    rng = np.random.default_rng(1)
    ps, M, T = 4, 6, 5
    cur = np.array([6, 2, 9], np.int32)
    lens = np.array(lengths, np.int32)
    _, _, pk, pv, table = _layout(rng, cfg, cur, ps, M, 3 * M, cover=T)
    x = rng.standard_normal((3, T, cfg.d_model)).astype(np.float32)

    out_j, pool_j = jax_attn.decode_attention_chunked_paged(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(pk), "v": jnp.asarray(pv)},
        jnp.asarray(table), jnp.asarray(cur), jnp.asarray(lens), window=window)
    keep = {"k": _t(pk), "v": _t(pv)}
    writes = _writes(table, cur, T, torch.arange(T)[None, :]
                     < _t(lens)[:, None], ps)
    out_v, _ = attn.decode_attention_chunked_paged(
        p, cfg, _t(x), keep, _t(table), _t(cur), writes, window=window,
        write=False)
    assert np.array_equal(to_numpy(keep["k"]), pk)
    assert np.array_equal(to_numpy(keep["v"]), pv)
    pool = {"k": _t(pk), "v": _t(pv)}
    out, _ = attn.decode_attention_chunked_paged(
        p, cfg, _t(x), pool, _t(table), _t(cur), writes, window=window)
    valid = np.arange(T)[None, :] < lens[:, None]
    for o in (out, out_v):
        np.testing.assert_allclose(to_numpy(o)[valid],
                                   np.asarray(out_j)[valid],
                                   atol=ATOL, rtol=RTOL)
    assert np.array_equal(to_numpy(out), to_numpy(out_v))
    for name_ in ("k", "v"):
        np.testing.assert_allclose(to_numpy(pool[name_]),
                                   np.asarray(pool_j[name_]),
                                   atol=ATOL, rtol=RTOL)


def test_gated_off_slots_write_nothing(smollm):
    """``active`` (decode) and ``lengths`` (chunk) gate the pool writes.
    A gated-off slot whose entry is -1 must not write page 0 through a
    clipped index, where a live slot writes at the same offset."""

    cfg = get_config("smollm-135m").reduced().replace(logits_dtype="float32")
    _, p = _attn_params(jax_get_config("smollm-135m").reduced())
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    table = torch.tensor([[0, 1], [-1, -1], [2, 3]], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 1, cfg.d_model), generator=g)
    solo = {"k": torch.zeros((4, Hkv, 4, hd)), "v": torch.zeros((4, Hkv, 4, hd))}
    attn.decode_attention_paged(
        p, cfg, x[:1], solo, table[:1], torch.tensor([0]),
        _writes(table[:1], [0], 1, torch.tensor([[True]]), 4))
    for gate in ([True, False, False], [True, True, False]):
        pool = {"k": torch.zeros((4, Hkv, 4, hd)),
                "v": torch.zeros((4, Hkv, 4, hd))}
        attn.decode_attention_paged(
            p, cfg, x, pool, table, torch.tensor([0, 0, 0]),
            _writes(table, [0, 0, 0], 1, torch.tensor(gate)[:, None], 4))
        for name in ("k", "v"):
            # page 0 offset 0 holds slot 0's token (a batch of 1 rounds
            # its projection differently in the last bit), nothing else
            # was written
            torch.testing.assert_close(pool[name], solo[name], atol=1e-6,
                                       rtol=1e-6)
            assert pool[name][0, :, 0].any()
            assert not pool[name][0, :, 1:].any()
            assert not pool[name][1:].any()

    pool = {"k": torch.zeros((4, Hkv, 4, hd)), "v": torch.zeros((4, Hkv, 4, hd))}
    attn.decode_attention_chunked_paged(
        p, cfg, torch.randn((3, 2, cfg.d_model), generator=g), pool, table,
        torch.tensor([0, 0, 0]),
        _writes(table, [0, 0, 0], 2,
                torch.arange(2)[None, :] < torch.tensor([0, 2, 0])[:, None],
                4))
    for name in ("k", "v"):
        assert not pool[name].any()                 # nothing backed writes


def test_jax_paged_state_carries_across(smollm):
    """``decode_state_from_jax`` carries a paged JAX state (the pool
    tree); one paged decode step from it writes the same pool."""

    (japi, jp), (api, p) = smollm
    spec = jax_kv.PagedKVSpec(n_pages=6, page_size=4, pages_per_slot=3)
    jstate = japi.init_decode_state(2, 12, spec, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    jstate = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jstate)
    state = decode_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    want = api.decode_state_specs(2, 12, PagedKVSpec(6, 4, 3),
                                  dtype=torch.float32)
    got_leaf = state["blocks"]["0_dense"]["kv"]["k"]
    assert tuple(got_leaf.shape) == want["blocks"]["0_dense"]["kv"]["k"].shape
    table = np.array([[3, 0, -1], [5, 1, 2]], np.int32)
    tokens = np.array([[7], [9]], np.int32)
    cur = np.array([5, 9], np.int32)
    lj, jnew = japi.decode_step(jp, jstate, jnp.asarray(tokens),
                                jnp.asarray(cur), jnp.asarray(table),
                                jnp.asarray([True, True]))
    lt, new = api.decode_step(p, state, _t(tokens), _t(cur), _t(table),
                              torch.tensor([True, True]))
    np.testing.assert_allclose(to_numpy(lt), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            to_numpy(new["blocks"]["0_dense"]["kv"][name]),
            np.asarray(jnew["blocks"]["0_dense"]["kv"][name]),
            atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the paged Server against the JAX paged Server
# ---------------------------------------------------------------------------


def _drain(server_cls, api, params, *, seed, vocab, submit_at=3, n_first=4,
           prompts=None, **kw):
    """``n_first`` requests, ``submit_at`` ticks, two more (staggered
    admissions); returns outputs, ticks, deferrals, kv_stats, stats."""

    srv = server_cls(api, params, **kw)
    if isinstance(api, PrefillRowSpy):
        api.server = srv
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = [rng.integers(0, vocab, int(rng.integers(3, 20))).tolist()
                   for _ in range(n_first)] + \
                  [rng.integers(0, vocab, 9).tolist() for _ in range(2)]
    news = [int(rng.integers(2, 8)) for _ in prompts]
    reqs = [srv.submit(q, max_new=n) for q, n in
            zip(prompts[:n_first], news)]
    for _ in range(submit_at):
        srv.tick()
    reqs += [srv.submit(q, max_new=n) for q, n in
             zip(prompts[n_first:], news[n_first:])]
    srv.run_until_drained()
    assert all(r.done for r in reqs)
    return ([r.out for r in reqs], srv.ticks, srv.deferrals, srv.kv_stats(),
            srv.stats(), srv)


def _same_as_jax(want, got):
    assert got[:4] == want[:4]
    for key in want[4]:
        assert got[4][key] == want[4][key], key


@pytest.mark.parametrize("name,window,batch", [
    ("smollm-135m", None, 3), ("qwen1.5-4b", None, 2), ("smollm-135m", 8, 3),
    ("qwen1.5-4b", None, 4)])
@pytest.mark.parametrize("chunk", [4, 32])
@pytest.mark.parametrize("kv_pages", [None, 13])
def test_paged_server_matches_jax_server(name, window, batch, chunk,
                                         kv_pages):
    """Same tokens, ticks, deferrals and kv_stats under full backing and
    under page pressure (13 pages of 4 tokens for up to 4 slots of 48).
    Each prefill step is handed the prefilling slots' rows alone; at 4
    slots, some while the others decode."""

    (japi, jp), (api, p) = _models(name, window=window)
    kw = dict(batch=batch, context=48, prefill_chunk=chunk, seed=1,
              vocab=api.cfg.vocab, paged=True, page_size=4,
              kv_pages=kv_pages)
    want = _drain(JaxServer, japi, jp, **kw)
    spy = PrefillRowSpy(api)
    got = _drain(Server, spy, p, **kw)
    _same_as_jax(want, got)
    spy.assert_prefilling_rows_only()
    if batch == 4:
        assert any(c["decoding"] and c["rows"] < batch for c in spy.calls)
    contiguous = _drain(Server, api, p, **{**kw, "paged": False,
                                           "kv_pages": None})
    assert got[0] == contiguous[0]


def test_paged_priority_preemption_matches_jax(smollm):
    (japi, jp), (api, p) = smollm
    kw = dict(batch=2, context=48, prefill_chunk=4, seed=2,
              vocab=api.cfg.vocab, paged=True, page_size=4,
              scheduler="priority")

    def drain(cls, a, pr):
        srv = cls(a, pr, **{k: v for k, v in kw.items()
                            if k not in ("seed", "vocab")})
        rng = np.random.default_rng(2)
        reqs = [srv.submit(rng.integers(0, 256, 12).tolist(), max_new=6,
                           slo="batch") for _ in range(2)]
        for _ in range(5):
            srv.tick()
        reqs.append(srv.submit(rng.integers(0, 256, 5).tolist(), max_new=4,
                               slo="interactive", deadline=20.0))
        srv.run_until_drained()
        return ([r.out for r in reqs], srv.ticks, srv.preemptions,
                srv.kv_stats(), [r.rid for r in srv.completed])

    want, got = drain(JaxServer, japi, jp), drain(Server, api, p)
    assert got == want and got[2] >= 1


# the reference's paged serving cases (tests/test_kv.py), on the port,
# each also held to the JAX server


def _solo_out(api, params, prompt, max_new, **kw):
    solo = Server(api, params, batch=1, context=32, **kw)
    ref = solo.submit(prompt, max_new=max_new)
    solo.run_until_drained()
    return ref.out


@pytest.mark.parametrize("name,window", [("smollm-135m", None),
                                         ("qwen1.5-4b", None),
                                         ("smollm-135m", 8)])
def test_paged_matches_contiguous_staggered_mixed_phase(name, window):
    (japi, jp), (api, p) = _models(name, window=window)
    rng = np.random.default_rng(11)
    prompt_a = rng.integers(0, api.cfg.vocab, 14).tolist()
    prompt_b = rng.integers(0, api.cfg.vocab, 6).tolist()
    outs = []
    for cls, a, pr in ((JaxServer, japi, jp), (Server, api, p)):
        srv = cls(a, pr, batch=2, context=32, prefill_chunk=4, paged=True,
                  page_size=8)
        req_a = srv.submit(prompt_a, max_new=4)
        for _ in range(2):
            srv.tick()               # A mid-prefill when B arrives
        req_b = srv.submit(prompt_b, max_new=4)
        srv.run_until_drained()
        outs.append((req_a.out, req_b.out, srv.ticks, srv.kv_stats()))
    assert outs[1] == outs[0]
    for prompt, out in ((prompt_a, outs[1][0]), (prompt_b, outs[1][1])):
        assert out == _solo_out(api, p, prompt, 4, prefill_chunk=4)


def test_paged_admission_waits_for_free_pages(smollm):
    (japi, jp), (api, p) = smollm
    p1, p2 = list(range(1, 21)), list(range(3, 20))
    runs = []
    for cls, a, pr in ((JaxServer, japi, jp), (Server, api, p)):
        srv = cls(a, pr, batch=2, context=32, paged=True, page_size=8,
                  kv_pages=4)                   # pool == one full slot
        r1 = srv.submit(p1, max_new=4)
        r2 = srv.submit(p2, max_new=4)
        srv.tick()
        assert srv.queue and srv.queue[0] is r2  # no pages -> not admitted
        srv.run_until_drained()
        runs.append((r1.out, r2.out, srv.ticks, srv.kv_stats()))
    assert runs[1] == runs[0]
    assert runs[1][0] == _solo_out(api, p, p1, 4)
    assert runs[1][1] == _solo_out(api, p, p2, 4)


def test_paged_oom_at_tick_defers_youngest_and_restarts(smollm):
    (japi, jp), (api, p) = smollm
    p1, p2 = list(range(1, 21)), list(range(1, 15))
    runs = []
    for cls, a, pr in ((JaxServer, japi, jp), (Server, api, p)):
        srv = cls(a, pr, batch=2, context=32, paged=True, page_size=8,
                  kv_pages=4)
        r1 = srv.submit(p1, max_new=4)
        r2 = srv.submit(p2, max_new=4)
        srv.run_until_drained()
        runs.append((r1.out, r2.out, srv.ticks, srv.deferrals,
                     r2.preempted, srv.kv_stats()))
    assert runs[1] == runs[0]
    assert runs[1][3] >= 1                      # the pool really choked
    assert runs[1][0] == _solo_out(api, p, p1, 4)
    assert runs[1][1] == _solo_out(api, p, p2, 4)


def test_paged_sliding_window_trims_dead_pages():
    (japi, jp), (api, p) = _models("smollm-135m", window=8)
    prompt = list(range(1, 25))
    peaks = []
    for cls, a, pr in ((JaxServer, japi, jp), (Server, api, p)):
        srv = cls(a, pr, batch=1, context=32, paged=True, page_size=4,
                  prefill_chunk=4)
        req = srv.submit(prompt, max_new=4)
        used = []
        while not req.done:
            srv.tick()
            used.append(srv.alloc.used_pages)
        peaks.append((used, req.out))
    assert peaks[1] == peaks[0]
    # window 8 at page size 4: at most 3 live pages
    assert max(peaks[1][0]) <= 3
    assert peaks[1][1] == _solo_out(api, p, prompt, 4, prefill_chunk=4)


def test_paged_slot_reuse_after_retire(smollm):
    _, (api, p) = smollm
    srv = Server(api, p, batch=1, context=32, paged=True, page_size=8)
    prompt = list(range(1, 13))
    r1 = srv.submit(prompt, max_new=3)
    srv.run_until_drained()
    assert srv.alloc.used_pages == 0             # retire released all
    r2 = srv.submit(prompt, max_new=3)
    srv.run_until_drained()
    assert r1.out == r2.out


# ---------------------------------------------------------------------------
# share_prefix
# ---------------------------------------------------------------------------


def _shared_drain(cls, api, params, prompts, *, kv_pages=None, max_new=4,
                  **kw):
    srv = cls(api, params, batch=4, context=48, paged=True, page_size=4,
              kv_pages=kv_pages, prefill_chunk=8, **kw)
    first = srv.submit(prompts[0], max_new=max_new)
    while not first.out:
        srv.tick()                         # the source holds a written prefix
    reqs = [first] + [srv.submit(q, max_new=max_new) for q in prompts[1:]]
    srv.run_until_drained()
    return ([r.out for r in reqs], [r.shared_prefix for r in reqs],
            srv.ticks, srv.kv_stats(), srv.stats())


@pytest.mark.parametrize("kv_pages", [None, 24])
@pytest.mark.parametrize("scheduler", ["prefix", "fcfs"])
def test_shared_prefix_matches_jax_and_unshared(smollm, kv_pages, scheduler):
    """Staggered sharers of an 18-token prefix (unaligned at page size
    4): the same tokens, shares, COW copies, ticks and kv_stats as the
    JAX server, and the tokens of the port's own unshared drain."""

    (japi, jp), (api, p) = smollm
    prefix = list(range(11, 29))
    prompts = [prefix + [40 + i, 50 + i] for i in range(3)]
    kw = dict(kv_pages=kv_pages, scheduler=scheduler, share_prefix=True)
    want = _shared_drain(JaxServer, japi, jp, prompts, **kw)
    got = _shared_drain(Server, api, p, prompts, **kw)
    assert got[:4] == want[:4]
    for key in want[4]:
        assert got[4][key] == want[4][key], key
    assert got[4]["share_hits"] == 2 and got[4]["cow_copies"] == 2
    unshared = _shared_drain(Server, api, p, prompts, kv_pages=kv_pages,
                             scheduler=scheduler)
    assert unshared[4]["share_hits"] == 0
    assert got[0] == unshared[0]


@pytest.mark.parametrize("window", [None, 8])
def test_shared_prefix_under_page_pressure_matches_jax(window):
    """Five sharers through a pool of one slot's pages: sources and
    sharers are evicted by page OOM and share again on re-admission
    (with a window, the trim frees the prefix first and nothing is
    shared).  The same tokens, shares, copies, deferrals, ticks and
    kv_stats as the JAX server, and the unshared drain's tokens."""

    (japi, jp), (api, p) = _models("smollm-135m", window=window)
    prefix = list(range(11, 29))
    prompts = [prefix + [40 + i, 50 + i] for i in range(5)]
    kw = dict(kv_pages=12, scheduler="prefix", max_new=6)
    want = _shared_drain(JaxServer, japi, jp, prompts, share_prefix=True,
                         **kw)
    got = _shared_drain(Server, api, p, prompts, share_prefix=True, **kw)
    assert got[:4] == want[:4]
    for key in want[4]:
        assert got[4][key] == want[4][key], key
    assert got[4]["deferrals"] >= 1
    assert (got[4]["share_hits"] > 2) == (window is None)
    assert got[0] == _shared_drain(Server, api, p, prompts, **kw)[0]


def test_share_prefix_refusals(smollm):
    _, (api, p) = smollm
    with pytest.raises(ValueError, match="needs paged=True"):
        Server(api, p, batch=2, context=48, share_prefix=True)
    encdec = types.SimpleNamespace(cfg=api.cfg.replace(encoder_layers=2))
    with pytest.raises(ValueError, match="encoder-decoder"):
        Server(encdec, p, batch=2, context=48, paged=True, share_prefix=True)
    # the conformance monitor checks the paged allocator: contiguous
    # rings have none to check
    with pytest.raises(ValueError, match="monitor=True needs Server"):
        Server(api, p, batch=1, context=16,
               obs=Observability(monitor=True))
