"""The paged ``Server``'s prefill step over the prefilling rows alone.

* ``prefill_step`` over a subset of a mixed batch's rows (a row of
  length 0 among them, rows starting mid-page, out of slot order) gives
  those rows' logits of the full padded step and writes the same pool
  pages, on a shuffled page layout with random pool contents: reduced
  qwen1.5-4b and mixtral (MoE, sliding window) in f32.
* What the Server hands ``prefill_step``: a paged Server whose state is
  the shared pools alone gets exactly the prefilling slots' rows while
  the others decode (staggered admissions, a shared prefix, preemption
  under page pressure; reduced qwen1.5-4b and llama4-maverick, MoE),
  with the JAX ``Server``'s tokens; a Server with
  per-slot state (SSM, cross K/V, enc-dec, contiguous rings) gets the
  whole batch, as before.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_row_spy import PrefillRowSpy  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.serve import Server as JaxServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402
from repro_torch.runtime.kv import NO_PAGE, PagedKVSpec  # noqa: E402

# a mixed batch of five slots at page size 4, chunk 8: positions (three
# start mid-page) and the chunk lengths of the slots that prefill
POS = np.array([0, 6, 3, 13, 9], np.int32)
LEN = np.array([5, 0, 8, 0, 3], np.int32)
CONTEXT, PAGE, T = 32, 4, 8


def _port(name):
    cfg = get_config(name).reduced().replace(logits_dtype="float32")
    api = build_model(cfg)
    return api, tree_map(lambda t: t.float(), api.init(0, "cpu"))


def _pool_state(api, rng):
    """Pools of random contents, and a page table whose slots hold
    shuffled pages covering their written positions and this chunk."""

    B = len(POS)
    spec = PagedKVSpec.for_server(context=CONTEXT, page_size=PAGE,
                                  batch=B)
    state = api.init_decode_state(B, CONTEXT, spec, dtype=torch.float32,
                                  device="cpu")
    state = tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), state)
    table = np.full((B, spec.pages_per_slot), NO_PAGE, np.int32)
    free = iter(rng.permutation(spec.n_pages).tolist())
    for s in range(B):
        for j in range(-(-int(POS[s] + LEN[s]) // PAGE)):
            table[s, j] = next(free)
    return state, table


@pytest.mark.parametrize("rows", [[0, 2, 4], [4, 1, 2], [3]])
@pytest.mark.parametrize("name", ["qwen1.5-4b", "mixtral-8x22b"])
def test_prefill_step_over_some_rows_equals_the_padded_step(name, rows):
    """Rows ``rows`` of the batch alone against all five rows with every
    other row at length 0 (as the Server pads them): the same logits for
    each handed row, a length-0 row's included, and the same pools,
    written only in the handed rows' pages.  Within 1e-6, not bit for
    bit: the CPU's f32 products block by the row count."""

    api, params = _port(name)
    rng = np.random.default_rng(3)
    state, table = _pool_state(api, rng)
    tokens = rng.integers(0, api.cfg.vocab, (len(POS), T)).astype(np.int32)
    lengths = np.zeros_like(LEN)
    lengths[rows] = LEN[rows]
    t = torch.from_numpy
    with torch.inference_mode():
        full_state = tree_map(torch.clone, state)
        full, full_state = api.prefill_step(
            params, full_state, t(tokens), t(POS), t(lengths), t(table))
        some_state = tree_map(torch.clone, state)
        some, some_state = api.prefill_step(
            params, some_state, t(tokens[rows]), t(POS[rows]),
            t(lengths[rows]), t(table[rows]))
    torch.testing.assert_close(some, full[rows], rtol=1e-6, atol=1e-6)
    for got, want in zip(tree_leaves(some_state), tree_leaves(full_state)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # nothing but the handed rows' pages was written
    written = {int(p) for p in table[rows].ravel() if p != NO_PAGE}
    for got, was in zip(tree_leaves(some_state), tree_leaves(state)):
        others = [p for p in range(got.shape[1]) if p not in written]
        assert torch.equal(got[:, others], was[:, others])
    assert any(not torch.equal(got, was) for got, was in
               zip(tree_leaves(some_state), tree_leaves(state))) \
        == bool(LEN[rows].any())


def _models(name):
    jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32")
    japi = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      japi.init(jax.random.PRNGKey(0)))
    cfg = get_config(name).reduced().replace(logits_dtype="float32")
    return (japi, jp), (build_model(cfg),
                        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))


def _mixed_drain(server_cls, api, params, spy=None):
    """Four slots, page pressure, a shared 10-token prefix: two
    requests, then two sharers while those decode, then two more; the
    youngest is preempted when the pool runs out."""

    srv = server_cls(api if spy is None else spy, params, batch=4,
                     context=48, prefill_chunk=4, paged=True, page_size=4,
                     kv_pages=14, share_prefix=True, scheduler="prefix")
    if spy is not None:
        spy.server = srv
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, api.cfg.vocab, 10).tolist()
    prompts = [prefix + rng.integers(1, api.cfg.vocab, n).tolist()
               for n in (3, 9, 2, 6, 11, 4)]
    reqs = []
    for wave in (prompts[:2], prompts[2:4], prompts[4:]):
        reqs += [srv.submit(q, max_new=8) for q in wave]
        for _ in range(4):
            srv.tick()
    srv.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs], srv.ticks, srv.stats()


@pytest.mark.parametrize("name", ["qwen1.5-4b",
                                  "llama4-maverick-400b-a17b"])
def test_paged_server_hands_prefill_only_the_prefilling_rows(name):
    (japi, jp), (api, p) = _models(name)
    spy = PrefillRowSpy(api)
    got = _mixed_drain(Server, api, p, spy)
    want = _mixed_drain(JaxServer, japi, jp)
    assert got[:2] == want[:2]
    for key in ("deferrals", "share_hits", "shared_tokens", "cow_copies"):
        assert got[2][key] == want[2][key], key
    spy.assert_prefilling_rows_only()
    # the drain had what it is for: sharing, preemption, and ticks where
    # one or two slots prefill while the others decode
    assert got[2]["share_hits"] >= 1 and got[2]["deferrals"] >= 1
    mixed = [c["rows"] for c in spy.calls if c["decoding"]]
    assert 1 in mixed and 2 in mixed


@pytest.mark.parametrize("name,paged", [
    ("hymba-1.5b", True), ("llama-3.2-vision-90b", True),
    ("whisper-medium", True), ("mamba2-2.7b", False),
    ("qwen1.5-4b", False)])
def test_server_with_per_slot_state_hands_prefill_the_whole_batch(name,
                                                                  paged):
    """SSM state, cross K/V, an encoder's K/V or contiguous rings: the
    step gets every slot's row, the others at length 0."""

    api, params = _port(name)
    spy = PrefillRowSpy(api)
    kw = dict(paged=True, page_size=4) if paged else {}
    srv = Server(spy, params, batch=3, context=40, prefill_chunk=4, **kw)
    spy.server = srv
    rng = np.random.default_rng(2)
    frames = [(rng.standard_normal((api.cfg.enc_seq, api.cfg.d_model))
               * 0.3).astype(np.float32) if api.cfg.is_encdec else None
              for _ in range(4)]
    reqs = [srv.submit(rng.integers(0, api.cfg.vocab, n).tolist(),
                       max_new=4, frames=f)
            for n, f in zip((5, 11, 3), frames)]
    for _ in range(2):
        srv.tick()
    reqs.append(srv.submit(rng.integers(0, api.cfg.vocab, 9).tolist(),
                           max_new=3, frames=frames[3]))
    with torch.inference_mode():
        srv.run_until_drained()
    assert all(r.done for r in reqs)
    spy.assert_whole_batch()
    assert any(c["decoding"] for c in spy.calls)
