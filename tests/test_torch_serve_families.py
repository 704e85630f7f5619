"""The port's ``Server`` over the other model families, against the JAX
package's ``Server`` and against its own offline ``forward``.

Reduced configs in f32 (weights from the JAX package's ``init_params``,
crossed by ``params_from_jax``), requests made with numpy from a seed and
submitted to both servers: every request must get the same tokens and
the drain the same tick count, contiguous and paged (paging does not
apply to mamba2, which has no attention state).  Whisper's requests
carry frames; a reused slot's recurrent state is reset; ``share_prefix``
is refused for state it cannot share; hymba speculates with the n-gram
and the self-draft drafter.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.serve import Server as JaxServer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402
from repro_torch.runtime.speculate import DraftModelDrafter  # noqa: E402
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402

FAMILIES = ["mamba2-2.7b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
            "llama-3.2-vision-90b", "hymba-1.5b", "whisper-medium"]


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


_MODELS: dict = {}


def _models(name):
    """(JAX api, params), (port api, params): f32 weights from seed 0,
    shared by the tests of this file."""

    if name not in _MODELS:
        jcfg = jax_get_config(name).reduced().replace(logits_dtype="float32")
        cfg = get_config(name).reduced().replace(logits_dtype="float32")
        japi = jax_build_model(jcfg)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                          japi.init(jax.random.PRNGKey(0)))
        _MODELS[name] = ((japi, jp), (build_model(cfg), params_from_jax(
            jax.tree.map(np.asarray, jp), "cpu")))
    return _MODELS[name]


def _frames(cfg, n, seed=5):
    """One (enc_seq, d_model) frame array a request for enc-dec models,
    None for the others."""

    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((cfg.enc_seq, cfg.d_model)) * 0.3
             ).astype(np.float32) if cfg.is_encdec else None
            for _ in range(n)]


def _drain(server_cls, api, params, *, seed=1, **kw):
    """Four requests, three ticks, one more (staggered admissions, so
    slots are reused mid-drain)."""

    srv = server_cls(api, params, batch=2, context=40, prefill_chunk=4,
                     **kw)
    rng = np.random.default_rng(seed)
    frames = _frames(api.cfg, 5)
    reqs = [srv.submit(rng.integers(0, api.cfg.vocab, int(rng.integers(3, 14))
                                    ).tolist(),
                       max_new=int(rng.integers(2, 7)), frames=frames[i])
            for i in range(4)]
    for _ in range(3):
        srv.tick()
    reqs.append(srv.submit(rng.integers(0, api.cfg.vocab, 9).tolist(),
                           max_new=5, frames=frames[4]))
    srv.run_until_drained()
    return [r.out for r in reqs], srv.ticks


@pytest.mark.parametrize("name,paged", [(n, False) for n in FAMILIES] +
                         [(n, True) for n in FAMILIES if n != "mamba2-2.7b"])
def test_server_matches_jax_server(name, paged):
    (japi, jp), (api, p) = _models(name)
    kw = dict(paged=True, page_size=4) if paged else {}
    want = _drain(JaxServer, japi, jp, **kw)
    got = _drain(Server, api, p, **kw)
    assert got == want


@pytest.mark.parametrize("name", ["hymba-1.5b", "mamba2-2.7b"])
def test_server_greedy_matches_offline_forward(name):
    """The Server's recurrence against the offline chunked scan: a
    request in a reused slot (its predecessor's state reset) gives the
    offline greedy continuation."""

    _, (api, p) = _models(name)
    rng = np.random.default_rng(3)
    first = rng.integers(0, api.cfg.vocab, 11).tolist()
    prompt = rng.integers(0, api.cfg.vocab, 6).tolist()
    server = Server(api, p, batch=1, context=32, prefill_chunk=4)
    server.submit(first, max_new=5)
    req = server.submit(prompt, max_new=4)
    server.run_until_drained()

    toks = list(prompt)
    for _ in range(4):
        logits = api.forward(p, {"tokens": torch.tensor([toks])})
        toks.append(int(torch.argmax(logits[0, -1])))
    assert req.out == toks[len(prompt):]


def test_encdec_server_matches_offline_forward():
    """Whisper: the encoder runs at admission, the decoder cross-attends
    the request's frames; the tokens are the offline enc-dec greedy's."""

    _, (api, p) = _models("whisper-medium")
    frames = _frames(api.cfg, 2, seed=7)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, api.cfg.vocab, 5).tolist() for _ in range(2)]
    server = Server(api, p, batch=1, context=24)
    reqs = [server.submit(q, max_new=3, frames=f)
            for q, f in zip(prompts, frames)]
    server.run_until_drained()
    for req, q, f in zip(reqs, prompts, frames):
        toks = list(q)
        for _ in range(3):
            logits = api.forward(p, {"tokens": torch.tensor([toks]),
                                     "frames": torch.from_numpy(f)[None]})
            toks.append(int(torch.argmax(logits[0, -1])))
        assert req.done and req.out == toks[len(q):]
    # the last request's cross K/V fills the slot; the rest of the state
    # tree is untouched by the encoder
    kv = api.encode_cross_kv(p, torch.from_numpy(frames[1])[None])
    for name in ("k", "v"):
        assert torch.equal(server.state["xattn"][name][:, 0],
                           kv[name][:, 0].to(torch.bfloat16))


def test_reused_slot_resets_only_its_recurrent_state():
    _, (api, p) = _models("hymba-1.5b")
    server = Server(api, p, batch=2, context=32, prefill_chunk=4)
    a = server.submit([5, 6, 7, 8, 9], max_new=2)
    b = server.submit([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], max_new=6)
    while not a.done:
        server.tick()
    assert server._slot_dirty[0] and not b.done
    entry = server.state["blocks"]["0_hybrid"]
    before = {k: v.clone() for k, v in entry["ssm"].items()}
    kv_before = {k: v.clone() for k, v in entry["kv"].items()}
    assert bool(before["h"][:, 0].any()) and bool(before["h"][:, 1].any())
    server.submit([4, 4, 4], max_new=2)
    server._admit()                    # places the request into slot 0
    assert not server._slot_dirty[0]
    for k, v in entry["ssm"].items():
        assert not v[:, 0].any()                       # reset
        assert torch.equal(v[:, 1], before[k][:, 1])   # neighbour kept
    for k, v in entry["kv"].items():
        assert torch.equal(v, kv_before[k])            # rings untouched
    server.run_until_drained()


def test_share_prefix_refusals():
    for name in ("hymba-1.5b", "mamba2-2.7b", "llama-3.2-vision-90b"):
        _, (api, p) = _models(name)
        with pytest.raises(ValueError, match="pure-attention decode state"):
            Server(api, p, batch=2, context=32, paged=True,
                   share_prefix=True)
    _, (api, p) = _models("whisper-medium")
    with pytest.raises(ValueError, match="encoder-decoder"):
        Server(api, p, batch=2, context=32, paged=True, share_prefix=True)
    # an MoE stack holds only K/V: it shares
    _, (api, p) = _models("mixtral-8x22b")
    server = Server(api, p, batch=2, context=32, paged=True, page_size=4,
                    share_prefix=True)
    prefix = list(range(1, 9))
    reqs = [server.submit(prefix + [20 + i], max_new=2) for i in range(2)]
    server.tick()
    server.run_until_drained()
    assert all(r.done for r in reqs)


def test_self_draft_is_refused_for_encdec():
    _, (api, p) = _models("whisper-medium")
    with pytest.raises(ValueError, match="enc-dec forwards need frames"):
        DraftModelDrafter(api, p)
    with pytest.raises(ValueError, match="enc-dec forwards need frames"):
        Server(api, p, batch=1, context=24, speculate="draft")


_PROMPTS = [[3, 4, 5] * 3, [7, 8] * 4, [9, 9, 1, 2] * 2]


def _spec_drain(cls, api, params, **kw):
    srv = cls(api, params, batch=2, context=32, prefill_chunk=4, **kw)
    reqs = [srv.submit(_PROMPTS[0], max_new=6)]
    for _ in range(2):
        srv.tick()            # the first request mid-prefill when the rest land
    reqs += [srv.submit(q, max_new=6) for q in _PROMPTS[1:]]
    srv.run_until_drained()
    st = srv.stats()
    return ([r.out for r in reqs],
            {k: st[k] for k in ("ticks", "spec_ticks", "spec_proposed",
                                "spec_accepted")})


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("speculate", ["ngram", "draft"])
def test_hymba_speculation_matches_jax_and_the_plain_drain(paged, speculate):
    """Speculation on the hybrid stack: the verifier's recurrence runs on
    its own tensors, the length-gated commit advances the state by the
    accepted tokens only; the tokens are the plain drain's and the JAX
    speculative drain's, with the same counters."""

    (japi, jp), (api, p) = _models("hymba-1.5b")
    pk = dict(paged=True, page_size=4) if paged else {}
    base, _ = _spec_drain(Server, api, p, **pk)
    kw = dict(speculate=speculate, spec_depth=3, **pk)
    got = _spec_drain(Server, api, p, **kw)
    assert got[0] == base
    assert got == _spec_drain(JaxServer, japi, jp, **kw)
    if speculate == "draft":
        assert got[1]["spec_accepted"] == got[1]["spec_proposed"] > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_launch_serve_every_family_on_the_cpu(capsys, name):
    """``--arch`` reaches every config, as the reference's driver (no
    frames: an enc-dec request decodes against zero cross K/V)."""

    serve_main(["--arch", name, "--preset", "smoke", "--requests", "3",
                "--batch", "2", "--context", "32", "--prompt-len", "8",
                "--max-new", "3", "--prefill-chunk", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"model {name} (smoke)" in out
    assert "served 3 requests / 9 tokens" in out
