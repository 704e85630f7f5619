"""The port's serving tunables against the JAX package's.

For each of ``serve.decode_batch``, ``serve.prefill_chunk``,
``serve.kv_page``, ``serve.spec_depth`` and ``serve.scheduler``, built
through the same factory with the same arguments on both sides: the
lattice, every lattice point's modeled cost (1e-12 relative), the
fingerprint, the ``grid`` pick and the ``measure`` engine's shortlist.
Both packages price against one set of platform constants, installed
into each package's ``set_platform_spec`` by the ``shared_spec`` fixture
(the reference's own defaults, and the port's H100 data-sheet defaults)
and restored after the test.  Then the drain harness's counters against
the reference's on the same prompts (reduced configs in f32, weights
carried across by ``params_from_jax``), the plan registry, the
re-exports, and the serving driver's ``--tune-*`` picks.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import calibrate as jax_calibrate  # noqa: E402
from repro import tune as jax_tune  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.serve import main as jax_serve_main  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import serve as jax_serve  # noqa: E402
from repro.runtime import speculate as jax_speculate  # noqa: E402
from repro_torch import calibrate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import serve, speculate, tunables  # noqa: E402
from repro_torch.tune import (TuningCache, TuningPlan,  # noqa: E402
                              available_tunables, build_tunable,
                              set_default_cache, tune)

NAMES = ("serve.decode_batch", "serve.prefill_chunk", "serve.kv_page",
         "serve.spec_depth", "serve.scheduler")
ARCHS = ("smollm-135m", "qwen1.5-4b")     # GQA (3 of 9 KV heads) and MHA
# (context, requests, max_new, prompt_len, batch)
LOADS = ((64, 6, 4, 20, 2), (1024, 8, 16, 512, 4), (2048, 32, 128, 300, 8))
REL = 1e-12


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


@pytest.fixture(params=["reference_defaults", "port_defaults"])
def shared_spec(request):
    """One constants dict installed into both packages: the JAX
    package's own defaults (here only as shared input to the
    comparison) or the port's H100 data-sheet ones."""

    src = (jax_calibrate.DEFAULT_SPEC if request.param == "reference_defaults"
           else calibrate.DEFAULT_SPEC).constants()
    jprev = jax_calibrate.set_platform_spec(
        jax_calibrate.PlatformSpec(**src))
    prev = calibrate.set_platform_spec(calibrate.PlatformSpec(**src))
    try:
        yield src
    finally:
        jax_calibrate.set_platform_spec(jprev)
        calibrate.set_platform_spec(prev)


_APIS: dict = {}


def _apis(arch: str, full: bool):
    """(reference api, port api) of ``arch``, full width or reduced:
    specs only, no weights (the costs read shapes and parameter
    counts)."""

    key = (arch, full)
    if key not in _APIS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if not full:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        _APIS[key] = (jax_build_model(jcfg), build_model(cfg))
    return _APIS[key]


_REF = types.SimpleNamespace(
    decode_batch_tunable=jax_serve.decode_batch_tunable,
    prefill_chunk_tunable=jax_serve.prefill_chunk_tunable,
    kv_page_tunable=jax_serve.kv_page_tunable,
    scheduler_tunable=jax_serve.scheduler_tunable,
    spec_depth_tunable=jax_speculate.spec_depth_tunable)
_PORT = types.SimpleNamespace(
    decode_batch_tunable=tunables.decode_batch_tunable,
    prefill_chunk_tunable=tunables.prefill_chunk_tunable,
    kv_page_tunable=tunables.kv_page_tunable,
    scheduler_tunable=tunables.scheduler_tunable,
    spec_depth_tunable=speculate.spec_depth_tunable)


def _build(ns, name, api, load, **kw):
    context, requests, max_new, prompt_len, batch = load
    if name == "serve.decode_batch":
        return ns.decode_batch_tunable(api, context=context,
                                       requests=requests, max_new=max_new,
                                       **kw)
    if name == "serve.prefill_chunk":
        return ns.prefill_chunk_tunable(api, context=context,
                                        prompt_len=prompt_len,
                                        requests=requests, max_new=max_new,
                                        batch=batch, **kw)
    if name == "serve.kv_page":
        return ns.kv_page_tunable(api, context=context,
                                  prompt_lens=[prompt_len // 3, prompt_len],
                                  requests=requests, max_new=max_new,
                                  batch=batch,
                                  pool_tokens=context * batch // 2, **kw)
    if name == "serve.spec_depth":
        return ns.spec_depth_tunable(api, context=context,
                                     prompt_len=prompt_len,
                                     requests=requests, max_new=max_new,
                                     batch=batch, **kw)
    return ns.scheduler_tunable(api, context=context, batch=batch,
                                requests=requests, page_size=16,
                                prefill_chunk=max(8, context // 8),
                                kv_pages=context * batch // 32,
                                prompt_len=(max(2, prompt_len // 2),
                                            prompt_len),
                                max_new=(max(1, max_new // 2), max_new),
                                prefix_len=prompt_len // 2, **kw)


def _pair(name, arch, load, full=False):
    japi, api = _apis(arch, full)
    return _build(_REF, name, japi, load), _build(_PORT, name, api, load)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("load", LOADS, ids=lambda ld: f"ctx{ld[0]}")
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", NAMES)
def test_space_cost_fingerprint_match_reference(name, arch, load,
                                                shared_spec):
    for full in (False, True):
        want, got = _pair(name, arch, load, full)
        space = list(got.space())
        assert space == list(want.space())
        for cfg in space:
            assert _close(got.cost(cfg), want.cost(cfg)), (cfg,
                                                           got.cost(cfg),
                                                           want.cost(cfg))
        assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", NAMES)
def test_grid_pick_matches_reference(name, arch, shared_spec):
    want, got = _pair(name, arch, LOADS[1], full=True)
    jres = jax_tune.tune(want, engine="grid", cache=None)
    res = tune(got, engine="grid", cache=None)
    assert res.best_config == jres.best_config
    assert _close(res.t_min, jres.t_min)


class _Shortlist:
    """A tunable's lattice and costs, with a ``measure`` that drains
    nothing and records what the engine asked for."""

    def __init__(self, inner):
        self.inner, self.name, self.asked = inner, inner.name, []

    def space(self):
        return self.inner.space()

    def cost(self, cfg):
        return self.inner.cost(cfg)

    def fingerprint(self):
        return self.inner.fingerprint()

    def measure(self, cfg, *, warmup=1, iters=1):
        self.asked.append(dict(cfg))
        return float(len(self.asked))


@pytest.mark.parametrize("name", NAMES)
def test_measure_shortlist_matches_reference(name, shared_spec):
    want, got = (_Shortlist(t) for t in _pair(name, "smollm-135m",
                                              LOADS[2], full=True))
    jres = jax_tune.tune(want, engine="measure", cache=None, top_k=3,
                         repeats=2)
    res = tune(got, engine="measure", cache=None, top_k=3, repeats=2)
    assert got.asked == want.asked and len(got.asked) == 6
    for a, b in zip(res.stats["candidates"], jres.stats["candidates"]):
        assert a["config"] == b["config"]
        assert _close(a["modeled"], b["modeled"])
    assert res.stats["modeled_pick"]["config"] == \
        jres.stats["modeled_pick"]["config"]
    assert res.best_config == jres.best_config


@pytest.mark.parametrize("name", NAMES[:4])
def test_measure_without_a_model_raises_as_reference(name):
    want, got = _pair(name, "smollm-135m", LOADS[0])
    cfg = next(iter(got.space()))
    with pytest.raises(RuntimeError) as jexc:
        want.measure(cfg)
    with pytest.raises(RuntimeError, match="needs the model attached") as exc:
        got.measure(cfg)
    assert str(exc.value) == str(jexc.value)


# ---------------------------------------------------------------------------
# the drain harness on the CPU, against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smollm():
    jcfg = jax_get_config("smollm-135m").reduced().replace(
        logits_dtype="float32")
    japi = jax_build_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      japi.init(jax.random.PRNGKey(0)))
    api = build_model(get_config("smollm-135m").reduced().replace(
        logits_dtype="float32"))
    return (japi, jp), (api, params_from_jax(jax.tree.map(np.asarray, jp),
                                             "cpu"))


@pytest.mark.parametrize("mode", [
    {}, {"paged": True, "page_size": 4, "kv_pages": 12},
    {"speculate": "ngram", "spec_depth": 3}], ids=["contiguous", "paged",
                                                   "ngram"])
def test_timed_server_drain_counters_match_reference(smollm, mode):
    (japi, jp), (api, p) = smollm
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, 50, int(n))]
               for n in rng.integers(3, 14, 5)]
    prompts[0] = [7, 8, 9] * 4          # something for the n-gram drafter
    kw = dict(batch=2, context=32, prompts=prompts, max_new=5,
              prefill_chunk=4, warmup=0, iters=1, **mode)
    want, got = {}, {}
    jax_serve.timed_server_drain(japi, jp, stats_out=want, **kw)
    us = serve.timed_server_drain(api, p, stats_out=got, **kw)
    assert us > 0
    # the port's Server also reports its peak of used pages
    assert set(got) - set(want) == {"peak_used_pages"}
    assert {k: got[k] for k in want} == want
    assert got["tokens_generated"] == 5 * len(prompts)


def test_choose_batch_measures_on_the_cpu_then_hits(smollm, tmp_path):
    _, (api, p) = smollm
    cache = TuningCache(tmp_path / "batch.json")
    kw = dict(context=32, requests=3, max_new=3, params=p, cache=cache,
              engine="measure", top_k=2, repeats=1)
    batch, res = tunables.choose_batch(api, **kw)
    assert res.stats["provenance"] == "measured"
    shortlist = [c["config"]["batch"] for c in res.stats["candidates"]]
    assert batch in shortlist and len(shortlist) == 2
    again, res2 = serve.choose_batch(api, **kw)
    assert again == batch and res2.stats["cache"] == "hit"


def test_scheduler_from_the_registry_measures_on_the_cpu(tmp_path):
    """JSON-only params (lists), ``device="cpu"``: the tunable builds
    its own reduced f32 model and drains the seeded trace; the device
    enters the fingerprint only when set, and a plan over the same spec
    is a pure cache hit."""

    params = {"arch": "smollm-135m", "context": 48, "batch": 2,
              "page_size": 8, "prefill_chunk": 8, "requests": 4,
              "burst": 2, "burst_every": 4, "prompt_len": [4, 8],
              "max_new": [2, 3], "prefix_len": 8, "age_limits": [4],
              "device": "cpu"}
    tb = build_tunable("serve.scheduler", params)
    assert tb.prompt_len == (4, 8) and tb.age_limits == (4,)
    fp = tb.fingerprint()
    assert fp["device"] == "cpu"
    without = {k: v for k, v in params.items() if k != "device"}
    assert "device" not in build_tunable("serve.scheduler",
                                         without).fingerprint()
    assert build_tunable("serve.scheduler", without).fingerprint() == \
        jax_serve.SchedulerTunable(**without).fingerprint()
    cache = TuningCache(tmp_path / "sched.json")
    res = tune(tb, engine="measure", cache=cache, top_k=1, repeats=1)
    assert res.stats["provenance"] == "measured"
    assert tb.last_stats["goodput_tokens"] > 0
    assert len(tb.last_stats["records"]) == 4
    spec = {"name": "sched", "jobs": [
        {"tunable": "serve.scheduler", "params": params,
         "engine": "measure", "engine_kwargs": {"top_k": 1, "repeats": 1}}]}
    report = TuningPlan.from_spec(spec).run(cache=cache)
    assert report.ok and report.results[0].status == "hit"
    assert report.results[0].best_config == dict(res.best_config)


def test_serving_tunables_are_registered():
    assert set(NAMES) <= set(available_tunables())
    assert build_tunable("serve.decode_batch", {
        "param_bytes": 1 << 20, "layers": 2, "d_model": 64, "context": 32,
        "requests": 2, "mean_new": 2}).fingerprint()["tunable"] == \
        "serve.decode_batch"


def test_tunables_reexported_from_runtime_serve():
    for name in ("DecodeBatchTunable", "PrefillChunkTunable",
                 "KVPageTunable", "SchedulerTunable", "timed_server_drain",
                 "timed_trace_drain", "kv_cache_stream_s",
                 "decode_batch_tunable", "prefill_chunk_tunable",
                 "kv_page_tunable", "scheduler_tunable", "choose_batch",
                 "choose_prefill_chunk", "choose_kv_page",
                 "choose_scheduler", "K_AND_V", "KV_CACHE_BYTES"):
        assert getattr(serve, name) is getattr(tunables, name)
        assert hasattr(jax_serve, name)
    from repro_torch import runtime
    assert runtime.SpecDepthTunable is speculate.SpecDepthTunable


def test_serve_driver_tune_flags_pick_as_reference(capsys, tmp_path):
    """``--tune-batch --tune-prefill --tune-page --tune-spec
    --tune-scheduler`` under ``--tune-engine grid``: each ``[tune]`` line
    of the port's driver (on the CPU) equals the reference's, picks and
    modeled drains included, under the same installed constants."""

    src = jax_calibrate.DEFAULT_SPEC.constants()
    jprev_spec = jax_calibrate.set_platform_spec(
        jax_calibrate.PlatformSpec(**src))
    prev_spec = calibrate.set_platform_spec(calibrate.PlatformSpec(**src))
    jprev_cache = jax_tune.set_default_cache(
        jax_tune.TuningCache(tmp_path / "jax.json"))
    argv = ["--arch", "smollm-135m", "--preset", "smoke", "--requests", "3",
            "--batch", "2", "--context", "64", "--prompt-len", "20",
            "--max-new", "4", "--tune-batch", "--tune-prefill",
            "--tune-page", "--tune-spec", "--tune-scheduler",
            "--tune-engine", "grid"]
    try:
        jax_serve_main(argv)
        want = capsys.readouterr().out
        serve_main(argv + ["--device", "cpu"])
        got = capsys.readouterr().out
    finally:
        jax_calibrate.set_platform_spec(jprev_spec)
        calibrate.set_platform_spec(prev_spec)
        jax_tune.set_default_cache(jprev_cache)

    def tune_lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("[tune]")]

    assert len(tune_lines(got)) == 5
    assert tune_lines(got) == tune_lines(want)
    assert "served 3 requests / 12 tokens" in got
