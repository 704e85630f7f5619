"""The port's ``Server`` against the JAX package's, and against its own
offline ``forward``.

Reduced configs in f32 (weights from the JAX package's ``init_params``,
crossed by ``params_from_jax``), requests made with numpy from a seed and
submitted to both servers: every request must get the same tokens, and
the drain the same tick count (tick counts depend only on the scheduler
and the greedy tokens).
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
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402
from repro_torch.tune import TuningCache, set_default_cache  # noqa: E402


@pytest.fixture(autouse=True)
def _port_cache(tmp_path):
    prev = set_default_cache(TuningCache(tmp_path / "cache.json"))
    yield
    set_default_cache(prev)


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


def _drain(server_cls, api, params, *, batch, context, chunk, seed,
           vocab, scheduler=None):
    """Four requests, three ticks, two more (staggered admissions)."""

    kw = {} if scheduler is None else {"scheduler": scheduler}
    srv = server_cls(api, params, batch=batch, context=context,
                     prefill_chunk=chunk, **kw)
    rng = np.random.default_rng(seed)
    reqs = [srv.submit(rng.integers(0, vocab, int(rng.integers(3, 20))
                                    ).tolist(),
                       max_new=int(rng.integers(2, 8)),
                       slo=("batch", "interactive")[i % 2])
            for i in range(4)]
    for _ in range(3):
        srv.tick()
    reqs += [srv.submit(rng.integers(0, vocab, 9).tolist(), max_new=5,
                        slo="interactive") for _ in range(2)]
    srv.run_until_drained()
    return [r.out for r in reqs], srv.ticks


@pytest.mark.parametrize("name,window,batch", [
    ("smollm-135m", None, 3), ("qwen1.5-4b", None, 2), ("smollm-135m", 8, 3)])
@pytest.mark.parametrize("chunk", [4, 32])
def test_server_matches_jax_server(name, window, batch, chunk):
    (japi, jp), (api, p) = _models(name, window=window)
    kw = dict(batch=batch, context=48, chunk=chunk, seed=1,
              vocab=api.cfg.vocab)
    want = _drain(JaxServer, japi, jp, **kw)
    got = _drain(Server, api, p, **kw)
    assert got == want


def test_priority_preemption_matches_jax_server():
    (japi, jp), (api, p) = _models("smollm-135m")
    kw = dict(batch=2, context=48, chunk=4, seed=2, vocab=api.cfg.vocab,
              scheduler="priority")
    want = _drain(JaxServer, japi, jp, **kw)
    got = _drain(Server, api, p, **kw)
    assert got == want


def test_server_greedy_matches_offline_forward():
    """A single request must reproduce the offline greedy continuation
    of repeated full forwards."""

    _, (api, p) = _models("qwen1.5-4b")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, api.cfg.vocab, 6).tolist()
    server = Server(api, p, batch=1, context=32)
    req = server.submit(prompt, max_new=4)
    server.run_until_drained()

    toks = list(prompt)
    for _ in range(4):
        logits = api.forward(p, {"tokens": torch.tensor([toks],
                                                        dtype=torch.int32)})
        toks.append(int(torch.argmax(logits[0, -1])))
    assert req.out == toks[len(prompt):]
    st = server.stats()
    assert st["ticks"] == server.ticks and st["tokens_generated"] == 4


def test_server_greedy_on_a_padded_flash_forward():
    """The chip check's offline loop: tokens padded right to a multiple
    of 128 take the flash gate, and causal masking makes the padding
    inert, so the logit at the last real token is the server's."""

    _, (api, p) = _models("qwen1.5-4b")
    assert api.cfg.use_flash
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, api.cfg.vocab, 20).tolist()
    server = Server(api, p, batch=2, context=64, prefill_chunk=8)
    req = server.submit(prompt, max_new=3)
    server.run_until_drained()
    toks = list(prompt)
    for _ in range(3):
        padded = toks + [0] * (-len(toks) % 128)
        logits = api.forward(p, {"tokens": torch.tensor([padded])})
        toks.append(int(torch.argmax(logits[0, len(toks) - 1])))
    assert req.out == toks[len(prompt):]


def test_submit_rejections():
    _, (api, p) = _models("smollm-135m")
    server = Server(api, p, batch=1, context=16)
    with pytest.raises(ValueError, match="empty prompt"):
        server.submit([], max_new=4)
    with pytest.raises(ValueError, match="context - max_new"):
        server.submit([1] * 13, max_new=4)
    with pytest.raises(ValueError, match="max_new"):
        server.submit([1, 2], max_new=0)
    req = server.submit([1] * 12, max_new=4)    # boundary case is fine
    server.run_until_drained()
    assert req.done and len(req.prompt) + len(req.out) <= 16


@pytest.mark.parametrize("flag", [{"obs": {"monitor": True}}])
def test_unported_options_raise(flag):
    """``obs=`` is ported; what a contiguous ``Server`` still refuses is
    the conformance monitor, which checks a paged allocator's ops."""

    _, (api, p) = _models("smollm-135m")
    with pytest.raises(ValueError, match="needs Server\\(paged=True\\)"):
        Server(api, p, batch=1, context=16,
               obs=Observability(**flag["obs"]))


@pytest.mark.parametrize("flags", [
    [], ["--paged", "--share-prefix", "--speculate", "ngram"]])
def test_launch_serve_on_the_cpu(capsys, flags):
    serve_main(["--arch", "qwen1.5-4b", "--preset", "smoke", "--requests",
                "3", "--batch", "2", "--context", "48", "--prompt-len",
                "10", "--max-new", "3", "--prefill-chunk", "4",
                "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
    if flags:
        assert "paged: peak" in out and "speculate (ngram, depth 4)" in out


def _driver(capsys, flags):
    serve_main(["--arch", "qwen1.5-4b", "--preset", "smoke", "--requests",
                "3", "--batch", "2", "--context", "48", "--prompt-len",
                "10", "--max-new", "3", "--prefill-chunk", "4",
                "--device", "cpu"] + flags)
    return capsys.readouterr().out


@pytest.mark.parametrize("policy", ["fcfs", "priority", "prefix"])
def test_launch_serve_scheduler_flag(capsys, policy):
    """``--scheduler`` reaches the Server and prints the reference's
    ``scheduler:`` line."""

    out = _driver(capsys, ["--scheduler", policy])
    assert "served 3 requests / 9 tokens" in out
    assert f"scheduler: policy={policy} preemptions=0" in out


def test_launch_serve_trace_metrics_profile(capsys, tmp_path):
    """``--trace``/``--metrics``/``--profile`` attach a bundle (with the
    monitor on a paged server) and print the reference's trace, monitor,
    phase-profile and Prometheus lines; the document passes ``check``."""

    from repro_torch.obs.cli import main as obs_main
    path = tmp_path / "trace.json"
    out = _driver(capsys, ["--paged", "--scheduler", "priority", "--trace",
                           str(path), "--metrics", "--profile"])
    assert "served 3 requests / 9 tokens" in out
    assert "  trace: " in out and f"-> {path} (open in" in out
    assert "  conformance monitor: accepted (" in out
    assert "phase profile (" in out and "  host " in out
    assert "# TYPE serve_retired counter" in out
    assert "serve_retired 3" in out
    assert obs_main(["check", str(path)]) == 0
    assert "OK" in capsys.readouterr().out


def test_launch_serve_metrics_alone_skips_the_trace(capsys):
    out = _driver(capsys, ["--metrics"])
    assert "trace:" not in out and "conformance monitor" not in out
    assert "phase profile" not in out
    assert "serve_tokens_out 9" in out
