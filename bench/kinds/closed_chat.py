"""``closed_chat``: a closed loop of chat clients against the program's
``Server``, one client per slot, each sending its next request as soon
as its previous one completes.

The mix file gives the clients, the lognormal prompt and output lengths
with their clips, the shared system prompt and the share of requests
that open with it.  Every seed serves the same work: the sizes of round
``k`` (each client's ``k``-th request) are drawn from the mix's
``size_seed`` and ``k``, and ``--seed`` only deals the rounds' columns
to the clients in another order and draws the token ids.

The window opens on a loop already in its steady state, not on every
client's first request sent at once.  Each client starts with the request it would
have in flight at a random moment of a long run (round 0): a request
picked with odds in proportion to its output length, part of whose
output is already written (it is prefilled with its prompt) and the rest
still to come.  Set-up ticks the loop until every such request has its
first token, clients whose request completes sending their next one as
in the window; then the window opens.

Times are the host's clock.  A request sent in the window counts its
time to first token from its send to the return of the tick that made
its first token; one with none by the window's end counts at its wait so
far.  Gaps between tokens are between the returns of the ticks that
made them, for every token made in the window.

``correct``: once the window has closed, a sample drawn from the seed of
the finished requests, the longest among them and both kinds (with and
without the system prompt), is run through the float32 reference over
its prompt and served tokens, and the widest gap by which a served
token's logit lies below the reference's best must stay within the
cell's limit.  With ``run.info["control"]`` the fp8 reference stands in
the program's place: the gap judged is that of the token it puts first
at each of those positions, and the program's own gap is kept in
``run.info["program_gap"]``.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench import flops, model, stats
from bench.reference import decoder
from bench.trace import profiled

# round 0 picks each client's request in flight from this many
# candidates a client, with odds in proportion to their output lengths
IN_FLIGHT_CANDIDATES = 8


@dataclass
class Spec:
    prompt: list[int]
    max_new: int
    shared: bool


@dataclass
class Sent:
    spec: Spec
    req: object
    t_send: float
    client: int = 0
    times: list[float] = field(default_factory=list)
    cursor0: int | None = None  # positions forwarded as the window opens
    out0: int = 0               # tokens served as the window opens


def _lognormal(rng, n: int, p: dict) -> np.ndarray:
    x = np.exp(math.log(p["median"]) + p["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), p["min"], p["max"]).astype(np.int64)


def _draw(traffic: dict, rng, n: int):
    """``n`` (prompt, output, shared) sizes, half of them (rounded as the
    mix's share) opening with the system prompt."""

    sp = traffic["system_prompt"]
    plen = _lognormal(rng, n, traffic["prompt"])
    olen = _lognormal(rng, n, traffic["output"])
    k = round(n * sp["share"])
    shared = rng.permutation([True] * k + [False] * (n - k))
    plen = np.where(shared, np.maximum(plen, sp["tokens"] +
                                       sp["min_user_tokens"]), plen)
    return plen, olen, shared


def round_sizes(traffic: dict, k: int) -> list[tuple[int, int, bool, int]]:
    """(prompt length, output length, opens with the system prompt,
    output already written) of round ``k``'s requests, one a column; the
    same for every ``--seed``.  Round 0 holds the requests in flight as
    the loop starts: picked from more candidates with odds in proportion
    to their output lengths, as a moment of a long run finds them, each
    with a uniform share of its output already written."""

    c = traffic["clients"]
    rng = np.random.default_rng([traffic["size_seed"], k])
    if k > 0:
        plen, olen, shared = _draw(traffic, rng, c)
        return [(int(p), int(o), bool(s), 0)
                for p, o, s in zip(plen, olen, shared)]
    n = IN_FLIGHT_CANDIDATES * c
    plen, olen, shared = _draw(traffic, rng, n)
    k_sh = round(c * traffic["system_prompt"]["share"])
    picked = []
    for kind, want in ((True, k_sh), (False, c - k_sh)):
        idx = np.flatnonzero(shared == kind)
        w = olen[idx] / olen[idx].sum()
        picked.extend(rng.choice(idx, want, replace=False, p=w).tolist())
    picked = rng.permutation(picked)
    done = np.floor(rng.random(n) * olen).astype(np.int64)
    return [(int(plen[i]), int(olen[i]), bool(shared[i]), int(done[i]))
            for i in picked]


class Clients:
    """Each client's requests in order, drawn as they are needed: client
    ``c`` sends column ``deal[c]`` of every round, with token ids drawn
    from the seed, the client and the round."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.traffic, self.seed, self.vocab = traffic, seed, vocab
        self.deal = np.random.default_rng(seed).permutation(
            traffic["clients"])
        sys_len = traffic["system_prompt"]["tokens"]
        self.system = np.random.default_rng([seed, 1]).integers(
            1, vocab, sys_len).tolist()
        self._rounds: dict[int, list] = {}
        self._next = [0] * traffic["clients"]

    def spec(self, client: int, k: int) -> Spec:
        if k not in self._rounds:
            self._rounds[k] = round_sizes(self.traffic, k)
        plen, olen, shared, done = self._rounds[k][self.deal[client]]
        rng = np.random.default_rng([self.seed, 2, client, k])
        own = plen - len(self.system) if shared else plen
        prompt = ((self.system if shared else []) +
                  rng.integers(1, self.vocab, own + done).tolist())
        return Spec(prompt, olen - done, shared)

    def next(self, client: int) -> Spec:
        k = self._next[client]
        self._next[client] += 1
        return self.spec(client, k)


def _server(run, api, params, obs=None):
    from repro_torch.runtime.serve import Server

    s = run.conf["serve"]
    return Server(api, params, batch=s["slots"], context=s["context"],
                  prefill_chunk=s["prefill_chunk"], paged=True,
                  page_size=s["page_size"], kv_pages=s["kv_pages"],
                  share_prefix=s["share_prefix"], scheduler=s["scheduler"],
                  obs=obs)


def _warm(server, vocab: int, chunk: int) -> None:
    """Every step the window drives: a prompt of two prefill chunks, a
    second that maps the first's written prefix (sharing), and decodes."""

    rng = np.random.default_rng(12345)
    a = rng.integers(1, vocab, chunk + chunk // 2).tolist()
    server.submit(a, 3)
    server.tick()
    server.submit(a[:chunk + 8] + rng.integers(1, vocab, 9).tolist(), 3)
    server.run_until_drained()


def _counters(server) -> dict:
    return {k: server.stats()[k] for k in
            ("ticks", "tokens_generated", "prefill_chunks", "share_hits",
             "shared_tokens", "cow_copies", "deferrals", "preemptions")}


def run(run) -> None:
    from repro_torch.models.api import build_model
    from repro_torch.obs import Observability
    from repro_torch.obs.profile import PhaseProfiler

    conf, traffic, dev = run.conf, run.traffic, run.device
    dims = model.Dims.of(conf)
    cfg = model.program_config(conf, dims)
    api = build_model(cfg)
    weights = model.make_weights(dims, run.seed, model.dtype_of(conf), dev)
    model.check_layout(api, weights)
    obs = Observability(trace=False, metrics=False, profile=True) \
        if run.trace else None
    server = _server(run, api, model.program_tree(weights), obs)
    _warm(server, dims.vocab, conf["serve"]["prefill_chunk"])
    clients = Clients(traffic, run.seed, dims.vocab)

    sent: list[Sent] = []
    live: list[Sent] = []
    used_pages: list[int] = []

    def send(client: int, t: float):
        spec = clients.next(client)
        s = Sent(spec, server.submit(spec.prompt, spec.max_new), t, client)
        sent.append(s)
        live.append(s)

    def tick(until: float) -> float:
        """One tick; note its tokens' times, and let each client whose
        request completed send its next one, before ``until``."""

        server.tick()
        t = time.perf_counter()
        for s in list(live):
            n = len(s.req.out)
            if n > len(s.times):
                s.times.extend([t] * (n - len(s.times)))
            if s.req.done:
                live.remove(s)
                if t < until:
                    send(s.client, t)
        return t

    # set-up: the loop from its in-flight requests to every one's first
    # token, the window's own calls
    t = time.perf_counter()
    for client in range(traffic["clients"]):
        send(client, t)
    first = list(sent)
    while not all(s.times for s in first):
        t = tick(math.inf)
    n_before, n_live = len(sent), len(live)
    for s in sent:
        s.cursor0 = getattr(s.req, "_cursor", None)
        s.out0 = len(s.req.out)
    if obs is not None:
        obs.profiler = PhaseProfiler(warmup_ticks=0)
    before = _counters(server)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = t = time.perf_counter()
    run.setup_s = t0 - run.t_process
    while t - t0 < run.seconds:
        t = tick(t0 + run.seconds)
        used_pages.append(server.alloc.used_pages)
    run.window_s = t - t0
    window_end(run, server, before, sent, n_before, dims, t0, t)
    run.counters["requests_in_flight_at_start"] = n_live
    run.counters["peak_used_pages"] = server.peak_used_pages
    run.counters["window_peak_used_pages"] = max(used_pages)
    run.counters["window_mean_used_pages"] = sum(used_pages) / len(used_pages)
    run.counters["kv_pages"] = conf["serve"]["kv_pages"]
    finished = [s for s in sent if s.req.done]
    if obs is not None:
        run.spans = obs.profiler.report()
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    if run.trace:
        # the profiled slices follow the window, under the same load
        run.slice = profiled(dev, lambda: tick(math.inf),
                             traffic["profile_ticks"])
        run.info["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)

    del server, obs, live
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = pick_sample(finished, run.seed, traffic["check_tokens"])
    if sample:
        control = run.info.get("control", False)
        gap, cgap = judge(weights, dims, sample, dev, control=control)
        if control:
            run.info["program_gap"] = gap
            gap = cgap
        run.checks["max_logit_gap"] = (gap, run.limits["max_logit_gap"])
        run.info["checked_requests"] = len(sample)
        run.info["checked_tokens"] = sum(len(s.req.out) for s in sample)


def window_end(run, server, before: dict, sent: list[Sent], n_before: int,
               dims, t0: float, t_end: float) -> None:
    """The window's end-to-end metrics and counters, read as it closes:
    the time to first token of each request sent in it (those still
    waiting at their wait so far), every gap between tokens made in it."""

    c = {k: v - before[k] for k, v in _counters(server).items()}
    mine = sent[n_before:]
    ttft = [(s.times[0] if s.times else t_end) - s.t_send for s in mine]
    itl = [b - a for s in sent for a, b in zip(s.times, s.times[1:])
           if b >= t0]
    run.e2e = {"ttft_p90_ms": 1e3 * stats.percentile(ttft, 90)
               if ttft else float("nan"),
               "itl_p95_ms": 1e3 * stats.percentile(itl, 95) if itl
               else float("nan"),
               "serve_tokens_per_s": c["tokens_generated"] / run.window_s,
               "setup_s": run.setup_s}
    # admitted in the window: placed after its start, and not waiting now
    queued = {id(r) for r in server.queue}
    admitted = [s for s in sent if s.cursor0 is None
                and id(s.req) not in queued
                and hasattr(s.req, "_cursor")]
    c["prompt_tokens_admitted"] = sum(len(s.spec.prompt) for s in admitted)
    c["requests_sent"] = len(mine)
    c["requests_finished"] = sum(s.req.done for s in mine)
    c["useful_flops"] = _useful_flops(dims, sent)
    run.counters = c
    run.attempted = len(mine)
    run.failed = 0


def _useful_flops(dims, sent: list[Sent]) -> float:
    """Model FLOPs of what the window computed for its requests: every
    position a request forwarded in the window past its shared prefix,
    with attention over the keys before it, and one unembedding a token
    it served in the window.  Padding and shared positions count for
    nothing."""

    body = model.matmul_params(dims) - dims.vocab * dims.d
    total = 0.0
    for s in sent:
        end = getattr(s.req, "_cursor", None)
        if end is None:
            continue
        start = s.req.shared_prefix if s.cursor0 is None else s.cursor0
        total += flops.forward_flops(dims, body, end - start,
                                     flops.causal_key_sum(start, end))
        total += 2.0 * dims.vocab * dims.d * (len(s.req.out) - s.out0)
    return total


def pick_sample(finished: list[Sent], seed: int, tokens: int) -> list[Sent]:
    """The longest finished request, then others in an order drawn from
    the seed until ``tokens`` served tokens are in, with at least one
    request of each kind (system prompt or not) where both finished."""

    if not finished:
        return []
    longest = max(finished, key=lambda s: len(s.spec.prompt) + len(s.req.out))
    rest = [s for s in finished if s is not longest]
    order = np.random.default_rng([seed, 1]).permutation(len(rest))
    out = [longest]
    n = len(longest.req.out)
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(rest[i].req.out)
    for kind in (True, False):
        if not any(s.spec.shared == kind for s in out):
            extra = [rest[i] for i in order if rest[i].spec.shared == kind]
            out.extend(extra[:1])
    return out


def judge(weights, dims, sample: list[Sent], dev, control: bool = False):
    """(widest gap of a served token below the reference's best, and with
    ``control`` the same gap of the token the fp8 reference puts first)."""

    seqs, rows, served = [], [], []
    for s in sample:
        p, out = s.spec.prompt, s.req.out
        seqs.append(torch.tensor(p + out[:-1], device=dev))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + len(out),
                                 device=dev))
        served.append(torch.tensor(out, device=dev))
    with decoder.exact_f32():
        ref = {}
        gap = 0.0
        for i, j, lg in decoder.logits_at(weights, dims, seqs, rows):
            tok = served[i][j:j + lg.shape[0]]
            best = lg.max(dim=-1).values
            gap = max(gap, float((best - lg.gather(1, tok[:, None])[:, 0])
                                 .max()))
            if control:
                ref[(i, j)] = lg
        if not control:
            return gap, None
        cgap = 0.0
        for i, j, lg8 in decoder.logits_at(weights, dims, seqs, rows,
                                           fp8=True):
            lg = ref.pop((i, j))
            pick = lg8.argmax(dim=-1)
            cgap = max(cgap, float((lg.max(dim=-1).values -
                                    lg.gather(1, pick[:, None])[:, 0]).max()))
    return gap, cgap


__all__ = ["Clients", "Spec", "judge", "pick_sample", "round_sizes", "run"]
