"""The paged decode attention (``repro_torch.kernels.paged_decode``).

On the CPU: the split rule and the wrapper's argument checks (pure
Python) and the signatures that let a call skip them, the import of the
kernel and the model in either order, the plain version against a
per-row softmax over the keys the definition counts (windows, holes,
shuffled pages, an idle row), the model's paged decode against the
chunked paged path at T = 1 (the CPU keeps its numbers), and the
Server's ``attn_kernel_calls`` counter with the benchmark's reader of
it.  Marked ``gpu``: the kernel against its plain version on the card,
and its refusals there.  This file imports no JAX.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    FILL, GROUPS, HEAD_DIMS, MAX_PAGES, check_kernel_args, group_rows,
    num_splits, paged_decode, paged_decode_kernel, paged_decode_ref, shapes)
from repro_torch.kernels.paged_decode import ops as pd_ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.runtime import Server  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402

HKV, M = 2, 8
# the output rounded once to its dtype, after f32 sums in another order
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2, torch.float16: 2e-3}
POISON = 1e4    # K/V where no counted key lies: a key read by mistake shows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest -m gpu tests/test_torch_paged_decode.py)")
    return torch.device("cuda", 0)


def _layout(B, g, hd, ps, seed=0):
    """q (B, g * HKV, 1, hd), pools, page table and lengths, f32 on the
    CPU.  Rows 0-4 hold 1, ps - 1, ps, ps + 1 and M * ps keys; row 5 is
    idle (no page); row 6 has holes (-1 entries below its length); the
    rest random lengths.  Physical pages are shuffled; pages no table
    holds and positions past a row's length hold ``POISON``."""

    rng = np.random.default_rng(seed)
    P = B * M + 3
    perm = rng.permutation(P)
    table = np.full((B, M), -1, np.int32)
    cur = np.zeros(B, np.int64)
    special = [0, ps - 2, ps - 1, ps, M * ps - 1]
    k = np.full((P, HKV, ps, hd), POISON, np.float32)
    v = np.full((P, HKV, ps, hd), POISON, np.float32)
    nxt = 0
    for b in range(B):
        cur[b] = special[b] if b < 5 else 7 if b == 5 else \
            M * ps - 3 if b == 6 else rng.integers(0, M * ps)
        if b == 5:
            continue
        for m in range(int(cur[b]) // ps + 1):
            if b == 6 and m in (1, M // 2):
                continue
            page = int(perm[nxt])
            nxt += 1
            table[b, m] = page
            n = min(ps, int(cur[b]) + 1 - m * ps)
            k[page, :, :n] = rng.standard_normal((HKV, n, hd))
            v[page, :, :n] = rng.standard_normal((HKV, n, hd))
    q = rng.standard_normal((B, g * HKV, 1, hd)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k, v, table, cur)]


def _per_row(q, k, v, table, cur, window, scale):
    """Each row's softmax over the keys it counts, in float64."""

    B, H, _, hd = q.shape
    ps, g = k.shape[2], H // k.shape[1]
    out = torch.zeros((B, H, 1, hd), dtype=torch.float64)
    for b in range(B):
        keys = [j for j in range(table.shape[1] * ps)
                if j <= cur[b] and table[b, j // ps] >= 0
                and (window is None or j >= cur[b] - window + 1)]
        if not keys:
            continue
        pages = [int(table[b, j // ps]) for j in keys]
        offs = [j % ps for j in keys]
        for h in range(H):
            kk = k[pages, h // g, offs].double()
            vv = v[pages, h // g, offs].double()
            p = torch.softmax(kk @ q[b, h, 0].double() * scale, dim=0)
            out[b, h, 0] = p @ vv
    return out


# -- the split rule and the argument checks (pure Python) ---------------------

@pytest.mark.parametrize("B,Hkv,M_,want", [
    (64, 20, 64, 1),            # chat-c64: 1,280 blocks, one launch a layer
    (132, 2, 8, 1),             # exactly FILL blocks
    (131, 2, 8, 2),
    (4, 20, 64, 4),             # a 4-slot qwen1.5-4b Server
    (1, 8, 64, 33),             # qwen3-32b served whole at B = 1
    (1, 8, 16, 16),             # at most one split a page
    (7, 2, 8, 8),
    (1, 1, 1, 1),
])
def test_split_rule_fills_the_card_from_host_sizes(B, Hkv, M_, want):
    assert FILL == 264
    assert num_splits(B, Hkv, M_) == want
    assert 1 <= want <= M_


@pytest.mark.parametrize("case", ["q_rows", "pool_shapes", "head_dim",
                                  "groups", "table_rows", "lengths"])
def test_wrapper_refuses_shapes_that_do_not_fit(case):
    q, k, v, table, cur = _layout(7, 3, 16, 4)
    bad = {"q_rows": dict(q=q.expand(7, 6, 2, 16)),
           "pool_shapes": dict(v=v[:-1]),
           "head_dim": dict(q=q[..., :8]),
           "groups": dict(q=q[:, :5]),
           "table_rows": dict(page_table=table[:-1]),
           "lengths": dict(cur_len=cur[:-1])}[case]
    args = {**dict(q=q, k=k, v=v, page_table=table, cur_len=cur), **bad}
    with pytest.raises(ValueError):
        paged_decode(args["q"], args["k"], args["v"], args["page_table"],
                     args["cur_len"])


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_args_accept_what_is_compiled(hd, g, dtype):
    q, k, v, table, cur = (t.to(dtype) if t.is_floating_point() else t
                           for t in _layout(7, g, hd, 16))
    check_kernel_args(q, k, v, shapes(q, k, v, table, cur),
                      num_splits(7, HKV, M), None)
    assert group_rows(g) in GROUPS and group_rows(g) >= g


@pytest.mark.parametrize("case,error", [
    ("head_dim_32", ValueError), ("nine_groups", ValueError),
    ("mixed_dtypes", TypeError), ("int_pool", TypeError),
    ("strided_pool", ValueError), ("pages_a_split", ValueError),
    ("negative_window", ValueError)])
def test_kernel_args_refuse_what_is_not_compiled(case, error):
    g, hd = (9, 16) if case == "nine_groups" else \
        (1, 32) if case == "head_dim_32" else (3, 16)
    q, k, v, table, cur = _layout(7, g, hd, 4)
    splits, window = 1, None
    if case == "mixed_dtypes":
        q = q.to(torch.bfloat16)
    elif case == "int_pool":
        q, k, v = (t.to(torch.int32) for t in (q, k, v))
    elif case == "strided_pool":
        k, v = (t.transpose(2, 3).contiguous().transpose(2, 3)
                for t in (k, v))
    elif case == "pages_a_split":
        table = torch.full((7, MAX_PAGES + 1), -1, dtype=torch.int32)
    elif case == "negative_window":
        window = -1
    with pytest.raises(error):
        check_kernel_args(q, k, v, shapes(q, k, v, table, cur), splits,
                          window)


def test_wrapper_refuses_a_dtensor(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0])
        q, k, v, table, cur = _layout(7, 3, 16, 4)
        for i in range(5):
            args = [q, k, v, table, cur]
            args[i] = distribute_tensor(args[i], mesh, [Replicate()])
            with pytest.raises(TypeError, match="DTensor"):
                paged_decode(*args)
    finally:
        if own:
            dist.destroy_process_group()


@pytest.mark.parametrize("change", [
    "q_dtype", "pool_dtype", "head_dim", "groups", "pool_pages", "page_size",
    "table_width", "batch", "strided_pool", "device", "subclass", "window",
    "splits"])
def test_signature_changes_with_everything_the_checks_read(change):
    """A CUDA call checks its arguments once a signature: any property
    the checks read gives another signature, and new values in the same
    tensors give the same one."""

    from repro_torch.kernels.paged_decode.kernel import _signature

    q, k, v, table, cur = _layout(7, 3, 16, 4)
    args = dict(q=q, k=k, v=v, page_table=table, cur_len=cur, window=None,
                splits=1)
    same = {n: t.clone() if torch.is_tensor(t) else t
            for n, t in args.items()}
    assert _signature(**same) == _signature(**args)
    q2, k2, v2, table2, cur2 = _layout(9, 5, 64, 16)
    changed = {"q_dtype": dict(q=q.to(torch.bfloat16)),
               "pool_dtype": dict(k=k.double()),
               "head_dim": dict(q=q2[:7, :6]),
               "groups": dict(q=q[:, :2]),
               "pool_pages": dict(v=v[:-1]),
               "page_size": dict(k=k2[:, :HKV, :, :16]),
               "table_width": dict(page_table=table[:, :-1]),
               "batch": dict(cur_len=cur2),
               "strided_pool": dict(
                   k=k.transpose(2, 3).contiguous().transpose(2, 3)),
               "device": dict(page_table=table.to("meta")),
               "subclass": dict(q=torch.nn.Parameter(q)),
               "window": dict(window=8),
               "splits": dict(splits=2)}[change]
    assert _signature(**{**args, **changed}) != _signature(**args)


@pytest.mark.parametrize("first", ["repro_torch.kernels.paged_decode",
                                   "repro_torch.kernels.paged_decode.ref",
                                   "repro_torch.models"])
def test_the_kernel_and_the_model_import_in_either_order(first):
    """The plain version imports the model's attention core, whose
    package imports the kernel: a fresh process imports both, whichever
    comes first, and the model calls the kernel's entry point."""

    import os
    import subprocess

    code = (f"import {first}\n"
            "from repro_torch.models import attention\n"
            "from repro_torch.kernels.paged_decode import paged_decode\n"
            "assert attention.paged_decode_ops.paged_decode is paged_decode\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


# -- the plain version and the model's paged decode on the CPU ----------------

@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 3, 5])
@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("window", [None, "short", "long"])
def test_plain_version_is_each_rows_softmax_over_its_keys(hd, g, ps, window):
    q, k, v, table, cur = _layout(9, g, hd, ps, seed=hd + g + ps)
    w = {None: None, "short": ps // 2 + 1, "long": 2 * ps + 1}[window]
    before = paged_decode_kernel.calls, paged_decode_kernel.launches
    got = paged_decode(q, k, v, table, cur, window=w)
    # no kernel on a CPU
    assert (paged_decode_kernel.calls, paged_decode_kernel.launches) == before
    want = _per_row(q, k, v, table, cur, w, hd ** -0.5)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert not got[5].any()                             # the idle row
    assert torch.equal(paged_decode_ref(q, k, v, table, cur, window=w,
                                        scale=hd ** -0.5), got)


@pytest.mark.parametrize("name,window", [("smollm-135m", None),
                                         ("qwen1.5-4b", None),
                                         ("mixtral-8x22b", 8)])
def test_paged_decode_equals_the_chunked_path_at_one_token(name, window):
    """The model's paged decode and the chunked paged path at T = 1 give
    the same bits on every row with a key, and write the same pools."""

    from repro_torch.models.common import init_params
    cfg = get_config(name).reduced().replace(logits_dtype="float32")
    p = {n: t.float() for n, t in init_params(
        attn.attn_specs(cfg), torch.Generator().manual_seed(1), "cpu").items()}
    B, ps = 6, 4
    q, k, v, table, cur = _layout(B, 1, cfg.hd, ps)
    shape = (k.shape[0], cfg.n_kv_heads, ps, cfg.hd)
    g = torch.Generator().manual_seed(2)
    pool = {"k": torch.randn(shape, generator=g),
            "v": torch.randn(shape, generator=g)}
    twin = {n: t.clone() for n, t in pool.items()}
    x = torch.randn((B, 1, cfg.d_model), generator=g)
    active = torch.tensor([True, True, False, True, True, True])
    pos = cur[:, None]
    writes = attn.paged_writes(table, pos, active[:, None], ps)
    out, _ = attn.decode_attention_paged(p, cfg, x, pool, table, cur, writes,
                                         window=window)
    want, _ = attn.decode_attention_chunked_paged(p, cfg, x, twin, table, cur,
                                                  writes, window=window)
    live = [b for b in range(B) if b != 5]              # row 5 has no page
    assert torch.equal(out[live], want[live])
    for n in ("k", "v"):
        assert torch.equal(pool[n], twin[n])


# -- the Server's counter and the benchmark's reader of it -------------------

def test_server_counts_the_kernel_launches_of_each_decode_step(monkeypatch):
    """``attn_kernel_calls`` is the kernel's calls in the decode phase, a
    layer a step: with a wrapper that counts a call and two launches (a
    split step's; the CPU launches none), the phase counts the calls."""

    cfg = get_config("qwen1.5-4b").reduced().replace(logits_dtype="float32")
    api = build_model(cfg)
    params = api.init(0, "cpu")
    real = pd_ops.paged_decode_kernel

    def counted(*a, **kw):
        paged_decode_kernel.calls += 1
        paged_decode_kernel.launches += 2
        return real(*a, **kw)

    monkeypatch.setattr(pd_ops, "paged_decode_kernel", counted)
    obs = Observability(trace=False, metrics=False, profile=True,
                        profile_warmup_ticks=0)
    srv = Server(api, params, batch=3, context=48, prefill_chunk=8,
                 paged=True, page_size=4, kv_pages=40, obs=obs)
    for n in (5, 13, 21, 9):
        srv.submit(list(range(1, n + 1)), 4)
    calls, launches = paged_decode_kernel.calls, paged_decode_kernel.launches
    with torch.inference_mode():
        srv.run_until_drained()
    dec = obs.profiler.report()["decode"]
    assert dec["count"] > 0
    assert dec["attn_kernel_calls"] == cfg.n_layers * dec["count"]
    assert paged_decode_kernel.calls - calls == dec["attn_kernel_calls"]
    assert paged_decode_kernel.launches - launches == \
        2 * dec["attn_kernel_calls"]
    assert "attn_kernel_calls" not in obs.profiler.report()["prefill"]


def test_attn_kernel_share_metric_reads_the_layer_steps_through_the_kernel():
    metric = harness.load_metric("attn_kernel_share.chat")
    run = harness.Run(cell={"name": "qwen1.5-4b.chat-c64"},
                      conf={"num_hidden_layers": 40}, traffic={}, limits={},
                      seed=0, seconds=1.0, trace=True,
                      device=torch.device("cuda", 0), t_process=0.0)
    assert metric.read(run) is None
    run.spans = {"decode": {"count": 8, "kv_tokens": 1, "qk_pairs": 1}}
    assert metric.read(run) is None                     # a parent's program
    run.spans["decode"]["attn_kernel_calls"] = 320
    assert metric.read(run) == 100.0
    run.spans["decode"]["attn_kernel_calls"] = 80       # a quarter of them
    assert metric.read(run) == 25.0
    run.device = torch.device("cpu")                    # no kernel off the card
    assert metric.read(run) is None


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 3, 5])
@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("window", [None, "short", "long"])
@pytest.mark.parametrize("batch", ["split", "whole"])
def test_kernel_equals_plain_version(cuda, dtype, hd, g, ps, window, batch):
    """The kernel against its plain version on the card, in the working
    dtype: every length case, holes, an idle row (exact zeros), windows
    shorter and longer than a page; B * Hkv small enough to split (the
    merge launch) and large enough not to."""

    B = 7 if batch == "split" else FILL // HKV + 8
    q, k, v, table, cur = (t.to(cuda) for t in _layout(B, g, hd, ps))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    w = {None: None, "short": ps // 2 + 1, "long": 2 * ps + 1}[window]
    splits = num_splits(B, HKV, M)
    assert (splits > 1) == (batch == "split")
    calls, before = paged_decode_kernel.calls, paged_decode_kernel.launches
    got = paged_decode(q, k, v, table, cur, window=w)
    torch.cuda.synchronize()
    assert paged_decode_kernel.calls - calls == 1
    assert paged_decode_kernel.launches - before == (2 if splits > 1 else 1)
    want = paged_decode_ref(q, k, v, table, cur, window=w, scale=hd ** -0.5)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert not got[5].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["head_dim_32", "nine_groups",
                                  "mixed_dtypes", "strided_pool"])
def test_kernel_raises_on_the_card_rather_than_fall_back(cuda, case):
    """Refused, also after a call of the layout it changes passed its
    checks (a signature checked once does not cover another)."""

    paged_decode(*(t.to(cuda) for t in _layout(7, 3, 16, 4)))
    g, hd = (9, 16) if case == "nine_groups" else \
        (1, 32) if case == "head_dim_32" else (3, 16)
    q, k, v, table, cur = (t.to(cuda) for t in _layout(7, g, hd, 4))
    if case == "mixed_dtypes":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif case == "strided_pool":
        k, v = (t.transpose(2, 3).contiguous().transpose(2, 3)
                for t in (k, v))
    before = paged_decode_kernel.calls, paged_decode_kernel.launches
    with pytest.raises((ValueError, TypeError)):
        paged_decode(q, k, v, table, cur)
    assert (paged_decode_kernel.calls, paged_decode_kernel.launches) == before
