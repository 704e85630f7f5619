"""``init_params``' draw of a leaf larger than ``LARGE_LEAF`` elements,
in slices of at most ``LEAF_SLICE`` elements into its dtype: the same
shape, dtype, device and scale as one draw, no f32 tensor of the leaf's
size; every leaf at or below the threshold keeps the values of one draw
in tree order."""

import math

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.models import common as C  # noqa: E402
from repro_torch.models.common import PSpec, init_params  # noqa: E402


class _F32Sizes(TorchDispatchMode):
    """The element counts of every f32 tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.sizes.append(t.numel())
        return out


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_leaves_under_the_threshold_keep_one_draw_each():
    specs = {"a": PSpec((8, 16), ("embed", "mlp")),
             "b": PSpec((3, 5, 7), (None, None, None), scale=0.02,
                        dtype=torch.float32),
             "z": PSpec((4,), (None,), init="zeros")}
    got = init_params(specs, _gen(), "cpu")
    g = _gen()
    want_a = torch.randn((8, 16), generator=g).mul_(16 ** -0.5)
    want_b = torch.randn((3, 5, 7), generator=g).mul_(0.02)
    assert torch.equal(got["a"], want_a.to(torch.bfloat16))
    assert torch.equal(got["b"], want_b)
    assert torch.equal(got["z"], torch.zeros(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_large_leaf_is_drawn_in_slices_at_the_same_scale(monkeypatch,
                                                           dtype):
    # 2^18 elements in slices of at most 2^14: 16 rows of 128 at a time
    monkeypatch.setattr(C, "LARGE_LEAF", 2 ** 12)
    monkeypatch.setattr(C, "LEAF_SLICE", 2 ** 14)
    shape = (4, 16, 32, 128)
    n = math.prod(shape)
    specs = {"w": PSpec(shape, ("layers", "experts", "embed", "mlp"),
                        dtype=dtype),
             "s": PSpec((2, 4096), (None, None), scale=0.5,
                        dtype=dtype)}
    with _F32Sizes() as seen:
        p = init_params(specs, _gen(3), "cpu")
    w = p["w"]
    assert w.shape == shape and w.dtype == dtype
    assert w.device == torch.device("cpu")
    x = w.double()
    # mean 0 within 5 standard errors; std 128^-0.5 within 1 %
    scale = 128 ** -0.5
    assert abs(float(x.mean())) < 5 * scale / math.sqrt(n)
    assert float(x.std()) == pytest.approx(scale, rel=1e-2)
    # an explicit scale on a sliced leaf (8192 elements > 2^12)
    assert float(p["s"].double().std()) == pytest.approx(0.5, rel=3e-2)
    # no f32 tensor of the leaf's size but the f32 leaf itself (its
    # allocation and its row view): the largest draw is one slice
    draws = seen.sizes if dtype == torch.bfloat16 else \
        [k for k in seen.sizes if k != n]
    assert len(seen.sizes) - len(draws) == (0 if dtype == torch.bfloat16
                                            else 2)
    assert draws and max(draws) <= 2 ** 14 < n
    # the slices are different draws: no two rows of 16 x 128 repeat
    rows = w.reshape(-1, 16 * 128)
    assert not torch.equal(rows[0], rows[1])


def test_the_threshold_leaves_the_cards_configs_whole():
    """Every leaf of the configs the card runs whole or cut is below
    LARGE_LEAF; llama4-maverick's (1, 128, 5120, 8192) expert leaves of
    one block are above it."""

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves

    def biggest(name, **kw):
        api = build_model(get_config(name).replace(**kw))
        return max(math.prod(s.shape) for s in tree_leaves(api.specs))

    for name, kw in (("qwen1.5-4b", {}), ("smollm-135m", {}),
                     ("hymba-1.5b", {}), ("mamba2-2.7b", {}),
                     ("whisper-medium", {}),
                     ("mixtral-8x22b", {"n_layers": 2}),
                     ("llama-3.2-vision-90b", {"n_layers": 5})):
        assert biggest(name, **kw) <= C.LARGE_LEAF, name
    assert biggest("llama4-maverick-400b-a17b", n_layers=2) == \
        128 * 5120 * 8192 > C.LARGE_LEAF
