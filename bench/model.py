"""A configuration file, its weights and its hand-over to the program.

A configuration is ``bench/configs/<name>.json``: the published config's
keys (``hidden_size``, ``num_hidden_layers``, ...) as they are run, the
name of the architecture in ``repro_torch.configs`` (``arch``), the
dtype (``dtype``) and the serving or training knobs of its cells.

The weights are the benchmark's, not the program's: :func:`make_weights`
draws every matrix of a dense decoder from the seed on the device, in
one ``randn`` call into one flat buffer, in the dtype the model is run
in.  The layout is flat names over layer-stacked tensors (``layers.wq``
is ``(L, d, H, hd)``); :func:`program_tree` hands the same tensors to
the program as its nested parameter tree, and the plain reference reads
the flat dict.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

# the rms-norm epsilon the program's dense block uses (it takes none)
PROGRAM_RMS_EPS = 1e-6
# N(0, BIAS_STD) for biases, 1 + N(0, BIAS_STD) for norm weights: not the
# zeros and ones of an untrained model, so that both paths are exercised
BIAS_STD = 0.02
EMBED_STD = 0.02


@dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    hd: int
    ff: int
    vocab: int
    qkv_bias: bool
    tied: bool
    rope_theta: float
    eps: float

    @classmethod
    def of(cls, conf: dict) -> "Dims":
        heads = conf["num_attention_heads"]
        return cls(layers=conf["num_hidden_layers"], d=conf["hidden_size"],
                   heads=heads, kv_heads=conf["num_key_value_heads"],
                   hd=conf.get("head_dim", conf["hidden_size"] // heads),
                   ff=conf["intermediate_size"], vocab=conf["vocab_size"],
                   qkv_bias=bool(conf.get("qkv_bias", False)),
                   tied=bool(conf["tie_word_embeddings"]),
                   rope_theta=float(conf["rope_theta"]),
                   eps=float(conf["rms_norm_eps"]))


def dtype_of(conf: dict) -> torch.dtype:
    return getattr(torch, conf["dtype"])


def leaf_shapes(dims: Dims) -> dict[str, tuple[tuple[int, ...], str, float]]:
    """name -> (shape, init kind, scale): ``normal`` leaves are scaled by
    their fan-in's ``-0.5`` power, so every layer's output and the logits
    keep unit scale whatever the widths."""

    L, d, H, Hkv, hd, f, V = (dims.layers, dims.d, dims.heads,
                              dims.kv_heads, dims.hd, dims.ff, dims.vocab)
    leaves = {
        "embed": ((V, d), "normal", EMBED_STD),
        "ln_f": ((d,), "norm", BIAS_STD),
        "layers.ln1": ((L, d), "norm", BIAS_STD),
        "layers.ln2": ((L, d), "norm", BIAS_STD),
        "layers.wq": ((L, d, H, hd), "normal", d ** -0.5),
        "layers.wk": ((L, d, Hkv, hd), "normal", d ** -0.5),
        "layers.wv": ((L, d, Hkv, hd), "normal", d ** -0.5),
        "layers.wo": ((L, H, hd, d), "normal", (H * hd) ** -0.5),
        "layers.wg": ((L, d, f), "normal", d ** -0.5),
        "layers.wu": ((L, d, f), "normal", d ** -0.5),
        "layers.wd": ((L, f, d), "normal", f ** -0.5),
    }
    if dims.qkv_bias:
        leaves["layers.bq"] = ((L, H, hd), "normal", BIAS_STD)
        leaves["layers.bk"] = ((L, Hkv, hd), "normal", BIAS_STD)
        leaves["layers.bv"] = ((L, Hkv, hd), "normal", BIAS_STD)
    if not dims.tied:
        leaves["unembed"] = ((d, V), "normal", d ** -0.5)
    return leaves


def make_weights(dims: Dims, seed: int, dtype: torch.dtype,
                 device) -> dict[str, torch.Tensor]:
    """Every leaf as a view of one buffer drawn by one ``randn`` call from
    a generator on ``device`` seeded with ``seed``, scaled in place."""

    shapes = leaf_shapes(dims)
    total = sum(math.prod(s) for s, _, _ in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, (shape, kind, scale) in shapes.items():
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        leaf.mul_(scale)
        if kind == "norm":
            leaf.add_(1.0)
        out[name] = leaf
    return out


def param_count(dims: Dims) -> int:
    return sum(math.prod(s) for s, _, _ in leaf_shapes(dims).values())


def matmul_params(dims: Dims) -> int:
    """Parameters that enter a matrix product per token: every leaf but
    the embedding table when it is only looked up (untied)."""

    n = param_count(dims)
    return n - (0 if dims.tied else dims.vocab * dims.d)


# the program's parameter tree: where each flat leaf sits in it
_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_FFN = ("wg", "wu", "wd")


def _tree_path(name: str) -> tuple[str, ...]:
    if not name.startswith("layers."):
        return (name,)
    leaf = name.split(".", 1)[1]
    if leaf in _ATTN:
        return ("blocks", "0_dense", "attn", leaf)
    if leaf in _FFN:
        return ("blocks", "0_dense", "ffn", leaf)
    return ("blocks", "0_dense", leaf)


def program_tree(weights: dict[str, torch.Tensor]) -> dict:
    """The flat weights as the program's nested tree (the same tensors)."""

    tree: dict = {}
    for name, t in weights.items():
        node = tree
        *parents, last = _tree_path(name)
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def flat_from_tree(tree: dict, names) -> dict[str, torch.Tensor]:
    """The inverse of :func:`program_tree` for the leaves ``names``."""

    out = {}
    for name in names:
        node = tree
        for key in _tree_path(name):
            node = node[key]
        out[name] = node
    return out


def program_config(conf: dict, dims: Dims, **overrides):
    """The program's ``ArchConfig`` for a configuration file: the
    registry's entry with the file's sizes, checked against what the
    program can run."""

    from repro_torch.configs import get_config

    if dims.eps != PROGRAM_RMS_EPS:
        raise ValueError(f"the program's rms norm takes eps "
                         f"{PROGRAM_RMS_EPS}, the file states {dims.eps}")
    base = get_config(conf["arch"])
    if base.family != "dense":
        raise ValueError(f"{conf['arch']}: only dense decoders have a "
                         f"reference here, not {base.family!r}")
    return base.replace(n_layers=dims.layers, d_model=dims.d,
                        n_heads=dims.heads, n_kv_heads=dims.kv_heads,
                        head_dim=dims.hd, d_ff=dims.ff, vocab=dims.vocab,
                        qkv_bias=dims.qkv_bias, tie_embeddings=dims.tied,
                        rope_theta=dims.rope_theta, **overrides)


def check_layout(api, weights: dict[str, torch.Tensor]) -> None:
    """Raise unless the program's parameter specs are exactly the flat
    leaves: the same keys at every level of the tree, the same shapes."""

    def walk(spec, node, path):
        if isinstance(spec, dict):
            have = sorted(node) if isinstance(node, dict) else node
            if not isinstance(node, dict) or set(spec) != set(node):
                raise ValueError(f"{'.'.join(path) or 'params'}: the program "
                                 f"has {sorted(spec)}, the benchmark {have}")
            for k in spec:
                walk(spec[k], node[k], path + (k,))
        elif tuple(node.shape) != tuple(spec.shape):
            raise ValueError(f"{'.'.join(path)}: program {spec.shape}, "
                             f"benchmark {tuple(node.shape)}")

    walk(api.specs, program_tree(weights), ())
