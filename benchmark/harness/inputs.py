"""What the benchmark hands the program, made from ``--seed``: the
parameters (on the card, from a ``torch.Generator`` there, in one draw per
network) and the ids of sentences. Both sides of the comparison get the
same; the reference makes nothing of the program's."""
from __future__ import annotations

import math
import re
import unicodedata

import numpy as np
import torch

from ..reference import dctts as R

# a normal truncated to +-2 has this standard deviation; dividing by it
# gives the He (fan-in) variance, as the paper's implementation draws
_TRUNC_STD = 0.87962566103423978
# the spread of biases, layer-norm shifts, gains about 1 and the embedding
_SHIFT_STD = 0.1


def sub_seed(seed: int, *key: int) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence([seed, *key]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def make_params(cfg: dict, network: str, seed: int, device) -> dict:
    """Flat {key: tensor} of one network, every leaf drawn from the seed in
    one call of a normal truncated to +-2: He (fan-in) convs and an
    embedding of std 0.1 (the paper's implementation's initialisers), and
    biases, layer-norm shifts and gains' offsets from one of std 0.1, so
    that a path that drops a bias add or a norm's scale or shift changes
    what it computes (zero biases and unit gains would hide it)."""
    shapes = R.param_shapes(cfg, network)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1 if network == "text2mel" else 2))
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    out, at = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        x = flat[at: at + n].reshape(shape)
        at += n
        if k.endswith("conv//w"):
            out[k] = x * (math.sqrt(2.0 / (shape[0] * shape[1]))
                          / _TRUNC_STD)
        elif k.endswith("gamma"):
            out[k] = 1.0 + _SHIFT_STD * x
        else:
            out[k] = _SHIFT_STD * x
    return out


def to_tree(flat: dict):
    """'//'-keyed leaves -> the nested dicts and lists of the npz layout
    (numeric path parts are list positions)."""
    root: dict = {}
    for key, v in flat.items():
        node, parts = root, key.split("//")
        for p, nxt in zip(parts[:-1], parts[1:]):
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(root)


def flatten(tree, prefix: str = "") -> dict:
    """The inverse of ``to_tree``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}//{k}" if prefix else k))
    return out


def encode(sentences, cfg: dict) -> np.ndarray:
    """Sentences -> (B, max_N) int64 ids: accents stripped, lower case,
    characters outside the vocabulary as spaces, runs of spaces collapsed,
    EOS appended, PAD (0) after; a sentence too long keeps its EOS."""
    vocab, n = cfg["vocab"], cfg["max_N"]
    index = {ch: i for i, ch in enumerate(vocab)}
    out = np.zeros((len(sentences), n), np.int64)
    for i, s in enumerate(sentences):
        s = "".join(c for c in unicodedata.normalize("NFD", s)
                    if unicodedata.category(c) != "Mn").lower()
        s = re.sub("[^{}]".format(re.escape(vocab)), " ", s)
        s = re.sub("[ ]+", " ", s).strip() + "E"
        ids = [index[c] for c in s]
        if len(ids) > n:
            ids = ids[: n - 1] + [index["E"]]
        out[i, : len(ids)] = ids
    return out
