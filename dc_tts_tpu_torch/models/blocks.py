"""Conv-block stacks with a batch / one-frame step API, the port of
``dc_tts_tpu/models/blocks.py`` (eval mode, float32).

* C  - conv1d -> layer-norm -> optional activation
* HC - gated highway conv: one conv to 2C channels, split into gate H1 and
       info H2, each layer-normed, then sigmoid(H1)*H2 + (1-sigmoid(H1))*x
* D  - stride-2 transposed conv -> layer-norm -> activation

A stack is a tuple of specs and a list of parameter dicts. ``apply_stack``
runs the whole sequence (with dropout after every block in training);
``step_stack`` runs one causal frame against per-layer history buffers, for
the incremental decoder.

With ``use_pallas`` in training every HC block runs kernel K4
(``ops/hc_vjp.py``): its forward and its hand-written backward, then
dropout. The JAX package gates that path on the TPU core's VMEM
(``hc_train_fits``); the CUDA kernels tile time themselves and take every
HC shape of the trainer, so the port has no gate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from . import layers as L

Act = Optional[str]  # None | "relu" | "sigmoid"


@dataclass(frozen=True)
class C:
    """Conv block spec. out_ch=None keeps the input width."""
    size: int = 1
    rate: int = 1
    out_ch: Optional[int] = None
    act: Act = None
    causal: bool = False


@dataclass(frozen=True)
class HC:
    """Highway-conv block spec; output width equals input width."""
    size: int = 3
    rate: int = 1
    causal: bool = False


@dataclass(frozen=True)
class D:
    """Stride-2 transposed-conv block spec (non-causal; SSRN only)."""
    size: int = 3
    out_ch: Optional[int] = None
    act: Act = None


def _act(x, name: Act):
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(name)


# ---------------------------------------------------------------------------
# init


def init_stack(gen: torch.Generator, in_ch: int, specs: Sequence,
               device="cpu") -> Tuple[List[dict], int]:
    """Parameters for a stack; returns (params_list, out_ch)."""
    params = []
    ch = in_ch
    for spec in specs:
        if isinstance(spec, C):
            out = spec.out_ch or ch
            p = {"conv": L.init_conv(gen, ch, out, spec.size, device),
                 "ln": L.init_layer_norm(out, device)}
            ch = out
        elif isinstance(spec, HC):
            p = {"conv": L.init_conv(gen, ch, 2 * ch, spec.size, device),
                 "ln1": L.init_layer_norm(ch, device),
                 "ln2": L.init_layer_norm(ch, device)}
        elif isinstance(spec, D):
            out = spec.out_ch or ch
            p = {"conv": L.init_deconv(gen, ch, out, spec.size, device),
                 "ln": L.init_layer_norm(out, device)}
            ch = out
        else:
            raise TypeError(spec)
        params.append(p)
    return params, ch


# ---------------------------------------------------------------------------
# batch apply


def _highway(p: dict, h: torch.Tensor, x: torch.Tensor,
             ln_eps: float) -> torch.Tensor:
    h1, h2 = torch.chunk(h, 2, dim=-1)
    h1 = torch.sigmoid(L.layer_norm(p["ln1"], h1, ln_eps))
    h2 = L.layer_norm(p["ln2"], h2, ln_eps)
    return h1 * h2 + (1.0 - h1) * x


def apply_block(p: dict, spec, x: torch.Tensor, *, ln_eps: float,
                dropout_rate: float = 0.0, gen=None, train: bool = False,
                use_pallas: bool = False) -> torch.Tensor:
    if use_pallas and train and isinstance(spec, HC):
        from ..ops.hc_vjp import hc_block_trainable
        y = hc_block_trainable(x, p["conv"]["w"], p["conv"]["b"],
                               p["ln1"]["gamma"], p["ln1"]["beta"],
                               p["ln2"]["gamma"], p["ln2"]["beta"],
                               spec.size, spec.rate, spec.causal, ln_eps)
    elif isinstance(spec, C):
        y = L.conv1d(p["conv"], x, size=spec.size, rate=spec.rate,
                     causal=spec.causal)
        y = _act(L.layer_norm(p["ln"], y, ln_eps), spec.act)
    elif isinstance(spec, HC):
        h = L.conv1d(p["conv"], x, size=spec.size, rate=spec.rate,
                     causal=spec.causal)
        y = _highway(p, h, x, ln_eps)
    elif isinstance(spec, D):
        y = L.conv1d_transpose(p["conv"], x)
        y = _act(L.layer_norm(p["ln"], y, ln_eps), spec.act)
    else:
        raise TypeError(spec)
    return L.dropout(y, dropout_rate, gen, train)


def apply_stack(params: Sequence[dict], specs: Sequence, x: torch.Tensor, *,
                ln_eps: float, dropout_rate: float = 0.0, gen=None,
                train: bool = False, use_pallas: bool = False
                ) -> torch.Tensor:
    """Run a stack. In training (``train``) every block is followed by
    dropout drawn from ``gen``, layer after layer in order."""
    for p, spec in zip(params, specs):
        x = apply_block(p, spec, x, ln_eps=ln_eps, dropout_rate=dropout_rate,
                        gen=gen, train=train, use_pallas=use_pallas)
    return x


# ---------------------------------------------------------------------------
# incremental step apply (causal stacks only)


def history_pad(spec) -> int:
    """Frames of left context a causal block needs: (K-1)*rate."""
    return (spec.size - 1) * spec.rate


def init_stack_state(specs: Sequence, in_chs: Sequence[int], batch: int,
                     max_t: int, device="cpu") -> List[Optional[torch.Tensor]]:
    """Per-layer input-history buffers for incremental decode: layer i with
    kernel size K>1 gets (B, pad_i + max_t, C_in_i) zeros (the causal left
    padding); size-1 layers carry no state."""
    state = []
    for spec, cin in zip(specs, in_chs):
        if isinstance(spec, D):
            raise ValueError("deconv blocks cannot run incrementally")
        if spec.size == 1:
            state.append(None)
        else:
            state.append(torch.zeros(batch, history_pad(spec) + max_t, cin,
                                     device=device))
    return state


def stack_in_channels(specs: Sequence, in_ch: int) -> List[int]:
    """Input channel count of each layer in the stack."""
    chs = []
    ch = in_ch
    for spec in specs:
        chs.append(ch)
        if isinstance(spec, (C, D)) and spec.out_ch:
            ch = spec.out_ch
    return chs


def step_block(p: dict, spec, x_t: torch.Tensor, buf, t: int, *,
               ln_eps: float) -> torch.Tensor:
    """One causal block on one frame x_t (B, C). Writes x_t into ``buf`` in
    place (the history is the caller's state, updated in place to avoid a
    copy of every buffer per step)."""
    assert spec.causal or spec.size == 1, "step apply requires causal blocks"
    if spec.size == 1:
        frames = x_t[:, None, :]
    else:
        buf[:, history_pad(spec) + t] = x_t
        # lags (K-1)r ... r, 0 -> buffer positions t, t+r, ..., t+(K-1)r
        frames = buf[:, t: t + spec.size * spec.rate: spec.rate]
    if isinstance(spec, C):
        y = L.conv1d_step(p["conv"], frames)
        return _act(L.layer_norm(p["ln"], y, ln_eps), spec.act)
    if isinstance(spec, HC):
        return _highway(p, L.conv1d_step(p["conv"], frames), x_t, ln_eps)
    raise TypeError(spec)


def step_stack(params: Sequence[dict], specs: Sequence, x_t: torch.Tensor,
               state, t: int, *, ln_eps: float) -> torch.Tensor:
    """One frame through a causal stack; ``state`` is updated in place."""
    for p, spec, buf in zip(params, specs, state):
        x_t = step_block(p, spec, x_t, buf, t, ln_eps=ln_eps)
    return x_t
