"""Conv-block stacks with a batch / one-frame step API, the port of
``dc_tts_tpu/models/blocks.py``.

* C  - conv1d -> layer-norm -> optional activation
* HC - gated highway conv: one conv to 2C channels, split into gate H1 and
       info H2, each layer-normed, then sigmoid(H1)*H2 + (1-sigmoid(H1))*x
* D  - stride-2 transposed conv -> layer-norm -> activation

A stack is a tuple of specs and a list of parameter dicts. ``apply_stack``
runs the whole sequence (with dropout after every block in training);
``step_stack`` runs one causal frame against per-layer history buffers, for
the incremental decoder.

Operand modes (``operand_modes``): ``dtype`` is each conv's matmul mode
(``layers.matmul``), ``act_dtype`` (``bfloat16_full``) the type in which
activations are stored between and inside blocks: conv outputs, layer-norm
outputs (their statistics stay float32), the gate, the residual, dropout.

With ``use_pallas`` in training every HC block runs kernel K4
(``ops/hc_vjp.py``): its forward and its hand-written backward, then
dropout; in bf16 operands when ``dtype`` is bf16 (``compute_dtype=
"bfloat16"``), never under ``act_dtype`` (the kernel takes float32
activations), as in the JAX package. The JAX package also gates that path
on the TPU core's VMEM (``hc_train_fits``: SSRN's wide HC blocks stay on
XLA there); the CUDA kernels tile time themselves and take every HC shape
of the trainer (a width their 16-byte copies cannot take is stored padded
with zero channels, ``ops/hc_vjp.py``), so the port has no gate. Under ``bfloat16`` that leaves
those blocks' dW (and dx's conv part) in float32 where XLA's transpose of
the bf16 conv rounds them to bf16: at the smallest shape JAX keeps off its
kernel, 3.8e-3 x max|dW| from JAX against 1.1e-3 for the port's XLA-like
route, both within bf16 noise (tests/test_torch_precision.py pins them).

Under ``bfloat16_full`` the sigmoids round as the JAX program does
(``_sigmoid``: after exp, the add and the divide).

With ``remat`` each block runs under ``torch.utils.checkpoint``: its
activations are recomputed in the backward instead of kept.

Tensor parallelism (``model_group``, ``parallel/tp.py``): each conv of a
block gathers its slice of the output channels before the layer norm (an
HC block's 2C channels before the split into gate and info, in
model-coordinate order). K4 takes no slice: an HC block under
``use_pallas`` gathers its kernel's weight whole and runs K4 on it, as
JAX's GSPMD runs a ``pallas_call`` whole on every rank; the weight's
gradient back is this rank's columns of K4's dW, and K4's dx is already
whole. Under ``remat`` the recompute issues the same collectives in the
same order on every model rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.tp import gather_from_model, is_sharded
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


def operand_modes(compute_dtype: str):
    """(dtype, act_dtype) of a ``compute_dtype``, as the JAX package's
    Text2Mel and SSRN read it: "float32" (None, None), "float32_high"
    ("high", None), "bfloat16" (bf16, None), "bfloat16_full" (bf16, bf16)."""
    modes = {"float32": (None, None), "float32_high": ("high", None),
             "bfloat16": (torch.bfloat16, None),
             "bfloat16_full": (torch.bfloat16, torch.bfloat16)}
    if compute_dtype not in modes:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; one of "
                         f"{tuple(modes)}")
    return modes[compute_dtype]


def widen(x: torch.Tensor) -> torch.Tensor:
    """A stack's output back in float32 (a bf16 one; float32 and float64
    pass unchanged)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid as the JAX package's program computes it: for bf16, 1 / (1 +
    exp(-x)) with each op rounded to bf16, as jax.nn.sigmoid lowers (three
    roundings where torch.sigmoid rounds once); float32 unchanged."""
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def _act(x, name: Act):
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return _sigmoid(x)
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
    h1 = _sigmoid(L.layer_norm(p["ln1"], h1, ln_eps))
    h2 = L.layer_norm(p["ln2"], h2, ln_eps)
    return h1 * h2 + (1.0 - h1) * x.to(h1.dtype)


def apply_block(p: dict, spec, x: torch.Tensor, *, ln_eps: float,
                dropout_rate: float = 0.0, gen=None, train: bool = False,
                use_pallas: bool = False, dtype=None, act_dtype=None,
                model_group=None) -> torch.Tensor:
    g = model_group
    if use_pallas and train and isinstance(spec, HC) and act_dtype is None:
        from ..ops.hc_vjp import hc_block_trainable
        w = p["conv"]["w"]
        if is_sharded(p["conv"]):
            w = gather_from_model(w, g)
        y = hc_block_trainable(x, w, p["conv"]["b"],
                               p["ln1"]["gamma"], p["ln1"]["beta"],
                               p["ln2"]["gamma"], p["ln2"]["beta"],
                               spec.size, spec.rate, spec.causal, ln_eps,
                               dtype is torch.bfloat16)
    elif isinstance(spec, C):
        y = L.conv1d(p["conv"], x, size=spec.size, rate=spec.rate,
                     causal=spec.causal, dtype=dtype, out_dtype=act_dtype,
                     group=g)
        y = _act(L.layer_norm(p["ln"], y, ln_eps), spec.act)
    elif isinstance(spec, HC):
        h = L.conv1d(p["conv"], x, size=spec.size, rate=spec.rate,
                     causal=spec.causal, dtype=dtype, out_dtype=act_dtype,
                     group=g)
        y = _highway(p, h, x, ln_eps)
    elif isinstance(spec, D):
        y = L.conv1d_transpose(p["conv"], x, dtype, act_dtype, g)
        y = _act(L.layer_norm(p["ln"], y, ln_eps), spec.act)
    else:
        raise TypeError(spec)
    y = L.dropout(y, dropout_rate, gen, train)
    if act_dtype is not None and y.dtype != act_dtype:
        y = y.to(act_dtype)
    return y


def _remat_block(p: dict, spec, x: torch.Tensor, gen, **kw) -> torch.Tensor:
    """``apply_block`` under ``torch.utils.checkpoint``. The checkpoint
    restores the global RNGs for its recompute, not ``gen``: the block
    draws its dropout mask from a generator set to ``gen``'s state before
    the block, in the forward and again in the recompute, and ``gen`` moves
    on as the forward left it. The masks are those of a run without
    remat."""
    state = None if gen is None else gen.get_state()
    first = True

    def run(p_, x_):
        nonlocal first
        g = None
        if state is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(state)
        y = apply_block(p_, spec, x_, gen=g, **kw)
        if first and g is not None:
            gen.set_state(g.get_state())
        first = False
        return y

    return checkpoint(run, p, x, use_reentrant=False,
                      preserve_rng_state=False)


def apply_stack(params: Sequence[dict], specs: Sequence, x: torch.Tensor, *,
                ln_eps: float, dropout_rate: float = 0.0, gen=None,
                train: bool = False, use_pallas: bool = False, dtype=None,
                act_dtype=None, remat: bool = False,
                model_group=None) -> torch.Tensor:
    """Run a stack. In training (``train``) every block is followed by
    dropout drawn from ``gen``, layer after layer in order. ``dtype`` and
    ``act_dtype``: the operand modes (module docstring); with ``act_dtype``
    the input is narrowed to it first. ``remat``: each block recomputed in
    the backward (``_remat_block``). ``model_group``: tensor parallelism
    over that group, ``params`` this rank's slices (module docstring)."""
    if act_dtype is not None:
        x = x.to(act_dtype)
    kw = dict(ln_eps=ln_eps, dropout_rate=dropout_rate, train=train,
              use_pallas=use_pallas, dtype=dtype, act_dtype=act_dtype,
              model_group=model_group)
    for p, spec in zip(params, specs):
        if remat and torch.is_grad_enabled():
            x = _remat_block(p, spec, x, gen, **kw)
        else:
            x = apply_block(p, spec, x, gen=gen, **kw)
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
