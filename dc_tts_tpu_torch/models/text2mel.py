"""Text2Mel: TextEnc + AudioEnc + Attention + AudioDec, the port of
``dc_tts_tpu/models/text2mel.py``.

* TextEnc: embed(e) -> C(2d,1,relu) -> C(2d,1) -> 2x[HC(3, 3^j) j=0..3]
  -> 2x HC(3,1) -> 2x HC(1,1); split -> K, V each (B, N, d). Non-causal.
* AudioEnc: C(d,1,relu) -> C(d,1,relu) -> C(d,1) -> 2x[HC(3, 3^j)]
  -> 2x HC(3,3). Causal.
* Attention: softmax(Q K^T / sqrt(d)) with the monotonic window
  [cursor, cursor + attention_win_size) at inference.
* AudioDec: C(d,1) -> HC(3,3^j) j=0..3 -> 2x HC(3,1) -> 3x C(d,1,relu)
  -> C(n_mels,1) -> sigmoid. Causal.

``apply`` is the teacher-forced full-sequence forward of training, with
dropout from a ``torch.Generator`` and, under ``cfg.use_pallas``, kernel K4
in every HC block (``blocks.apply_block``). ``cfg.compute_dtype`` selects
the stacks' operand modes (``blocks.operand_modes``); the stacks' outputs
are cast back to float32, so attention and the losses stay float32.
``cfg.remat`` recomputes each block's activations in the backward.
``model_group`` runs the stacks tensor-parallel over that process group
(``parallel/tp.py``) with ``params`` this rank's slices
(``parallel.shard_params``): each stack's output is whole, so TextEnc's K/V
split, the attention and the losses see replicated tensors.

In synthesis on the card (the tensors on CUDA, gradients off, not training,
the float32 operand mode with float32 activations, no model group)
TextEnc's blocks keep their float32 products and run each tail (the bias,
the layer norms, the gate and highway mix, or the norm and activation) as
one launch of K5's epilogue (``ops/ssrn_block.float32_block``). Every
other call runs the eager chain of ``blocks.apply_stack``.

Decode modes, as in the JAX package: "incremental" (a loop of one-frame
steps, ``decode_step``, with cached conv history), "fused" (the whole loop
in one launch of the decode kernel K1, ops/decode.py, in any of its
precisions ``prec``) and "reference" (the O(T^2) recompute loop of the
original synthesize.py, plain torch).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from ..config import Config
from ..ops.ssrn_block import float32_stack
from ..utils.profiling import span
from . import layers as L
from .blocks import (C, HC, apply_stack, init_stack, init_stack_state,
                     operand_modes, stack_in_channels, step_stack, widen)

NEG_INF = -(2.0 ** 32 - 1.0)  # the original graph's mask constant


def takes_k5(x: torch.Tensor, train: bool, dtype, act_dtype,
             model_group) -> bool:
    """Whether ``Text2Mel.text_encode`` runs its blocks' tails through K5's
    epilogue: what the call can observe, synthesis on the card in the
    float32 operand mode (module docstring)."""
    return (x.is_cuda and not train and not torch.is_grad_enabled()
            and dtype is None and act_dtype is None and model_group is None)


def text_enc_specs(cfg: Config):
    d = cfg.d
    specs = [C(1, 1, 2 * d, "relu"), C(1, 1, None, None)]
    specs += [HC(3, 3 ** j) for _ in range(2) for j in range(4)]
    specs += [HC(3, 1), HC(3, 1)]
    specs += [HC(1, 1), HC(1, 1)]
    return tuple(specs)


def audio_enc_specs(cfg: Config):
    d = cfg.d
    specs = [C(1, 1, d, "relu", True), C(1, 1, None, "relu", True),
             C(1, 1, None, None, True)]
    specs += [HC(3, 3 ** j, True) for _ in range(2) for j in range(4)]
    specs += [HC(3, 3, True), HC(3, 3, True)]
    return tuple(specs)


def audio_dec_specs(cfg: Config):
    d = cfg.d
    specs = [C(1, 1, d, None, True)]
    specs += [HC(3, 3 ** j, True) for j in range(4)]
    specs += [HC(3, 1, True), HC(3, 1, True)]
    specs += [C(1, 1, None, "relu", True)] * 3
    specs += [C(1, 1, cfg.n_mels, None, True)]
    return tuple(specs)


class DecodeState(NamedTuple):
    """Carried through the autoregressive loop (on the decode's device).
    The history buffers are updated in place by ``Text2Mel.decode_step``."""
    enc_bufs: List[Optional[torch.Tensor]]  # AudioEnc per-layer histories
    dec_bufs: List[Optional[torch.Tensor]]  # AudioDec per-layer histories
    prev_max_attention: torch.Tensor        # (B,) long attention cursor
    prev_y: torch.Tensor                    # (B, n_mels) last mel frame


@dataclass(frozen=True)
class Text2Mel:
    cfg: Config
    model_group: Any = field(default=None, compare=False)

    # ------------------------------------------------------------- init
    def init(self, gen: torch.Generator, device="cpu") -> dict:
        cfg = self.cfg
        params = {"embed": L.init_embedding(gen, cfg.vocab_size, cfg.e,
                                            device)}
        params["text_enc"], out = init_stack(gen, cfg.e, text_enc_specs(cfg),
                                             device)
        assert out == 2 * cfg.d
        params["audio_enc"], out = init_stack(gen, cfg.n_mels,
                                              audio_enc_specs(cfg), device)
        assert out == cfg.d
        params["audio_dec"], out = init_stack(gen, 2 * cfg.d,
                                              audio_dec_specs(cfg), device)
        assert out == cfg.n_mels
        return params

    @property
    def dtype(self):
        """Matmul operand mode: bf16, "high" or None (float32)."""
        return operand_modes(self.cfg.compute_dtype)[0]

    @property
    def act_dtype(self):
        """Activation dtype between blocks ("bfloat16_full"), or None."""
        return operand_modes(self.cfg.compute_dtype)[1]

    # ------------------------------------------------------------- stacks
    def _stack(self, params, specs, x, gen, train):
        cfg = self.cfg
        return widen(apply_stack(
            params, specs, x, ln_eps=cfg.ln_eps,
            dropout_rate=cfg.dropout_rate, gen=gen, train=train,
            use_pallas=cfg.use_pallas, dtype=self.dtype,
            act_dtype=self.act_dtype, remat=cfg.remat,
            model_group=self.model_group))

    def text_encode(self, params, ids: torch.Tensor, *, gen=None,
                    train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (B, N) -> K, V each (B, N, d). In synthesis on the card
        (``takes_k5``) each block's tail runs as one launch of K5's
        epilogue on its float32 product (module docstring)."""
        x = L.embedding_lookup(params["embed"], ids)
        specs = text_enc_specs(self.cfg)
        if takes_k5(x, train, self.dtype, self.act_dtype, self.model_group):
            x = float32_stack(params["text_enc"], specs, x, self.cfg.ln_eps)
        else:
            x = self._stack(params["text_enc"], specs, x, gen, train)
        return torch.chunk(x, 2, dim=-1)

    def audio_encode(self, params, S: torch.Tensor, *, gen=None,
                     train: bool = False) -> torch.Tensor:
        """Shifted mel S (B, T, n_mels) -> queries Q (B, T, d)."""
        return self._stack(params["audio_enc"], audio_enc_specs(self.cfg), S,
                           gen, train)

    def audio_decode(self, params, R: torch.Tensor, *, gen=None,
                     train: bool = False) -> torch.Tensor:
        """R (B, T, 2d) -> mel logits (B, T, n_mels)."""
        return self._stack(params["audio_dec"], audio_dec_specs(self.cfg), R,
                           gen, train)

    def apply(self, params, ids: torch.Tensor, S: torch.Tensor, *, gen=None,
              train: bool = False, monotonic: bool = False,
              prev_max_attentions=None):
        """Teacher-forced forward: ids (B, N), S (B, T, n_mels) shifted mels
        -> (logits, Y, alignments (B, N, T), max_attentions (B, T)). With
        ``monotonic`` every query row attends only inside the window at
        ``prev_max_attentions`` (B,)."""
        Kt, V = self.text_encode(params, ids, gen=gen, train=train)
        Q = self.audio_encode(params, S, gen=gen, train=train)
        R, alignments, max_attentions = self.attention(
            params, Q, Kt, V, monotonic=monotonic,
            prev_max_attentions=prev_max_attentions)
        logits = self.audio_decode(params, R, gen=gen, train=train)
        return logits, torch.sigmoid(logits), alignments, max_attentions

    # ------------------------------------------------------------- attention
    def attention(self, params, Q, Kt, V, *, monotonic: bool = False,
                  prev_max_attentions=None):
        """Q (B,T,d), Kt/V (B,N,d) -> R (B,T,2d), alignments (B,N,T),
        max_attentions (B,T). With ``monotonic`` every query row may only
        attend to keys in [prev, prev + attention_win_size) of
        ``prev_max_attentions`` (B,): the same cursor for every row, as in
        the original graph. ``params`` is unused (the JAX signature)."""
        cfg = self.cfg
        A = torch.einsum("btd,bnd->btn", Q, Kt) * (cfg.d ** -0.5)
        if monotonic:
            A = torch.where(self._disallowed(prev_max_attentions,
                                             Kt.shape[1])[:, None, :],
                            NEG_INF, A)
        A = torch.softmax(A, dim=-1)
        max_attentions = torch.argmax(A, dim=-1)
        R = torch.cat([torch.einsum("btn,bnd->btd", A, V), Q], dim=-1)
        return R, A.transpose(1, 2), max_attentions

    def _disallowed(self, prev: torch.Tensor, n: int) -> torch.Tensor:
        pos = torch.arange(n, device=prev.device)[None, :]
        p = prev[:, None]
        return (pos < p) | (pos >= p + self.cfg.attention_win_size)

    # ------------------------------------------------------------- decode
    def init_decode_state(self, batch: int, max_t: Optional[int] = None,
                          device="cpu") -> DecodeState:
        """Zero history buffers (the causal left padding), cursor 0 and a
        zero first input frame for ``batch`` rows and up to ``max_t``
        steps."""
        cfg = self.cfg
        max_t = max_t or cfg.max_T
        enc_specs, dec_specs = audio_enc_specs(cfg), audio_dec_specs(cfg)
        enc_bufs = init_stack_state(
            enc_specs, stack_in_channels(enc_specs, cfg.n_mels), batch,
            max_t, device)
        dec_bufs = init_stack_state(
            dec_specs, stack_in_channels(dec_specs, 2 * cfg.d), batch, max_t,
            device)
        return DecodeState(enc_bufs, dec_bufs,
                           torch.zeros(batch, dtype=torch.long, device=device),
                           torch.zeros(batch, cfg.n_mels, device=device))

    def decode_step(self, params, Kt, V, state: DecodeState, t: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, DecodeState]:
        """Advance the autoregressive decoder by one frame: one causal step
        of AudioEnc on ``state.prev_y`` (zero at t=0), one attention row
        masked to the window at the cursor, one causal step of AudioDec.
        Returns (y_t (B, n_mels), align_t (B, N), new_state). Unlike the
        JAX package, whose state is immutable, the history buffers are
        written in place: the returned state shares them, and a state must
        not be used again once it has been stepped."""
        cfg = self.cfg
        q_t = step_stack(params["audio_enc"], audio_enc_specs(cfg),
                         state.prev_y, state.enc_bufs, t, ln_eps=cfg.ln_eps)
        a = torch.einsum("bd,bnd->bn", q_t, Kt) * (cfg.d ** -0.5)
        a = torch.softmax(torch.where(
            self._disallowed(state.prev_max_attention, Kt.shape[1]),
            NEG_INF, a), dim=-1)
        r_t = torch.cat([torch.einsum("bn,bnd->bd", a, V), q_t], dim=-1)
        logits = step_stack(params["audio_dec"], audio_dec_specs(cfg), r_t,
                            state.dec_bufs, t, ln_eps=cfg.ln_eps)
        y_t = torch.sigmoid(logits)
        return y_t, a, DecodeState(state.enc_bufs, state.dec_bufs,
                                   torch.argmax(a, dim=-1), y_t)

    def decode(self, params, ids: torch.Tensor, max_t: Optional[int] = None,
               *, mode: str = "incremental", prec: str = "highest",
               packed: Optional[dict] = None, text_encoder=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Autoregressive synthesis of ids (B,N) -> (Y (B, max_T, n_mels),
        alignments (B, N, max_T)).

        "incremental" and "fused" mask each attention row by the cursor of
        its own step, feed back the sigmoid output as the next input frame,
        and take the first argmax of the attention row as the next cursor.
        "fused" runs the decode kernel in precision ``prec`` (``ops.decode.
        PRECS``; the other modes are float32 and ignore it, as in the JAX
        package); ``packed`` is ``pack_decode_params(cfg, params, prec)``
        made once by a caller that decodes many batches with the same
        params. "reference" is the original synthesize.py loop: at step t
        the CURRENT cursor re-masks every earlier query row too, and those
        rows feed AudioDec's causal history for frame t, so attention and
        AudioDec run again over the whole prefix each step (O(T^2)); Q is
        cached frame by frame, since AudioEnc never sees the mask.

        ``text_encoder``, a callable ids -> (K, V), takes TextEnc's place
        (the Synthesizer's captured graph on the card); by default
        ``self.text_encode(params, ids)``.

        Spans (``utils/profiling``), in every mode: ``text2mel.text_encode``
        around TextEnc and ``text2mel.decode`` around the decode (the
        kernel's launch with its host-side preparation in "fused", the
        step loop otherwise)."""
        from ..ops.decode import check_prec, fused_decode, pack_decode_params
        check_prec(prec)
        if mode not in ("incremental", "fused", "reference"):
            raise ValueError(f"unknown decode mode {mode!r}; one of "
                             "('incremental', 'fused', 'reference')")
        max_t = max_t or self.cfg.max_T
        if mode == "fused" and packed is None:
            packed = pack_decode_params(self.cfg, params, prec)
        with span("text2mel.text_encode"):
            if text_encoder is None:
                Kt, V = self.text_encode(params, ids)
            else:
                Kt, V = text_encoder(ids)
        with span("text2mel.decode"):
            if mode == "incremental":
                return self._decode_incremental(params, Kt, V, max_t)
            if mode == "reference":
                return self._decode_reference(params, Kt, V, max_t)
            return fused_decode(packed, Kt.contiguous(), V.contiguous(),
                                max_t, self.cfg, prec)

    def _decode_incremental(self, params, Kt, V, max_t: int):
        B, N = Kt.shape[:2]
        state = self.init_decode_state(B, max_t, Kt.device)
        Y = torch.empty(B, max_t, self.cfg.n_mels, device=Kt.device)
        A = torch.empty(B, N, max_t, device=Kt.device)
        for t in range(max_t):
            Y[:, t], A[:, :, t], state = self.decode_step(params, Kt, V,
                                                          state, t)
        return Y, A

    def _decode_reference(self, params, Kt, V, max_t: int):
        cfg = self.cfg
        B, N = Kt.shape[:2]
        dev = Kt.device
        enc_specs = audio_enc_specs(cfg)
        enc_bufs = init_stack_state(
            enc_specs, stack_in_channels(enc_specs, cfg.n_mels), B, max_t,
            dev)
        Q = torch.zeros(B, max_t, cfg.d, device=dev)
        Y = torch.empty(B, max_t, cfg.n_mels, device=dev)
        A = torch.empty(B, N, max_t, device=dev)
        prev = torch.zeros(B, dtype=torch.long, device=dev)
        y_t = torch.zeros(B, cfg.n_mels, device=dev)
        for t in range(max_t):
            Q[:, t] = step_stack(params["audio_enc"], enc_specs, y_t,
                                 enc_bufs, t, ln_eps=cfg.ln_eps)
            # attention and AudioDec over the prefix under the current
            # cursor. The JAX package runs all max_t columns (those after t
            # hold zeros); AudioDec is causal and each attention row is
            # independent, so columns 0..t come out the same either way.
            R, align, maxatt = self.attention(
                params, Q[:, : t + 1], Kt, V, monotonic=True,
                prev_max_attentions=prev)
            logits = self.audio_decode(params, R)
            y_t = torch.sigmoid(logits[:, t])
            Y[:, t] = y_t
            A[:, :, t] = align[:, :, t]
            prev = maxatt[:, t]
        return Y, A
