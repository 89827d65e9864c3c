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

Decode modes: "incremental" (a Python loop of one-frame steps with cached
conv history) and "fused" (the whole loop in one launch of the decode
kernel, ops/decode.py). The JAX package's O(T^2) "reference" mode is not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..config import Config
from . import layers as L
from .blocks import (C, HC, apply_stack, init_stack, init_stack_state,
                     operand_modes, stack_in_channels, step_stack, widen)

NEG_INF = -(2.0 ** 32 - 1.0)  # the original graph's mask constant


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


@dataclass(frozen=True)
class Text2Mel:
    cfg: Config

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
            act_dtype=self.act_dtype, remat=cfg.remat))

    def text_encode(self, params, ids: torch.Tensor, *, gen=None,
                    train: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (B, N) -> K, V each (B, N, d)."""
        x = L.embedding_lookup(params["embed"], ids)
        x = self._stack(params["text_enc"], text_enc_specs(self.cfg), x, gen,
                        train)
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
            Q, Kt, V,
            prev_max_attentions=prev_max_attentions if monotonic else None)
        logits = self.audio_decode(params, R, gen=gen, train=train)
        return logits, torch.sigmoid(logits), alignments, max_attentions

    # ------------------------------------------------------------- attention
    def attention(self, Q, Kt, V, *, prev_max_attentions=None):
        """Q (B,T,d), Kt/V (B,N,d) -> R (B,T,2d), alignments (B,N,T),
        max_attentions (B,T). With ``prev_max_attentions`` (B,) every query
        row may only attend to keys in [prev, prev + attention_win_size)."""
        cfg = self.cfg
        A = torch.einsum("btd,bnd->btn", Q, Kt) * (cfg.d ** -0.5)
        if prev_max_attentions is not None:
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
    def decode(self, params, ids: torch.Tensor, max_t: Optional[int] = None,
               *, mode: str = "incremental", packed: Optional[dict] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Autoregressive synthesis of ids (B,N) -> (Y (B, max_T, n_mels),
        alignments (B, N, max_T)).

        Both modes mask each attention row by the cursor of its own step,
        feed back the sigmoid output as the next input frame, and take the
        first argmax of the attention row as the next cursor. ``packed``
        (mode "fused" only) is ``pack_decode_params(cfg, params)`` made once
        by a caller that decodes many batches with the same params."""
        max_t = max_t or self.cfg.max_T
        if mode == "incremental":
            return self._decode_incremental(params, ids, max_t)
        if mode == "fused":
            from ..ops.decode import fused_decode, pack_decode_params
            if packed is None:
                packed = pack_decode_params(self.cfg, params)
            Kt, V = self.text_encode(params, ids)
            return fused_decode(packed, Kt.contiguous(), V.contiguous(),
                                max_t, self.cfg)
        raise ValueError(f"unknown or unported decode mode {mode!r}")

    def _decode_incremental(self, params, ids, max_t: int):
        cfg = self.cfg
        B, N = ids.shape
        dev = ids.device
        Kt, V = self.text_encode(params, ids)
        enc_specs, dec_specs = audio_enc_specs(cfg), audio_dec_specs(cfg)
        enc_bufs = init_stack_state(
            enc_specs, stack_in_channels(enc_specs, cfg.n_mels), B, max_t,
            dev)
        dec_bufs = init_stack_state(
            dec_specs, stack_in_channels(dec_specs, 2 * cfg.d), B, max_t,
            dev)
        prev = torch.zeros(B, dtype=torch.long, device=dev)
        y_t = torch.zeros(B, cfg.n_mels, device=dev)
        Y = torch.empty(B, max_t, cfg.n_mels, device=dev)
        A = torch.empty(B, N, max_t, device=dev)
        for t in range(max_t):
            q_t = step_stack(params["audio_enc"], enc_specs, y_t, enc_bufs,
                             t, ln_eps=cfg.ln_eps)
            a = torch.einsum("bd,bnd->bn", q_t, Kt) * (cfg.d ** -0.5)
            a = torch.softmax(torch.where(self._disallowed(prev, N),
                                          NEG_INF, a), dim=-1)
            prev = torch.argmax(a, dim=-1)
            r_t = torch.cat([torch.einsum("bn,bnd->bd", a, V), q_t], dim=-1)
            logits = step_stack(params["audio_dec"], dec_specs, r_t,
                                dec_bufs, t, ln_eps=cfg.ln_eps)
            y_t = torch.sigmoid(logits)
            Y[:, t] = y_t
            A[:, :, t] = a
        return Y, A
