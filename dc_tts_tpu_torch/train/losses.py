"""Training losses of Text2Mel and SSRN, the port of
``dc_tts_tpu/train/losses.py``.

Text2Mel:  L = mean|Y - mels| + mean sigmoid_xent(Y_logits, mels)
             + sum(|A * W| * mask) / sum(mask)        (guided attention)
SSRN:      L = mean|Z - mags| + mean sigmoid_xent(Z_logits, mags)

W[n, t] = 1 - exp(-(t/max_T - n/max_N)^2 / 2g^2), g = 0.2. Batches are
padded to static shapes, so the attention mask is built from each example's
text and mel lengths; without lengths the whole grid counts.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..config import Config


@functools.lru_cache(maxsize=4)
def guided_attention_matrix(max_n: int, max_t: int, g: float = 0.2
                            ) -> np.ndarray:
    """(max_N, max_T) guided-attention prior (float32, host)."""
    n = np.arange(max_n)[:, None] / float(max_n)
    t = np.arange(max_t)[None, :] / float(max_t)
    return (1.0 - np.exp(-((t - n) ** 2) / (2.0 * g * g))).astype(np.float32)


def binary_divergence(logits, targets):
    """Mean sigmoid cross-entropy, max(l,0) - l*z + log1p(exp(-|l|))."""
    return torch.mean(torch.clamp(logits, min=0.0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def attention_loss(alignments, text_lens: Optional[torch.Tensor],
                   mel_lens: Optional[torch.Tensor], cfg: Config):
    """Guided-attention loss over the real (n, t) cells of each example.
    alignments (B, N, T); with lengths None the whole grid counts."""
    B, N, T = alignments.shape
    W = torch.as_tensor(guided_attention_matrix(cfg.max_N, cfg.max_T)[:N, :T],
                        device=alignments.device)
    weighted = torch.abs(alignments * W[None])
    if text_lens is None or mel_lens is None:
        return torch.mean(weighted)
    dev = alignments.device
    n_mask = torch.arange(N, device=dev)[None, :] < text_lens[:, None]
    t_mask = torch.arange(T, device=dev)[None, :] < mel_lens[:, None]
    mask = n_mask[:, :, None] & t_mask[:, None, :]
    total = torch.sum(weighted * mask)
    count = torch.clamp(torch.sum(mask), min=1)
    return total / count


def text2mel_loss(logits, Y, alignments, mels, cfg: Config, text_lens=None,
                  mel_lens=None):
    """Returns (loss, dict of components)."""
    loss_mels = l1_loss(Y, mels)
    loss_bd1 = binary_divergence(logits, mels)
    loss_att = attention_loss(alignments, text_lens, mel_lens, cfg)
    loss = loss_mels + loss_bd1 + loss_att
    return loss, {"loss": loss, "loss_mels": loss_mels,
                  "loss_bd1": loss_bd1, "loss_att": loss_att}


def attention_diagonality(alignments, text_lens=None, mel_lens=None):
    """Health metric: mean |n/N - t/T| distance of the attention mass from
    the diagonal, in [0, 1); lower is more diagonal."""
    B, N, T = alignments.shape
    dev = alignments.device
    n_len = text_lens[:, None, None] if text_lens is not None else N
    t_len = mel_lens[:, None, None] if mel_lens is not None else T
    n_pos = torch.arange(N, device=dev)[None, :, None] / n_len
    t_pos = torch.arange(T, device=dev)[None, None, :] / t_len
    dist = torch.abs(n_pos - t_pos)
    return torch.sum(alignments * dist) / torch.clamp(torch.sum(alignments),
                                                      min=1e-9)


def ssrn_loss(logits, Z, mags, cfg: Config):
    """Returns (loss, dict of components)."""
    loss_mags = l1_loss(Z, mags)
    loss_bd2 = binary_divergence(logits, mags)
    loss = loss_mags + loss_bd2
    return loss, {"loss": loss, "loss_mags": loss_mags, "loss_bd2": loss_bd2}
