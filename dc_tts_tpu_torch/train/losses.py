"""Training losses of Text2Mel and SSRN, the port of
``dc_tts_tpu/train/losses.py``.

Text2Mel:  L = mean|Y - mels| + mean sigmoid_xent(Y_logits, mels)
             + sum(|A * W| * mask) / sum(mask)        (guided attention)
SSRN:      L = mean|Z - mags| + mean sigmoid_xent(Z_logits, mags)

W[n, t] = 1 - exp(-(t/max_T - n/max_N)^2 / 2g^2), g = 0.2. Batches are
padded to static shapes, so the attention mask is built from each example's
text and mel lengths; without lengths the whole grid counts.

Under data parallelism (``group``: the data axis' process group, each rank
holding an equal share of the global batch's rows) every function returns
this rank's share of the global batch's value, so that the shares (and
their gradients) summed over the group are the value (and gradient) of the
global batch, as JAX's GSPMD step computes it. The means are split evenly;
the attention loss and the diagonality, ratios of sums, divide this rank's
sum by the denominator summed over the group. A mean of each rank's own
loss would differ whenever the ranks' text and mel lengths do.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..config import Config


def _ranks(group) -> int:
    return 1 if group is None else torch.distributed.get_world_size(group)


def _global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group (a constant for autograd)."""
    x = x.detach().clone()
    if group is not None:
        from ..parallel.distributed import all_reduce_sum_
        all_reduce_sum_([x], group)
    return x


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
                   mel_lens: Optional[torch.Tensor], cfg: Config,
                   group=None):
    """Guided-attention loss over the real (n, t) cells of each example.
    alignments (B, N, T); with lengths None the whole grid counts."""
    B, N, T = alignments.shape
    W = torch.as_tensor(guided_attention_matrix(cfg.max_N, cfg.max_T)[:N, :T],
                        device=alignments.device)
    weighted = torch.abs(alignments * W[None])
    if text_lens is None or mel_lens is None:
        return torch.mean(weighted) / _ranks(group)
    dev = alignments.device
    n_mask = torch.arange(N, device=dev)[None, :] < text_lens[:, None]
    t_mask = torch.arange(T, device=dev)[None, :] < mel_lens[:, None]
    mask = n_mask[:, :, None] & t_mask[:, None, :]
    total = torch.sum(weighted * mask)
    count = torch.clamp(_global_sum(torch.sum(mask), group), min=1)
    return total / count


def text2mel_loss(logits, Y, alignments, mels, cfg: Config, text_lens=None,
                  mel_lens=None, group=None):
    """Returns (loss, dict of components)."""
    n = _ranks(group)
    loss_mels = l1_loss(Y, mels) / n
    loss_bd1 = binary_divergence(logits, mels) / n
    loss_att = attention_loss(alignments, text_lens, mel_lens, cfg, group)
    loss = loss_mels + loss_bd1 + loss_att
    return loss, {"loss": loss, "loss_mels": loss_mels,
                  "loss_bd1": loss_bd1, "loss_att": loss_att}


def attention_diagonality(alignments, text_lens=None, mel_lens=None,
                          group=None):
    """Health metric: mean |n/N - t/T| distance of the attention mass from
    the diagonal, in [0, 1); lower is more diagonal."""
    B, N, T = alignments.shape
    dev = alignments.device
    n_len = text_lens[:, None, None] if text_lens is not None else N
    t_len = mel_lens[:, None, None] if mel_lens is not None else T
    n_pos = torch.arange(N, device=dev)[None, :, None] / n_len
    t_pos = torch.arange(T, device=dev)[None, None, :] / t_len
    dist = torch.abs(n_pos - t_pos)
    return torch.sum(alignments * dist) / torch.clamp(
        _global_sum(torch.sum(alignments), group), min=1e-9)


def ssrn_loss(logits, Z, mags, cfg: Config, group=None):
    """Returns (loss, dict of components)."""
    n = _ranks(group)
    loss_mags = l1_loss(Z, mags) / n
    loss_bd2 = binary_divergence(logits, mags) / n
    loss = loss_mags + loss_bd2
    return loss, {"loss": loss, "loss_mags": loss_mags, "loss_bd2": loss_bd2}
