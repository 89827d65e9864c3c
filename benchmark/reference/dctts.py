"""Plain PyTorch reference of DC-TTS, the yardstick that decides `correct`.

DC-TTS: Tachibana, Uenoyama and Aihara, "Efficiently Trainable
Text-to-Speech System Based on Deep Convolutional Networks with Guided
Attention", arXiv:1710.08969, with the sizes and training recipe of
Kyubyong/dc_tts `hyperparams.py` (LJSpeech). Written from those equations in
plain torch operations (matmuls, `torch.fft`), in the type of the
parameters it is given: float64 to judge a run (a float32 sum that cancels,
as a layer norm's bias gradient does, is itself as far from the exact one
as the program is), float32 with TF32 on for the control. It imports
nothing of the measured program. Where the program's semantics go
beyond the paper, this copies them as the program documents them:

* every conv block is conv -> layer norm (biased variance, eps from the
  config) -> activation; a highway block splits its 2C-wide conv output into
  gate and information halves, each layer-normed;
* PAD (id 0) embeds as zeros; the decode's attention window at step t is
  [cursor, cursor + attention_win_size), the cursor the first argmax of the
  previous step's attention row (0 at the first step);
* the de-emphasis is the IIR y[t] = x[t] + coef * y[t-1], and waveforms are
  quantised to 16 bits as round(clip(w, -1, 1) * 32767);
* training: inverted dropout after every block with masks drawn as
  `torch.rand(shape, generator=gen) < 1 - rate`, block after block, from a
  generator seeded per step by `step_seed`; per-element clipping to [-1, 1],
  Adam (0.9, 0.999, 1e-8) and the Noam decay `noam_lr`.

The parameters are a flat dict keyed by '//'-joined paths, the npz layout
that the checkpoints use (`embed//table`, `text_enc//3//conv//w`,
`stack//0//ln//gamma`, ...); a conv kernel is (K, C_in, C_out).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Block(NamedTuple):
    kind: str                  # "C" conv, "HC" highway conv, "D" deconv
    size: int = 1
    rate: int = 1
    out: Optional[int] = None  # None keeps the input width
    act: Optional[str] = None  # None | "relu"
    causal: bool = False


def hop_length(cfg: dict) -> int:
    return int(cfg["sr"] * cfg["frame_shift"])


def win_length(cfg: dict) -> int:
    return int(cfg["sr"] * cfg["frame_length"])


def n_freq(cfg: dict) -> int:
    return cfg["n_fft"] // 2 + 1


# ---------------------------------------------------------------------------
# the networks' layer programs (the paper's Fig. 1 and section 4)


def text_enc(cfg: dict) -> List[Block]:
    d = cfg["d"]
    b = [Block("C", out=2 * d, act="relu"), Block("C")]
    b += [Block("HC", 3, 3 ** j) for _ in range(2) for j in range(4)]
    return b + [Block("HC", 3, 1)] * 2 + [Block("HC", 1, 1)] * 2


def audio_enc(cfg: dict) -> List[Block]:
    d = cfg["d"]
    b = [Block("C", out=d, act="relu", causal=True),
         Block("C", act="relu", causal=True), Block("C", causal=True)]
    b += [Block("HC", 3, 3 ** j, causal=True)
          for _ in range(2) for j in range(4)]
    return b + [Block("HC", 3, 3, causal=True)] * 2


def audio_dec(cfg: dict) -> List[Block]:
    b = [Block("C", out=cfg["d"], causal=True)]
    b += [Block("HC", 3, 3 ** j, causal=True) for j in range(4)]
    b += [Block("HC", 3, 1, causal=True)] * 2
    b += [Block("C", act="relu", causal=True)] * 3
    return b + [Block("C", out=cfg["n_mels"], causal=True)]


def ssrn(cfg: dict) -> List[Block]:
    c = cfg["c"]
    b = [Block("C", out=c), Block("HC", 3, 1), Block("HC", 3, 3)]
    for _ in range(2):
        b += [Block("D", 3), Block("HC", 3, 1), Block("HC", 3, 3)]
    b += [Block("C", out=2 * c), Block("HC", 3, 1), Block("HC", 3, 1),
          Block("C", out=n_freq(cfg))]
    return b + [Block("C", act="relu")] * 2 + [Block("C")]


def stacks(cfg: dict, network: str) -> Dict[str, tuple]:
    """{stack name: (input width, blocks)} of "text2mel" or "ssrn"."""
    if network == "text2mel":
        return {"text_enc": (cfg["e"], text_enc(cfg)),
                "audio_enc": (cfg["n_mels"], audio_enc(cfg)),
                "audio_dec": (2 * cfg["d"], audio_dec(cfg))}
    if network == "ssrn":
        return {"stack": (cfg["n_mels"], ssrn(cfg))}
    raise ValueError(f"unknown network {network!r}")


def param_shapes(cfg: dict, network: str) -> Dict[str, tuple]:
    """Every parameter's key and shape, in a fixed order."""
    out = {}
    if network == "text2mel":
        out["embed//table"] = (len(cfg["vocab"]), cfg["e"])
    for name, (ch, blocks) in stacks(cfg, network).items():
        for i, b in enumerate(blocks):
            k = f"{name}//{i}"
            cout = 2 * ch if b.kind == "HC" else (b.out or ch)
            out[f"{k}//conv//w"] = (b.size if b.kind != "D" else 3, ch, cout)
            out[f"{k}//conv//b"] = (cout,)
            norms = ("ln1", "ln2") if b.kind == "HC" else ("ln",)
            width = ch if b.kind == "HC" else cout
            for ln in norms:
                out[f"{k}//{ln}//gamma"] = (width,)
                out[f"{k}//{ln}//beta"] = (width,)
            if b.kind != "HC":
                ch = cout
    return out


# ---------------------------------------------------------------------------
# blocks


def layer_norm(x, gamma, beta, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * gamma + beta


def conv1d(x, w, b, size, rate, causal):
    """x (B, T, C_in), w (K, C_in, C_out) -> (B, T, C_out), SAME or causal
    padding, dilation ``rate``: the sum over taps of the shifted input
    times the tap's matrix (matmuls, which TF32 governs; a cuDNN
    convolution may pick a Winograd or FFT algorithm that rounds more)."""
    total = (size - 1) * rate
    left = total if causal else total // 2
    T = x.shape[1]
    xp = F.pad(x, (0, 0, left, total - left))
    y = b
    for k in range(size):
        y = y + xp[:, k * rate: k * rate + T] @ w[k]
    return y


def deconv1d(x, w, b):
    """Stride-2 transposed conv, kernel 3, SAME: y[2t] = x[t] w0 +
    x[t-1] w2, y[2t+1] = x[t] w1."""
    B, T, _ = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :T]
    even = x @ w[0] + x_prev @ w[2]
    odd = x @ w[1]
    return torch.stack([even, odd], 2).reshape(B, 2 * T, -1) + b


def _finish(p, k, blk, h, x, eps):
    """Norm, gate and activation of block ``k`` on its conv output h."""
    if blk.kind == "HC":
        c = x.shape[-1]
        g = torch.sigmoid(layer_norm(h[..., :c], p[k + "//ln1//gamma"],
                                     p[k + "//ln1//beta"], eps))
        info = layer_norm(h[..., c:], p[k + "//ln2//gamma"],
                          p[k + "//ln2//beta"], eps)
        return g * info + (1.0 - g) * x
    y = layer_norm(h, p[k + "//ln//gamma"], p[k + "//ln//beta"], eps)
    return torch.relu(y) if blk.act == "relu" else y


def run_stack(p: Params, name: str, blocks, x, eps, dropout=None):
    """A whole stack over time; ``dropout(y)`` after every block."""
    for i, blk in enumerate(blocks):
        k = f"{name}//{i}"
        w, b = p[k + "//conv//w"], p[k + "//conv//b"]
        h = deconv1d(x, w, b) if blk.kind == "D" else \
            conv1d(x, w, b, blk.size, blk.rate, blk.causal)
        x = _finish(p, k, blk, h, x, eps)
        if dropout is not None:
            x = dropout(x)
    return x


class CausalStepper:
    """A causal stack run one frame at a time, every layer's input history
    kept whole (zeros before the first frame)."""

    def __init__(self, p: Params, name: str, blocks, in_ch, B, T, eps,
                 like):
        self.p, self.name, self.blocks, self.eps = p, name, blocks, eps
        self.hist = []
        ch = in_ch
        for blk in blocks:
            self.hist.append(like.new_zeros(B, T, ch))
            if blk.kind == "C" and blk.out:
                ch = blk.out

    def step(self, x, t):
        for i, blk in enumerate(self.blocks):
            k = f"{self.name}//{i}"
            H = self.hist[i]
            H[:, t] = x
            taps = [H[:, t - j * blk.rate] if t - j * blk.rate >= 0
                    else torch.zeros_like(x)
                    for j in range(blk.size - 1, -1, -1)]
            w = self.p[k + "//conv//w"]
            h = torch.cat(taps, -1) @ w.reshape(-1, w.shape[-1]) \
                + self.p[k + "//conv//b"]
            x = _finish(self.p, k, blk, h, x, self.eps)
        return x


# ---------------------------------------------------------------------------
# synthesis


def embed(p: Params, ids):
    table = p["embed//table"]
    table = torch.cat([torch.zeros_like(table[:1]), table[1:]])
    return table[ids]


def text_encode(cfg: dict, p: Params, ids, dropout=None):
    x = run_stack(p, "text_enc", text_enc(cfg), embed(p, ids), cfg["ln_eps"],
                  dropout)
    return torch.chunk(x, 2, -1)


@torch.no_grad()
def decode(cfg: dict, p: Params, ids, cursors=None):
    """The autoregressive decode of ids (B, N) over max_T steps -> (Y (B, T,
    n_mels), A (B, N, T)). With ``cursors`` (B, T) the window of step t
    starts at ``cursors[:, t - 1]`` (a run being judged: its own argmax of
    each row), else at this run's own argmax."""
    B, N = ids.shape
    T, d, eps, win = cfg["max_T"], cfg["d"], cfg["ln_eps"], \
        cfg["attention_win_size"]
    dev = ids.device
    K, V = text_encode(cfg, p, ids)
    enc = CausalStepper(p, "audio_enc", audio_enc(cfg), cfg["n_mels"], B, T,
                        eps, K)
    dec = CausalStepper(p, "audio_dec", audio_dec(cfg), 2 * d, B, T, eps, K)
    pos = torch.arange(N, device=dev)[None]
    cur = torch.zeros(B, 1, dtype=torch.long, device=dev)
    y = K.new_zeros(B, cfg["n_mels"])
    Y = K.new_empty(B, T, cfg["n_mels"])
    A = K.new_empty(B, N, T)
    for t in range(T):
        q = enc.step(y, t)
        s = torch.einsum("bnd,bd->bn", K, q) / math.sqrt(d)
        s = s.masked_fill((pos < cur) | (pos >= cur + win), float("-inf"))
        a = torch.softmax(s, -1)
        cur = a.argmax(-1, keepdim=True) if cursors is None else \
            cursors[:, t: t + 1].long()
        r = torch.cat([torch.einsum("bn,bnd->bd", a, V), q], -1)
        y = torch.sigmoid(dec.step(r, t))
        Y[:, t], A[:, :, t] = y, a
    return Y, A


@torch.no_grad()
def ssrn_apply(cfg: dict, p: Params, Y):
    """Y (B, T, n_mels) -> Z (B, r T, n_freq)."""
    return torch.sigmoid(run_stack(p, "stack", ssrn(cfg), Y, cfg["ln_eps"]))


def hann(cfg: dict) -> np.ndarray:
    """Periodic Hann of the window length, centred in n_fft zeros."""
    n_fft, wl = cfg["n_fft"], win_length(cfg)
    w = np.zeros(n_fft)
    lpad = (n_fft - wl) // 2
    w[lpad: lpad + wl] = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(wl) / wl)
    return w


def stft(y, cfg, window):
    n_fft, hop = cfg["n_fft"], hop_length(cfg)
    pad = n_fft // 2
    yp = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    return torch.fft.rfft(yp.unfold(-1, n_fft, hop) * window, dim=-1)


def istft(X, cfg, window, inv_env):
    """Least-squares inverse: windowed frames overlap-added over the summed
    squared window, the centre padding trimmed."""
    n_fft, hop = cfg["n_fft"], hop_length(cfg)
    nf = X.shape[-2]
    frames = torch.fft.irfft(X, n=n_fft, dim=-1) * window
    L = n_fft + hop * (nf - 1)
    y = F.fold(frames.transpose(1, 2), (1, L), (1, n_fft), stride=(1, hop))
    y = y[:, 0, 0] * inv_env
    return y[:, n_fft // 2: L - n_fft // 2]


def inverse_envelope(cfg: dict, nf: int) -> np.ndarray:
    n_fft, hop = cfg["n_fft"], hop_length(cfg)
    w2 = hann(cfg) ** 2
    env = np.zeros(n_fft + hop * (nf - 1))
    for f in range(nf):
        env[f * hop: f * hop + n_fft] += w2
    env[env <= 1e-11] = 1.0
    return 1.0 / env


@torch.no_grad()
def vocode(cfg: dict, Z, dtype=torch.float64) -> np.ndarray:
    """Z (B, F, n_freq) -> int16 waveforms (B, hop (F - 1)) on the host:
    denormalisation, ``n_iter`` Griffin-Lim rounds from zero phase in
    ``dtype``, de-emphasis in float64, 16-bit quantisation."""
    mag = torch.clamp(Z.to(dtype), 0, 1) * cfg["max_db"] - cfg["max_db"] \
        + cfg["ref_db"]
    mag = torch.pow(10.0, mag * 0.05) ** cfg["power"]
    window = torch.as_tensor(hann(cfg), dtype=dtype, device=Z.device)
    inv_env = torch.as_tensor(inverse_envelope(cfg, Z.shape[1]), dtype=dtype,
                              device=Z.device)
    X = mag.to(torch.complex128 if dtype == torch.float64
               else torch.complex64)
    for _ in range(cfg["n_iter"]):
        est = stft(istft(X, cfg, window, inv_env), cfg, window)
        X = mag * (est / torch.clamp(est.abs(), min=1e-8))
    wav = istft(X, cfg, window, inv_env).double().cpu().numpy()
    from scipy.signal import lfilter
    wav = lfilter([1.0], [1.0, -cfg["preemphasis"]], wav, axis=-1)
    return np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)


# ---------------------------------------------------------------------------
# training


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def make_dropout(rate: float, gen: torch.Generator):
    keep = 1.0 - rate

    def dropout(y):
        mask = torch.rand(y.shape, generator=gen, device=y.device) < keep
        return torch.where(mask, y / keep, torch.zeros((), device=y.device))
    return dropout


def _bd(logits, z):
    return torch.mean(torch.clamp(logits, min=0) - logits * z
                      + torch.log1p(torch.exp(-logits.abs())))


def guided_attention(cfg: dict, N: int, T: int, device):
    n = np.arange(cfg["max_N"])[:, None] / cfg["max_N"]
    t = np.arange(cfg["max_T"])[None, :] / cfg["max_T"]
    W = 1.0 - np.exp(-((t - n) ** 2) / (2 * 0.2 ** 2))
    return torch.as_tensor(W[:N, :T].astype(np.float32), device=device)


def text2mel_loss(cfg: dict, p: Params, batch: dict, dropout):
    """Teacher-forced loss: L1 + binary divergence of the mels, and the
    guided-attention loss over each example's real (n, t) cells."""
    texts, mels = batch["texts"], batch["mels"]
    S = torch.cat([torch.zeros_like(mels[:, :1]), mels[:, :-1]], 1)
    eps = cfg["ln_eps"]
    K, V = text_encode(cfg, p, texts, dropout)
    Q = run_stack(p, "audio_enc", audio_enc(cfg), S, eps, dropout)
    A = torch.softmax(Q @ K.transpose(1, 2) / math.sqrt(cfg["d"]), -1)
    R = torch.cat([A @ V, Q], -1)
    logits = run_stack(p, "audio_dec", audio_dec(cfg), R, eps, dropout)
    Y = torch.sigmoid(logits)
    B, N, T = texts.shape[0], texts.shape[1], mels.shape[1]
    W = guided_attention(cfg, N, T, mels.device)
    n_ok = torch.arange(N, device=mels.device)[None] < \
        batch["text_lens"][:, None]
    t_ok = torch.arange(T, device=mels.device)[None] < \
        batch["mel_lens"][:, None]
    mask = (n_ok[:, :, None] & t_ok[:, None, :]).float()
    att = torch.sum(torch.abs(A.transpose(1, 2) * W) * mask) / \
        torch.clamp(mask.sum(), min=1)
    return torch.mean(torch.abs(Y - mels)) + _bd(logits, mels) + att


def ssrn_loss(cfg: dict, p: Params, batch: dict, dropout):
    logits = run_stack(p, "stack", ssrn(cfg), batch["mels"], cfg["ln_eps"],
                       dropout)
    mags = batch["mags"]
    return torch.mean(torch.abs(torch.sigmoid(logits) - mags)) + \
        _bd(logits, mags)


LOSSES = {"text2mel": text2mel_loss, "ssrn": ssrn_loss}

B1, B2, EPS = 0.9, 0.999, 1e-8


def noam_lr(count: int, lr0: float, warmup: float) -> float:
    s = count + 1.0
    return lr0 * warmup ** 0.5 * min(s * warmup ** -1.5, s ** -0.5)


class Trainer:
    """The reference's training loop on its own copy of the parameters:
    ``step(batch)`` -> (loss, gradients as the optimizer takes them,
    i.e. clipped), then the Adam update with the Noam rate."""

    def __init__(self, cfg: dict, network: str, params: Params, seed: int):
        self.cfg, self.loss_fn, self.seed = cfg, LOSSES[network], seed
        self.p = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def step(self, batch: dict):
        cfg = self.cfg
        gen = torch.Generator(device=batch["mels"].device)
        gen.manual_seed(step_seed(self.seed, self.count))
        loss = self.loss_fn(cfg, self.p, batch,
                            make_dropout(cfg["dropout_rate"], gen))
        keys = list(self.p)
        grads = torch.autograd.grad(loss, [self.p[k] for k in keys])
        lr = noam_lr(self.count, cfg["lr"], cfg["warmup_steps"])
        c = self.count + 1
        clipped = {}
        with torch.no_grad():
            for k, g in zip(keys, grads):
                g = torch.clamp(g, -1.0, 1.0)
                clipped[k] = g
                self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
                self.nu[k].mul_(B2).add_(g * g, alpha=1 - B2)
                u = (self.mu[k] / (1 - B1 ** c)) / \
                    (torch.sqrt(self.nu[k] / (1 - B2 ** c)) + EPS)
                self.p[k].sub_(lr * u)
        self.count = c
        return float(loss.detach()), clipped
