"""Batched synthesis on one GPU: text -> mel -> linear spectrogram ->
waveform, the port of ``dc_tts_tpu/pipeline.py``'s single-device path.

The chain per batch: TextEnc -> the T-step autoregressive decode (kernel K1
in the default "fused" mode, in precision ``decode_prec``; "incremental"
and "reference" are plain torch) -> SSRN -> denormalize -> Griffin-Lim
(``cfg.stft_method``: kernel K2 under the default "dft_pallas2", kernel K3
under "dft_pallas", plain torch transforms otherwise) -> de-emphasis ->
optional 16-bit PCM quantisation on the device. Every step is enqueued on
the current CUDA stream; nothing waits for the device until results are
copied back. The mesh, pipeline and time-sharded modes are not ported.

SSRN's conv matmuls take ``ssrn_precision`` in synthesis, as in the JAX
package: "high" (the default: the 3-pass bf16 hi/lo split, the config's
``compute_dtype="float32_high"``), "highest" (the config as given) or
"bf16" (``compute_dtype="bfloat16"``). The decode kernel's layer products
take ``decode_prec`` (``ops.decode.PRECS``): "highest" (the default, float32),
"hybrid" (AudioEnc float32, AudioDec the 3-pass split), "high3" (the split
everywhere) or "default" (one bf16 pass). The reduced ones are opt-in: at
random init their rounding flips attention cursors (argmax ties of a
diffuse attention), as the JAX package measured; TextEnc stays float32.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import text as text_mod
from .config import Config
from .device import resolve_device
from .dsp.features import trim_silence
from .dsp.griffin_lim import spectrogram_to_wav
from .models.ssrn import SSRN
from .models.text2mel import Text2Mel
from .ops.decode import check_prec, pack_decode_params
from .params import to_device

DECODE_MODES = ("fused", "incremental", "reference")
# ssrn_precision -> the compute_dtype SSRN runs under (None: the config's)
SSRN_PRECISIONS = {"highest": None, "high": "float32_high",
                   "bf16": "bfloat16"}


class Synthesizer:
    """Both networks' parameters on one device, and the synthesis chain.

    device defaults to "cuda" and raises when there is no CUDA device;
    pass device="cpu" to run the plain PyTorch versions on the CPU.
    decode_mode "auto" is the fused decode kernel. ssrn_precision and
    decode_prec: see the module docstring; decode_prec is read by the fused
    mode only, as in the JAX package."""

    def __init__(self, cfg: Config, t2m_params, ssrn_params, *,
                 device="cuda", decode_mode: str = "auto",
                 pcm16: bool = False, ssrn_precision: str = "high",
                 decode_prec: str = "highest"):
        if ssrn_precision not in SSRN_PRECISIONS:
            raise ValueError(f"ssrn_precision={ssrn_precision!r}; use one "
                             f"of {tuple(SSRN_PRECISIONS)}")
        check_prec(decode_prec)
        if decode_mode == "auto":
            decode_mode = "fused"
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode={decode_mode!r}; use one of "
                             f"{('auto',) + DECODE_MODES}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.text2mel = Text2Mel(cfg)
        ssrn_dtype = SSRN_PRECISIONS[ssrn_precision]
        self.ssrn = SSRN(cfg if ssrn_dtype is None
                         else cfg.replace(compute_dtype=ssrn_dtype))
        self.t2m_params = to_device(t2m_params, self.device)
        self.ssrn_params = to_device(ssrn_params, self.device)
        self.decode_mode = decode_mode
        self.decode_prec = decode_prec
        self.pcm16 = pcm16
        # the decode kernel's weights packed for decode_prec (~29 MB at
        # base_config), made once here rather than on every batch
        self.packed = None
        if decode_mode == "fused":
            self.packed = pack_decode_params(cfg, self.t2m_params,
                                             decode_prec)

    @classmethod
    def from_checkpoints(cls, cfg: Config, logdir1: str, logdir2: str,
                         **kw) -> "Synthesizer":
        """Text2Mel from logdir1 and SSRN from logdir2 (either package's
        checkpoints); ``kw`` as the constructor's."""
        t2m_params, ssrn_params = restore_synthesis_params(cfg, logdir1,
                                                           logdir2)
        return cls(cfg, t2m_params, ssrn_params, **kw)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def synthesize_ids(self, ids):
        """ids (B, max_N) int -> (wavs (B, n_samples), Y, Z, align), all on
        the device; wavs are int16 when pcm16 is set."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                              device=self.device)
        Y, align = self.text2mel.decode(self.t2m_params, ids,
                                        mode=self.decode_mode,
                                        prec=self.decode_prec,
                                        packed=self.packed)
        _, Z = self.ssrn.apply(self.ssrn_params, Y)
        wav = spectrogram_to_wav(Z, self.cfg)
        if self.pcm16:
            wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0
                              ).to(torch.int16)
        return wav, Y, Z, align

    def synthesize_ids_chunked(self, ids, chunk: int = 40) -> np.ndarray:
        """Any batch size, in chunks of ``chunk`` rows -> wavs (B, n_samples)
        on the host. Every chunk is enqueued before any result is copied
        back; each copy is a non-blocking copy into pinned host memory, so
        a chunk's transfer overlaps the next chunks' compute."""
        ids = np.asarray(ids)
        wavs = [self.synthesize_ids(ids[i: i + chunk])[0]
                for i in range(0, ids.shape[0], chunk)]
        if self.device.type != "cuda":
            return torch.cat(wavs).numpy()
        host = []
        for w in wavs:
            h = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
            h.copy_(w, non_blocking=True)
            host.append(h)
        torch.cuda.synchronize(self.device)
        return torch.cat(host).numpy()

    def synthesize(self, sentences: Sequence[str], *, trim: bool = True):
        """Raw sentences -> list of float32 waveforms (host, trimmed)."""
        ids = text_mod.encode_batch(list(sentences), self.cfg)
        wavs = self.synthesize_ids(ids)[0].cpu().numpy()
        if wavs.dtype == np.int16:
            wavs = wavs.astype(np.float32) / 32767.0
        if trim:
            return [trim_silence(w) for w in wavs]
        return list(wavs)


def restore_synthesis_params(cfg: Config, logdir1: str, logdir2: str):
    """(t2m_params, ssrn_params) on the CPU from the two checkpoint
    namespaces: Text2Mel from logdir1, SSRN from logdir2."""
    from .train import checkpoint
    gen = torch.Generator().manual_seed(0)
    t2m_params, _ = checkpoint.restore(logdir1, Text2Mel(cfg).init(gen))
    ssrn_params, _ = checkpoint.restore(logdir2, SSRN(cfg).init(gen))
    return t2m_params, ssrn_params
