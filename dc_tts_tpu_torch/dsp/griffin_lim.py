"""Griffin-Lim vocoder, the port of ``dc_tts_tpu/dsp/griffin_lim.py``.

Each round is X = mag * phase(stft(istft(X))) with a 1e-8 magnitude floor,
starting from zero phase, all rounds float32. ``method="dft_pallas2"`` (the
config default) runs the whole loop through kernel K2 (``ops/gl2.py``);
``method="fft"`` is the ``torch.fft`` loop, which is also K2's plain
version.
"""
from __future__ import annotations

import functools

import torch

from ..config import Config
from .features import deemphasis
from .stft import istft, stft


def _griffin_lim_fft(mag: torch.Tensor, n_fft: int, hop: int,
                     win_length: int, n_iter: int) -> torch.Tensor:
    """The rounds in the magnitude's precision (float32, or float64 for a
    reference)."""
    X = mag.to(mag.dtype.to_complex())
    for _ in range(n_iter):
        est = stft(istft(X, n_fft, hop, win_length), n_fft, hop, win_length)
        X = mag * (est / torch.clamp(est.abs(), min=1e-8))
    return istft(X, n_fft, hop, win_length)


@functools.lru_cache(maxsize=8)
def _gl2_device_consts(n_fft: int, hop: int, win_length: int, F: int,
                       device: str) -> dict:
    from ..ops.gl2 import gl2_consts
    return {k: torch.as_tensor(v, device=device)
            for k, v in gl2_consts(n_fft, hop, win_length, F).items()}


def griffin_lim(mag: torch.Tensor, n_fft: int, hop: int, win_length: int,
                n_iter: int, method: str = "fft") -> torch.Tensor:
    """Phase reconstruction. mag (..., F, n_freq) -> (..., hop*(F-1)).
    float32, except that method "fft" keeps a float64 magnitude in float64
    (a reference for the float32 paths)."""
    if mag.dtype != torch.float64:
        mag = mag.float()
    if method == "fft":
        return _griffin_lim_fft(mag, n_fft, hop, win_length, n_iter)
    if method == "dft_pallas2":
        from ..ops.gl2 import gl2_geometry, gl2_run, scramble_mag
        F, n_freq = mag.shape[-2], mag.shape[-1]
        g = gl2_geometry(n_fft, hop, win_length, F)
        consts = _gl2_device_consts(n_fft, hop, win_length, F,
                                    str(mag.device))
        y = gl2_run(scramble_mag(mag.reshape(-1, F, n_freq), g), consts, g,
                    n_iter)
        return y.reshape(*mag.shape[:-2], -1)
    raise NotImplementedError(
        f"stft_method={method!r} is not ported; use 'dft_pallas2' or 'fft'")


def denormalize_mag(mag_norm: torch.Tensor, cfg: Config) -> torch.Tensor:
    """[0,1]-normalized spectrogram -> sharpened linear amplitude: clip ->
    dB denorm -> amplitude -> ^power."""
    mag = torch.clamp(mag_norm, 0.0, 1.0) * cfg.max_db - cfg.max_db \
        + cfg.ref_db
    return torch.pow(10.0, mag * 0.05) ** cfg.power


def spectrogram_to_wav(mag_norm: torch.Tensor, cfg: Config) -> torch.Tensor:
    """Normalized linear spectrogram (..., T, n_freq) -> waveform:
    denormalize -> Griffin-Lim -> de-emphasis. A float64 spectrogram under
    ``stft_method="fft"`` gives a float64 reference waveform."""
    wav = griffin_lim(denormalize_mag(mag_norm, cfg), cfg.n_fft,
                      cfg.hop_length, cfg.win_length, cfg.n_iter,
                      method=cfg.stft_method)
    return deemphasis(wav, cfg.preemphasis)
