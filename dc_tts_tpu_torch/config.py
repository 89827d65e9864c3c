"""Static configuration of the PyTorch/CUDA port.

Field for field the same as ``dc_tts_tpu/config.py`` (names, defaults and
derived properties); the values are load-bearing for numerical parity with
the JAX package, which tests/test_torch_config_text.py checks field by field.
A frozen dataclass, so configs are hashable and ``replace`` builds the tiny
test config without editing source.

Fields keep their names and defaults so that a config means the same thing
in both packages. Every ``compute_dtype`` and ``remat`` (``models``) and
every ``stft_method`` (``dsp/griffin_lim.py``) of the JAX package is
ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # --- signal processing ---
    sr: int = 22050                # sampling rate
    n_fft: int = 2048              # FFT size (samples)
    frame_shift: float = 0.0125    # seconds
    frame_length: float = 0.05     # seconds
    n_mels: int = 80               # mel bands
    power: float = 1.5             # magnitude sharpening exponent before Griffin-Lim
    n_iter: int = 50               # Griffin-Lim iterations
    preemphasis: float = 0.97
    max_db: float = 100.0
    ref_db: float = 20.0

    # --- model ---
    r: int = 4                     # reduction factor (mel frame decimation)
    dropout_rate: float = 0.05
    e: int = 128                   # embedding width
    d: int = 256                   # Text2Mel hidden width
    c: int = 512                   # SSRN hidden width
    attention_win_size: int = 3

    # --- data ---
    data: str = "data/LJSpeech-1.1"
    test_data: str = "harvard_sentences.txt"
    vocab: str = "PE abcdefghijklmnopqrstuvwxyz'.?"  # P: pad, E: EOS
    max_N: int = 180               # max characters
    max_T: int = 210               # max (reduced) mel frames

    # --- training scheme ---
    lr: float = 0.001
    logdir: str = "logdir/LJ01"
    sampledir: str = "samples"
    B: int = 32                    # global batch size
    num_iterations: int = 2_000_000
    warmup_steps: float = 4000.0   # Noam warmup

    # --- numerics ---
    # Layer-norm epsilon (see dc_tts_tpu/config.py for why 1e-5, not TF's
    # 1e-12).
    ln_eps: float = 1e-5
    # Griffin-Lim backend. "dft_pallas2" (the default): the whole-loop
    # kernel K2 (ops/gl2.py); "dft_pallas": the mixed schedule with every
    # round through kernel K3 (ops/gl.py); "fft", "dft", "dft_3x",
    # "dft_bf16", "ct", "dft_mixed": plain torch transforms (dsp/stft.py).
    stft_method: str = "dft_pallas2"
    # training: recompute each block's activations in the backward
    # (torch.utils.checkpoint) instead of keeping them
    remat: bool = False
    # conv matmul operands (models/blocks.operand_modes): "float32" (true
    # float32), "float32_high" (the 3-pass bf16 hi/lo split), "bfloat16"
    # (bf16 operands, float32 sums; with use_pallas, K4's bf16 body),
    # "bfloat16_full" (also bf16 activations between and inside blocks)
    compute_dtype: str = "float32"
    # training only: every HC block runs kernel K4 (ops/hc_vjp.py), its CUDA
    # forward and backward on the card
    use_pallas: bool = False

    # ------------------------------------------------------------------
    @property
    def hop_length(self) -> int:
        """Samples per hop. == 275 at base config: int(22050*0.0125)."""
        return int(self.sr * self.frame_shift)

    @property
    def win_length(self) -> int:
        """Window length in samples. == 1102 at base config."""
        return int(self.sr * self.frame_length)

    @property
    def n_freq(self) -> int:
        """rfft bin count: 1 + n_fft // 2."""
        return 1 + self.n_fft // 2

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def max_T_full(self) -> int:
        """Full-resolution spectrogram frames: max_T * r."""
        return self.max_T * self.r

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def base_config() -> Config:
    """The original DC-TTS configuration (LJSpeech)."""
    return Config()


def test_config() -> Config:
    """A tiny config for fast CPU tests: same structure, small dims."""
    return Config(
        sr=8000,
        n_fft=256,
        frame_shift=8 / 8000.0,    # hop 8
        frame_length=32 / 8000.0,  # win 32
        n_mels=12,
        n_iter=4,
        e=16,
        d=32,
        c=48,
        max_N=20,
        max_T=24,
        B=2,
        dropout_rate=0.0,
    )


# keep pytest from collecting the factory as a test when imported by name
test_config.__test__ = False  # type: ignore[attr-defined]
