"""DC-TTS in PyTorch with hand-written CUDA kernels for the H100.

The port of ``dc_tts_tpu`` (JAX on a TPU), module for module; it imports
neither JAX nor the JAX package. Entry points run on CUDA unless the caller
asks for the CPU.
"""
from .config import Config, base_config, test_config  # noqa: F401
from .pipeline import Synthesizer  # noqa: F401
