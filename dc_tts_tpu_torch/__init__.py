"""DC-TTS in PyTorch with hand-written CUDA kernels for the H100.

The port of ``dc_tts_tpu`` (JAX on a TPU), module for module; it imports
neither JAX nor the JAX package. Entry points run on CUDA unless the caller
asks for the CPU.
"""
__version__ = "0.1.0"

from .config import Config, base_config, test_config  # noqa: E402
from .pipeline import Synthesizer  # noqa: E402

__all__ = ["Config", "base_config", "test_config", "Synthesizer",
           "__version__"]
