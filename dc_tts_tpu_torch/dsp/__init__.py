"""Signal processing: features, STFT, emphasis filters, Griffin-Lim, wav
I/O."""
# the JAX package's exports, but for its functions stft and griffin_lim,
# whose names would hide the modules of those names here
from .mel import mel_filterbank  # noqa: F401
from .stft import istft, hann_window, frame_indices  # noqa: F401
from .griffin_lim import spectrogram_to_wav  # noqa: F401
from .features import (wav_to_spectrograms, reduce_mel, preemphasis,  # noqa
                       deemphasis)
