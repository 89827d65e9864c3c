"""Training logs and plots."""
from .plotting import plot_alignment, plot_spectrogram  # noqa: F401
from .logging import MetricLogger  # noqa: F401
