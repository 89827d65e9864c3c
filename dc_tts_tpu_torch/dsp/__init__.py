"""Signal processing: STFT, emphasis filters, Griffin-Lim, wav output."""
