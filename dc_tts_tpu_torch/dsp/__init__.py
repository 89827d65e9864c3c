"""Signal processing: features, STFT, emphasis filters, Griffin-Lim, wav
I/O."""
