"""Training logs and plots."""
