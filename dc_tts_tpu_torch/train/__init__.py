"""Training: losses, optimizer, steps, checkpoints and the CLI."""
