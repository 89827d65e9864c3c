"""Training is not ported yet; ``checkpoint`` restores parameters."""
