"""Training: losses, optimizer, steps, checkpoints and the CLI."""
from .losses import (guided_attention_matrix, binary_divergence,  # noqa
                     l1_loss, text2mel_loss, ssrn_loss)
from .steps import (make_text2mel_step, make_ssrn_step,  # noqa: F401
                    init_text2mel_state, init_ssrn_state)
from . import checkpoint  # noqa: F401
