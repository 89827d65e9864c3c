"""Text2Mel, SSRN and their layers."""
from .layers import (init_embedding, embedding_lookup, init_layer_norm,  # noqa
                     layer_norm, init_conv, conv1d, init_deconv,
                     conv1d_transpose)
from .text2mel import Text2Mel  # noqa: F401
from .ssrn import SSRN  # noqa: F401
