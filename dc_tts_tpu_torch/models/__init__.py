from .ssrn import SSRN  # noqa: F401
from .text2mel import Text2Mel  # noqa: F401
