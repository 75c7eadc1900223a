"""RMSNorm and its functional where the Llama path first imported them;
they live in ``layers/norm.py`` and ``functional/norm.py``."""
from .functional.norm import rms_norm  # noqa: F401
from .layers.norm import RMSNorm  # noqa: F401
