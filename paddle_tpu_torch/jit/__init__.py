"""paddle.jit (port of ``paddle_tpu/jit/__init__.py``): ``to_static`` on
``torch.compile`` (``api.py``). Not ported yet: ``jit.save``,
``jit.load`` and ``TranslatedLayer`` (the reference exports through
``jax.export``; the counterpart is ``torch.export``) and
``dy2static.py``."""
from .api import (InputSpec, StaticFunction, disable_static,  # noqa: F401
                  enable_persistent_cache, enable_static, enable_to_static,
                  ignore_module, in_dynamic_mode, in_to_static_mode,
                  not_to_static, to_static)

__all__ = ["to_static", "not_to_static", "ignore_module", "StaticFunction",
           "InputSpec", "enable_static", "disable_static", "in_dynamic_mode",
           "in_to_static_mode", "enable_to_static", "enable_persistent_cache"]
