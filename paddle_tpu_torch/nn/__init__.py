from .clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                        clip_grad_norm_, clip_grad_value_)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_"]
