"""``paddle.nn`` (port of ``paddle_tpu/nn/__init__.py``): ``Layer`` and its
containers, the layers of ``layers/{activation,common,conv,loss,norm,
pooling,transformer}.py``, ``functional``, ``initializer``, ``utils`` and
gradient clipping. The reference's recurrent and remaining layers
(``layers/{rnn,extras}.py``) are not ported yet."""
from . import functional, initializer, norm, utils  # noqa: F401
from .clip_grad import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                        clip_grad_norm_, clip_grad_value_)
from .layer import (Layer, LayerDict, LayerList, ParameterList,  # noqa: F401
                    Sequential)
from .layers.activation import (CELU, ELU, GELU, GLU, LeakyReLU,  # noqa: F401
                                LogSigmoid, LogSoftmax, Maxout, Mish, PReLU,
                                ReLU, ReLU6, RReLU, SELU, Hardshrink,
                                Hardsigmoid, Hardswish, Hardtanh, Sigmoid,
                                Silu, Softmax, Softplus, Softshrink, Softsign,
                                Swish, Tanh, Tanhshrink)
from .layers.common import (AlphaDropout, Bilinear,  # noqa: F401
                            ChannelShuffle, CosineSimilarity, Dropout,
                            Dropout2D, Dropout3D, Embedding, Flatten,
                            Identity, Linear, Pad1D, Pad2D, Pad3D,
                            PixelShuffle, Unfold, Upsample,
                            UpsamplingBilinear2D, UpsamplingNearest2D,
                            ZeroPad2D)
from .layers.conv import Conv1D, Conv2D, Conv2DTranspose, Conv3D  # noqa: F401
from .layers.loss import (AdaptiveLogSoftmaxWithLoss,  # noqa: F401
                          BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                          CrossEntropyLoss, GaussianNLLLoss,
                          HingeEmbeddingLoss, HuberLoss, KLDivLoss, L1Loss,
                          MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                          TripletMarginLoss)
from .layers.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                          BatchNorm3D, GroupNorm, InstanceNorm1D,
                          InstanceNorm2D, InstanceNorm3D, LayerNorm,
                          LocalResponseNorm, RMSNorm, SpectralNorm,
                          SyncBatchNorm)
from .layers.pooling import (AdaptiveAvgPool1D,  # noqa: F401
                             AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool1D,
                             AvgPool2D, MaxPool1D, MaxPool2D)
from .layers.transformer import (MultiHeadAttention,  # noqa: F401
                                 Transformer, TransformerDecoder,
                                 TransformerDecoderLayer, TransformerEncoder,
                                 TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_"]
