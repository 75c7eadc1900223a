"""``paddle.vision.models`` (port of ``paddle_tpu/vision/models/``):
ResNet, LeNet, VGG, MobileNet V1 / V2 / V3, AlexNet, SqueezeNet,
ShuffleNetV2, DenseNet, GoogLeNet, InceptionV3 and the Vision
Transformer. Their layers land on the current device
(``paddle.get_device()``)."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext101_32x4d, resnext101_64x4d,
                     resnext152_32x4d, wide_resnet50_2, wide_resnet101_2)
from .lenet import LeNet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        mobilenet_v1, mobilenet_v2)
from .extras import (AlexNet, DenseNet, MobileNetV3Large,  # noqa: F401
                     MobileNetV3Small, ShuffleNetV2, SqueezeNet, alexnet,
                     densenet121, mobilenet_v3_large, mobilenet_v3_small,
                     shufflenet_v2_x1_0, squeezenet1_0, squeezenet1_1)
from .inception import (GoogLeNet, InceptionV3, googlenet,  # noqa: F401
                        inception_v3)
from .vit import (VisionTransformer, vit_base_patch16_224,  # noqa: F401
                  vit_large_patch16_224, vit_small_patch16_224)
