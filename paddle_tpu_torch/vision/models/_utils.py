"""Pretrained weights for the vision models (port of
``paddle_tpu/vision/models/_utils.py``). Nothing is downloaded: a
model's weights file must already be in the local cache
(``~/.cache/paddle_tpu/weights``, the reference's, under the upstream
file name); a cache miss raises with the path where the file belongs."""
from __future__ import annotations

import os

#: upstream file names, which key the cache
model_urls = {
    "resnet18": "https://paddle-hapi.bj.bcebos.com/models/resnet18.pdparams",
    "resnet34": "https://paddle-hapi.bj.bcebos.com/models/resnet34.pdparams",
    "resnet50": "https://paddle-hapi.bj.bcebos.com/models/resnet50.pdparams",
    "resnet101":
        "https://paddle-hapi.bj.bcebos.com/models/resnet101.pdparams",
    "resnet152":
        "https://paddle-hapi.bj.bcebos.com/models/resnet152.pdparams",
    "vgg16": "https://paddle-hapi.bj.bcebos.com/models/vgg16.pdparams",
    "vgg19": "https://paddle-hapi.bj.bcebos.com/models/vgg19.pdparams",
    "mobilenetv1_1.0":
        "https://paddle-hapi.bj.bcebos.com/models/mobilenetv1_1.0.pdparams",
    "mobilenetv2_1.0":
        "https://paddle-hapi.bj.bcebos.com/models/mobilenet_v2_x1.0.pdparams",
    "lenet": "https://paddle-hapi.bj.bcebos.com/models/lenet.pdparams",
    "alexnet": "https://paddle-hapi.bj.bcebos.com/models/alexnet.pdparams",
    "squeezenet1_0":
        "https://paddle-hapi.bj.bcebos.com/models/squeezenet1_0.pdparams",
    "squeezenet1_1":
        "https://paddle-hapi.bj.bcebos.com/models/squeezenet1_1.pdparams",
    "mobilenet_v3_small_1.0":
        "https://paddle-hapi.bj.bcebos.com/models/"
        "mobilenet_v3_small_x1.0.pdparams",
    "mobilenet_v3_large_1.0":
        "https://paddle-hapi.bj.bcebos.com/models/"
        "mobilenet_v3_large_x1.0.pdparams",
    "shufflenet_v2_x1_0":
        "https://paddle-hapi.bj.bcebos.com/models/shufflenet_v2_x1_0.pdparams",
    "densenet121":
        "https://paddle-hapi.bj.bcebos.com/models/densenet121.pdparams",
    "googlenet":
        "https://paddle-hapi.bj.bcebos.com/models/googlenet.pdparams",
    "inception_v3":
        "https://paddle-hapi.bj.bcebos.com/models/inception_v3.pdparams",
}

WEIGHTS_HOME = os.path.join("~", ".cache", "paddle_tpu", "weights")


def weights_path(url):
    """The cached file of ``url``; ``IOError`` naming the path when it is
    not there."""
    path = os.path.join(os.path.expanduser(WEIGHTS_HOME),
                        os.path.basename(url))
    if not os.path.exists(path):
        raise IOError(f"no network access: place the weights file at {path}"
                      f" (wanted {url})")
    return path


def load_pretrained(model, arch):
    """Load the cached weights of ``arch`` into ``model``, every key
    matching (``paddle.load``, then ``set_state_dict``)."""
    from ...framework.io import load
    url = model_urls.get(arch)
    if url is None:
        raise ValueError(f"no pretrained weights registered for '{arch}'")
    dev = next(iter(model.parameters())).device
    state = load(weights_path(url), device=dev)
    missing, unexpected = model.set_state_dict(state)
    if missing or unexpected:
        raise RuntimeError(
            f"pretrained state_dict mismatch for {arch}: "
            f"missing={list(missing)[:5]} unexpected={list(unexpected)[:5]}")
    return model
