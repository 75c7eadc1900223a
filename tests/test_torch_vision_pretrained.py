"""Pretrained weights of the port's vision zoo
(``paddle_tpu_torch/vision/models/_utils.py``) against the reference's
(``paddle_tpu/vision/models/_utils.py``): the same weights table, so
every zoo constructor with ``pretrained=True`` resolves the same cached
file (``~/.cache/paddle_tpu/weights/<upstream name>``) and, where it is
missing, raises ``IOError`` naming that path in both packages; a file
the port's ``paddle.save`` wrote there from a seeded model loads back
bit for bit. Nothing is downloaded."""
import re

import numpy as np
import pytest
import torch

import paddle_tpu.utils as jutils
from paddle_tpu.vision.models import _utils as jutils_vision

import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import _utils as tutils
from torch_vision_common import port_on_cpu  # noqa: F401

#: each zoo constructor taking ``pretrained`` and the table's key it
#: reads; kwargs keep the models small where the file does not depend
#: on them (the key is the architecture's)
ZOO = {
    "resnet18": ("resnet18", {}), "resnet34": ("resnet34", {}),
    "resnet50": ("resnet50", {}), "resnet101": ("resnet101", {}),
    "resnet152": ("resnet152", {}),
    "vgg16": ("vgg16", {"num_classes": 0}),
    "vgg19": ("vgg19", {"num_classes": 0}),
    "mobilenet_v1": ("mobilenetv1_1.0", {}),
    "mobilenet_v2": ("mobilenetv2_1.0", {}),
    "alexnet": ("alexnet", {}),
    "squeezenet1_0": ("squeezenet1_0", {}),
    "squeezenet1_1": ("squeezenet1_1", {}),
    "mobilenet_v3_small": ("mobilenet_v3_small_1.0", {}),
    "mobilenet_v3_large": ("mobilenet_v3_large_1.0", {}),
    "shufflenet_v2_x1_0": ("shufflenet_v2_x1_0", {}),
    "densenet121": ("densenet121", {}),
    "googlenet": ("googlenet", {}),
    "inception_v3": ("inception_v3", {}),
}


@pytest.fixture(autouse=True)
def _home(port_on_cpu, tmp_path, monkeypatch):  # noqa: F811
    """A ``HOME`` of the test's own; the reference's import-time weights
    root pointed at it too."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(jutils, "_WEIGHTS_HOME",
                        str(tmp_path / ".cache" / "paddle_tpu" / "weights"))
    yield tmp_path


def test_tables_are_equal():
    assert tutils.model_urls == jutils_vision.model_urls
    assert {key for key, _ in ZOO.values()} | {"lenet"} == set(
        tutils.model_urls)


def _path_of(message):
    return re.search(r"at (\S+)", message).group(1)


@pytest.mark.parametrize("arch", sorted(ZOO))
def test_every_arch_names_the_references_cache_path(arch, tmp_path):
    key, kw = ZOO[arch]
    with pytest.raises(IOError) as et:
        getattr(tmodels, arch)(pretrained=True, **kw)
    # the reference's loader on a stand-in model: the path depends on
    # the key alone, and the reference raises before touching the model
    with pytest.raises(IOError) as ej:
        jutils_vision.load_pretrained(object(), key)
    got, want = _path_of(str(et.value)), _path_of(str(ej.value))
    assert got == want
    assert got == str(tmp_path / ".cache" / "paddle_tpu" / "weights"
                      / tutils.model_urls[key].rsplit("/", 1)[1])


def test_unregistered_arch_raises_in_both():
    with pytest.raises(ValueError, match="vgg11"):
        tmodels.vgg11(pretrained=True, num_classes=0)
    with pytest.raises(ValueError, match="vgg11"):
        jutils_vision.load_pretrained(object(), "vgg11")


@pytest.mark.parametrize("arch", ["vgg16", "mobilenet_v2"])
def test_a_saved_file_loads(arch, tmp_path):
    key, kw = ZOO[arch]
    pt.seed(3)
    src = getattr(tmodels, arch)(**kw)
    path = tmp_path / ".cache" / "paddle_tpu" / "weights" / \
        tutils.model_urls[key].rsplit("/", 1)[1]
    pt.save(src.state_dict(), str(path))
    pt.seed(4)
    got = getattr(tmodels, arch)(pretrained=True, **kw)
    want = src.state_dict()
    for name, t in got.state_dict().items():
        assert torch.equal(t, want[name]), name
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, 64, 64)).astype(np.float32))
    src.eval()
    got.eval()
    assert torch.equal(got(x), src(x))
