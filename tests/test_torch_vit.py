"""The port's Vision Transformer (``paddle_tpu_torch/vision/models/
vit.py``) against the reference's: 2 layers, dim 128, 2 heads (head_dim
64), 10 classes, batch 2, the reference's weights carried in. The
logits and every gradient of a cross-entropy loss within 1e-5 of each
tensor's largest magnitude, at two shapes:

* 32 x 32 at patch 8 (17 tokens): both packages take SDPA's ``"sdpa"``
  route;
* 96 x 96 at patch 8 (145 tokens): the port takes ``"flash_attn"``
  (``sdpa_route``: no mask, >= 128 queries, head_dim 64), non-causal,
  the plain versions of B1-B3 on the CPU; the reference's
  ``"flash_attn"`` needs a TPU, so it takes its XLA attention. The test
  counts the port's flash calls.

Also the features without a head (``num_classes=0``) and the
constructors' widths."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.vision.models import vit as jvit

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn.functional import common as tcommon
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.vision.models import vit as tvit

from torch_vision_common import (TOL, check_grads, err, model_pair,  # noqa: F401
                                 npy, port_on_cpu)

pytestmark = pytest.mark.usefixtures("port_on_cpu")

SMALL = dict(embed_dim=128, depth=2, num_heads=2, num_classes=10,
             patch_size=8)


@pytest.mark.parametrize("img,route", [(32, "sdpa"), (96, "flash_attn")])
def test_vit_logits_and_grads(img, route, monkeypatch):
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("flash_attention_plain", "fwd"),
                      ("flash_bwd_dq_plain", "bwd")):
        orig = getattr(tfa, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    tokens = (img // 8) ** 2 + 1
    shape = (2, tokens, 2, 64)
    assert tcommon.sdpa_route(shape, shape) == route
    jm, tm = model_pair(lambda: jvit.VisionTransformer(img_size=img, **SMALL),
                        lambda: tvit.VisionTransformer(img_size=img, **SMALL))
    rng = np.random.default_rng(img)
    x = rng.standard_normal((2, 3, img, img)).astype(np.float32)
    y = rng.integers(0, 10, 2).astype(np.int64)
    jlogits = jm(paddle.to_tensor(x))
    tlogits = tm(torch.from_numpy(x))
    assert err(npy(tlogits), npy(jlogits)) <= TOL
    jnn.CrossEntropyLoss()(jlogits, paddle.to_tensor(y)).backward()
    tnn.CrossEntropyLoss()(tlogits, torch.from_numpy(y)).backward()
    check_grads(jm, tm)
    flash = route == "flash_attn"
    assert calls == {"fwd": 2 * flash, "bwd": 2 * flash}


def test_vit_features_without_head():
    cfg = dict(SMALL, num_classes=0)
    jm, tm = model_pair(lambda: jvit.VisionTransformer(img_size=32, **cfg),
                        lambda: tvit.VisionTransformer(img_size=32, **cfg))
    x = np.random.default_rng(1).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    feats = tm(torch.from_numpy(x))
    assert tm.head is None and feats.shape == (1, 17, 128)
    assert err(npy(feats), npy(jm(paddle.to_tensor(x)))) <= TOL


@pytest.mark.parametrize("name,dim,depth,heads", [
    ("vit_small_patch16_224", 384, 12, 6),
    ("vit_base_patch16_224", 768, 12, 12),
    ("vit_large_patch16_224", 1024, 24, 16)])
def test_constructors(name, dim, depth, heads):
    with torch.device("meta"):
        m = getattr(tvit, name)()
    assert (m.embed_dim, len(m.blocks), m.blocks[0].attn.num_heads) == (
        dim, depth, heads)
    assert m.pos_embed.shape == (1, 197, dim)
    assert m.blocks[0].attn.head_dim == 64
