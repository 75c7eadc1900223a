"""Vision Transformer (port of ``paddle_tpu/vision/models/vit.py``;
PaddleClas's ViT-B/16 family): a patch-embedding convolution, a class
token and learned positions, pre-LN blocks and a linear head on the
class token.

Attention goes through :func:`~paddle_tpu_torch.nn.functional.
scaled_dot_product_attention`, non-causal, on q, k and v sliced from
the fused projection (``[b, tokens, heads, head_dim]``). At 224 x 224
and patch 16 that is 197 tokens at head_dim 64, so without attention
dropout it takes the flash route (``sdpa_route``): the kernel B1 on a
CUDA tensor, B2 and B3 for its gradient. Each op casts by the
reference's op name under AMP. The layers land on the current device,
as ResNet's do."""
from __future__ import annotations

from ... import amp, nn
from ...amp import sites
from ...nn import functional as F
from ...nn.initializer import Constant, Normal, TruncatedNormal


class _MLP(nn.Layer):
    def __init__(self, dim, hidden, dropout=0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.act = nn.GELU()
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class _Attention(nn.Layer):
    def __init__(self, dim, num_heads, attn_dropout=0.0, dropout=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.attn_dropout = attn_dropout
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        b, s, d = x.shape
        qkv = sites.reshape(self.qkv(x), b, s, 3, self.num_heads,
                            self.head_dim)
        q, k, v = (sites.getitem(qkv, (slice(None), slice(None), i))
                   for i in range(3))
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=False, dropout_p=self.attn_dropout,
            training=self.training)
        return self.drop(self.proj(sites.reshape(out, b, s, d)))


class _Block(nn.Layer):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, dropout=0.0,
                 attn_dropout=0.0, epsilon=1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, epsilon=epsilon)
        self.attn = _Attention(dim, num_heads, attn_dropout, dropout)
        self.norm2 = nn.LayerNorm(dim, epsilon=epsilon)
        self.mlp = _MLP(dim, int(dim * mlp_ratio), dropout)

    def forward(self, x):
        x = sites.add(x, self.attn(self.norm1(x)))
        return sites.add(x, self.mlp(self.norm2(x)))


class VisionTransformer(nn.Layer):
    """ViT backbone and classification head (PaddleClas's signature,
    in part)."""

    def __init__(self, img_size=224, patch_size=16, in_channels=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, dropout=0.0, attn_dropout=0.0,
                 epsilon=1e-6):
        super().__init__()
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = nn.Conv2D(in_channels, embed_dim,
                                     kernel_size=patch_size,
                                     stride=patch_size)
        self.cls_token = self.create_parameter(
            [1, 1, embed_dim], dtype="float32",
            default_initializer=Constant(0.0))
        self.pos_embed = self.create_parameter(
            [1, n_patches + 1, embed_dim], dtype="float32",
            default_initializer=TruncatedNormal(std=0.02))
        self.pos_drop = nn.Dropout(dropout)
        self.blocks = nn.LayerList([
            _Block(embed_dim, num_heads, mlp_ratio, dropout, attn_dropout,
                   epsilon) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon)
        self.head = (nn.Linear(embed_dim, num_classes,
                               weight_attr=Normal(0.0, 0.02))
                     if num_classes > 0 else None)

    def forward_features(self, x):
        b = x.shape[0]
        x = self.patch_embed(x)                       # [b, D, H/P, W/P]
        (x,) = amp.amp_cast_inputs("flatten", [x])
        x = sites.transpose(x.flatten(2), [0, 2, 1])  # [b, N, D]
        (cls,) = amp.amp_cast_inputs("expand", [self.cls_token])
        cls = cls.expand(b, 1, self.embed_dim)
        x = sites.add(sites.concat([cls, x], axis=1), self.pos_embed)
        x = self.pos_drop(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def forward(self, x):
        feats = self.forward_features(x)
        if self.head is None:
            return feats
        return self.head(sites.getitem(feats, (slice(None), 0)))


def vit_base_patch16_224(**kwargs):
    kwargs.setdefault("embed_dim", 768)
    kwargs.setdefault("depth", 12)
    kwargs.setdefault("num_heads", 12)
    return VisionTransformer(**kwargs)


def vit_large_patch16_224(**kwargs):
    kwargs.setdefault("embed_dim", 1024)
    kwargs.setdefault("depth", 24)
    kwargs.setdefault("num_heads", 16)
    return VisionTransformer(**kwargs)


def vit_small_patch16_224(**kwargs):
    kwargs.setdefault("embed_dim", 384)
    kwargs.setdefault("depth", 12)
    kwargs.setdefault("num_heads", 6)
    return VisionTransformer(**kwargs)
