"""Vision Transformer (BASELINE.md vision config; reference ships ViT via
its ecosystem — implemented here natively on nn.TransformerEncoder)."""

import numpy as np

from ... import nn
from ...core.tensor import Tensor
from ...nn.initializer import Normal, TruncatedNormal


class PatchEmbed(nn.Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3, embed_dim=768):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x):
        x = self.proj(x)                          # [B, D, H/p, W/p]
        b, d = x.shape[0], x.shape[1]
        x = x.reshape([b, d, -1])
        return x.transpose([0, 2, 1])             # [B, N, D]


class VisionTransformer(nn.Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, dropout=0.0, attention_dropout=0.0):
        super().__init__()
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim)
        n = self.patch_embed.num_patches
        init = TruncatedNormal(std=0.02)
        self.cls_token = self.create_parameter((1, 1, embed_dim),
                                               default_initializer=init)
        self.pos_embed = self.create_parameter((1, n + 1, embed_dim),
                                               default_initializer=init)
        self.pos_drop = nn.Dropout(dropout)
        enc_layer = nn.TransformerEncoderLayer(
            embed_dim, num_heads, int(embed_dim * mlp_ratio),
            dropout=dropout, attn_dropout=attention_dropout,
            activation="gelu", normalize_before=True)
        self.encoder = nn.TransformerEncoder(enc_layer, depth)
        self.norm = nn.LayerNorm(embed_dim)
        self.head = nn.Linear(embed_dim, num_classes) \
            if num_classes > 0 else None

    def forward(self, x):
        x = self.patch_embed(x)                    # [B, N, D]
        b = x.shape[0]
        from ...ops.manipulation import concat, expand
        cls = expand(self.cls_token, [b, 1, self.cls_token.shape[-1]])
        x = concat([cls, x], axis=1)
        x = x + self.pos_embed
        x = self.pos_drop(x)
        x = self.encoder(x)
        x = self.norm(x)
        if self.head is not None:
            return self.head(x[:, 0])
        return x[:, 0]


def vit_base_patch16_224(**kwargs):
    cfg = dict(embed_dim=768, depth=12, num_heads=12)
    cfg.update(kwargs)
    return VisionTransformer(**cfg)


def vit_large_patch16_224(**kwargs):
    cfg = dict(embed_dim=1024, depth=24, num_heads=16)
    cfg.update(kwargs)
    return VisionTransformer(**cfg)


def vit_tiny(**kwargs):
    cfg = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
               num_classes=10)
    cfg.update(kwargs)
    return VisionTransformer(**cfg)
