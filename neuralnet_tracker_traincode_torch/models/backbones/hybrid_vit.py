"""Hybrid CNN/Transformer backbone (counterpart of the JAX package's
`models/backbones/hybrid_vit.py`): the ResNet18 front (7x7 stride-2 stem
straight into the four stages, no BatchNorm after the stem, no max pool),
a 1x1 projection to 248 channels plus 8 learned positional channels, a cls
token, and one post-LN encoder and one post-LN decoder layer (d 256, 8
heads, ffn 512, dropout 0.1) that decode one learned query per prediction
head. Output (B, num_heads_out, 256).

Attention is written out in plain tensor ops in the order of flax's
`MultiHeadDotProductAttention`: per-head projections, the query scaled by
1/sqrt(d_head), the dot products, softmax, dropout on the weights, the
weighted sum, the output projection. Its parameters are held in the
reference's packed layout (`in_proj_weight` (3d, d), `in_proj_bias`,
`out_proj`), which the JAX package's exporter writes from flax's q/k/v/out
projections. Module names give the reference state-dict keys
(`convnet.convnet.0` the stem, `convnet.convnet.1`-`.4` the stages,
`convnet.proj`, `convnet.position` (1, 8, H, W), `convnet.cls_token`,
`convnet.queries`, `convnet.transformer.{encoder,decoder}`). Every dropout
mask is drawn from the generator the forward is given.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuralnet_tracker_traincode_torch.models.backbones.common import BatchNorm2d, dropout, lecun_normal_
from neuralnet_tracker_traincode_torch.models.backbones.resnet import make_stages


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, dropout_rate: float):
        super().__init__()
        self.nhead = nhead
        self.dropout_rate = dropout_rate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, kv: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        B, Lq, d = query.shape
        H = self.nhead
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        heads = lambda t: t.reshape(B, -1, H, d // H).transpose(1, 2)  # noqa: E731  (B, H, L, hd)
        q = heads(F.linear(query, wq, bq))
        k = heads(F.linear(kv, wk, bk))
        v = heads(F.linear(kv, wv, bv))
        q = q / math.sqrt(d // H)
        weights = torch.softmax(torch.matmul(q, k.transpose(-2, -1)), dim=-1)
        weights = dropout(weights, self.dropout_rate, self.training, generator)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(B, Lq, d)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_ff: int, dropout_rate: float):
        super().__init__()
        self.rate = dropout_rate
        self.self_attn = MultiheadAttention(d_model, nhead, dropout_rate)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        drop = lambda t: dropout(t, self.rate, self.training, generator)  # noqa: E731
        x = self.norm1(x + drop(self.self_attn(x, x, generator)))
        ff = self.linear2(drop(F.relu(self.linear1(x))))
        return self.norm2(x + drop(ff))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_ff: int, dropout_rate: float):
        super().__init__()
        self.rate = dropout_rate
        self.self_attn = MultiheadAttention(d_model, nhead, dropout_rate)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout_rate)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        drop = lambda t: dropout(t, self.rate, self.training, generator)  # noqa: E731
        tgt = self.norm1(tgt + drop(self.self_attn(tgt, tgt, generator)))
        tgt = self.norm2(tgt + drop(self.multihead_attn(tgt, memory, generator)))
        ff = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(ff))


class _Stack(nn.Module):
    """`layers.0` and the final `norm`, the reference's key layout."""

    def __init__(self, layer: nn.Module, d_model: int):
        super().__init__()
        self.layers = nn.ModuleList([layer])
        self.norm = nn.LayerNorm(d_model, eps=1e-5)


class _Transformer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_ff: int, dropout_rate: float):
        super().__init__()
        self.encoder = _Stack(EncoderLayer(d_model, nhead, dim_ff, dropout_rate), d_model)
        self.decoder = _Stack(DecoderLayer(d_model, nhead, dim_ff, dropout_rate), d_model)


def _feature_size(input_resolution: int) -> int:
    """The side of the stage-4 map: the stem and three stages halve it."""
    n = input_resolution
    for _ in range(4):
        n = (n - 1) // 2 + 1
    return n


class HybridVitBackbone(nn.Module):
    draws_masks = True  # whether training draws dropout or stochastic-depth masks

    def __init__(self, num_heads_out: int = 4, transformer_dim: int = 256, position_enc_dim: int = 8, nhead: int = 8,
                 dropout_rate: float = 0.1, input_resolution: int = 129):
        super().__init__()
        self.num_features = transformer_dim
        self.convnet = nn.Sequential(nn.Conv2d(1, 64, 7, 2, 3, bias=False), *make_stages((2, 2, 2, 2), False, 0.1))
        self.proj = nn.Sequential(nn.Conv2d(512, transformer_dim - position_enc_dim, 1, bias=False),
                                  BatchNorm2d(transformer_dim - position_enc_dim, 0.1))
        n = _feature_size(input_resolution)
        self.position = nn.Parameter(torch.zeros(1, position_enc_dim, n, n))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, transformer_dim))
        self.queries = nn.Parameter(torch.zeros(1, num_heads_out, transformer_dim))
        self.transformer = _Transformer(transformer_dim, nhead, 2 * transformer_dim, dropout_rate)

    @torch.no_grad()
    def init_extra(self, generator: Optional[torch.Generator] = None):
        """flax's inits where they are not lecun-normal over a Conv2d or
        Linear: the positional channels, cls token and queries N(0, 1); the
        packed input projections lecun-normal over d, zero bias."""
        for p in (self.position, self.cls_token, self.queries):
            p.normal_(0.0, 1.0, generator=generator)
        for mod in self.modules():
            if isinstance(mod, MultiheadAttention):
                lecun_normal_(mod.in_proj_weight, generator)
                mod.in_proj_bias.zero_()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        z = self.proj(self.convnet(x))
        B, _, H, W = z.shape
        z = torch.cat([z, self.position.to(z.dtype).expand(B, -1, H, W)], dim=1)
        z = z.permute(0, 2, 3, 1).reshape(B, H * W, -1)  # row-major positions, as the NHWC reshape
        z = torch.cat([self.cls_token.to(z.dtype).expand(B, -1, -1), z], dim=1)
        enc, dec = self.transformer.encoder, self.transformer.decoder
        memory = enc.norm(enc.layers[0](z, generator))
        out = dec.layers[0](self.queries.expand(B, -1, -1), memory, generator)
        return dec.norm(out), None
