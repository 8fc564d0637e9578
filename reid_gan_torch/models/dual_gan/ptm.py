"""Pose transformer cross module (port of ``reid_gan_tpu/models/dual_gan/ptm.py``
``_SeqNorm``, ``CAB``, ``TTB`` and ``PCTM``; parity: CC/dual_gan/models/
PTM.py:6-58,162-247).

Batch-first (B, L, C) token sequences in the NHWC flatten order of the JAX
package (row-major over (H, W)). The attention is flax's
``MultiHeadDotProductAttention`` written as plain matmuls and a softmax: q,
k, v projections with bias, the query scaled by 1/sqrt(head_dim), the
softmax over keys, an output projection with bias. ``_SeqNorm('batch')`` is
BatchNorm over the B·L tokens of each channel. ``PTM`` (DPTN) is not ported
yet (ROADMAP A: other generators and DPTN).
"""

import math

import torch
from torch import nn

from .base_function import get_nonlinearity


class _SeqNorm(nn.Module):
    """BatchNorm1d over the (B·L) tokens of (B, L, C) (ptm.py:26-48);
    instance norm is not ported yet
    (ROADMAP A: other generators and DPTN)."""

    def __init__(self, c, norm="batch", affine=True):
        super().__init__()
        if norm != "batch":
            raise NotImplementedError(f"sequence norm {norm!r} is not ported yet "
                                      "(ROADMAP A: other generators and DPTN)")
        self.bn = nn.BatchNorm1d(c, eps=1e-5, momentum=0.1, affine=affine)

    def forward(self, x):
        b, l, c = x.shape
        return self.bn(x.reshape(b * l, c)).reshape(b, l, c)


def _xavier_linear(in_f, out_f):
    lin = nn.Linear(in_f, out_f)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features=d_model,
    out_features=d_model)`` (ptm.py:51-54)."""

    def __init__(self, d_model, nhead):
        super().__init__()
        self.nhead, self.head_dim = nhead, d_model // nhead
        self.query = _xavier_linear(d_model, d_model)
        self.key = _xavier_linear(d_model, d_model)
        self.value = _xavier_linear(d_model, d_model)
        self.out = _xavier_linear(d_model, d_model)

    def _heads(self, t):
        b, l, _ = t.shape
        return t.reshape(b, l, self.nhead, self.head_dim).transpose(1, 2)

    def forward(self, q_in, k_in, v_in):
        q = self._heads(self.query(q_in)) / math.sqrt(self.head_dim)
        k = self._heads(self.key(k_in))
        v = self._heads(self.value(v_in))
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)     # (B, h, Lq, Lk)
        out = (attn @ v).transpose(1, 2)                          # (B, Lq, h, hd)
        return self.out(out.reshape(out.shape[0], out.shape[1], -1))


class CAB(nn.Module):
    """Context Augment Block: self-attention + FFN (ptm.py:61-84)."""

    def __init__(self, d_model, nhead=2, dim_feedforward=2048,
                 activation="LeakyReLU", affine=True, norm="batch"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = _SeqNorm(d_model, norm, affine)
        self.linear1 = _xavier_linear(d_model, dim_feedforward)
        self.linear2 = _xavier_linear(dim_feedforward, d_model)
        self.norm2 = _SeqNorm(d_model, norm, affine)
        self.act = get_nonlinearity(activation)

    def forward(self, src):
        src = self.norm1(src + self.self_attn(src, src, src))
        return self.norm2(src + self.linear2(self.act(self.linear1(src))))


class TTB(nn.Module):
    """Texture Transfer Block: self-attention, cross-attention (query tgt,
    key memory, value val), FFN (ptm.py:87-115)."""

    def __init__(self, d_model, nhead=2, dim_feedforward=2048,
                 activation="LeakyReLU", affine=True, norm="batch"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = _SeqNorm(d_model, norm, affine)
        self.multihead_attn = MultiHeadAttention(d_model, nhead)
        self.norm2 = _SeqNorm(d_model, norm, affine)
        self.linear1 = _xavier_linear(d_model, dim_feedforward)
        self.linear2 = _xavier_linear(dim_feedforward, d_model)
        self.norm3 = _SeqNorm(d_model, norm, affine)
        self.act = get_nonlinearity(activation)

    def forward(self, tgt, memory, val):
        tgt = self.norm1(tgt + self.self_attn(tgt, tgt, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt, memory, val))
        return self.norm3(tgt + self.linear2(self.act(self.linear1(tgt))))


class PCTM(nn.Module):
    """(query = pose map, value = id-feature map) cross module: CABs over the
    id tokens, TTBs with the pose tokens as query (ptm.py:149-177). NCHW maps
    in and out."""

    def __init__(self, d_model, nhead=2, num_CABs=2, num_TTBs=2,
                 dim_feedforward=256, activation="LeakyReLU", affine=True,
                 norm="batch"):
        super().__init__()
        args = (d_model, nhead, dim_feedforward, activation, affine, norm)
        for i in range(num_CABs):
            self.add_module(f"cab{i}", CAB(*args))
        for i in range(num_TTBs):
            self.add_module(f"ttb{i}", TTB(*args))
        self.num_CABs, self.num_TTBs = num_CABs, num_TTBs
        self.decoder_norm = _SeqNorm(d_model, norm, affine)

    def forward(self, query, value):
        n, c, h, w = query.shape
        memory = value.flatten(2).transpose(1, 2)
        for i in range(self.num_CABs):
            memory = getattr(self, f"cab{i}")(memory)
        out = query.flatten(2).transpose(1, 2)
        for i in range(self.num_TTBs):
            out = getattr(self, f"ttb{i}")(out, memory, memory)
        out = self.decoder_norm(out)
        return out.transpose(1, 2).reshape(n, c, h, w)
