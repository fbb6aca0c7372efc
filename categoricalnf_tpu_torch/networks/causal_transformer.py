"""Causal transformer coupling network of the time-autoregressive flows (LM).

Counterpart of ``categoricalnf_tpu/networks/causal_transformer.py``, the
``--net transformer`` backbone, with ``CausalLSTM``'s API.  ``forward``
(the reference's ``apply``) is one batched causal-attention stack over the
whole sequence: with ``shift`` the input is right-shifted by one step, so
the output at t sees the inputs before t only.  Sampling rolls it one
position at a time through ``init_carry`` and ``step``, with a KV cache of
fixed shape [B, max_len, heads, hd] a layer (fp32), written at the
position, and the keys ``arange(max_len) <= pos`` attended over all of
max_len, as the reference's.  The position is a device tensor, so every
shape and every operation of a step is the same at each position.  The
cache is written in place, where the reference returns a new one: a carry
is stepped once.

The dtypes and rounding points are the reference's: the embedding plus
``pos[:T]`` cast to the compute dtype; a residual stream in the compute
dtype; LN then qkv; logits summed in fp32 from compute-dtype operands and
scaled by 1/sqrt(hd), -1e9 outside the causal mask (ANDed with the key
mask where one is given); the softmax in fp32, its probabilities rounded
to the compute dtype before the product with v; proj with residual; LN,
fc1, the tanh-approximated gelu (``jax.nn.gelu``'s default), fc2 with
residual; the final LN, ``extra`` joined after it, and the zero-initialised
output layer.  The attention is plain torch, as the reference computes it
with ``einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from categoricalnf_tpu_torch.networks.common import (Dense, concat_cond,
                                                     layer_norm, torch_dtype)
from categoricalnf_tpu_torch.networks.transformer import _Block
from categoricalnf_tpu_torch.ops.numerics import at_least_f32

MASKED_LOGIT = -1e9  # the reference's logit outside the mask


class CausalTransformer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, cond_dim: int = 0, *,
                 hidden_dim: int = 256, num_heads: int = 4,
                 num_layers: int = 2, mlp_ratio: int = 2, max_len: int = 512,
                 extra_dim: int = 0, compute_dtype: str = "bfloat16",
                 generator=None):
        """``max_len``: the KV cache's length, the longest sequence
        ``forward`` takes; ``extra_dim``: per-step features fed to the
        output head only (the channel coupling's masked-in channels of the
        current step)."""
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.embed = Dense(in_dim + cond_dim, hidden_dim, generator=generator)
        self.pos = nn.Parameter(torch.randn(max_len, hidden_dim,
                                            generator=generator) * 0.02)
        self.out = Dense(hidden_dim + extra_dim, out_dim, zero=True,
                         generator=generator)
        self.blocks = nn.ModuleList(
            _Block(hidden_dim, mlp_ratio, generator)
            for _ in range(num_layers))

    @property
    def _head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    def _cache_dtype(self, cd):
        return torch.float64 if cd == torch.float64 else torch.float32

    def forward(self, x, cond=None, mask=None, *, shift: bool = True,
                extra=None):
        """x [B, T, in] -> [B, T, out_dim] in the compute dtype; ``mask``
        [B, T] (nonzero = a valid key) is ANDed with the causal mask."""
        cd = torch_dtype(self.compute_dtype)
        B, T, _ = x.shape
        if T > self.max_len:
            raise ValueError(f"T={T} exceeds max_len={self.max_len}")
        nh, hd = self.num_heads, self._head_dim
        h = concat_cond(x, cond)
        if shift:
            h = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        h = self.embed(h, cd) + self.pos[:T].to(cd)
        keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        if mask is not None:
            keep = keep & (mask != 0)[:, None, :]           # [B, T, T]
        keep = keep[:, None] if keep.dim() == 3 else keep   # [.., 1, T, T]
        for blk in self.blocks:
            qkv = blk.qkv(layer_norm(h), cd).reshape(B, T, 3, nh, hd)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            # compute-dtype operands, fp32 sums: the products are exact
            logits = (at_least_f32(q) @ at_least_f32(k).transpose(-1, -2)
                      / math.sqrt(hd))
            attn = torch.softmax(logits.masked_fill(~keep, MASKED_LOGIT),
                                 dim=-1)
            o = at_least_f32(attn.to(cd)) @ at_least_f32(v)  # [B, nh, T, hd]
            h = h + blk.proj(o.transpose(1, 2).reshape(B, T, -1), cd)
            m = F.gelu(blk.fc1(layer_norm(h), cd), approximate="tanh")
            h = h + blk.fc2(m, cd)
        h = layer_norm(h)
        if extra is not None:
            h = torch.cat([h, extra.to(h.dtype)], dim=-1)
        return self.out(h, cd)

    def init_carry(self, batch: int, device=None) -> tuple:
        """(per-layer (k, v) caches of zeros [batch, max_len, heads, hd],
        the position 0 as a device tensor, the dense layers' weights as
        ``dense`` rounds them at every call, rounded here once for the
        rollout: a position then casts no weight)."""
        cd = torch_dtype(self.compute_dtype)
        device = device or self.out.w.device
        shape = (batch, self.max_len, self.num_heads, self._head_dim)
        caches = [tuple(torch.zeros(shape, dtype=self._cache_dtype(cd),
                                    device=device) for _ in range(2))
                  for _ in self.blocks]
        weights = {name: at_least_f32(m.w.to(cd))
                   for name, m in self.named_modules()
                   if isinstance(m, Dense)}
        return (caches, torch.zeros((), dtype=torch.long, device=device),
                weights)

    def step(self, carry, x_t, cond_t=None, extra_t=None):
        """One position: x_t = x_{t-1} [B, in] -> (carry, out [B, out_dim]),
        the output ``forward`` gives at t.  The caches are written in
        place."""
        cd = torch_dtype(self.compute_dtype)
        caches, pos, weights = carry
        B = x_t.shape[0]
        nh, hd = self.num_heads, self._head_dim

        def lin(name, x):  # ``dense`` with the carry's rounded weight
            b = self.get_submodule(name).b
            return (at_least_f32(x.to(cd)) @ weights[name] + b).to(cd)

        at = pos.reshape(1)
        h = (lin("embed", concat_cond(x_t, cond_t))
             + self.pos.index_select(0, at).to(cd))
        keep = torch.arange(self.max_len, device=pos.device) <= pos
        for i, (kc, vc) in enumerate(caches):
            blk = f"blocks.{i}."
            qkv = lin(blk + "qkv", layer_norm(h)).reshape(B, 3, nh, hd)
            q, k, v = qkv.unbind(1)                           # [B, nh, hd]
            kc.index_copy_(1, at, k.to(kc.dtype)[:, None])
            vc.index_copy_(1, at, v.to(vc.dtype)[:, None])
            # the cache holds compute-dtype values (a dense layer's output,
            # or zeros), so its cast to the compute dtype is exact: the
            # reference's kc.astype(compute dtype) is kc itself
            logits = torch.einsum("bhd,blhd->bhl", at_least_f32(q),
                                  kc) / math.sqrt(hd)
            attn = torch.softmax(logits.masked_fill(~keep, MASKED_LOGIT),
                                 dim=-1)
            o = torch.einsum("bhl,blhd->bhd", at_least_f32(attn.to(cd)), vc)
            h = h + lin(blk + "proj", o.reshape(B, -1))
            m = F.gelu(lin(blk + "fc1", layer_norm(h)), approximate="tanh")
            h = h + lin(blk + "fc2", m)
        h = layer_norm(h)
        if extra_t is not None:
            h = torch.cat([h, extra_t.to(h.dtype)], dim=-1)
        return (caches, pos + 1, weights), lin("out", h)
