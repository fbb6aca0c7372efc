"""Permutation-equivariant transformer coupling network (set tasks).

Counterpart of ``categoricalnf_tpu/networks/transformer.py``.  No
positional embeddings; keys of invalid elements are masked with -1e9.
A CUDA tensor always runs the whole net in one CUDA kernel
(``ops/cuda/fused_transformer.py``), key mask included, which raises on
what it does not take (a condition, sets above 128: ROADMAP B16); with
grad on, its backward is the backward kernel (at widths whose tile does
not fit otherwise, with regions of it in a global workspace: in bf16 the
residual copies at 256, in fp32 also the MLP pair from 192 and qkv at 256;
in fp32 at sets of 33 to 128 a set over a thread-block cluster), and a
call whose backward tile would not fit even so raises before the forward
launches.  A CPU tensor takes the unfused
path, ``plain_forward``, which is also the kernels' plain version
(autograd through it for the backward).  The reference's ``fused`` switch
has no counterpart: the device chooses.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from categoricalnf_tpu_torch.networks.common import (Dense, concat_cond,
                                                     layer_norm, torch_dtype)
from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


class _Block(nn.Module):
    def __init__(self, h: int, mlp_ratio: int, generator):
        super().__init__()
        self.qkv = Dense(h, 3 * h, generator=generator)
        self.proj = Dense(h, h, scale=0.5, generator=generator)
        self.fc1 = Dense(h, mlp_ratio * h, generator=generator)
        self.fc2 = Dense(mlp_ratio * h, h, scale=0.5, generator=generator)


class SetTransformer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, cond_dim: int = 0, *,
                 hidden_dim: int = 128, num_heads: int = 4,
                 num_layers: int = 2, mlp_ratio: int = 2,
                 compute_dtype: str = "bfloat16", generator=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.mlp_ratio = mlp_ratio
        self.compute_dtype = compute_dtype
        self._packed = None
        self.embed = Dense(in_dim + cond_dim, hidden_dim, generator=generator)
        self.out = Dense(hidden_dim, out_dim, zero=True, generator=generator)
        self.blocks = nn.ModuleList(
            _Block(hidden_dim, mlp_ratio, generator)
            for _ in range(num_layers))

    def _attention(self, blk, h, mask, cd):
        B, T, H = h.shape
        nh, hd = self.num_heads, H // self.num_heads
        qkv = blk.qkv(layer_norm(h), cd).reshape(B, T, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # bf16 operands, fp32 sums: the products are exact in fp32
        logits = (at_least_f32(q) @ at_least_f32(k).transpose(-1, -2)
                  / math.sqrt(hd))
        if mask is not None:
            logits = logits.masked_fill(~mask.bool()[:, None, None, :], -1e9)
        attn = torch.softmax(logits, dim=-1)
        out = at_least_f32(attn.to(cd)) @ at_least_f32(v)
        return blk.proj(out.transpose(1, 2).reshape(B, T, H), cd)

    def _packed_weights(self, cd):
        """The kernel's weights, cast once and kept until a parameter is
        replaced (``.to``) or written in place (loading, data init)."""
        params = tuple(self.parameters())
        key = (cd,) + tuple((id(p), p._version) for p in params)
        if self._packed is None or self._packed[0] != key:
            # holding ``params`` keeps their ids from being reused
            self._packed = (key, params,
                            ft.PackedWeights(ft.flatten_params(self), cd))
        return self._packed[2]

    def check_backward_fits(self, x) -> None:
        """Raise unless the backward kernel takes this net at x's set size
        where the forward does: a differentiable call is refused before its
        forward launches.  A set above 128 rows raises ``ValueError`` here
        (ROADMAP B16: no kernel takes it); another call the forward refuses
        raises there.  Every net of the reference's configs fits in both
        dtypes, the wide ones with regions of the tile in global memory
        (GraphCNF's node flow at hidden 192 and 256 in fp32, at 256 in
        bf16), and sets of 33 to 128 at the set tasks' widths (in fp32 a set
        over a thread-block cluster); what is left is a tile too large even
        so (a width above 264 in fp32, above 256 or an MLP ratio of 4 at 256
        in bf16, at sets of 24; in fp32 at sets above 32, whose instance has
        no workspace, a width of 120 or more)."""
        cd = torch_dtype(self.compute_dtype)
        H, mlp = self.hidden_dim, self.mlp_ratio * self.hidden_dim
        if x.dim() == 3 and x.shape[1] > ft.MAX_BIG_SET:
            raise ValueError(
                f"the fused SetTransformer kernels take sets up to "
                f"{ft.MAX_BIG_SET} rows, not {x.shape[1]} (ROADMAP.md, "
                f"Queue B, B16)")
        if not ft.supported(x, None, None, H, self.num_heads,
                            self.mlp_ratio, cd):
            return
        if not ft.bwd_fits(cd, x.shape[1], x.shape[2], H, mlp,
                           self.out.w.shape[1], self.num_heads,
                           self.num_layers):
            raise NotImplementedError(
                f"the fused SetTransformer backward has no tile for width "
                f"{H} at sets of {x.shape[1]} in {self.compute_dtype}: its "
                f"shared memory is over {ft.MAX_SMEM} bytes even with its "
                f"regions in global memory (at sets above {ft.MAX_SET} in "
                f"fp32: all in shared memory) (ROADMAP.md, Queue C: a call "
                f"the kernels refuse)")

    def forward(self, x, cond=None, mask=None):
        if not x.is_cuda:
            return self.plain_forward(x, cond, mask)
        if cond is not None:
            raise NotImplementedError(
                "the fused SetTransformer kernel takes no condition: no "
                "SetTransformer of the reference is given one")
        cd = torch_dtype(self.compute_dtype)
        if torch.is_grad_enabled():
            self.check_backward_fits(x)
            # kernel #3 forward, kernel #4 backward; the stacks of
            # flatten_params carry the weight gradients to the parameters
            return ft.FusedSetTransformer.apply(
                x, self._packed_weights(cd), self.num_heads, mask,
                *ft.flatten_params(self))
        return ft.fused_set_transformer(self._packed_weights(cd), x,
                                        num_heads=self.num_heads, mask=mask)

    def plain_forward(self, x, cond=None, mask=None):
        """The unfused net on any device: the kernel's plain version."""
        cd = torch_dtype(self.compute_dtype)
        h = self.embed(concat_cond(x, cond), cd)
        for blk in self.blocks:
            h = h + self._attention(blk, h, mask, cd)
            m = F.gelu(blk.fc1(layer_norm(h), cd), approximate="tanh")
            h = h + blk.fc2(m, cd)
        return self.out(layer_norm(h), cd)
