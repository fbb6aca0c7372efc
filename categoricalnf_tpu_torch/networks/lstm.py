"""Causal LSTM coupling network of the time-autoregressive flows (LM).

Counterpart of ``categoricalnf_tpu/networks/lstm.py``.  ``forward`` (the
reference's ``apply``) runs the whole sequence with teacher forcing: with
``shift`` the input is right-shifted by one step, so the output at t sees
the inputs before t only.  Every layer's input-side gates are one matmul
over all B x T rows, hoisted out of the time loop; only the recurrent
[B, H] x [H, 4H] product runs in the loop.  Sampling rolls the state one
step at a time through ``init_carry`` and ``step``.

The dtypes are the reference's: each dense layer returns the compute dtype
(``networks.common.dense``), the carry (h, c) is fp32, and the cell mixes
the compute-dtype gates with the fp32 carry, so c and h come out fp32.
PyTorch's ``nn.LSTM`` (cuDNN) keeps h and c in the compute dtype between
steps, another function, so the cell is a plain loop.  On the card that
loop is host-bound: about 15 launches a cell step.
"""

from __future__ import annotations

import torch
from torch import nn

from categoricalnf_tpu_torch.networks.common import (Dense, concat_cond,
                                                     torch_dtype)
from categoricalnf_tpu_torch.ops.numerics import at_least_f32


class _Cell(nn.Module):
    """The reference's ``{"wx", "wh"}`` of one LSTM layer."""

    def __init__(self, in_dim: int, hidden_dim: int, generator):
        super().__init__()
        self.wx = Dense(in_dim, 4 * hidden_dim, generator=generator)
        self.wh = Dense(hidden_dim, 4 * hidden_dim, generator=generator)


def _update(gates, c_prev):
    """(h, c) from the gates [.., 4H] (i, f, g, o) in the compute dtype and
    the fp32 cell state; the forget gate is biased by +1."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class CausalLSTM(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, cond_dim: int = 0, *,
                 hidden_dim: int = 256, num_layers: int = 1,
                 extra_dim: int = 0, compute_dtype: str = "bfloat16",
                 generator=None):
        """``extra_dim``: per-step features fed to the output head only
        (the channel coupling's masked-in channels of the current step)."""
        super().__init__()
        self.hidden_dim = hidden_dim
        self.compute_dtype = compute_dtype
        dims = [in_dim + cond_dim] + [hidden_dim] * num_layers
        self.cells = nn.ModuleList(_Cell(dims[i], hidden_dim, generator)
                                   for i in range(num_layers))
        self.out = Dense(hidden_dim + extra_dim, out_dim, zero=True,
                         generator=generator)

    def _state_dtype(self, cd):
        return torch.float64 if cd == torch.float64 else torch.float32

    def init_carry(self, batch: int, device=None) -> list:
        cd = torch_dtype(self.compute_dtype)
        h = torch.zeros(batch, self.hidden_dim, dtype=self._state_dtype(cd),
                        device=device or self.out.w.device)
        return [(h, h) for _ in self.cells]

    def step(self, carry, x_t, cond_t=None, extra_t=None):
        """One timestep: x_t [B, in] -> (new carry, out [B, out_dim])."""
        cd = torch_dtype(self.compute_dtype)
        h = concat_cond(x_t, cond_t)
        new = []
        for cell, (h_prev, c_prev) in zip(self.cells, carry):
            h, c = _update(cell.wx(h, cd) + cell.wh(h_prev, cd), c_prev)
            new.append((h, c))
        if extra_t is not None:
            h = torch.cat([h, extra_t.to(h.dtype)], dim=-1)
        return new, self.out(h, cd)

    def forward(self, x, cond=None, mask=None, *, shift: bool = True,
                extra=None):
        """x [B, T, in] -> [B, T, out_dim] in the compute dtype."""
        cd = torch_dtype(self.compute_dtype)
        B, T, _ = x.shape
        h = concat_cond(x, cond)
        if shift:
            h = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        seq = h.transpose(0, 1)                            # [T, B, in]
        for cell in self.cells:
            gx = cell.wx(seq, cd)                          # hoisted [T, B, 4H]
            # the recurrent weight rounded once, as dense rounds it
            wh, bh = at_least_f32(cell.wh.w.to(cd)), cell.wh.b
            h_t = gx.new_zeros(B, self.hidden_dim,
                               dtype=self._state_dtype(cd))
            c_t = h_t
            hs = []
            for t in range(T):
                rec = torch.addmm(bh, at_least_f32(h_t.to(cd)), wh).to(cd)
                h_t, c_t = _update(gx[t] + rec, c_t)
                hs.append(h_t)
            seq = torch.stack(hs)
        hs = seq.transpose(0, 1)
        if extra is not None:
            hs = torch.cat([hs, extra.to(hs.dtype)], dim=-1)
        return self.out(hs, cd)
