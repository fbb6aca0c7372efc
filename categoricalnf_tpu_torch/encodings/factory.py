"""Encoding factory (counterpart of ``categoricalnf_tpu/encodings/factory.py``)."""

from __future__ import annotations

from categoricalnf_tpu_torch.encodings.dequantization import \
    VariationalDequantization
from categoricalnf_tpu_torch.encodings.linear_flows import LinearFlowEncoding
from categoricalnf_tpu_torch.encodings.mixture import MixtureEncoding


def create_encoding(name: str, num_categories: int, dim: int = 2, **kw):
    """Build an encoding by name: mixture | linear_flows | vardeq (whose dim
    is always 1)."""
    if name in ("mixture", "mixture_model"):
        return MixtureEncoding(num_categories, dim, **kw)
    if name in ("linear_flows", "linear"):
        return LinearFlowEncoding(num_categories, dim, **kw)
    if name in ("vardeq", "variational_dequantization"):
        return VariationalDequantization(num_categories, 1, **kw)
    raise ValueError(f"unknown encoding {name!r}")
