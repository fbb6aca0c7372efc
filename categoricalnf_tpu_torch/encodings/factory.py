"""Encoding factory (counterpart of ``categoricalnf_tpu/encodings/factory.py``).
Only the mixture encoding is ported so far."""

from __future__ import annotations

from categoricalnf_tpu_torch.encodings.mixture import MixtureEncoding


def create_encoding(name: str, num_categories: int, dim: int = 2, **kw):
    if name in ("mixture", "mixture_model"):
        return MixtureEncoding(num_categories, dim, **kw)
    if name in ("linear_flows", "linear", "vardeq",
                "variational_dequantization"):
        raise NotImplementedError(
            f"encoding {name!r} is not ported yet (ROADMAP.md, Queue A: "
            "the other encodings)")
    raise ValueError(f"unknown encoding {name!r}")
