from categoricalnf_tpu_torch.encodings.base import Encoding
from categoricalnf_tpu_torch.encodings.factory import create_encoding
from categoricalnf_tpu_torch.encodings.mixture import MixtureEncoding

__all__ = ["Encoding", "create_encoding", "MixtureEncoding"]
