from categoricalnf_tpu_torch.encodings.base import Encoding
from categoricalnf_tpu_torch.encodings.decoders import (LinearDecoder,
                                                        MLPDecoder,
                                                        create_decoder)
from categoricalnf_tpu_torch.encodings.dequantization import \
    VariationalDequantization
from categoricalnf_tpu_torch.encodings.factory import create_encoding
from categoricalnf_tpu_torch.encodings.linear_flows import LinearFlowEncoding
from categoricalnf_tpu_torch.encodings.mixture import MixtureEncoding

__all__ = ["Encoding", "LinearDecoder", "LinearFlowEncoding", "MLPDecoder",
           "MixtureEncoding", "VariationalDequantization", "create_decoder",
           "create_encoding"]
