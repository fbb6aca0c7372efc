from categoricalnf_tpu_torch.networks.causal_transformer import \
    CausalTransformer
from categoricalnf_tpu_torch.networks.common import (Dense, concat_cond,
                                                     dense, layer_norm)
from categoricalnf_tpu_torch.networks.graph import RGCN, EdgeGNN
from categoricalnf_tpu_torch.networks.lstm import CausalLSTM
from categoricalnf_tpu_torch.networks.mlp import MLP
from categoricalnf_tpu_torch.networks.transformer import SetTransformer

__all__ = ["CausalLSTM", "CausalTransformer", "Dense", "EdgeGNN", "concat_cond", "dense",
           "layer_norm", "MLP", "RGCN", "SetTransformer"]
