from categoricalnf_tpu_torch.tasks.graph_coloring import GraphColoringTask
from categoricalnf_tpu_torch.tasks.language import LanguageModelingTask
from categoricalnf_tpu_torch.tasks.molecules import MoleculeTask
from categoricalnf_tpu_torch.tasks.set_modeling import (SetShufflingTask,
                                                        SetSummationTask,
                                                        build_set_flow)

__all__ = ["GraphColoringTask", "LanguageModelingTask", "MoleculeTask",
           "SetShufflingTask", "SetSummationTask", "build_set_flow"]
