from categoricalnf_tpu_torch.tasks.graph_coloring import GraphColoringTask
from categoricalnf_tpu_torch.tasks.set_modeling import (SetShufflingTask,
                                                        SetSummationTask,
                                                        build_set_flow)

__all__ = ["GraphColoringTask", "SetShufflingTask", "SetSummationTask",
           "build_set_flow"]
