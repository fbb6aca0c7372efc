from categoricalnf_tpu_torch.tasks.set_modeling import (SetShufflingTask,
                                                        build_set_flow)

__all__ = ["SetShufflingTask", "build_set_flow"]
