"""Multi-process coordination (counterpart of ``nezha_tpu/dist``): the
native coordinator's rendezvous, key-value store, barriers and failure
detection (:mod:`.coordinator`), and the start of ``torch.distributed``
over the world it forms (:mod:`.launch`). The device collectives are in
:mod:`nezha_tpu_torch.parallel.collectives`."""

from nezha_tpu_torch.dist.coordinator import (Coordinator, CoordinatorError,
                                              JoinTimeout, ProcessGroup, join)
from nezha_tpu_torch.dist.launch import backend_for, init_torch_distributed

__all__ = ["Coordinator", "CoordinatorError", "JoinTimeout", "ProcessGroup",
           "backend_for", "init_torch_distributed", "join"]
