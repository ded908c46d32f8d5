"""Meshes and collectives (counterpart of ``nezha_tpu/parallel``): the
one-process serve mesh (:mod:`.mesh`) and the composed ring attention
(:mod:`.ring`) the sequence-sharded prefill folds with; and, over a
``torch.distributed`` group, the collectives (:mod:`.collectives`), the
int8 wire (:mod:`.quantized`), data parallelism (:mod:`.data_parallel`)
and ZeRO-1 (:mod:`.zero1`); and tensor parallelism over a one-process
``dp x tp`` mesh (:mod:`.gspmd`), imported from their modules."""

from nezha_tpu_torch.parallel.mesh import (Mesh, all_to_all, device_scope,
                                           make_mesh, pmax, ppermute, psum,
                                           ring_perm)
from nezha_tpu_torch.parallel.ring import ring_attention_lse

__all__ = ["Mesh", "all_to_all", "device_scope", "make_mesh", "pmax",
           "ppermute", "psum", "ring_attention_lse", "ring_perm"]
