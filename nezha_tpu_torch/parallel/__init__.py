"""Meshes and collectives (counterpart of ``nezha_tpu/parallel``): the
one-process serve mesh (:mod:`.mesh`) and the composed ring attention
(:mod:`.ring`) the sequence-sharded prefill folds with; and, over a
``torch.distributed`` group, the collectives (:mod:`.collectives`), the
int8 wire (:mod:`.quantized`), data parallelism (:mod:`.data_parallel`)
and ZeRO-1 (:mod:`.zero1`); tensor parallelism over a one-process
``dp x tp (x ep)`` mesh (:mod:`.gspmd`), the mixture-of-experts layer and
its expert parallelism (:mod:`.expert`), the GPipe pipeline over a
one-process ``dp x pp`` mesh (:mod:`.pipeline`), and sequence
parallelism over a one-process ``dp x sp`` mesh (:mod:`.ring`'s flash and
composed ring attention, :mod:`.sequence_parallel`'s Ulysses attention
and train step), imported from their modules."""

from nezha_tpu_torch.parallel.expert import (MoE, MoEConfig, ShardedMoE,
                                             dryrun_moe_step,
                                             gpt2_moe_gspmd_rules,
                                             moe_ep_rules, routing_tape,
                                             shard_moe_params)
from nezha_tpu_torch.parallel.mesh import (Mesh, SpMesh, all_to_all,
                                           device_scope, make_mesh,
                                           make_sp_mesh, pmax, ppermute,
                                           psum, ring_perm)
from nezha_tpu_torch.parallel.pipeline import (PipelineMesh, PipelineSpec,
                                               PipelineTrainStep,
                                               gpt2_pipeline_spec,
                                               make_pipeline_mesh,
                                               make_pipeline_train_step,
                                               merge_pipeline_params,
                                               stack_block_params,
                                               unstack_block_params)
from nezha_tpu_torch.parallel.ring import (ring_attention,
                                           ring_attention_lse,
                                           ring_self_attention)
from nezha_tpu_torch.parallel.sequence_parallel import (SPTrainStep,
                                                        make_sp_train_step,
                                                        shard_lm_batch,
                                                        ulysses_attention)

__all__ = ["Mesh", "MoE", "MoEConfig", "PipelineMesh", "PipelineSpec",
           "PipelineTrainStep", "SPTrainStep", "ShardedMoE", "SpMesh",
           "all_to_all", "device_scope", "dryrun_moe_step",
           "gpt2_moe_gspmd_rules", "gpt2_pipeline_spec", "make_mesh",
           "make_pipeline_mesh", "make_pipeline_train_step",
           "make_sp_mesh", "make_sp_train_step", "merge_pipeline_params",
           "moe_ep_rules", "pmax", "ppermute", "psum", "ring_attention",
           "ring_attention_lse", "ring_perm", "ring_self_attention",
           "routing_tape", "shard_lm_batch", "shard_moe_params",
           "stack_block_params", "ulysses_attention",
           "unstack_block_params"]
