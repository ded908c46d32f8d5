"""GPT-2 parameters -> M per-shard parameter sets on a serve mesh
(counterpart of ``nezha_tpu/serve/sharded/reshard.py``).

The split is Megatron's, from the same table the JAX package trains and
serves with (``nezha_tpu/parallel/gspmd.py`` ``GPT2_TP_RULES``):
column-parallel qkv and fc (their output features split), row-parallel
attention and MLP projections (their input features split), a
vocab-sharded token embedding, everything else replicated. GSPMD is free
to lay a split out as it likes; explicit shards must own whole heads, so
the fused qkv weight ``[hidden, 3 * hidden]`` splits each of its q, k and
v thirds by head group: shard r takes the q, k and v columns of heads
``[r * H/M, (r + 1) * H/M)``, and the attention projection's rows follow
the same grouping (which is its contiguous split). The embedding
replicates when the vocabulary does not divide by M (GPT-2's 50257
divides by none of 2, 4, 8).

Streaming a training checkpoint onto the mesh
(:func:`reshard_checkpoint`) waits for the checkpoint interop and is
refused typed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from nezha_tpu_torch.errors import NotPortedError
from nezha_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Split:
    """How one parameter lies over the mesh: ``axis`` is split M ways
    (None: replicated); with ``groups`` > 1 the axis holds that many
    fused blocks (qkv's q | k | v), each split M ways and shard r taking
    its part of every block."""

    axis: Optional[int] = None
    groups: int = 1


REPLICATED = Split()

# Port parameter names (``h.0.attn.qkv.w``) -> placement; the JAX
# table's order and coverage.
GPT2_TP_RULES: List[Tuple[str, Split]] = [
    (r".*\.qkv\.w$", Split(1, groups=3)),
    (r".*\.qkv\.b$", Split(0, groups=3)),
    (r".*\.attn\.proj\.w$", Split(0)),
    (r".*\.mlp\.fc\.w$", Split(1)),
    (r".*\.mlp\.fc\.b$", Split(0)),
    (r".*\.mlp\.proj\.w$", Split(0)),
    (r"^wte\.embedding$", Split(0)),
    (r".*\.(attn|mlp)\.proj\.b$", REPLICATED),
    (r".*\.ln_\d+\.(scale|bias)$", REPLICATED),
    (r"^ln_f\.(scale|bias)$", REPLICATED),
    (r"^wpe\.embedding$", REPLICATED),
]


def serve_tp_rules(model_cfg, mesh_devices: int
                   ) -> List[Tuple[str, Split]]:
    """The serving table: :data:`GPT2_TP_RULES`, except that the token
    embedding replicates when ``vocab_size % mesh_devices``."""
    rules = []
    for pat, split in GPT2_TP_RULES:
        if (pat == r"^wte\.embedding$"
                and model_cfg.vocab_size % max(int(mesh_devices), 1)):
            split = REPLICATED
        rules.append((pat, split))
    return rules


def rule_for(name: str, rules: Sequence[Tuple[str, Split]]) -> Split:
    """The first rule matching ``name``; an unmatched name raises."""
    for pat, split in rules:
        if re.match(pat, name):
            return split
    raise ValueError(f"no serve placement rule covers parameter {name!r}")


def shard_slice(t: torch.Tensor, split: Split, r: int,
                m: int) -> torch.Tensor:
    """Shard r's part of ``t`` under ``split`` (the tensor itself when
    replicated)."""
    if split.axis is None:
        return t
    size = t.shape[split.axis]
    if size % (split.groups * m):
        raise ValueError(f"axis {split.axis} of {tuple(t.shape)} does not "
                         f"split into {split.groups} x {m} parts")
    block = size // split.groups
    part = block // m
    return torch.cat([t.narrow(split.axis, g * block + r * part, part)
                      for g in range(split.groups)], dim=split.axis)


def place_variables(params: Dict[str, torch.Tensor], mesh: Mesh,
                    rules: Sequence[Tuple[str, Split]]
                    ) -> List[Dict[str, torch.Tensor]]:
    """A GPT-2 ``state_dict``-like ``{name: tensor}`` -> one dict per
    shard, each on its shard's device: split leaves hold shard r's
    contiguous part, replicated leaves the whole tensor (shared by shards
    on one device)."""
    m = mesh.size
    shards: List[Dict[str, torch.Tensor]] = [{} for _ in range(m)]
    for name, t in params.items():
        split = rule_for(name, rules)
        t = t.detach()
        for r, dev in enumerate(mesh.devices):
            part = shard_slice(t, split, r, m)
            shards[r][name] = (part.to(dev) if split.axis is None
                               else part.to(dev).contiguous())
    return shards


def reshard_checkpoint(*args, **kwargs):
    """Refused: loading a training checkpoint onto the serve mesh is not
    ported yet (ROADMAP A2.2)."""
    raise NotPortedError("reshard_checkpoint (a training checkpoint onto "
                         "the serve mesh) is not ported yet (ROADMAP A2.2)")
