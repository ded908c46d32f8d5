"""Mixture-of-experts with expert parallelism over an ``ep`` mesh axis
(counterpart of ``nezha_tpu/parallel/expert.py``).

The JAX package's dense-dispatch formulation, kept as it is:

- routing gives static-shape one-hot dispatch and combine tensors
  ``[T, E, C]`` (top-k gating, a fixed capacity C per expert); tokens over
  capacity are dropped, and the Switch load-balance loss keeps the
  router near uniform (:func:`_top_k_gating`);
- dispatch, the experts' two-layer GELU MLPs and combine are four
  einsums in the compute dtype (plain tensor products, outside any
  kernel);
- the expert stacks ``w_in [E, d, f]`` and ``w_out [E, f, d]`` split over
  ``ep`` (:func:`moe_ep_rules`). Where XLA inserts all-to-alls between
  the token axis and the expert axis, :class:`ShardedMoE` runs shard r's
  experts ``[r E/ep, (r + 1) E/ep)`` on its slice of the dispatch tensor
  on its device and sums the shards' partial outputs in fp32, in rank
  order, as a row-parallel layer does.

The masks are JAX's exactly: ``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does, and the capacity positions are integer-valued fp32
cumulative sums (exact below 2**24 tokens).

Routing is an argmax, so two forwards that differ by rounding (bf16
attention by the flash kernels and by composed ops, one device and an ep
mesh) send the tokens whose second and third choices nearly tie to
different experts. :func:`routing_tape` records each gating's choices in
one forward and replays them in another, so that such a comparison sees
the rounding alone (the gates, the capacity drops and the aux loss are
still each forward's own).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from nezha_tpu_torch.nn import initializers as init_lib
from nezha_tpu_torch.nn.layers import Linear, _generator
from nezha_tpu_torch.ops import gelu
from nezha_tpu_torch.tensor.policy import DEFAULT_POLICY, Policy


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.5
    aux_loss_weight: float = 0.01


class RoutingTape:
    """The experts each gating chose, in call order: recorded
    (``replay`` None) or replayed from another tape's ``choices``."""

    def __init__(self, replay: Optional[List[List[torch.Tensor]]] = None):
        self.replay = replay
        self.choices: List[List[torch.Tensor]] = []

    def take(self) -> Optional[List[torch.Tensor]]:
        if self.replay is None:
            return None
        return self.replay[len(self.choices)]


_TAPE: contextvars.ContextVar = contextvars.ContextVar(
    "nezha_torch_routing_tape", default=None)


@contextlib.contextmanager
def routing_tape(replay: Optional[List[List[torch.Tensor]]] = None):
    """Record every gating's choices inside the block (-> the tape), or,
    given another tape's ``choices``, replay them call by call. Not for a
    rematerialized forward (its recompute gates again)."""
    tape = RoutingTape(replay)
    token = _TAPE.set(tape)
    try:
        yield tape
    finally:
        _TAPE.reset(token)


def _top_k_gating(router_logits: torch.Tensor, top_k: int, num_experts: int,
                  capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dispatch ``[T, E, C]`` one-hot, combine ``[T, E, C]``, aux
    scalar), fp32. Each top-k pass takes the argmax of the probabilities
    not yet taken (or a :func:`routing_tape`'s replayed choice); a
    token's place in its expert's buffer is the count of earlier tokens
    of the pass there plus the earlier passes' totals, and a place at or
    past ``capacity`` drops it."""
    probs = torch.softmax(router_logits.float(), dim=-1)        # [T, E]
    t = probs.shape[0]
    tape = _TAPE.get()
    replay = tape.take() if tape is not None else None
    gates, masks, chosen = [], [], []
    remaining = probs
    for j in range(top_k):
        idx = (torch.argmax(remaining, dim=-1) if replay is None
               else replay[j].to(probs.device))                  # [T]
        chosen.append(idx)
        onehot = F.one_hot(idx, num_experts).to(probs.dtype)
        gates.append(torch.sum(probs * onehot, dim=-1))
        masks.append(onehot)
        remaining = remaining * (1.0 - onehot)
    if tape is not None:
        tape.choices.append(chosen)
    slots = torch.arange(capacity, device=probs.device)
    dispatch = torch.zeros((t, num_experts, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    prior = torch.zeros((num_experts,), dtype=probs.dtype,
                        device=probs.device)
    for gate, mask in zip(gates, masks):
        pos = torch.cumsum(mask, dim=0) - mask + prior[None, :]  # [T, E]
        in_cap = (pos < capacity) & (mask > 0)
        at = torch.clamp(pos, max=capacity - 1).to(torch.int64)
        sel = ((at[..., None] == slots) & in_cap[..., None]).to(probs.dtype)
        dispatch = dispatch + sel
        combine = combine + sel * gate[:, None, None]
        prior = prior + torch.sum(mask, dim=0)
    frac = torch.mean(masks[0], dim=0)       # top-1 assignment fraction
    prob = torch.mean(probs, dim=0)
    aux = num_experts * torch.sum(frac * prob)
    return dispatch, combine, aux


def _experts(xin: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
             policy: Policy) -> torch.Tensor:
    """The experts' MLPs on their buffers ``[e, C, d]`` -> ``[e, C, d]``."""
    cd = policy.compute_dtype
    h = gelu(torch.einsum("ecd,edf->ecf", xin, w_in.to(cd)))
    return torch.einsum("ecf,efd->ecd", h, w_out.to(cd))


class MoE(nn.Module):
    """Top-k routed mixture of GELU expert MLPs. ``forward(x [B, S, d])``
    -> ``(y, aux)``: the output in ``x``'s dtype and the load-balance
    loss (unweighted; GPT-2 weighs it by ``moe_aux_weight``). Weights are
    drawn router first, then ``w_in``, then ``w_out``, as JAX splits its
    key."""

    def __init__(self, cfg: MoEConfig, policy: Policy = DEFAULT_POLICY,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        g = _generator(generator, device)
        self.cfg, self.policy = cfg, policy
        init = init_lib.normal(0.02)
        self.router = Linear(cfg.d_model, cfg.num_experts, use_bias=False,
                             kernel_init=init, policy=policy, generator=g)
        self.w_in = nn.Parameter(init(
            g, (cfg.num_experts, cfg.d_model, cfg.d_ff), policy.param_dtype))
        self.w_out = nn.Parameter(init(
            g, (cfg.num_experts, cfg.d_ff, cfg.d_model), policy.param_dtype))

    def capacity(self, num_tokens: int) -> int:
        cfg = self.cfg
        return max(1, int(cfg.capacity_factor * cfg.top_k * num_tokens
                          / cfg.num_experts))

    def route(self, x: torch.Tensor):
        """-> (tokens ``[T, d]``, dispatch, combine, aux) of ``x``."""
        cfg = self.cfg
        tokens = x.reshape(-1, x.shape[-1])
        dispatch, combine, aux = _top_k_gating(
            self.router(tokens), cfg.top_k, cfg.num_experts,
            self.capacity(tokens.shape[0]))
        return tokens, dispatch, combine, aux

    def forward(self, x: torch.Tensor):
        tokens, dispatch, combine, aux = self.route(x)
        cd = self.policy.compute_dtype
        xin = torch.einsum("tec,td->ecd", dispatch.to(cd), tokens.to(cd))
        out = _experts(xin, self.w_in, self.w_out, self.policy)
        y = torch.einsum("tec,ecd->td", combine.to(cd), out)
        return y.reshape(x.shape).to(x.dtype), aux


class ShardedMoE(nn.Module):
    """A :class:`MoE` layer over an ``ep`` mesh: the router replicated on
    the residual stream's device, ``w_in[r]``/``w_out[r]`` shard r's
    experts on ``mesh.devices[r]``. Called as the layer."""

    def __init__(self, moe: MoE, w_in: Sequence[torch.Tensor],
                 w_out: Sequence[torch.Tensor], mesh):
        super().__init__()
        self.moe, self.mesh = moe, mesh
        self.w_in, self.w_out = list(w_in), list(w_out)

    def forward(self, x: torch.Tensor):
        from nezha_tpu_torch.parallel.mesh import device_scope, psum
        moe = self.moe
        tokens, dispatch, combine, aux = moe.route(x)
        cd = moe.policy.compute_dtype
        per = moe.cfg.num_experts // self.mesh.size
        partials = []
        for r, dev in enumerate(self.mesh.devices):
            experts = slice(r * per, (r + 1) * per)
            with device_scope(dev):
                xin = torch.einsum("tec,td->ecd",
                                   dispatch[:, experts].to(dev, cd),
                                   tokens.to(dev, cd))
                out = _experts(xin, self.w_in[r], self.w_out[r], moe.policy)
                partials.append(torch.einsum(
                    "tec,ecd->td", combine[:, experts].to(dev, cd),
                    out).float())
        y = psum(partials)[0].to(x.device)
        return y.reshape(x.shape).to(x.dtype), aux


# ------------------------------------------------------------ the rules
def moe_ep_rules(ep_axis: str = "ep") -> List[Tuple[str, Split]]:
    """The expert stacks split over ``ep`` on the expert axis; the router
    (and everything else) replicates. Port parameter names."""
    from nezha_tpu_torch.serve.sharded.reshard import Split
    split = Split(0, mesh_axis=ep_axis)
    return [(r".*w_in$", split), (r".*w_out$", split)]


def gpt2_moe_gspmd_rules(tp_rules=None, ep_axis: str = "ep"
                         ) -> List[Tuple[str, Split]]:
    """First-match table of the MoE GPT-2: the expert stacks over
    ``ep_axis``, the router replicated, the dense rest by ``tp_rules``
    (``GPT2_TP_RULES`` for dp x tp x ep). Strict-mode complete."""
    from nezha_tpu_torch.serve.sharded.reshard import REPLICATED
    return (moe_ep_rules(ep_axis) + [(r".*\.mlp\.router\.w$", REPLICATED)]
            + list(tp_rules or []))


def shard_moe_params(params: Dict[str, torch.Tensor], mesh
                     ) -> Dict[str, Any]:
    """A MoE layer's parameters placed per :func:`moe_ep_rules` on an
    ``ep`` mesh: a split leaf becomes its shards' list (shard r's experts
    on its device), the router stays as it is."""
    from nezha_tpu_torch.parallel.gspmd import param_specs_from_rules
    from nezha_tpu_torch.serve.sharded.reshard import shard_slice
    specs = param_specs_from_rules(params, moe_ep_rules(mesh.axis_name))
    return {n: (t if specs[n].axis is None else
                [shard_slice(t.detach(), specs[n], r, mesh.size)
                 .to(dev).contiguous().requires_grad_(t.requires_grad)
                 for r, dev in enumerate(mesh.devices)])
            for n, t in params.items()}


def dryrun_moe_step(mesh, n_experts: int, seed: int = 0) -> float:
    """One expert-parallel MoE train step on tiny shapes (d=16, f=32):
    the experts split over ``mesh`` (an ``ep`` mesh), forward, backward
    and an SGD update; -> the loss."""
    cfg = MoEConfig(d_model=16, d_ff=32, num_experts=n_experts)
    dev = mesh.devices[0]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    layer = MoE(cfg, generator=g)
    placed = shard_moe_params(dict(layer.named_parameters()), mesh)
    sharded = ShardedMoE(layer, placed["w_in"], placed["w_out"], mesh)
    x = torch.randn((4, 8, cfg.d_model), generator=g, device=dev)
    y, aux = sharded(x)
    loss = torch.mean((y - x) ** 2) + cfg.aux_loss_weight * aux
    leaves = [layer.router.w] + placed["w_in"] + placed["w_out"]
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for w, gr in zip(leaves, grads):
            w.sub_(1e-2 * gr)
    return float(loss)


__all__ = ["MoE", "MoEConfig", "RoutingTape", "ShardedMoE",
           "dryrun_moe_step", "gpt2_moe_gspmd_rules", "moe_ep_rules",
           "routing_tape", "shard_moe_params"]
