"""Mixture-of-experts FFN — port of ``repro.models.moe``: Switch/GShard-style
scatter dispatch with capacity, top-k routing, optional shared experts, and
the load-balancing auxiliary loss.

The reference's sharding constraints (experts over the model axis, rows
over data) place its activations, and the port's tensors are plain, so
they are dropped (``distributed.sharding.constrain`` is the identity on a
plain tensor); the launcher's data-parallel step runs each rank on its
rows, and the aux loss's shares and the dropless test read the whole
batch through ``sharding.batch_mean`` / ``batch_shards``. Its 16-way
segmented cumsum, there to keep the long cumsum local to a sequence shard,
is the same integer result as the flat cumsum written here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import batch_mean, batch_shards
from .layers import FFN_AXES, _act, ffn, init_ffn
from .param import dense_init

# logical sharding axes of init_moe's leaves
MOE_AXES = {"router": ("embed", None),
            "w_up": ("expert", "embed", "mlp"),
            "w_down": ("expert", "mlp", "embed"),
            "w_gate": ("expert", "embed", "mlp"),
            "shared": FFN_AXES}


def init_moe(gen, cfg, dtype, device):
    """The reference's tree (router, w_up, w_down, w_gate if gated, shared
    if cfg.n_shared_experts) in its draw order."""
    D, E = cfg.d_model, cfg.n_experts
    Fe = cfg.effective_moe_d_ff
    p = {"router": dense_init(gen, (D, E), dtype, device, scale=0.02),
         "w_up": dense_init(gen, (E, D, Fe), dtype, device),
         "w_down": dense_init(gen, (E, Fe, D), dtype, device)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (E, D, Fe), dtype, device)
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, cfg, Fe * cfg.n_shared_experts, dtype,
                               device)
    return p


class Routing(NamedTuple):
    """One MoE call's routing. B rows of S tokens, K choices each, laid out
    token-major: assignment a = s K + k."""
    probs: torch.Tensor        # (B, S, E) float32 router softmax
    expert_idx: torch.Tensor   # (B, S, K) chosen experts, by falling prob
    gate: torch.Tensor         # (B, A) float32, renormalised, 0 if dropped
    slot: torch.Tensor         # (B, A) slot in its expert, 0 if dropped
    keep: torch.Tensor         # (B, A) bool: within the expert's capacity
    capacity: int              # C: slots per expert per row


def assign_slots(expert_idx: torch.Tensor, gate_vals: torch.Tensor, E: int,
                 C: int):
    """Row-grouped capacity: an assignment's slot is the count of earlier
    assignments of its row to its expert, in token-major order (an
    inclusive cumsum of the one-hot over A, minus 1); those at slot >= C
    are dropped (slot 0, gate 0). Returns (gate, slot, keep), each (B, A)."""
    B = expert_idx.shape[0]
    flat_e = expert_idx.reshape(B, -1)                        # (B, A)
    onehot = F.one_hot(flat_e, E)                             # (B, A, E)
    pos = onehot.cumsum(dim=1) - 1
    slot = pos.gather(2, flat_e[..., None])[..., 0]
    keep = slot < C
    return (torch.where(keep, gate_vals.reshape(B, -1), 0.0),
            torch.where(keep, slot, 0), keep)


def routing_from_choice(probs: torch.Tensor, expert_idx: torch.Tensor,
                        capacity: int) -> Routing:
    """The routing of chosen experts: their probabilities as gates,
    renormalised by max(sum, 1e-9), and their slots under ``capacity``."""
    gate_vals = probs.gather(-1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    gate, slot, keep = assign_slots(expert_idx, gate_vals, probs.shape[-1],
                                    capacity)
    return Routing(probs, expert_idx, gate, slot, keep, capacity)


def route(p, cfg, x: torch.Tensor, no_drop: bool) -> Routing:
    """Router logits (computed in x's type, then float32), softmax, top-k,
    then ``routing_from_choice``. The capacity C is every assignment of a
    row (S K) under ``no_drop``, else the Switch capacity-factor bound."""
    S, K, E = x.shape[1], cfg.top_k, cfg.n_experts
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    # sorted=True: descending, lax.top_k's order (the order sets the slots)
    _, expert_idx = torch.topk(probs, K, dim=-1, sorted=True)
    C = S * K if no_drop else max(1, int(S * K * cfg.capacity_factor / E))
    return routing_from_choice(probs, expert_idx, C)


def aux_loss(cfg, routing: Routing) -> torch.Tensor:
    """Switch load-balancing loss: weight E sum(mean prob x top-1 share),
    the means over the whole batch where ranks hold slices of it."""
    E = cfg.n_experts
    me = batch_mean(routing.probs.mean(dim=(0, 1)))
    ce = batch_mean(F.one_hot(routing.expert_idx[..., 0],
                              E).float().mean(dim=(0, 1)))
    return cfg.router_aux_weight * E * (me * ce).sum()


def moe_ffn(p, cfg, x: torch.Tensor, no_drop: bool = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux float32 scalar). ``no_drop``
    defaults to B S K <= 4096 (decode and small batches), as in the
    reference, B being the whole batch's rows where ranks hold slices of
    it."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if no_drop is None:
        no_drop = B * batch_shards() * S * K <= 4096
    r = route(p, cfg, x, no_drop)
    C, A = r.capacity, S * K

    # dispatch into (B, E C, D): row b's assignment a goes to flat slot
    # b E C + e C + slot. Kept assignments have distinct (e, slot); a
    # dropped one adds exact zeros at slot 0 of its expert. So every sum
    # the atomic index_add_ forms is one value plus zeros: exact, and the
    # same in any order.
    xtok = x.repeat_interleave(K, dim=1)                      # (B, A, D)
    idx = r.expert_idx.reshape(B, A) * C + r.slot             # (B, A)
    rows = torch.arange(B, device=x.device)[:, None] * (E * C)
    disp = torch.zeros((B * E * C, D), dtype=x.dtype, device=x.device)
    disp.index_add_(0, (rows + idx).reshape(-1),
                    (xtok * r.keep[..., None].to(x.dtype)).reshape(-1, D))
    disp = disp.view(B, E, C, D)

    # the experts, each on its C slots of every row (grouped einsum)
    up = torch.einsum("becd,edf->becf", disp, p["w_up"])
    if "w_gate" in p:
        h = _act(cfg.activation,
                 torch.einsum("becd,edf->becf", disp, p["w_gate"])) * up
    else:
        h = _act(cfg.activation, up)
    y_e = torch.einsum("becf,efd->becd", h, p["w_down"]).reshape(B, E * C, D)

    # combine: gather each assignment's slot, weight it by its gate, and sum
    # a token's K assignments (adjacent, token-major)
    gathered = y_e.gather(1, idx[..., None].expand(B, A, D))
    out = (gathered * r.gate[..., None].to(x.dtype)).view(B, S, K, D).sum(2)
    if "shared" in p:
        out = out + ffn(p["shared"], cfg, x)
    return out, aux_loss(cfg, r)
