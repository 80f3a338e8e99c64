"""Shared layers: norms, rotary embeddings, embedding/unembedding, FFNs —
port of ``repro.models.layers``.

The embedding lookup carries the reference's custom VJP as a
``torch.autograd.Function`` (``embed_lookup``): the table's gradient is
accumulated in float32 and cast to the table's type. The reference forms
it by chunked one-hot matmuls so that GSPMD can shard the work over the
vocabulary; on one device ``index_add_`` into a float32 (V, D) buffer
computes the same sum.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .param import dense_init, ones_init

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


# logical sharding axes of each init function's leaves (the reference's
# Boxed axes; ``transformer.param_axes`` pairs them with the init's tree)
NORM_AXES = {"scale": ("act_embed",)}
EMBED_AXES = {"table": ("vocab", "embed")}
FFN_AXES = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
            "w_gate": ("embed", "mlp")}


def init_rmsnorm(d: int, dtype, device):
    return {"scale": ones_init((d,), dtype, device)}


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in float32, cast back to ``x.dtype``."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, d_head: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) integer -> cos/sin (..., d_head//2) in float32."""
    half = d_head // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D/2) (or (B, S, D/2)), broadcast over
    batch and heads. Half-split rotation (not interleaved), in float32."""
    half = x.shape[-1] // 2
    cos, sin = cos[..., None, :], sin[..., None, :]    # head axis
    while cos.ndim < x.ndim:                           # leading batch axes
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, d: int, dtype, device):
    return {"table": dense_init(gen, (vocab, d), dtype, device, scale=1.0)}


class EmbedLookup(torch.autograd.Function):
    """table[tokens], with dTable summed in float32 (or in the incoming
    gradient's type where that is wider) and cast to the table's type (the
    reference's ``_embed_bwd``, ``preferred_element_type=float32``);
    tokens get no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, tokens: torch.Tensor):
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        tokens, = ctx.saved_tensors
        acc_dtype = torch.promote_types(torch.float32, g.dtype)
        acc = torch.zeros(ctx.table_shape, dtype=acc_dtype, device=g.device)
        acc.index_add_(0, tokens.reshape(-1),
                       g.reshape(-1, g.shape[-1]).to(acc_dtype))
        return acc.to(ctx.table_dtype), None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) integer -> table rows (B, S, D)."""
    return EmbedLookup.apply(table, tokens.long())


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) integer -> (B, S, D)."""
    return embed_lookup(p["table"], tokens)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> logits (B, S, V)."""
    return x @ p["table"].T


# ---------------------------------------------------------------------------
# Dense FFN variants
# ---------------------------------------------------------------------------

def init_ffn(gen, cfg, d_ff: int, dtype, device):
    """The reference's draw order: w_up, w_down, then w_gate (gated only)."""
    D = cfg.d_model
    p = {"w_up": dense_init(gen, (D, d_ff), dtype, device),
         "w_down": dense_init(gen, (d_ff, D), dtype, device)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (D, d_ff), dtype, device)
    return p


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("swiglu", "silu"):
        return F.silu(x)
    if name in ("geglu", "gelu"):
        # jax.nn.gelu defaults to approximate=True: the tanh form
        return F.gelu(x, approximate="tanh")
    if name == "sqrelu":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def ffn(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D)."""
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(cfg.activation, x @ p["w_gate"]) * up
    else:
        h = _act(cfg.activation, up)
    return h @ p["w_down"]
