"""Plain PyTorch version of the ``alloc_objective`` kernel — port of the
jnp oracle ``repro.kernels.alloc_objective.ref``.

The CPU path of every wrapper in ``ops``, and what ``chip_smoke.py`` holds
the CUDA kernel to on the card.

X is computed in K's type (float32 everywhere in the port; float64 where
``chip_smoke.py`` scores both versions against eq. (1) in double).

Shapes: X (S, n) starts for one problem with K (m, n), E (p, n), c (n,),
d (m,) and scalar params; or, for the fleet forms, X (B, T, n) with
K (B, m, n), E (B, p, n), c (B, n), d (B, m) and params (B,) each.
"""
from __future__ import annotations

import torch


def alloc_objective_ref(X, K, E, c, d, alpha, beta1, beta2, beta3, gamma):
    """One problem, S points: (f (S,), grad (S, n))."""
    X = X.to(K.dtype)
    KX = torch.einsum("mn,sn->sm", K, X)               # (S, m)
    EX = torch.einsum("pn,sn->sp", E, X)               # (S, p)
    p = E.shape[0]

    base = X @ c                                       # (S,)
    consol = alpha * (p - torch.exp(-beta1 * EX).sum(-1))
    volume = -gamma * torch.log1p(beta2 * EX).sum(-1)
    short = torch.clamp(d[None, :] - KX, min=0.0)      # (S, m)
    shortage = beta3 * (short ** 2).sum(-1)
    f = base + consol + volume + shortage

    g_consol = alpha * beta1 * torch.einsum(
        "sp,pn->sn", torch.exp(-beta1 * EX), E)
    g_volume = -gamma * beta2 * torch.einsum(
        "sp,pn->sn", 1.0 / (1.0 + beta2 * EX), E)
    g_short = -2.0 * beta3 * torch.einsum("sm,mn->sn", short, K)
    grad = c[None, :] + g_consol + g_volume + g_short
    return f, grad


def _fleet_forward(X, K, E, c, d, alpha, beta1, beta2, beta3, gamma):
    """Shared value computation + the intermediates the gradient reuses."""
    X = X.to(K.dtype)
    KX = torch.einsum("bmn,btn->btm", K, X)            # (B, T, m)
    EX = torch.einsum("bpn,btn->btp", E, X)            # (B, T, p)

    al, b1, b2, b3, ga = (a[:, None] for a in (alpha, beta1, beta2, beta3,
                                               gamma))
    base = torch.einsum("btn,bn->bt", X, c)            # (B, T)
    exp_term = torch.exp(-b1[..., None] * EX)          # (B, T, p)
    # padded (all-zero) E rows give 1 - exp(0) = 0
    consol = al * (1.0 - exp_term).sum(-1)
    volume = -ga * torch.log1p(b2[..., None] * EX).sum(-1)
    short = torch.clamp(d[:, None, :] - KX, min=0.0)   # (B, T, m)
    shortage = b3 * (short ** 2).sum(-1)
    f = base + consol + volume + shortage
    return f, EX, exp_term, short


def alloc_objective_fleet_value(X, K, E, c, d, alpha, beta1, beta2, beta3,
                                gamma):
    """Values only (B, T): the fleet solver's Armijo-ladder evaluation."""
    return _fleet_forward(X, K, E, c, d, alpha, beta1, beta2, beta3, gamma)[0]


def alloc_objective_fleet_ref(X, K, E, c, d, alpha, beta1, beta2, beta3,
                              gamma):
    """Per-problem matrices: (f (B, T), grad (B, T, n))."""
    f, EX, exp_term, short = _fleet_forward(X, K, E, c, d, alpha, beta1,
                                            beta2, beta3, gamma)
    al, b1, b2, b3, ga = (a[:, None, None] for a in (alpha, beta1, beta2,
                                                     beta3, gamma))
    g_consol = al * b1 * torch.einsum("btp,bpn->btn", exp_term, E)
    g_volume = -ga * b2 * torch.einsum(
        "btp,bpn->btn", 1.0 / (1.0 + b2 * EX), E)
    g_short = -2.0 * b3 * torch.einsum("btm,bmn->btn", short, K)
    grad = c[:, None, :] + g_consol + g_volume + g_short
    return f, grad
