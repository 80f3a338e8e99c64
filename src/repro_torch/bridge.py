"""Carry problem state across from arrays: the port's "weights".

A problem of the JAX reference, turned into numpy leaves (``np.asarray`` of
each field), becomes the port's AllocationProblem on a device, so both
packages can solve the identical problem. The dictionary holds the
reference's ``AllocationProblem`` field names (``K``, ``E``, ``c``, ``d``,
``mu``, ``g``, ``lb``, ``ub``, ``mask``), ``params``, a mapping of the
``PenaltyParams`` names (``alpha`` ... ``gamma``), and ``terms``, the
attached scenario terms as ``(kind, {param: array})`` pairs (either
package's ``PricedTerm`` turns into such a pair by :func:`terms_arrays`;
the reference's ``make_term(kind, **params)`` takes it back).

A horizon window (either package's ``HorizonProblem``, leaves (H, ...) or
(B, H, ...)) crosses as its problem's arrays plus the two coupling scalars
(:func:`horizon_arrays`, :func:`horizon_from_arrays`).

A model's parameters cross the same way: ``model_params_from_reference``
takes the reference's parameter values as numpy arrays and returns the
port's per-layer parameters; the same mapping carries a gradient tree
across, and ``adamw_state_from_reference`` the AdamW state (step and the
float32 moments).
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.problem import AllocationProblem, PenaltyParams
from .core.terms import make_term
from .device import DeviceLike, resolve_device
from .fleet.batching import FleetBatch
from .models.transformer import init_model

LEAVES = ("K", "E", "c", "d", "mu", "g", "lb", "ub", "mask")


def _host(a) -> np.ndarray:
    return np.array(a.detach().cpu() if torch.is_tensor(a) else a, np.float32)


def problem_arrays(prob) -> dict:
    """The numpy leaves of any problem with the reference's field names
    (a reference problem, or the port's): the input of
    :func:`problem_from_arrays`."""
    out = {k: _host(getattr(prob, k)) for k in LEAVES}
    out["params"] = {f: _host(getattr(prob.params, f))
                     for f in PenaltyParams._fields}
    out["terms"] = terms_arrays(prob.terms)
    return out


def terms_arrays(terms) -> list:
    """Either package's attached terms as ``(kind, {param: numpy array})``
    pairs, in attachment order."""
    return [(t.kind, {k: _host(v) for k, v in t.params.items()})
            for t in terms]


def terms_from_arrays(pairs, device: DeviceLike = None) -> tuple:
    """The port's PricedTerms from ``(kind, {param: array})`` pairs, float32
    on ``device`` (single or stacked, as the arrays are)."""
    dev = resolve_device(device)
    return tuple(make_term(kind, **params).to(dev) for kind, params in pairs)


def problem_from_arrays(arrays: Mapping, device: DeviceLike = None
                        ) -> AllocationProblem:
    """The port's AllocationProblem from the reference's fields as numpy
    arrays (single or stacked, as the arrays are), float32 on ``device``."""
    dev = resolve_device(device)
    put = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    params = PenaltyParams(*(put(arrays["params"][f])
                             for f in PenaltyParams._fields))
    return AllocationProblem(
        params=params, terms=terms_from_arrays(arrays.get("terms", ()), dev),
        **{k: put(arrays[k]) for k in LEAVES})


def fleet_batch_from_arrays(arrays: Mapping, n_true, m_true, p_true,
                            active: Optional[np.ndarray] = None,
                            device: DeviceLike = None) -> FleetBatch:
    """The port's FleetBatch from a stacked reference batch: its problem's
    fields as numpy arrays plus the per-tenant true extents."""
    return FleetBatch(
        problem=problem_from_arrays(arrays, device),
        n_true=np.asarray(n_true, np.int64),
        m_true=np.asarray(m_true, np.int64),
        p_true=np.asarray(p_true, np.int64),
        active=None if active is None else np.asarray(active, bool))


def horizon_arrays(hp) -> dict:
    """The numpy leaves of either package's ``HorizonProblem``: its
    problem's :func:`problem_arrays` and the coupling scalars."""
    return {"problem": problem_arrays(hp.problem),
            "coupling_w": _host(hp.coupling_w),
            "coupling_eps": _host(hp.coupling_eps)}


def horizon_from_arrays(arrays: Mapping, device: DeviceLike = None):
    """The port's ``HorizonProblem`` from :func:`horizon_arrays`' output,
    float32 on ``device``."""
    from .horizon.problem import HorizonProblem
    dev = resolve_device(device)
    put = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return HorizonProblem(problem_from_arrays(arrays["problem"], dev),
                          coupling_w=put(arrays["coupling_w"]),
                          coupling_eps=put(arrays["coupling_eps"]))


def model_params_from_reference(values: Mapping, cfg: ModelConfig,
                                device: DeviceLike = None) -> dict:
    """The port's model parameters from the reference's parameter values:
    the output of ``split(init_model(cfg, key))[0]`` with every leaf as a
    numpy array, whose ``groups`` leaves carry a leading ``n_groups`` axis.
    Layer l takes slice l // period of block l % period's leaves, for any
    block the port runs (an attention or Mamba block and its dense or MoE
    FFN with its shared expert, an RWKV time mix and its channel mix; a
    period of 8 for jamba). The top level carries ``embed``,
    ``final_norm``, ``unembed`` and the vision frontend's
    ``frontend_proj``. Every leaf takes the type that the port's
    ``init_model`` gives it (cfg.param_dtype, or float32 for the RWKV and
    Mamba constants), on ``device``. A model the port does not run
    raises."""
    return _layers_from_reference(values, cfg, device)


def adamw_state_from_reference(state, cfg: ModelConfig,
                               device: DeviceLike = None):
    """The port's ``AdamWState`` from the reference's (``step``, ``m``,
    ``v``; leaves as numpy arrays or anything ``np.asarray`` takes): the
    step as an int32 scalar, the moments in the per-layer layout of
    ``model_params_from_reference``, float32 on ``device``."""
    from .optim.adamw import AdamWState
    dev = resolve_device(device)
    moments = lambda tree: _layers_from_reference(tree, cfg, dev,
                                                  torch.float32)
    return AdamWState(step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=dev),
                      m=moments(state.m), v=moments(state.v))


def _layers_from_reference(values: Mapping, cfg: ModelConfig,
                           device: DeviceLike = None, dtype=None) -> dict:
    """The reference's tree (``groups`` leaves stacked over n_groups) in
    the port's per-layer layout; each leaf in ``dtype``, or in the type
    ``init_model`` gives it."""
    dev = resolve_device(device)
    # the port's own tree, shapes and types only
    like = init_model(cfg, torch.Generator(), device="meta")

    def tree(node, like, index=None):
        if isinstance(like, Mapping):       # the port's key order
            return {k: tree(node[k], v, index) for k, v in like.items()}
        a = np.asarray(node if index is None else np.asarray(node)[index],
                       np.float32)
        return torch.tensor(a, device=dev).to(dtype or like.dtype)

    return {k: ([tree(values["groups"][i % cfg.period], like["layers"][i],
                      i // cfg.period) for i in range(cfg.n_layers)]
                if k == "layers" else tree(values[k], v))
            for k, v in like.items()}
