"""Model assembly: embedding -> the layers -> final norm -> logits — port of
``repro.models.transformer``: attention and Mamba blocks with dense or MoE
FFNs, RWKV6 time-mix blocks with their channel mix, and the vision
frontend's projection of precomputed patch embeddings.

Parameters are nested dictionaries with the reference's names and shapes,
except that the reference's stacked ``groups`` (one leading ``n_groups``
axis per leaf, scanned with ``lax.scan``) become ``layers``: a list of
``cfg.n_layers`` per-layer dictionaries walked by a plain Python loop
(layer l has the kinds ``cfg.blocks_in_group[l % cfg.period]``). Caches are
a list of per-layer caches: a ``KVCache`` (written in place) for an
attention layer, an ``RWKVCache`` or a ``MambaCache`` (replaced in the
list) for an RWKV or a Mamba layer.

Four entry points: ``forward`` (teacher forcing), ``loss_fn`` (training:
the chunked cross-entropy plus the MoE aux loss, differentiable),
``prefill`` (forward + cache build), ``decode_step`` (one token). Each
takes ``use_kernel`` (see ``repro_torch.models.attention`` and
``repro_torch.models.rwkv``; the MoE FFN and the Mamba block have no
kernel). The kernels have no backward, so ``loss_fn`` defaults to the
plain route (``use_kernel=False``), as the reference's defaults to
``use_pallas=False``. Under autograd each layer runs under ``cfg.remat``
(``repro_torch.remat``): "full" keeps only its input, "dots" also the
weight products' outputs, "none" everything; the reference checkpoints its
scanned group body the same ways.

Parameters held as DTensors (the launcher's mesh step) are gathered whole
where they are read: each layer's leaves at the top of its body, inside
its remat, so "full" gathers them again in the backward instead of
keeping them (``distributed.sharding.gather``, the identity on plain
tensors).

``param_axes`` and ``cache_axes`` give the logical sharding axes of the
parameter tree and of the cache list, per layer; ``abstract_params`` is the
parameter tree on the meta device with its axes (the dry run's).
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..distributed.sharding import batch_mean, gather
from ..remat import remat
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from .attention import KVCache
from .layers import (EMBED_AXES, FFN_AXES, NORM_AXES, embed, ffn,
                     init_embedding, init_ffn, init_rmsnorm, rmsnorm,
                     rope_tables, unembed)
from .mamba import MambaCache
from .param import dense_init
from .rwkv import RWKVCache

NOT_PORTED = ("not ported: repro_torch runs attention and Mamba blocks "
              "with dense or MoE FFNs and RWKV6 blocks with their channel "
              "mix, the layer kinds of the registered configs (see "
              "ROADMAP.md)")
# the (block, ffn) kinds a layer may have
PORTED_KINDS = {("attn", "dense"), ("attn", "moe"), ("mamba", "dense"),
                ("mamba", "moe"), ("rwkv", "rwkv_cm")}


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def layer_kinds(cfg: ModelConfig):
    """[(block_kind, ffn_kind)] for each of the cfg.n_layers layers."""
    unit = cfg.blocks_in_group
    return [unit[i % cfg.period] for i in range(cfg.n_layers)]


def _check_ported(cfg: ModelConfig) -> None:
    kinds = set(layer_kinds(cfg))
    if kinds - PORTED_KINDS:
        raise NotImplementedError(f"{cfg.name}: {sorted(kinds)}: "
                                  + NOT_PORTED)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

_INIT_BLOCK = {"attn": attn_mod.init_attention, "mamba": mamba_mod.init_mamba,
               "rwkv": rwkv_mod.init_rwkv_time_mix}
_INIT_FFN = {"moe": moe_mod.init_moe,
             "rwkv_cm": rwkv_mod.init_rwkv_channel_mix}


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: DeviceLike = None):
    """Random parameters in cfg.param_dtype on ``device`` (default "cuda"),
    drawn from ``generator`` (a torch.Generator on that device)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)
    D = cfg.d_model
    params = {"embed": init_embedding(generator, cfg.vocab_size, D, dtype,
                                      dev)}
    params["layers"] = []
    for blk, fk in layer_kinds(cfg):
        mix = _INIT_BLOCK[blk](generator, cfg, dtype, dev)
        ffn_p = (init_ffn(generator, cfg, cfg.d_ff, dtype, dev)
                 if fk == "dense" else _INIT_FFN[fk](generator, cfg, dtype,
                                                     dev))
        params["layers"].append({"norm1": init_rmsnorm(D, dtype, dev),
                                 "mix": mix,
                                 "norm2": init_rmsnorm(D, dtype, dev),
                                 "ffn": ffn_p})
    params["final_norm"] = init_rmsnorm(D, dtype, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(generator, cfg.vocab_size, D,
                                           dtype, dev)
    if cfg.frontend == "vision":
        params["frontend_proj"] = dense_init(
            generator, (cfg.d_frontend, D), dtype, dev)
    return params


_BLOCK_AXES = {"attn": attn_mod.ATTENTION_AXES, "mamba": mamba_mod.MAMBA_AXES,
               "rwkv": rwkv_mod.TIME_MIX_AXES}
_FFN_AXES = {"dense": FFN_AXES, "moe": moe_mod.MOE_AXES,
             "rwkv_cm": rwkv_mod.CHANNEL_MIX_AXES}


def _pair_axes(table, tree, where: str, what: str = "param_axes"):
    """``tree``'s structure with each leaf replaced by its axes from
    ``table`` (nested dicts, lists and NamedTuples); raises, naming
    ``what``, if a leaf has none or axes of another rank."""
    if isinstance(tree, dict):
        missing = set(tree) - set(table)
        if missing:
            raise KeyError(f"{what}: no axes for {where}."
                           f"{sorted(missing)}")
        return {k: _pair_axes(table[k], v, f"{where}.{k}", what)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pair_axes(t, v, f"{where}[{i}]", what)
                for i, (t, v) in enumerate(zip(table, tree))]
    if hasattr(tree, "_fields"):
        if type(table) is not type(tree):
            raise ValueError(f"{what}: {where} is a {type(tree).__name__} "
                             f"but its axes a {type(table).__name__}")
        return type(tree)(*(_pair_axes(t, v, f"{where}.{f}", what)
                            for f, t, v in zip(tree._fields, table, tree)))
    if not isinstance(table, tuple) or len(table) != tree.ndim:
        raise ValueError(f"{what}: {where} has shape "
                         f"{tuple(tree.shape)} but axes {table}")
    return table


def param_axes(cfg: ModelConfig):
    """The logical sharding axes of ``init_model(cfg, ...)``'s tree, keyed
    and ordered as it is: a tuple of axis names (or None) per leaf, one per
    dimension. The reference's axes, per layer: its stacked leading
    "layers" axis, which every rule set maps to None, is not there. Built
    from the tree that ``init_model`` makes on the meta device (no memory)
    and the init functions' tables."""
    tree = init_model(cfg, torch.Generator(), "meta")
    table = {"embed": EMBED_AXES, "final_norm": NORM_AXES,
             "unembed": EMBED_AXES, "frontend_proj": ("frontend", "embed"),
             "layers": [{"norm1": NORM_AXES, "mix": _BLOCK_AXES[blk],
                         "norm2": NORM_AXES, "ffn": _FFN_AXES[fk]}
                        for blk, fk in layer_kinds(cfg)]}
    return _pair_axes(table, tree, "params")


def abstract_params(cfg: ModelConfig):
    """(parameters on the meta device, their logical axes): the tree of
    ``init_model`` with shapes and dtypes but no memory, and
    ``param_axes(cfg)`` — the reference's dry-run pair, per layer."""
    return init_model(cfg, torch.Generator(), "meta"), param_axes(cfg)


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=None,
                device: DeviceLike = None) -> List:
    """One zeroed cache per layer: a KVCache for an attention layer (s_max
    is the KV capacity; sliding-window archs get min(s_max, window) ring
    buffers), an RWKVCache or a MambaCache for an RWKV or a Mamba layer
    (their size does not depend on s_max)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    cap = min(s_max, cfg.window) if cfg.window else s_max
    state = {"rwkv": RWKVCache, "mamba": MambaCache}
    return [KVCache.zeros(batch, cfg.n_kv_heads, cap, cfg.d_head, dtype, dev)
            if blk == "attn" else state[blk].zeros(batch, cfg, dtype, dev)
            for blk, _ in layer_kinds(cfg)]


_KV_AXES = ("batch", "kv_heads", "kv_seq", None)
_CACHE_AXES = {
    "attn": KVCache(_KV_AXES, _KV_AXES),
    "mamba": MambaCache(("batch", None, "mamba_inner"),
                        ("batch", "mamba_inner", None)),
    "rwkv": RWKVCache(("batch", "act_embed"), ("batch", "act_embed"),
                      ("batch", "rwkv_heads", None, None))}


def cache_axes(cfg: ModelConfig):
    """The logical axes of ``init_caches(cfg, ...)``'s list: per layer, its
    cache's type with a tuple of axis names (or None) per field, one per
    dimension. The reference's axes, per layer: its stacked leading
    "layers" axis is not there (as in ``param_axes``). Checked, rank by
    rank, against the caches ``init_caches`` makes on the meta device."""
    caches = init_caches(cfg, 1, 1, device="meta")
    table = [_CACHE_AXES[blk] for blk, _ in layer_kinds(cfg)]
    return _pair_axes(table, caches, "caches", "cache_axes")


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _apply_block(p, cfg, kind, x, positions, mode, cache, rope, pos=None,
                 valid=None, use_kernel=None):
    """Returns (y, cache)."""
    if kind == "rwkv":
        return rwkv_mod.rwkv_time_mix(p, cfg, x, cache, use_kernel=use_kernel)
    if kind == "mamba":
        return mamba_mod.mamba_block(p, cfg, x, cache)
    if kind != "attn":
        raise NotImplementedError(f"{kind} blocks: " + NOT_PORTED)
    if mode == "train":
        return attn_mod.attention(p, cfg, x, positions, rope=rope,
                                  use_kernel=use_kernel), cache
    if mode == "prefill":
        return attn_mod.prefill_attention(p, cfg, x, positions, cache,
                                          rope=rope, use_kernel=use_kernel)
    return attn_mod.decode_attention_step(p, cfg, x, pos, cache, rope=rope,
                                          valid=valid, use_kernel=use_kernel)


def _apply_ffn(p, cfg, kind, x, cache):
    """Returns (y, aux, cache): aux is the MoE's load-balancing loss, a
    float32 scalar tensor (0.0 for the others, a Python float: no launch);
    the RWKV channel mix threads the cache."""
    if kind == "moe":
        y, aux = moe_mod.moe_ffn(p, cfg, x)
        return y, aux, cache
    if kind == "dense":
        return ffn(p, cfg, x), 0.0, cache
    if kind == "rwkv_cm":
        y, cache = rwkv_mod.rwkv_channel_mix(p, cfg, x, cache)
        return y, 0.0, cache
    raise NotImplementedError(f"{kind} FFNs: " + NOT_PORTED)


def _first_attention(cfg) -> Optional[int]:
    """The index of the first attention layer, None if there is none."""
    return next((i for i, (blk, _) in enumerate(layer_kinds(cfg))
                 if blk == "attn"), None)


def _run_layers(cfg, params, x, positions, mode, caches=None, pos=None,
                valid=None, use_kernel=None, on_layer=None):
    """The reference's scan over layer groups as a loop over layers; caches
    (if any) are updated in the list. The RoPE tables of ``positions`` (and,
    in decode, the validity vector ``valid``) are made once for all layers,
    and only if some layer is attention.

    Returns (x, aux): aux sums the MoE layers' auxiliary losses. In
    "train" mode each layer runs under cfg.remat (``repro_torch.remat``;
    nothing is kept or recomputed where autograd records nothing).

    ``on_layer``, if given, is called after each layer's block (attention,
    time mix or Mamba) as ``on_layer(i, y, cache, rerun)``: ``y`` and ``cache``
    are what the block returned, and ``rerun(use_kernel)`` runs the same
    block again on the same input and cache with another kernel switch and
    returns its (y, cache). (A rerun attention block writes its KV cache
    slots again, with the same values.)"""
    rope = (rope_tables(positions, cfg.d_head, cfg.rope_theta)
            if _first_attention(cfg) is not None else None)
    aux = 0.0
    for i, (layer, (blk, fk)) in enumerate(zip(params["layers"],
                                               layer_kinds(cfg))):
        cache_in = caches[i] if caches is not None else None

        def one_layer(x, layer=layer, blk=blk, fk=fk, cache_in=cache_in,
                      i=i):
            layer = gather(layer)
            h = rmsnorm(layer["norm1"], x, cfg.norm_eps)
            block = partial(_apply_block, layer["mix"], cfg, blk, h,
                            positions, mode, cache_in, rope, pos, valid)
            y, cache = block(use_kernel)
            if on_layer is not None:
                on_layer(i, y, cache, block)
            x = x + y
            h = rmsnorm(layer["norm2"], x, cfg.norm_eps)
            y, layer_aux, cache = _apply_ffn(layer["ffn"], cfg, fk, h, cache)
            return x + y, layer_aux, cache

        if mode == "train":
            # teacher forcing threads no cache: the layer under cfg.remat
            x, layer_aux, cache = remat(one_layer, cfg.remat, x)
        else:
            x, layer_aux, cache = one_layer(x)
        aux = aux + layer_aux
        if caches is not None:
            caches[i] = cache
    return x, aux


def _embed_inputs(cfg, params, batch):
    """The token embeddings; with the vision frontend, the first
    n_frontend_tokens positions replaced by batch["frontend_embeds"]
    (B, n_frontend_tokens, d_frontend) projected by frontend_proj."""
    _check_ported(cfg)
    x = embed(gather(params["embed"]), batch["tokens"])
    if cfg.frontend == "vision":
        fe = batch["frontend_embeds"].to(x.dtype)
        proj = fe @ gather(params["frontend_proj"])
        x = torch.cat([proj, x[:, cfg.n_frontend_tokens:, :]], dim=1)
    return x.to(torch_dtype(cfg.dtype))


def _logits(cfg, params, x):
    x = rmsnorm(gather(params["final_norm"]), x, cfg.norm_eps)
    return unembed(gather(params.get("unembed", params["embed"])), x)


def forward(cfg: ModelConfig, params, batch,
            use_kernel: Optional[bool] = None, on_layer=None):
    """Teacher-forcing logits (B, S, V) and the auxiliary loss, the sum of
    the MoE layers' (0 without MoE). batch: tokens (B, S) integer [+
    frontend_embeds]. ``on_layer``: see ``_run_layers``."""
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_layers(cfg, params, x, positions, "train",
                         use_kernel=use_kernel, on_layer=on_layer)
    return _logits(cfg, params, x), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params, batch,
            use_kernel: Optional[bool] = False):
    """The training loss: mean next-token cross-entropy plus the MoE aux
    loss. batch: tokens and labels (B, S) integer [+ frontend_embeds].
    Returns (loss + aux, {"xent": loss, "aux": aux}), float32 scalars. The
    cross-entropy is summed over chunks of cfg.loss_chunk positions, each
    chunk's (B, chunk, V) logits in float32 (the reference's
    ``preferred_element_type=float32``), which bounds the logits buffer; S
    must be a multiple of the chunk. ``use_kernel`` defaults to False: the
    kernels have no backward. Under a mesh whose ranks hold slices of the
    batch (``launch.mesh.mesh_context``), the cross-entropy and the MoE
    aux loss are those of the whole batch (``sharding.batch_mean``)."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    x, aux = _run_layers(cfg, params, x, positions, "train",
                         use_kernel=use_kernel)
    x = rmsnorm(gather(params["final_norm"]), x, cfg.norm_eps)
    table = gather(params.get("unembed", params["embed"])["table"])
    labels = batch["labels"].long()
    chunk = min(cfg.loss_chunk, S)
    if S % chunk:
        raise ValueError(f"loss_fn: S={S} is not a multiple of the loss "
                         f"chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = x[:, sl].float() @ table.float().T          # (B, chunk, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, sl, None])[..., 0]
        total = total + (logz - gold).sum()
    # the mean over the whole batch where ranks hold slices of it
    loss = batch_mean(total / (B * S))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    return loss + aux, {"xent": loss, "aux": aux}


def prefill(cfg: ModelConfig, params, batch, s_max: int,
            use_kernel: Optional[bool] = None, on_layer=None):
    """Build caches from a full prompt. Returns (last_logits (B, V),
    caches). ``on_layer``: see ``_run_layers``."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    caches = init_caches(cfg, B, s_max, device=x.device)
    x, _ = _run_layers(cfg, params, x, positions, "prefill", caches,
                       use_kernel=use_kernel, on_layer=on_layer)
    return _logits(cfg, params, x[:, -1:, :])[:, 0], caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos: int,
                use_kernel: Optional[bool] = None, on_layer=None):
    """One decode step. tokens (B, 1) integer; pos the current position (a
    Python int). Returns (logits (B, V), caches): the list it was given,
    updated in place (KV caches written, RWKV caches replaced).
    ``on_layer``: see ``_run_layers``."""
    x = embed(gather(params["embed"]), tokens).to(torch_dtype(cfg.dtype))
    pos = int(pos)
    positions = torch.arange(pos, pos + 1, device=x.device)
    # int32, as the decode kernel takes it; the attention layers' caches
    # share one capacity
    first = _first_attention(cfg)
    valid = (None if first is None else attn_mod.decode_valid(
        cfg, pos, caches[first].k.shape[2], x.device).to(torch.int32))
    x, _ = _run_layers(cfg, params, x, positions, "decode", caches,
                       pos=pos, valid=valid, use_kernel=use_kernel,
                       on_layer=on_layer)
    return _logits(cfg, params, x)[:, 0], caches
