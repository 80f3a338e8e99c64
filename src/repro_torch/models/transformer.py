"""Model assembly: embedding -> the layers -> final norm -> logits — port of
``repro.models.transformer`` for attention blocks and dense FFNs.

Parameters are nested dictionaries with the reference's names and shapes,
except that the reference's stacked ``groups`` (one leading ``n_groups``
axis per leaf, scanned with ``lax.scan``) become ``layers``: a list of
``cfg.n_layers`` per-layer dictionaries walked by a plain Python loop
(layer l has the kinds ``cfg.blocks_in_group[l % cfg.period]``). Caches are
a list of per-layer ``KVCache``s, written in place.

Three entry points: ``forward`` (teacher forcing), ``prefill`` (forward +
KV cache build), ``decode_step`` (one token). Each takes ``use_kernel``
(see ``repro_torch.models.attention``). ``loss_fn`` waits for the training
slice; Mamba, MoE and RWKV blocks and the vision frontend raise.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import attention as attn_mod
from .attention import KVCache
from .layers import (embed, ffn, init_embedding, init_ffn, init_rmsnorm,
                     rmsnorm, rope_tables, unembed)

NOT_PORTED = ("not ported yet: this slice of repro_torch runs attention "
              "blocks and dense FFNs (ROADMAP.md queue 1, item 12)")


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def layer_kinds(cfg: ModelConfig):
    """[(block_kind, ffn_kind)] for each of the cfg.n_layers layers."""
    unit = cfg.blocks_in_group
    return [unit[i % cfg.period] for i in range(cfg.n_layers)]


def _check_ported(cfg: ModelConfig) -> None:
    kinds = set(layer_kinds(cfg))
    if cfg.frontend == "vision" or kinds - {("attn", "dense")}:
        raise NotImplementedError(
            f"{cfg.name}: {sorted(kinds)}, frontend {cfg.frontend!r}: "
            + NOT_PORTED)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

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
    params["layers"] = [
        {"norm1": init_rmsnorm(D, dtype, dev),
         "mix": attn_mod.init_attention(generator, cfg, dtype, dev),
         "norm2": init_rmsnorm(D, dtype, dev),
         "ffn": init_ffn(generator, cfg, cfg.d_ff, dtype, dev)}
        for _ in range(cfg.n_layers)]
    params["final_norm"] = init_rmsnorm(D, dtype, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(generator, cfg.vocab_size, D,
                                           dtype, dev)
    return params


def init_caches(cfg: ModelConfig, batch: int, s_max: int, dtype=None,
                device: DeviceLike = None) -> List[KVCache]:
    """One zeroed KVCache per layer. s_max is the KV capacity; sliding-window
    archs get min(s_max, window) ring buffers."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    cap = min(s_max, cfg.window) if cfg.window else s_max
    return [KVCache.zeros(batch, cfg.n_kv_heads, cap, cfg.d_head, dtype, dev)
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _apply_block(p, cfg, kind, x, positions, mode, cache, rope, pos=None,
                 valid=None, use_kernel=None):
    """Returns (y, cache)."""
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


def _apply_ffn(p, cfg, kind, x):
    if kind != "dense":
        raise NotImplementedError(f"{kind} FFNs: " + NOT_PORTED)
    return ffn(p, cfg, x)


def _run_layers(cfg, params, x, positions, mode, caches=None, pos=None,
                valid=None, use_kernel=None):
    """The reference's scan over layer groups as a loop over layers; caches
    (if any) are updated in place. The RoPE tables of ``positions`` (and, in
    decode, the validity vector ``valid``) are made once for all layers."""
    rope = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    for i, (layer, (blk, fk)) in enumerate(zip(params["layers"],
                                               layer_kinds(cfg))):
        cache = caches[i] if caches is not None else None
        h = rmsnorm(layer["norm1"], x, cfg.norm_eps)
        y, cache = _apply_block(layer["mix"], cfg, blk, h, positions, mode,
                                cache, rope, pos, valid, use_kernel)
        x = x + y
        h = rmsnorm(layer["norm2"], x, cfg.norm_eps)
        x = x + _apply_ffn(layer["ffn"], cfg, fk, h)
        if caches is not None:
            caches[i] = cache
    return x


def _embed_inputs(cfg, params, batch):
    _check_ported(cfg)
    return embed(params["embed"], batch["tokens"]).to(torch_dtype(cfg.dtype))


def _logits(cfg, params, x):
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params.get("unembed", params["embed"]), x)


def forward(cfg: ModelConfig, params, batch,
            use_kernel: Optional[bool] = None):
    """Teacher-forcing logits (B, S, V) and the auxiliary loss (0: no MoE).
    batch: tokens (B, S) integer."""
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_layers(cfg, params, x, positions, "train", use_kernel=use_kernel)
    return (_logits(cfg, params, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(cfg: ModelConfig, params, batch, s_max: int,
            use_kernel: Optional[bool] = None):
    """Build caches from a full prompt. Returns (last_logits (B, V),
    caches)."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    caches = init_caches(cfg, B, s_max, device=x.device)
    x = _run_layers(cfg, params, x, positions, "prefill", caches,
                    use_kernel=use_kernel)
    return _logits(cfg, params, x[:, -1:, :])[:, 0], caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos: int,
                use_kernel: Optional[bool] = None):
    """One decode step. tokens (B, 1) integer; pos the current position (a
    Python int). Returns (logits (B, V), caches), the caches updated in
    place."""
    x = embed(params["embed"], tokens).to(torch_dtype(cfg.dtype))
    pos = int(pos)
    positions = torch.arange(pos, pos + 1, device=x.device)
    # int32, as the decode kernel takes it
    valid = attn_mod.decode_valid(cfg, pos, caches[0].k.shape[2],
                                  x.device).to(torch.int32)
    x = _run_layers(cfg, params, x, positions, "decode", caches, pos=pos,
                    valid=valid, use_kernel=use_kernel)
    return _logits(cfg, params, x)[:, 0], caches
