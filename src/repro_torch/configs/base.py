"""Model configuration schema covering all 10 assigned architectures.

A config describes a decoder-only LM backbone assembled from a repeating
``block_pattern`` (attention / mamba / rwkv time-mix) and ``ffn_pattern``
(dense / moe) — the repeat unit is scanned over, keeping compiled HLO size
independent of depth.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int                  # 0 for attention-free archs
    d_ff: int
    vocab_size: int
    d_head: int = 128

    # repeating structure (tiled to n_layers; len must divide n_layers)
    block_pattern: Tuple[str, ...] = ("attn",)     # attn | mamba | rwkv
    ffn_pattern: Tuple[str, ...] = ("dense",)      # dense | moe

    activation: str = "swiglu"       # swiglu | geglu | sqrelu | gelu
    qkv_bias: bool = False
    window: int = 0                  # sliding-window size; 0 = full attention
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # 0 -> use d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # Mamba (used by hybrid blocks)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # RWKV6
    rwkv_head_size: int = 64
    rwkv_lora_rank: int = 64

    # modality frontend (STUB: input_specs provides precomputed embeddings)
    frontend: str = "none"           # none | vision | audio
    n_frontend_tokens: int = 0
    d_frontend: int = 0              # frontend embedding dim (pre-projection)

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "full"              # none | dots | full
    dtype: str = "float32"           # activation/compute dtype
    param_dtype: str = "float32"
    scan_chunk: int = 0              # mamba/rwkv seq chunk (0 = auto)
    loss_chunk: int = 512            # vocab-logits sequence chunking
    unroll_inner: bool = False       # unroll ALL scans (roofline-exact
                                     # dry-run compiles; never for real runs)
    attn_q_chunk: int = 0            # flash q/kv chunk override (0 = default)
    attn_kv_chunk: int = 0
    # ---- perf-iteration levers (EXPERIMENTS.md §Perf; baseline = off) -----
    attn_probs_bf16: bool = False    # flash softmax weights in bf16
    ssm_scan_bf16: bool = False      # mamba dA/dBu in bf16 (state stays f32)

    sub_quadratic: bool = False      # eligible for long_500k decode

    def __post_init__(self):
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern period {self.period}")

    @property
    def period(self) -> int:
        return int(math.lcm(len(self.block_pattern), len(self.ffn_pattern)))

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.period

    @property
    def blocks_in_group(self):
        """[(block_kind, ffn_kind)] for one repeat unit."""
        out = []
        for i in range(self.period):
            out.append((self.block_pattern[i % len(self.block_pattern)],
                        self.ffn_pattern[i % len(self.ffn_pattern)]))
        return out

    @property
    def effective_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def reduced(self) -> "ModelConfig":
        """Family-preserving small config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=self.period * 2 if self.period > 1 else 2,
            d_model=64,
            n_heads=max(4, 0) if self.n_heads else 0,
            n_kv_heads=(max(1, min(self.n_kv_heads, 2))
                        if self.n_kv_heads else 0),
            d_head=16,
            d_ff=128,
            moe_d_ff=64 if self.n_experts else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            rwkv_head_size=16,
            rwkv_lora_rank=8,
            mamba_d_state=4,
            n_frontend_tokens=8 if self.frontend != "none" else 0,
            d_frontend=32 if self.frontend != "none" else 0,
            loss_chunk=64,
            remat="none",
        )

    # ---- parameter count (for roofline MODEL_FLOPS = 6 N D) ---------------
    def param_counts(self):
        """Returns (total, active) parameter counts (active < total for MoE)."""
        D, F = self.d_model, self.d_ff
        total = active = 0
        # embeddings (+ untied unembed)
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        total += emb; active += emb
        gated = self.activation in ("swiglu", "geglu")
        for (blk, ffn) in self.blocks_in_group:
            if blk == "attn":
                a = D * self.n_heads * self.d_head * 2  # q, o
                a += D * self.n_kv_heads * self.d_head * 2  # k, v
            elif blk == "mamba":
                di, N = self.mamba_d_inner, self.mamba_d_state
                a = D * di * 2          # in_proj (x, z)
                a += di * self.mamba_d_conv
                a += di * (N * 2 + 2)   # B, C, dt rank~, A... approx
                a += di * D             # out_proj
            elif blk == "rwkv":
                H, hs, r = self.n_rwkv_heads, self.rwkv_head_size, self.rwkv_lora_rank
                a = D * D * 4 + D * D   # r,k,v,g + out
                a += D * r * 2 + 5 * D  # w lora + mixes
            else:
                raise ValueError(blk)
            if ffn == "dense":
                f_in = 2 * D * F if gated else D * F
                f = f_in + F * D
                fa = f
            else:
                Fm = self.effective_moe_d_ff
                per = (2 * D * Fm if gated else D * Fm) + Fm * D
                f = self.n_experts * per + D * self.n_experts  # + router
                fa = self.top_k * per + D * self.n_experts
                if self.n_shared_experts:
                    f += self.n_shared_experts * per
                    fa += self.n_shared_experts * per
            total += (a + f) * self.n_groups
            active += (a + fa) * self.n_groups
        return total, active
