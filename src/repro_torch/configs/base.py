"""Config system: architecture configs and input shapes.

Every assigned architecture is a frozen ``ModelConfig``; the configs are
pure data, copied from the reference package so that the port stands
alone.  The reference's ``input_specs`` (allocation-free
``jax.ShapeDtypeStruct`` stand-ins for the multi-pod dry-run) is not
ported: it waits with ``launch/dryrun.py`` (ROADMAP queue 1, item 13e).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # ffn hidden size per expert
    num_shared: int = 0              # shared (always-on) experts, deepseek-v3 style
    every_k_layers: int = 1          # MoE replaces the MLP on layers where
                                     # (layer_idx % every_k_layers) == every_k_layers - 1
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256                 # SSD chunk length for training


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # one period of the layer stack; repeated num_layers/len(pattern) times.
    # 'A' = self-attention mixer, 'M' = mamba mixer, 'X' = cross-attention
    # (extra gated layer, VLM).  Each entry also carries an FFN (MLP or MoE
    # per MoEConfig.every_k_layers, counted over the flat layer index).
    layer_pattern: str = "A"
    # number of layers at the start of the stack that use a dense MLP even
    # when ``moe`` is set (deepseek-v3 has 3).
    dense_prefix: int = 0
    dense_prefix_ff: int = 0         # ffn size of the dense prefix layers
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"          # "swiglu" (3 mats) | "gelu" (2 mats)
    tie_embeddings: bool = False
    # modality frontend stub: "tokens" feeds int32 ids; "embeddings" feeds
    # precomputed frame/patch embeddings of width d_model (audio), and vlm
    # additionally feeds image patch embeddings for cross-attention.
    input_mode: str = "tokens"
    num_image_tokens: int = 0        # vlm: #patch embeddings per example
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training-time attention: scan over kv blocks with online softmax when
    # seq > flash_block, bounding activation memory (flash-style).
    flash_block: int = 1024
    remat: bool = True
    # citation / provenance tag from the assignment sheet
    source: str = ""

    @property
    def d_inner(self) -> int:        # ssm inner width
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def pattern_layers(self) -> list[str]:
        """Flat per-layer mixer kinds, length == num_layers."""
        pat = self.layer_pattern
        assert self.num_layers % len(pat) == 0, (self.name, pat)
        return list(pat) * (self.num_layers // len(pat))

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None or idx < self.dense_prefix:
            return False
        return (idx % self.moe.every_k_layers) == self.moe.every_k_layers - 1

    def active_param_count(self) -> int:
        """Params touched per token: total minus inactive routed experts."""
        n = self.param_count()
        if self.moe is not None:
            e = self.moe
            per_expert = 3 * self.d_model * e.d_expert
            n_moe_layers = sum(self.is_moe_layer(i)
                               for i in range(self.num_layers))
            n -= n_moe_layers * (e.num_experts - e.top_k) * per_expert
        return n

    def param_count(self) -> int:
        """Exact parameter count derived from the config (for sanity tests)."""
        c, d = self, self.d_model
        n = 0
        n += c.vocab_size * d                      # embed
        if not c.tie_embeddings:
            n += c.vocab_size * d                  # unembed
        n += d                                     # final norm
        for i, kind in enumerate(c.pattern_layers()):
            has_ffn = not (kind == "M" and c.family == "ssm")
            n += d * (2 if has_ffn else 1)         # pre-norms
            if kind == "A":
                if c.mla is not None:
                    m = c.mla
                    qk = m.qk_nope_dim + m.qk_rope_dim
                    n += d * m.q_lora_rank + m.q_lora_rank        # q down + norm
                    n += m.q_lora_rank * c.num_heads * qk          # q up
                    n += d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank
                    n += m.kv_lora_rank * c.num_heads * (m.qk_nope_dim + m.v_dim)
                    n += c.num_heads * m.v_dim * d                 # o
                else:
                    n += d * c.num_heads * c.head_dim              # q
                    n += 2 * d * c.num_kv_heads * c.head_dim       # k, v
                    n += c.num_heads * c.head_dim * d              # o
                    if c.qk_norm:
                        n += 2 * c.head_dim
            elif kind == "M":
                s = c.ssm
                di, g = c.d_inner, s.n_groups * s.d_state
                n += d * (2 * di + 2 * g + self.ssm_heads)         # in_proj
                n += (s.d_conv + 1) * (di + 2 * g)                 # conv w+b
                n += self.ssm_heads * 3 + di                       # A,D,dt_bias,norm
                n += di * d                                        # out_proj
            elif kind == "X":
                n += d * c.num_heads * c.head_dim
                n += 2 * d * c.num_kv_heads * c.head_dim
                n += c.num_heads * c.head_dim * d
                n += 2                                             # gates
            # ffn
            if c.is_moe_layer(i):
                e = c.moe
                n += d * e.num_experts                             # router
                n += e.num_experts * 3 * d * e.d_expert
                n += e.num_shared * 3 * d * e.d_expert
            else:
                ff = c.dense_prefix_ff if (c.moe is not None and i < c.dense_prefix
                                           and c.dense_prefix_ff) else c.d_ff
                if kind != "M" or c.family == "hybrid":            # pure ssm has no ffn
                    if c.d_ff > 0 or (c.moe is not None):
                        n += (3 if c.mlp_act == "swiglu" else 2) * d * ff
        return n


# ---------------------------------------------------------------------------
# Input shapes (assignment sheet)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs that may run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_is_applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = cfg.layer_pattern
    changes = dict(
        num_layers=max(len(pat), 2 if len(pat) == 1 else len(pat)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        dense_prefix=min(cfg.dense_prefix, 1),
        dense_prefix_ff=128 if cfg.dense_prefix_ff else 0,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        param_dtype="float32",
        compute_dtype="float32",
        flash_block=32,
    )
    if cfg.moe is not None:
        # capacity_factor high enough that smoke tests never drop tokens
        # (decode-vs-forward consistency needs lossless dispatch)
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=64,
            capacity_factor=float(4 // min(cfg.moe.top_k, 2) + 3))
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                   qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=8, chunk=16)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
