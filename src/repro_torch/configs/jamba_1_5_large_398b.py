"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536  [arXiv:2403.19887; hf]
Layer period of 8 with the self-attention mixer at position 4 (1 attn : 7
mamba), MoE replacing the MLP on every other layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern="MMMMAMMM",
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576, every_k_layers=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=8),
    source="arXiv:2403.19887; hf",
)
