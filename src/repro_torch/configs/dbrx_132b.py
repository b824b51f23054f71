"""DBRX-132B: fine-grained MoE, 16 experts top-4. 40L d_model=6144 48H
(GQA kv=8) d_ff=10752 vocab=100352  [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752),
    source="hf:databricks/dbrx-base; unverified",
)
