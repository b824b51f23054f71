"""Granite-20B (code): dense llama-arch with MQA (kv=1). 52L d_model=6144
48H d_ff=24576 vocab=49152  [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_act="gelu",            # GPT-BigCode style non-gated MLP
    tie_embeddings=True,
    source="arXiv:2405.04324; hf",
)
