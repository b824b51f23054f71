"""MusicGen-Large: decoder-only over EnCodec tokens. 48L d_model=2048 32H
(kv=32) d_ff=8192 vocab=2048  [arXiv:2306.05284; hf]

Backbone only — the EnCodec frontend is a stub: input_specs() provides
precomputed frame embeddings of width d_model (the sum of the four
codebook embeddings after the delay pattern), per the assignment sheet.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    input_mode="embeddings",
    source="arXiv:2306.05284; hf",
)
