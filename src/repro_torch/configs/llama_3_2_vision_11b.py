"""Llama-3.2-Vision-11B: text decoder with gated cross-attention image
layers. 40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision encoder is a stub: input_specs() provides precomputed patch
embeddings (B, 1600, d_model).  One gated cross-attention layer is
interleaved every 5 layers (period 'AAAAX' -> 32 self + 8 cross).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern="AAAAX",
    num_image_tokens=1600,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
