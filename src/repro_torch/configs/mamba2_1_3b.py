"""Mamba2-1.3B: attention-free SSD (state-space duality). 48L d_model=2048
d_ff=0 vocab=50280 ssm_state=128  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,               # unused by ssm mixer
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,                    # no FFN in mamba2 blocks
    vocab_size=50280,
    tie_embeddings=True,
    layer_pattern="M",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    source="arXiv:2405.21060; unverified",
)
