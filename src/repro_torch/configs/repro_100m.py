"""repro-100m: ~130M-parameter dense decoder for the end-to-end training
driver (llama-style, qwen3-family reduced). CPU-runnable."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="repro-100m",
    family="dense",
    num_layers=10,
    d_model=640,
    num_heads=10,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=50304,
    qk_norm=True,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
    flash_block=512,
    source="in-repo (training example)",
)
