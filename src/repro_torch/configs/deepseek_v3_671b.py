"""DeepSeek-V3 671B: MLA, 1 shared + 256 routed experts top-8, fine-grained
(d_expert=2048).  61L d_model=7168 128H vocab=129280  [arXiv:2412.19437; hf]

First 3 layers are dense MLP (ff 18432) per the paper; the remaining 58 are
MoE.  KV cache stores the MLA latent (kv_lora 512 + rope 64 per token).
The MTP (multi-token prediction) auxiliary head is out of scope — the
param-count target (671.03B) is met by the backbone above.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # nominal (MLA replaces GQA; kept for the sheet)
    head_dim=128,
    d_ff=2048,                 # routed expert hidden size (fine-grained)
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1),
    dense_prefix=3,
    dense_prefix_ff=18432,
    source="arXiv:2412.19437; hf",
)
