"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H (GQA kv=4), expert
d_ff=1536, vocab=151936, MoE 128 experts top-8.  head_dim=128 (q dim 8192 !=
d_model, as in the Qwen3 family).  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    moe=MoECfg(num_experts=128, top_k=8, expert_d_ff=1536, spare_slots=16),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B",
)
