"""olmoe-1b-7b [moe]: 16L, d_model=2048, 16H (GQA kv=16), expert d_ff=1024,
vocab=50304, MoE 64 experts top-8.  The primary Reshape-integration target:
expert-routing skew is mitigated by the paper's technique (SBR/SBK expert
replication & placement).  [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe=MoECfg(num_experts=64, top_k=8, expert_d_ff=1024, spare_slots=16),
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2409.02060",
)
