"""The paper-technique showcase config: a ~100M-param MoE LM used by the
end-to-end training example.  Reshape expert-skew mitigation, Amber control
plane, and Maestro region scheduling are all first-class on this config."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="paper-moe-100m",
    family="moe",
    num_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1024,
    vocab=32000,
    moe=MoECfg(num_experts=16, top_k=2, expert_d_ff=1024, spare_slots=2),
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="this work",
)
