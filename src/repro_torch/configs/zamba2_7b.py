"""zamba2-7b [hybrid]: 81L, d_model=3584, 32H (GQA kv=32), d_ff=14336,
vocab=32000, ssm_state=64.  Mamba2 backbone + SHARED attention+MLP block
applied every 6th layer (weights shared across all occurrences).  O(1) SSM
decode state + bounded attn reuse -> long_500k applicable.
[arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMCfg

# every 6th block is the shared attention block: 13 occurrences in 81 layers.
_PATTERN = tuple(
    "shared_attn" if (i % 6) == 5 else "mamba" for i in range(81)
)

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    layer_pattern=_PATTERN,
    ssm=SSMCfg(state_size=64, head_dim=64, expand=2, chunk=128),
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2411.15242",
)
