"""command-r-plus-104b [dense]: 64L, d_model=12288, 96H (GQA kv=8),
d_ff=33792, vocab=256000.  GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01;
unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
