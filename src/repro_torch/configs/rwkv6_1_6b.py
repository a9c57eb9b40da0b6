"""rwkv6-1.6b [ssm]: 24L, d_model=2048 (attention-free), channel-mix
d_ff=7168, vocab=65536.  Finch — data-dependent decay.  head_size=64 -> 32
time-mix heads.  O(1) decode state -> long_500k applicable.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    n_heads=32,            # time-mix heads = d_model / head_size
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    layer_pattern=("rwkv",) * 24,
    ssm=SSMCfg(state_size=64, head_dim=64, chunk=128),
    tie_embeddings=False,
    subquadratic=True,
    source="arXiv:2404.05892",
)
