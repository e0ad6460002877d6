"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
Mamba2 backbone + shared attention blocks.  [arXiv:2411.15242]

ssm_state=64. Shared attention+MLP block applied every `attn_every` layers
(weights shared across applications, the zamba signature).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    attn_every=6,
)
