"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536,
early-fusion VQ image tokens, qk-norm.  [arXiv:2405.09818]

The image tokenizer is a STUB: VQ image tokens share the 65536-entry text
vocab, so input_specs() supplies ordinary token ids (early fusion).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
)
