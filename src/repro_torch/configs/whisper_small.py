"""whisper-small [audio]: enc-dec transformer backbone, conv frontend stubbed.

12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865  [arXiv:2212.04356]
The audio conv frontend is a STUB: input_specs() provides precomputed frame
embeddings for the encoder; the decoder consumes token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp_type="gelu",
    frontend_stub=True,
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions, not RoPE
)
