"""xlstm-125m [ssm]: 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304,
sLSTM + mLSTM blocks.  [arXiv:2405.04517]

d_ff=0: block capacity lives in the mLSTM/sLSTM up/down projections
(projection factor 2), per the xLSTM block design. Every `slstm_every`-th
block is an sLSTM (recurrent scalar memory); the rest are mLSTM (matrix
memory, parallelizable).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=2,
    tie_embeddings=True,
)
