"""The paper's own workload: distributed sparse logistic regression.

Scaled from the paper's 50B-feature / 20B-sample Hadoop run to a hashed
1M-feature space; the DPMR engine itself is feature-count agnostic.
"""
from repro_torch.configs.base import DPMRConfig

CONFIG = DPMRConfig(
    num_features=1 << 20,
    max_features_per_sample=64,
    hot_threshold=1e-3,
    max_hot=512,
    learning_rate=0.5,
    iterations=4,
    distribution="a2a",
)
