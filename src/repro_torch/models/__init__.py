"""Model code of the port: the dense family's serve path (prefill and
greedy decode), with chameleon's qk-norm. Training, MoE, SWA, SSM,
hybrid and encoder-decoder models are ROADMAP A12."""
