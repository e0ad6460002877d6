"""Model code of the port: the dense, vlm and MoE families (mixtral with
its sliding window), served (prefill and greedy decode) and trained.
SSM, hybrid and encoder-decoder models are ROADMAP A12."""
