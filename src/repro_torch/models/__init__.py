"""Model code of the port: every family of the reference, served
(prefill and greedy decode) and trained: dense, vlm and MoE
(`transformer`, `moe`; mixtral with its sliding window), the zamba2
hybrid (`mamba`, `ssm_common`), xLSTM (`xlstm`) and the whisper-style
encoder-decoder (`encdec`)."""
