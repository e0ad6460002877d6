"""Hand-written CUDA kernels of the port, behind a device-dispatched seam.

Layout:
  ops.py              the seam: strategies, step fns and the sparse
                      optimizers import ONLY this
  ref.py              plain PyTorch versions, run for CPU tensors and the
                      parity oracle of every kernel
  sigmoid_grad.py     wrapper of csrc/sigmoid_grad.cu (computeGradients)
  segment_sum.py      wrapper of csrc/segment_sum.cu (sorted run totals,
                      behind ops.owner_accumulate and the combiner)
  select_pack.py      wrapper of csrc/select_pack.cu (topk_reduce's
                      per-row top-k select + pack)
  flash_attention.py  wrapper of csrc/flash_attention.cu (the dense
                      prefill's causal GQA attention, bf16)
  row_update.py       wrapper of csrc/row_update.cu (sgd / adagrad over
                      the rows that a reduce's run totals name)
  build.py            nvcc build of csrc/*.cu for sm_90a at first use,
                      loaded with ctypes
"""
