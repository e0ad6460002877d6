"""Hand-written CUDA kernels of the port, behind a device-dispatched seam.

Layout:
  ops.py              the seam: strategies and step fns import ONLY this
  ref.py              plain PyTorch versions, run for CPU tensors and the
                      parity oracle of every kernel
  sigmoid_grad.py     wrapper of csrc/sigmoid_grad.cu (computeGradients)
  segment_sum.py      wrapper of csrc/segment_sum.cu (sorted run totals,
                      behind ops.owner_accumulate and the combiner)
  select_pack.py      wrapper of csrc/select_pack.cu (topk_reduce's
                      per-row top-k select + pack)
  build.py            nvcc build of csrc/*.cu for sm_90a at first use,
                      loaded with ctypes
"""
