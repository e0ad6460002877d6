"""Wrapper of the CUDA `segment_sum_sorted` kernel (`csrc/segment_sum.cu`).

Replaces the Pallas TPU kernel `repro.kernels.segment_sum.
segment_sum_sorted`: each run of equal sorted ids reduced to one total at
the run's last slot. The TPU kernel carries a partial total across its
sequential grid in SMEM; the CUDA kernel is a two-pass segmented scan
whose carry between tiles is resolved in order by a second small kernel
(the source note in the `.cu` file gives the design and what bounds it).
The result is bit-reproducible run to run; it agrees with the plain
version to within f32 rounding of each run total, because the order of
the additions differs.

On CPU tensors the wrapper computes the plain version
(`ref.segment_sum_sorted_ref`); on CUDA tensors it launches the kernel,
or raises on inputs the kernel does not take. `launches` counts calls
that launched it; each such call launches two CUDA kernels, the
per-tile scan and the carry pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0


def segment_sum_sorted(ids: torch.Tensor, grads: torch.Tensor
                       ) -> torch.Tensor:
    """ids: (N,) int32 sorted ascending, negatives = padding sorted LAST;
    grads: (N,) f32. Returns (N,) f32 with each run's total at the run's
    last slot, 0 elsewhere."""
    if ids.device.type == "cpu":
        return ref.segment_sum_sorted_ref(ids, grads)
    global launches
    _check(ids, grads)
    n = ids.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=ids.device)
    if n == 0:
        return out
    lib = build.library()
    tiles = max(1, -(-n // lib.repro_segment_sum_tile_size()))
    tile_head = torch.empty((tiles,), dtype=torch.int32, device=ids.device)
    tile_sum = torch.empty((tiles,), dtype=torch.float32, device=ids.device)
    lead_end = torch.empty((tiles,), dtype=torch.int32, device=ids.device)
    status = lib.repro_segment_sum_sorted_f32(
        ids.data_ptr(), grads.data_ptr(), out.data_ptr(),
        tile_head.data_ptr(), tile_sum.data_ptr(), lead_end.data_ptr(), n,
        torch.cuda.current_stream(ids.device).cuda_stream)
    build.check(status, "segment_sum_sorted")
    launches += 1
    return out


def _check(ids, grads) -> None:
    if ids.device.type != "cuda":
        raise ValueError(
            f"segment_sum_sorted: no kernel for device {ids.device}")
    if ids.dim() != 1 or grads.shape != ids.shape:
        raise ValueError(f"segment_sum_sorted: shapes ids {tuple(ids.shape)}"
                         f", grads {tuple(grads.shape)}")
    if ids.shape[0] >= 2 ** 31:
        raise ValueError("segment_sum_sorted: N must be below 2^31")
    for name, t, dtype in (("ids", ids, torch.int32),
                           ("grads", grads, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"segment_sum_sorted: {name} is {t.dtype}, "
                            f"the kernel takes {dtype}")
        if t.device != ids.device:
            raise ValueError(f"segment_sum_sorted: {name} on {t.device}, "
                             f"ids on {ids.device}")
        if not t.is_contiguous():
            raise ValueError(f"segment_sum_sorted: {name} is not contiguous")
