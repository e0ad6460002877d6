"""Wrapper of the CUDA `segment_sum_sorted` kernel (`csrc/segment_sum.cu`).

Replaces the Pallas TPU kernel `repro.kernels.segment_sum.
segment_sum_sorted`: each run of equal sorted ids reduced to one total at
the run's last slot. The TPU kernel carries a partial total across its
sequential grid in SMEM; the CUDA kernel is a single-pass segmented scan
whose carry between tiles comes from a decoupled look-back that folds in
tile order (the source note in the `.cu` file gives the design and what
bounds it). The result is bit-identical from call to call; it agrees
with the plain version to within f32 rounding of each run total, because
the order of the additions differs.

On CPU tensors the wrapper computes the plain version
(`ref.segment_sum_sorted_ref`); on CUDA tensors it launches the kernel,
or raises on inputs the kernel does not take. `launches` counts calls
that launched it; each such call is one CUDA kernel and no memset.

The look-back's status words and tile ticket live in a buffer kept per
(device, stream) and are never cleared on the call path: each call
stamps its words with a new epoch and passes the ticket count it starts
from (`_LookBack`). The buffer is zeroed only when it is made or grows,
and when the epoch wraps (every 2^29 - 1 calls). Calls that share a
buffer are ordered by their stream; a CUDA graph that replays a captured
call would replay its epoch too, so the port captures none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0
EPOCH_BITS = 29


class _LookBack:
    """The status words (one int64 a tile) and the ticket counter (the last
    int64) of one stream, with the epoch and ticket count of its last
    call."""

    def __init__(self, tiles: int, device: torch.device):
        self.words = torch.zeros((tiles + 1,), dtype=torch.int64,
                                 device=device)
        self.epoch = 0
        self.ticket = 0

    def next_call(self, tiles: int) -> tuple[int, int]:
        """(epoch, ticket base) for a call over `tiles` tiles."""
        if self.epoch == 2 ** EPOCH_BITS - 1:
            self.words[:-1].zero_()
            self.epoch = 0
        self.epoch += 1
        base = self.ticket
        self.ticket = (self.ticket + tiles) % 2 ** 32
        return self.epoch, base


_lookback: dict[tuple[int, int], _LookBack] = {}


def num_tiles(n: int, tile: int) -> int:
    return max(1, -(-n // tile))


def _state(device: torch.device, stream: int, tiles: int) -> _LookBack:
    key = (device.index, stream)
    st = _lookback.get(key)
    if st is None or st.words.numel() < tiles + 1:
        st = _lookback[key] = _LookBack(tiles, device)
    return st


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
    tiles = num_tiles(n, lib.repro_segment_sum_tile_size())
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    st = _state(ids.device, stream, tiles)
    epoch, base = st.next_call(tiles)
    words = st.words.data_ptr()
    status = lib.repro_segment_sum_sorted_f32(
        ids.data_ptr(), grads.data_ptr(), out.data_ptr(), words,
        words + 8 * (st.words.numel() - 1), base, epoch, n, stream)
    if status:
        # the device's ticket count no longer matches `st.ticket`: the
        # stream's next call starts from a new, zeroed buffer
        del _lookback[(ids.device.index, stream)]
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
