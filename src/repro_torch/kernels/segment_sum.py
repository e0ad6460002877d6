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
or raises on inputs the kernel does not take. The `obs` counter
`launch.segment_sum_sorted` counts calls that launched it; each such call is one CUDA kernel and no memset.

The look-back's state lives on the device: status words (one int64 a
tile) and a control word (the ticket and the epoch) that the kernel alone
reads and advances, so no call passes it any state. The wrapper keeps one
zeroed buffer per (device, stream); it is zeroed again only when it
grows. Calls that share a buffer are ordered by their stream.

Capture in a CUDA graph: a call made while the current stream is
capturing gets a buffer of its own, zeroed at capture time outside the
graph, which its replays carry on from (each replay leaves it ready for
the next). So a replay on any stream never shares state with an eager
call. Replays of one graph must be ordered, as for any graph that reuses
its memory. The module keeps each such buffer alive until the owner of
the graph takes it with `take_captured()` right after the capture and
keeps it as long as the graph: a graph whose buffers were taken and
dropped must not be replayed.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import build, ref

CONTROL_WORDS = 1   # int64 words after the status words: the control word

_lookback: dict[tuple[int, int], torch.Tensor] = {}
_captured: list[torch.Tensor] = []


def num_tiles(n: int, tile: int) -> int:
    return max(1, -(-n // tile))


def _state(device: torch.device, stream: int, tiles: int,
           capturing: bool) -> torch.Tensor:
    """The look-back buffer (status words, then the control word) for a
    call over `tiles` tiles on `stream`: the stream's own, or a new one
    for a call under capture."""
    if capturing:
        words = torch.empty((tiles + CONTROL_WORDS,), dtype=torch.int64,
                            device=device)
        _zero_outside_capture(words)
        _captured.append(words)
        return words
    key = (device.index, stream)
    words = _lookback.get(key)
    if words is None or words.numel() < tiles + CONTROL_WORDS:
        words = _lookback[key] = torch.zeros(
            (tiles + CONTROL_WORDS,), dtype=torch.int64, device=device)
    return words


def _zero_outside_capture(words: torch.Tensor) -> None:
    if words.device.type != "cuda":
        words.zero_()
        return
    build.check(build.library().repro_segment_sum_zero_state(
        words.data_ptr(), 8 * words.numel()), "segment_sum_sorted")


def take_captured() -> list[torch.Tensor]:
    """The buffers of the calls captured since the last take; the module
    drops its own references to them. Keep the list with the graph."""
    taken = _captured[:]
    _captured.clear()
    return taken


def segment_sum_sorted(ids: torch.Tensor, grads: torch.Tensor
                       ) -> torch.Tensor:
    """ids: (N,) int32 sorted ascending, negatives = padding sorted LAST;
    grads: (N,) f32. Returns (N,) f32 with each run's total at the run's
    last slot, 0 elsewhere."""
    if ids.device.type == "cpu":
        return ref.segment_sum_sorted_ref(ids, grads)
    _check(ids, grads)
    n = ids.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=ids.device)
    if n == 0:
        return out
    lib = build.library()
    tiles = num_tiles(n, lib.repro_segment_sum_tile_size())
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    words = _state(ids.device, stream, tiles,
                   torch.cuda.is_current_stream_capturing())
    capacity = words.numel() - CONTROL_WORDS
    ptr = words.data_ptr()
    build.check(lib.repro_segment_sum_sorted_f32(
        ids.data_ptr(), grads.data_ptr(), out.data_ptr(), ptr,
        ptr + 8 * capacity, capacity, n, stream), "segment_sum_sorted")
    obs.count("launch.segment_sum_sorted")
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
