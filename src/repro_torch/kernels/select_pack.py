"""Wrapper of the CUDA `select_pack` kernel (`csrc/select_pack.cu`).

Replaces the Pallas TPU kernel `repro.kernels.select_pack.select_pack`:
the `topk_reduce` strategy's compensate + rank-by-|value| + pack of each
destination row of its (P, cap) send buffer. The TPU kernel ranks a row
with a (cap, cap) comparison mask, which bounds it at cap = 4096; the
CUDA kernel is a stable radix sort of each row, with no capacity bound
and no fallback (the source note in the `.cu` file gives the design).
All three outputs equal the plain version bit for bit.

On CPU tensors the wrapper computes the plain version
(`ref.select_pack_ref`); on CUDA tensors it launches the kernel, or
raises on inputs the kernel does not take. `launches` counts calls that
launched it; each such call runs 13 CUDA kernels: the key pass (with
the first histogram), 4 radix passes of histogram, scan and scatter,
and the emit pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0


def select_pack(send: torch.Tensor, ids: torch.Tensor,
                carry_slots: torch.Tensor, k: int):
    """send, carry_slots: (P, cap) f32; ids: (P, cap) int32, negative =
    empty; 1 <= k <= cap. Returns (vals_k (P, k) f32, ids_k (P, k) int32,
    resid (P, cap) f32), as `ref.select_pack_ref`."""
    if ids.device.type == "cpu":
        return ref.select_pack_ref(send, ids, carry_slots, k)
    global launches
    _check(send, ids, carry_slots, k)
    p, cap = ids.shape
    dev = ids.device
    vals_k = torch.empty((p, k), dtype=torch.float32, device=dev)
    ids_k = torch.empty((p, k), dtype=torch.int32, device=dev)
    resid = torch.empty((p, cap), dtype=torch.float32, device=dev)
    if p == 0:
        return vals_k, ids_k, resid
    lib = build.library()
    tiles = -(-cap // lib.repro_select_pack_tile_size())
    keys = torch.empty((2, p, cap), dtype=torch.int32, device=dev)
    pos = torch.empty((2, p, cap), dtype=torch.int32, device=dev)
    radix = lib.repro_select_pack_radix()
    hist = torch.empty((p, radix * tiles), dtype=torch.int32, device=dev)
    totals = torch.empty((p, 4, radix), dtype=torch.int32, device=dev)
    status = lib.repro_select_pack_f32(
        send.data_ptr(), ids.data_ptr(), carry_slots.data_ptr(),
        vals_k.data_ptr(), ids_k.data_ptr(), resid.data_ptr(),
        keys[0].data_ptr(), keys[1].data_ptr(), pos[0].data_ptr(),
        pos[1].data_ptr(), hist.data_ptr(), totals.data_ptr(), p, cap, k,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "select_pack")
    launches += 1
    return vals_k, ids_k, resid


def _check(send, ids, carry_slots, k) -> None:
    if ids.device.type != "cuda":
        raise ValueError(f"select_pack: no kernel for device {ids.device}")
    if ids.dim() != 2 or send.shape != ids.shape \
            or carry_slots.shape != ids.shape:
        raise ValueError(
            f"select_pack: shapes send {tuple(send.shape)}, ids "
            f"{tuple(ids.shape)}, carry_slots {tuple(carry_slots.shape)}")
    p, cap = ids.shape
    if not 1 <= k <= cap:
        raise ValueError(f"select_pack: k={k} outside [1, cap={cap}]")
    if p > 65535 or p * cap >= 2 ** 31:
        raise ValueError(f"select_pack: (P, cap) = {(p, cap)} needs P <= "
                         "65535 and P * cap < 2^31")
    for name, t, dtype in (("send", send, torch.float32),
                           ("ids", ids, torch.int32),
                           ("carry_slots", carry_slots, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"select_pack: {name} is {t.dtype}, "
                            f"the kernel takes {dtype}")
        if t.device != ids.device:
            raise ValueError(f"select_pack: {name} on {t.device}, ids on "
                             f"{ids.device}")
        if not t.is_contiguous():
            raise ValueError(f"select_pack: {name} is not contiguous")
