"""Wrapper of the CUDA `select_pack` kernel (`csrc/select_pack.cu`).

Replaces the Pallas TPU kernel `repro.kernels.select_pack.select_pack`:
the `topk_reduce` strategy's compensate + rank-by-|value| + pack of each
destination row of its (P, cap) send buffer. The TPU kernel ranks a row
with a (cap, cap) comparison mask, which bounds it at cap = 4096; the
CUDA kernel has two paths and no capacity bound (the source note in the
`.cu` file gives the design):

  - the cluster path: one launch, a cluster of 16 CTAs per row that keeps
    the row in shared memory, radix-selects the threshold key, compacts
    the min(k, live) live winners and sorts only them, the CTAs talking
    through pushes into each other's shared memory; no scratch in device
    memory and no memset;
  - the large path, for a row that the cluster cannot hold: a stable radix
    sort of the whole row through device memory, 13 CUDA kernels and a
    memset of the digit totals.

Which path runs is a function of (cap, k) alone, stated once by the
`.cu` file (`repro_select_pack_uses_cluster`), which the wrapper reads.
`uses_cluster` is a Python copy of that rule for code that runs without
the card (the CPU tests); the card tests hold the two together on each
side of the rule's boundary. The main path's row (cap = 262,144) takes
the cluster path at k = 13,108 (`topk_frac` 0.05) and at k = 65,536
(0.25); at that cap the cluster path holds k up to 128,928.
All three outputs equal the plain version bit for bit on both paths.

On CPU tensors the wrapper computes the plain version
(`ref.select_pack_ref`); on CUDA tensors it launches the kernel, or
raises on inputs the kernel does not take. The `obs` counter
`launch.select_pack` counts calls that launched it.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import build, ref



# The cluster path's geometry, copied from `csrc/select_pack.cu` for the
# Python copy of its path rule.
CLUSTER_CTAS = 16
CLUSTER_THREADS = 512
CLUSTER_CHUNK = 4 * CLUSTER_THREADS   # slots of a chunk, 4 a thread
CLUSTER_MAX_CHUNKS = 64               # chunks a CTA may hold
RADIX = 256
EXCHANGE_TABLE_BYTES = CLUSTER_CTAS * 512
SMEM_PER_BLOCK = 232448               # shared memory one H100 block can use
STATIC_SMEM_RESERVE = 1024            # the cluster kernel's static shared
LARGE_TILE = 1024                     # slots a block of the large path takes


def cluster_chunks(cap: int) -> int:
    """Chunks of a row each CTA of the cluster holds: chunk q of the row
    goes to CTA q % 16."""
    return -(-(-(-cap // CLUSTER_CHUNK)) // CLUSTER_CTAS)


def cluster_smem_bytes(cap: int, k: int) -> int:
    """Dynamic shared memory of one CTA of the cluster path: two winner
    buffers of min(k, cap) / 16 (comp, position) pairs, two exchange
    tables, comp and a live bit a slot, per-warp digit rows and the CTA's
    row, per (chunk, warp) counts and per-chunk bases."""
    nq = cluster_chunks(cap)
    s = nq * CLUSTER_CHUNK
    wcap = -(-min(k, cap) // CLUSTER_CTAS)
    warps = CLUSTER_THREADS // 32
    return (2 * 8 * wcap + 2 * EXCHANGE_TABLE_BYTES + 4 * s
            + 4 * warps * RADIX + 4 * RADIX + 8 * warps * nq + 12 * nq
            + s // 8)


def uses_cluster(cap: int, k: int) -> bool:
    """The path rule, as the kernel states it: a row takes the cluster path
    when one cluster's shared memory holds it, else the large path."""
    return (cluster_chunks(cap) <= CLUSTER_MAX_CHUNKS
            and cluster_smem_bytes(cap, k) + STATIC_SMEM_RESERVE
            <= SMEM_PER_BLOCK)


def scratch_shapes(p: int, cap: int, cluster: bool) -> dict[str, tuple]:
    """int32 device scratch of a (P, cap) call on the given path, in the C
    entry point's order: none on the cluster path; on the large path the
    two key and two position buffers, the per-tile digit histogram and the
    digit totals (which the large path zeroes with a memset)."""
    if cluster:
        return {}
    tiles = -(-cap // LARGE_TILE)
    return {"keys_a": (p, cap), "keys_b": (p, cap), "pos_a": (p, cap),
            "pos_b": (p, cap), "hist": (p, RADIX * tiles),
            "totals": (p, 4, RADIX)}


def select_pack(send: torch.Tensor, ids: torch.Tensor,
                carry_slots: torch.Tensor, k: int):
    """send, carry_slots: (P, cap) f32; ids: (P, cap) int32, negative =
    empty; 1 <= k <= cap. Returns (vals_k (P, k) f32, ids_k (P, k) int32,
    resid (P, cap) f32), as `ref.select_pack_ref`."""
    if ids.device.type == "cpu":
        return ref.select_pack_ref(send, ids, carry_slots, k)
    _check(send, ids, carry_slots, k)
    p, cap = ids.shape
    dev = ids.device
    vals_k = torch.empty((p, k), dtype=torch.float32, device=dev)
    ids_k = torch.empty((p, k), dtype=torch.int32, device=dev)
    resid = torch.empty((p, cap), dtype=torch.float32, device=dev)
    if p == 0:
        return vals_k, ids_k, resid
    lib = build.library()
    cluster = bool(lib.repro_select_pack_uses_cluster(cap, k))
    scratch = [torch.empty(shape, dtype=torch.int32, device=dev)
               for shape in scratch_shapes(p, cap, cluster).values()]
    ptrs = [t.data_ptr() for t in scratch] if scratch else [None] * 6
    status = lib.repro_select_pack_f32(
        send.data_ptr(), ids.data_ptr(), carry_slots.data_ptr(),
        vals_k.data_ptr(), ids_k.data_ptr(), resid.data_ptr(), *ptrs, p,
        cap, k, torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "select_pack")
    obs.count("launch.select_pack")
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
