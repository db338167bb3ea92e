"""Per-slot segment sums: kernel B5 (csrc/segsum.cu) and its plain PyTorch
version.

Replaces ``segsum_sorted`` of
pointcloud_depthfusion_tpu/ops/pallas/segsum_pallas.py. Contract: per slot
of ``[0, n_slots)``, the sum of each of the C ≤ 16 f32 channels of the
entries routed there (0 where empty) and the smallest entry index
(INT32_MAX where empty). Entries whose slot lies outside ``[0, n_slots)``
are dropped, so ``padded_slots(n_slots)`` keeps its meaning as the id of
an invalid entry.

Both versions add each slot's channels in entry order, starting from 0:
the kernel over its own stable radix placement of the entries by slot
(the JAX package sorts with XLA before its kernel; the port runs no
library sort), the plain version by ``index_add_``, which adds in entry
order on the CPU. So the kernel's result is the same in every run and
equals, bit for bit, the plain version run on the CPU. On a CUDA tensor
``index_add_`` adds with atomics, in an order that changes from run to
run.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches the
kernel, or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pointcloud_depthfusion_tpu_torch.ops.cuda import _build

INT32_MAX = 0x7FFFFFFF
MAX_CHANNELS = 16

#: Wrapper launches of the kernel.
launches = {"segsum_sorted": 0}


def padded_slots(n_slots: int, tile_slots: int = 256) -> int:
    """Slot id that routes an entry past every slot (the JAX package's
    padded tile count; any id outside ``[0, n_slots)`` is dropped)."""
    return -(-n_slots // tile_slots) * tile_slots


def _check(slot: torch.Tensor, values: torch.Tensor, n_slots: int) -> None:
    if slot.dtype != torch.int32 or slot.dim() != 1:
        raise ValueError(f"slot: expected (N,) int32, got {tuple(slot.shape)} {slot.dtype}")
    if values.dtype != torch.float32 or values.dim() != 2 or values.shape[0] != slot.shape[0]:
        raise ValueError(
            f"values: expected ({slot.shape[0]}, C) float32, got {tuple(values.shape)} {values.dtype}"
        )
    if not 1 <= values.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"{values.shape[1]} channels: expected 1..{MAX_CHANNELS}")
    if not slot.is_contiguous() or not values.is_contiguous():
        raise ValueError("slot and values must be contiguous tensors")
    if values.device != slot.device:
        raise ValueError(f"values on {values.device}, slot on {slot.device}")
    if n_slots < 0:
        raise ValueError(f"n_slots {n_slots} < 0")


def segsum_sorted_plain(
    slot: torch.Tensor, values: torch.Tensor, n_slots: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`segsum_sorted`: ``index_add_`` for the sums,
    ``scatter_reduce_(amin)`` for the representative; dropped entries go to
    a dump row at index ``n_slots``."""
    n, c = values.shape
    dev = slot.device
    inside = (slot >= 0) & (slot < n_slots)
    idx = torch.where(inside, slot, n_slots).to(torch.int64)
    sums = torch.zeros((n_slots + 1, c), dtype=torch.float32, device=dev)
    sums.index_add_(0, idx, values)
    rep = torch.full((n_slots + 1,), INT32_MAX, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, idx, torch.arange(n, dtype=torch.int64, device=dev), "amin")
    return sums[:n_slots], rep[:n_slots].to(torch.int32)


def segsum_sorted(
    slot: torch.Tensor, values: torch.Tensor, n_slots: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot channel sums ``(n_slots, C)`` f32 and minimum entry index
    ``(n_slots,)`` int32 of unsorted entries (see the module docstring)."""
    _check(slot, values, n_slots)
    if slot.device.type == "cpu":
        return segsum_sorted_plain(slot, values, n_slots)
    if slot.device.type != "cuda":
        raise ValueError(f"unsupported device {slot.device}")
    n, c = values.shape
    sums = torch.empty((n_slots, c), dtype=torch.float32, device=slot.device)
    rep = torch.empty((n_slots,), dtype=torch.int32, device=slot.device)
    lib = _build.load()
    scratch = torch.empty((lib.segsum_scratch_ints(n, n_slots),), dtype=torch.int32,
                          device=slot.device)
    stream = torch.cuda.current_stream(slot.device).cuda_stream
    _build.check(
        lib.segsum_launch(slot.data_ptr(), values.data_ptr(), n, c, n_slots, scratch.data_ptr(),
                          sums.data_ptr(), rep.data_ptr(), stream),
        "segsum_launch",
    )
    launches["segsum_sorted"] += 1
    return sums, rep
