"""Carry a DPMR state across the two packages as numpy arrays.

`state_from_numpy` takes the 7 leaves of a `DPMRState` (the JAX
package's or this one's, in field order: cold, hot, hot_ids, cold_acc,
hot_acc, step, strat) as numpy arrays and builds the port's state on
`device`; `state_to_numpy` goes the other way. The same state then gives
the same steps in both packages, up to f32 rounding.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core.dpmr import DPMRState

_DTYPES = (np.float32, np.float32, np.int32, np.float32, np.float32,
           np.int32, np.float32)


def state_from_numpy(leaves: Sequence, device) -> DPMRState:
    """The port's DPMRState from 7 numpy leaves in field order (copied)."""
    if len(leaves) != len(DPMRState._fields):
        raise ValueError(f"expected {len(DPMRState._fields)} leaves "
                         f"{DPMRState._fields}, got {len(leaves)}")
    return DPMRState(*(
        torch.tensor(np.asarray(leaf, dtype=dt), device=device)
        for leaf, dt in zip(leaves, _DTYPES, strict=True)))


def state_to_numpy(state: DPMRState) -> tuple[np.ndarray, ...]:
    """The 7 leaves of `state` as host numpy arrays, in field order."""
    return tuple(t.detach().cpu().numpy() for t in state)
