"""Tables carried across from the JAX package.

The NTT's prepared tables play the role weights play in a model.  These
functions turn the JAX package's tables, handed over as numpy arrays (the
caller does the ``np.asarray`` on the JAX side), into the port's tensors:

* a limb pair ``(hi, lo)`` of uint32 arrays -> an int64 tensor;
* ``MxuDirection.planes`` / ``corr`` -> ``ops.ntt_mxu.MxuDirection``;
* a ``MontPair`` as ``{"w": (hi, lo), "wp": (hi, lo) or None}``;
* a whole ``PlanTables`` as ``{"leaf": {(m, "mxu"): {"planes": ..., "corr":
  (hi, lo)}}, "split_tw": {(m0, m1): pair}, "split_tw_t": {...}}``.

No JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .field.limb import FieldConsts, from_limbs
from .field.modulus import Modulus
from .ops.ntt_mxu import MxuDirection
from .ops.twiddle import MontPair
from .plan.planner import PlanTables


def montpair_from_numpy(pair: dict, device=None) -> MontPair:
    """``{"w": (hi, lo), "wp": (hi, lo) | None}`` -> MontPair."""
    wp = pair.get("wp")
    return MontPair(
        from_limbs(*pair["w"], device),
        None if wp is None else from_limbs(*wp, device),
    )


def mxu_direction_from_numpy(
    mod: Modulus, m: int, inverse: bool, planes: np.ndarray, corr, device=None
) -> MxuDirection:
    """The JAX ``MxuDirection`` (s8 scheme) as the port's: ``planes`` the
    (8m, m) int8 array, ``corr`` its (hi, lo) limb pair of shape (1, m)."""
    planes = np.asarray(planes)
    if planes.dtype != np.int8 or planes.shape != (8 * m, m):
        raise ValueError(f"expected (8m, m) int8 planes, got {planes.dtype} {planes.shape}")
    N = mod.modulus
    return MxuDirection(
        m, inverse,
        torch.from_numpy(np.array(planes, copy=True)).to(device),
        from_limbs(*corr, device).reshape(m),
        N, pow(2, 128, N), pow(N, -1, 1 << 64),
    )


def tables_from_numpy(
    plan, mod: Modulus, fc: FieldConsts, inverse: bool, arrays: dict, device=None
) -> PlanTables:
    """A whole JAX ``PlanTables`` (as numpy arrays, layout above) as the
    port's PlanTables for the same plan."""
    leaf = {
        key: mxu_direction_from_numpy(
            mod, key[0], inverse, v["planes"], v["corr"], device
        )
        for key, v in arrays["leaf"].items()
    }
    conv = {
        name: {k: montpair_from_numpy(v, device) for k, v in arrays[name].items()}
        for name in ("split_tw", "split_tw_t")
    }
    return PlanTables.from_parts(
        plan, mod, fc, inverse, leaf=leaf, split_tw=conv["split_tw"],
        split_tw_t=conv["split_tw_t"],
    )
