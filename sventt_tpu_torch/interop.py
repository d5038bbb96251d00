"""Tables carried across from the JAX package.

The NTT's prepared tables play the role weights play in a model.  These
functions turn the JAX package's tables, handed over as numpy arrays (the
caller does the ``np.asarray`` on the JAX side), into the port's tensors:

* a limb pair ``(hi, lo)`` of uint32 arrays -> an int64 tensor;
* ``MxuDirection.planes`` / ``corr`` of any scheme -> ``ops.ntt_mxu.MxuDirection``;
* ``FusedDirection`` (``stage_ls``, ``tw``: per stage the four (rows,
  block_b) arrays w_hi, w_lo, wp_hi, wp_lo, or under Solinas the two
  w_hi, w_lo; ``scale``: four (two) arrays of the broadcast (s, sp) pair,
  or none) -> ``ops.ntt_pallas.FusedDirection``;
* ``LaneDirection`` (``stage_ls``, ``tw``: (stages, 4, rows, m), under
  Solinas (stages, 2, rows, m); ``scale_scalar``: (s, sp) ints, sp None
  under Solinas, or None) -> ``ops.ntt_pallas.LaneDirection``;
* ``GroupedDirection`` (``specs``; ``tw``: per group the four (m, 256)
  arrays w_hi, w_lo, wp_hi, wp_lo) -> ``ops.ntt_pallas.GroupedDirection``,
  and ``GroupedLaneDirection`` (``specs``; ``tw``: (groups, 4, rows, m))
  -> ``ops.ntt_pallas.GroupedLaneDirection``.  A spec is any object with
  the fields of ``GroupSpec`` (the JAX one as it is); its ``consts``
  become the port's constant tensor;
* a ``MontPair`` as ``{"w": (hi, lo), "wp": (hi, lo) or None}`` (Solinas
  row twiddles are plain and companion-free: ``"wp"`` None);
* a whole ``PlanTables`` as ``{"leaf": {(m, "mxu"): {"planes": ..., "corr":
  (hi, lo)}, (m, "pallas"): {"stage_ls": ..., "tw": ..., "scale": ...}
  or {"specs": ..., "tw": ...}}, "lane": {m1: {"stage_ls": ..., "tw": ...,
  "scale_scalar": ...} or {"specs": ..., "tw": ...}},
  "split_tw": {(m0, m1): pair}, "split_tw_t": {(m0, m1): pair}}`` (the
  JAX package's transposed (m1, m0) table of an mxu root, if any, is
  carried into the port's ``split_tw`` transposed back, once: the port's
  root step reads its (m0, m1) layout);
* a ``DistributedNTT``'s tables of one direction as ``{"tw": pair (the
  whole (n0, n1) inter-step matrix, as ``np.asarray`` gathers it), "col":
  PlanTables layout, "row": PlanTables layout}`` -> ``parallel.sixstep.
  DirectionTables``, the matrix cut by columns onto the shards.

The JAX package broadcasts each stage's l twiddles to its vreg tiles (a
row or lane index i holds ``w_stage[i mod l]``); the port's compact tables
take column or row 0 of each and keep its first l entries.  A grouped
table is broadcast the same way; the port keeps column or row 0, all m
entries.  Every
``device`` None is the CUDA card.  No JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .field.limb import FieldConsts, from_limbs
from .field.modulus import Modulus
from .ops.ntt_mxu import SCHEMES, MxuDirection, _mat_dims
from .ops.ntt_pallas import (
    FusedDirection,
    GroupedDirection,
    GroupedLaneDirection,
    GroupSpec,
    LaneDirection,
    _compact,
    _const_tensors,
)
from .ops.twiddle import MontPair, montpair_map
from .plan.planner import PlanTables
from .utils.device import resolve_device


def montpair_from_numpy(pair: dict, device=None) -> MontPair:
    """``{"w": (hi, lo), "wp": (hi, lo) | None}`` -> MontPair."""
    device = resolve_device(device)
    wp = pair.get("wp")
    return MontPair(
        from_limbs(*pair["w"], device),
        None if wp is None else from_limbs(*wp, device),
    )


def mxu_direction_from_numpy(
    mod: Modulus, m: int, inverse: bool, planes: np.ndarray, corr, device=None,
    scheme: str = "s8",
) -> MxuDirection:
    """The JAX ``MxuDirection`` of one scheme as the port's: ``planes`` the
    int8 array of ``_mat_dims(scheme, m)`` ((8m, m) s8, (10m, m) u7, the
    banded (15m, 8m) s8b), ``corr`` its (hi, lo) limb pair of shape (1, m),
    or None for u7."""
    device = resolve_device(device)
    planes = np.asarray(planes)
    if scheme not in SCHEMES:
        raise ValueError(f"unknown mxu plane scheme {scheme!r}")
    dims = _mat_dims(scheme, m)
    if planes.dtype != np.int8 or planes.shape != dims:
        raise ValueError(f"expected {dims} int8 {scheme} planes, got {planes.dtype} {planes.shape}")
    if (corr is None) != (scheme == "u7"):
        raise ValueError(f"scheme {scheme} {'takes no' if scheme == 'u7' else 'needs a'} corr")
    if corr is not None:
        corr = from_limbs(*corr, device)
        if corr.numel() != m:
            raise ValueError(f"expected (1, {m}) corr limbs, got {tuple(corr.shape)}")
        corr = corr.reshape(m)
    N = mod.modulus
    return MxuDirection(
        m, inverse,
        torch.from_numpy(np.array(planes, copy=True)).to(device),
        corr, N, pow(2, 128, N), pow(N, -1, 1 << 64), scheme,
    )


def _channels(modmul: str) -> int:
    """Limb arrays a stage table has: w and its companion, or w alone
    (Solinas)."""
    return 2 if modmul == "solinas" else 4


def _stage_pairs(stage_ls, arrays, device) -> list[MontPair]:
    """Per stage the compact pair from its (hi, lo) limb vectors: four, or
    two without a companion."""
    pairs = []
    for l, limbs in zip(stage_ls, arrays):
        w = from_limbs(limbs[0][:l], limbs[1][:l], device)
        wp = from_limbs(limbs[2][:l], limbs[3][:l], device) if len(limbs) == 4 else None
        pairs.append(MontPair(w, wp))
    return pairs


def fused_direction_from_numpy(
    m: int, inverse: bool, modmul: str, stage_ls, tw, scale, device=None
) -> FusedDirection:
    """The JAX ``FusedDirection`` (radix-2) as the port's: column 0 of each
    pre-broadcast stage array, first l rows."""
    device = resolve_device(device)
    ch = _channels(modmul)
    cols = [[np.asarray(a)[:, 0] for a in stage] for stage in tw]
    if any(len(stage) != ch for stage in cols):
        raise ValueError(f"expected {ch} arrays per stage under {modmul!r}")
    w, wp = _compact(_stage_pairs(stage_ls, cols, device), stage_ls, m, device)
    sc = None
    if inverse:
        limbs = [int(np.asarray(a).flat[0]) for a in scale]
        if len(limbs) != ch:
            raise ValueError(f"expected {ch} scale arrays under {modmul!r}")
        sc = ((limbs[0] << 32) | limbs[1], (limbs[2] << 32) | limbs[3] if ch == 4 else None)
    return FusedDirection(m, inverse, modmul, tuple(stage_ls), w, wp, sc)


def lane_direction_from_numpy(
    m: int, inverse: bool, modmul: str, stage_ls, tw, scale_scalar, device=None
) -> LaneDirection:
    """The JAX ``LaneDirection`` as the port's: row 0 of each stage's four
    lane vectors, first l lanes."""
    device = resolve_device(device)
    ch = _channels(modmul)
    tw = np.asarray(tw)
    if tw.ndim != 4 or tw.shape[1] != ch or tw.shape[3] != m:
        raise ValueError(f"expected (stages, {ch}, rows, {m}) lane tables, got {tw.shape}")
    rows = [[tw[s, c, 0] for c in range(ch)] for s in range(tw.shape[0])]
    w, wp = _compact(_stage_pairs(stage_ls, rows, device), stage_ls, m, device)
    sc = None if scale_scalar is None else tuple(None if v is None else int(v) for v in scale_scalar)
    return LaneDirection(m, inverse, modmul, tuple(stage_ls), w, wp, sc)


def _grouped_fields(m: int, inverse: bool, modmul: str, specs, vectors, device) -> tuple:
    """(fields of a grouped direction) from the specs and, per group, the
    four (m,) limb vectors of its combined table."""
    specs = tuple(
        GroupSpec(tuple(s.ls), s.L, s.span, tuple(tuple(row) for row in s.consts), s.scaled)
        for s in specs
    )
    if len(vectors) != len(specs) or any(len(v) != 4 for v in vectors):
        raise ValueError("expected four arrays (w_hi, w_lo, wp_hi, wp_lo) per group")
    w = torch.stack([from_limbs(wh, wl, device) for wh, wl, _, _ in vectors])
    wp = torch.stack([from_limbs(ph, pl, device) for _, _, ph, pl in vectors])
    if tuple(w.shape) != (len(specs), m):
        raise ValueError(f"expected (m,) = ({m},) tables per group, got {tuple(w.shape)}")
    return (m, inverse, modmul, specs, w, wp, *_const_tensors(specs, device))


def grouped_direction_from_numpy(
    m: int, inverse: bool, modmul: str, specs, tw, device=None
) -> GroupedDirection:
    """The JAX ``GroupedDirection`` as the port's: column 0 of each group's
    four pre-broadcast (m, 256) arrays."""
    device = resolve_device(device)
    vectors = [[np.asarray(a)[:, 0] for a in group] for group in tw]
    return GroupedDirection(*_grouped_fields(m, inverse, modmul, specs, vectors, device))


def grouped_lane_direction_from_numpy(
    m: int, inverse: bool, modmul: str, specs, tw, device=None
) -> GroupedLaneDirection:
    """The JAX ``GroupedLaneDirection`` as the port's: row 0 of each
    group's four lane vectors of its (groups, 4, rows, m) array."""
    device = resolve_device(device)
    tw = np.asarray(tw)
    if tw.ndim != 4 or tw.shape[1] != 4 or tw.shape[3] != m:
        raise ValueError(f"expected (groups, 4, rows, {m}) lane tables, got {tw.shape}")
    vectors = [[tw[g, c, 0] for c in range(4)] for g in range(tw.shape[0])]
    return GroupedLaneDirection(*_grouped_fields(m, inverse, modmul, specs, vectors, device))


def tables_from_numpy(
    plan, mod: Modulus, fc: FieldConsts, inverse: bool, arrays: dict, device=None
) -> PlanTables:
    """A whole JAX ``PlanTables`` (as numpy arrays, layout above) as the
    port's PlanTables for the same plan."""
    device = resolve_device(device)
    leaf = {}
    for key, v in arrays["leaf"].items():
        if key[1] == "mxu":
            leaf[key] = mxu_direction_from_numpy(
                mod, key[0], inverse, v["planes"], v["corr"], device
            )
        elif "specs" in v:
            leaf[key] = grouped_direction_from_numpy(
                key[0], inverse, fc.modmul, v["specs"], v["tw"], device
            )
        else:
            leaf[key] = fused_direction_from_numpy(
                key[0], inverse, fc.modmul, v["stage_ls"], v["tw"], v["scale"], device
            )
    lane = {}
    for m1, v in arrays.get("lane", {}).items():
        if "specs" in v:
            lane[m1] = grouped_lane_direction_from_numpy(
                m1, inverse, fc.modmul, v["specs"], v["tw"], device
            )
        else:
            lane[m1] = lane_direction_from_numpy(
                m1, inverse, fc.modmul, v["stage_ls"], v["tw"], v["scale_scalar"], device
            )
    split_tw = {k: montpair_from_numpy(v, device) for k, v in arrays["split_tw"].items()}
    for k, v in arrays.get("split_tw_t", {}).items():
        split_tw[k] = montpair_map(lambda a: a.t().contiguous(), montpair_from_numpy(v, device))
    return PlanTables.from_parts(plan, mod, fc, inverse, leaf=leaf, split_tw=split_tw, lane=lane)


def distributed_tables_from_numpy(
    col_plan, row_plan, mod: Modulus, fc: FieldConsts, inverse: bool, arrays: dict, devices
):
    """A JAX ``DistributedNTT``'s tables of one direction (layout above;
    its local plans were built with ``root_lead=False``, so no table is
    transposed) as the port's
    ``DirectionTables``: shard d's columns [d*n1/D, (d+1)*n1/D) of the
    inter-step matrix on ``devices[d]``, the column and row PlanTables once
    per distinct device."""
    from .parallel.sixstep import DirectionTables, shard_columns

    devices = [resolve_device(d) for d in devices]
    tw = shard_columns(montpair_from_numpy(arrays["tw"], "cpu"), devices)
    col, row = {}, {}
    for dev in dict.fromkeys(devices):
        col[dev] = tables_from_numpy(col_plan, mod, fc, inverse, arrays["col"], dev)
        row[dev] = tables_from_numpy(row_plan, mod, fc, inverse, arrays["row"], dev)
    return DirectionTables(tw, col, row, tuple(devices))
