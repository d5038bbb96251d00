"""Memory budgeting and plan validation for huge distributed transforms.

The counterpart of ``sventt_tpu/parallel/budget.py``: the per-device byte
budget of a ``DistributedNTT`` computed WITHOUT building it, so 2^30-class
plans can be checked anywhere.  8 bytes a point (one int64 word, the JAX
package's two u32 limbs).  The table bytes are the port's own tables --
compact stage vectors, (8m, m) int8 planes, (groups, m) grouped tables --
not the TPU's broadcast tiles.  With logical shards (a mesh that names one
card D times) the card holds D shards' data and one copy of the tables.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import ntt_pallas
from ..plan import planner
from ..plan.config import NttConfig
from ..plan.planner import W_ONLY_THRESHOLD
from ..plan.wrapper import _resolve_engine

#: Bytes per coefficient: one int64 word of a u64.
BYTES_PER_POINT = 8

#: Usable device memory of one NVIDIA H100 80GB HBM3:
#: ``torch.cuda.get_device_properties(0).total_memory`` = 85,017,493,504
#: bytes on that card (torch 2.11, CUDA 12.8), less 4 GiB of headroom for
#: the CUDA context, the caching allocator's rounding and free blocks and
#: the kernel library.
DEFAULT_HBM_BYTES = 85_017_493_504 - 4 * (1 << 30)


def _split_tw_bytes(m: int) -> int:
    """An inter-step table of m entries, with its companion below
    W_ONLY_THRESHOLD (``planner.row_twiddles``' default)."""
    return m * BYTES_PER_POINT * (1 if m >= W_ONLY_THRESHOLD else 2)


def _grouped_bytes(m: int, max_r: int) -> int:
    """(groups, m) w and wp, (groups, MAX_R, MAX_LOWS, 2) int64 constants
    and their (groups, MAX_R, MAX_LOWS) bool mask."""
    groups = len(ntt_pallas._choose_groups(m.bit_length() - 1, max_r))
    lows = ntt_pallas.MAX_R * ntt_pallas.MAX_LOWS
    return groups * (2 * m * 8 + lows * 2 * 8 + lows)


def _pallas_bytes(m: int, max_r: int | None) -> int:
    """Leaf or lane tables of the butterfly engine: two (m-1,) int64 stage
    vectors (radix-2), or the grouped tables with ``max_r`` > 1."""
    if max_r is not None and max_r > 1:
        return _grouped_bytes(m, max_r)
    return 2 * (m - 1) * 8


def _leaf_table_bytes(plan, max_r: int | None = None) -> int:
    """Bytes of every table ``PlanTables`` builds for ``plan`` (replicated
    on every device): leaf tables, the lane tables of pallas rows and the
    inter-step tables of inner split levels, each once per key as
    ``PlanTables`` keys them."""
    seen = set()
    total = 0

    def walk(node):
        nonlocal total
        if isinstance(node, planner.Leaf):
            key = ("leaf", node.m, node.engine)
            if key in seen:
                return
            seen.add(key)
            if node.engine == "mxu":
                # (8m, m) int8 digit planes and the (m,) int64 correction
                total += 8 * node.m * node.m + 8 * node.m
            else:
                total += _pallas_bytes(node.m, max_r)
            return
        key = ("split", node.m0, node.m1)
        if key not in seen:
            seen.add(key)
            total += _split_tw_bytes(node.m0 * node.m1)
        if planner._lane_row(node) and ("lane", node.m1) not in seen:
            seen.add(("lane", node.m1))
            total += _pallas_bytes(node.m1, max_r)
        walk(node.col)
        walk(node.row)

    walk(plan)
    return total


@dataclass(frozen=True)
class MemoryBudget:
    """Per-device byte budget of one DistributedNTT configuration."""

    n: int
    devices: int
    coefficients: int  # input/output shard
    transient: int  # non-donated second buffer + all-to-all staging
    inter_step_twiddles: int  # sharded (n0, n1) matrix, per direction
    leaf_tables: int  # replicated, per direction
    directions: int

    @property
    def total(self) -> int:
        return (
            self.coefficients
            + self.transient
            + self.directions * (self.inter_step_twiddles + self.leaf_tables)
        )

    def fits(self, hbm_bytes: int = DEFAULT_HBM_BYTES) -> bool:
        return self.total <= hbm_bytes


def distributed_memory_budget(
    config: NttConfig,
    devices: int,
    *,
    enable_forward: bool = True,
    enable_inverse: bool = True,
    donate_input: bool = False,
) -> MemoryBudget:
    """Per-device budget of ``DistributedNTT(config, mesh)`` over
    ``devices`` shards, without constructing anything."""
    n0, n1 = config.split
    if n0 % devices or n1 % devices:
        raise ValueError(f"n0={n0}, n1={n1} must be divisible by mesh size {devices}")
    n = config.n
    shard = n // devices * BYTES_PER_POINT
    # the (n0, n1) inter-step matrix sharded over the mesh; from
    # W_ONLY_THRESHOLD on without its companion (half the bytes)
    tw = n // devices * BYTES_PER_POINT
    if n < W_ONLY_THRESHOLD:
        tw *= 2
    engine = _resolve_engine(config.engine)
    leaf = _leaf_table_bytes(planner.build_plan(n0, engine), config.max_r) + _leaf_table_bytes(
        planner.build_plan(n1, engine), config.max_r
    )
    directions = int(enable_forward) + int(enable_inverse)
    # transient: the all-to-all writes a fresh shard (always), plus the
    # un-donated input copy when the caller keeps their buffer
    transient = shard if donate_input else 2 * shard
    return MemoryBudget(
        n=n,
        devices=devices,
        coefficients=shard,
        transient=transient,
        inter_step_twiddles=tw,
        leaf_tables=leaf,
        directions=directions,
    )


def validate_2p30(devices: int = 8) -> MemoryBudget:
    """The row-sharded 2^30 flagship transform over ``devices`` devices must
    fit one device's memory, one direction at a time with donation.
    Returns the budget."""
    from ..field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS

    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 30, strategy="six_step")
    budget = distributed_memory_budget(cfg, devices, enable_inverse=False, donate_input=True)
    if not budget.fits():
        raise ValueError(
            f"2^30 over {devices} devices needs {budget.total / 2**30:.1f} GiB "
            f"per device (> {DEFAULT_HBM_BYTES / 2**30:.1f} GiB)"
        )
    return budget
