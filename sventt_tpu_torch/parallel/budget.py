"""Memory budgeting and plan validation for huge distributed transforms.

The counterpart of ``sventt_tpu/parallel/budget.py``: the per-device byte
budget of a ``DistributedNTT`` computed WITHOUT building it, so 2^30-class
plans can be checked anywhere.  8 bytes a point (one int64 word, the JAX
package's two u32 limbs).  The table bytes are the port's own tables --
compact stage vectors (no companion vector under Solinas), (8m, m) int8
planes, (groups, m) grouped tables -- not the TPU's broadcast tiles.  Tables
built on a CUDA device (``device="cuda"``, the default) also hold each mxu
leaf's digit planes a second time, in the tensor-core kernel's tile layout
(``MxuDirection.tc_planes``, ``ntt_mxu.tc_plane_tile_bytes``: 8 x m x kp
bytes, m rounded up to its row groups, at most 8 MiB at m = 1024); CPU
tables (``device="cpu"``) have no such copy.

The data terms follow the JAX rule where the port holds the same buffers:
the input shard (``coefficients``), and the all-to-all's fresh output
beside a second buffer (``transient``): two shards, or one with
``donate_input=True``, the JAX rule (``sventt_tpu/parallel/budget.py:123``).
For ``DistributedNTT`` donation means that the caller hands its list of
shards over and keeps no reference to them: the schedule already drops
each step's input as soon as its output exists.  The eager port also holds, while one shard's local
transform runs, the intermediates of its kernel chain that XLA would fuse
away: a transposed copy and the outputs of two kernels beside that
shard's input and output, two shards' worth (``step_scratch``, the port's
own term).  ``DistributedNTT`` releases each shard's step input as soon as
its output exists and builds each shard's inter-step block on its own
device, so nothing else is held longer than the step that needs it; under
``comm="overlap"`` a chunk's exchange is joined, and its inputs freed,
before the next chunk's is launched.  With
logical shards (a mesh that names one card D times) the card holds D
shards' data, one copy of the tables and, since its shards run one after
another, one shard's scratch (``MemoryBudget.card_total``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops import ntt_mxu, ntt_pallas
from ..plan import planner
from ..plan.config import NttConfig
from ..plan.planner import W_ONLY_THRESHOLD
from ..plan.wrapper import _auto_max_fused, _resolve_engine

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


def _pallas_bytes(m: int, max_r: int | None, solinas: bool) -> int:
    """Leaf or lane tables of the butterfly engine: two (m-1,) int64 stage
    vectors (radix-2; one under Solinas), or the grouped tables with
    ``max_r`` > 1 (never under Solinas, which forces radix-2)."""
    if solinas:
        return (m - 1) * 8
    if max_r is not None and max_r > 1:
        return _grouped_bytes(m, max_r)
    return 2 * (m - 1) * 8


def _leaf_table_bytes(
    plan, max_r: int | None = None, solinas: bool = False, cuda: bool = True
) -> int:
    """Bytes of every table ``PlanTables`` builds for ``plan`` (replicated
    on every device): leaf tables, the lane tables of pallas rows and the
    inter-step tables of inner split levels (companion-free under
    Solinas), each once per key as ``PlanTables`` keys them; ``cuda``: an
    mxu leaf also holds its tensor-core tile copy."""
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
                if cuda:
                    total += ntt_mxu.tc_plane_tile_bytes(node.m)
            else:
                total += _pallas_bytes(node.m, max_r, solinas)
            return
        key = ("split", node.m0, node.m1)
        if key not in seen:
            seen.add(key)
            m = node.m0 * node.m1
            total += m * BYTES_PER_POINT if solinas else _split_tw_bytes(m)
        if planner._lane_row(node) and ("lane", node.m1) not in seen:
            seen.add(("lane", node.m1))
            total += _pallas_bytes(node.m1, max_r, solinas)
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
    transient: int  # the all-to-all's output beside the non-donated input
    inter_step_twiddles: int  # sharded (n0, n1) matrix, per direction
    leaf_tables: int  # replicated, per direction
    directions: int
    step_scratch: int  # the port's own: one shard's kernel-chain intermediates

    @property
    def total(self) -> int:
        return self.card_total(1)

    def card_total(self, shards: int) -> int:
        """Bytes of a device holding ``shards`` logical shards: each one's
        data and inter-step block, one copy of the replicated tables, and
        one shard's scratch (a device's shards run one after another)."""
        per_shard = self.coefficients + self.transient + self.directions * self.inter_step_twiddles
        return shards * per_shard + self.directions * self.leaf_tables + self.step_scratch

    def fits(self, hbm_bytes: int = DEFAULT_HBM_BYTES) -> bool:
        return self.total <= hbm_bytes


def distributed_memory_budget(
    config: NttConfig,
    devices: int,
    *,
    enable_forward: bool = True,
    enable_inverse: bool = True,
    donate_input: bool = False,
    device: str = "cuda",
) -> MemoryBudget:
    """Per-device budget of ``DistributedNTT(config, mesh)`` over
    ``devices`` shards, without constructing anything.  ``donate_input``:
    the caller keeps no reference to its input shards (one shard of
    ``transient``, not two).  ``device``: the type of device the tables
    will live on, "cuda" (the port's default) or "cpu"; nothing is built,
    so no card is needed."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
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
    engine = _resolve_engine(config, device)
    cap = _auto_max_fused(config, engine)
    solinas = config.modmul == "solinas"
    leaf = sum(
        _leaf_table_bytes(planner.build_plan(m, engine, cap), config.max_r, solinas,
                          device == "cuda")
        for m in (n0, n1)
    )
    directions = int(enable_forward) + int(enable_inverse)
    return MemoryBudget(
        n=n,
        devices=devices,
        coefficients=shard,
        transient=shard if donate_input else 2 * shard,
        inter_step_twiddles=tw,
        leaf_tables=leaf,
        directions=directions,
        step_scratch=2 * shard,
    )


def validate_2p30(devices: int = 8) -> MemoryBudget:
    """The row-sharded 2^30 flagship transform over ``devices`` devices must
    fit one device's memory, one direction at a time, with the caller's
    input kept: unlike the JAX rule's, no donated distributed peak has been
    measured on the card.  Returns the budget."""
    from ..field.modulus import FLAGSHIP_GENERATOR, FLAGSHIP_MODULUS

    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 30, strategy="six_step")
    budget = distributed_memory_budget(cfg, devices, enable_inverse=False)
    if not budget.fits():
        raise ValueError(
            f"2^30 over {devices} devices needs {budget.total / 2**30:.1f} GiB "
            f"per device (> {DEFAULT_HBM_BYTES / 2**30:.1f} GiB)"
        )
    return budget
