"""Recursive transform planner: leaves composed by six-step splits.

The counterpart of ``sventt_tpu/plan/planner.py`` for its three engines:
the matrix engine ("mxu"), the butterfly engine ("pallas", radix-2 or,
with ``max_r`` > 1, radix-2^R grouped) and the portable engine ("jnp",
plain torch ops, ``ops.ntt_jnp``).  A plan is a static tree:

* ``Leaf(m, engine)`` -- a length-m NTT along the leading axis
  (``ops.ntt_mxu.mxu_ntt``, ``ops.ntt_pallas.fused_ntt`` or, chunked,
  ``ops.ntt_jnp.ntt_forward`` / ``ntt_inverse``).
* ``Split(m, m0, m1)`` -- the six-step decomposition m = m0*m1: column
  NTTs (the ``col`` subtree, length m0), then the row step (the ``row``
  subtree, length m1).  The output is bit-reversed like a Leaf of the same
  length, so nodes compose, also across engines.

A row that is a leaf takes the inter-step twiddle multiply fused into its
kernel.  It runs mid-axis when the node has batch axes (inner levels: no
transposes).  At the unbatched root it runs lane-axis on the data as it
lies, with the level's table in its natural (m0, m1) layout: a pallas row
as in the JAX package, an mxu row on the port's own choice -- the JAX
package runs that one lead-axis between two transposes with the table
stored transposed (``split_tw_t``), for Mosaic's sake
(``sventt_tpu/plan/planner.py:555-574``), and the two agree bit for bit.
A jnp row runs along axis 1 at every level, batched or not, in chunks of
rows, each chunk's inter-step multiply (``ops.inter_step``) and row
transform together (``_jnp_mid_chunked``).  Every other row step -- a
batched pallas row with grouped tables (the mid kernel takes per-stage
tables only) or a row subtree -- takes the JAX package's transpose
fallback: the inter-step multiply as its own pass (``ops.inter_step``), a
transpose, the row as a leading-axis transform, a transpose back
(mirrored on the inverse).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field.limb import FieldConsts
from ..field.modulus import Modulus
from ..ops import inter_step, ntt_mxu, ntt_pallas
from ..ops.ntt_jnp import ntt_forward, ntt_forward_mid, ntt_inverse, ntt_inverse_mid
from ..ops.transpose import transpose01
from ..ops.twiddle import (
    MontPair,
    forward_tables,
    inverse_tables,
    montpair_map,
    sixstep_row_twiddles,
    sixstep_row_twiddles_device,
    sixstep_row_twiddles_inverse,
    sixstep_row_twiddles_plain,
)
from ..utils.device import resolve_device

#: Above this element count inter-step twiddle matrices are generated on the
#: device instead of with host Python ints.
DEVICE_TWIDDLE_THRESHOLD = 1 << 16

#: At and above this element count the Montgomery companion array is
#: dropped (the multiply computes it in flight), halving twiddle memory.
W_ONLY_THRESHOLD = 1 << 26

#: Largest element count of one chunk of a jnp leaf or jnp row step, the
#: JAX package's value (sized there for a TPU core's vector memory, not
#: tuned for the GPU).  A chunk's stage chain holds a few temporaries of
#: its size, so the chunks bound the engine's scratch memory on the card.
JNP_RESIDENT_ELEMS = 1 << 21

#: Largest jnp leaf a ``plan_spec`` may name.
JNP_SPEC_CAP = 1 << 22


def row_twiddles(
    mod: Modulus, n0: int, n1: int, *, inverse: bool,
    w_only: bool | None = None, modmul: str = "montgomery",
    transposed: bool = False, device=None,
) -> MontPair:
    """Inter-step twiddle matrix for one Split level: Montgomery form for
    every engine (Shoup applies to stage twiddles only) but Solinas, whose
    tables are plain canonical values and always companion-free, whatever
    ``w_only`` says (``ops.twiddle.inter_step_mul`` multiplies them).

    ``w_only`` drops the companion; None applies W_ONLY_THRESHOLD.
    ``transposed`` returns the (n1, n0) layout, the JAX package's table of
    a lead-axis root step (no plan of the port reads it).
    """
    if modmul != "solinas":
        modmul = "montgomery"
    if w_only is None:
        w_only = n0 * n1 >= W_ONLY_THRESHOLD
    if n0 * n1 > DEVICE_TWIDDLE_THRESHOLD:
        return sixstep_row_twiddles_device(
            mod, n0, n1, inverse=inverse, with_companion=not w_only, modmul=modmul,
            transposed=transposed, device=device,
        )
    if modmul == "solinas":
        tw = sixstep_row_twiddles_plain(mod, n0, n1, inverse=inverse, device=device)
    else:
        build = sixstep_row_twiddles_inverse if inverse else sixstep_row_twiddles
        tw = build(mod, n0, n1, device)
        if w_only:
            tw = MontPair(tw.w, None)
    if transposed:
        tw = _transpose_pair(tw)
    return tw


def _transpose_pair(tw: MontPair) -> MontPair:
    return montpair_map(lambda a: a.t().contiguous(), tw)


@dataclass(frozen=True)
class Leaf:
    m: int
    engine: str  # "mxu" | "pallas" | "jnp"


@dataclass(frozen=True)
class Split:
    m: int
    m0: int
    m1: int
    col: "Leaf | Split"
    row: "Leaf | Split"


def build_plan(n: int, engine: str, max_fused: int | None = None) -> "Leaf | Split":
    """Static plan tree for a length-n transform.

    log2(n) is cut into the fewest near-equal factors, each <= max_fused
    (512 for mxu, ``ntt_pallas.MAX_FUSED`` = 256 for pallas, 2^13 for jnp),
    left-deep: the row side is a leaf, the column side recurses.  mxu: 2^17
    -> 256 x 512, 2^24 -> (256 x 256) x 256; pallas: 2^17 -> (32 x 64) x
    64; jnp: 2^17 -> 256 x 512, 2^24 -> 4096 x 4096.
    """
    if max_fused is None:
        max_fused = {"mxu": 512, "pallas": ntt_pallas.MAX_FUSED}.get(engine, 1 << 13)
    if n <= max_fused:
        return Leaf(n, engine)
    log2n = n.bit_length() - 1
    log2f = max_fused.bit_length() - 1
    k = -(-log2n // log2f)
    n1 = 1 << -(-log2n // k)
    n0 = n // n1
    return Split(n, n0, n1, build_plan(n0, engine, max_fused), Leaf(n1, engine))


def build_plan_spec(n: int, spec: str) -> "Leaf | Split":
    """Explicit plan tree from a spec string, top-down: ``engine:m1`` per
    Split level (its row leaf), then a bare engine for the column leaf.
    Validates exactly as ``sventt_tpu.plan.planner.build_plan_spec``."""
    caps = {"jnp": JNP_SPEC_CAP, "pallas": ntt_pallas.MAX_FUSED, "mxu": ntt_mxu.MAX_MXU}

    def leaf(m: int, engine: str) -> Leaf:
        if engine not in caps:
            raise ValueError(f"plan_spec: unknown engine {engine!r}")
        if m > caps[engine]:
            raise ValueError(
                f"plan_spec: leaf m={m} exceeds the {engine} cap {caps[engine]}"
            )
        return Leaf(m, engine)

    def rec(n: int, parts: list[str]):
        head, rest = parts[0], parts[1:]
        if not rest:
            if ":" in head:
                raise ValueError(
                    "plan_spec: the last element is the column LEAF -- a "
                    f"bare engine name, got {head!r}"
                )
            return leaf(n, head)
        if ":" not in head:
            raise ValueError(f"plan_spec: split levels need 'engine:m1', got {head!r}")
        engine, m1s = head.split(":", 1)
        m1 = int(m1s)
        if m1 < 2 or m1 & (m1 - 1) or n % m1 or m1 >= n:
            raise ValueError(f"plan_spec: m1={m1} must be a power of two dividing n={n}")
        return Split(n, n // m1, m1, rec(n // m1, rest), leaf(m1, engine))

    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError("plan_spec: empty spec")
    return rec(n, parts)


def _row_engine(node) -> str | None:
    """The engine of a Split's row leaf (None for a Leaf or a row subtree)."""
    if isinstance(node, Split) and isinstance(node.row, Leaf):
        return node.row.engine
    return None


def _mxu_row(node) -> bool:
    return _row_engine(node) == "mxu"


def _jnp_row(node) -> bool:
    """Split nodes whose row child is a jnp leaf: along axis 1 in chunks,
    the inter-step multiply with each chunk (``_jnp_mid_chunked``)."""
    return _row_engine(node) == "jnp"


def _lane_row(node) -> bool:
    """Split nodes whose row child is a pallas leaf: lane-axis when the
    batch is empty; when batched, mid-axis if its tables are per-stage
    (``_mid_row``), else the transpose fallback."""
    return _row_engine(node) == "pallas"


def _mid_row(node, tables: "PlanTables") -> bool:
    """A pallas row leaf that the mid kernel takes when batched: per-stage
    tables (``FusedDirection``), as the JAX package decides."""
    return _lane_row(node) and isinstance(
        tables.leaf.get((node.m1, "pallas")), ntt_pallas.FusedDirection
    )


class PlanTables:
    """Twiddle, matrix and stage tables for every node of a plan, one
    direction, on one device (None: the CUDA card).

    ``leaf[(m, engine)]``: MxuDirection, FusedDirection or (``max_r`` > 1)
    GroupedDirection, or ForwardTables / InverseTables of a jnp leaf;
    ``lane[m1]``: LaneDirection or GroupedLaneDirection
    of a pallas row leaf, for the unbatched lane-axis step;
    ``split_tw[(m0, m1)]``: the (m0, m1) MontPair of every level, the root's
    included (the JAX package also keeps an mxu root's table transposed, in
    ``split_tw_t``; the port has no such copy).  The pallas knobs
    (``block_b``, ``spc``, ``rows``, ``max_r``, ``tw_layout``) go to the
    pallas tables; ``chunk_elems`` (None: ``JNP_RESIDENT_ELEMS``) bounds a
    chunk of the jnp leaves and rows.
    """

    def __init__(
        self, plan, mod: Modulus, fc: FieldConsts, inverse: bool, *,
        device=None, split_w_only: bool | None = None, block_b: int | None = None,
        spc: int | None = None, rows: int | None = None, max_r: int | None = None,
        tw_layout: str | None = None, chunk_elems: int | None = None,
    ):
        self.plan = plan
        self.mod = mod
        self.fc = fc
        self.inverse = inverse
        self.device = resolve_device(device)
        self.split_w_only = split_w_only
        self.knobs = dict(block_b=block_b, spc=spc, max_r=max_r, tw_layout=tw_layout)
        self.rows = rows
        self.chunk_elems = chunk_elems
        self.leaf: dict = {}
        self.lane: dict = {}
        self.split_tw: dict = {}
        self._prepare(plan)

    @classmethod
    def from_parts(
        cls, plan, mod: Modulus, fc: FieldConsts, inverse: bool, *,
        leaf: dict, split_tw: dict, lane: dict | None = None,
    ) -> "PlanTables":
        """Tables assembled from prepared parts (see ``interop``)."""
        obj = object.__new__(cls)
        obj.plan, obj.mod, obj.fc, obj.inverse = plan, mod, fc, inverse
        first = next(iter(leaf.values()))
        obj.device = (first.planes if isinstance(first, ntt_mxu.MxuDirection) else first.w).device
        obj.split_w_only = None
        obj.knobs, obj.rows, obj.chunk_elems = {}, None, None
        obj.leaf, obj.split_tw = leaf, split_tw
        obj.lane = lane or {}
        return obj

    def _prepare(self, node):
        if isinstance(node, Leaf):
            key = (node.m, node.engine)
            if key in self.leaf:
                return
            if node.engine == "mxu":
                self.leaf[key] = ntt_mxu.make_mxu_tables(
                    self.mod, node.m, inverse=self.inverse, device=self.device
                )
            elif node.engine == "jnp":
                build = inverse_tables if self.inverse else forward_tables
                self.leaf[key] = build(self.mod, node.m, modmul=self.fc.modmul, device=self.device)
            else:
                self.leaf[key] = ntt_pallas.make_leaf_tables(
                    self.mod, node.m, inverse=self.inverse, modmul=self.fc.modmul,
                    device=self.device, **self.knobs,
                )
            return
        key = (node.m0, node.m1)
        if key not in self.split_tw:
            self.split_tw[key] = row_twiddles(
                self.mod, node.m0, node.m1, inverse=self.inverse,
                w_only=self.split_w_only, modmul=self.fc.modmul, device=self.device,
            )
        if _lane_row(node) and node.m1 not in self.lane:
            self.lane[node.m1] = ntt_pallas.make_lane_tables(
                self.mod, node.m1, inverse=self.inverse, modmul=self.fc.modmul,
                max_r=self.knobs["max_r"], rows=self.rows, device=self.device,
            )
        self._prepare(node.col)
        self._prepare(node.row)


def _row_step(mat: torch.Tensor, node: Split, tables: PlanTables, batch) -> torch.Tensor:
    """The row step of a Split on (m0, m1, batch...) data: a row leaf with
    the inter-step twiddle fused into its kernel (prologue forward,
    epilogue inverse) -- lane-axis at the unbatched root, mid-axis when
    batched; a jnp row along axis 1 with the multiply in each chunk -- else
    the transpose fallback."""
    fc = tables.fc
    tw = tables.split_tw[(node.m0, node.m1)]
    if _jnp_row(node):
        return _jnp_mid_chunked(mat, tables.leaf[(node.m1, "jnp")], fc, tw, tables.inverse,
                                tables.chunk_elems)
    if _lane_row(node) and not batch:
        return ntt_pallas.fused_ntt_lane(mat, tables.lane[node.m1], fc, pre_tw=tw)
    if _mid_row(node, tables):
        return ntt_pallas.fused_ntt_mid(mat, tables.leaf[(node.m1, "pallas")], fc, tw=tw)
    if not _mxu_row(node):
        return _transposed_row(mat, node, tables)
    t = tables.leaf[(node.m1, "mxu")]
    if batch:
        return ntt_mxu.mxu_ntt_mid(mat, t, fc, tw=tw)
    return ntt_mxu.mxu_ntt_lane(mat, t, fc, tw=tw)


def _transposed_row(mat: torch.Tensor, node: Split, tables: PlanTables) -> torch.Tensor:
    """The JAX package's fallback row step (``sventt_tpu/plan/planner.py``
    ``:595-599`` and ``:653-657``): forward, the inter-step multiply, a
    transpose to (m1, m0, batch...), the row transform along the leading
    axis, a transpose back; the inverse mirrors it."""
    tw = tables.split_tw[(node.m0, node.m1)]
    if not tables.inverse:
        mat = transpose01(inter_step.mont_mul_bcast(tables.fc, mat, tw))
        return transpose01(run_forward(mat, node.row, tables))
    mat = transpose01(run_inverse(transpose01(mat), node.row, tables))
    return inter_step.mont_mul_bcast(tables.fc, mat, tw)


def _leaf(x: torch.Tensor, node: Leaf, tables: PlanTables) -> torch.Tensor:
    t = tables.leaf[(node.m, node.engine)]
    if node.engine == "pallas":
        return ntt_pallas.fused_ntt(x, t, tables.fc)
    if node.engine == "jnp":
        fn = ntt_inverse if tables.inverse else ntt_forward
        return _jnp_chunked(x, t, tables.fc, fn, tables.chunk_elems)
    return ntt_mxu.mxu_ntt(x, t, tables.fc)


# The jnp engine's chunk loops.  The JAX package unrolls few chunks and runs
# many under a lax.fori_loop of dynamic slices (``MAX_UNROLLED_CHUNKS``), a
# bound on its TPU compile time; eager torch has no compile step, so one
# Python loop writes the chunks into a preallocated output.  The chunk size
# changes no value: each chunk's columns (rows) are transformed alone.


def _jnp_chunked(x: torch.Tensor, t, fc: FieldConsts, fn, chunk_elems: int | None = None):
    """A leading-axis jnp transform ``fn`` of (m, batch...) data, in chunks
    of batch columns of at most ``chunk_elems`` elements (None:
    ``JNP_RESIDENT_ELEMS``); one call when the whole fits, the batch is 1
    or the chunk does not divide it."""
    resident = chunk_elems or JNP_RESIDENT_ELEMS
    m = x.shape[0]
    b = x[0].numel()
    chunk_b = max(1, resident // m)
    if m * b <= resident or b == 1 or b % chunk_b:
        return fn(x, t, fc)
    xm = x.reshape(m, b)
    out = torch.empty_like(xm)
    for i in range(0, b, chunk_b):
        out[:, i:i + chunk_b] = fn(xm[:, i:i + chunk_b], t, fc)
    return out.reshape(x.shape)


def _jnp_mid_chunked(
    x: torch.Tensor, t, fc: FieldConsts, tw: MontPair | None, inverse: bool,
    chunk_elems: int | None = None,
) -> torch.Tensor:
    """The six-step row step on (m0, m1, batch...) without transposes: the
    axis-1 jnp transform in chunks of rows of at most ``chunk_elems``
    elements, each chunk's inter-step multiply (``inter_step``) with it --
    forward before the row NTT, inverse after.  ``tw=None`` runs the bare
    axis-1 transform (the distributed schedule applies its twiddles under
    another sharding)."""
    m0, m1 = x.shape[0], x.shape[1]
    b = x[0, 0].numel()
    fn = ntt_inverse_mid if inverse else ntt_forward_mid

    def run(v: torch.Tensor, w: MontPair | None) -> torch.Tensor:
        if w is None:
            return fn(v, t, fc)
        if not inverse:
            return fn(inter_step.mont_mul_bcast(fc, v, w), t, fc)
        return inter_step.mont_mul_bcast(fc, fn(v, t, fc), w)

    chunk_a = max(1, (chunk_elems or JNP_RESIDENT_ELEMS) // (m1 * b))
    if chunk_a >= m0 or m0 % chunk_a:
        return run(x, tw)
    out = torch.empty_like(x)
    for i in range(0, m0, chunk_a):
        sl = slice(i, i + chunk_a)
        out[sl] = run(x[sl], None if tw is None else montpair_map(lambda a: a[sl], tw))
    return out


def _release(donated: torch.Tensor | None) -> None:
    """Free the storage of the donated input (``NTT(donate_input=True)``)
    once the step that read it has been issued: the kernels are
    out-of-place, so each level's output lands in a new buffer and, with the
    input's memory back in the caching allocator, the transform holds two
    n-word buffers at a time, not three.  Stream order keeps the freed block
    from being rewritten before that step has read it."""
    if donated is not None:
        donated.untyped_storage().resize_(0)


def run_forward(
    x: torch.Tensor, node, tables: PlanTables, donated: torch.Tensor | None = None
) -> torch.Tensor:
    """Length-m DIF NTT along the leading axis (bit-reversed output).
    ``donated``: the tensor whose storage ``x`` lies in, released after the
    first step (the deepest column leaf) has read it."""
    if isinstance(node, Leaf):
        out = _leaf(x, node, tables)
        _release(donated)
        return out
    batch = tuple(x.shape[1:])
    mat = x.reshape((node.m0, node.m1) + batch)
    mat = run_forward(mat, node.col, tables, donated)  # column NTTs, leading axis m0
    mat = _row_step(mat, node, tables, batch)
    return mat.reshape((node.m,) + batch)


def run_inverse(
    x: torch.Tensor, node, tables: PlanTables, donated: torch.Tensor | None = None
) -> torch.Tensor:
    """Mirror of run_forward: undo the row step, then the column NTTs;
    ``donated`` is released after the first step (the root's row step)."""
    if isinstance(node, Leaf):
        out = _leaf(x, node, tables)
        _release(donated)
        return out
    batch = tuple(x.shape[1:])
    mat = x.reshape((node.m0, node.m1) + batch)
    mat = _row_step(mat, node, tables, batch)
    _release(donated)
    mat = run_inverse(mat, node.col, tables)
    return mat.reshape((node.m,) + batch)
