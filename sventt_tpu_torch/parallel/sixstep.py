"""Distributed six-step NTT: row-sharded matrix, all-to-all transposes.

The counterpart of ``sventt_tpu/parallel/sixstep.py``.  The n = n0*n1
coefficient vector is row-sharded over the D devices of a mesh: a list of D
int64 tensors, shard d of shape (n/D,) on mesh device d, the contiguous
block d (as ``P(axis)`` lays it out).  One process drives every shard, as
the JAX package's ``shard_map`` does, and the two transposes of the
six-step schedule are all-to-alls between the shards.  Forward:

  flat x: (n,) = row-major (n0, n1), shard d = rows [d*n0/D, (d+1)*n0/D)
  1. all-to-all   -> (n0, n1/D) column shards       [comm 1]
  2. column NTTs over the full local leading axis n0
  3. twiddle multiply W[p0, j1] = omega_n^(bitrev(p0)*j1) (column-sharded)
  4. all-to-all + local transpose -> (n1, n0/D)     [comm 2]
  5. row NTTs over the full local leading axis n1
  6. local transpose -> (n0/D, n1): the flat bit-reversed output, row-sharded

which gives the single-device ``NTT`` wrapper's output, equal mod N, shard
by shard; the inverse runs the mirror schedule.  The local transforms are
the port's plans and kernels on each shard's device, the inter-step
multiply is the kernel ``ops.inter_step.mont_mul_bcast`` and the local
transposes follow ``NttConfig.transpose``.

``comm`` picks the all-to-all: "xla" the torch-copy exchange
(``ring.copy_all_to_all``, the counterpart of ``lax.all_to_all``), "ring"
the kernel K10 (``ring.ring_all_to_all``, one mesh axis only), "overlap"
the torch copy with the column step and [comm 2] chunked
``overlap_chunks`` ways: on CUDA shards chunk c's exchange runs on a side
stream of each card while chunk c+1's column NTTs run, joined by events.
All three give the same bits.

Divergences from the JAX package: ``engine="auto"`` is the matrix engine
("mxu", see ``plan.wrapper``), and the config's pallas knobs (``max_r``,
``block_b``, ``stages_per_call``, ``lane_rows``, ``tw_layout``) reach the
local plans, which the JAX package builds with its defaults (residues
agree mod N either way).  A collective axis that leaves mesh axes out
(shards replicated over them) is not ported, nor are ``forward_step`` /
``inverse_step`` (ROADMAP Queue 1 items 5 and 11).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..field.limb import FieldConsts, from_numpy
from ..ops import inter_step
from ..ops.transpose import transpose01_u64
from ..ops.twiddle import MontPair, montpair_map
from ..plan import planner
from ..plan.config import NttConfig
from ..plan.planner import PlanTables, row_twiddles
from ..plan.wrapper import _resolve_engine, _resolve_modmul
from .mesh import AXIS, Mesh
from .ring import copy_all_to_all, ring_all_to_all


@dataclass
class DirectionTables:
    """One direction's tables: ``tw[d]``, shard d's (n0, n1/D) columns of
    the inter-step twiddle matrix on mesh device d; ``col`` / ``row``, the
    local plans' tables (``root_lead=False``) per distinct mesh device."""

    tw: list[MontPair]
    col: dict[torch.device, PlanTables]
    row: dict[torch.device, PlanTables]


def shard_columns(tw: MontPair, devices) -> list[MontPair]:
    """The (n0, n1) inter-step matrix cut into len(devices) column blocks,
    block d on ``devices[d]``."""
    w = tw.w.shape[1] // len(devices)
    return [
        montpair_map(lambda a, d=d, dev=dev: a[:, d * w:(d + 1) * w].contiguous().to(dev), tw)
        for d, dev in enumerate(devices)
    ]


def _guard(device: torch.device):
    """Make ``device`` current while a shard's kernels launch."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class DistributedNTT:
    """Forward/inverse six-step NTT sharded over the devices of a mesh.

    Input/output: a list of D int64 tensors, shard d of shape (n/D,) on
    mesh device d (``shard`` / ``gather`` convert a flat vector).  Forward
    emits bit-reversed order, inverse consumes it; values may be lazy
    representatives (``normalize``).  Requires ``n0 % D == 0`` and
    ``n1 % D == 0``.  ``axis`` may be a tuple of mesh axis names (a
    hierarchical ``("dcn", "ici")`` mesh): the shard dimension is their
    combined axis, row-major.  ``comm="ring"`` needs a 1-D mesh whose axis
    is the collective axis; ``overlap_chunks`` is reduced until it divides
    n1/D.
    """

    def __init__(
        self,
        config: NttConfig,
        mesh: Mesh,
        axis: str | tuple[str, ...] = AXIS,
        enable_forward: bool = True,
        enable_inverse: bool = True,
        comm: str = "xla",
        overlap_chunks: int = 4,
    ):
        n0, n1 = config.split
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        D = 1
        for a in axes:
            D *= mesh.shape[a]
        if n0 % D or n1 % D:
            raise ValueError(f"n0={n0}, n1={n1} must be divisible by mesh size {D}")
        if comm not in ("xla", "ring", "overlap"):
            raise ValueError(f"unknown comm {comm!r}")
        if comm == "overlap":
            w2 = n1 // D
            while overlap_chunks > 1 and w2 % overlap_chunks:
                overlap_chunks -= 1
        self.overlap_chunks = overlap_chunks
        if comm == "ring" and (tuple(mesh.axis_names) != axes or len(axes) != 1):
            raise ValueError(
                "comm='ring' needs a 1-D mesh whose single axis is the "
                f"collective axis (mesh {mesh.axis_names}, axes {axes}); "
                "hierarchical meshes use comm='xla'"
            )
        if sorted(axes) != sorted(mesh.axis_names):
            raise NotImplementedError(
                f"axes {axes} leave mesh axes of {mesh.axis_names} out; shards "
                "replicated over them are not ported yet (ROADMAP Queue 1 item 11)"
            )
        if config.tune:
            raise NotImplementedError("tune=True is not ported yet (ROADMAP Queue 1 item 10)")
        self.config = config
        self.mesh = mesh
        self.axes = axes
        self.comm = comm
        self.D = D
        self.n0, self.n1 = n0, n1
        #: shard d's device: the mesh devices along the combined axis
        self.devices = mesh.devices_along(axes)
        self.mod = config.mod  # API parity with NTT: apps duck-type over both
        self.fc = FieldConsts.from_modulus(
            self.mod, lazy=config.lazy, modmul=_resolve_modmul(config)
        )
        engine = _resolve_engine(config.engine)
        self._col_plan = planner.build_plan(n0, engine)
        self._row_plan = planner.build_plan(n1, engine)
        self._side: dict[int, torch.cuda.Stream] = {}
        # tables per enabled direction only: at 2^30 each direction's are GBs
        self._forward = self._tables(inverse=False) if enable_forward else None
        self._inverse = self._tables(inverse=True) if enable_inverse else None

    def _tables(self, inverse: bool) -> DirectionTables:
        cfg = self.config
        knobs = dict(
            block_b=cfg.block_b, spc=cfg.stages_per_call, rows=cfg.lane_rows,
            max_r=cfg.max_r, tw_layout=cfg.tw_layout, root_lead=False,
        )
        col, row = {}, {}
        for dev in dict.fromkeys(self.devices):
            col[dev] = PlanTables(self._col_plan, self.mod, self.fc, inverse, device=dev, **knobs)
            row[dev] = PlanTables(self._row_plan, self.mod, self.fc, inverse, device=dev, **knobs)
        full = row_twiddles(
            self.mod, self.n0, self.n1, inverse=inverse, w_only=cfg.split_w_only,
            modmul=self.fc.modmul, device=self.devices[0],
        )
        return DirectionTables(shard_columns(full, self.devices), col, row)

    # -- public API ---------------------------------------------------------

    def get_m(self) -> int:
        return self.config.n

    def shard(self, x) -> list[torch.Tensor]:
        """A flat (n,) vector (int64 tensor or numpy uint64) as the D
        row-sharded blocks on their devices (new memory)."""
        if isinstance(x, np.ndarray):
            x = from_numpy(x, "cpu")
        if x.shape != (self.config.n,):
            raise ValueError(f"expected shape ({self.config.n},), got {tuple(x.shape)}")
        k = self.config.n // self.D
        return [x[d * k:(d + 1) * k].to(dev, copy=True) for d, dev in enumerate(self.devices)]

    def gather(self, shards) -> torch.Tensor:
        """The flat vector of ``shards``, on the host."""
        return torch.cat([s.cpu() for s in shards])

    def normalize(self, shards) -> list[torch.Tensor]:
        return [self.fc.normalize(s) for s in shards]

    def compute_forward(self, x) -> list[torch.Tensor]:
        if self._forward is None:
            raise RuntimeError("forward transform was not enabled")
        return self._forward_local(self._check(x), self._forward)

    def compute_inverse(self, x) -> list[torch.Tensor]:
        if self._inverse is None:
            raise RuntimeError("inverse transform was not enabled")
        return self._inverse_local(self._check(x), self._inverse)

    def _check(self, shards) -> list[torch.Tensor]:
        if len(shards) != self.D:
            raise ValueError(f"expected {self.D} shards, got {len(shards)}")
        k = self.config.n // self.D
        for s, dev in zip(shards, self.devices):
            if s.dtype != torch.int64:
                raise TypeError(f"expected int64 shards of u64 bit patterns, got {s.dtype}")
            if tuple(s.shape) != (k,):
                raise ValueError(f"expected shards of shape ({k},), got {tuple(s.shape)}")
            if s.device != dev:
                raise ValueError(f"shard on {s.device}, its mesh device is {dev}")
        return list(shards)

    # -- per-shard steps ----------------------------------------------------

    def _map(self, f, mats) -> list[torch.Tensor]:
        """``f(d, mats[d])`` for every shard, with its device current."""
        out = []
        for d, m in enumerate(mats):
            with _guard(self.devices[d]):
                out.append(f(d, m))
        return out

    def _all_to_all(self, mats, split_axis: int, concat_axis: int) -> list[torch.Tensor]:
        if self.comm == "ring":
            return ring_all_to_all(mats, split_axis, concat_axis, self.axes)
        return copy_all_to_all(mats, split_axis, concat_axis)

    def _tw_mul(self, mat: torch.Tensor, tw: MontPair) -> torch.Tensor:
        return inter_step.mont_mul_bcast(self.fc, mat, tw)

    def _rows(self, mat: torch.Tensor, tables: PlanTables, inverse: bool) -> torch.Tensor:
        """Row NTTs of an (n0/D, n1) shard between two local transposes.
        The JAX package runs a jnp row leaf along axis 1 in place instead
        (``sixstep.py:301-305``); the port builds no jnp plan (the portable
        engine is ROADMAP Queue 1 item 7), so every row takes this path."""
        run = planner.run_inverse if inverse else planner.run_forward
        mat = transpose01_u64(mat, self.config.transpose)  # (n1, n0/D)
        mat = run(mat, self._row_plan, tables)
        return transpose01_u64(mat, self.config.transpose)  # (n0/D, n1)

    def _col_fwd(self, t: DirectionTables, d: int, mat: torch.Tensor, sl=slice(None)):
        """Column NTTs and twiddles of shard d's columns ``sl``."""
        tw = montpair_map(lambda a: a[:, sl], t.tw[d])
        mat = planner.run_forward(mat[:, sl].contiguous(), self._col_plan, t.col[self.devices[d]])
        return self._tw_mul(mat, tw)

    def _col_inv(self, t: DirectionTables, d: int, mat: torch.Tensor, sl=slice(None)):
        mat = self._tw_mul(mat, montpair_map(lambda a: a[:, sl], t.tw[d]))
        return planner.run_inverse(mat, self._col_plan, t.col[self.devices[d]])

    # -- comm/compute overlap (comm="overlap") ------------------------------
    #
    # The local column axis of the (n0, n1/D) block is independent for the
    # column NTT and the twiddle multiply, so both pipelines chunk it K
    # ways: the [comm 2] exchange of chunk c does not depend on chunk c+1's
    # compute.  On CUDA shards the exchanges run on a side stream of each
    # card, joined to the compute streams by events; on CPU shards in turn.

    def _side_all_to_all(self, subs, split_axis: int, concat_axis: int):
        """The torch-copy exchange of ``subs`` on the side streams; returns
        the outputs and, per card, an event recorded after it.  The outputs
        are allocated on the compute streams, which the side streams wait
        for; the caller keeps ``subs`` alive until it has joined the
        events, so no memory crosses streams unordered."""
        cards = sorted({s.device.index for s in subs if s.device.type == "cuda"})
        if not cards:
            return copy_all_to_all(subs, split_axis, concat_axis), {}
        r, c = subs[0].shape
        D = len(subs)
        shape = (D * r, c // D) if split_axis == 1 else (r // D, D * c)
        outs = [torch.empty(shape, dtype=s.dtype, device=s.device) for s in subs]
        for card in cards:
            if card not in self._side:
                self._side[card] = torch.cuda.Stream(card)
            self._side[card].wait_stream(torch.cuda.current_stream(card))
        with contextlib.ExitStack() as stack:
            for card in cards:
                stack.enter_context(torch.cuda.stream(self._side[card]))
            copy_all_to_all(subs, split_axis, concat_axis, out=outs)
        events = {}
        for card in cards:
            events[card] = torch.cuda.Event()
            events[card].record(self._side[card])
        return outs, events

    @staticmethod
    def _join(events) -> None:
        for c, ev in events.items():
            torch.cuda.current_stream(c).wait_event(ev)

    def _overlap_fwd_col_comm2(self, mats, t: DirectionTables) -> list[torch.Tensor]:
        D, K = self.D, self.overlap_chunks
        h, w2 = self.n0 // D, self.n1 // D
        wK = w2 // K
        parts, events, inputs = [], [], []
        for c in range(K):
            sl = slice(c * wK, (c + 1) * wK)
            subs = self._map(lambda d, m: self._col_fwd(t, d, m, sl), mats)
            out, ev = self._side_all_to_all(subs, 0, 1)
            parts.append(out)
            events.append(ev)
            inputs.append(subs)
        for ev in events:
            self._join(ev)
        del inputs  # read by the side streams, which the joins have ordered

        def reasm(d, _):
            # chunk c: (h, D*wK), columns grouped by source shard o; the
            # full layout wants column o*w2 + c*wK + i  ->  (h, D, K, wK)
            s = torch.stack([p[d] for p in parts]).reshape(K, h, D, wK)
            return s.permute(1, 2, 0, 3).reshape(h, self.n1)

        return self._map(reasm, mats)

    def _overlap_inv_comm2_col(self, mats, t: DirectionTables) -> list[torch.Tensor]:
        D, K = self.D, self.overlap_chunks
        h, w2 = self.n0 // D, self.n1 // D
        wK = w2 // K
        chunks = []
        for c in range(K):
            picks = self._map(
                lambda d, m, c=c: m.reshape(h, D, K, wK)[:, :, c, :].reshape(h, D * wK), mats
            )
            chunks.append((*self._side_all_to_all(picks, 1, 0), picks))
        parts = []
        for c, (subs, ev, _) in enumerate(chunks):
            self._join(ev)
            sl = slice(c * wK, (c + 1) * wK)
            parts.append(self._map(lambda d, m: self._col_inv(t, d, m, sl), subs))
        del chunks  # the picks were read by the side streams, joined above
        return self._map(lambda d, _: torch.cat([p[d] for p in parts], dim=1), mats)

    # -- local (per-shard) schedules ---------------------------------------

    def _forward_local(self, shards, t: DirectionTables) -> list[torch.Tensor]:
        n0, n1, D = self.n0, self.n1, self.D
        mats = [x.reshape(n0 // D, n1) for x in shards]
        # [comm 1] row shards -> column shards: (n0/D, n1) -> (n0, n1/D)
        mats = self._all_to_all(mats, 1, 0)
        if self.comm == "overlap":
            # column NTTs + twiddle + [comm 2], chunked for overlap
            mats = self._overlap_fwd_col_comm2(mats, t)
        else:
            # column NTTs over the full local leading axis n0, twiddles
            mats = self._map(lambda d, m: self._col_fwd(t, d, m), mats)
            # [comm 2] column shards of (n0, n1) -> row shards (n0/D, n1)
            mats = self._all_to_all(mats, 0, 1)
        mats = self._map(lambda d, m: self._rows(m, t.row[self.devices[d]], False), mats)
        return [m.reshape(n0 // D * n1) for m in mats]

    def _inverse_local(self, shards, t: DirectionTables) -> list[torch.Tensor]:
        n0, n1, D = self.n0, self.n1, self.D
        mats = [x.reshape(n0 // D, n1) for x in shards]
        mats = self._map(lambda d, m: self._rows(m, t.row[self.devices[d]], True), mats)
        if self.comm == "overlap":
            # undo [comm 2] + twiddles + column NTTs, chunked for overlap
            mats = self._overlap_inv_comm2_col(mats, t)
        else:
            mats = self._all_to_all(mats, 1, 0)  # undo [comm 2]
            mats = self._map(lambda d, m: self._col_inv(t, d, m), mats)
        # undo [comm 1]: column shards -> row shards
        mats = self._all_to_all(mats, 0, 1)
        return [m.reshape(n0 // D * n1) for m in mats]
