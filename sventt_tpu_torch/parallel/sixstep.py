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

(a jnp row leaf runs steps 4-6 as the all-to-all and the row NTTs along
axis 1 of the (n0/D, n1) shard, with no local transpose, as in the JAX
package),

which gives the single-device ``NTT`` wrapper's output, equal mod N, shard
by shard; the inverse runs the mirror schedule.  The local transforms are
the port's plans and kernels on each shard's device, the inter-step
multiply is the kernel ``ops.inter_step.mont_mul_bcast`` and the local
transposes follow ``NttConfig.transpose``.  As in the JAX package, the
inter-step twiddles are Montgomery under every engine: under Solinas the
local plans take Solinas tables, and the inter-step multiply has a
Montgomery ``FieldConsts`` of its own (``tw_fc``).

``comm`` picks the all-to-all: "xla" the torch-copy exchange
(``ring.copy_all_to_all``, the counterpart of ``lax.all_to_all``), "ring"
the kernel K10 (``ring.ring_all_to_all``, one mesh axis only), "overlap"
the torch copy with the column step and [comm 2] chunked
``overlap_chunks`` ways: on CUDA shards chunk c's exchange runs on a side
stream of each card while chunk c+1's column NTTs run, joined by events.
All three give the same bits.

A collective ``axis`` that leaves mesh axes out runs the schedule within
each group of devices along it (``Mesh.replica_groups``), the vector
replicated over the other axes, as ``P(axis)`` lays it out in JAX's
``shard_map``: the list then holds R x D shards, group r's D shards at
[r*D, (r+1)*D), every group holding the whole vector.

Divergences from the JAX package: ``engine="auto"`` follows the port's
rule (``plan.wrapper._resolve_engine`` on the first shard's device: the
butterfly engine on a card, its local plans cut at leaves of up to 512
points, the matrix engine on the CPU), and the config's pallas knobs
(``max_r``, ``block_b``, ``stages_per_call``, ``lane_rows``,
``tw_layout``) reach the local plans, which the JAX package builds with
its defaults (residues agree mod N either way).  As in the JAX package,
``tune`` is not read.  ``forward_step`` / ``inverse_step`` return the
schedule and its tables, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..field.limb import FieldConsts, from_numpy
from ..ops import inter_step
from ..ops.transpose import transpose01_u64
from ..ops.twiddle import MontPair, montpair_map, sixstep_row_twiddles_device
from ..plan import planner
from ..plan.config import NttConfig
from ..plan.planner import PlanTables, row_twiddles
from ..plan.wrapper import _auto_max_fused, _resolve_engine, _resolve_modmul
from .mesh import AXIS, Mesh
from .ring import copy_all_to_all, ring_all_to_all


@dataclass
class DirectionTables:
    """One direction's tables: ``tw[i]``, shard i's (n0, n1/D) columns of
    the inter-step twiddle matrix on its device ``devices[i]``; ``col`` /
    ``row``, the local plans' tables per distinct mesh device."""

    tw: list[MontPair]
    col: dict[torch.device, PlanTables]
    row: dict[torch.device, PlanTables]
    devices: tuple[torch.device, ...]

    def group(self, r: int, D: int) -> "DirectionTables":
        """The tables of replica group r's D shards."""
        if len(self.tw) == D:
            return self
        sl = slice(r * D, (r + 1) * D)
        return DirectionTables(self.tw[sl], self.col, self.row, self.devices[sl])


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
    combined axis, row-major.  An ``axis`` that leaves mesh axes out gives
    R replica groups (see the module docstring): D is the size of the
    collective axis, and the lists hold R x D shards.  ``comm="ring"``
    needs a 1-D mesh whose axis is the collective axis; ``overlap_chunks``
    is reduced until it divides n1/D.  ``config.tune`` is not read, as in
    the JAX package: the local plans take the config's knobs as given.
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
        if config.rns:
            raise ValueError("DistributedNTT is not supported on an RNS config (tuples of "
                             "moduli): it runs one modulus")
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
        self.config = config
        self.mesh = mesh
        self.axes = axes
        self.comm = comm
        self.D = D
        self.n0, self.n1 = n0, n1
        #: each replica group's devices along the collective axis
        self.replicas = mesh.replica_groups(axes)
        #: shard i's device: group i // D's device i % D
        self.devices = tuple(dev for group in self.replicas for dev in group)
        self.mod = config.mod  # API parity with NTT: apps duck-type over both
        self.fc = FieldConsts.from_modulus(
            self.mod, lazy=config.lazy, modmul=_resolve_modmul(config)
        )
        #: the inter-step multiply's engine: Montgomery, as the JAX package
        #: multiplies its Montgomery tables by ``mont_mul`` / ``mont_mul_full``
        self.tw_fc = FieldConsts.from_modulus(self.mod, lazy=self.fc.lazy)
        engine = _resolve_engine(config, self.devices[0])
        cap = _auto_max_fused(config, engine)
        self._col_plan = planner.build_plan(n0, engine, cap)
        self._row_plan = planner.build_plan(n1, engine, cap)
        self._side: dict[int, torch.cuda.Stream] = {}
        # tables per enabled direction only: at 2^30 each direction's are GBs
        self._forward = self._tables(inverse=False) if enable_forward else None
        self._inverse = self._tables(inverse=True) if enable_inverse else None

    def _tables(self, inverse: bool) -> DirectionTables:
        cfg = self.config
        knobs = dict(
            block_b=cfg.block_b, spc=cfg.stages_per_call, rows=cfg.lane_rows,
            max_r=cfg.max_r, tw_layout=cfg.tw_layout,
        )
        col, row = {}, {}
        for dev in dict.fromkeys(self.devices):
            col[dev] = PlanTables(self._col_plan, self.mod, self.fc, inverse, device=dev, **knobs)
            row[dev] = PlanTables(self._row_plan, self.mod, self.fc, inverse, device=dev, **knobs)
        return DirectionTables(self._shard_twiddles(inverse), col, row, self.devices)

    def _shard_twiddles(self, inverse: bool) -> list[MontPair]:
        """Each shard's (n0, n1/D) block of the inter-step matrix on its
        device, one block per (column block, device) pair that the shards
        name.  Above DEVICE_TWIDDLE_THRESHOLD each block is generated on
        its device alone, so no device ever holds the whole matrix (at
        2^28 the whole matrix and its blocks would be 4 GiB at once)."""
        n0, n1, D = self.n0, self.n1, self.D
        w_only = self.config.split_w_only
        cut = None
        if n0 * n1 <= planner.DEVICE_TWIDDLE_THRESHOLD:
            full = row_twiddles(self.mod, n0, n1, inverse=inverse, w_only=w_only, device="cpu")
            cut = shard_columns(full, ["cpu"] * D)
        elif w_only is None:
            w_only = n0 * n1 >= planner.W_ONLY_THRESHOLD
        w = n1 // D
        blocks: dict[tuple[int, torch.device], MontPair] = {}
        for i, dev in enumerate(self.devices):
            d = i % D
            if (d, dev) in blocks:
                continue
            if cut is not None:
                blocks[(d, dev)] = montpair_map(lambda a, dev=dev: a.to(dev), cut[d])
            else:
                blocks[(d, dev)] = sixstep_row_twiddles_device(
                    self.mod, n0, n1, inverse=inverse, with_companion=not w_only,
                    columns=(d * w, w), device=dev,
                )
        return [blocks[(i % D, dev)] for i, dev in enumerate(self.devices)]

    # -- public API ---------------------------------------------------------

    def get_m(self) -> int:
        return self.config.n

    def shard(self, x) -> list[torch.Tensor]:
        """A flat (n,) vector (int64 tensor or numpy uint64) as the D
        row-sharded blocks on their devices, once per replica group (new
        memory)."""
        if isinstance(x, np.ndarray):
            x = from_numpy(x, "cpu")
        if x.shape != (self.config.n,):
            raise ValueError(f"expected shape ({self.config.n},), got {tuple(x.shape)}")
        D, k = self.D, self.config.n // self.D
        return [x[i % D * k:(i % D + 1) * k].to(dev, copy=True)
                for i, dev in enumerate(self.devices)]

    def gather(self, shards) -> torch.Tensor:
        """The flat vector of ``shards`` (the first replica group's), on the
        host."""
        return torch.cat([s.cpu() for s in shards[:self.D]])

    def normalize(self, shards) -> list[torch.Tensor]:
        return [self.fc.normalize(s) for s in shards]

    def forward_step(self):
        """(step, tables): ``step(shards, *tables)`` is
        ``compute_forward(shards)`` without the input checks, as in the JAX
        package's API."""
        if self._forward is None:
            raise RuntimeError("forward transform was not enabled")
        return self._forward_local, (self._forward,)

    def inverse_step(self):
        """Mirror of ``forward_step`` for the inverse transform."""
        if self._inverse is None:
            raise RuntimeError("inverse transform was not enabled")
        return self._inverse_local, (self._inverse,)

    def compute_forward(self, x, on_step=None) -> list[torch.Tensor]:
        """The forward transform of the shards ``x``; ``on_step(name)``, if
        given, is called after each step of the schedule ("comm1",
        "columns", "comm2", "rows"; "columns+comm2" under overlap)."""
        if self._forward is None:
            raise RuntimeError("forward transform was not enabled")
        return self._forward_local(self._check(x), self._forward, on_step)

    def compute_inverse(self, x, on_step=None) -> list[torch.Tensor]:
        """The inverse transform; ``on_step`` as in ``compute_forward``
        ("rows", "comm2", "columns", "comm1"; "comm2+columns" under
        overlap)."""
        if self._inverse is None:
            raise RuntimeError("inverse transform was not enabled")
        return self._inverse_local(self._check(x), self._inverse, on_step)

    def _check(self, shards) -> list[torch.Tensor]:
        if len(shards) != len(self.devices):
            raise ValueError(f"expected {len(self.devices)} shards, got {len(shards)}")
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

    @staticmethod
    def _map(f, mats: list, devices) -> list[torch.Tensor]:
        """``f(d, mats[d])`` for every shard of a group, with its device
        ``devices[d]`` current, dropping ``mats[d]`` once shard d's output
        exists: a step holds one shard's input and output beside the lists,
        not two whole lists.  ``mats`` must be the caller's own list (a copy
        keeps the entries)."""
        out = []
        for d in range(len(mats)):
            with _guard(devices[d]):
                out.append(f(d, mats[d]))
            mats[d] = None
        return out

    def _all_to_all(self, mats, split_axis: int, concat_axis: int) -> list[torch.Tensor]:
        if self.comm == "ring":
            return ring_all_to_all(mats, split_axis, concat_axis, self.axes)
        return copy_all_to_all(mats, split_axis, concat_axis)

    def _tw_mul(self, mat: torch.Tensor, tw: MontPair) -> torch.Tensor:
        return inter_step.mont_mul_bcast(self.tw_fc, mat, tw)

    def _rows(self, mat: torch.Tensor, tables: PlanTables, inverse: bool) -> torch.Tensor:
        """Row NTTs of an (n0/D, n1) shard: a jnp row leaf along axis 1 with
        no local transposes (``planner._jnp_mid_chunked``, its twiddles
        already applied under the column sharding), as the JAX package
        runs it; every other row plan between two local transposes."""
        row = self._row_plan
        if isinstance(row, planner.Leaf) and row.engine == "jnp":
            return planner._jnp_mid_chunked(
                mat, tables.leaf[(self.n1, "jnp")], self.fc, None, inverse
            )
        run = planner.run_inverse if inverse else planner.run_forward
        mat = transpose01_u64(mat, self.config.transpose)  # (n1, n0/D)
        mat = run(mat, self._row_plan, tables)
        return transpose01_u64(mat, self.config.transpose)  # (n0/D, n1)

    def _col_fwd(self, t: DirectionTables, d: int, mat: torch.Tensor, sl=slice(None)):
        """Column NTTs and twiddles of shard d's columns ``sl``."""
        tw = montpair_map(lambda a: a[:, sl], t.tw[d])
        mat = planner.run_forward(mat[:, sl].contiguous(), self._col_plan, t.col[t.devices[d]])
        return self._tw_mul(mat, tw)

    def _col_inv(self, t: DirectionTables, d: int, mat: torch.Tensor, sl=slice(None)):
        mat = self._tw_mul(mat, montpair_map(lambda a: a[:, sl], t.tw[d]))
        return planner.run_inverse(mat, self._col_plan, t.col[t.devices[d]])

    # -- comm/compute overlap (comm="overlap") ------------------------------
    #
    # The local column axis of the (n0, n1/D) block is independent for the
    # column NTT and the twiddle multiply, so both pipelines chunk it K
    # ways: the [comm 2] exchange of chunk c does not depend on chunk c+1's
    # compute.  On CUDA shards the exchanges run on a side stream of each
    # card, joined to the compute streams by events; on CPU shards in turn.
    # Chunk c's compute runs while chunk c-1's exchange does; that
    # exchange is joined, and its inputs freed, before chunk c's is
    # launched.  The block goes once the last chunk has read it, and each
    # chunk output as soon as the next list holds its data.

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
        parts, in_flight, events = [], [], {}
        for c in range(K):
            sl = slice(c * wK, (c + 1) * wK)
            # the last chunk drops each shard's block once it is read
            subs = self._map(lambda d, m: self._col_fwd(t, d, m, sl),
                             mats if c == K - 1 else list(mats), t.devices)
            self._join(events)  # chunk c-1's exchange has read its inputs
            in_flight.clear()
            out, events = self._side_all_to_all(subs, 0, 1)
            parts.append(out)
            in_flight.append(subs)  # kept until that exchange is joined
        self._join(events)
        in_flight.clear()
        del subs

        def reasm(d, _):
            # chunk c: (h, D*wK), columns grouped by source shard o; the
            # full layout wants column o*w2 + c*wK + i  ->  (h, D, K, wK)
            s = torch.stack([p[d] for p in parts]).reshape(K, h, D, wK)
            for p in parts:
                p[d] = None
            return s.permute(1, 2, 0, 3).reshape(h, self.n1)

        return self._map(reasm, [None] * D, t.devices)

    def _overlap_inv_comm2_col(self, mats, t: DirectionTables) -> list[torch.Tensor]:
        D, K = self.D, self.overlap_chunks
        h, w2 = self.n0 // D, self.n1 // D
        wK = w2 // K
        parts, in_flight, events, prev = [], [], {}, None

        def columns(c, subs):
            sl = slice(c * wK, (c + 1) * wK)
            parts.append(self._map(lambda d, m: self._col_inv(t, d, m, sl), subs, t.devices))

        for c in range(K):
            picks = self._map(
                lambda d, m: m.reshape(h, D, K, wK)[:, :, c, :].reshape(h, D * wK),
                mats if c == K - 1 else list(mats), t.devices,
            )
            self._join(events)  # chunk c-1's exchange has read its inputs
            in_flight.clear()
            subs, events = self._side_all_to_all(picks, 1, 0)
            in_flight.append(picks)  # kept until that exchange is joined
            del picks
            if prev is not None:
                columns(c - 1, prev)  # while chunk c's exchange runs
            prev = subs
        self._join(events)
        in_flight.clear()
        columns(K - 1, prev)

        def cat(d, _):
            out = torch.cat([p[d] for p in parts], dim=1)
            for p in parts:
                p[d] = None
            return out

        return self._map(cat, [None] * D, t.devices)

    # -- local (per-shard) schedules ---------------------------------------
    #
    # ``on_step(name)``, if given, is called after each step (a caller reads
    # the memory a step holds; with replica groups, once per group); each
    # step drops what it has consumed.

    def _forward_local(self, shards, t: DirectionTables, on_step=None) -> list[torch.Tensor]:
        return self._per_group(self._forward_group, shards, t, on_step)

    def _inverse_local(self, shards, t: DirectionTables, on_step=None) -> list[torch.Tensor]:
        return self._per_group(self._inverse_group, shards, t, on_step)

    def _per_group(self, schedule, shards, t: DirectionTables, on_step) -> list[torch.Tensor]:
        """``schedule`` run on each replica group's D shards in turn; the
        groups' outputs concatenated in the shards' order."""
        D = self.D
        out = []
        for r in range(len(self.replicas)):
            group = list(shards[r * D:(r + 1) * D])
            out += schedule(group, t.group(r, D), on_step)
        return out

    def _forward_group(self, shards, t: DirectionTables, on_step=None) -> list[torch.Tensor]:
        n0, n1, D = self.n0, self.n1, self.D
        note = on_step or (lambda name: None)
        mats = [x.reshape(n0 // D, n1) for x in shards]
        # [comm 1] row shards -> column shards: (n0/D, n1) -> (n0, n1/D)
        mats = self._all_to_all(mats, 1, 0)
        note("comm1")
        if self.comm == "overlap":
            # column NTTs + twiddle + [comm 2], chunked for overlap
            mats = self._overlap_fwd_col_comm2(mats, t)
            note("columns+comm2")
        else:
            # column NTTs over the full local leading axis n0, twiddles
            mats = self._map(lambda d, m: self._col_fwd(t, d, m), mats, t.devices)
            note("columns")
            # [comm 2] column shards of (n0, n1) -> row shards (n0/D, n1)
            mats = self._all_to_all(mats, 0, 1)
            note("comm2")
        mats = self._map(lambda d, m: self._rows(m, t.row[t.devices[d]], False), mats,
                         t.devices)
        note("rows")
        return [m.reshape(n0 // D * n1) for m in mats]

    def _inverse_group(self, shards, t: DirectionTables, on_step=None) -> list[torch.Tensor]:
        n0, n1, D = self.n0, self.n1, self.D
        note = on_step or (lambda name: None)
        mats = [x.reshape(n0 // D, n1) for x in shards]
        mats = self._map(lambda d, m: self._rows(m, t.row[t.devices[d]], True), mats, t.devices)
        note("rows")
        if self.comm == "overlap":
            # undo [comm 2] + twiddles + column NTTs, chunked for overlap
            mats = self._overlap_inv_comm2_col(mats, t)
            note("comm2+columns")
        else:
            mats = self._all_to_all(mats, 1, 0)  # undo [comm 2]
            note("comm2")
            mats = self._map(lambda d, m: self._col_inv(t, d, m), mats, t.devices)
            note("columns")
        # undo [comm 1]: column shards -> row shards
        mats = self._all_to_all(mats, 0, 1)
        note("comm1")
        return [m.reshape(n0 // D * n1) for m in mats]
