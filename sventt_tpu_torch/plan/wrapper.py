"""The public NTT wrapper: owns the tables of one config on one device.

The counterpart of ``sventt_tpu/plan/wrapper.py::NTT``, with the same
numerical contract:

* ``compute_forward`` output is in bit-reversed order, residues mod N equal
  to GoldenNTT.forward;
* ``compute_inverse`` consumes bit-reversed order, returns natural order;
* values may be lazy representatives in [0, 2N) -- ``normalize`` makes
  them canonical;
* inputs must already be reduced ([0, N), or [0, 2N) in lazy mode).

Data is an int64 tensor of u64 bit patterns, shape ``(n,)`` or
``(n, batch...)``, on the NTT's device.  ``device=None`` is the current
CUDA card (``RuntimeError`` where there is none); ``device="cpu"`` runs
every kernel's plain PyTorch version.

``forward_step`` / ``inverse_step`` return the planner's program and its
tables, as the JAX package's do for its chained timing: here the step is
what a ``torch.cuda.CUDAGraph`` captures (it synchronizes nothing and
builds no table; ``utils.timing.time_chained`` times it so).

``tune=True`` resolves the config's knobs through the autotuner
(``plan/autotune.py``) on the NTT's device before anything else, as in the
JAX package.  ``donate_input=True`` lets ``compute_forward`` /
``compute_inverse`` release the caller's tensor: its storage is freed once
the first kernel has read it (the tensor is unusable afterwards, as a
donated JAX array is deleted), so a transform holds two n-word buffers at
its peak, not three.  No kernel works in place; the result is bitwise the
non-donated one.

``engine="auto"`` is the port's own rule (``_resolve_engine``), read from
the configuration and the device alone: on a CUDA card a single-modulus
configuration runs the butterfly engine ("pallas": radix-2, K4 leaf / K5
mid / K6 lane on the register kernel), its automatic plan cut at leaves of
up to ``AUTO_MAX_FUSED`` = 512 points, so it has the matrix plan's levels
and launches (2^17 = 256 x 512, 2^24 = (256 x 256) x 256); a
multi-modular configuration runs the matrix engine ("mxu"), its only
engine; on the CPU "auto" is "mxu".  On an H100 the autotuner's race picks
the butterfly family at 2^17 and 2^24, 3.3-4.0x the matrix engine as
CUDA-graph replays (``autotune_cache.json``: 0.728 against 2.905 ms at
2^24), and the benchmark's 2^24 cells spend nearly all their device time
in K1-K3, which run at 22-28% of their int8 bound and take about 2.9 ms a
transform against about 0.75 ms forward on K4-K6.  The JAX package picks
its portable jnp engine off the TPU; here ``engine="jnp"`` asks for it.

A multi-modular configuration (``NttConfig`` with tuples of L moduli and
generators, one a limb) takes ``(L, n, batch...)`` data, limb l at row l
canonical (or below 2 q_l when lazy) mod its q_l, and returns the same
layout: each limb's forward in bit-reversed order, its inverse in natural
order scaled by 1/n mod q_l -- the contract above, limb by limb.  Every
limb's tables are stacked and each plan level is one kernel launch for all
limbs.  ``fc`` is then the limbs' ``LimbConsts`` and ``mod`` None; every
limb must resolve to one ``lazy`` and one ``modmul``.  A 1-tuple
configuration is the single-modulus transform on (1, n, ...) data: the
same tables, launches and results.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.limb import FieldConsts, LimbConsts, from_numpy, to_numpy
from ..field.modulus import Modulus
from ..utils.device import resolve_device
from ..utils.profiling import span
from . import planner
from .config import NttConfig


def _resolve_modmul(config: NttConfig, mod: Modulus | None = None) -> str:
    """'auto' -> Shoup at n >= 2^22 for lazy-capable moduli, Montgomery
    otherwise (the JAX package's rule, verbatim), for the modulus ``mod``
    (None: the configuration's one).  The matrix engine has no stage
    twiddles, so its output does not depend on the choice."""
    if config.modmul != "auto":
        return config.modmul
    mod = mod or config.mod
    lazy = config.lazy if config.lazy is not None else mod.bit_width <= 62
    if lazy and config.n >= (1 << 22):
        return "shoup"
    return "montgomery"


#: Largest leaf of the butterfly plan that ``engine="auto"`` builds on a
#: card (``max_fused`` unset): the matrix engine's 512, so the plan has the
#: matrix plan's levels, where ``ntt_pallas.MAX_FUSED`` = 256 would give
#: 2^17 a third launch; the race picks 512 at 2^17 too.
AUTO_MAX_FUSED = 512


def _resolve_engine(config: NttConfig, device) -> str:
    """``config.engine`` with "auto" resolved for ``device`` (a
    ``torch.device`` or its type string): on a CUDA device "pallas" for a
    single-modulus configuration and "mxu" for a multi-modular one (the
    only engine with a limb axis); "mxu" on the CPU, where only the plain
    versions run.  See the module docstring for why."""
    if config.engine != "auto":
        return config.engine
    if torch.device(device).type == "cuda" and not config.rns:
        return "pallas"
    return "mxu"


def _auto_max_fused(config: NttConfig, engine: str) -> int | None:
    """The leaf cap that "auto" sets: ``AUTO_MAX_FUSED`` where it resolved
    to the butterfly engine, else None (the engine's own default)."""
    return AUTO_MAX_FUSED if config.engine == "auto" and engine == "pallas" else None


def build_config_plan(config: NttConfig, engine: str):
    """The plan tree of ``config`` with its engine resolved to ``engine``."""
    if config.plan_spec is not None:
        return planner.build_plan_spec(config.n, config.plan_spec)
    max_fused = config.max_fused or _auto_max_fused(config, engine)
    if config.strategy == "auto":
        return planner.build_plan(config.n, engine, max_fused)
    if config.resolved_strategy == "iterative":
        return planner.Leaf(config.n, engine)
    n0, n1 = config.split
    return planner.Split(
        config.n, n0, n1,
        planner.build_plan(n0, engine, max_fused),
        planner.build_plan(n1, engine, max_fused),
    )


class NTT:
    """Forward/inverse NTT for one NttConfig on one device."""

    def __init__(
        self,
        config: NttConfig,
        enable_forward: bool = True,
        enable_inverse: bool = True,
        donate_input: bool = False,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        if config.tune:
            from .autotune import tune

            config = tune(config, device=self.device)
        self.config = config
        self.donate_input = donate_input
        #: Limbs of a multi-modular configuration (None: one modulus).
        self.limbs = len(config.limb_mods) if config.rns else None
        if self.limbs is None:
            self.mod = config.mod
            self.fc = FieldConsts.from_modulus(
                self.mod, lazy=config.lazy, modmul=_resolve_modmul(config)
            )
        else:
            fcs = LimbConsts.from_moduli(
                config.limb_mods, lazy=config.lazy, modmul=lambda m: _resolve_modmul(config, m)
            )
            if self.limbs == 1:  # the single-modulus transform on (1, n, ...) data
                self.mod, self.fc = config.limb_mods[0], fcs[0]
            else:
                self.mod, self.fc = None, fcs
        self._squeeze = self.limbs == 1
        # the tables of every limb at once, or of the one modulus
        mods = config.limb_mods if self.mod is None else self.mod
        self.engine = _resolve_engine(config, self.device)
        self.plan = build_config_plan(config, self.engine)
        # NttConfig.transpose allows only "auto" and "xla", the torch copy
        # the planner's fallback runs either way: no table takes it
        tables = dict(
            device=self.device, split_w_only=config.split_w_only,
            block_b=config.block_b, spc=config.stages_per_call, rows=config.lane_rows,
            max_r=config.max_r, tw_layout=config.tw_layout, chunk_elems=config.chunk_elems,
        )
        self._fwd_tables = self._inv_tables = None
        if enable_forward:
            with span("sventt.tables.forward"):
                self._fwd_tables = planner.PlanTables(
                    self.plan, mods, self.fc, inverse=False, **tables
                )
        if enable_inverse:
            with span("sventt.tables.inverse"):
                self._inv_tables = planner.PlanTables(
                    self.plan, mods, self.fc, inverse=True, **tables
                )

    # -- public API -----------------------------------------------------------

    def get_m(self) -> int:
        """Transform length."""
        return self.config.n

    def describe(self, batched: bool = False) -> str:
        """Human-readable execution strategy per plan node: which path each
        Split's row step takes.  ``batched`` describes the schedule for
        inputs with trailing batch dims.

        The leaf, pallas and jnp lines are the JAX package's wording, its
        quirk included: a batched pallas row with grouped tables (``max_r`` > 1)
        reads "mid-axis pallas ... (no transposes)" although it runs the
        transpose fallback, as in the JAX package.  The mxu lines are the
        port's own, on purpose: the JAX ``describe`` has no mxu branch and
        prints "transposed row leaf m1=X" for every mxu row leaf, where
        the port prints what runs -- "lane-axis mxu m1=X (fused twiddle, no
        transposes)" for the unbatched root (the JAX package runs that one
        between two transposes), "mid-axis mxu m1=X (fused twiddle, no
        transposes)" for a batched row.  Mapping either of those back to
        "transposed row leaf m1=X" gives the JAX text line for line."""
        lines = []

        def walk(node, depth, batch):
            pad = "  " * depth
            if isinstance(node, planner.Leaf):
                lines.append(f"{pad}leaf m={node.m} engine={node.engine}")
                return
            if planner._lane_row(node):
                if batch:
                    row = f"mid-axis pallas m1={node.m1} (no transposes)"
                else:
                    row = f"lane-axis pallas m1={node.m1} (fused twiddle, no transposes)"
            elif planner._mxu_row(node):
                if batch:
                    row = f"mid-axis mxu m1={node.m1} (fused twiddle, no transposes)"
                else:
                    row = f"lane-axis mxu m1={node.m1} (fused twiddle, no transposes)"
            elif planner._jnp_row(node):
                row = (f"mid-axis jnp m1={node.m1} "
                       "(chunked VMEM-resident, fused twiddle, no transposes)")
            else:
                row = f"transposed row subtree m1={node.m1}"
            lines.append(f"{pad}split {node.m} = {node.m0} x {node.m1}: {row}")
            if not isinstance(node.row, planner.Leaf):
                walk(node.row, depth + 1, True)
            walk(node.col, depth + 1, True)

        walk(self.plan, 0, batched)
        return "\n".join(lines)

    def forward_step(self):
        """(step, tables): ``step(x, *tables)`` is ``compute_forward(x)``
        without the input checks -- the same planner program on prepared
        tables, which does no host synchronization and builds nothing, so
        a ``torch.cuda.CUDAGraph`` can capture it."""
        if self._fwd_tables is None:
            raise RuntimeError("forward transform was not enabled")
        return (lambda v, t: self._run(planner.run_forward, v, t)), (self._fwd_tables,)

    def inverse_step(self):
        """Mirror of ``forward_step`` for the inverse transform."""
        if self._inv_tables is None:
            raise RuntimeError("inverse transform was not enabled")
        return (lambda v, t: self._run(planner.run_inverse, v, t)), (self._inv_tables,)

    def compute_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The forward transform of ``x``; with ``donate_input`` the call
        releases ``x`` (see the module docstring)."""
        return self._forward(x, self.donate_input)

    def compute_inverse(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse transform of ``x``; ``donate_input`` as for the
        forward."""
        return self._inverse(x, self.donate_input)

    def _forward(self, x: torch.Tensor, donate: bool) -> torch.Tensor:
        if self._fwd_tables is None:
            raise RuntimeError("forward transform was not enabled")
        with span("sventt.forward"):
            x = self._check(x, donate)
            return self._run(planner.run_forward, x, self._fwd_tables, x if donate else None)

    def _inverse(self, x: torch.Tensor, donate: bool) -> torch.Tensor:
        if self._inv_tables is None:
            raise RuntimeError("inverse transform was not enabled")
        with span("sventt.inverse"):
            x = self._check(x, donate)
            return self._run(planner.run_inverse, x, self._inv_tables, x if donate else None)

    def _run(self, run, x: torch.Tensor, tables, donated=None) -> torch.Tensor:
        """``run`` (the planner's ``run_forward`` or ``run_inverse``) on
        ``x``; a 1-tuple configuration's (1, n, ...) data as the
        single-modulus (n, ...)."""
        if self._squeeze:
            return run(x[0], self.plan, tables, donated).unsqueeze(0)
        return run(x, self.plan, tables, donated)

    def _check(self, x: torch.Tensor, donate: bool = False) -> torch.Tensor:
        if x.dtype != torch.int64:
            raise TypeError(f"expected an int64 tensor of u64 bit patterns, got {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"data on {x.device}, NTT on {self.device}")
        if self.limbs is not None:
            if x.dim() < 2 or tuple(x.shape[:2]) != (self.limbs, self.config.n):
                raise ValueError(f"an NTT of {self.limbs} limbs takes (L, n, ...) = "
                                 f"({self.limbs}, {self.config.n}, ...) data, got {tuple(x.shape)}")
        elif x.shape[0] != self.config.n:
            raise ValueError(f"leading axis {x.shape[0]} != n = {self.config.n}")
        if donate:
            storage = x.untyped_storage()
            if (x.storage_offset() or not x.is_contiguous()
                    or storage.nbytes() != x.numel() * x.element_size()
                    or not storage.resizable()):
                raise ValueError(
                    "donate_input needs a contiguous tensor that owns its whole, "
                    "resizable storage (not a view, not memory shared with numpy)"
                )
        return x

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc.normalize(x)

    # numpy convenience (host <-> device); the tensor is the call's own, so
    # there is nothing of the caller's to donate
    def forward_numpy(self, x: np.ndarray) -> np.ndarray:
        out = self._forward(from_numpy(x, self.device), False)
        return to_numpy(self.fc.normalize(out))

    def inverse_numpy(self, x: np.ndarray) -> np.ndarray:
        out = self._inverse(from_numpy(x, self.device), False)
        return to_numpy(self.fc.normalize(out))
