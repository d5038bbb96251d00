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

Divergence from the JAX package: ``engine="auto"`` resolves to the matrix
engine ("mxu") on EVERY device.  The JAX package picks its portable jnp
engine off the TPU; here ``engine="jnp"`` asks for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.limb import FieldConsts, from_numpy, to_numpy
from ..utils.device import resolve_device
from . import planner
from .config import NttConfig


def _resolve_modmul(config: NttConfig) -> str:
    """'auto' -> Shoup at n >= 2^22 for lazy-capable moduli, Montgomery
    otherwise (the JAX package's rule, verbatim).  The matrix engine has
    no stage twiddles, so its output does not depend on the choice."""
    if config.modmul != "auto":
        return config.modmul
    lazy = config.lazy if config.lazy is not None else config.mod.bit_width <= 62
    if lazy and config.n >= (1 << 22):
        return "shoup"
    return "montgomery"


def _resolve_engine(engine: str) -> str:
    """'auto' -> 'mxu' on every device (see the module docstring)."""
    return "mxu" if engine == "auto" else engine


def build_config_plan(config: NttConfig, engine: str):
    """The plan tree of ``config`` with its engine resolved to ``engine``."""
    if config.plan_spec is not None:
        return planner.build_plan_spec(config.n, config.plan_spec)
    if config.strategy == "auto":
        return planner.build_plan(config.n, engine, config.max_fused)
    if config.resolved_strategy == "iterative":
        return planner.Leaf(config.n, engine)
    n0, n1 = config.split
    return planner.Split(
        config.n, n0, n1,
        planner.build_plan(n0, engine, config.max_fused),
        planner.build_plan(n1, engine, config.max_fused),
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
        self.mod = config.mod
        self.fc = FieldConsts.from_modulus(
            self.mod, lazy=config.lazy, modmul=_resolve_modmul(config)
        )
        self.engine = _resolve_engine(config.engine)
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
            self._fwd_tables = planner.PlanTables(
                self.plan, self.mod, self.fc, inverse=False, **tables
            )
        if enable_inverse:
            self._inv_tables = planner.PlanTables(
                self.plan, self.mod, self.fc, inverse=True, **tables
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
        plan = self.plan
        return (lambda v, t: planner.run_forward(v, plan, t)), (self._fwd_tables,)

    def inverse_step(self):
        """Mirror of ``forward_step`` for the inverse transform."""
        if self._inv_tables is None:
            raise RuntimeError("inverse transform was not enabled")
        plan = self.plan
        return (lambda v, t: planner.run_inverse(v, plan, t)), (self._inv_tables,)

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
        x = self._check(x, donate)
        return planner.run_forward(x, self.plan, self._fwd_tables, x if donate else None)

    def _inverse(self, x: torch.Tensor, donate: bool) -> torch.Tensor:
        if self._inv_tables is None:
            raise RuntimeError("inverse transform was not enabled")
        x = self._check(x, donate)
        return planner.run_inverse(x, self.plan, self._inv_tables, x if donate else None)

    def _check(self, x: torch.Tensor, donate: bool = False) -> torch.Tensor:
        if x.dtype != torch.int64:
            raise TypeError(f"expected an int64 tensor of u64 bit patterns, got {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"data on {x.device}, NTT on {self.device}")
        if x.shape[0] != self.config.n:
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
