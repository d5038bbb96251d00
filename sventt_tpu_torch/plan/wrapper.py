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

Divergence from the JAX package: ``engine="auto"`` resolves to the matrix
engine ("mxu") on EVERY device.  The JAX package picks its portable jnp
engine off the TPU, which is not ported yet.
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
    if engine == "auto":
        return "mxu"
    if engine not in planner.PORTED_ENGINES:
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet (ROADMAP Queue 1 item 7)"
        )
    return engine


class NTT:
    """Forward/inverse NTT for one NttConfig on one device."""

    def __init__(
        self,
        config: NttConfig,
        enable_forward: bool = True,
        enable_inverse: bool = True,
        *,
        device=None,
    ):
        if config.tune:
            raise NotImplementedError(
                "tune=True is not ported yet (ROADMAP Queue 1 item 10)"
            )
        self.config = config
        self.device = resolve_device(device)
        self.mod = config.mod
        self.fc = FieldConsts.from_modulus(
            self.mod, lazy=config.lazy, modmul=_resolve_modmul(config)
        )
        self.engine = _resolve_engine(config.engine)
        self.plan = self._build_plan()
        tables = dict(
            device=self.device, split_w_only=config.split_w_only,
            block_b=config.block_b, spc=config.stages_per_call, rows=config.lane_rows,
            max_r=config.max_r, tw_layout=config.tw_layout,
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

    def _build_plan(self):
        cfg = self.config
        if cfg.plan_spec is not None:
            return planner.build_plan_spec(cfg.n, cfg.plan_spec)
        if cfg.strategy == "auto":
            return planner.build_plan(cfg.n, self.engine, cfg.max_fused)
        if cfg.resolved_strategy == "iterative":
            return planner.Leaf(cfg.n, self.engine)
        n0, n1 = cfg.split
        return planner.Split(
            cfg.n, n0, n1,
            planner.build_plan(n0, self.engine, cfg.max_fused),
            planner.build_plan(n1, self.engine, cfg.max_fused),
        )

    # -- public API -----------------------------------------------------------

    def get_m(self) -> int:
        """Transform length."""
        return self.config.n

    def describe(self, batched: bool = False) -> str:
        """Human-readable execution strategy per plan node: which path each
        Split's row step takes.  ``batched`` describes the schedule for
        inputs with trailing batch dims.

        The leaf and pallas lines are the JAX package's wording, its quirk
        included: a batched pallas row with grouped tables (``max_r`` > 1)
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
            else:
                row = f"transposed row subtree m1={node.m1}"
            lines.append(f"{pad}split {node.m} = {node.m0} x {node.m1}: {row}")
            if not isinstance(node.row, planner.Leaf):
                walk(node.row, depth + 1, True)
            walk(node.col, depth + 1, True)

        walk(self.plan, 0, batched)
        return "\n".join(lines)

    def compute_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fwd_tables is None:
            raise RuntimeError("forward transform was not enabled")
        return planner.run_forward(self._check(x), self.plan, self._fwd_tables)

    def compute_inverse(self, x: torch.Tensor) -> torch.Tensor:
        if self._inv_tables is None:
            raise RuntimeError("inverse transform was not enabled")
        return planner.run_inverse(self._check(x), self.plan, self._inv_tables)

    def _check(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.int64:
            raise TypeError(f"expected an int64 tensor of u64 bit patterns, got {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"data on {x.device}, NTT on {self.device}")
        if x.shape[0] != self.config.n:
            raise ValueError(f"leading axis {x.shape[0]} != n = {self.config.n}")
        return x

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc.normalize(x)

    # numpy convenience (host <-> device)
    def forward_numpy(self, x: np.ndarray) -> np.ndarray:
        out = self.compute_forward(from_numpy(x, self.device))
        return to_numpy(self.fc.normalize(out))

    def inverse_numpy(self, x: np.ndarray) -> np.ndarray:
        out = self.compute_inverse(from_numpy(x, self.device))
        return to_numpy(self.fc.normalize(out))
