"""The portable NTT engine: radix-2 butterfly stages as plain torch ops.

The counterpart of ``sventt_tpu/ops/ntt_jnp.py`` (the JAX package's
pure-jnp engine, which reaches no Pallas kernel).  Values are int64
tensors of u64 bit patterns; the arithmetic is ``field.limb.FieldConsts``
and the stage tables are ``ops.twiddle.ForwardTables`` /
``InverseTables`` in the engine's form (Montgomery, Shoup or Solinas,
whose tables carry no companion: ``wp`` is None).

Layout rule: the transform runs along the LEADING axis (``ntt_forward``,
``ntt_inverse``) or along axis 1 of (A, m, batch...) (the ``_mid``
variants, the six-step row step without transposes); every other axis is
batch.  The butterfly schedule is the golden model's, so the transforms
compose bit for bit at every split, and each equals the JAX engine's
output bit for bit.  It runs on any device; on the card every stage is a
chain of elementwise kernels, a portable engine, not a fast one.
"""

from __future__ import annotations

import torch

from ..field.limb import FieldConsts
from .twiddle import ForwardTables, InverseTables, MontPair


def _bcast(pair: MontPair, shape) -> MontPair:
    """A stage's twiddle pair reshaped to broadcast as ``shape``; ``wp``
    may be None (Solinas tables)."""
    return MontPair(pair.w.reshape(shape), None if pair.wp is None else pair.wp.reshape(shape))


def _stage_views(x: torch.Tensor, axis: int, m: int, l: int):
    """The butterfly operand pairs of one stage along ``axis`` (0 or 1):
    x0 = x[b*2l + j], x1 = x[b*2l + l + j] for blocks b and twiddle index
    j < l, a (m/(2l), 2, l) split of the transform axis."""
    shape = x.shape[:axis] + (m // (2 * l), 2, l) + x.shape[axis + 1:]
    xr = x.reshape(shape)
    return xr.select(axis + 1, 0), xr.select(axis + 1, 1)


def _stage_join(y0: torch.Tensor, y1: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    """Inverse of ``_stage_views``: the pairs stacked back into the axis."""
    y = torch.stack([y0, y1], dim=axis + 1)
    return y.reshape(y.shape[:axis] + (m,) + y.shape[axis + 3:])


def _tw_shape(axis: int, l: int, ndim_batch: int) -> tuple:
    """Broadcast shape of a length-l stage twiddle against the stage views:
    (1, l, 1...) along axis 0, (1, 1, l, 1...) along axis 1."""
    return (1,) * (axis + 1) + (l,) + (1,) * ndim_batch


def _check(x: torch.Tensor, axis: int, m: int) -> None:
    if x.shape[axis] != m:
        which = "leading axis" if axis == 0 else "axis-1 length"
        raise ValueError(f"{which} {x.shape[axis]} != transform length {m}")


def _forward(x: torch.Tensor, tables: ForwardTables, fc: FieldConsts, axis: int) -> torch.Tensor:
    m = tables.m
    _check(x, axis, m)
    nb = x.dim() - axis - 1
    for pair in tables.stages:
        l = pair.w.shape[0]
        x0, x1 = _stage_views(x, axis, m, l)
        w = _bcast(pair, _tw_shape(axis, l, nb))
        y0, y1 = fc.butterfly_forward(x0, x1, w.w, w.wp)
        x = _stage_join(y0, y1, axis, m)
    return x


def _inverse(x: torch.Tensor, tables: InverseTables, fc: FieldConsts, axis: int) -> torch.Tensor:
    m = tables.m
    _check(x, axis, m)
    nb = x.dim() - axis - 1
    last = len(tables.stages) - 1
    for s, pair in enumerate(tables.stages):
        l = pair.w.shape[0]
        x0, x1 = _stage_views(x, axis, m, l)
        w = _bcast(pair, _tw_shape(axis, l, nb))
        if s == last:
            # the final stage's double-twiddle butterfly folds in 1/m
            sc = _bcast(tables.scale, _tw_shape(axis, 1, nb))
            y0, y1 = fc.butterfly_inverse_scaled(x0, x1, sc.w, sc.wp, w.w, w.wp)
        else:
            y0, y1 = fc.butterfly_inverse(x0, x1, w.w, w.wp)
        x = _stage_join(y0, y1, axis, m)
    return x


def ntt_forward(x: torch.Tensor, tables: ForwardTables, fc: FieldConsts) -> torch.Tensor:
    """Length-m DIF NTT along the leading axis of (m, batch...); output in
    bit-reversed order, equal mod N to GoldenNTT.forward per column."""
    return _forward(x, tables, fc, 0)


def ntt_inverse(x: torch.Tensor, tables: InverseTables, fc: FieldConsts) -> torch.Tensor:
    """Length-m DIT inverse along the leading axis: consumes bit-reversed
    order, returns natural order scaled by 1/m (times any extra factor
    folded into the tables)."""
    return _inverse(x, tables, fc, 0)


def ntt_forward_mid(x: torch.Tensor, tables: ForwardTables, fc: FieldConsts) -> torch.Tensor:
    """Length-m DIF NTT along AXIS 1 of (A, m, batch...): ``ntt_forward``
    of the transposed data, bit for bit."""
    return _forward(x, tables, fc, 1)


def ntt_inverse_mid(x: torch.Tensor, tables: InverseTables, fc: FieldConsts) -> torch.Tensor:
    """Mirror of ``ntt_forward_mid`` (DIT inverse along axis 1, 1/m folded
    into the final stage)."""
    return _inverse(x, tables, fc, 1)


def pointwise_mont_mul(a: torch.Tensor, b: torch.Tensor, fc: FieldConsts) -> torch.Tensor:
    """Elementwise product with ``b`` in the Montgomery domain (the
    convolution's pointwise step)."""
    return fc.mont_mul_full(a, b)


def twiddle_rows(x: torch.Tensor, w: MontPair, fc: FieldConsts) -> torch.Tensor:
    """Elementwise multiply by a prepared Montgomery twiddle matrix (the
    six-step inter-step pass)."""
    return fc.mont_mul(x, w.w, w.wp)
