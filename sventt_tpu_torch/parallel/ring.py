"""The all-to-all of the six-step transposes: the ring kernel K10 and the
torch-copy exchange.

The counterpart of ``sventt_tpu/parallel/ring.py``.  Data is a list of D
shards, shard d on mesh device d (one process drives them all, see
``mesh``).  Two exchanges with ``jax.lax.all_to_all(tiled=True)``
semantics on 2-D shards -- the shard's ``split_axis`` is cut into D chunks,
chunk j goes to shard j, and the chunks a shard receives are concatenated
along ``concat_axis`` in source order:

* ``copy_all_to_all`` -- torch slicing, ``.to(device)`` and ``torch.cat``,
  the counterpart of the XLA collective (``DistributedNTT(comm="xla")``)
  and the yardstick of the kernel;
* ``ring_all_to_all`` -- ``comm="ring"``: on CUDA shards the kernel
  ``csrc/ring.cu`` (K10, the remote-DMA ring of the JAX package), on CPU
  shards its plain version ``ring_all_to_all_plain``.

Both map onto the canonical contract of the JAX kernel: shard d's input is
(D, R, C), slab j bound for shard j, and its output (D, R, C) with
``out_d[o] = in_o[d]`` (``canonical_all_to_all``).  A column split (split
1, concat 0) reads its slabs through the transpose ``(r, D, w) -> (D, r,
w)`` and a row split (split 0, concat 1) writes them through ``(D, h, c)
-> (h, D, c)`` (JAX ``ring.py:155-177``); the kernel takes both as strides,
so no reshaping pass runs before or after it.

On CUDA shards the kernel pulls: one launch per destination card, on its
current stream, covering every shard the card holds.  Before it, that
stream waits on an event recorded on each source card's current stream;
after it, each source tensor read from another card is recorded on that
stream (``record_stream``), so its allocator does not hand the memory out
early.  On one card these steps do nothing.  Peer access between the cards
is turned on when the mesh is built (``enable_peer_access``).  A CUDA shard
list launches the kernel or raises: there is no fallback to the plain
version or to the torch copy.

``LAUNCHES`` / ``PLAIN_CALLS`` count K10 launches and plain exchanges
("ring").
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from .mesh import AXIS

LAUNCHES = {"ring": 0}
PLAIN_CALLS = {"ring": 0}

#: Most shards the kernel takes (its by-value pointer table).
MAX_D = 64

#: Card pairs with peer access on: a property of the process's CUDA
#: contexts, so it is kept per process.
_peers: set[tuple[int, int]] = set()


def reset_counts() -> None:
    """Set the launch and plain-call counts to zero."""
    LAUNCHES["ring"] = PLAIN_CALLS["ring"] = 0


def enable_peer_access(cards) -> None:
    """Let every card of ``cards`` (indices) read every other's memory;
    raise if a pair cannot.  Each pair is turned on once per process."""
    lib = None
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _peers:
                continue
            if lib is None:
                from .. import _build

                lib = _build.load()
            rc = lib.sventt_enable_peer_access(a, b)
            if rc != 0:
                raise RuntimeError(
                    f"cuda:{a} cannot read cuda:{b}'s memory (CUDA error {rc}); "
                    "comm='ring' across these cards needs peer access"
                )
            _peers.add((a, b))


def _check_axes(axes) -> None:
    """The ring runs over one mesh axis (JAX ``ring.py:47-57``)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) != 1:
        raise ValueError("ring all-to-all supports a single mesh axis")


def _check_shards(shards, dims: int) -> tuple[int, tuple[int, ...]]:
    D = len(shards)
    if D < 1:
        raise ValueError("no shards")
    shape = tuple(shards[0].shape)
    for s in shards:
        if s.dim() != dims or tuple(s.shape) != shape:
            raise ValueError(f"expected {D} {dims}-D shards of one shape, got {tuple(s.shape)}")
        if s.dtype != torch.int64:
            raise TypeError(f"expected int64 shards of u64 bit patterns, got {s.dtype}")
    return D, shape


def _check_split(D: int, shape, split_axis: int, concat_axis: int) -> None:
    if (split_axis, concat_axis) not in ((1, 0), (0, 1)):
        raise ValueError(f"unsupported (split_axis={split_axis}, concat_axis={concat_axis})")
    if shape[split_axis] % D:
        raise ValueError(f"axis {split_axis} of {shape} is not divisible by {D} shards")


def copy_all_to_all(shards, split_axis: int, concat_axis: int, out=None) -> list[torch.Tensor]:
    """``lax.all_to_all(tiled=True)`` over 2-D shards by torch slicing,
    ``.to(device)`` and ``torch.cat``: the ``comm="xla"`` exchange.  ``out``:
    one preallocated output per shard, written in place."""
    D, shape = _check_shards(shards, 2)
    _check_split(D, shape, split_axis, concat_axis)
    k = shape[split_axis] // D
    if out is None:
        out = [None] * D
    return [
        torch.cat([s.narrow(split_axis, d * k, k).to(dst.device) for s in shards],
                  dim=concat_axis, out=out[d])
        for d, dst in enumerate(shards)
    ]


def ring_all_to_all_plain(shards, split_axis: int, concat_axis: int) -> list[torch.Tensor]:
    """The plain version of ``ring_all_to_all`` (torch indexing and cat)."""
    PLAIN_CALLS["ring"] += 1
    return copy_all_to_all(shards, split_axis, concat_axis)


def canonical_all_to_all_plain(slabs) -> list[torch.Tensor]:
    """The plain version of ``canonical_all_to_all``: out_d[o] = in_o[d]."""
    D, shape = _check_shards(slabs, 3)
    if shape[0] != D:
        raise ValueError(f"expected (D, R, C) = ({D}, R, C) slabs, got {shape}")
    PLAIN_CALLS["ring"] += 1
    return [torch.stack([s[d].to(dst.device) for s in slabs]) for d, dst in enumerate(slabs)]


def _on_card(shards) -> bool:
    kinds = {s.device.type for s in shards}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"shards on {sorted(kinds)}: the ring runs on cpu or cuda shards")


def _launch(shards, out_shape, R: int, C: int, strides: tuple[int, int, int, int]):
    """K10 over ``shards`` (contiguous CUDA tensors): slab d of source o at
    ``d * src_slab``, R rows ``src_row`` apart, lands in destination d at
    ``o * dst_slab``, rows ``dst_row`` apart."""
    from .. import _build

    with span("sventt.launch.ring"):
        D = len(shards)
        if D > MAX_D:
            raise ValueError(f"the ring kernel takes at most {MAX_D} shards, got {D}")
        shards = [s.contiguous() for s in shards]
        enable_peer_access(sorted({s.device.index for s in shards}))
        lib = _build.load()
        outs = [torch.empty(out_shape, dtype=torch.int64, device=s.device) for s in shards]
        src = (ctypes.c_void_p * D)(*[s.data_ptr() for s in shards])
        by_card: dict[int, list[int]] = {}
        for d, s in enumerate(shards):
            by_card.setdefault(s.device.index, []).append(d)
        for card, dests in by_card.items():
            stream = torch.cuda.current_stream(card)
            for other in by_card:
                if other != card:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(other))
                    stream.wait_event(event)
            dst = (ctypes.c_void_p * len(dests))(*[outs[d].data_ptr() for d in dests])
            ids = (ctypes.c_int * len(dests))(*dests)
            rc = lib.sventt_ring_all_to_all(
                src, dst, ids, len(dests), D, R, C, *strides, card, stream.cuda_stream
            )
            if rc != 0:
                raise RuntimeError(f"ring all-to-all kernel launch failed: CUDA error {rc}")
            LAUNCHES["ring"] += 1
            for s in shards:
                if s.device.index != card:
                    s.record_stream(stream)
        return outs


def canonical_all_to_all(slabs) -> list[torch.Tensor]:
    """The canonical exchange (K10): shard d's (D, R, C) input holds slab j
    for shard j; its output holds out_d[o] = in_o[d]."""
    if not _on_card(slabs):
        return canonical_all_to_all_plain(slabs)
    D, shape = _check_shards(slabs, 3)
    if shape[0] != D:
        raise ValueError(f"expected (D, R, C) = ({D}, R, C) slabs, got {shape}")
    _, R, C = shape
    return _launch(slabs, shape, R, C, (R * C, C, R * C, C))


def ring_all_to_all(
    shards, split_axis: int, concat_axis: int, axes=(AXIS,)
) -> list[torch.Tensor]:
    """``lax.all_to_all(tiled=True)`` over 2-D shards by the ring kernel
    (K10) on CUDA shards, its plain version on CPU shards.  ``axes``: the
    collective mesh axes, which must be one."""
    _check_axes(axes)
    D, shape = _check_shards(shards, 2)
    _check_split(D, shape, split_axis, concat_axis)
    if not _on_card(shards):
        return ring_all_to_all_plain(shards, split_axis, concat_axis)
    r, c = shape
    if split_axis == 1:
        # (r, c) -> (D*r, c/D): slab j = columns [j*w, (j+1)*w), read
        # through the transpose (r, D, w) -> (D, r, w); written contiguous
        w = c // D
        return _launch(shards, (D * r, w), r, w, (w, c, r * w, w))
    # (r, c) -> (r/D, D*c): slab j = rows [j*h, (j+1)*h), read contiguous;
    # written through the transpose (D, h, c) -> (h, D, c)
    h = r // D
    return _launch(shards, (h, D * c), h, c, (h * c, c, c, D * c))


# ctypes signatures of the C entries in csrc/ring.cu
_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 2
    + [ctypes.c_longlong] * 6
    + [ctypes.c_int, ctypes.c_void_p]
)
_PEER_ARGTYPES = [ctypes.c_int, ctypes.c_int]
