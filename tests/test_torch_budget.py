"""PyTorch port, the distributed memory budget: ``parallel.budget``
against sventt_tpu's, and its table bytes against the tables the port
really builds.

The coefficient and inter-step twiddle bytes and the count of directions
follow the same rule as the JAX package (8 bytes a point); ``transient``
is the JAX rule's without donation, which the port does not have, and
``step_scratch`` the port's own term (its eager kernel chain's
intermediates); the table bytes are the port's own compact tables, held
to the ``nbytes`` of the tensors that ``DistributedNTT`` builds on CPU
shards (``device="cpu"``); CUDA tables (the default) add each mxu leaf's
tensor-core tile copy, ``ntt_mxu.tc_plane_tile_bytes``, held here to the
tile layout's own size.  The card checks -- the measured peak within the
budget, and the CUDA budget's table bytes equal to the built CUDA tables'
-- are chip_smoke.py's distributed phases.
"""

import dataclasses

import pytest
import torch

from sventt_tpu.parallel import distributed_memory_budget as jbudget
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
)
from sventt_tpu_torch.ops import ntt_mxu
from sventt_tpu_torch.parallel import (
    DistributedNTT,
    distributed_memory_budget,
    make_ntt_mesh,
    validate_2p30,
)
from sventt_tpu_torch.parallel.budget import DEFAULT_HBM_BYTES
from sventt_tpu_torch.plan import NttConfig


def _args(N, g, log2n, n0=None):
    n = 1 << log2n
    return dict(modulus=N, generator=g, n=n, strategy="six_step", n0=n0,
                n1=None if n0 is None else n // n0)


@pytest.mark.parametrize(
    "args,devices,kw",
    [
        pytest.param(_args(TEST_MODULUS, TEST_GENERATOR, 20), 8, {}, id="2^20-D8"),
        pytest.param(_args(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 26), 4, {}, id="2^26-D4"),
        pytest.param(_args(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 30), 8,
                     dict(enable_inverse=False, donate_input=True), id="2^30-D8-fwd-donated"),
        pytest.param(_args(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 30), 2, {}, id="2^30-D2"),
    ],
)
def test_budget_matches_jax(args, devices, kw):
    """Coefficient and inter-step twiddle bytes and the count of directions
    equal the JAX budget's for the same config and D; ``transient`` is the
    JAX rule's without donation (the port keeps the caller's input), and
    ``step_scratch`` two shards, the port's own count."""
    port_kw = {k: v for k, v in kw.items() if k != "donate_input"}
    got = distributed_memory_budget(NttConfig(**args), devices, **port_kw)
    want = jbudget(JNttConfig(**args), devices, **kw)
    for name in ("n", "devices", "coefficients", "inter_step_twiddles", "directions"):
        assert getattr(got, name) == getattr(want, name), name
    undonated = jbudget(JNttConfig(**args), devices, **port_kw)
    assert got.transient == undonated.transient == 2 * got.coefficients
    assert got.step_scratch == 2 * got.coefficients
    tables = got.directions * (got.inter_step_twiddles + got.leaf_tables)
    assert got.total == got.coefficients + got.transient + tables + got.step_scratch


def _tensor_bytes(obj) -> int:
    """Bytes of every tensor held by a table object, its fields and items."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(_tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_tensor_bytes(v) for v in obj)
    return 0


@pytest.mark.parametrize(
    "log2n,n0,kw",
    [
        pytest.param(log2n, None, kw, id=f"2^{log2n}-{name}")
        for log2n in (12, 13, 14)
        for name, kw in (("mxu", dict(engine="mxu")), ("pallas", dict(engine="pallas")),
                         ("grouped", dict(engine="pallas", max_r=3)))
    ]
    + [
        pytest.param(18, 1 << 4, dict(engine="pallas"), id="2^18-row-split-pallas"),
        pytest.param(18, 1 << 4, dict(engine="pallas", max_r=4), id="2^18-row-split-grouped"),
        pytest.param(20, 1 << 4, dict(engine="mxu"), id="2^20-row-split-mxu"),
    ]
    + [
        pytest.param(log2n, n0, dict(kw, modmul="solinas"), id=f"2^{log2n}-{name}-solinas")
        for log2n, n0, name, kw in (
            (13, None, "mxu", dict(engine="mxu")),
            (13, None, "pallas", dict(engine="pallas")),
            (13, None, "grouped", dict(engine="pallas", max_r=3)),
            (18, 1 << 4, "row-split-pallas", dict(engine="pallas")),
        )
    ],
)
def test_leaf_tables_match_built_tables(log2n, n0, kw):
    """``leaf_tables`` equals the summed bytes of the tensors the port's
    PlanTables built for the n0 and n1 plans (one direction, one device);
    under Solinas (the flagship modulus) the stage and inner inter-step
    tables are companion-free and max_r=3 is radix-2."""
    N, g = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR) if kw.get("modmul") else (TEST_MODULUS, TEST_GENERATOR)
    cfg = NttConfig(**_args(N, g, log2n, n0), **kw)
    dntt = DistributedNTT(cfg, make_ntt_mesh(devices=["cpu"] * 8), enable_inverse=False)
    t = dntt._forward
    built = 0
    for tables in (t.col[torch.device("cpu")], t.row[torch.device("cpu")]):
        built += sum(_tensor_bytes(getattr(tables, k)) for k in ("leaf", "lane", "split_tw", "split_tw_t"))
    budget = distributed_memory_budget(cfg, 8, enable_inverse=False, device="cpu")
    assert budget.leaf_tables == built
    assert budget.directions == 1
    # the sharded inter-step matrix: the per-device figure times D
    assert budget.inter_step_twiddles * 8 == sum(_tensor_bytes(tw) for tw in t.tw)


def test_validate_2p30_fits_the_h100():
    b = validate_2p30(8)
    assert b.coefficients == (1 << 30) // 8 * 8
    assert b.inter_step_twiddles == b.coefficients  # companion-free
    assert b.fits() and b.total <= DEFAULT_HBM_BYTES
    assert 70 * (1 << 30) < DEFAULT_HBM_BYTES < 80 * (1 << 30)
    # validate_2p30 budgets what the port does: no donation, its scratch
    assert b.transient == 2 * b.coefficients and b.step_scratch == 2 * b.coefficients
    assert b.total == 6 * b.coefficients + b.leaf_tables
    # one card holds the whole 2^30 transform one direction at a time
    # (48 GiB), not 2^31 even forward only (96 GiB): the port cannot donate
    assert validate_2p30(1).fits()
    cfg = NttConfig(**_args(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 31))
    assert not distributed_memory_budget(cfg, 1).fits()
    assert not distributed_memory_budget(cfg, 1, enable_inverse=False).fits()


def test_card_total_counts_logical_shards():
    """A card holding D logical shards needs D shards' data and inter-step
    blocks, one copy of the tables and one shard's scratch; the budget the
    2^28 D = 8 card check holds the measured peak to."""
    cfg = NttConfig(**_args(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 28), engine="pallas")
    b = distributed_memory_budget(cfg, 8)
    per_shard = b.coefficients + b.transient + b.directions * b.inter_step_twiddles
    assert b.card_total(8) == 8 * per_shard + b.directions * b.leaf_tables + b.step_scratch
    assert b.card_total(1) == b.total
    # 2^28: 5 x 2 GiB of data and twiddles, 0.5 GiB of scratch
    assert b.card_total(8) - b.directions * b.leaf_tables == 5 * (1 << 31) + (1 << 29)


def test_budget_rejects_a_mesh_of_3():
    cfg = NttConfig(**_args(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 30))
    with pytest.raises(ValueError, match="divisible"):
        distributed_memory_budget(cfg, 3)
    with pytest.raises(ValueError, match="divisible"):
        DistributedNTT(NttConfig(**_args(TEST_MODULUS, TEST_GENERATOR, 12)),
                       make_ntt_mesh(devices=["cpu"] * 3))


def test_companion_threshold_reflected():
    """Below 2^26 the inter-step matrix keeps its Montgomery companion."""
    mid = distributed_memory_budget(NttConfig(**_args(TEST_MODULUS, TEST_GENERATOR, 20)), 8)
    assert mid.inter_step_twiddles == 2 * mid.coefficients
    big = distributed_memory_budget(NttConfig(**_args(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 30)), 8)
    assert big.inter_step_twiddles == big.coefficients


@pytest.mark.parametrize("m", [1 << k for k in range(1, 11)] + [3, 48, 96, 200, 1000])
def test_tc_plane_tile_bytes_match_the_layout(m):
    """``tc_plane_tile_bytes(m)`` is the size of the tile copy that
    ``tc_plane_tiles`` builds, without building it."""
    planes = torch.zeros(ntt_mxu.NL_S8 * m, m, dtype=torch.int8)
    tiles = ntt_mxu.tc_plane_tiles(planes, m)
    assert ntt_mxu.tc_plane_tile_bytes(m) == tiles.numel() * tiles.element_size()


@pytest.mark.parametrize(
    "log2n,n0,kw",
    [
        pytest.param(13, None, dict(engine="mxu"), id="2^13-mxu"),
        pytest.param(20, 1 << 4, dict(engine="mxu"), id="2^20-row-split-mxu"),
        pytest.param(13, None, dict(engine="mxu", modmul="solinas"), id="2^13-mxu-solinas"),
        pytest.param(13, None, dict(engine="pallas", max_r=3), id="2^13-grouped"),
    ],
)
def test_cuda_budget_counts_the_tile_copy(log2n, n0, kw):
    """The "cuda" budget exceeds the "cpu" one by the tile copy of each
    distinct mxu leaf the built tables hold, once per length, as
    ``PlanTables`` keys them; a pallas plan has no mxu leaf."""
    N, g = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR) if kw.get("modmul") else (TEST_MODULUS, TEST_GENERATOR)
    cfg = NttConfig(**_args(N, g, log2n, n0), **kw)
    dntt = DistributedNTT(cfg, make_ntt_mesh(devices=["cpu"] * 8), enable_inverse=False)
    t = dntt._forward
    mxu_ms = set()
    for tables in (t.col[torch.device("cpu")], t.row[torch.device("cpu")]):
        for d in tables.leaf.values():
            if isinstance(d, ntt_mxu.MxuDirection):
                assert d.tc_planes is None  # CPU tables hold no tile copy
                mxu_ms.add(d.m)
    cuda = distributed_memory_budget(cfg, 8, enable_inverse=False)
    cpu = distributed_memory_budget(cfg, 8, enable_inverse=False, device="cpu")
    assert cuda.leaf_tables - cpu.leaf_tables == sum(map(ntt_mxu.tc_plane_tile_bytes, mxu_ms))
    assert bool(mxu_ms) == (kw["engine"] == "mxu")
    with pytest.raises(ValueError, match="device"):
        distributed_memory_budget(cfg, 8, device="tpu")
