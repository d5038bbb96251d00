"""PyTorch port, the multi-device slice: ``parallel.DistributedNTT`` on
eight CPU logical shards against sventt_tpu's DistributedNTT on the
8-device CPU mesh, both directions.

The JAX side runs ``engine="auto"`` (its jnp engine off the TPU) with
``comm="xla"``, which its own tests pin bit-identical to its ring and
overlap modes; its outputs are computed once per configuration.  The port
runs its plain versions on CPU shards, every comm mode and engine.  All
engines agree mod N, so outputs are compared after ``normalize``,
tolerance zero, and every roundtrip must return the input exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from sventt_tpu.apps import convolve as japps
from sventt_tpu.field.limb import u64_from_numpy, u64_to_numpy
from sventt_tpu.parallel import DistributedNTT as JDistributedNTT
from sventt_tpu.parallel import make_ntt_mesh as jmake_ntt_mesh
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu.plan import planner as jplanner
from sventt_tpu_torch import interop
from sventt_tpu_torch.apps import cyclic_convolve, poly_multiply
from sventt_tpu_torch.field.limb import to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
)
from sventt_tpu_torch.ops import inter_step
from sventt_tpu_torch.parallel import DistributedNTT, make_ntt_mesh, ring
from sventt_tpu_torch.parallel.mesh import Mesh, make_mesh
from sventt_tpu_torch.plan import NTT, NttConfig, planner

N, G = TEST_MODULUS, TEST_GENERATOR
CPU8 = ["cpu"] * 8


def _cfg(n, n0=None, **kw):
    return dict(strategy="six_step", n0=n0, n1=None if n0 is None else n // n0, **kw)


def _x(n, seed=0, count=1):
    rng = np.random.default_rng(seed + n)
    return [rng.integers(0, N, n, dtype=np.uint64) for _ in range(count)]


@functools.lru_cache(maxsize=None)
def _jax_dntt(n, n0=None, mesh2d=False, enable_inverse=True):
    """The JAX DistributedNTT (engine "auto", comm "xla") of a config."""
    cfg = JNttConfig(N, G, n, **_cfg(n, n0))
    if mesh2d:
        mesh = jax.make_mesh((2, 4), ("dcn", "ici"))
        return JDistributedNTT(cfg, mesh, axis=("dcn", "ici"), enable_inverse=enable_inverse)
    return JDistributedNTT(cfg, jmake_ntt_mesh(8), enable_inverse=enable_inverse)


@functools.lru_cache(maxsize=None)
def _jax_ref(n, n0=None, mesh2d=False, inverse=True):
    """(x, forward(x), inverse(x)) of the JAX DistributedNTT, normalized."""
    dntt = _jax_dntt(n, n0, mesh2d, inverse)
    (x,) = _x(n)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd = u64_to_numpy(dntt.fc.normalize(dntt.compute_forward(xd)))
    inv = u64_to_numpy(dntt.fc.normalize(dntt.compute_inverse(xd))) if inverse else None
    return x, fwd, inv


def _check(dntt: DistributedNTT, x, fwd, inv=None):
    """The port's forward / inverse of x equal the references, the forward
    output stays sharded, and the roundtrip is exact."""
    shards = dntt.shard(x)
    out = dntt.compute_forward(shards)
    assert len(out) == dntt.D
    for s, dev in zip(out, dntt.devices):
        assert tuple(s.shape) == (dntt.get_m() // dntt.D,) and s.device == dev
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(out))), fwd)
    if inv is not None:
        got = dntt.compute_inverse(shards)
        np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(got))), inv)
    back = dntt.compute_inverse(out)
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(back))), x)


@pytest.mark.parametrize("comm,chunks", [("xla", 4), ("ring", 4), ("overlap", 2), ("overlap", 4)])
@pytest.mark.parametrize("n,n0", [(1 << 12, None), (1 << 13, 1 << 6)])
def test_distributed_matches_jax(n, n0, comm, chunks):
    x, fwd, inv = _jax_ref(n, n0)
    mesh = make_ntt_mesh(devices=CPU8)
    dntt = DistributedNTT(NttConfig(N, G, n, **_cfg(n, n0)), mesh, comm=comm, overlap_chunks=chunks)
    assert dntt.overlap_chunks == chunks  # divisibility kept the request
    ring.reset_counts()
    _check(dntt, x, fwd, inv)
    assert ring.PLAIN_CALLS["ring"] == (6 if comm == "ring" else 0)  # 2 a transform, 3 of them
    assert ring.LAUNCHES["ring"] == 0


@pytest.mark.parametrize("comm", ["xla", "ring"])
def test_distributed_row_split_plan(comm):
    """Shard-local row plan that is itself a Split (n1 = 2^14 above the
    pallas and mxu leaf caps): the nested plan inside each shard."""
    n = 1 << 18
    x, fwd, _ = _jax_ref(n, 1 << 4, inverse=False)
    cfg = NttConfig(N, G, n, **_cfg(n, 1 << 4, engine="pallas"))
    dntt = DistributedNTT(cfg, make_ntt_mesh(devices=CPU8), comm=comm)
    assert isinstance(dntt._row_plan, planner.Split)  # the shape under test
    _check(dntt, x, fwd)


@pytest.mark.parametrize(
    "kw,comm",
    [
        pytest.param(dict(engine="pallas"), "ring", id="pallas-ring"),
        pytest.param(dict(engine="mxu"), "xla", id="mxu-xla"),
        pytest.param(dict(engine="pallas", max_r=3), "overlap", id="pallas-r3-overlap"),
        pytest.param(dict(engine="pallas", max_r=3), "ring", id="pallas-r3-ring"),
    ],
)
def test_distributed_engines(kw, comm):
    n = 1 << 12
    x, fwd, inv = _jax_ref(n)
    dntt = DistributedNTT(NttConfig(N, G, n, **_cfg(n, **kw)), make_ntt_mesh(devices=CPU8), comm=comm)
    inter_step.reset_counts()
    _check(dntt, x, fwd, inv)
    assert inter_step.PLAIN_CALLS["inter_step"] >= 8 * 3  # one per shard and transform


def test_hierarchical_mesh():
    """The (2, 4) ("dcn", "ici") mesh, combined axis, comm "xla"."""
    n = 1 << 12
    x, fwd, _ = _jax_ref(n, mesh2d=True, inverse=False)
    mesh = make_mesh((2, 4), ("dcn", "ici"), devices=CPU8)
    dntt = DistributedNTT(NttConfig(N, G, n, **_cfg(n)), mesh, axis=("dcn", "ici"))
    assert dntt.D == 8
    _check(dntt, x, fwd)


def test_mesh_device_order():
    """A multi-axis mesh lists its devices row-major; a combined axis takes
    them row-major over the axes as named (devices made without a card)."""
    devs = tuple(torch.device("cuda", i) for i in range(8))
    mesh = Mesh(devs, ("dcn", "ici"), (2, 4))
    assert mesh.shape == {"dcn": 2, "ici": 4}
    assert mesh.devices_along(("dcn", "ici")) == devs
    order = np.arange(8).reshape(2, 4).T.ravel()
    assert mesh.devices_along(("ici", "dcn")) == tuple(devs[i] for i in order)
    with pytest.raises(ValueError):
        mesh.devices_along(("dcn",))
    with pytest.raises(ValueError):
        Mesh(devs, ("a",), (4,))


def test_mesh_and_constructor_checks():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 1 devices, have 0"):
            make_ntt_mesh(1)
    with pytest.raises(ValueError, match="requested 9"):
        make_ntt_mesh(9, devices=CPU8)
    mesh = make_ntt_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="divisible"):
        DistributedNTT(NttConfig(N, G, 1 << 12, **_cfg(1 << 12, 1 << 2)), mesh)
    with pytest.raises(ValueError, match="unknown comm"):
        DistributedNTT(NttConfig(N, G, 1 << 12, **_cfg(1 << 12)), mesh, comm="nccl")
    dntt = DistributedNTT(NttConfig(N, G, 1 << 12, **_cfg(1 << 12)), mesh, enable_inverse=False,
                          comm="overlap", overlap_chunks=3)
    assert dntt.overlap_chunks == 2  # reduced until it divides n1/D = 8
    shards = dntt.shard(_x(1 << 12)[0])
    with pytest.raises(RuntimeError, match="not enabled"):
        dntt.compute_inverse(shards)
    with pytest.raises(ValueError, match="shards"):
        dntt.compute_forward(shards[:4])
    with pytest.raises(TypeError):
        dntt.compute_forward([s.int() for s in shards])


def test_solinas_raises():
    """Solinas on a modulus that is not sparse-high raises, as in JAX; on
    the flagship the distributed transform builds with Solinas local
    tables and Montgomery inter-step tables (held against JAX in
    test_torch_solinas_plan.py)."""
    with pytest.raises(ValueError, match="sparse-high"):
        NttConfig(N, G, 1 << 12, **_cfg(1 << 12, modmul="solinas"))
    with pytest.raises(ValueError, match="sparse-high"):
        JNttConfig(N, G, 1 << 12, **_cfg(1 << 12, modmul="solinas"))
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12, **_cfg(1 << 12, modmul="solinas"))
    dntt = DistributedNTT(cfg, make_ntt_mesh(devices=CPU8))
    assert (dntt.fc.modmul, dntt.tw_fc.modmul) == ("solinas", "montgomery")
    assert dntt._forward.tw[0].wp is not None


def test_shard_twiddles_built_per_device(monkeypatch):
    """Above DEVICE_TWIDDLE_THRESHOLD each shard's inter-step block is
    generated on its own device: the blocks equal the columns of the whole
    matrix (companion below W_ONLY_THRESHOLD, none from it on), and the
    transform is the one built from the whole matrix.  The schedule drops
    only its own lists' entries: the caller's shards stay."""
    n = 1 << 12
    cfg = NttConfig(N, G, n, **_cfg(n))
    mesh = make_ntt_mesh(devices=CPU8)
    x = _x(n)[0]
    want = DistributedNTT(cfg, mesh).compute_forward(DistributedNTT(cfg, mesh).shard(x))
    monkeypatch.setattr(planner, "DEVICE_TWIDDLE_THRESHOLD", 1 << 6)
    for w_only in (False, True):
        monkeypatch.setattr(planner, "W_ONLY_THRESHOLD", (1 << 6) if w_only else (1 << 26))
        dntt = DistributedNTT(cfg, mesh)
        for inverse, t in ((False, dntt._forward), (True, dntt._inverse)):
            full = planner.row_twiddles(dntt.mod, dntt.n0, dntt.n1, inverse=inverse,
                                        w_only=w_only, device="cpu")
            for d, tw in enumerate(t.tw):
                cols = slice(d * dntt.n1 // 8, (d + 1) * dntt.n1 // 8)
                assert torch.equal(tw.w, full.w[:, cols])
                assert (tw.wp is None) == w_only
                if not w_only:
                    assert torch.equal(tw.wp, full.wp[:, cols])
        shards = dntt.shard(x)
        got = dntt.compute_forward(shards)
        assert all(s is not None and s.shape == (n // 8,) for s in shards)
        for a, b in zip(got, want):
            assert torch.equal(dntt.fc.normalize(a), dntt.fc.normalize(b))


STEPS = {
    "ring": (["comm1", "columns", "comm2", "rows"], ["rows", "comm2", "columns", "comm1"]),
    "overlap": (["comm1", "columns+comm2", "rows"], ["rows", "comm2+columns", "comm1"]),
}


@pytest.mark.parametrize("comm", sorted(STEPS))
def test_on_step_names_the_schedule(comm):
    """``on_step(name)`` is called after each step of the schedule, in
    order, and changes nothing: the outputs equal a run without it, the
    roundtrip is exact, and the caller's shards stay (each step drops only
    the entries of its own lists)."""
    n = 1 << 12
    dntt = DistributedNTT(NttConfig(N, G, n, **_cfg(n)), make_ntt_mesh(devices=CPU8), comm=comm)
    (x,) = _x(n)
    shards = dntt.shard(x)
    seen = {False: [], True: []}
    fwd = dntt.compute_forward(shards, on_step=seen[False].append)
    back = dntt.compute_inverse(fwd, on_step=seen[True].append)
    assert (seen[False], seen[True]) == STEPS[comm]
    assert all(s is not None for s in shards + fwd)
    for a, b in zip(fwd, dntt.compute_forward(shards)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(back))), x)


def test_cyclic_convolve_distributed():
    """cyclic_convolve over a DistributedNTT equals JAX's over its own, and
    poly_multiply through the mesh, or on one device, equals the product
    computed with Python ints."""
    n = 1 << 12
    a, b = _x(n, seed=7, count=2)
    jd = _jax_dntt(n)
    want = u64_to_numpy(jd.fc.normalize(japps.cyclic_convolve(
        jd, *(jax.device_put(u64_from_numpy(v), jd.sharding()) for v in (a, b))
    )))
    dntt = DistributedNTT(NttConfig(N, G, n, **_cfg(n)), make_ntt_mesh(devices=CPU8), comm="ring")
    got = cyclic_convolve(dntt, dntt.shard(a), dntt.shard(b))
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(got))), want)
    pa, pb = [int(v) for v in a[:300]], [int(v) for v in b[:200]]
    prod = [0] * (len(pa) + len(pb) - 1)
    for i, u in enumerate(pa):
        for j, v in enumerate(pb):
            prod[i + j] = (prod[i + j] + u * v) % N
    for kw in (dict(ntt=dntt), dict(device="cpu")):
        got = poly_multiply(a[:300], b[:200], N, G, **kw)
        assert [int(v) for v in got] == prod
    assert len(poly_multiply(a[:300], b[:200], N, G, out_len=10, device="cpu")) == 10


def _pair(tw):
    return {
        "w": (np.asarray(tw.w.hi), np.asarray(tw.w.lo)),
        "wp": None if tw.wp is None else (np.asarray(tw.wp.hi), np.asarray(tw.wp.lo)),
    }


def _plan_arrays(jpt):
    """A JAX mxu PlanTables as numpy in interop's layout."""
    return {
        "leaf": {
            k: {"planes": np.asarray(v.planes), "corr": (np.asarray(v.corr.hi), np.asarray(v.corr.lo))}
            for k, v in jpt.leaf.items()
        },
        "split_tw": {k: _pair(v) for k, v in jpt.split_tw.items()},
        "split_tw_t": {k: _pair(v) for k, v in jpt.split_tw_t.items()},
    }


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_distributed_tables_from_numpy(inverse):
    """A JAX DistributedNTT's tables carried across equal the port's own
    at 2^12, D = 8 (engine "mxu"), and drive the same transform."""
    n = 1 << 12
    jcfg = JNttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, strategy="six_step", engine="mxu")
    jd = JDistributedNTT(jcfg, jmake_ntt_mesh(8), enable_forward=not inverse, enable_inverse=inverse)
    tw, col, row = (jd._inv_tw, jd._inv_col, jd._inv_row) if inverse else (jd._fwd_tw, jd._fwd_col, jd._fwd_row)
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, strategy="six_step", engine="mxu")
    dntt = DistributedNTT(cfg, make_ntt_mesh(devices=CPU8))
    arrays = {"tw": _pair(jplanner.MontPair(*tw)), "col": _plan_arrays(col), "row": _plan_arrays(row)}
    carried = interop.distributed_tables_from_numpy(
        dntt._col_plan, dntt._row_plan, dntt.mod, dntt.fc, inverse, arrays, CPU8
    )
    own = dntt._inverse if inverse else dntt._forward
    assert len(carried.tw) == 8 and tuple(carried.tw[0].w.shape) == (64, 8)
    for c, o in zip(carried.tw, own.tw):
        assert torch.equal(c.w, o.w) and torch.equal(c.wp, o.wp)
    for name in ("col", "row"):
        c, o = getattr(carried, name), getattr(own, name)
        assert c.keys() == o.keys() == {torch.device("cpu")}
        for k, v in o[torch.device("cpu")].leaf.items():
            assert torch.equal(c[torch.device("cpu")].leaf[k].planes, v.planes)
            assert torch.equal(c[torch.device("cpu")].leaf[k].corr, v.corr)
    x = dntt.shard(_x(n)[0] % np.uint64(FLAGSHIP_MODULUS))
    local = dntt._inverse_local if inverse else dntt._forward_local
    for a, b in zip(local(x, carried), local(x, own)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_partial(n):
    """(x, forward(x), inverse(x)) of JAX's DistributedNTT on the (2, 4)
    ("dcn", "ici") mesh with the collective axis "ici" alone (the vector
    replicated over "dcn"), normalized."""
    mesh = jax.make_mesh((2, 4), ("dcn", "ici"))
    dntt = JDistributedNTT(JNttConfig(N, G, n, **_cfg(n)), mesh, axis="ici")
    (x,) = _x(n)
    xd = jax.device_put(u64_from_numpy(x), dntt.sharding())
    fwd = u64_to_numpy(dntt.fc.normalize(dntt.compute_forward(xd)))
    inv = u64_to_numpy(dntt.fc.normalize(dntt.compute_inverse(xd)))
    return x, fwd, inv


@pytest.mark.parametrize("comm", ["xla", "overlap"])
def test_partial_axis_matches_jax(comm):
    """A collective axis that leaves a mesh axis out: the six-step runs in
    each of the two "dcn" replica groups over its four "ici" devices; the
    replicas are equal, and equal to JAX's and to the single-device NTT."""
    n = 1 << 12
    x, fwd, inv = _jax_partial(n)
    mesh = make_mesh((2, 4), ("dcn", "ici"), devices=CPU8)
    cfg = NttConfig(N, G, n, **_cfg(n))
    dntt = DistributedNTT(cfg, mesh, axis="ici", comm=comm)
    assert dntt.D == 4 and dntt.replicas == mesh.replica_groups(("ici",))
    assert len(dntt.devices) == 8 and len(dntt._forward.tw) == 8
    single = NTT(cfg, device="cpu")
    shards = dntt.shard(x)
    assert [tuple(s.shape) for s in shards] == [(n // 4,)] * 8
    for compute, want, ref in ((dntt.compute_forward, fwd, single.forward_numpy(x)),
                               (dntt.compute_inverse, inv, single.inverse_numpy(x))):
        out = compute(shards)
        replicas = [to_numpy(torch.cat(dntt.normalize(out[r * 4:(r + 1) * 4]))) for r in range(2)]
        np.testing.assert_array_equal(replicas[0], replicas[1])
        np.testing.assert_array_equal(replicas[0], want)
        np.testing.assert_array_equal(replicas[0], ref)
    back = dntt.compute_inverse(dntt.compute_forward(shards))
    np.testing.assert_array_equal(to_numpy(dntt.gather(dntt.normalize(back))), x)
    with pytest.raises(ValueError, match="8 shards"):
        dntt.compute_forward(shards[:4])


def test_replica_groups():
    devs = tuple(torch.device("cpu", i) for i in range(8))
    mesh = Mesh(devs, ("dcn", "ici"), (2, 4))
    assert mesh.replica_groups(("ici",)) == (devs[:4], devs[4:])
    assert mesh.replica_groups(("dcn",)) == tuple((devs[i], devs[i + 4]) for i in range(4))
    assert mesh.replica_groups(("dcn", "ici")) == (mesh.devices_along(("dcn", "ici")),)
    assert mesh.replica_groups(("ici", "dcn")) == (mesh.devices_along(("ici", "dcn")),)
    with pytest.raises(ValueError, match="not distinct axes"):
        mesh.replica_groups(("ici", "ici"))
    with pytest.raises(ValueError, match="not distinct axes"):
        mesh.replica_groups(("x",))


def test_tune_is_not_read(tmp_path, monkeypatch):
    """As in the JAX package, DistributedNTT does not read ``tune``: with
    and without it the transform is the same (no search runs)."""
    from sventt_tpu_torch.plan import autotune

    def boom(*a, **k):
        raise AssertionError("DistributedNTT ran the autotuner")

    monkeypatch.setattr(autotune, "search", boom)
    n = 1 << 12
    x, fwd, _ = _jax_ref(n)
    mesh = make_ntt_mesh(devices=CPU8)
    outs = []
    for tune in (True, False):
        dntt = DistributedNTT(NttConfig(N, G, n, tune=tune, **_cfg(n)), mesh, enable_inverse=False)
        outs.append(to_numpy(dntt.gather(dntt.normalize(dntt.compute_forward(dntt.shard(x))))))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], fwd)


@pytest.mark.slow
@pytest.mark.parametrize("comm", ["xla", "ring", "overlap"])
def test_deep_composition(comm):
    """2^20 over 8 shards with two-level mxu local plans, every comm mode,
    against the native oracle (``tools/deep_composition.py``, which also
    runs it on the card)."""
    from tools.deep_composition import check

    check("cpu", comm)
