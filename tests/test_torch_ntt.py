"""PyTorch port, the slice as a whole: NTT against sventt_tpu's NTT(engine="mxu").

Inputs are made with numpy from a seed; the JAX side runs its Pallas
kernels in interpret mode.  Outputs are compared bit for bit (tolerance
zero), and the roundtrip must return the input exactly.
"""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu.utils import fill as jfill
from sventt_tpu_torch import native
from sventt_tpu_torch.field.golden import GoldenNTT
from sventt_tpu_torch.field.limb import to_numpy
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
)
from sventt_tpu_torch.ops import ntt_mxu
from sventt_tpu_torch.plan import NTT, NttConfig
from sventt_tpu_torch.plan import planner
from sventt_tpu_torch.utils import fill

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "N,g,log2n,max_fused",
    [
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 10, None, id="flagship-2^10"),
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 12, None, id="flagship-2^12"),
        pytest.param(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 14, 32, id="flagship-2^14-3level"),
        pytest.param(TEST_MODULUS, TEST_GENERATOR, 10, 16, id="test62-2^10-3level"),
    ],
)
def test_ntt_matches_jax_mxu(rng, N, g, log2n, max_fused):
    n = 1 << log2n
    kw = dict(max_fused=max_fused)
    ref = JNTT(JNttConfig(N, g, n, engine="mxu", **kw))
    ntt = NTT(NttConfig(N, g, n, **kw), device="cpu")
    assert ntt.engine == "mxu"
    assert repr(ntt.plan) == repr(ref.plan)
    x = rng.integers(0, N, n, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, ref.forward_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(x), ref.inverse_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


def test_three_level_plan_reaches_mid_kernel(rng):
    """The 2^24-shaped composition at reduced size: both orientations run."""
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12, max_fused=16)
    ntt = NTT(cfg, device="cpu")
    assert isinstance(ntt.plan.col, planner.Split)
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    ntt_mxu.reset_counts()
    out = ntt.forward_numpy(x)
    assert ntt_mxu.PLAIN_CALLS["lead"] > 0 and ntt_mxu.PLAIN_CALLS["mid"] > 0
    assert ntt_mxu.LAUNCHES == {"lead": 0, "mid": 0, "lane": 0}
    np.testing.assert_array_equal(out, native.golden_forward(x, cfg.modulus, cfg.generator))


def test_batched_input_matches_columns(rng):
    """(n, batch) input: each column equals the unbatched transform."""
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 8, max_fused=16)
    ntt = NTT(cfg, device="cpu")
    x = rng.integers(0, cfg.modulus, (cfg.n, 3), dtype=np.uint64)
    from sventt_tpu_torch.field.limb import from_numpy

    got = to_numpy(ntt.compute_forward(from_numpy(x)))
    for c in range(3):
        np.testing.assert_array_equal(got[:, c], ntt.forward_numpy(x[:, c].copy()))


def test_oracle_and_fill_match():
    n = 1 << 10
    x = fill.host_fill(n, FLAGSHIP_MODULUS)
    np.testing.assert_array_equal(x, jfill.host_fill(n, FLAGSHIP_MODULUS))
    np.testing.assert_array_equal(to_numpy(fill.device_fill(n, FLAGSHIP_MODULUS, "cpu")), x)
    mod = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n).mod
    want = GoldenNTT(n, mod).forward([int(v) for v in x])
    assert [int(v) for v in native.golden_forward(x, mod.modulus, mod.generator)] == want
    back = native.golden_inverse(np.array(want, dtype=np.uint64), mod.modulus, mod.generator)
    np.testing.assert_array_equal(back, x)


def test_describe_and_get_m():
    ntt = NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 14, max_fused=32),
              enable_inverse=False, device="cpu")
    assert ntt.get_m() == 1 << 14
    assert ntt.describe().splitlines() == [
        "split 16384 = 512 x 32: lane-axis mxu m1=32 (fused twiddle, no transposes)",
        "  split 512 = 16 x 32: mid-axis mxu m1=32 (fused twiddle, no transposes)",
        "    leaf m=16 engine=mxu",
    ]
    assert ntt.describe(batched=True).splitlines()[0].startswith(
        "split 16384 = 512 x 32: mid-axis mxu"
    )
    with pytest.raises(RuntimeError):
        ntt.compute_inverse(torch.zeros(1 << 14, dtype=torch.int64))


#: The port's mxu row lines and the JAX package's text for the same row
#: (its describe() has no mxu branch): the mapping the port documents.
_MXU_ROW = re.compile(r"(lane|mid)-axis mxu m1=(\d+) \(fused twiddle, no transposes\)")


@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
@pytest.mark.parametrize("engine", ["mxu", "pallas"])
def test_describe_against_jax(engine, batched):
    """describe() of the port and of the JAX package on n = 2^14,
    max_fused=32, side by side: the pallas and leaf lines are equal; each
    mxu row line is the port's own (what runs) and maps to JAX's
    "transposed row leaf m1=32" (ROADMAP Queue 3, kept on purpose)."""
    kw = dict(max_fused=32, engine=engine)
    cfg = (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 14)
    port = NTT(NttConfig(*cfg, **kw), enable_inverse=False, device="cpu").describe(batched).splitlines()
    jax_lines = JNTT(JNttConfig(*cfg, **kw), enable_inverse=False).describe(batched).splitlines()
    if engine == "pallas":
        assert port == jax_lines
        return
    root = "mid-axis mxu m1=32 (fused twiddle, no transposes)" if batched else (
        "lane-axis mxu m1=32 (fused twiddle, no transposes)")
    assert port == [
        f"split 16384 = 512 x 32: {root}",
        "  split 512 = 16 x 32: mid-axis mxu m1=32 (fused twiddle, no transposes)",
        "    leaf m=16 engine=mxu",
    ]
    assert jax_lines == [
        "split 16384 = 512 x 32: transposed row leaf m1=32",
        "  split 512 = 16 x 32: transposed row leaf m1=32",
        "    leaf m=16 engine=mxu",
    ]
    assert [_MXU_ROW.sub(r"transposed row leaf m1=\2", line) for line in port] == jax_lines


@pytest.mark.parametrize(
    "kw", [dict(tune=True)], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items())
)
def test_unported_options_raise(kw, tmp_path, monkeypatch):
    """The option that raised while the autotuner was unported now builds:
    ``tune=True`` resolves through ``autotune.tune`` on the NTT's device
    (the CPU races the jnp engine only; the timer is replaced, so no
    timing is taken) into a cache of the test's own."""
    from sventt_tpu_torch.plan import autotune

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "cache.json"))
    monkeypatch.setattr(autotune, "_time_candidate", lambda cfg, s, reps=2, device=None: 1.0)
    ntt = NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12, **kw), device="cpu")
    assert ntt.config.tune is False and ntt.engine == "jnp"
    assert (tmp_path / "cache.json").exists()


@pytest.mark.parametrize(
    "kw",
    [
        dict(engine="jnp"),
        pytest.param(dict(strategy="six_step", engine="jnp"), id="strategy=six_step"),
        dict(plan_spec="pallas:64,jnp"),
        dict(plan_spec="jnp:64,mxu"),
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_jnp_options_run(rng, kw):
    """The jnp options that raised while the portable engine was unported
    now build and run: equal to the native oracle, exact roundtrip."""
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12, **kw)
    ntt = NTT(cfg, device="cpu")
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, native.golden_forward(x, cfg.modulus, cfg.generator))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)


@pytest.mark.parametrize(
    "kw",
    [dict(engine="pallas", max_r=3, modmul="solinas"), dict(modmul="solinas")],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_solinas_options_run(rng, kw):
    """The two Solinas options that raised while the mode was unported now
    build and run: equal to the native oracle, exact roundtrip; max_r=3
    under Solinas is radix-2 (K4/K6, no K7/K8), as in JAX."""
    from sventt_tpu_torch.ops import ntt_pallas

    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 12, **kw)
    ntt = NTT(cfg, device="cpu")
    assert ntt.fc.modmul == "solinas"
    x = rng.integers(0, cfg.modulus, cfg.n, dtype=np.uint64)
    ntt_pallas.reset_counts()
    fwd = ntt.forward_numpy(x)
    np.testing.assert_array_equal(fwd, native.golden_forward(x, cfg.modulus, cfg.generator))
    np.testing.assert_array_equal(ntt.inverse_numpy(fwd), x)
    calls = ntt_pallas.PLAIN_CALLS
    assert calls["grouped"] == calls["lane_grouped"] == 0
    assert (calls["leaf"] > 0 and calls["lane"] > 0) == (cfg.engine == "pallas")


def test_config_validation_matches_jax():
    for bad in (dict(n=3), dict(engine="gpu"), dict(plan_spec="mxu:64"), dict(max_fused=3)):
        args = dict(modulus=FLAGSHIP_MODULUS, generator=FLAGSHIP_GENERATOR, n=1 << 12)
        args.update(bad)
        with pytest.raises(ValueError):
            JNttConfig(**args)
        with pytest.raises(ValueError):
            NttConfig(**args)


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        NTT(NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 10), device="cuda")


def test_default_device_without_card_raises():
    """``device=None`` is the CUDA card: without one, NTT and the public
    table builders raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 10)
    mod = cfg.mod
    with pytest.raises(RuntimeError, match="CUDA"):
        NTT(cfg)
    from sventt_tpu_torch.ops import ntt_pallas

    for build in (
        lambda: ntt_mxu.make_mxu_tables(mod, 8, inverse=False),
        lambda: ntt_pallas.make_leaf_tables(mod, 8, inverse=False),
        lambda: ntt_pallas.make_lane_tables(mod, 8, inverse=True),
        lambda: planner.PlanTables(planner.build_plan(64, "pallas", 8), mod, NTT(cfg, device="cpu").fc, False),
        lambda: fill.device_fill(8, FLAGSHIP_MODULUS),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def _path_strings(path: pathlib.Path) -> list[str]:
    """String constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [
        n.value for n in ast.walk(tree)
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs
    ]


def test_port_imports_no_jax():
    """No module of the port, nor a tool, nor chip_smoke.py, imports jax or sventt_tpu;
    no module of the port names a path into sventt_tpu/, and the native
    sources it compiles (the oracle and the q-series generators) lie in
    the port."""
    files = (sorted((REPO / "sventt_tpu_torch").rglob("*.py")) + sorted((REPO / "tools").glob("*.py"))
             + [REPO / "chip_smoke.py"])
    assert len(files) > 10
    for path in files:
        for name in _imported_modules(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "sventt_tpu"), f"{path}: imports {name}"
    into_jax_pkg = re.compile(r"(^|[/\\])sventt_tpu([/\\]|$)")
    for path in files[:-1]:
        for text in _path_strings(path):
            assert not into_jax_pkg.search(text), f"{path}: path into sventt_tpu/: {text!r}"
    port = (REPO / "sventt_tpu_torch").resolve()
    assert native.SOURCE in native.SOURCES and native.SERIES_SOURCE in native.SOURCES
    for src in native.SOURCES:
        source = pathlib.Path(src).resolve()
        assert source.is_relative_to(port) and source.exists(), src


@pytest.mark.parametrize(
    "kw",
    [dict(engine="mxu"), dict(engine="pallas"), dict(engine="pallas", max_r=3),
     dict(engine="jnp")],
    ids=["mxu", "pallas", "pallas-r3", "jnp"],
)
def test_donate_input_matches_jax(kw):
    """``NTT(donate_input=True)`` releases the caller's tensor (its storage
    is freed) and gives the non-donated output bitwise in both directions,
    on three-level plans (1024 = (8 x 8) x 16); the donated forward equals
    JAX's ``NTT(donate_input=True)``.  A view, or memory shared with numpy,
    cannot be donated."""
    n = 1 << 10
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, max_fused=16, **kw)
    x = np.random.default_rng(n).integers(0, cfg.modulus, n, dtype=np.uint64)
    jcfg = JNttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, n, max_fused=16, **kw)
    want = JNTT(jcfg, enable_inverse=False, donate_input=True).forward_numpy(x)
    kept, donated = NTT(cfg, device="cpu"), NTT(cfg, donate_input=True, device="cpu")
    assert "  split 64 = 8 x 8: " in donated.describe()
    outs = {}
    for direction in ("forward", "inverse"):
        xd = torch.from_numpy(x.view(np.int64)).clone()
        plain = getattr(kept, f"compute_{direction}")(xd)
        assert xd.untyped_storage().nbytes() == n * 8
        outs[direction] = getattr(donated, f"compute_{direction}")(xd)
        assert xd.untyped_storage().nbytes() == 0
        assert torch.equal(outs[direction], plain)
    # (a numpy view of a tensor's memory makes it undonatable: clone first)
    np.testing.assert_array_equal(to_numpy(donated.normalize(outs["forward"].clone())), want)
    np.testing.assert_array_equal(donated.forward_numpy(x), want)  # the call's own copy
    back = donated.compute_inverse(outs["forward"])
    np.testing.assert_array_equal(to_numpy(donated.normalize(back)), x)
    whole = torch.from_numpy(np.concatenate([x, x]).view(np.int64)).clone()
    with pytest.raises(ValueError, match="donate_input"):
        donated.compute_forward(whole[n:])
    with pytest.raises(ValueError, match="donate_input"):
        donated.compute_forward(torch.from_numpy(x.view(np.int64).copy()))
