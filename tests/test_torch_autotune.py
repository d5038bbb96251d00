"""PyTorch port, the autotuner (``plan/autotune.py``) against sventt_tpu's.

The machinery only: candidate enumeration, winner selection, the cache and
its keys, the playoff, verification, and that every raced candidate runs
something the others do not.  Timing quality is judged on the card
(``chip_smoke.py`` [autotune], ``tools/tune_h100.py``); here the timer is
replaced by a cost model or a constant.  Where the port and the JAX package
compute the same thing (candidate lists, keys, the tuned CPU transform) they
are held equal, tolerance zero.
"""

import json

import numpy as np
import pytest

from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu.plan import autotune as jautotune
from sventt_tpu_torch.field.modulus import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
)
from sventt_tpu_torch.ops import ntt_pallas
from sventt_tpu_torch.plan import NTT, NttConfig, autotune

GOLDILOCKS = (2**64 - 2**32 + 1, 7)


def _cfg(n=1 << 10, **kw):
    return NttConfig(TEST_MODULUS, TEST_GENERATOR, n, **kw)


def _const(ms=1.0):
    return lambda cfg, seconds, reps=2, device=None: ms


def test_fields_match_jax():
    assert autotune.KNOB_FIELDS == jautotune.KNOB_FIELDS
    assert autotune.CONSTRAINT_FIELDS == jautotune.CONSTRAINT_FIELDS
    assert autotune.PLAYOFF_MARGIN == jautotune.PLAYOFF_MARGIN
    assert autotune.PLAYOFF_ROUNDS == jautotune.PLAYOFF_ROUNDS
    assert autotune.JNP_KNOB_GRID == jautotune.JNP_KNOB_GRID


@pytest.mark.parametrize(
    "N,g,kw",
    [
        (TEST_MODULUS, TEST_GENERATOR, {}),
        (TEST_MODULUS, TEST_GENERATOR, dict(lazy=False)),
        (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, {}),
        (*GOLDILOCKS, {}),
        (FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, dict(modmul="solinas")),
        (TEST_MODULUS, TEST_GENERATOR, dict(modmul="shoup")),
    ],
    ids=["test", "test-eager", "flagship", "goldilocks", "pinned-solinas", "pinned-shoup"],
)
def test_modmul_candidates_match_jax(N, g, kw):
    got = autotune._modmul_candidates(NttConfig(N, g, 1 << 12, **kw))
    assert got == jautotune._modmul_candidates(JNttConfig(N, g, 1 << 12, **kw))


def test_plan_spec_candidates_match_jax():
    for log2n in range(4, 31):
        assert autotune._plan_spec_candidates(1 << log2n) == jautotune._plan_spec_candidates(
            1 << log2n
        )


@pytest.mark.parametrize(
    "kw",
    [{}, dict(engine="pallas"), dict(modmul="shoup", block_b=64), dict(plan_spec="mxu:32,jnp"),
     dict(strategy="six_step", n0=16, n1=64, lazy=False)],
    ids=["free", "engine", "modmul+block_b", "plan_spec", "split"],
)
def test_cache_key_matches_jax(kw, monkeypatch):
    """The key is JAX's format: equal to it apart from its backend and
    device kind fields, which here are "cpu" and "cpu"."""
    monkeypatch.setattr(jautotune, "_backend", lambda: "BACKEND")
    monkeypatch.setattr(jautotune, "_device_kind", lambda: "KIND")
    got = autotune.cache_key(_cfg(1 << 10, **kw), "cpu")
    want = jautotune.cache_key(JNttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 10, **kw))
    assert got == want.replace(":BACKEND:KIND", ":cpu:cpu")


def test_cache_key_pins_constraints():
    free = autotune.cache_key(_cfg(1 << 10), "cpu")
    pinned = autotune.cache_key(_cfg(1 << 10, engine="pallas"), "cpu")
    assert free != pinned
    assert "engine=pallas" in pinned
    assert free.count(":") == 4
    assert autotune.cache_key(_cfg(1 << 10, modmul="shoup"), "cpu") != pinned


def test_tune_cpu_picks_jnp_and_caches(tmp_path, monkeypatch):
    """On the CPU the tuner races the jnp engine only and persists its
    winner; a second call hits the cache and never searches."""
    cache = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "_time_candidate", _const())
    cfg = _cfg(1 << 10, tune=True)
    tuned = autotune.tune(cfg, device="cpu", cache_path=cache)
    assert tuned.tune is False
    assert tuned.engine == "jnp"
    assert tuned.modmul in ("montgomery", "shoup")
    [entry] = json.loads(cache.read_text()).values()
    assert entry["knobs"]["engine"] == "jnp"

    def boom(*a, **k):
        raise AssertionError("search ran on a cache hit")

    monkeypatch.setattr(autotune, "search", boom)
    assert autotune.tune(cfg, device="cpu", cache_path=cache) == tuned
    assert autotune.tune(cfg.with_(n=1 << 11), device="cpu", cache_path=cache,
                         on_miss="skip") == cfg.with_(n=1 << 11, tune=False)


def test_staged_search_selects_measured_minimum(monkeypatch):
    """A pallas candidate space under a synthetic cost model: the greedy
    coordinate descent lands on the cost minimum, over the port's grids."""
    monkeypatch.setattr(autotune, "_engine_candidates", lambda cfg, device=None: ["pallas"])
    monkeypatch.setattr(autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"])

    def fake_time(cfg, seconds, reps=2, device=None):
        cost = 10.0
        if cfg.modmul == "shoup":
            cost -= 1.0
        if cfg.max_fused == 64:
            cost -= 0.5
        if cfg.block_b == 16:
            cost -= 0.25
        if cfg.stages_per_call == 2:
            cost -= 0.25
        if cfg.lane_rows == 16:
            cost -= 0.125
        return cost

    monkeypatch.setattr(autotune, "_time_candidate", fake_time)
    best, best_ms, timings = autotune.search(_cfg(1 << 14, engine="pallas"), device="cpu")
    assert (best.modmul, best.max_fused, best.block_b, best.stages_per_call, best.lane_rows) == (
        "shoup", 64, 16, 2, 16)
    assert best_ms == 10.0 - 2.125
    assert "pallas/montgomery" in timings and "pallas/shoup" in timings


def test_search_survives_failing_candidates(monkeypatch):
    monkeypatch.setattr(autotune, "_engine_candidates", lambda cfg, device=None: ["pallas"])
    monkeypatch.setattr(autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"])

    def flaky(cfg, seconds, reps=2, device=None):
        if cfg.modmul == "shoup" or cfg.block_b == 16:
            raise RuntimeError("launch failed")
        return 5.0

    monkeypatch.setattr(autotune, "_time_candidate", flaky)
    best, _, timings = autotune.search(_cfg(1 << 12, engine="pallas"), device="cpu")
    assert best.modmul == "montgomery"
    assert best.block_b != 16
    assert timings["pallas/shoup"] == float("inf") and timings["block_b=16"] == float("inf")

    monkeypatch.setattr(autotune, "_time_candidate", lambda *a, **k: 1 / 0)
    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.search(_cfg(1 << 12, engine="pallas"), device="cpu")


def test_tune_true_resolves_via_wrapper_like_jax(tmp_path, monkeypatch):
    """``NTT(tune=True, device="cpu")`` and JAX's ``NTT(tune=True)`` on the
    CPU both pick the jnp engine; their normalized outputs are equal."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "port.json"))
    monkeypatch.setenv(jautotune.CACHE_ENV, str(tmp_path / "jax.json"))
    monkeypatch.setattr(autotune, "_time_candidate", _const())
    monkeypatch.setattr(jautotune, "_time_candidate", lambda cfg, iters, reps=2: 1.0)
    n = 1 << 10
    ntt = NTT(_cfg(n, tune=True), device="cpu")
    jntt = JNTT(JNttConfig(TEST_MODULUS, TEST_GENERATOR, n, tune=True))
    assert ntt.config.tune is False and ntt.config.engine == jntt.config.engine == "jnp"
    assert ntt.config.modmul == jntt.config.modmul
    x = np.random.default_rng(14).integers(0, TEST_MODULUS, n, dtype=np.uint64)
    out = ntt.forward_numpy(x)
    np.testing.assert_array_equal(out, jntt.forward_numpy(x))
    np.testing.assert_array_equal(ntt.inverse_numpy(out), x)


def test_playoff_finalist_selection(monkeypatch):
    """Near-tied candidates are re-raced interleaved on the card; the
    playoff winner is returned even when the greedy pass ranked it second."""
    monkeypatch.setattr(autotune, "_backend", lambda device=None: "cuda")
    monkeypatch.setattr(autotune, "_engine_candidates", lambda cfg, device=None: ["jnp"])
    monkeypatch.setattr(autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"])
    costs = {"montgomery": 1.05, "shoup": 1.0}
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda cfg, seconds, reps=2, device=None: costs[cfg.modmul])
    seen = {}

    def fake_playoff(finalists, seconds, timings, device=None):
        seen["tags"] = [tag for tag, _ in finalists]
        winner = next(cfg for tag, cfg in finalists if cfg.modmul == "montgomery")
        return winner, 0.9

    monkeypatch.setattr(autotune, "_playoff", fake_playoff)
    best, best_ms, _ = autotune.search(_cfg(1 << 10), device="cpu")
    assert best.modmul == "montgomery" and best_ms == 0.9
    assert seen["tags"] == ["jnp/shoup", "jnp/montgomery"]


def test_playoff_skipped_when_clear_winner(monkeypatch):
    monkeypatch.setattr(autotune, "_backend", lambda device=None: "cuda")
    monkeypatch.setattr(autotune, "_engine_candidates", lambda cfg, device=None: ["jnp"])
    monkeypatch.setattr(autotune, "_modmul_candidates", lambda cfg: ["montgomery", "shoup"])
    costs = {"montgomery": 2.0, "shoup": 1.0}
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda cfg, seconds, reps=2, device=None: costs[cfg.modmul])

    def boom(*a, **k):
        raise AssertionError("playoff ran with a clear winner")

    monkeypatch.setattr(autotune, "_playoff", boom)
    best, _, _ = autotune.search(_cfg(1 << 10), device="cpu")
    assert best.modmul == "shoup"


def test_playoff_takes_the_median_of_its_rounds(monkeypatch):
    """Each finalist's score is the median of its rounds (of two rounds,
    their mean; JAX's ``ms_list[len // 2]`` takes the larger, which would
    have picked B here)."""
    times = {"a": iter([3.0, 1.0]), "b": iter([2.0, 2.2])}
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda cfg, seconds, reps=2, device=None: next(times[cfg]))
    timings = {}
    winner, ms = autotune._playoff([("A", "a"), ("B", "b")], 0.1, timings, "cpu")
    assert (winner, ms) == ("a", 2.0)
    assert timings == {"playoff:A": 2.0, "playoff:B": 2.1}


def test_cpu_tune_does_not_write_repo_cache(tmp_path, monkeypatch):
    # the port's own shipped file, not the JAX package's
    assert autotune._DEFAULT_CACHE.parent.name == "sventt_tpu_torch"
    assert autotune._DEFAULT_CACHE != jautotune._DEFAULT_CACHE
    assert autotune.CACHE_ENV != jautotune.CACHE_ENV
    fake_default = tmp_path / "repo_cache.json"
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", fake_default)
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.setattr(autotune, "_time_candidate", _const())
    tuned = autotune.tune(_cfg(1 << 10, tune=True), device="cpu")
    assert tuned.engine == "jnp"
    assert not fake_default.exists()
    explicit = tmp_path / "explicit.json"
    autotune.tune(_cfg(1 << 10, tune=True), device="cpu", cache_path=explicit)
    assert explicit.exists()


def test_verify_winner(monkeypatch):
    """The same transform under other knobs passes; another generator is
    another transform and is refused."""
    base = _cfg(1 << 8, tune=True)
    autotune._verify_winner(base, base.with_(tune=False, engine="jnp", modmul="shoup"), "cpu")
    autotune._verify_winner(base, base.with_(tune=False, engine="pallas", block_b=8), "cpu")
    bad = NttConfig(TEST_MODULUS, 11, 1 << 8)
    with pytest.raises(AssertionError, match="elementwise"):
        autotune._verify_winner(base, bad, "cpu")


@pytest.mark.parametrize("log2n", [12, 17, 24])
def test_every_raced_candidate_changes_what_runs(log2n, monkeypatch):
    """The card's race (three engines) at the flagship sizes: every timed
    candidate's footprint -- its plan, launch geometry and tables' forms --
    differs from every other's, no grid value is refused by the launch
    geometry, and the knob values that change nothing are not timed."""
    monkeypatch.setattr(autotune, "_engine_candidates",
                        lambda cfg, device=None: ["jnp", "pallas", "mxu"])
    raced = []
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda cfg, s, reps=2, device=None: raced.append(cfg) or 9.0 - len(raced) / 64)
    refused = []
    footprint = autotune._footprint

    def checked(cfg, device=None):
        try:
            return footprint(cfg, device)
        except ValueError:
            refused.append(cfg)
            raise

    monkeypatch.setattr(autotune, "_footprint", checked)
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << log2n)
    _, _, timings = autotune.search(cfg, device="cpu")
    prints = [footprint(c, "cpu") for c in raced]
    assert len(set(prints)) == len(prints) == len(timings)
    assert not refused
    assert {c.engine for c in raced} == {"jnp", "pallas", "mxu"}
    assert all(c.tw_layout is None for c in raced)
    assert all(c.block_b is None for c in raced if c.engine == "mxu")


def test_footprint_sees_what_changes():
    """Knob values that reach no launch leave the footprint as it is;
    values that change a launch's geometry, the launches or the plan
    change it (flagship 2^24: leaves of 256 x 65536, 8 stages)."""
    cfg = NttConfig(FLAGSHIP_MODULUS, FLAGSHIP_GENERATOR, 1 << 24, engine="pallas")
    fp = autotune._footprint(cfg, "cpu")
    default_cols = ntt_pallas.butterfly_geometry(256, 0, 8, False, 65536).cols
    same = [dict(tw_layout="dedup"), dict(block_b=default_cols), dict(stages_per_call=8),
            dict(max_r=1), dict(max_fused=256), dict(chunk_elems=1 << 20)]
    for kw in same:
        assert autotune._footprint(cfg.with_(**kw), "cpu") == fp, kw
    for kw in (dict(block_b=default_cols // 2), dict(stages_per_call=4), dict(max_r=3),
               dict(max_fused=64), dict(split_w_only=True), dict(lane_rows=2),
               dict(modmul="solinas")):
        assert autotune._footprint(cfg.with_(**kw), "cpu") != fp, kw
    mxu = cfg.with_(engine="mxu")
    assert autotune._footprint(mxu.with_(block_b=256), "cpu") == autotune._footprint(mxu, "cpu")
    with pytest.raises(ValueError):  # a tile beyond shared memory
        autotune._footprint(cfg.with_(block_b=1024), "cpu")
