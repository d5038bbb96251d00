"""PyTorch port, the utilities: the instance cache (``utils/cache.py``), the
chained timer (``utils/timing.py``) and profiling (``utils/profiling.py``).

``phase_breakdown`` walks the plan as the JAX package's does: its labels
are held equal to JAX's for the configs of ``tests/test_utils.py``, with
both timers replaced by a constant (a CPU time says nothing of the card).
One test runs the real timer, at 2^8 points.
"""

import sys
import threading

import pytest
import torch

from sventt_tpu.plan import NTT as JNTT
from sventt_tpu.plan import NttConfig as JNttConfig
from sventt_tpu.utils import profiling as jprofiling
from sventt_tpu_torch.field.modulus import TEST_GENERATOR, TEST_MODULUS
from sventt_tpu_torch.plan import NTT, NttConfig
from sventt_tpu_torch.utils import (
    cache,
    cached_ntt,
    clear_ntt_cache,
    device_fill,
    phase_breakdown,
    time_chained,
    timing,
    trace,
)


def test_cached_ntt_reuses_instance():
    clear_ntt_cache()
    cfg = NttConfig(TEST_MODULUS, TEST_GENERATOR, 64)
    a = cached_ntt(cfg, device="cpu")
    b = cached_ntt(cfg, enable_inverse=False, device="cpu")
    assert a is b
    assert a._fwd_tables is not None and a._inv_tables is not None
    c = cached_ntt(cfg.with_(n=128), device="cpu")
    assert c is not a
    clear_ntt_cache()
    assert cached_ntt(cfg, device="cpu") is not a
    clear_ntt_cache()


def test_cached_ntt_builds_each_key_once_under_threads(monkeypatch):
    """Sixteen threads race two keys (two configs, the CPU named as a
    string and as a ``torch.device``): each key is built once."""
    clear_ntt_cache()
    built = []
    lock = threading.Lock()

    class Fake:
        def __init__(self, config, enable_forward, enable_inverse, *, device):
            with lock:
                built.append((config, device))

    monkeypatch.setattr(cache, "NTT", Fake)
    cfgs = [NttConfig(TEST_MODULUS, TEST_GENERATOR, 64), NttConfig(TEST_MODULUS, TEST_GENERATOR, 128)]
    got = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            cfg = cfgs[i % 2]
            dev = ("cpu", torch.device("cpu"))[i // 2 % 2]
            got[i] = cached_ntt(cfg, device=dev)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        clear_ntt_cache()
    assert len(got) == 16
    assert sorted(c.n for c, _ in built) == [64, 128]
    assert all(got[i] is got[i % 2] for i in range(16))


def test_time_chained_on_the_cpu():
    """The real timer at 2^8 points: a chain of synchronous calls."""
    ntt = NTT(NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 8, engine="jnp"),
              enable_inverse=False, device="cpu")
    step, tables = ntt.forward_step()
    x = device_fill(1 << 8, TEST_MODULUS, "cpu")
    r = time_chained(step, x, tables, seconds=0.02, reps=3, probe_k=2)
    assert r.ms > 0 and len(r.samples) == 3 and r.samples == sorted(r.samples)
    assert 2 <= r.k <= 4096
    assert r.ms == r.samples[1]


def test_time_chained_refuses_other_devices():
    with pytest.raises(ValueError, match="cannot time"):
        time_chained(lambda v: v, torch.zeros(4, dtype=torch.int64, device="meta"))


def _stub(monkeypatch, module):
    class Result:
        ms = 1.0

    calls = []

    def fake(step, x, tables=(), **kw):
        calls.append(tuple((x.hi if hasattr(x, "hi") else x).shape))
        return Result()

    monkeypatch.setattr(module, "time_chained", fake)
    return calls


@pytest.mark.parametrize(
    "kw,jax_kw",
    [
        # the JAX default off the TPU is its jnp engine; the port's is mxu
        (dict(n=1 << 15, engine="jnp"), dict(n=1 << 15)),
        (dict(n=1 << 10, engine="pallas", strategy="six_step", n0=1 << 5, n1=1 << 5),
         dict(n=1 << 10, engine="pallas", strategy="six_step", n0=1 << 5, n1=1 << 5)),
    ],
    ids=["jnp-2^15", "pallas-2^10"],
)
def test_phase_breakdown_labels_match_jax(kw, jax_kw, monkeypatch):
    """The same phases, labels and shapes as the JAX package's
    (``tests/test_utils.py::test_phase_breakdown_walks_the_plan``)."""
    from sventt_tpu.utils import truetime

    port_shapes = _stub(monkeypatch, timing)
    jax_shapes = _stub(monkeypatch, truetime)
    ntt = NTT(NttConfig(TEST_MODULUS, TEST_GENERATOR, **kw), enable_inverse=False, device="cpu")
    jntt = JNTT(JNttConfig(TEST_MODULUS, TEST_GENERATOR, **jax_kw), enable_inverse=False)
    got = phase_breakdown(ntt, seconds=0.05)
    want = jprofiling.phase_breakdown(jntt, seconds=0.05)
    assert list(got) == list(want)
    assert port_shapes == jax_shapes and len(port_shapes) == len(got)
    assert "total" in got and any("col leaf" in k for k in got)
    assert any(k.startswith("level0.rows") for k in got) == (kw.get("engine") == "jnp")


def test_phase_breakdown_walks_the_mxu_plan(monkeypatch):
    """The port's default engine: every level's row step is timed as its
    inter-step multiply, at the plan's shapes ((256 x 16) x 16 here)."""
    shapes = _stub(monkeypatch, timing)
    ntt = NTT(NttConfig(TEST_MODULUS, TEST_GENERATOR, 1 << 12, max_fused=16),
              enable_inverse=False, device="cpu")
    got = phase_breakdown(ntt)
    assert list(got) == ["total", "level0.inter-step tw 256x16", "level1.inter-step tw 16x16",
                         "level2.col leaf m=16"]
    assert shapes == [(4096,), (256, 16), (16, 16, 16), (16, 16, 16)]


def test_trace_writes_a_chrome_trace(tmp_path):
    ntt = NTT(NttConfig(TEST_MODULUS, TEST_GENERATOR, 64, engine="jnp"), device="cpu")
    x = device_fill(64, TEST_MODULUS, "cpu")
    with trace(str(tmp_path)) as prof:
        ntt.compute_forward(x)
    assert prof is not None
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
