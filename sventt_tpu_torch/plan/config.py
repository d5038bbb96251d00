"""NttConfig: the configuration record of one transform.

The same fields and validation as ``sventt_tpu/plan/config.py``.  The port
runs the matrix engine ("mxu"), the butterfly engine ("pallas", radix-2
or, with ``max_r`` > 1, radix-2^R grouped) and the portable engine
("jnp"), and ``tune=True`` resolves through the port's autotuner
(``plan/autotune.py``).  "auto" is the butterfly engine for one modulus on
a CUDA card, with leaves of up to 512 points (the matrix plan's levels),
and the matrix engine for a multi-modular configuration and on the CPU:
on an H100 the radix-2 kernels run the flagship transform 3.3-4.0x faster
than the int8 tensor-core levels at 2^17 and 2^24 (``plan/wrapper.py``
says more).
The docstrings below are the JAX package's.

The port's own: ``modulus`` and ``generator`` may be equal-length tuples,
one entry a limb, for a multi-modular (RNS) transform of L limbs at once
(``limb_mods``; ``NTT`` then takes (L, n) data, row l over limb l's field).
Every limb must be prime, of 2-adicity at least log2 n, with a generator
of its group.  Such a configuration runs the matrix engine and nothing
else ("auto" cuts its plan at leaves of up to 128 points, ``plan/wrapper.py``
``RNS_MAX_FUSED``): ``engine`` "pallas" or "jnp", ``tune=True`` and
``modmul="solinas"`` are refused here, a plan with another engine or a
row subtree by ``NTT``, and ``parallel.DistributedNTT`` refuses it too.

The reference's configuration system is C++ template parameters -- modulus,
modmul engine, radix per stage, blocking, transpose strategy -- all fixed at
compile time (SURVEY.md section 6, "Config / flag system").  The TPU-native
equivalent is this dataclass: every field is static at jit-trace time, so XLA
specializes exactly like the C++ compiler did.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..field.modulus import Modulus, is_generator, is_probable_prime


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


@dataclass(frozen=True)
class NttConfig:
    """Static plan for one transform length over one prime field.

    Strategies (the reference's kernel/algorithm families, README.md:7-8):

    * ``iterative``  -- all stages over the full vector (reference
      kernel/iterative.hpp); right for lengths whose working set fits VMEM.
    * ``six_step``   -- n = n0*n1 matrix: column NTTs, twiddle, transpose,
      row NTTs, transpose (reference layer/sve/generic.hpp four/six-step).
      On TPU the transposes are XLA/Pallas tile transposes on one chip and
      ICI all-to-alls on a mesh.

    ``engine`` selects the butterfly implementation: ``jnp`` (portable pure
    XLA) or ``pallas`` (fused VMEM kernels); ``auto`` picks pallas on TPU.

    The kernel knobs (``block_b``, ``stages_per_call``, ``lane_rows``,
    ``max_fused``) default to measured static heuristics; ``tune=True``
    replaces them with values selected by the benchmark-driven autotuner
    (plan/autotune.py) -- the TPU-native analogue of the reference choosing
    every template parameter from its measured tuning corpus (reference
    tests/bench-transpose.cpp:105-499, README.md:26-27).
    """

    modulus: int | tuple[int, ...]
    generator: int | tuple[int, ...]
    n: int
    strategy: str = "auto"  # "iterative" | "six_step" | "auto"
    n0: int | None = None  # six-step: column-transform length (matrix rows)
    n1: int | None = None  # six-step: row-transform length (matrix cols)
    lazy: bool | None = None  # None: lazy iff bit_width(N) <= 62
    engine: str = "auto"  # "jnp" | "pallas" | "auto"
    #: Twiddle-multiply engine (reference's PAdic64 vs FixedPoint64 choice):
    #: "montgomery", "shoup" (needs bit_width(N) <= 62), or "auto" (shoup
    #: when the lazy range discipline allows it -- one fewer u64 multiply
    #: per butterfly).
    modmul: str = "auto"
    #: Pallas kernel knobs (None = static defaults in ops/ntt_pallas.py).
    block_b: int | None = None  # sublane/mid kernel lane-tile width
    stages_per_call: int | None = None  # butterfly stages per pallas_call
    lane_rows: int | None = None  # lane-kernel batch-rows block height
    max_fused: int | None = None  # largest fused leaf in the plan tree
    #: Pallas leaves: fold stages into radix-2^max_r grouped bodies (the
    #: reference's radix-4/8 layer structure, layer/sve/radix-eight.hpp);
    #: None/1 = per-stage radix-2 (ops/ntt_pallas.py DEFAULT_MAX_RADIX).
    max_r: int | None = None
    #: jnp engine: VMEM-resident chunk size in elements (None = the
    #: measured default, plan/planner.py JNP_RESIDENT_ELEMS).
    chunk_elems: int | None = None
    #: Pallas leaf stage-twiddle storage layout: "tiled" (full (m/2, b)
    #: butterfly layout per stage, 4x VMEM but plain aligned reads),
    #: "dedup" (only the l distinct rows -- the reference's
    #: store_precomputation memory/compute trade for STAGE tables,
    #: layer/sve/radix-two.hpp:96-138), or "hybrid" (dedup except the
    #: sub-8-row tail stages).  None = "tiled" (static default).
    tw_layout: str | None = None
    #: Store the inter-step twiddle matrix WITHOUT its Montgomery companion
    #: array (the multiply recomputes the companion in flight) -- halves the
    #: dominant HBM table read of large six-step levels at the cost of one
    #: extra u64 low-product per point.  None = size heuristic
    #: (plan/planner.py W_ONLY_THRESHOLD); the TPU analogue of the
    #: reference's store_precomputation=false memory/compute trade
    #: (reference layer/sve/radix-two.hpp:96-138).
    split_w_only: bool | None = None
    #: Transpose strategy for fallback split levels and distributed local
    #: steps.  "auto"/"xla" only: the blocked Pallas alternative (kept in
    #: ops/transpose.py as the benchmarks/bench_transpose.py corpus, the
    #: reference's bench-transpose role, tests/bench-transpose.cpp:105-499)
    #: lost to XLA at EVERY measured shape even as a single pair-kernel
    #: with rectangular tiles (round-5 sweep: best 2354 vs 2806 GB/s at
    #: 1024^2, 3-6x behind at the skewed six-step shapes), so it is not a
    #: public knob.  The default schedules are transpose-free anyway.
    transpose: str = "auto"
    #: Explicit MIXED-ENGINE plan tree, overriding strategy/engine/
    #: max_fused plan construction: a comma list, top-down -- every
    #: element but the last is ``engine:m1`` (one Split level whose ROW
    #: leaf uses that engine at length m1), the last is a bare engine
    #: name for the final column leaf.  E.g. ``"mxu:512,mxu:512,jnp"``
    #: at n = 2^26 = Split(2^26, 2^17, 512-mxu) -> Split(2^17, 2^8,
    #: 512-mxu) -> Leaf(2^8, jnp).  The TPU analogue of the reference's
    #: freely-mixed layer lists in one kernel type expression (reference
    #: tests/ntt-tests/recursive-sve-radix248-two13.hpp); autotunable.
    plan_spec: str | None = None
    #: Resolve knobs via the measure-and-cache autotuner at NTT build time.
    tune: bool = False

    # largest transform the iterative strategy handles before auto switches
    # to six-step (working set 16*n bytes vs ~16 MB VMEM, leave headroom)
    ITERATIVE_MAX: int = field(default=1 << 13, repr=False)

    def __post_init__(self):
        if not _is_pow2(self.n) or self.n < 2:
            raise ValueError("n must be a power of two >= 2")
        if self.rns:
            self._check_limbs()
        else:
            mod = self.mod
            if (mod.modulus - 1) % self.n:
                raise ValueError(
                    f"modulus lacks 2-adicity {self.n.bit_length() - 1} "
                    f"(has {mod.two_adicity})"
                )
        if self.strategy not in ("auto", "iterative", "six_step"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.engine not in ("auto", "jnp", "pallas", "mxu"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.modmul not in ("auto", "montgomery", "shoup", "solinas"):
            raise ValueError(f"unknown modmul engine {self.modmul!r}")
        if self.modmul == "solinas":
            from ..field.limb import solinas_capable

            if not solinas_capable(self.modulus):
                raise ValueError(
                    "solinas modmul requires a sparse-high modulus "
                    "N = 2^64 - (c*2^s - 1), bit_width(c*2^s) <= 42"
                )
        if self.transpose not in ("auto", "xla"):
            raise ValueError(
                f"unknown transpose strategy {self.transpose!r} (the blocked "
                "pallas transpose lost to XLA at every measured shape and "
                "lives in benchmarks/bench_transpose.py only)"
            )
        for name in ("block_b", "stages_per_call", "lane_rows", "max_fused", "chunk_elems"):
            v = getattr(self, name)
            if v is not None and (v < 1 or (name != "stages_per_call" and not _is_pow2(v))):
                raise ValueError(f"{name} must be a positive power of two, got {v}")
        if self.max_r is not None and not 1 <= self.max_r <= 4:
            raise ValueError(f"max_r must be in 1..4, got {self.max_r}")
        if self.tw_layout is not None and self.tw_layout not in (
            "tiled", "dedup", "hybrid"
        ):
            raise ValueError(f"unknown tw_layout {self.tw_layout!r}")
        if self.strategy == "six_step" or (
            self.strategy == "auto" and self.n > self.ITERATIVE_MAX
        ):
            n0, n1 = self.split
            if n0 * n1 != self.n or not (_is_pow2(n0) and _is_pow2(n1)):
                raise ValueError("n0 * n1 must equal n (powers of two)")
        if self.plan_spec is not None:
            from . import planner

            planner.build_plan_spec(self.n, self.plan_spec)  # validates

    def _check_limbs(self) -> None:
        """Each limb of a tuple configuration, and what such a
        configuration does not run."""
        if not (isinstance(self.modulus, tuple) and isinstance(self.generator, tuple)
                and len(self.modulus) == len(self.generator) and self.modulus):
            raise ValueError("an RNS config takes modulus and generator as non-empty tuples "
                             "of one length, one entry a limb")
        log2n = self.n.bit_length() - 1
        for i, (q, g) in enumerate(zip(self.modulus, self.generator)):
            if not (isinstance(q, int) and isinstance(g, int) and 2 < q < 1 << 64):
                raise ValueError(f"limb {i}: modulus {q!r} and generator {g!r} must be ints, "
                                 "the modulus in (2, 2^64)")
            if not is_probable_prime(q):
                raise ValueError(f"limb {i}: modulus {q:#x} is not prime")
            mod = Modulus(q, g)
            if mod.two_adicity < log2n:
                raise ValueError(f"limb {i}: modulus {q:#x} lacks 2-adicity {log2n} "
                                 f"(has {mod.two_adicity})")
            if not is_generator(q, g):
                raise ValueError(f"limb {i}: {g} does not generate the group of Z/{q:#x}")
        if self.engine not in ("auto", "mxu"):
            raise ValueError(f"engine={self.engine!r} is not supported on an RNS config "
                             "(the matrix engine, 'auto' or 'mxu', runs every limb at once)")
        if self.tune:
            raise ValueError("tune=True is not supported on an RNS config")
        if self.modmul == "solinas":
            raise ValueError("modmul='solinas' is not supported on an RNS config")

    @property
    def rns(self) -> bool:
        """Whether the configuration is multi-modular: tuples of moduli and
        generators, one a limb."""
        return isinstance(self.modulus, tuple) or isinstance(self.generator, tuple)

    @property
    def limb_mods(self) -> tuple[Modulus, ...]:
        """One Modulus a limb: a tuple configuration's, or the one modulus."""
        if not self.rns:
            return (self.mod,)
        return tuple(Modulus(q, g) for q, g in zip(self.modulus, self.generator))

    @property
    def mod(self) -> Modulus:
        if self.rns:
            raise ValueError("an RNS config has a modulus a limb (limb_mods), not one mod")
        return Modulus(self.modulus, self.generator)

    @property
    def resolved_strategy(self) -> str:
        if self.strategy != "auto":
            return self.strategy
        return "iterative" if self.n <= self.ITERATIVE_MAX else "six_step"

    @property
    def split(self) -> tuple[int, int]:
        """(n0, n1) for six-step; balanced by default with n1 >= n0, matching
        the reference flagship 2^17 = 2^8 x 2^9 (README.md:18-68)."""
        if self.n0 is not None and self.n1 is not None:
            return self.n0, self.n1
        log2n = self.n.bit_length() - 1
        n0 = 1 << (log2n // 2)
        return n0, self.n // n0

    def with_(self, **kw) -> "NttConfig":
        return replace(self, **kw)
