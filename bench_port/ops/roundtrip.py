"""roundtrip: calls alternate, the forward of an input, then the inverse of
that output; a unit of work is the pair.

Judged in both directions: the forward output against the reference's
forward of the input, and the inverse output against the input, which is
the reference's inverse of the forward output where that forward was
right; where it was not, the reference's inverse of the program's own
forward output.
"""

from bench_port import check
from bench_port.ops import forward

LIMITS = {"fwd_wrong_words": ("max", 0), "inv_wrong_words": ("max", 0)}
WORK = {"transforms": 2}
make_inputs = forward.make_inputs


def steps(system, inputs: dict, i: int) -> list:
    x = inputs["x"][i]
    return [("bench.forward", lambda _: system.forward(x)),
            ("bench.inverse", system.inverse)]


def wrong(outputs: tuple, inputs: dict, i: int, memo: check.Memo) -> dict:
    y, z = outputs
    bad = check.wrong_words(y, memo("forward", i, "x"))
    x = inputs["x"][i]
    want = x if bad == 0 or y.shape != x.shape else memo.reference.inverse(y)
    return {"fwd_wrong_words": bad, "inv_wrong_words": check.wrong_words(z, want)}
