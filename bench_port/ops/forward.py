"""forward: one forward transform a call; a unit of work is the call.

Inputs: a ring of n residues below N, ``x``.  Judged
against the reference's forward of the input.
"""

from bench_port import check, traffic

LIMITS = {"fwd_wrong_words": ("max", 0)}
#: What a completed unit adds to the window's counts.
WORK = {"transforms": 1}


def make_inputs(mix: dict, config: dict, gen, device) -> dict:
    return {"x": traffic.residues((traffic.RING, config["n"]), config["modulus"], gen, device)}


def steps(system, inputs: dict, i: int) -> list:
    """(span, call) of each call of the unit on ring entry ``i``; a call
    takes the output of the one before it."""
    x = inputs["x"][i]
    return [("bench.forward", lambda _: system.forward(x))]


def wrong(outputs: tuple, inputs: dict, i: int, memo: check.Memo) -> dict:
    return {"fwd_wrong_words": check.wrong_words(outputs[0], memo("forward", i, "x"))}
