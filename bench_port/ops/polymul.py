"""polymul: one cyclic product of two polynomials a call; a unit of work is
the call.

Inputs: a ring of pairs ``a``, ``b`` of length n, the first
``coefficients`` share of each random residues below N and the rest zero,
the layout of a product's padding.  Judged against the reference's
cyclic convolution of the pair.
"""

import torch

from bench_port import check, traffic

LIMITS = {"polymul_wrong_words": ("max", 0)}
WORK = {"products": 1}


def make_inputs(mix: dict, config: dict, gen, device) -> dict:
    n = config["n"]
    fill = int(n * mix["coefficients"])
    ab = torch.zeros((2, traffic.RING, n), dtype=torch.int64, device=device)
    ab[:, :, :fill] = traffic.residues((2, traffic.RING, fill), config["modulus"], gen, device)
    return {"a": ab[0], "b": ab[1]}


def steps(system, inputs: dict, i: int) -> list:
    a, b = inputs["a"][i], inputs["b"][i]
    return [("bench.polymul", lambda _: system.polymul(a, b))]


def wrong(outputs: tuple, inputs: dict, i: int, memo: check.Memo) -> dict:
    return {"polymul_wrong_words": check.wrong_words(outputs[0], memo("polymul", i, "a", "b"))}
