"""rns_polymul: one multi-modular cyclic product a call, every limb of two
(L, n) polynomials at once; a unit of work is the call.

Inputs: a ring of pairs ``a``, ``b`` of shape (L, n), L the configuration's
``moduli``: in limb l the first ``coefficients`` share of the length
uniform residues below q_l and the rest zero, the layout of a product's
padding.  Judged against the reference's product, limb by limb, word for
word.
"""

import torch

from bench_port import check, traffic

LIMITS = {"rns_polymul_wrong_words": ("max", 0)}
#: What a completed unit adds to the window's counts.  ``make_inputs`` adds
#: ``limb_products``, the configuration's limbs, so that a reader counts
#: the bytes of every limb's product.
WORK = {"products": 1}


def make_inputs(mix: dict, config: dict, gen, device) -> dict:
    n, moduli = config["n"], config["moduli"]
    WORK["limb_products"] = len(moduli)
    fill = int(n * mix["coefficients"])
    ab = torch.zeros((2, traffic.RING, len(moduli), n), dtype=torch.int64, device=device)
    for i, q in enumerate(moduli):
        ab[:, :, i, :fill] = traffic.residues((2, traffic.RING, fill), q, gen, device)
    return {"a": ab[0], "b": ab[1]}


def steps(system, inputs: dict, i: int) -> list:
    a, b = inputs["a"][i], inputs["b"][i]
    return [("bench.polymul", lambda _: system.polymul(a, b))]


def wrong(outputs: tuple, inputs: dict, i: int, memo: check.Memo) -> dict:
    return {"rns_polymul_wrong_words": check.wrong_words(outputs[0],
                                                         memo("polymul", i, "a", "b"))}
