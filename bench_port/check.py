"""The check that decides ``correct``: the window's kept outputs against the
plain reference, word for word.

Every number compared is a count, and the arithmetic is exact, so each
limit is 0 words wrong (a control that computes the transform in float64
reads millions).  Each op (``ops/<op>.py``) names its own numbers and
limits in ``LIMITS`` and judges a kept unit in ``wrong``; the two below
hold for every op.
"""

from __future__ import annotations

import torch

#: The checks of every op and their limits: ("max", v) fails above v,
#: ("min", v) below.
COMMON = {
    "failed_calls": ("max", 0),
    "outputs_compared": ("min", 1),
}


def wrong_words(a: torch.Tensor, b: torch.Tensor) -> int:
    """Words of ``a`` that differ from ``b``; all of them where the shapes do."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum().item())


class Memo:
    """The reference's answers on the ring's inputs, each computed once:
    ``memo("forward", i, "x")`` is ``reference.forward(inputs["x"][i])``."""

    def __init__(self, reference, inputs: dict):
        self.reference, self.inputs, self._done = reference, inputs, {}

    def __call__(self, method: str, i: int, *names: str):
        key = (method, i, names)
        if key not in self._done:
            args = [self.inputs[name][i] for name in names]
            self._done[key] = getattr(self.reference, method)(*args)
        return self._done[key]


def compare(samples: list, inputs: dict, reference, failed: int, op) -> dict:
    """{name: value} of the numbers compared, and ``wrong_outputs``: the
    kept units with a word wrong.  A sample is (ring index, outputs)."""
    out = {"failed_calls": failed, "outputs_compared": 0, "wrong_outputs": 0}
    memo = Memo(reference, inputs)
    for i, outputs in samples:
        wrong = op.wrong(outputs, inputs, i, memo)
        for name, v in wrong.items():
            out[name] = out.get(name, 0) + v
        out["outputs_compared"] += len(wrong)
        out["wrong_outputs"] += any(wrong.values())
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": v, "max" | "min": limit}}): the op's
    ``limits`` first, then COMMON.  A number of the op that no kept unit
    reached reads 0."""
    checks, ok = {}, True
    for name, (rule, limit) in {**limits, **COMMON}.items():
        v = values.get(name, 0)
        checks[name] = {"value": v, rule: limit}
        ok &= v <= limit if rule == "max" else v >= limit
    return ok, checks
