"""Tests of the benchmark.  ``card`` marks the tests that need a CUDA card;
they decide inside the test and skip without one:

    python -m pytest bench_port/tests -q            # here, on the CPU
    python -m pytest bench_port/tests -q -m card    # on the card
"""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
