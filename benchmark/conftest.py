"""Test settings of the benchmark's own tests (``python -m pytest
benchmark``): the marker of the tests that need a card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
