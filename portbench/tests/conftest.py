"""Registers the ``cuda`` marker of the benchmark's own tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")
