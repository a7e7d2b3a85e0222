"""pytest settings of the benchmark's own tests (vdbench/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
