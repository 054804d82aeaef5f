def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips (with its reason) where there is none")
