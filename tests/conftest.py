

def pytest_configure(config):
    config.addinivalue_line("markers", "slow: slow SPMD subprocess tests")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skipped without one")
