def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU (an H100 for the sm_90a kernels); skips without one",
    )
