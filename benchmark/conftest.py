"""The benchmark's tests (benchmark/tests/): the marker of those that need the card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card (TF32, the port's CUDA kernels); skips "
        "without CUDA")
