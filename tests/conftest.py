import os
import sys

# tests must see the single real CPU device (the 512-device override is
# dryrun.py-local, never global).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (tests/test_torch_cuda_*.py); "
                   "skips without one")
