"""The benchmark's own tests, on the CPU at tiny sizes. A test that needs
the card carries the ``card`` marker and skips inside itself where there
is none. They import neither JAX nor the JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")
