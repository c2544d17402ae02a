#!/bin/bash
# Run the test suite on the CPU (8 virtual devices, float64; see
# tests/conftest.py). Extra arguments go to pytest.
#
# Tests marked `gpu` skip here; on a GPU machine run them with
#   GCM_TEST_GPU=1 python -m pytest -m gpu tests/
cd "$(dirname "$0")/.."
JAX_PLATFORMS=cpu exec python -m pytest tests/ -q "$@"
