"""Checks that need the NVIDIA GPU: chip_smoke.py's phases as tests.

Skip elsewhere. On the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_chip.py
"""
import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; backend is {jax.default_backend()}")


def test_knn_on_card_matches_float64(gpu):
    rep = chip_smoke.phase_knn(timing=False)
    assert set(rep) == {"surf", "edge", "depth"}


def test_ba_precision_on_card(gpu):
    chip_smoke.phase_precision()


def test_pipeline_on_card(gpu):
    rep, _, _ = chip_smoke.phase_pipeline()
    assert rep["restarts"] == 0
