"""Card-only checks (marker `gpu`): skipped off the card.

Run them on a GPU with:
    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_chip.py
They reuse chip_smoke.py's phases at reduced sizes; chip_smoke.py runs the
same phases at full size.
"""
import importlib.util
import os.path as osp

import pytest

pytestmark = pytest.mark.gpu
ROOT = osp.abspath(osp.join(osp.dirname(__file__), ".."))


@pytest.fixture
def smoke():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/test_chip.py)")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", osp.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_beam_weights_on_card_match_references(smoke):
    smoke.phase_weights(dict(smoke.TINY, n_weights=65536, n_oracle=512))


def test_full_step_on_card(smoke):
    smoke.phase_full_step(dict(smoke.TINY, n_step=65536), rehearse=False)


def test_slam_field_on_card_matches_float64(smoke):
    smoke.phase_slam(dict(smoke.TINY, slam_ticks=50, slam_p=32))
