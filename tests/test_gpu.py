"""Checks that need the card (marker `gpu`; they skip elsewhere). Each is
a phase of chip_smoke.py at a reduced size; run them on the card with
JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_dense_fit_predict_and_residual():
    chip_smoke.phase_dense(n=4096, d=8, steps=3, m=256, nb=2048)


def test_oracle_agreement():
    chip_smoke.phase_oracle(n=2048, d=4, m=128)


def test_fused_matvec_against_xla():
    chip_smoke.phase_iterative(n=32768, d=8, steps=1, m=16)


def test_many_chain_hmc():
    chip_smoke.phase_sampler(n=256, chains=64)
