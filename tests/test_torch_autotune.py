"""The port's tile lookups (``repro_torch.kernels.autotune``) against the
reference's (``repro.kernels.autotune``, its sweep cache empty) over a grid
of head dims, cache lengths and verify depths: equal answers everywhere.
"""
import itertools

import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import autotune as at
from repro_torch.kernels import cuda_build

HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 192, 256, 512)
S_MAXES = (1, 7, 32, 48, 64, 96, 250, 256, 290, 384, 512, 1000, 1024, 2048,
           2080, 4096, 32768)
GAMMAS = (1, 2, 4, 5, 8, 16)


@pytest.fixture(autouse=True)
def empty_sweep_cache():
    jat.clear_sweep_cache()
    yield
    jat.clear_sweep_cache()


def test_tables_equal_the_reference():
    assert at.CANDIDATE_BLOCK_K == jat.CANDIDATE_BLOCK_K
    assert at.CANDIDATE_G_PAD == jat.CANDIDATE_G_PAD
    assert at._HEURISTIC_TABLE == jat._HEURISTIC_TABLE


@pytest.mark.parametrize("s_max", S_MAXES)
def test_candidates_and_heuristic_equal_the_reference(s_max):
    assert at.candidate_block_ks(s_max) == jat.candidate_block_ks(s_max)
    for d in HEAD_DIMS:
        assert at.heuristic_block_k(d, s_max) == \
            jat.heuristic_block_k(d, s_max), d
        assert at.decode_tile(d, s_max) == jat.decode_tile(d, s_max), d


@pytest.mark.parametrize("gamma", GAMMAS)
def test_verify_tile_equals_the_reference(gamma):
    for d, s in itertools.product(HEAD_DIMS, S_MAXES):
        assert at.verify_tile(d, s, gamma) == jat.verify_tile(d, s, gamma), \
            (d, s)


def test_kernels_supported_needs_a_card_and_built_kernels(monkeypatch):
    assert at.kernels_supported() is False          # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = {n: cuda_build.library_path(n).exists()
             for n in cuda_build.KERNELS}
    assert at.kernels_supported() is all(built.values())
