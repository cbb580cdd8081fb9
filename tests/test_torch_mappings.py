"""ops/mappings.fold_map_hist (torch) against ans_tpu's
mappings_jax.fold_map_hist, on the conftest datasets and edge values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ans_tpu.constants import fold_max_sigma
from ans_tpu.ops import mappings_jax as mj
from ans_tpu_torch.ops.mappings import fold_map_hist

EDGES = np.array([0, 1, 255, 256, 511, 512, (1 << 16) - 1, 1 << 16,
                  (1 << 24) - 1, 1 << 24, (1 << 31) - 1, 1 << 31,
                  (1 << 32) - 1], dtype=np.uint32)


def _check(x: np.ndarray, fidelity: int):
    length = fold_max_sigma(fidelity)
    jm, jk, jb, jh = mj.fold_map_hist(jnp.asarray(x), fidelity=fidelity,
                                      length=length)
    m, k, low, h = fold_map_hist(torch.from_numpy(x.view(np.int32)),
                                 fidelity=fidelity, length=length)
    np.testing.assert_array_equal(m.numpy().view(np.uint32), np.asarray(jm))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    jb = np.asarray(jb).astype(np.int32)
    np.testing.assert_array_equal(
        low.numpy(), jb[:, 0] | (jb[:, 1] << 8) | (jb[:, 2] << 16))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


@pytest.mark.parametrize("fidelity", range(1, 9))
@pytest.mark.parametrize("name", ["zipf12", "zipf_large", "geometric",
                                  "uniform_small", "wide", "tiny",
                                  "single_sym"])
def test_fold_map_hist(datasets, name, fidelity):
    _check(datasets[name], fidelity)


@pytest.mark.parametrize("fidelity", range(1, 9))
def test_fold_map_hist_edges(fidelity):
    _check(EDGES, fidelity)


def _check_msb(x: np.ndarray):
    from ans_tpu.constants import MSB_MAX_SIGMA
    from ans_tpu_torch.ops.mappings import msb_map_hist
    jm, jk, jb, jh = mj.msb_map_hist(jnp.asarray(x), length=MSB_MAX_SIGMA)
    m, k, low, h = msb_map_hist(torch.from_numpy(x.view(np.int32)),
                                length=MSB_MAX_SIGMA)
    np.testing.assert_array_equal(m.numpy().view(np.uint32), np.asarray(jm))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    jb = np.asarray(jb).astype(np.int32)
    np.testing.assert_array_equal(
        low.numpy(), jb[:, 0] | (jb[:, 1] << 8) | (jb[:, 2] << 16))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


@pytest.mark.parametrize("name", ["zipf12", "zipf_large", "geometric",
                                  "uniform_small", "wide", "tiny",
                                  "single_sym"])
def test_msb_map_hist(datasets, name):
    """msb_map_hist (ANSmsb's device pass) equals mappings_jax's."""
    _check_msb(datasets[name])


def test_msb_map_hist_edges():
    """Each bucket's bounds (x <= 256, 2^16, 2^24 map down a byte less)."""
    more = np.array([257, (1 << 16) + 1, (1 << 24) + 1], dtype=np.uint32)
    _check_msb(np.concatenate([EDGES, more]))
