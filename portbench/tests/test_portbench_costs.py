"""The cost functions against the bounds PERF.md's kernel table gives, and
the live counting on hand-made inputs."""

import numpy as np
import pytest

from portbench.costs import kernels
from portbench.costs import model as flops


def test_k1_int8_bound_matches_the_kernel_table():
    # B 1024, T 250, H 16, Dh 16, pos 95, every row live: 0.01909 ms
    assert kernels.k1_int8_s(1024, 95, 16, 16) * 1e3 == pytest.approx(0.01909, rel=2e-4)


def test_k4_bound_matches_the_kernel_table():
    # B 160, N 128, Hm 256, 465,412 live pairs: 0.1879 ms (operations)
    t = kernels.k4_s(465_412, 160 * 128, 160 * 128 * 128, 256)
    assert t * 1e3 == pytest.approx(0.1879, rel=2e-4)


def test_dead_rows_and_padding_cost_nothing():
    assert kernels.k1_int8_s(0, 95, 16, 16) == 0.0
    assert kernels.k1_int8_s(512, 95, 16, 16) == pytest.approx(kernels.k1_int8_s(1024, 95, 16, 16) / 2)


def test_live_tokens_stop_at_each_rows_stop():
    stop = 1
    rows = np.array([[2, 5, 6, stop, 0, 0],
                     [2, stop, 0, 0, 0, 0],
                     [2, 5, 5, 5, 5, 5]])
    assert flops.live_length(rows, stop).tolist() == [4, 2, 6]
    d, n = 8, 2
    brute = sum(n * (24 * d * d + 4 * (t + 1) * d) for length in (4, 2, 6) for t in range(length))
    assert flops.trunk_flops([4, 2, 6], d, n) == pytest.approx(brute)


def test_live_pairs_are_distinct_real_atoms_within_the_cutoff():
    atoms = np.array([[6, 6, 8, 0], [1, 0, 0, 0]])
    coords = np.zeros((2, 4, 3), np.float32)
    coords[0, 1, 0] = 1.0   # 1 A from atom 0
    coords[0, 2, 0] = 7.0   # 7 A from atom 0, 6 from atom 1
    coords[0, 3, 0] = 0.5   # padding, inside the cutoff of everyone
    real, pairs = flops.live_geometry(atoms, coords, 5.0)
    assert real == 4
    assert pairs == 2  # (0, 1) and (1, 0); the lone atom of row 1 has no partner


def test_decode_counts_each_rows_own_steps():
    d, n, v = 8, 2, 10
    one = flops.decode_flops([3], d, n, v)
    assert flops.decode_flops([3, 3], d, n, v) == pytest.approx(2 * one)
    assert one == pytest.approx(n * (24 * d * d + 4 * 4 * d) + 2 * d * v)
