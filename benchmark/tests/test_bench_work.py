"""The roofline's work counts at known shapes, and the layer files that call
them with a call's arguments."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, peaks, work


def test_pippenger_count_by_hand():
    # n = 4, c = 2: W = 127 windows, each 4 mixed adds and 4 full adds;
    # 126 joins of 2 doublings and an add
    assert work.pippenger_products(4, 2) == 127 * (4 * 11 + 4 * 16) + 126 * (2 * 7 + 16)


@pytest.mark.parametrize("log_n,c", [(12, 9), (16, 13), (20, 16), (24, 20)])
def test_best_window(log_n, c):
    n = 1 << log_n
    assert work.best_window(n) == c
    assert all(work.pippenger_products(n, c) <= work.pippenger_products(n, d)
               for d in range(1, 25))


def test_msm_work_at_2_20():
    muls, nbytes = work.msm_work(1 << 20)
    products = 16 * ((1 << 20) * 11 + (1 << 16) * 16) + 15 * (16 * 7 + 16)
    assert muls == products * 600
    assert nbytes == (1 << 20) * (96 + 32) + 96
    # about 7.2 ms at the integer peak: the compute bound, not the bytes
    assert peaks.bound_seconds(muls, nbytes) == pytest.approx(products * 600 / 16.75e12)
    assert 7.0e-3 < peaks.bound_seconds(muls, nbytes) < 7.4e-3


def test_multi_msm_shares_the_base():
    one, nb1 = work.msm_work(4096)
    eight, nb8 = work.msm_work(4096, 8)
    assert eight == 8 * one
    assert nb8 == 4096 * 96 + 8 * (4096 * 32 + 96)


def test_poseidon_counts():
    # the least form at t = 3: 8 full rounds of 3 s-boxes and 3 rows, 31
    # partial rounds of one s-box, one row and 2 products
    sbox = 4 * (72 + 136) + 272
    row = 3 * 128 + 136
    assert work.poseidon_ops(3) == 8 * 3 * (sbox + row) + 31 * (sbox + row + 2 * 272) == 106184
    assert work.sponge_permutations(2, 2, 1) == 1
    assert work.sponge_permutations(2, 5, 1) == 3
    assert work.sponge_permutations(4, 5, 5) == 3
    assert work.sponge_work(32768, 2, 2, 1) == (32768 * 106184, 32768 * 3 * 32)


def test_epoch_program_count():
    assert work.epoch_program_work(8, 4096) == (12 * 8 * 4096 * 272,
                                                2 * 8 * 4096 * 32 + 12 * 4096 * 36)


def test_layers_count_from_the_call_arguments():
    layers = harness.Benchmark().layers()
    scal = torch.zeros((16, 8, 4096), dtype=torch.int32)
    assert layers["msm"].work("snarkos_tpu_torch.ops.msm:msm_affine_multi",
                              {"scalar_limbs": scal}) == work.msm_work(4096, 8)
    assert layers["msm"].work("snarkos_tpu_torch.ops.msm:msm_affine",
                              {"scalar_limbs": torch.zeros((16, 1 << 10))}) == work.msm_work(1024)
    inputs = torch.zeros((2, 16, 8 * 4096))
    assert layers["leaves"].work("snarkos_tpu_torch.ops.poseidon:hash_fixed",
                                 {"inputs": inputs, "rate": 2, "num_outputs": 1}) == \
        work.sponge_work(8 * 4096, 2, 2, 1)
    assert layers["leaves"].work("snarkos_tpu_torch.ops.puzzle:EpochProgram.apply",
                                 {"leaves": torch.zeros((16, 8, 4096))}) == \
        work.epoch_program_work(8, 4096)


def test_layer_targets_exist_in_the_program():
    from benchmark import trace

    for layer in harness.Benchmark().layers().values():
        for target in layer.TARGETS:
            owner, attr = trace.resolve(target)
            assert callable(getattr(owner, attr)), target
