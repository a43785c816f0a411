"""Kernel B1's Fr passes and its multiply, on the CPU: the epoch step and
the packed Poseidon constants of the fused kernels (``csrc/mont_mul.cu``)
against the JAX package; a model of the carry-chain multiply of
``csrc/field.cuh`` against the exact product; and the field add's carry
resolution with and without its host-side early-out."""

import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import poseidon as jref
from snarkos_tpu.ops import puzzle as jpuzzle
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops import poseidon, puzzle
from snarkos_tpu_torch.ops.fieldspec import FQ, FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

EPOCH = b"\x03" * 32


def test_epoch_steps_match_jax_apply_host():
    """``epoch_step_plain`` chained over the 12 steps of the program at
    k = 64 for 2 nonces equals the JAX package's host reference, with every
    selector present and edge leaves 0, 1, p - 1."""
    k, batch = 64, 2
    jprog = jpuzzle.EpochProgram(EPOCH, k)
    prog = puzzle.EpochProgram(EPOCH, k, device="cpu")
    assert set(prog.sels.reshape(-1).tolist()) == {0, 1, 2, 3}
    rng = random.Random(9)
    leaves = [[rng.randrange(FR.p) for _ in range(k)] for _ in range(batch)]
    leaves[0][:3] = [0, 1, FR.p - 1]
    v = torch.stack([torch.from_numpy(FR.encode_fast(row, mont=True)) for row in leaves], dim=1)
    for s in range(puzzle.EPOCH_STEPS):
        v = puzzle.epoch_step_plain(v, prog.perms[s], prog.sels[s].reshape(-1), prog.consts[s])
    for b in range(batch):
        assert FR.decode_fast(v[:, b].numpy(), mont=True) == jprog.apply_host(leaves[b])


@pytest.mark.parametrize("rate", poseidon.REGISTER_RATES)
def test_packed_poseidon_consts_match_jax(rate):
    """The permute kernel's constants: ark then the MDS matrix, Montgomery
    limbs, one row an element."""
    ark, mds = jref.poseidon_params(rate)
    t = rate + 1
    packed = poseidon.packed_consts(rate)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert tuple(packed.shape) == (poseidon.ROUNDS * t + t * t, FR.nlimbs)
    want = [v for row in ark for v in row] + [v for row in mds for v in row]
    assert FR.decode_fast(packed.T.contiguous().numpy(), mont=True) == want


# -- a model of field.cuh's multiply: CIOS on 32-bit words, PTX carry chains --

_M32 = (1 << 32) - 1


class _Chain:
    """The carry flag and the PTX instructions the multiply uses; an
    instruction without .cc must not carry out (asserted)."""

    def __init__(self):
        self.cf = 0

    def _out(self, v, cc):
        if cc:
            self.cf = v >> 32
        else:
            assert v >> 32 == 0, "a carry was dropped"
        return v & _M32

    def mad(self, a, b, c, hi, carry_in, cc=True):
        prod = (a * b >> 32) if hi else (a * b & _M32)
        return self._out(prod + c + (self.cf if carry_in else 0), cc)

    def add(self, a, b, carry_in, cc=True):
        return self._out(a + b + (self.cf if carry_in else 0), cc)


def _mad_even(ch, acc, a, bi):
    for j in range(0, len(acc), 2):
        acc[j] = ch.mad(a[j], bi, acc[j], hi=False, carry_in=j > 0)
        acc[j + 1] = ch.mad(a[j], bi, acc[j + 1], hi=True, carry_in=True)


def _model_mont_mul(spec, a_int, b_int):
    """field.cuh's mont_mul, instruction by instruction; returns the value
    before the conditional subtract."""
    n = spec.nlimbs // 2
    a, b, p = ([(v >> (32 * i)) & _M32 for i in range(n)] for v in (a_int, b_int, spec.p))
    inv = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    ch = _Chain()

    def reduce(even, odd):
        m = even[0] * inv & _M32
        _mad_even(ch, odd, p[1:], m)
        assert ch.cf == 0, "the odd chain of the reduction carried out"
        _mad_even(ch, even, p, m)
        odd[-1] = ch.add(odd[-1], 0, carry_in=True, cc=False)
        assert even[0] == 0

    x, y = [0] * n, [0] * n
    for j in range(0, n, 2):
        x[j], x[j + 1] = a[j] * b[0] & _M32, a[j] * b[0] >> 32
        y[j], y[j + 1] = a[j + 1] * b[0] & _M32, a[j + 1] * b[0] >> 32
    reduce(x, y)
    for i in range(1, n):
        even, odd = (y, x) if i % 2 else (x, y)
        even[0] = ch.add(even[0], odd[1], carry_in=False)
        for j in range(0, n - 2, 2):  # madc_rshift
            odd[j] = ch.mad(a[j + 1], b[i], odd[j + 2], hi=False, carry_in=True)
            odd[j + 1] = ch.mad(a[j + 1], b[i], odd[j + 3], hi=True, carry_in=True)
        odd[n - 2] = ch.mad(a[n - 1], b[i], 0, hi=False, carry_in=True)
        odd[n - 1] = ch.mad(a[n - 1], b[i], 0, hi=True, carry_in=True, cc=False)
        _mad_even(ch, even, a, b[i])
        odd[-1] = ch.add(odd[-1], 0, carry_in=True, cc=False)
        reduce(even, odd)
    t = [ch.add(x[0], y[1], carry_in=False)]
    t += [ch.add(x[j], y[j + 1], carry_in=True) for j in range(1, n - 1)]
    t.append(ch.add(x[n - 1], 0, carry_in=True, cc=False))
    return sum(w << (32 * i) for i, w in enumerate(t))


@pytest.mark.parametrize("spec", [FR, FQ], ids=lambda s: s.name)
def test_carry_chain_multiply_model(spec):
    """The multiply's chains drop no carry and give a * b / R below 2p, for
    edge operands and uniform ones: the conditional subtract then gives the
    canonical product the plain version computes."""
    p, R = spec.p, 1 << (16 * spec.nlimbs)
    rng = random.Random(11)
    edge = [0, 1, 2, p - 1, p - 2, p // 2, (1 << 200) - 1]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(150)]
    r_inv = pow(R, -1, p)
    for x, y in pairs:
        t = _model_mont_mul(spec, x, y)
        assert t < 2 * p and t % p == x * y * r_inv % p
    xs, ys = (torch.from_numpy(spec.encode_fast([v[i] for v in pairs])) for i in (0, 1))
    got = spec.decode_fast(fa.mont_mul_plain(spec, xs, ys).numpy())
    assert got == [x * y * r_inv % p for x, y in pairs]


def test_ripple_without_early_out_gives_same_limbs():
    """On the card the field add resolves carries with no early-out (no
    host sync); both branches give the same limbs, with and without a
    generating limb."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 1 << 16, size=(24, 64))).long()
    x[:, :8] = 0xFFFF
    x[3, 1::2] = 1 << 16  # carries that ripple through 0xFFFF runs
    x[23, 5] = 1 << 16    # out of the top limb: dropped
    for cols in (slice(0, 64), slice(0, 1), slice(2, 3)):
        part = x[:, cols].clone()
        gen = part == (1 << 16)
        assert torch.equal(fa._ripple(part.clone()), fa._lookahead(part.clone(), gen))
    assert not bool((x[:, 2:3] == 1 << 16).any())  # the early-out case was covered
