"""The port's field layer (plain PyTorch, on the CPU) against the JAX
package's ops/modarith.py, limb for limb, for Fq and Fr."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snarkos_tpu.ops import modarith as jfa
from snarkos_tpu.ops.fieldspec import FQ as JFQ, FR as JFR
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FQ, FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

N = 24


def _operands(spec):
    """0, 1, p-1 and carry-chain edge lanes, then uniform elements (numpy
    stream, seed 7), as canonical (L, N) int32 limbs."""
    p = spec.p
    rng = np.random.default_rng(7)
    ripple = (1 << (16 * (spec.nlimbs - 4))) - 1  # 0xFFFF...FF: long carry chains
    edge_a = [0, 1, p - 1, p - 1, 0, ripple, ripple, p - 2]
    edge_b = [0, p - 1, p - 1, 1, p - 1, 1, ripple, p - 1]
    a = spec.random(N, rng)
    b = spec.random(N, rng)
    a[:, :len(edge_a)] = spec.encode_fast(edge_a)
    b[:, :len(edge_b)] = spec.encode_fast(edge_b)
    return a, b


JAX_OPS = ("add", "sub", "neg", "double", "mont_mul", "sqr", "to_mont", "from_mont",
           "mul_small3", "mul_small8", "inv")


def _jax_op(spec, op, x, y):
    return {
        "add": lambda: jfa.add_impl(spec, x, y), "sub": lambda: jfa.sub_impl(spec, x, y),
        "neg": lambda: jfa.neg_impl(spec, x), "double": lambda: jfa.double_impl(spec, x),
        "mont_mul": lambda: jfa.mont_mul_impl(spec, x, y),
        "sqr": lambda: jfa.mont_sqr_impl(spec, x),
        "to_mont": lambda: jfa.to_mont_impl(spec, x),
        "from_mont": lambda: jfa.from_mont_impl(spec, x),
        "mul_small3": lambda: jfa.mul_small_impl(spec, x, 3),
        "mul_small8": lambda: jfa.mul_small_impl(spec, x, 8),
        "inv": lambda: jfa.inv_impl(spec, x),
    }[op]()


def _jax_outputs(ops, names):
    """One jitted JAX program computing ``names`` for both fields."""

    @jax.jit
    def run(a, b):
        return {spec.name: {op: _jax_op(spec, op, a[spec.name], b[spec.name]) for op in names}
                for spec in (JFQ, JFR)}

    a = {k: jnp.asarray(v[0]) for k, v in ops.items()}
    b = {k: jnp.asarray(v[1]) for k, v in ops.items()}
    return jax.tree_util.tree_map(np.asarray, run(a, b))


@pytest.fixture(scope="module")
def operands():
    return {spec.name: _operands(spec) for spec in (FQ, FR)}


@pytest.fixture(scope="module")
def jax_outputs(operands):
    return _jax_outputs(operands, JAX_OPS)


def _port(spec, op, a, b):
    return {
        "add": lambda: fa.add(spec, a, b), "sub": lambda: fa.sub(spec, a, b),
        "neg": lambda: fa.neg(spec, a), "double": lambda: fa.double(spec, a),
        "mont_mul": lambda: fa.mont_mul(spec, a, b), "sqr": lambda: fa.mont_sqr(spec, a),
        "to_mont": lambda: fa.to_mont(spec, a), "from_mont": lambda: fa.from_mont(spec, a),
        "mul_small3": lambda: fa.mul_small(spec, a, 3),
        "mul_small8": lambda: fa.mul_small(spec, a, 8),
        "inv": lambda: fa.inv(spec, a),
    }[op]()


def _check(spec, op, operands, want):
    a, b = (torch.from_numpy(x) for x in operands[spec.name])
    got = _port(spec, op, a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (spec.nlimbs, N)
    np.testing.assert_array_equal(got.numpy(), want[spec.name][op])


@pytest.mark.parametrize("op", JAX_OPS)
@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_matches_jax_limb_for_limb(operands, jax_outputs, spec, op):
    _check(spec, op, operands, jax_outputs)


@pytest.mark.parametrize("op", JAX_OPS)
@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_ops_against_python_ints(operands, spec, op):
    """Every op on the same operands against bigint arithmetic: canonical
    limbs are unique, so this pins the limbs the JAX package produces."""
    a, b = operands[spec.name]
    p, r, rinv = spec.p, spec.mont_r, spec.mont_rinv
    xs, ys = spec.decode(a, mont=False), spec.decode(b, mont=False)
    want = {
        "add": [(x + y) % p for x, y in zip(xs, ys)],
        "sub": [(x - y) % p for x, y in zip(xs, ys)],
        "neg": [-x % p for x in xs], "double": [2 * x % p for x in xs],
        "mont_mul": [x * y * rinv % p for x, y in zip(xs, ys)],
        "sqr": [x * x * rinv % p for x in xs], "to_mont": [x * r % p for x in xs],
        "from_mont": [x * rinv % p for x in xs], "mul_small3": [3 * x % p for x in xs],
        "mul_small8": [8 * x % p for x in xs],
        "inv": [pow(x, p - 2, p) * r * r % p for x in xs],
    }[op]
    got = _port(spec, op, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), spec.encode(want, mont=False))


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_mont_pow(spec):
    a, _ = _operands(spec)
    a = torch.from_numpy(a[:, :6])
    vals = spec.decode(a.numpy())
    assert spec.decode(fa.mont_pow(spec, a, 12345).numpy()) == [pow(v, 12345, spec.p) for v in vals]


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_plain_ops_against_python_ints(spec):
    """Broadcasting, int64 inputs and a wider batch, against bigints."""
    rng = random.Random(3)
    p = spec.p
    xs = [rng.randrange(p) for _ in range(300)] + [p - 1, 0, (1 << 200) - 1]
    ys = [rng.randrange(p) for _ in range(300)] + [p - 1, p - 1, 1]
    a = torch.from_numpy(spec.encode(xs)).reshape(spec.nlimbs, 3, -1)
    b = torch.from_numpy(spec.encode(ys)).reshape(spec.nlimbs, 3, -1)
    dec = lambda t: spec.decode(t.reshape(spec.nlimbs, -1).numpy())
    assert dec(fa.mont_mul(spec, a.long(), b)) == [x * y % p for x, y in zip(xs, ys)]
    assert dec(fa.sub(spec, a, b)) == [(x - y) % p for x, y in zip(xs, ys)]
    c = fa.broadcast_const(spec, 5, (3, 1))
    assert dec(fa.mont_mul(spec, a, c)) == [x * 5 % p for x in xs]
    assert fa.is_zero(spec, torch.from_numpy(spec.encode([0, 1]))).tolist() == [True, False]
