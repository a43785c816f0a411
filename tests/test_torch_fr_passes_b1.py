"""Kernel B1's two Fr passes as ``csrc/fr_passes.cu`` runs them, on the CPU:

- the permutation in its sparse form, over the exact constants the kernel
  reads (``poseidon.kernel_consts``, in ``kernel_layout`` order), in
  Montgomery integers with one reduction a row, against the port's and the
  JAX package's host permutation;
- the bound that lets an MDS row be reduced once;
- the wide product, squaring and reduction of the kernel, instruction by
  instruction (PTX carry chains), against the exact integers;
- the fused sponge's absorb and squeeze schedule against ``hash_many``;
- the one-launch epoch program's index math, thread by thread, against
  ``EpochProgram.apply_host`` and the JAX package's ``EpochProgram.apply``.
"""

import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import poseidon as jref
from snarkos_tpu.ops import puzzle as jpuzzle
from snarkos_tpu_torch.crypto.ref import poseidon as ref
from snarkos_tpu_torch.ops import poseidon, puzzle
from snarkos_tpu_torch.ops.fieldspec import FR

P = FR.p
R = 1 << 256
N_INV = (-pow(P, -1, R)) % R
EPOCH = b"\x07" * 32

# -- the permutation in Montgomery integers ----------------------------------------


def _redc(t: int) -> int:
    """t R^-1 mod p as the kernel reduces: one Montgomery reduction of t <
    p R, below 2p, then one conditional subtract."""
    assert 0 <= t < P * R
    r = (t + (t * N_INV % R) * P) // R
    assert r < 2 * P
    return r - P if r >= P else r


def _mont_permute(state: list, rate: int) -> list:
    """fr_poseidon_permute's permutation on Montgomery ints, reading the
    packed constants in the kernel's order."""
    t = rate + 1
    lay = poseidon.kernel_layout(t)
    c = FR.decode_fast(poseidon.kernel_consts(rate).T.contiguous().numpy(), mont=False)
    assert len(c) == lay["size"]

    def mul(a, b):
        return _redc(a * b)

    def sbox(x):
        y = x
        for _ in range(4):
            y = _redc(y * y)
        return mul(y, x)

    def row(m, s):  # unreduced products summed, one reduction
        return _redc(sum(a * b for a, b in zip(m, s)))

    s = list(state)
    for r in range(poseidon.FULL_ROUNDS):
        first = r < poseidon.HALF_FULL
        ark = lay["ark_first"] + r * t if first else lay["ark_last"] + (r - poseidon.HALF_FULL) * t
        s = [sbox((x + c[ark + i]) % P) for i, x in enumerate(s)]
        m = lay["m_pre"] if r == poseidon.HALF_FULL - 1 else lay["mds"]
        s = [row(c[m + i * t:m + (i + 1) * t], s) for i in range(t)]
        if r == poseidon.HALF_FULL - 1:
            s = [(x + c[lay["pre"] + i]) % P for i, x in enumerate(s)]
            for p in range(poseidon.PARTIAL_ROUNDS):
                k = lay["partial"] + p * 2 * t
                s[0] = (sbox(s[0]) + c[k]) % P
                new0 = row(c[k + 1:k + 1 + t], s)
                s = [new0] + [(s[i] + mul(s[0], c[k + t + i])) % P for i in range(1, t)]
    return s


@pytest.mark.parametrize("rate", poseidon.KERNEL_RATES)
def test_sparse_permutation_model_matches_reference(rate):
    t = rate + 1
    rng = np.random.default_rng(15 + rate)
    states = [[v] * t for v in (0, 1, P - 1)]
    states += [FR.decode_fast(FR.random(t, rng)) for _ in range(8)]
    for st in states:
        got = _mont_permute([v * R % P for v in st], rate)
        want = ref.permute(st, rate)
        assert [v * pow(R, -1, P) % P for v in got] == want
        assert want == jref.permute(st, rate)


@pytest.mark.parametrize("rate", poseidon.KERNEL_RATES)
def test_kernel_consts_layout(rate):
    """The packed tensor is kernel_values in Montgomery limbs, one row an
    element, and the dense constants are still those of the JAX package."""
    t = rate + 1
    packed = poseidon.kernel_consts(rate)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert tuple(packed.shape) == (poseidon.kernel_layout(t)["size"], FR.nlimbs)
    assert FR.decode_fast(packed.T.contiguous().numpy(), mont=True) == poseidon.kernel_values(rate)
    sp = poseidon.sparse_params(rate)
    ark, mds = jref.poseidon_params(rate)
    assert sp["mds"] == mds and sp["ark_first"] == ark[:4] and sp["ark_last"] == ark[35:]
    assert sp["post"][-1] == 0  # the last partial round's constant moved into the one before


@pytest.mark.parametrize("t", [3, 5])
def test_lazy_row_bound(t):
    """An MDS row of t unreduced products stays below p R, so that one
    reduction gives a value below 2p and one conditional subtract the
    canonical one; at t = 14 it would not."""
    assert t * (P - 1) ** 2 < P * R
    assert 14 * (P - 1) ** 2 >= P * R
    worst = t * (P - 1) ** 2
    assert (worst + (R - 1) * P) // R < 2 * P


# -- the kernel's wide arithmetic, instruction by instruction ----------------------

_M32 = (1 << 32) - 1
FN, WIDE = 8, 16


class _Chain:
    """The carry flag and the PTX instructions of fr_passes.cu; an
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


def _words(v, n):
    return [(v >> (32 * i)) & _M32 for i in range(n)]


def _value(ws):
    return sum(w << (32 * i) for i, w in enumerate(ws))


def _merge(ch, e, o):
    assert o[0] == 0
    t = [e[0], ch.add(e[1], o[1], carry_in=False)]
    t += [ch.add(e[k], o[k], carry_in=True) for k in range(2, WIDE - 1)]
    t.append(ch.add(e[WIDE - 1], o[WIDE - 1], carry_in=True, cc=False))
    return t


def _mul_wide(a, b):
    ch, e, o = _Chain(), [0] * WIDE, [0] * WIDE
    for i in range(FN):
        bi = b[i]
        e[i] = ch.mad(a[0], bi, e[i], False, carry_in=False)
        e[i + 1] = ch.mad(a[0], bi, e[i + 1], True, carry_in=True)
        for j in range(2, FN, 2):
            e[i + j] = ch.mad(a[j], bi, e[i + j], False, True)
            e[i + j + 1] = ch.mad(a[j], bi, e[i + j + 1], True, True)
        e[i + FN] = ch.add(e[i + FN], 0, carry_in=True, cc=False)
        o[i + 1] = ch.mad(a[1], bi, o[i + 1], False, carry_in=False)
        o[i + 2] = ch.mad(a[1], bi, o[i + 2], True, True)
        for j in range(3, FN - 2, 2):
            o[i + j] = ch.mad(a[j], bi, o[i + j], False, True)
            o[i + j + 1] = ch.mad(a[j], bi, o[i + j + 1], True, True)
        o[i + FN - 1] = ch.mad(a[FN - 1], bi, o[i + FN - 1], False, True)
        if i + 1 < FN:
            o[i + FN] = ch.mad(a[FN - 1], bi, o[i + FN], True, True)
            o[i + FN + 1] = ch.add(o[i + FN + 1], 0, carry_in=True, cc=False)
        else:
            o[i + FN] = ch.mad(a[FN - 1], bi, o[i + FN], True, True, cc=False)
    return _merge(ch, e, o)


def _sqr_wide(a):
    ch, e, o = _Chain(), [0] * WIDE, [0] * WIDE
    for i in range(FN - 1):
        ai = a[i]
        j0 = (i + 2) & ~1
        if j0 < FN:
            e[i + j0] = ch.mad(a[j0], ai, e[i + j0], False, carry_in=False)
            e[i + j0 + 1] = ch.mad(a[j0], ai, e[i + j0 + 1], True, True)
            for j in range(j0 + 2, FN, 2):
                e[i + j] = ch.mad(a[j], ai, e[i + j], False, True)
                e[i + j + 1] = ch.mad(a[j], ai, e[i + j + 1], True, True)
            e[i + FN] = ch.add(e[i + FN], 0, carry_in=True, cc=False)
        j1 = (i + 1) | 1
        o[i + j1] = ch.mad(a[j1], ai, o[i + j1], False, carry_in=False)
        o[i + j1 + 1] = ch.mad(a[j1], ai, o[i + j1 + 1], True, True)
        for j in range(j1 + 2, FN, 2):
            o[i + j] = ch.mad(a[j], ai, o[i + j], False, True)
            o[i + j + 1] = ch.mad(a[j], ai, o[i + j + 1], True, True)
        o[i + FN + 1] = ch.add(o[i + FN + 1], 0, carry_in=True, cc=False)
    x = _merge(ch, e, o)
    t = [(x[0] << 1) & _M32] + [((x[k] << 1) | (x[k - 1] >> 31)) & _M32 for k in range(1, WIDE)]
    assert x[WIDE - 1] >> 31 == 0  # x < 2^511: the doubling loses no bit
    t[0] = ch.mad(a[0], a[0], t[0], False, carry_in=False)
    t[1] = ch.mad(a[0], a[0], t[1], True, True)
    for i in range(1, FN - 1):
        t[2 * i] = ch.mad(a[i], a[i], t[2 * i], False, True)
        t[2 * i + 1] = ch.mad(a[i], a[i], t[2 * i + 1], True, True)
    t[WIDE - 2] = ch.mad(a[FN - 1], a[FN - 1], t[WIDE - 2], False, True)
    t[WIDE - 1] = ch.mad(a[FN - 1], a[FN - 1], t[WIDE - 1], True, True, cc=False)
    return t


def _add_wide(t, u):
    ch = _Chain()
    out = [ch.add(t[0], u[0], carry_in=False)]
    out += [ch.add(t[k], u[k], carry_in=True) for k in range(1, WIDE - 1)]
    out.append(ch.add(t[WIDE - 1], u[WIDE - 1], carry_in=True, cc=False))
    return out


_PW = _words(P, FN)
_INV32 = (-pow(P, -1, 1 << 32)) % (1 << 32)


def _mont_reduce(ch, even, odd):
    m = even[0] * _INV32 & _M32
    for j in range(0, FN, 2):  # mad_even(odd, p + 1, m)
        odd[j] = ch.mad(_PW[j + 1], m, odd[j], False, carry_in=j > 0)
        odd[j + 1] = ch.mad(_PW[j + 1], m, odd[j + 1], True, True)
    assert ch.cf == 0, "the odd chain of the reduction carried out"
    for j in range(0, FN, 2):  # mad_even(even, p, m)
        even[j] = ch.mad(_PW[j], m, even[j], False, carry_in=j > 0)
        even[j + 1] = ch.mad(_PW[j], m, even[j + 1], True, True)
    odd[-1] = ch.add(odd[-1], 0, carry_in=True, cc=False)
    assert even[0] == 0


def _redc_wide(t):
    """redc_wide up to its conditional subtract: returns the sum below 2p."""
    ch = _Chain()
    x, y = list(t[:FN]), [0] * FN
    _mont_reduce(ch, x, y)
    for i in range(1, FN):  # redc_row
        even, odd = (y, x) if i % 2 else (x, y)
        even[0] = ch.add(even[0], odd[1], carry_in=False)
        m = even[0] * _INV32 & _M32
        for j in range(0, FN - 2, 2):  # madc_rshift(odd, p + 1, m)
            odd[j] = ch.mad(_PW[j + 1], m, odd[j + 2], False, carry_in=True)
            odd[j + 1] = ch.mad(_PW[j + 1], m, odd[j + 3], True, carry_in=True)
        odd[FN - 2] = ch.mad(_PW[FN - 1], m, 0, False, carry_in=True)
        odd[FN - 1] = ch.mad(_PW[FN - 1], m, 0, True, carry_in=True, cc=False)
        for j in range(0, FN, 2):  # mad_even(even, p, m)
            even[j] = ch.mad(_PW[j], m, even[j], False, carry_in=j > 0)
            even[j + 1] = ch.mad(_PW[j], m, even[j + 1], True, True)
        odd[-1] = ch.add(odd[-1], 0, carry_in=True, cc=False)
        assert even[0] == 0
    s = [ch.add(x[0], y[1], carry_in=False)]
    s += [ch.add(x[j], y[j + 1], carry_in=True) for j in range(1, FN - 1)]
    s.append(ch.add(x[FN - 1], 0, carry_in=True, cc=False))
    s[0] = ch.add(s[0], t[FN], carry_in=False)
    for j in range(1, FN - 1):
        s[j] = ch.add(s[j], t[FN + j], carry_in=True)
    s[FN - 1] = ch.add(s[FN - 1], t[WIDE - 1], carry_in=True, cc=False)
    return _value(s)


def test_wide_chains_model():
    """mul_wide and sqr_wide give the exact 512-bit product, add_wide the
    sum, and redc_wide t R^-1 mod p below 2p for t < p R, all dropping no
    carry: at edge operands, at the worst row of five (p - 1)^2 and at
    uniform ones."""
    rng = random.Random(151)
    edge = [0, 1, 2, P - 1, P - 2, P // 2, (1 << 252) - 1, _M32]
    ops = edge + [rng.randrange(P) for _ in range(24)]
    pairs = [(x, y) for x in edge for y in edge] + [(rng.choice(ops), rng.choice(ops))
                                                     for _ in range(40)]
    r_inv = pow(R, -1, P)
    for x, y in pairs:
        prod = _mul_wide(_words(x, FN), _words(y, FN))
        assert _value(prod) == x * y
        sq = _sqr_wide(_words(x, FN))
        assert _value(sq) == x * x
        for t in (prod, sq):
            v = _redc_wide(t)
            assert v < 2 * P and v % P == _value(t) * r_inv % P
    for terms in ([(P - 1, P - 1)] * 5, [(rng.randrange(P), rng.randrange(P)) for _ in range(5)]):
        acc = _mul_wide(*(_words(v, FN) for v in terms[0]))
        for x, y in terms[1:]:
            acc = _add_wide(acc, _mul_wide(_words(x, FN), _words(y, FN)))
        want = sum(x * y for x, y in terms)
        assert _value(acc) == want
        v = _redc_wide(acc)
        assert v < 2 * P and v % P == want * r_inv % P


# -- the fused sponge's schedule --------------------------------------------------


def _sponge_model(rate, inputs=(), num_outputs=0, domain="", state=None):
    """fr_poseidon_kernel's control flow over ints: the first rate block
    absorbed, then permute; absorb the next block while inputs remain, else
    squeeze slots first .. t - 1 until the outputs are full."""
    t = rate + 1
    if state is not None:
        s, first, num_outputs = list(state), 0, t
    else:
        s, first = [ref._domain_to_field(domain)] + [0] * rate, 1
    k, out = 0, []

    def absorb():
        nonlocal k
        for i in range(1, t):
            if k < len(inputs):
                s[i] = (s[i] + inputs[k]) % P
                k += 1

    absorb()
    while True:
        s = ref.permute(s, rate)
        if k < len(inputs):
            absorb()
            continue
        for i in range(t):
            if i >= first and len(out) < num_outputs:
                out.append(s[i])
        if len(out) >= num_outputs:
            return out


@pytest.mark.parametrize("rate", poseidon.KERNEL_RATES)
def test_sponge_schedule_model(rate):
    rng = random.Random(152 + rate)
    for n in range(0, 6):
        xs = [rng.randrange(P) for _ in range(n)]
        for num_out in (1, 2, 3):
            want = ref.hash_many(xs, rate, num_out, "snarkos_tpu.puzzle.coeff")
            assert _sponge_model(rate, xs, num_out, "snarkos_tpu.puzzle.coeff") == want
    st = [rng.randrange(P) for _ in range(rate + 1)]
    assert _sponge_model(rate, state=st) == ref.permute(st, rate)


# -- the one-launch epoch program's index math ----------------------------------------

MAX_THREADS = 512


def _epoch_program_model(leaves, perms, sels, consts, cluster, seed=0):
    """fr_epoch_program_kernel thread by thread over canonical ints (the
    Montgomery form is transparent to the mix): per nonce a cluster of
    ``cluster`` ranks, each holding K / cluster lanes in two buffers, a
    lane's 8 words together; step s reads buffer s & 1 (the partner through its owner rank)
    and writes the other, with one product a lane, the operands picked by
    the selector ((v - u)(v + u) for v^2 - u^2); threads and ranks run in a
    shuffled order with every write landing at once, then the cluster
    barrier. leaves: B rows of K ints."""
    order = random.Random(seed)
    K = len(leaves[0])
    kb = K // cluster
    threads = min(MAX_THREADS, (kb + 31) // 32 * 32)
    out = []
    for row in leaves:
        bufs = [[0] * (2 * FN * kb) for _ in range(cluster)]  # shared memory of each rank
        for rank in range(cluster):
            for tid in range(threads):
                for kk in range(tid, kb, threads):
                    x = _words(row[rank * kb + kk], FN)
                    for w in range(FN):
                        bufs[rank][FN * kk + w] = x[w]
        for s in range(len(perms)):
            cur, nxt = (s & 1) * FN * kb, ((s + 1) & 1) * FN * kb
            for rank in order.sample(range(cluster), cluster):
                for tid in order.sample(range(threads), threads):
                    for kk in range(tid, kb, threads):
                        k = rank * kb + kk
                        j = int(perms[s][k])
                        owner, src = j // kb, cur + FN * (j % kb)
                        x = _value([bufs[rank][cur + FN * kk + w] for w in range(FN)])
                        u = _value([bufs[owner][src + w] for w in range(FN)])
                        c, sl = consts[s][k], int(sels[s][k])
                        f3 = sl not in (0, 1, 2)
                        a = (x - u) % P if f3 else x
                        b = {0: u, 1: x, 2: c}.get(sl, (x + u) % P)
                        y = a * b % P
                        r = (y - u) % P if sl == 2 else (y + (u if sl == 1 else c)) % P
                        r = _words(r, FN)
                        for w in range(FN):
                            bufs[rank][nxt + FN * kk + w] = r[w]
        fin = (len(perms) & 1) * FN * kb
        out.append([_value([bufs[k // kb][fin + FN * (k % kb) + w] for w in range(FN)])
                    for k in range(K)])
    return out


def _program_inputs(k, batch):
    prog = puzzle.EpochProgram(EPOCH, k, device="cpu")
    assert set(prog.sels.reshape(-1).tolist()) == {0, 1, 2, 3}
    rng = random.Random(153)
    leaves = [[rng.randrange(P) for _ in range(k)] for _ in range(batch)]
    leaves[0][:3] = [0, 1, P - 1]
    perms = prog.perms.numpy()
    sels = prog.sels.numpy()[:, 0, :]
    consts = [FR.decode_fast(prog.consts[s].numpy(), mont=True)
              for s in range(puzzle.EPOCH_STEPS)]
    return prog, leaves, perms, sels, consts


@pytest.mark.parametrize("cluster", [8, 16])
def test_epoch_program_thread_model(cluster):
    """At K = 64 (8 or 4 lanes a rank, a block of 32 threads, most idle) for
    2 nonces: the model equals the port's and the JAX package's
    apply_host."""
    prog, leaves, perms, sels, consts = _program_inputs(64, 2)
    got = _epoch_program_model(leaves, perms, sels, consts, cluster)
    jprog = jpuzzle.EpochProgram(EPOCH, 64)
    for b, row in enumerate(leaves):
        assert got[b] == prog.apply_host(row) == jprog.apply_host(row)


def test_epoch_program_model_many_lanes_a_thread():
    """At K = 8192 in clusters of 8 a rank holds 1024 lanes: two a thread
    of a 512-thread block (one nonce, the first two steps, checked against
    apply_host's recurrence over those steps)."""
    prog, leaves, perms, sels, consts = _program_inputs(8192, 1)
    got = _epoch_program_model(leaves, perms[:2], sels[:2], consts[:2], 8)
    v = list(leaves[0])
    for s in range(2):
        u = [v[j] for j in perms[s]]
        v = [(x * y + c if sl == 0 else x * x + y if sl == 1 else x * c - y if sl == 2
              else x * x - y * y + c) % P for x, y, c, sl in zip(v, u, consts[s], sels[s])]
    assert got[0] == v


def test_epoch_program_plain_matches_jax_apply():
    """The port's CPU apply (plain steps) and the thread model equal the JAX
    package's jitted EpochProgram.apply limb for limb (its XLA:CPU compile
    takes seconds)."""
    import jax.numpy as jnp

    prog, leaves, perms, sels, consts = _program_inputs(64, 2)
    jprog = jpuzzle.EpochProgram(EPOCH, 64)
    v = np.stack([FR.encode_fast(row, mont=True) for row in leaves], axis=1)
    want = np.asarray(jprog.apply(jnp.asarray(v)))
    np.testing.assert_array_equal(prog.apply(torch.from_numpy(v)).numpy(), want)
    model = _epoch_program_model(leaves, perms, sels, consts, puzzle.EPOCH_CLUSTER, seed=1)
    assert [FR.decode_fast(want[:, b], mont=True) for b in range(2)] == model


# -- what the wrappers hand the kernels ------------------------------------------------


@pytest.fixture
def stub_launch(monkeypatch):
    """The wrappers' build and launch replaced by a recorder, so that CPU
    tensors pass their checks: each launch's (symbol, tensors, sizes); the
    launch counters are put back afterwards."""
    from snarkos_tpu_torch.ops import _build

    calls = []
    for counter in (poseidon.sponge_kernel, puzzle.program_kernel):  # restored after the test
        monkeypatch.setattr(counter, "launches", counter.launches)
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "entry", lambda lib, symbol, *a: symbol)
    monkeypatch.setattr(_build, "launch",
                        lambda fn, tensors, sizes, device: calls.append((fn, tensors, sizes)))
    return calls


def test_sponge_wrapper_interface(stub_launch):
    """hash_fixed's sponge is one launch with no state, the inputs, the
    domain's limbs and (B, t, n, num_outputs); permute_kernel one launch
    with the state, no inputs and (B, t, 0, t); and the sponge dispatches no
    torch op but its output's allocation (the chip check asserts the same
    on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    x = torch.zeros((5, FR.nlimbs, 8), dtype=torch.int32)
    poseidon.sponge_kernel(4, inputs=x, domain="d", num_outputs=3)
    (fn, tensors, sizes), = stub_launch
    assert fn == "fr_poseidon_permute" and tensors[0] is None and tensors[1] is x
    assert FR.decode_fast(tensors[2].numpy(), mont=True) == [ref._domain_to_field("d")]
    assert torch.equal(tensors[3], poseidon.kernel_consts(4)) and sizes == (8, 5, 5, 3)
    assert tuple(tensors[4].shape) == (3, FR.nlimbs, 8)
    st = torch.zeros((3, FR.nlimbs, 8), dtype=torch.int32)
    poseidon.permute_kernel(st, 2)
    assert stub_launch[1][1][0] is st and stub_launch[1][1][1] is None
    assert stub_launch[1][2] == (8, 3, 0, 3)

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    pair = x[:2]
    with Record():
        poseidon.sponge_kernel(2, inputs=pair, domain="d", num_outputs=1)
    assert seen == ["aten.empty.memory_format"]
    with pytest.raises(ValueError, match="rate 3"):
        poseidon.sponge_kernel(3, inputs=x, num_outputs=1)


def test_program_wrapper_interface(stub_launch):
    """EpochProgram.apply on the card is one launch of (B, K, steps,
    EPOCH_CLUSTER); K must split into the cluster."""
    prog = puzzle.EpochProgram(EPOCH, 64, device="cpu")
    v = torch.zeros((FR.nlimbs, 2, 64), dtype=torch.int32)
    puzzle.program_kernel(v, prog.perms, prog.sels.reshape(puzzle.EPOCH_STEPS, 64), prog.consts)
    (fn, tensors, sizes), = stub_launch
    assert fn == "fr_epoch_program" and tensors[0] is v
    assert sizes == (2, 64, puzzle.EPOCH_STEPS, puzzle.EPOCH_CLUSTER)
    with pytest.raises(ValueError, match="clusters of 16"):
        puzzle.program_kernel(v[..., :40], prog.perms[:, :40],
                              prog.sels.reshape(puzzle.EPOCH_STEPS, 64)[:, :40],
                              prog.consts[..., :40])
