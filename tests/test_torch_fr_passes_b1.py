"""Kernel B1's two Fr passes as ``csrc/fr_passes.cu`` runs them, on the CPU:

- the permutation in its sparse form, over the exact constants the kernel
  reads (``poseidon.kernel_consts``, in ``kernel_layout`` order), in
  Montgomery integers with one reduction a row (a chunk of at most 13
  products at the wide widths), against the port's and the JAX package's
  host permutation, at the register template's rates and the wide ones;
- the bound that lets an MDS row be reduced once;
- the runtime-width kernel thread by thread: its state slots in a global
  scratch, its constant words, its chunked rows, against
  ``permute`` and ``hash_many``;
- the wide product, squaring and reduction of the kernel, instruction by
  instruction (PTX carry chains), against the exact integers;
- the fused sponge's absorb and squeeze schedule against ``hash_many``;
- the one-launch epoch program's index math, thread by thread, against
  ``EpochProgram.apply_host`` and the JAX package's ``EpochProgram.apply``:
  both read the wiring word and constant words of ``side_tables``; the
  cluster variant at every K up to 58,112 lanes (uneven ranks) and the
  global variant (a packing pass, grid-strided lanes, two buffers with a
  lane's nonces side by side), and the rule on (B, K) that picks between
  them.
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

    def row(m, s):  # unreduced products summed, one reduction a chunk
        out = 0
        for j0 in range(0, t, poseidon.ROW_CHUNK):
            out += _redc(sum(a * b for a, b in zip(m[j0:j0 + poseidon.ROW_CHUNK],
                                                   s[j0:j0 + poseidon.ROW_CHUNK])))
        return out % P

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


WIDE_RATES = (9, 12)  # the runtime-width kernel's, tier 1 (rate 16 under slow)


@pytest.mark.parametrize("rate", poseidon.REGISTER_RATES + WIDE_RATES
                         + (pytest.param(16, marks=pytest.mark.slow),))
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


@pytest.mark.parametrize("rate", poseidon.REGISTER_RATES + WIDE_RATES)
def test_kernel_consts_layout(rate):
    """The packed tensor is kernel_values in Montgomery limbs, one row an
    element, ``kernel_words`` the same values as 8 words an element, and the
    dense constants are still those of the JAX package."""
    t = rate + 1
    packed = poseidon.kernel_consts(rate)
    assert packed.dtype == torch.int32 and packed.is_contiguous()
    assert tuple(packed.shape) == (poseidon.kernel_layout(t)["size"], FR.nlimbs)
    assert FR.decode_fast(packed.T.contiguous().numpy(), mont=True) == poseidon.kernel_values(rate)
    words = poseidon.kernel_words(rate)
    assert words.dtype == torch.int32 and words.is_contiguous()
    assert tuple(words.shape) == (packed.shape[0], FN)
    mont = [_value(row) for row in words.numpy().view(np.uint32).tolist()]
    assert [v * pow(R, -1, P) % P for v in mont] == poseidon.kernel_values(rate)
    sp = poseidon.sparse_params(rate)
    ark, mds = jref.poseidon_params(rate)
    assert sp["mds"] == mds and sp["ark_first"] == ark[:4] and sp["ark_last"] == ark[35:]
    assert sp["post"][-1] == 0  # the last partial round's constant moved into the one before


@pytest.mark.parametrize("t", [rate + 1 for rate in poseidon.REGISTER_RATES] + [13])
def test_lazy_row_bound(t):
    """An MDS row of t unreduced products stays below p R, so that one
    reduction gives a value below 2p and one conditional subtract the
    canonical one: for every width the kernel is built for, and up to t =
    13, dot_row's static_assert; at t = 14 it would not."""
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


@pytest.mark.parametrize("rate", poseidon.REGISTER_RATES + WIDE_RATES)
def test_sponge_schedule_model(rate):
    rng = random.Random(152 + rate)
    for n in range(0, 6):
        xs = [rng.randrange(P) for _ in range(n)]
        for num_out in (1, 2, 3):
            want = ref.hash_many(xs, rate, num_out, "snarkos_tpu.puzzle.coeff")
            assert _sponge_model(rate, xs, num_out, "snarkos_tpu.puzzle.coeff") == want
    st = [rng.randrange(P) for _ in range(rate + 1)]
    assert _sponge_model(rate, state=st) == ref.permute(st, rate)


# -- the runtime-width sponge kernel, thread by thread ---------------------------------


def _wide_kernel_model(rate, B, threads, state=None, inputs=None, num_outputs=0, domain="",
                       seed=0):
    """fr_poseidon_wide_kernel thread by thread over Montgomery ints held as
    32-bit words: lanes in blocks of ``threads``, blocks and threads in a
    shuffled order; a lane's two state copies (Slots s and o) in one scratch
    of (2 t, FN, B) words, slot i's word w of lane e at (i FN + w) B + e (the
    second copy t FN B words on); the constants read as 8 words from kernel_words in
    kernel_layout order; a full round's rows into o, then s and o swapped;
    MDS rows in chunks of at most ROW_CHUNK unreduced products. state: t
    lists of B ints; inputs: n lists of B ints (Montgomery). Returns the
    written slots, (num_outputs or t) lists of B ints."""
    order = random.Random(seed)
    t = rate + 1
    lay = poseidon.kernel_layout(t)
    words = poseidon.kernel_words(rate).numpy().view(np.uint32)
    n_out = t if state is not None else num_outputs
    out = [[None] * B for _ in range(n_out)]
    mem = [None] * (2 * t * FN * B)

    def const(k):
        return _value(words[k].tolist())

    def mul(a, b):
        return _redc(a * b)

    def sbox(x):
        y = x
        for _ in range(4):
            y = _redc(y * y)
        return mul(y, x)

    for blk in order.sample(range(-(-B // threads)), -(-B // threads)):
        for tid in order.sample(range(threads), threads):
            e = blk * threads + tid
            if e >= B:
                continue
            sl, ol = [e], [e + t * FN * B]  # the two copies' first word

            def get(c, i):
                return _value([mem[c[0] + (i * FN + w) * B] for w in range(FN)])

            def put(c, i, v):
                for w, x in enumerate(_words(v, FN)):
                    mem[c[0] + (i * FN + w) * B] = x

            def row(m):
                total = 0
                for j0 in range(0, t, poseidon.ROW_CHUNK):
                    js = range(j0, min(t, j0 + poseidon.ROW_CHUNK))
                    total = (total + _redc(sum(get(sl, j) * const(m + j) for j in js))) % P
                return total

            def permute():
                for r in range(poseidon.FULL_ROUNDS):
                    half = r < poseidon.HALF_FULL
                    ark = r * t if half else lay["ark_last"] + (r - poseidon.HALF_FULL) * t
                    for i in range(t):
                        put(sl, i, sbox((get(sl, i) + const(ark + i)) % P))
                    m = lay["m_pre"] if r == poseidon.HALF_FULL - 1 else lay["mds"]
                    for i in range(t):
                        put(ol, i, row(m + i * t))
                    sl[0], ol[0] = ol[0], sl[0]
                    if r == poseidon.HALF_FULL - 1:
                        for i in range(t):
                            put(sl, i, (get(sl, i) + const(lay["pre"] + i)) % P)
                        for p in range(poseidon.PARTIAL_ROUNDS):
                            k = lay["partial"] + p * 2 * t
                            x0 = (sbox(get(sl, 0)) + const(k)) % P
                            put(sl, 0, x0)
                            new0 = row(k + 1)
                            for i in range(1, t):
                                put(sl, i, (get(sl, i) + mul(x0, const(k + t + i))) % P)
                            put(sl, 0, new0)

            if state is not None:
                for i in range(t):
                    put(sl, i, state[i][e])
            else:
                put(sl, 0, ref._domain_to_field(domain) * R % P)
                for i in range(1, t):
                    put(sl, i, 0)
            first = 0 if state is not None else 1
            n_in = 0 if inputs is None else len(inputs)
            k, n = 0, 0

            def absorb():
                nonlocal k
                for i in range(1, t):
                    if k < n_in:
                        put(sl, i, (get(sl, i) + inputs[k][e]) % P)
                        k += 1

            absorb()
            while True:
                permute()
                if k < n_in:
                    absorb()
                    continue
                for i in range(first, t):
                    if n < n_out:
                        out[n][e] = get(sl, i)
                        n += 1
                if n >= n_out:
                    break
    return out


@pytest.mark.parametrize("rate, B, threads", [(9, 5, 2), (9, 3, 4), (12, 3, 2), (12, 2, 1)])
def test_wide_kernel_model(rate, B, threads):
    """The runtime-width kernel's model, lanes spread over blocks (the last
    one short), its state in the scratch: one permutation of edge and
    random states equals ``ref.permute``, and the
    sponge over rate + 1 inputs squeezing rate + 1 (two absorbs, two
    squeezes) equals ``hash_many``."""
    t = rate + 1
    rng = random.Random(170 + rate + B)
    canon = [[0] * t, [1] * t, [P - 1] * t] + [[rng.randrange(P) for _ in range(t)]
                                               for _ in range(B - 3)]
    canon = canon[:B]
    state = [[canon[e][i] * R % P for e in range(B)] for i in range(t)]
    got = _wide_kernel_model(rate, B, threads, state=state, seed=B)
    r_inv = pow(R, -1, P)
    for e in range(B):
        assert [got[i][e] * r_inv % P for i in range(t)] == ref.permute(canon[e], rate)
    xs = [[rng.randrange(P) for _ in range(rate + 1)] for _ in range(B)]
    inputs = [[xs[e][i] * R % P for e in range(B)] for i in range(rate + 1)]
    got = _wide_kernel_model(rate, B, threads, inputs=inputs, num_outputs=rate + 1,
                             domain="snarkos_tpu.test")
    for e in range(B):
        assert [got[i][e] * r_inv % P for i in range(rate + 1)] == \
            ref.hash_many(xs[e], rate, rate + 1, "snarkos_tpu.test")


@pytest.mark.parametrize("rate", [9, 12])
@pytest.mark.slow
def test_hash_plain_wide_rates_match_host(rate):
    """The plain sponge, the CPU path and the card's yardstick, at the wide
    rates over rate + 1 inputs squeezing rate + 1, equals the port's and the
    JAX package's ``hash_many`` on three lanes (1.5-2.5 s a rate on one
    CPU core)."""
    rng = np.random.default_rng(171 + rate)
    x = FR.random((rate + 1) * 3, rng).reshape(FR.nlimbs, rate + 1, 3).transpose(1, 0, 2)
    got = poseidon.hash_plain(torch.from_numpy(np.ascontiguousarray(x)), rate, "snarkos_tpu.test",
                              rate + 1)
    for e in range(3):
        xs = [FR.decode_fast(x[i, :, e:e + 1], mont=True)[0] for i in range(rate + 1)]
        want = ref.hash_many(xs, rate, rate + 1, "snarkos_tpu.test")
        assert want == jref.hash_many(xs, rate, rate + 1, "snarkos_tpu.test")
        assert [FR.decode_fast(got[i, :, e:e + 1].numpy(), mont=True)[0]
                for i in range(rate + 1)] == want


# -- the one-launch epoch program's index math ----------------------------------------

MAX_THREADS = 512


def _epoch_program_model(leaves, tables, cluster, seed=0):
    """fr_epoch_program_kernel thread by thread over canonical ints (the
    Montgomery form is transparent to the mix): per nonce a cluster of
    ``cluster`` ranks, rank q holding lanes [q kb, min(K, (q + 1) kb)), kb =
    ceil(K / cluster), in two buffers of kb lanes, a lane's 8 words together;
    step s of lane k reads the wiring word ps[s][k] (partner j = its low 30
    bits, selector its top 2) and the constant's 8 words cw[s][k], reads
    buffer s & 1 (the partner through its owner rank j // kb) and writes the
    other, with one product a lane, the operands picked by the selector ((v
    - u)(v + u) for v^2 - u^2); threads and ranks run in a shuffled order
    with every write landing at once, then the cluster barrier. leaves: B
    rows of K ints; tables: ``side_tables``' (ps, cw) as numpy."""
    order = random.Random(seed)
    K = len(leaves[0])
    words, cwords = tables[0].view(np.uint32), tables[1].view(np.uint32)
    r_inv = pow(R, -1, P)
    kb = -(-K // cluster)
    threads = min(MAX_THREADS, (kb + 31) // 32 * 32)
    lanes = [max(0, min(kb, K - rank * kb)) for rank in range(cluster)]  # a rank's lanes
    out = []
    for row in leaves:
        bufs = [[0] * (2 * FN * kb) for _ in range(cluster)]  # shared memory of each rank
        for rank in range(cluster):
            for tid in range(threads):
                for kk in range(tid, lanes[rank], threads):
                    x = _words(row[rank * kb + kk], FN)
                    for w in range(FN):
                        bufs[rank][FN * kk + w] = x[w]
        for s in range(len(words)):
            cur, nxt = (s & 1) * FN * kb, ((s + 1) & 1) * FN * kb
            for rank in order.sample(range(cluster), cluster):
                for tid in order.sample(range(threads), threads):
                    for kk in range(tid, lanes[rank], threads):
                        k = rank * kb + kk
                        word = int(words[s, k])
                        j, sl = word & 0x3FFFFFFF, word >> 30
                        owner, src = j // kb, cur + FN * (j % kb)
                        x = _value([bufs[rank][cur + FN * kk + w] for w in range(FN)])
                        u = _value([bufs[owner][src + w] for w in range(FN)])
                        c = _value(cwords[s, k].tolist()) * r_inv % P
                        r = _words(_epoch_lane(x, u, c, sl), FN)
                        for w in range(FN):
                            bufs[rank][nxt + FN * kk + w] = r[w]
        fin = (len(words) & 1) * FN * kb
        out.append([_value([bufs[k // kb][fin + FN * (k % kb) + w] for w in range(FN)])
                    for k in range(K)])
    return out


def _epoch_lane(x, u, c, sl):
    """fr_passes.cu's epoch_lane: one product, the operands picked by sl."""
    f3 = sl not in (0, 1, 2)
    a = (x - u) % P if f3 else x
    b = {0: u, 1: x, 2: c}.get(sl, (x + u) % P)
    y = a * b % P
    return (y - u) % P if sl == 2 else (y + (u if sl == 1 else c)) % P


def _epoch_global_model(leaves, ps, cw, steps, blocks, threads, seed=0):
    """fr_epoch_program_global_kernel thread by thread: ``blocks`` x
    ``threads`` threads walk the n = B K lanes grid-strided, one at a time,
    blocks and threads in a shuffled order.
    leaves: (16, B, K) Montgomery limbs (numpy); ps (S, K), cw (S, K, 8):
    ``side_tables``' int32 words. A first pass packs lane e = b K + k of the
    leaves into buffer 0 at k B + b; step s of lane (b, k) reads the wiring
    word ps[s][k] (partner j = its low 30 bits, selector its top 2) and the
    constant's 8 words cw[s][k], x at k B + b and u at j B + b of buffer s &
    1, and writes the other buffer at once (lane e = k B + b), the last step
    the output's limbs (lane e = b K + k); a grid barrier between passes.
    Returns (16, B, K) limbs."""
    order = random.Random(seed)
    _, B, K = leaves.shape
    n, grid = B * K, blocks * threads
    r_inv = pow(R, -1, P)
    if steps == 0:
        return leaves.copy()
    flat = leaves.reshape(FR.nlimbs, n)
    out = np.zeros_like(flat)
    words, cwords = ps.view(np.uint32), cw.view(np.uint32)
    bufs = [[None] * (FN * n), [None] * (FN * n)]  # 8 words a lane

    def walk():
        for blk in order.sample(range(blocks), blocks):
            for tid in order.sample(range(threads), threads):
                yield from range(blk * threads + tid, n, grid)

    for e in walk():  # the packing pass
        b, k = divmod(e, K)
        bufs[0][FN * (k * B + b):FN * (k * B + b + 1)] = [
            int(flat[2 * w, e]) | int(flat[2 * w + 1, e]) << 16 for w in range(FN)]
    for s in range(steps):
        cur, nxt = bufs[s & 1], bufs[(s + 1) & 1]
        last = s + 1 == steps
        writes = []
        for e in walk():
            b, k = divmod(e, K) if last else divmod(e, B)[::-1]
            word = int(words[s, k])
            j, sl = word & 0x3FFFFFFF, word >> 30
            x = _value(cur[FN * (k * B + b):FN * (k * B + b + 1)]) * r_inv % P
            u = _value(cur[FN * (j * B + b):FN * (j * B + b + 1)]) * r_inv % P
            c = _value(cwords[s, k].tolist()) * r_inv % P
            writes.append((b, k, _epoch_lane(x, u, c, sl) * R % P))
        for b, k, r in writes:  # every write lands once the step's reads are done
            if last:
                out[:, b * K + k] = FR.encode_fast([r], mont=False)[:, 0]
            else:
                nxt[FN * (k * B + b):FN * (k * B + b + 1)] = _words(r, FN)
    return out.reshape(leaves.shape)


def _host_steps(v, perms, sels, consts):
    """apply_host's recurrence over the given steps."""
    for perm, sel, c in zip(perms, sels, consts):
        u = [v[j] for j in perm]
        v = [(x * y + cc if sl == 0 else x * x + y if sl == 1 else x * cc - y if sl == 2
              else x * x - y * y + cc) % P for x, y, cc, sl in zip(v, u, c, sel)]
    return v


def _program_inputs(k, batch, steps=puzzle.EPOCH_STEPS):
    """The program of EPOCH at K = k, ``batch`` rows of leaves (0, 1, p - 1
    first), the first ``steps`` steps' perms, sels and constants, and their
    ``side_tables`` as numpy."""
    prog = puzzle.EpochProgram(EPOCH, k, device="cpu")
    assert set(prog.sels.reshape(-1).tolist()) == {0, 1, 2, 3} or k < 4
    rng = random.Random(153)
    leaves = [[rng.randrange(P) for _ in range(k)] for _ in range(batch)]
    leaves[0][:3] = [0, 1, P - 1][:k]
    perms = prog.perms.numpy()[:steps]
    sels = prog.sels.numpy()[:steps, 0, :]
    consts = [FR.decode_fast(prog.consts[s].numpy(), mont=True) for s in range(steps)]
    tables = puzzle.side_tables(prog.perms[:steps], prog.sels[:steps], prog.consts[:steps])
    return prog, leaves, perms, sels, consts, tuple(t.numpy() for t in tables)


@pytest.mark.parametrize("cluster", [8, 16])
def test_epoch_program_thread_model(cluster):
    """At K = 64 (8 or 4 lanes a rank, a block of 32 threads, most idle) for
    2 nonces: the model equals the port's and the JAX package's
    apply_host."""
    prog, leaves, *_, tables = _program_inputs(64, 2)
    got = _epoch_program_model(leaves, tables, cluster)
    jprog = jpuzzle.EpochProgram(EPOCH, 64)
    for b, row in enumerate(leaves):
        assert got[b] == prog.apply_host(row) == jprog.apply_host(row)


def test_epoch_program_model_many_lanes_a_thread():
    """At K = 8192 in clusters of 8 a rank holds 1024 lanes: two a thread
    of a 512-thread block (one nonce, the first two steps, checked against
    apply_host's recurrence over those steps)."""
    prog, leaves, perms, sels, consts, tables = _program_inputs(8192, 1, steps=2)
    got = _epoch_program_model(leaves, tables, 8)
    assert got[0] == _host_steps(list(leaves[0]), perms, sels, consts)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 24])
def test_epoch_program_small_k_model(k):
    """Below and off the cluster of 16: at K = 1, 2, 4, 8 (a cluster of K
    blocks, one lane a block, 31 of a warp's threads idle) and K = 24 (a
    cluster of 16, two lanes a rank, ranks 12-15 empty) for 3 nonces, the
    model of the cluster rule ``epoch_plan`` picks equals the port's and the
    JAX package's apply_host, and the port's CPU apply."""
    kind, cluster, kb = puzzle.epoch_plan(3, k)
    assert (kind, cluster, kb) == ("cluster", min(k, 16), -(-k // min(k, 16)))
    prog, leaves, *_, tables = _program_inputs(k, 3)
    got = _epoch_program_model(leaves, tables, cluster, seed=k)
    jprog = jpuzzle.EpochProgram(EPOCH, k)
    v = np.stack([FR.encode_fast(row, mont=True) for row in leaves], axis=1)
    applied = prog.apply(torch.from_numpy(v)).numpy()
    for b, row in enumerate(leaves):
        assert got[b] == prog.apply_host(row) == jprog.apply_host(row)
        assert FR.decode_fast(applied[:, b], mont=True) == got[b]


def _global_case(k, batch, steps=puzzle.EPOCH_STEPS):
    """The program of EPOCH at K = k, its side tables and ``batch`` rows of
    Montgomery leaves (0, 1, p - 1 first), all as numpy."""
    prog, leaves, *_, (ps, cw) = _program_inputs(k, batch, steps)
    v = np.stack([FR.encode_fast(row, mont=True) for row in leaves], axis=1)
    return prog, v, ps, cw


@pytest.mark.parametrize("blocks", [1, 5, 6])
def test_epoch_program_global_model(blocks):
    """The redesigned global variant at K = 64 for 3 nonces on a grid of 1,
    5 or 6 blocks of 32 threads (32, 160 or 192 threads over 192 lanes: a
    thread walks six, two or one), all 12 steps, equals the port's
    apply_plain limb for limb and the JAX package's apply_host; with one
    step (the first step is also the last) and with none, the first step's
    plain version and the leaves."""
    prog, v, ps, cw = _global_case(64, 3)
    got = _epoch_global_model(v, ps, cw, puzzle.EPOCH_STEPS, blocks, 32, seed=blocks)
    np.testing.assert_array_equal(got, prog.apply_plain(torch.from_numpy(v)).numpy())
    jprog = jpuzzle.EpochProgram(EPOCH, 64)
    for b in range(3):
        assert FR.decode_fast(got[:, b], mont=True) == jprog.apply_host(
            FR.decode_fast(v[:, b], mont=True))
    one = _epoch_global_model(v, ps[:1], cw[:1], 1, blocks, 32)
    want = puzzle.epoch_step_plain(torch.from_numpy(v), prog.perms[0], prog.sels[0].reshape(-1),
                                   prog.consts[0])
    np.testing.assert_array_equal(one, want.numpy())
    np.testing.assert_array_equal(_epoch_global_model(v, ps[:0], cw[:0], 0, blocks, 32), v)


def test_epoch_side_tables():
    """``side_tables``: the wiring word holds the partner in its low 30 bits
    and the selector in its top 2 (selectors 2 and 3 set the sign bit), the
    constant words the limbs pairwise, a lane's 8 words together; the
    program builds them once, on its device, and keeps its own tensors on
    the host; K = 2^30 does not fit the word."""
    prog = puzzle.EpochProgram(EPOCH, 64, device="cpu")
    ps, cw = prog.side_tables()
    assert prog.side_tables()[0] is ps
    meta = puzzle.EpochProgram.from_tensors(EPOCH, prog.perms, prog.sels, prog.consts, "meta")
    assert {t.device.type for t in meta.side_tables()} == {"meta"}
    assert {t.device.type for t in (meta.perms, meta.sels, meta.consts)} == {"cpu"}
    assert ps.dtype == cw.dtype == torch.int32 and ps.is_contiguous() and cw.is_contiguous()
    assert tuple(ps.shape) == (puzzle.EPOCH_STEPS, 64)
    assert tuple(cw.shape) == (puzzle.EPOCH_STEPS, 64, FN)
    w = ps.numpy().view(np.uint32)
    np.testing.assert_array_equal(w & 0x3FFFFFFF, prog.perms.numpy())
    np.testing.assert_array_equal(w >> 30, prog.sels.numpy()[:, 0, :])
    assert (ps < 0).any() and set((w >> 30).reshape(-1).tolist()) == {0, 1, 2, 3}
    limbs = prog.consts.numpy().astype(np.uint32)
    np.testing.assert_array_equal(cw.numpy().view(np.uint32),
                                  (limbs[:, 0::2] | limbs[:, 1::2] << 16).transpose(0, 2, 1))
    empty = torch.empty((0, 1 << 30), dtype=torch.int32)
    with pytest.raises(ValueError, match="wiring word"):
        puzzle.side_tables(empty, empty, empty)


@pytest.mark.slow
def test_epoch_program_global_model_log16():
    """The global variant at K = 2^16, the first log degree above the
    cluster's shared memory, one nonce, the first two steps, on a grid of
    264 blocks of 256 threads (two blocks an SM of the card): equal to the
    plain steps (about 2 s)."""
    prog, v, ps, cw = _global_case(1 << 16, 1, steps=2)
    assert puzzle.epoch_plan(1, 1 << 16)[0] == "global"
    got = _epoch_global_model(v, ps, cw, 2, 264, 256)
    want = torch.from_numpy(v)
    for s in range(2):
        want = puzzle.epoch_step_plain(want, prog.perms[s], prog.sels[s].reshape(-1),
                                       prog.consts[s])
    np.testing.assert_array_equal(got, want.numpy())


PLANS = [
    ((1, 1), ("cluster", 1, 1)), ((8, 1), ("cluster", 1, 1)), ((8, 2), ("cluster", 2, 1)),
    ((8, 4), ("cluster", 4, 1)), ((8, 8), ("cluster", 8, 1)), ((8, 24), ("cluster", 16, 2)),
    ((1, 16), ("cluster", 16, 1)), ((1, 4096), ("cluster", 16, 256)),
    ((2, 4096), ("cluster", 16, 256)), ((4, 4096), ("cluster", 16, 256)),
    ((8, 4096), ("global", None, None)), ((16, 4096), ("global", None, None)),
    ((1, 58112), ("global", None, None)), ((1, 58113), ("global", None, None)),
    ((8, 1 << 16), ("global", None, None)), ((2, 1 << 20), ("global", None, None))]


@pytest.mark.parametrize("bk, plan", PLANS)
def test_epoch_plan(bk, plan):
    """The variant by (B, K): a cluster of min(16, 2^floor(log2 K)) blocks a
    nonce while the B K lanes stay below EPOCH_GLOBAL_MIN_LANES, the global
    variant else: at every shape a path launches (b8 / b16 x 4096 the
    prover, b2 / b4 x 4096 the node's smaller nonce batches, b1 x 4096
    check_binding, b8 x 1-24 log degree 0-3, b8 x 2^16, b2 x 2^20) and the
    cluster entry's largest K."""
    b, k = bk
    assert puzzle.epoch_plan(b, k) == plan
    if plan[0] == "cluster":
        assert 64 * plan[2] <= puzzle.EPOCH_SMEM_MAX and b * k < puzzle.EPOCH_GLOBAL_MIN_LANES
    with pytest.raises(ValueError):
        puzzle.epoch_plan(0, k)


@pytest.mark.parametrize("k, cluster", [(58112, (16, 3632)), (58113, None)])
def test_epoch_cluster_limit(k, cluster):
    """``fr_epoch_program``'s range: a block's two buffers of ceil(K / 16)
    lanes, 64 bytes a lane, fit 227 KiB of shared memory up to K = 58,112
    and no further; epoch_plan sends both to the global variant, whose B K
    threshold lies far below."""
    assert puzzle.epoch_cluster(k) == cluster
    assert 64 * 3632 <= puzzle.EPOCH_SMEM_MAX < 64 * 3633
    assert puzzle.epoch_plan(1, k)[0] == "global" and k > puzzle.EPOCH_GLOBAL_MIN_LANES


def test_epoch_program_plain_matches_jax_apply():
    """The port's CPU apply (plain steps) and the thread model equal the JAX
    package's jitted EpochProgram.apply limb for limb (its XLA:CPU compile
    takes seconds)."""
    import jax.numpy as jnp

    prog, leaves, *_, tables = _program_inputs(64, 2)
    jprog = jpuzzle.EpochProgram(EPOCH, 64)
    v = np.stack([FR.encode_fast(row, mont=True) for row in leaves], axis=1)
    want = np.asarray(jprog.apply(jnp.asarray(v)))
    np.testing.assert_array_equal(prog.apply(torch.from_numpy(v)).numpy(), want)
    model = _epoch_program_model(leaves, tables, puzzle.EPOCH_CLUSTER, seed=1)
    assert [FR.decode_fast(want[:, b], mont=True) for b in range(2)] == model


# -- what the wrappers hand the kernels ------------------------------------------------


@pytest.fixture
def stub_launch(monkeypatch):
    """The wrappers' build and launch replaced by a recorder, so that CPU
    tensors pass their checks: each launch's (symbol, tensors, sizes); the
    launch counters are put back afterwards."""
    from snarkos_tpu_torch.ops import _build

    calls = []
    for counter in (poseidon.sponge_kernel, puzzle.program_kernel_cluster,
                    puzzle.program_kernel_global):  # restored after the test
        monkeypatch.setattr(counter, "launches", counter.launches)
    monkeypatch.setattr(_build, "check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "entry", lambda lib, symbol, *a: symbol)
    monkeypatch.setattr(_build, "launch",
                        lambda fn, tensors, sizes, device: calls.append((fn, tensors, sizes)))
    return calls


def test_sponge_wrapper_interface(stub_launch):
    """hash_fixed's sponge is one launch with no state, the inputs, the
    domain's limbs, the rate's constants, the output and no scratch, and
    (B, t, n, num_outputs); permute_kernel one launch with the state, no
    inputs and (B, t, 0, t); a wide rate hands the kernel the constants'
    words and a (2 t, 8, B) scratch for its state; only a rate < 1 is
    refused; and the sponge dispatches no torch op but its output's
    allocation (the chip check asserts the same on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    x = torch.zeros((5, FR.nlimbs, 8), dtype=torch.int32)
    poseidon.sponge_kernel(4, inputs=x, domain="d", num_outputs=3)
    (fn, tensors, sizes), = stub_launch
    assert fn == "fr_poseidon_permute" and tensors[0] is None and tensors[1] is x
    assert FR.decode_fast(tensors[2].numpy(), mont=True) == [ref._domain_to_field("d")]
    assert torch.equal(tensors[3], poseidon.kernel_consts(4)) and sizes == (8, 5, 5, 3)
    assert tuple(tensors[4].shape) == (3, FR.nlimbs, 8) and tensors[5] is None
    st = torch.zeros((3, FR.nlimbs, 8), dtype=torch.int32)
    poseidon.permute_kernel(st, 2)
    assert stub_launch[1][1][0] is st and stub_launch[1][1][1] is None
    assert stub_launch[1][2] == (8, 3, 0, 3)
    poseidon.sponge_kernel(9, inputs=x, num_outputs=1)
    assert torch.equal(stub_launch[2][1][3], poseidon.kernel_words(9))
    assert tuple(stub_launch[2][1][5].shape) == (20, FN, 8)
    assert stub_launch[2][2] == (8, 10, 5, 1)
    poseidon.permute_kernel(torch.zeros((17, FR.nlimbs, 8), dtype=torch.int32), 16)
    assert tuple(stub_launch[3][1][5].shape) == (34, FN, 8)
    assert stub_launch[3][1][5].dtype == torch.int32 and stub_launch[3][2] == (8, 17, 0, 17)

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    pair = x[:2]
    with Record():
        poseidon.sponge_kernel(2, inputs=pair, domain="d", num_outputs=1)
    assert seen == ["aten.empty.memory_format"]
    with pytest.raises(ValueError, match="rate 0"):
        poseidon.sponge_kernel(0, inputs=x, num_outputs=1)


def test_program_wrapper_interface(stub_launch):
    """EpochProgram.apply on the card is one launch of the kernel that
    ``epoch_plan(B, K)`` names, both on the program's side tables, built
    once: ``fr_epoch_program`` with (B, K, steps, cluster) at (1, 64) (a
    cluster of 16) and (2, 40) (16 blocks of 3 lanes, the last ranks
    short); ``fr_epoch_program_global`` with a scratch tensor the size of
    the output and (B, K, steps) at (8, 4096) and (1, 2^16); one count on
    the launched variant's counter."""
    prog = puzzle.EpochProgram(EPOCH, 64, device="cpu")
    v = torch.zeros((FR.nlimbs, 1, 64), dtype=torch.int32)
    puzzle.program_kernel(v, prog)
    (fn, tensors, sizes), = stub_launch
    assert fn == "fr_epoch_program" and tensors[0] is v and len(tensors) == 4
    assert tensors[1] is prog.side_tables()[0] and tensors[2] is prog.side_tables()[1]
    assert tensors[3].shape == v.shape
    assert sizes == (1, 64, puzzle.EPOCH_STEPS, puzzle.EPOCH_CLUSTER)
    p40 = puzzle.EpochProgram(EPOCH, 40, device="cpu")
    puzzle.program_kernel(torch.zeros((FR.nlimbs, 2, 40), dtype=torch.int32), p40)
    assert stub_launch[1][0] == "fr_epoch_program"
    assert stub_launch[1][2] == (2, 40, puzzle.EPOCH_STEPS, 16)
    before = puzzle.program_kernel_global.launches
    p4k = puzzle.EpochProgram(EPOCH, 4096, device="cpu")
    v8 = torch.zeros((FR.nlimbs, 8, 4096), dtype=torch.int32)
    puzzle.program_kernel(v8, p4k)
    fn, tensors, sizes = stub_launch[2]
    assert fn == "fr_epoch_program_global" and tensors[0] is v8 and len(tensors) == 5
    assert tensors[1] is p4k.side_tables()[0] and tensors[2] is p4k.side_tables()[1]
    assert tensors[4].shape == tensors[3].shape == v8.shape and tensors[4] is not tensors[3]
    assert sizes == (8, 4096, puzzle.EPOCH_STEPS)
    big = puzzle.EpochProgram(EPOCH, 1 << 16, device="cpu")
    vb = torch.zeros((FR.nlimbs, 1, 1 << 16), dtype=torch.int32)
    puzzle.program_kernel(vb, big)
    assert stub_launch[3][0] == "fr_epoch_program_global" and stub_launch[3][2] == (
        1, 1 << 16, puzzle.EPOCH_STEPS)
    assert puzzle.program_kernel_global.launches == before + 2
