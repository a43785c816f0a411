"""The port's NTT over Fr (plain PyTorch on the CPU) against the JAX
package's host reference ``crypto/ref/ntt.py`` and ``golden.json``'s
``ntt_16``, limb for limb (tolerance 0), under the default pass plan and
forced multi-pass plans; a model of the CUDA entry ``fr_ntt_pass``'s tile,
shared-memory and twiddle-offset math (``csrc/ntt.cu``) over Z_r; and, in
the slow tier, the port
against the JAX package's ``ops/ntt.py`` itself, its arrays handed across
with ``convert.fr`` (n = 4096 takes the JAX four-step path)."""

import json
import os
import random

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import ntt as jref
from snarkos_tpu_torch import convert
from snarkos_tpu_torch.crypto.ref import ntt as ref
from snarkos_tpu_torch.ops import ntt
from snarkos_tpu_torch.ops.fieldspec import FR

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)

P = FR.p
FIX = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures", "golden.json")))
CPU = torch.device("cpu")
# the two CPU routes: ``ntt`` through the passes' plain versions (n^-1
# folded into the gather), and ``ntt_plain``, the JAX package's stage loop
ROUTES = {"ntt": ntt.ntt, "ntt_plain": ntt.ntt_plain}


def _enc(vals):
    return torch.from_numpy(np.ascontiguousarray(FR.encode_fast(vals, mont=True)))


def _dec(t):
    return FR.decode_fast(t.numpy(), mont=True)


def _rand(rng, n):
    return [rng.randrange(P) for _ in range(n)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", [2, 16, 128])
def test_forward_matches_reference(route, n):
    vals = _rand(random.Random(n), n)
    assert _dec(ROUTES[route](_enc(vals))) == jref.ntt(vals)


@pytest.mark.parametrize("route", ROUTES)
def test_inverse_matches_reference(route):
    vals = _rand(random.Random(64), 64)
    assert _dec(ROUTES[route](_enc(vals), invert=True)) == jref.intt(vals)


@pytest.mark.parametrize("n", [16, 128])
def test_roundtrip(n):
    vals = _rand(random.Random(n + 1), n)
    a = _enc(vals)
    assert torch.equal(ntt.intt(ntt.ntt(a)), a)
    assert torch.equal(ntt.ntt_plain(ntt.ntt_plain(a), invert=True), a)


@pytest.mark.parametrize("invert", [False, True])
def test_batched(invert):
    """(16, 4, 32): each row an independent transform, on both routes."""
    rng = random.Random(32 + invert)
    rows = [_rand(rng, 32) for _ in range(4)]
    a = torch.stack([_enc(row) for row in rows], dim=1)
    for out in (ntt.ntt_batched(a, invert), ntt.ntt_plain(a, invert)):
        assert out.shape == a.shape
        for i, row in enumerate(rows):
            assert _dec(out[:, i]) == jref.ntt(row, invert)


@pytest.mark.parametrize("route", ROUTES)
def test_edge_values(route):
    vals = [0, 1, P - 1, P - 2] + [0] * 12
    a = _enc(vals)
    assert _dec(ROUTES[route](a)) == jref.ntt(vals)
    assert _dec(ROUTES[route](a, invert=True)) == jref.intt(vals)
    vals = [P - 1, P - 2, 1, 0] * 4
    assert _dec(ROUTES[route](_enc(vals))) == jref.ntt(vals)


def test_golden_ntt_16():
    g = FIX["ntt_16"]
    got = _dec(ntt.ntt(_enc([int(v) for v in g["input"]])))
    assert got == [int(v) for v in g["output"]]


def test_host_reference_matches_jax_package():
    """The port's own copy of crypto/ref/ntt.py: roots of unity of every
    order 2^k <= 2^22, bit reversal, and the transforms."""
    for k in range(23):
        assert ref.root_of_unity(1 << k) == jref.root_of_unity(1 << k)
    rng = random.Random(3)
    for bits in (1, 5, 12, 22):
        for x in [0, (1 << bits) - 1] + [rng.randrange(1 << bits) for _ in range(4)]:
            assert ref.bit_reverse(x, bits) == jref.bit_reverse(x, bits)
    vals = _rand(rng, 32)
    assert ref.ntt(vals) == jref.ntt(vals) and ref.intt(vals) == jref.intt(vals)
    assert ref.poly_eval(vals, 7) == jref.poly_eval(vals, 7)


@pytest.mark.parametrize("invert", [False, True])
def test_master_table_is_powers_of_omega(invert):
    n = 1 << 10
    omega = ref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, P)
    table = ntt._master_table(n, invert, CPU)
    assert table.shape == (FR.nlimbs, n // 2) and table.is_contiguous()
    assert _dec(table) == [pow(omega, i, P) for i in range(n // 2)]


@pytest.mark.parametrize("invert", [False, True])
def test_stage_table_is_per_stage_powers(invert):
    """Stage s of the table starts at offset 2^s - 1 and holds
    omega_{2^(s+1)}^j, j < 2^s."""
    n = 1 << 6
    omega = ref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, P)
    table = ntt._stage_table(n, invert, CPU)
    assert table.shape == (FR.nlimbs, n - 1) and table.is_contiguous()
    got = _dec(table)
    for s in range(6):
        w = pow(omega, n >> (s + 1), P)
        assert got[(1 << s) - 1:(2 << s) - 1] == [pow(w, j, P) for j in range(1 << s)]


def test_pass_plan_tiles_the_stages():
    """For every log n in [1, 31] and k_max in [1, 8]: passes of k <= k_max
    stages that tile [0, log n), the longer first; at most three at 2^22;
    every pass's tile (and the first pass's twiddles) fits a block's shared
    memory."""
    for k_max in range(1, 9):
        for log_n in range(1, 32):
            plan = ntt._pass_plan(log_n, k_max)
            assert [s0 for s0, _ in plan] == [sum(k for _, k in plan[:i]) for i in range(len(plan))]
            assert sum(k for _, k in plan) == log_n
            assert all(1 <= k <= k_max for _, k in plan)
            assert [k for _, k in plan] == sorted((k for _, k in plan), reverse=True)
            assert len(plan) == -(-log_n // k_max)
    assert ntt._pass_plan(22) == ((0, 8), (8, 7), (15, 7))
    for log_n in range(1, 32):
        for s0, k in ntt._pass_plan(log_n):
            cols = ntt._pass_cols(log_n, s0, k)
            assert cols <= (1 << (log_n - k) if s0 == 0 else 1 << s0)
            assert ntt._pass_smem(k, cols, s0 == 0) <= ntt.PASS_SMEM_MAX


@pytest.mark.parametrize("k_max, n", [(2, 64), (3, 128), (2, 256)])
def test_multi_pass_plan(monkeypatch, k_max, n):
    """``ntt`` under a forced plan of three or more passes equals
    ``ntt_plain`` and the JAX package's host reference, both directions and
    batched."""
    monkeypatch.setattr(ntt, "K_MAX", k_max)
    assert len(ntt._pass_plan(n.bit_length() - 1)) >= 3
    rng = random.Random(n + k_max)
    rows = [_rand(rng, n) for _ in range(2)]
    rows[0][:4] = [0, 1, P - 1, P - 2]
    a = _enc(rows[0])
    for invert in (False, True):
        got = ntt.ntt(a, invert)
        assert torch.equal(got, ntt.ntt_plain(a, invert))
        assert _dec(got) == jref.ntt(rows[0], invert)
    b = torch.stack([_enc(row) for row in rows], dim=1)
    out = ntt.ntt_batched(b)
    for i, row in enumerate(rows):
        assert _dec(out[:, i]) == jref.ntt(row)


# -- a model of csrc/ntt.cu's fr_ntt_pass over Z_r ----------------------------


def _rev(x, bits):
    return int(f"{x:0{bits}b}"[::-1], 2) if bits else 0


def _pass_model(src, dst, table, rows, n, s0, k, cols, scale, threads=32):
    """One launch of fr_ntt_pass, block by block and thread by thread, on
    the flat (rows n) array of values; the shared tile holds one value a
    slot (the kernel's 8 word planes share the slot index). Asserts that
    the pass loads and stores each element exactly once, that each load
    fills its own slot, that each stage's butterflies cover every slot once,
    and that each twiddle offset lies in its stage's part of the table and
    is the element's j."""
    log_n, log_cols = n.bit_length() - 1, cols.bit_length() - 1
    tile_rows = 1 << k
    tile, pitch = tile_rows << log_cols, cols + 1
    log_per = log_n - k - log_cols
    loaded, stored = [], []
    for blk in range((rows * n) // tile):
        row0 = (blk >> log_per) << log_n
        g = blk & ((1 << log_per) - 1)
        col0 = 0 if s0 == 0 else (g & ((1 << (s0 - log_cols)) - 1)) << log_cols
        start = 0 if s0 == 0 else row0 + ((g >> (s0 - log_cols)) << (s0 + k)) + col0
        sm = {}  # slot -> value
        for tid in range(threads):
            for e in range(tid, tile, threads):
                if s0 == 0:
                    c, q = e & (cols - 1), e >> log_cols
                    i = row0 + (q << (log_n - k)) + (g << log_cols) + c
                    slot = _rev(q, k) * pitch + c
                    val = src[i] * scale % P
                else:
                    c, t = e & (cols - 1), e >> log_cols
                    i = start + (t << s0) + c
                    slot = t * pitch + c
                    val = src[i]
                assert slot not in sm
                sm[slot] = val
                loaded.append(i)
        tw = table[:tile_rows - 1] if s0 == 0 else None
        for sp in range(k):
            s = s0 + sp
            touched = []
            for tid in range(threads):
                for b in range(tid, tile // 2, threads):
                    c, q = b & (cols - 1), b >> log_cols
                    lo = q & ((1 << sp) - 1)
                    t = ((q >> sp) << (sp + 1)) | lo
                    e0 = t * pitch + c
                    e1 = e0 + (pitch << sp)
                    if s0 == 0:
                        off = (1 << sp) - 1 + lo
                        assert off < tile_rows - 1
                        w = tw[off]
                        j = t & ((1 << s) - 1)  # chunk element t, index h 2^k + t
                    else:
                        off = (1 << s) - 1 + col0 + c + (lo << s0)
                        w = table[off]
                        j = ((t << s0) + col0 + c) & ((1 << s) - 1)
                    assert (1 << s) - 1 <= off < (2 << s) - 1 and off - ((1 << s) - 1) == j
                    u, v = sm[e0], sm[e1] * w % P
                    sm[e0], sm[e1] = (u + v) % P, (u - v) % P
                    touched += [e0, e1]
            assert sorted(touched) == sorted(sm)
        for tid in range(threads):
            for e in range(tid, tile, threads):
                if s0 == 0:
                    t, c = e & (tile_rows - 1), e >> k
                    h = _rev((g << log_cols) + c, log_n - k)
                    i, slot = row0 + (h << k) + t, t * pitch + c
                else:
                    c, t = e & (cols - 1), e >> log_cols
                    i, slot = start + (t << s0) + c, t * pitch + c
                dst[i] = sm[slot]
                stored.append(i)
    assert sorted(loaded) == list(range(rows * n))
    assert sorted(stored) == list(range(rows * n))


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("shape, k_max, log_elems", [((1, 64), 2, 3), ((4, 32), 2, 3),
                                                     ((2, 256), 3, 6)])
def test_pass_kernel_model(shape, k_max, log_elems, invert):
    """The plan's passes through the model of fr_ntt_pass (three or more
    passes, several tiles a row, threads that loop) equal the host NTT."""
    B, n = shape
    rng = random.Random(B * n + invert)
    rows = [_rand(rng, n) for _ in range(B)]
    rows[0][:4] = [0, 1, P - 1, P - 2]
    log_n = n.bit_length() - 1
    omega = ref.root_of_unity(n)
    if invert:
        omega = pow(omega, -1, P)
    table = [pow(pow(omega, n >> (s + 1), P), j, P) for s in range(log_n) for j in range(1 << s)]
    plan = ntt._pass_plan(log_n, k_max)
    assert len(plan) >= 3
    a = [v for row in rows for v in row]
    out = [None] * (B * n)
    for s0, k in plan:
        cols = ntt._pass_cols(log_n, s0, k, log_elems)
        scale = pow(n, -1, P) if invert and s0 == 0 else 1
        _pass_model(a if s0 == 0 else out, out, table, B, n, s0, k, cols, scale)
    assert [out[b * n:(b + 1) * n] for b in range(B)] == [jref.ntt(row, invert) for row in rows]


def test_sizes():
    """n == 1 returns its input on every entry; a size that is not a power
    of two raises."""
    a = _enc([5])
    assert ntt.ntt(a) is a and ntt.intt(a) is a and ntt.ntt_plain(a) is a
    b = a.reshape(FR.nlimbs, 1, 1)
    assert ntt.ntt_batched(b) is b
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt(_enc(list(range(12))))
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt_batched(_enc(list(range(12))).reshape(FR.nlimbs, 1, 12))


def test_convert_fr_checks_limbs():
    a = FR.encode_fast([1, 2, 3, 4], mont=True)
    assert torch.equal(convert.fr(a, "cpu"), torch.from_numpy(np.array(a)))
    assert convert.fr(a.reshape(FR.nlimbs, 2, 2), "cpu").shape == (FR.nlimbs, 2, 2)
    with pytest.raises(ValueError, match="limbs"):
        convert.fr(np.full((FR.nlimbs, 2), 1 << 16, dtype=np.int32), "cpu")
    with pytest.raises(ValueError, match="expected"):
        convert.fr(np.zeros((2, FR.nlimbs, 4), dtype=np.int32), "cpu")
    with pytest.raises(ValueError, match="int32"):
        convert.fr(np.zeros((FR.nlimbs, 4), dtype=np.int64), "cpu")


# -- the slow tier: the JAX package's ops/ntt.py itself -------------------------


def _jax_pair(fn, vals_arr):
    import jax.numpy as jnp

    return convert.fr(vals_arr, "cpu"), convert.fr(np.asarray(fn(jnp.asarray(vals_arr))), "cpu")


@pytest.mark.slow
@pytest.mark.parametrize("n", [16, 128, 4096])
def test_ntt_matches_jax(n):
    from snarkos_tpu.ops import ntt as jntt

    arr = FR.random(n, np.random.default_rng(n))
    a, want = _jax_pair(jntt.ntt, arr)
    assert torch.equal(ntt.ntt(a), want)
    assert torch.equal(ntt.ntt_plain(a), want)


@pytest.mark.slow
def test_intt_matches_jax():
    from snarkos_tpu.ops import ntt as jntt

    a, want = _jax_pair(jntt.intt, FR.random(64, np.random.default_rng(64)))
    assert torch.equal(ntt.intt(a), want)


@pytest.mark.slow
def test_ntt_batched_matches_jax():
    from snarkos_tpu.ops import ntt as jntt

    arr = FR.random(4 * 32, np.random.default_rng(32)).reshape(FR.nlimbs, 4, 32)
    a, want = _jax_pair(jntt.ntt_batched, arr)
    assert torch.equal(ntt.ntt_batched(a), want)
