"""Batched Poseidon sponge over Fr (the port of ``snarkos_tpu/ops/poseidon.py``).

Bit-exact against crypto/ref/poseidon.py. The batch axis is data-parallel.
On a CUDA tensor ``hash_fixed`` is one launch of ``fr_poseidon_permute``
(``csrc/fr_passes.cu``, kernel B1's Fr pass) at any rate >= 1: the kernel
seeds the capacity slot, absorbs the inputs, runs every permutation and
writes only the squeezed slots. ``permute`` is the same launch on a given
state. Rates 1-8 run a kernel built for their width with the state in
registers; wider states run one kernel of runtime width with the state in
a global scratch (``REGISTER_RATES``). On a CPU tensor both run the plain
version, the dense rounds with a round's slots in each field op together:
the x^17 s-box is four squarings and a multiply, the MDS mix t^2 constant
multiplies in one call and t - 1 adds.

The kernel runs the permutation in the optimized form of the Poseidon paper
(Grassi et al., USENIX Security 2021, appendix B), exact algebra over Fr
with the same outputs: the partial rounds' constants moved through the MDS
matrix so that each partial round adds one constant to slot 0 after its
s-box, and their MDS matrices factored into one dense matrix (``m_pre``,
applied in the last full round before them) and one sparse matrix a round
(a first row, a first column and the identity). ``sparse_params`` derives
them in exact integers; ``kernel_consts`` packs them in the order the kernel
reads them (``kernel_layout``).

State layout: (t, L, B) int32 — t state slots of L 16-bit-limb Montgomery
Fr elements over batch B.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snarkos_tpu_torch.crypto.ref import poseidon as ref
from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.ops import modarith as fa
from snarkos_tpu_torch.ops.fieldspec import FR

ALPHA = ref.ALPHA
FULL_ROUNDS = ref.FULL_ROUNDS
PARTIAL_ROUNDS = ref.PARTIAL_ROUNDS
ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
HALF_FULL = FULL_ROUNDS // 2
# the rates of the register template (fr_passes.cu: fr_poseidon_kernel<T>),
# one kernel a width t = 2 .. 9 (snarkVM defines Poseidon2, 4 and 8; the
# callers of either package use 2 and 4); every wider state runs the
# runtime-width kernel (fr_poseidon_wide_kernel), its MDS rows reduced in
# chunks of at most ROW_CHUNK products (dot_row's bound: an unreduced sum
# of 13 stays below p R)
REGISTER_RATES = tuple(range(1, 9))
ROW_CHUNK = 13
P = FR.p


@functools.lru_cache(maxsize=None)
def packed_consts(rate: int) -> torch.Tensor:
    """The permutation's constants as one contiguous int32 tensor of
    Montgomery limbs, (ROUNDS t + t^2, L): the round constants ark
    (ROUNDS, t, L), then the MDS matrix (t, t, L), t = rate + 1."""
    ark, mds = ref.poseidon_params(rate)
    flat = [v for row in ark for v in row] + [v for row in mds for v in row]
    return torch.from_numpy(np.ascontiguousarray(FR.encode_fast(flat, mont=True).T))


# -- the sparse form of the kernel ---------------------------------------------


def _mat_inv(m: list) -> list:
    """The inverse of a square matrix over Fr (Gauss-Jordan); raises if it
    is singular."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % P)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], -1, P)
        a[col] = [v * inv % P for v in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(v - f * w) % P for v, w in zip(a[r], a[col])]
    return [row[n:] for row in a]


def _mat_mul(a: list, b: list) -> list:
    return [[sum(x * b[k][j] for k, x in enumerate(row)) % P for j in range(len(b[0]))]
            for row in a]


def _mat_vec(m: list, v: list) -> list:
    return [sum(x * y for x, y in zip(row, v)) % P for row in m]


@functools.lru_cache(maxsize=None)
def sparse_params(rate: int) -> dict:
    """The permutation of ``ref.permute`` rewritten with sparse partial
    rounds, as canonical ints, t = rate + 1:

      rounds 0 .. 3:    s += ark[r]; s = sbox(s); s = M s  (m_pre in round 3)
      then:             s += pre
      partial round i:  s0 = sbox(s0) + post[i]; s = S_i s, where
                        S_i s = (row0[i] . s, s_1 + w[i][0] s0, ..., s_{t-1} + w[i][t-2] s0)
      rounds 35 .. 38:  s += ark[r]; s = sbox(s); s = M s

    Derivation (M^-1 and the lower-right blocks are invertible for these
    Cauchy matrices): walking the partial rounds backwards, round r's
    constant c is M d with d = M^-1 c; d's slots 1.. pass through round r -
    1's s-box unchanged and join its constant, d_0 becomes round r - 1's
    ``post`` (the last partial round keeps none). Then each partial round's
    matrix N (M for the last, D M for the others) is split as N = S D with
    D = diag(1, N') (N' its lower-right block) and S sparse; D commutes with
    the slot-0 s-box and the slot-0 constant, so it moves into the round
    before: the first partial round's D turns round 3's M into m_pre = D M
    and its full constant into pre = D c."""
    ark, mds = ref.poseidon_params(rate)
    t = rate + 1
    first, last = HALF_FULL, HALF_FULL + PARTIAL_ROUNDS - 1
    c = [list(row) for row in ark]
    m_inv = _mat_inv(mds)
    post = [0] * PARTIAL_ROUNDS
    for r in range(last, first, -1):
        d = _mat_vec(m_inv, c[r])
        c[r - 1] = [c[r - 1][0]] + [(x + y) % P for x, y in zip(c[r - 1][1:], d[1:])]
        post[r - 1 - first] = d[0]
        c[r] = [0] * t
    row0, w = [None] * PARTIAL_ROUNDS, [None] * PARTIAL_ROUNDS
    n = mds
    for r in range(last, first - 1, -1):
        lower = [row[1:] for row in n[1:]]
        v = _mat_vec([list(col) for col in zip(*_mat_inv(lower))], n[0][1:])
        row0[r - first] = [n[0][0]] + v
        w[r - first] = [row[0] for row in n[1:]]
        d = [[1] + [0] * (t - 1)] + [[0] + row for row in lower]
        n = _mat_mul(d, mds)
    return {"ark_first": [list(row) for row in ark[:first]], "mds": [list(r) for r in mds],
            "m_pre": n, "pre": _mat_vec(d, c[first]), "post": post, "row0": row0, "w": w,
            "ark_last": [list(row) for row in ark[last + 1:]]}


def kernel_layout(t: int) -> dict:
    """Offsets, in elements, of the parts of ``kernel_consts``, in the order
    the kernel reads them: ark of rounds 0-3 (4 t), M (t^2, row-major),
    m_pre (t^2), pre (t), then for each partial round post, row0 and w (2 t
    a round), then ark of rounds 35-38 (4 t). ``size`` is the total."""
    out, off = {}, 0
    for name, size in (("ark_first", HALF_FULL * t), ("mds", t * t), ("m_pre", t * t),
                       ("pre", t), ("partial", PARTIAL_ROUNDS * 2 * t),
                       ("ark_last", HALF_FULL * t)):
        out[name] = off
        off += size
    out["size"] = off
    return out


def kernel_values(rate: int) -> list:
    """``sparse_params`` flattened in the order of ``kernel_layout``, as
    canonical ints."""
    sp = sparse_params(rate)
    flat = [v for row in sp["ark_first"] for v in row]
    flat += [v for row in sp["mds"] for v in row] + [v for row in sp["m_pre"] for v in row]
    flat += sp["pre"]
    for i in range(PARTIAL_ROUNDS):
        flat += [sp["post"][i]] + sp["row0"][i] + sp["w"][i]
    flat += [v for row in sp["ark_last"] for v in row]
    assert len(flat) == kernel_layout(rate + 1)["size"]
    return flat


@functools.lru_cache(maxsize=None)
def kernel_consts(rate: int) -> torch.Tensor:
    """The kernel's constants, ``kernel_values`` as Montgomery limbs, one
    contiguous int32 row of L limbs an element."""
    return torch.from_numpy(np.ascontiguousarray(
        FR.encode_fast(kernel_values(rate), mont=True).T))


@functools.lru_cache(maxsize=None)
def kernel_words(rate: int) -> torch.Tensor:
    """``kernel_consts`` as 32-bit Montgomery words, (size, 8) int32 (word w
    = limb 2w | limb 2w + 1 << 16): the runtime-width kernel reads a constant
    as two 16-byte loads."""
    limbs = kernel_consts(rate).numpy().astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(
        (limbs[:, 0::2] | (limbs[:, 1::2] << 16)).view(np.int32)))


@functools.lru_cache(maxsize=None)
def _device_kernel_consts(rate: int, device: torch.device) -> torch.Tensor:
    """The constants in the form the rate's kernel reads."""
    table = kernel_consts(rate) if rate in REGISTER_RATES else kernel_words(rate)
    return table.to(device)


@functools.lru_cache(maxsize=None)
def _device_consts(rate: int, device: torch.device) -> torch.Tensor:
    return packed_consts(rate).to(device)


@functools.lru_cache(maxsize=None)
def _domain_limbs(domain: str, device: torch.device) -> torch.Tensor:
    """The capacity slot's seed, Montgomery limbs (L,) int32."""
    return torch.from_numpy(np.ascontiguousarray(
        FR.encode_fast([ref._domain_to_field(domain)], mont=True)[:, 0])).to(device)


def _consts(rate: int, device: torch.device):
    """(ark, mds) for the plain version, limbs first: ark (ROUNDS, L, t, 1),
    mds (L, t, t, 1)."""
    t = rate + 1
    packed = _device_consts(rate, device)
    return (packed[:ROUNDS * t].reshape(ROUNDS, t, FR.nlimbs, 1).permute(0, 2, 1, 3),
            packed[ROUNDS * t:].reshape(t, t, FR.nlimbs, 1).permute(2, 0, 1, 3))


def _sbox(x: torch.Tensor) -> torch.Tensor:
    """x^17 = ((((x^2)^2)^2)^2) * x."""
    y = x
    for _ in range(4):
        y = fa.mont_mul_plain(FR, y, y)
    return fa.mont_mul_plain(FR, y, x)


def _mix(state: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """MDS matrix multiply on (L, t, B) state: out_i = sum_j mds[i][j] * s_j,
    the t^2 products in one multiply over (L, t, t, B), then t - 1 adds."""
    prods = fa.mont_mul_plain(FR, mds, state.unsqueeze(1))
    acc = prods[:, :, 0]
    for j in range(1, state.shape[1]):
        acc = fa.add(FR, acc, prods[:, :, j])
    return acc


def permute_plain(state: torch.Tensor, rate: int) -> torch.Tensor:
    """Plain PyTorch version of the permutation on (t, L, B) state
    (Montgomery form), on any device: a round's t slots in each field op
    together, the dense rounds of ``ref.permute``."""
    ark, mds = _consts(rate, state.device)
    t = rate + 1
    assert state.shape[0] == t
    s = state.transpose(0, 1)  # (L, t, B)
    for rnd in range(ROUNDS):
        s = fa.add(FR, s, ark[rnd])
        if rnd < HALF_FULL or rnd >= HALF_FULL + PARTIAL_ROUNDS:
            s = _sbox(s)
        else:
            s = torch.cat([_sbox(s[:, :1]), s[:, 1:]], dim=1)
        s = _mix(s, mds)
    return s.transpose(0, 1).contiguous()


def hash_plain(inputs: torch.Tensor, rate: int, domain: str = "",
               num_outputs: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the sponge on (n, L, B) Montgomery inputs,
    on any device: the capacity slot seeded from the domain, absorb by
    addition a rate block at a time with ``permute_plain`` between blocks,
    squeeze ``num_outputs`` slots. Returns (num_outputs, L, B)."""
    n, L, B = inputs.shape
    cap = fa.broadcast_const(FR, ref._domain_to_field(domain), (B,), device=inputs.device)
    zero = torch.zeros((L, B), dtype=torch.int32, device=inputs.device)
    slots = [cap] + [zero] * rate
    pos = 0
    for k in range(n):
        if pos == rate:
            slots = list(permute_plain(torch.stack(slots), rate))
            pos = 0
        slots[1 + pos] = fa.add(FR, slots[1 + pos], inputs[k])
        pos += 1
    outs = []
    state = torch.stack([s.expand(L, B) for s in slots])
    while len(outs) < num_outputs:
        state = permute_plain(state, rate)
        take = min(rate, num_outputs - len(outs))
        outs.extend(state[1 + i] for i in range(take))
    return torch.stack(outs[:num_outputs])


@_build.counted
def sponge_kernel(rate: int, state=None, inputs=None, domain: str = "",
                  num_outputs: int = 0) -> torch.Tensor:
    """Launch ``fr_poseidon_permute`` on int32 CUDA tensors, in one of two
    modes. With ``state`` (rate + 1, L, B): one permutation of it, all t
    slots written. Else the sponge over ``inputs`` (n, L, B): the capacity
    slot seeded from ``domain``, the inputs absorbed and ``num_outputs``
    slots squeezed, (num_outputs, L, B) written. Any rate >= 1: a rate < 1
    has no slot to absorb into and raises. Above ``REGISTER_RATES`` the
    state lives in a scratch tensor of (2 t, 8, B) words, its two copies."""
    if rate < 1:
        raise ValueError(f"sponge_kernel: rate {rate} < 1")
    t = rate + 1
    if (state is None) == (inputs is None):
        raise ValueError("sponge_kernel: give exactly one of state and inputs")
    if state is not None:
        B = state.shape[-1] if state.dim() == 3 else None
        _build.check(state, (t, FR.nlimbs, B), "permute state")
        device, n_in, n_out, dom = state.device, 0, t, None
    else:
        n_in, B = (inputs.shape[0], inputs.shape[-1]) if inputs.dim() == 3 else (None, None)
        _build.check(inputs, (n_in, FR.nlimbs, B), "sponge inputs")
        if num_outputs < 1:
            raise ValueError(f"sponge_kernel: num_outputs {num_outputs} < 1")
        device, n_out = inputs.device, num_outputs
        dom = _domain_limbs(domain, device)
    out = torch.empty((n_out, FR.nlimbs, B), dtype=torch.int32, device=device)
    if B:
        scratch = None
        if rate not in REGISTER_RATES:
            scratch = torch.empty((2 * t, FR.nlimbs // 2, B), dtype=torch.int32, device=device)
        fn = _build.entry("fr_passes", "fr_poseidon_permute", 6, 4)
        _build.launch(fn, (state, inputs, dom, _device_kernel_consts(rate, device), out, scratch),
                      (B, t, n_in, n_out), device)
        _build.count(sponge_kernel)
    return out


def permute_kernel(state: torch.Tensor, rate: int) -> torch.Tensor:
    """One launch of ``fr_poseidon_permute`` on a (rate + 1, L, B) int32
    CUDA tensor (``sponge_kernel`` with a state)."""
    return sponge_kernel(rate, state=state)


def permute(state: torch.Tensor, rate: int) -> torch.Tensor:
    """The Poseidon permutation on (t, L, B) state (Montgomery form): one
    launch of the permute kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if state.device.type == "cpu":
        return permute_plain(state, rate)
    return permute_kernel(state.to(torch.int32).contiguous(), rate)


def hash_fixed(inputs: torch.Tensor, rate: int, domain: str = "",
               num_outputs: int = 1) -> torch.Tensor:
    """Sponge-hash a fixed number of field elements per lane.

    inputs: (n, L, B) Montgomery Fr elements; returns (num_outputs, L, B).
    Mirrors ref.poseidon.hash_many: capacity slot seeded from the domain,
    absorb-by-addition per rate block, permute between blocks. One launch of
    the sponge kernel on a CUDA tensor, ``hash_plain`` on a CPU tensor."""
    if inputs.device.type == "cpu":
        return hash_plain(inputs, rate, domain, num_outputs)
    return sponge_kernel(rate, inputs=inputs.to(torch.int32).contiguous(), domain=domain,
                         num_outputs=num_outputs)


def hash_batch(values, rate: int = 2, domain: str = "", device=None) -> torch.Tensor:
    """(n, L, B) Montgomery limbs -> (L, B) digests, ``hash_fixed(...)[0]``.
    ``values`` is a tensor, hashed where it lies, or a numpy array, which
    goes to ``device`` (None: the card)."""
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int32)).to(
            _build.resolve_device(device))
    return hash_fixed(values, rate, domain)[0]
