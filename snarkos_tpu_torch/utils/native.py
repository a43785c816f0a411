"""ctypes bindings of the host engines: the port's own C++ BLS12-377 pairing,
G1 MSM and Poseidon sponge (``csrc/host/``), with the names, byte layouts and
contracts of the JAX package's ``utils/native.py``.

``ops/_build.py`` builds each engine with ``g++`` into ``build/host/`` on
first use. Two rules differ from the reference's module, on purpose:
- an engine that cannot be built or loaded raises ``RuntimeError`` (with the
  compiler's log); there is no ``have_*`` predicate and no quiet fall-back
  to the pure-Python versions, so a node whose engines cannot build stops
  (``node.ledger.is_device_fault``) instead of running slowly;
- the loads and each rate's ``poseidon377_init`` run under one lock, so the
  node's executor threads (ctypes releases the GIL) build, bind and
  initialise an engine once.

``None`` still means malformed input, as in the reference (an off-curve
point: the engine returns rc < 0); the callers in ``crypto/ref`` hand that
case to their plain Python versions, which decide what it means.

Each engine entry adds one to its count, ``engine.<entry>`` in the registry
of ``utils/tracing.py`` (``call_counts``), which a node prints as it stops
and serves on ``/metrics``, and the chip check reads a path.

``sha256d``, ``sha256d_batch`` and ``assign_to_worker`` are ``hashlib``'s
(OpenSSL's SHA-256), ``limbs_to_bytes`` / ``bytes_to_limbs`` numpy's: the
reference's own bodies for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import threading

import numpy as np

from snarkos_tpu_torch.crypto import params
from snarkos_tpu_torch.ops import _build
from snarkos_tpu_torch.utils import tracing

_LOCK = threading.Lock()
_LIBS: dict = {}
_RATES: set = set()  # (engine path, rate) pairs whose tables are registered

POSEIDON_MAX_RATE = 8  # the sponge engine's widest state: rate 8 + capacity 1

_p, _l, _i, _u64 = ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_uint64
_SIGNATURES = {
    "pairing377": {
        "pairing377_multi": ([_p, _p, _l, _p], _i),
        "pairing377_check": ([_p, _p, _l], _i),
        "g2_scalar_mul377": ([_p, _p, _p], _i),
    },
    "g1_msm": {
        "g1_msm": ([_p, _p, _l, _p], _i),
        "g1_msm_mt": ([_p, _p, _l, _i, _p], _i),
        "g1_fixed_base_gen": ([_u64, _l, ctypes.c_void_p], _i),
    },
    "poseidon377": {
        "poseidon377_init": ([_i, _p, _p], _i),
        "poseidon377_hash_many": ([_i, _p, _p, _l, _p, _l], _i),
        "poseidon377_permute": ([_i, _p], _i),
    },
}


def bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of engine ``name``'s entry points
    on ``lib``."""
    for symbol, (args, res) in _SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = args
        fn.restype = res
    return lib


def engine(name: str) -> ctypes.CDLL:
    """The loaded, bound engine ``name`` (built first if missing); raises
    ``RuntimeError`` if it cannot be built."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = bind(name, _build.load_host(name))
                _LIBS[name] = lib
    return lib


def load_engines() -> None:
    """Build and load every engine now (a node's start-up), so that a host
    that cannot build them fails before it serves anything."""
    for name in _build.HOST_SOURCES:
        engine(name)


def _count(entry: str) -> None:
    tracing.count("engine." + entry)


def call_counts() -> dict:
    """The calls of each engine entry in this process since the last
    ``reset_counts``, by the entry's name."""
    return {name[len("engine."):]: n for name, n in tracing.counters("engine.").items()}


def reset_counts() -> None:
    tracing.reset("engine.")


# -- hashes and limbs (the reference's own bodies) ------------------------------

def sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def sha256d_batch(items: list[bytes]) -> list[bytes]:
    """Batch sha256d for transmission-ID hashing."""
    h = hashlib.sha256
    return [h(h(i).digest()).digest() for i in items]


def assign_to_worker(ids: list[bytes], num_workers: int) -> list[int]:
    """Double-sha256-based worker partition: the first byte of each id's
    sha256d mod the worker count."""
    return [d[0] % num_workers for d in sha256d_batch(ids)]


def limbs_to_bytes(limbs: np.ndarray) -> bytes:
    """(L, B) int32 16-bit limbs -> B packed 2L-byte LE strings."""
    limbs = np.ascontiguousarray(limbs, dtype=np.int32)
    return limbs.T.astype("<u2").tobytes()


def bytes_to_limbs(data: bytes, nlimbs: int) -> np.ndarray:
    """Packed LE byte strings -> (L, B) int32 limb array."""
    B = len(data) // (2 * nlimbs)
    arr = np.frombuffer(data, dtype="<u2").reshape(B, nlimbs)
    return arr.T.astype(np.int32)


# -- the G1 engine (csrc/host/g1_msm.cpp) ----------------------------------------

def _g1_inputs(scalars, affine_points) -> tuple[bytes, bytes]:
    sbuf = b"".join(int(k).to_bytes(32, "little") for k in scalars)
    pbuf = b"".join(int(x).to_bytes(48, "little") + int(y).to_bytes(48, "little")
                    for x, y in affine_points)
    return sbuf, pbuf


def _jacobian(raw: bytes) -> tuple:
    return tuple(int.from_bytes(raw[i * 48:(i + 1) * 48], "little") for i in range(3))


def g1_fixed_base_gen(seed: int, n: int) -> np.ndarray:
    """n pseudo-random curve points k_i G (64-bit splitmix64 k_i, odd):
    SRS-like, structure-free bases for MSM benchmarks and tests. Returns an
    (n, 12) uint64 array of canonical little-endian affine x || y limbs (6 +
    6 a point)."""
    _count("g1_fixed_base_gen")
    out = np.empty((n, 12), dtype=np.uint64)
    if engine("g1_msm").g1_fixed_base_gen(seed, n, out.ctypes.data) != 0:
        raise RuntimeError("g1_fixed_base_gen failed")
    return out


def g1_msm(scalars: list, affine_points: list) -> tuple:
    """Windowed-Pippenger MSM on one thread. scalars: canonical Fr ints;
    affine_points: (x, y) canonical Fq int pairs. Returns a Jacobian (X, Y, Z)
    tuple of canonical ints (Z = 0: the identity)."""
    _count("g1_msm")
    sbuf, pbuf = _g1_inputs(scalars, affine_points)
    out = ctypes.create_string_buffer(144)
    if engine("g1_msm").g1_msm(sbuf, pbuf, len(scalars), out) != 0:
        raise RuntimeError("g1_msm failed")
    return _jacobian(out.raw)


def g1_msm_mt(scalars: list, affine_points: list, nthreads: int = 0) -> tuple:
    """``g1_msm`` with the points split over ``nthreads`` threads (<= 0: the
    hardware's), the partial sums added: a CPU baseline at machine scale."""
    _count("g1_msm_mt")
    sbuf, pbuf = _g1_inputs(scalars, affine_points)
    out = ctypes.create_string_buffer(144)
    if engine("g1_msm").g1_msm_mt(sbuf, pbuf, len(scalars), int(nthreads), out) != 0:
        raise RuntimeError("g1_msm_mt failed")
    return _jacobian(out.raw)


# -- the pairing engine (csrc/host/pairing377.cpp) --------------------------------

def _enc_g1_affine(p) -> bytes:
    """Affine (x, y) canonical ints -> 96 LE bytes; None -> all-zero (inf)."""
    if p is None:
        return b"\0" * 96
    return int(p[0]).to_bytes(48, "little") + int(p[1]).to_bytes(48, "little")


def _enc_g2_affine(q) -> bytes:
    """Affine ((x0, x1), (y0, y1)) -> 192 LE bytes; None -> all-zero (inf)."""
    if q is None:
        return b"\0" * 192
    (x0, x1), (y0, y1) = q
    return b"".join(int(v).to_bytes(48, "little") for v in (x0, x1, y0, y1))


def _enc_pairs(pairs) -> tuple[bytes, bytes]:
    return (b"".join(_enc_g1_affine(p) for p, _ in pairs),
            b"".join(_enc_g2_affine(q) for _, q in pairs))


def pairing_check(pairs) -> bool | None:
    """prod_i e(P_i, Q_i) == 1? pairs: [(g1_affine, g2_affine)], None = inf.
    Returns True / False, or None if an input point is off its curve (the
    caller's plain version decides what malformed means)."""
    _count("pairing_check")
    g1b, g2b = _enc_pairs(pairs)
    rc = engine("pairing377").pairing377_check(g1b, g2b, len(pairs))
    if rc < 0:
        return None
    return rc == 1


def multi_pairing(pairs):
    """The exact reduced pairing product, bit for bit the plain version's
    (``crypto/ref/pairing.multi_pairing_plain``): the flat-basis Fq12 tuple
    ((c0a, c0b), ..., (c5a, c5b)), or None if an input point is off its
    curve."""
    _count("multi_pairing")
    g1b, g2b = _enc_pairs(pairs)
    out = ctypes.create_string_buffer(1152)
    if engine("pairing377").pairing377_multi(g1b, g2b, len(pairs), out) != 0:
        return None
    raw = out.raw
    return tuple(
        (int.from_bytes(raw[i * 96:i * 96 + 48], "little"),
         int.from_bytes(raw[i * 96 + 48:i * 96 + 96], "little"))
        for i in range(6)
    )


# the result of g2_scalar_mul at the point at infinity (None is malformed
# input, which the caller hands to its plain version; infinity must not)
G2_INF = object()


def g2_scalar_mul(k: int, q):
    """k Q on the G2 twist, k < 2^256; affine in and out. Returns the affine
    pair, ``G2_INF`` when the result is the point at infinity, or None if Q
    is off the twist."""
    _count("g2_scalar_mul")
    out = ctypes.create_string_buffer(192)
    if engine("pairing377").g2_scalar_mul377(int(k).to_bytes(32, "little"),
                                             _enc_g2_affine(q), out) != 0:
        return None
    raw = out.raw
    if not any(raw):
        return G2_INF
    return (
        (int.from_bytes(raw[0:48], "little"), int.from_bytes(raw[48:96], "little")),
        (int.from_bytes(raw[96:144], "little"), int.from_bytes(raw[144:192], "little")),
    )


# -- the Poseidon sponge (csrc/host/poseidon377.cpp) ------------------------------

def _poseidon(rate: int) -> ctypes.CDLL:
    """The sponge engine with ``rate``'s round constants and MDS registered
    (once an engine and rate, under the lock)."""
    if not 1 <= rate <= POSEIDON_MAX_RATE:
        raise ValueError(f"the Poseidon engine takes rates 1-{POSEIDON_MAX_RATE}, not {rate}")
    lib = engine("poseidon377")
    key = (lib._name, rate)
    if key not in _RATES:
        with _LOCK:
            if key not in _RATES:
                from snarkos_tpu_torch.crypto.ref import poseidon as ref_poseidon

                ark, mds = ref_poseidon.poseidon_params(rate)
                ark_b = b"".join(int(c).to_bytes(32, "little") for row in ark for c in row)
                mds_b = b"".join(int(c).to_bytes(32, "little") for row in mds for c in row)
                if lib.poseidon377_init(rate, ark_b, mds_b) != 0:
                    raise RuntimeError(f"poseidon377_init refused rate {rate}")
                _RATES.add(key)
    return lib


def poseidon_hash_many(inputs, rate: int, num_outputs: int, domain_field: int) -> list[int]:
    """The duplex sponge of ``crypto/ref/poseidon.hash_many_plain``: absorb
    ``inputs`` (reduced mod r) into a state whose capacity holds
    ``domain_field``, squeeze ``num_outputs`` canonical ints. Rates 1-8."""
    lib = _poseidon(rate)
    _count("poseidon_hash_many")
    inp = b"".join(int(x % params.FR_MODULUS).to_bytes(32, "little") for x in inputs)
    out = ctypes.create_string_buffer(32 * num_outputs)
    if lib.poseidon377_hash_many(rate, int(domain_field).to_bytes(32, "little"), inp,
                                 len(inputs), out, num_outputs) != 0:
        raise RuntimeError("poseidon377_hash_many failed")
    raw = out.raw
    return [int.from_bytes(raw[i * 32:(i + 1) * 32], "little") for i in range(num_outputs)]
