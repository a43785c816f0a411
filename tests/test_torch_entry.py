"""The port's pipeline step (``snarkos_tpu_torch/entry.py``: Poseidon, then
the NTT, then a square) on the CPU against the JAX package's host
references, and its inputs against ``__graft_entry__.entry()``'s; in the
slow tier, against the JAX package's jitted forward."""

import os
import sys

import numpy as np
import pytest
import torch

from snarkos_tpu.crypto.ref import ntt as jntt_ref
from snarkos_tpu.crypto.ref import poseidon as jpos_ref
from snarkos_tpu_torch import entry as port_entry
from snarkos_tpu_torch.ops.fieldspec import FR

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the plain versions run many small tensor ops: intra-op threads only add
# contention when test workers share the CPU
torch.set_num_threads(1)


def _dec(t):
    return FR.decode_fast(t.numpy(), mont=True)


def test_forward_matches_host_composition():
    forward, (seed, ctr) = port_entry.entry(log_n=6, device="cpu")
    out = forward(seed, ctr)
    assert out.shape == (FR.nlimbs, 64) and out.dtype == torch.int32
    coeffs = [jpos_ref.hash_many([s, c], rate=2, domain="graft.entry")[0]
              for s, c in zip(_dec(seed), _dec(ctr))]
    assert _dec(out) == [v * v % FR.p for v in jntt_ref.ntt(coeffs)]


def test_inputs_match_graft_entry():
    """``entry()``'s (seed, ctr) at n = 1024 are the JAX entry's arrays
    (building them compiles nothing)."""
    import __graft_entry__ as graft

    _, (jseed, jctr) = graft.entry()
    _, (seed, ctr) = port_entry.entry(device="cpu")
    np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed))
    np.testing.assert_array_equal(ctr.numpy(), np.asarray(jctr))


@pytest.mark.slow
def test_forward_matches_jax_forward():
    import jax

    import __graft_entry__ as graft

    jforward, jargs = graft.entry()
    want = np.asarray(jax.jit(jforward)(*jargs))
    forward, args = port_entry.entry(device="cpu")
    np.testing.assert_array_equal(forward(*args).numpy(), want)
