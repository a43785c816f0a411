"""The leaves' and epoch program's share of their roofline in the traced
requests: the least time for the sponge's permutations and the program's
products (``benchmark/layers/leaves.py``) over the device time launched
inside the spans of ``ops/poseidon.hash_fixed`` and ``EpochProgram.apply``."""

from benchmark import peaks


def read(ctx):
    st = ctx.trace.layer("leaves") if ctx.trace else None
    if st is None or st.device_s <= 0:
        return None
    return 100.0 * peaks.bound_seconds(st.muls, st.nbytes) / st.device_s
