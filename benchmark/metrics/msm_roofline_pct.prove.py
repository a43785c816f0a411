"""The MSM engine's share of its roofline in the traced requests, over the
spans of ``ops/msm.msm_affine_multi``: the least time the card could take for
Pippenger's work at the best window (``benchmark/layers/msm.py``), over
the device time of the activities launched inside those spans."""

from benchmark import peaks

TARGET = "snarkos_tpu_torch.ops.msm:msm_affine_multi"


def read(ctx):
    st = ctx.trace.layer("msm", TARGET) if ctx.trace else None
    if st is None or st.device_s <= 0:
        return None
    return 100.0 * peaks.bound_seconds(st.muls, st.nbytes) / st.device_s
