"""The MSM engine (``ops/msm``): the multi-MSM of the puzzle's commitments
and witnesses over one shared base, and the single MSM of a commitment.
Work: Pippenger at the best window for the call's n (``work.msm_work``)."""

from benchmark import work as w

LAYER = "MSM engine (ops/msm)"
TARGETS = ["snarkos_tpu_torch.ops.msm:msm_affine_multi",
           "snarkos_tpu_torch.ops.msm:msm_affine"]


def work(target: str, args: dict) -> tuple:
    shape = tuple(args["scalar_limbs"].shape)
    if target.endswith("msm_affine_multi"):  # (16, B, N): B MSMs of N points
        return w.msm_work(shape[2], shape[1])
    return w.msm_work(shape[-1])
