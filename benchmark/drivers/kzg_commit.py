"""A KZG commitment on the card: ``ops/kzg.commit`` of a polynomial of
2^log_degree coefficients over SRS powers [tau^i G] of the known dev tau,
timed until the commitment is decoded on the host, as the ledger's
``device_commit`` returns it.

Configuration keys: ``log_degree``, ``tau_exponent`` (tau = 22^e mod r),
``check_sample`` (commitments the reference recomputes a run).
Traffic keys: ``pool`` (polynomials made from the seed in set-up; request i
commits polynomial i mod pool).

The SRS powers are built on the card from tau by the program's own group
arithmetic (``ops/g1.scalar_mul``, ``to_affine``); the host copy that
``PuzzleSRS.dev_powers`` also makes is not needed here. The pool is drawn on
the card from a ``torch.Generator`` seeded with the seed: 16-bit limbs in
Montgomery form, the top limb below r's, so each coefficient is below r.
The reference recomputes p(tau) G for a sample of the window's commitments
drawn from the seed; it never reads the SRS.
"""

from __future__ import annotations

R_TOP_LIMB = 0x12AB  # r's top 16-bit limb: a value with a smaller top limb is below r


class System:
    """The SRS powers on ``device`` and the commit the window times."""

    def __init__(self, config: dict, device: str):
        import torch

        from snarkos_tpu_torch.ops import g1, ntt
        from snarkos_tpu_torch.ops import modarith as fa
        from snarkos_tpu_torch.ops.fieldspec import FQ, FR

        from benchmark.reference.bls12_377 import GENERATOR

        self.device = torch.device(device)
        n = self.n = 1 << config["log_degree"]
        self.tau = tau(config)
        tau_m = torch.from_numpy(FR.encode_fast([self.tau], mont=True)).to(self.device)
        scalars = fa.from_mont(FR, ntt.geometric_powers(tau_m, n)).contiguous()
        gen = g1.encode_points([GENERATOR], device=self.device)
        gen = g1.JacobianPoints(*(t.expand(-1, n).contiguous() for t in (gen.x, gen.y, gen.z)))
        x, y, _ = g1.to_affine(g1.scalar_mul(gen, scalars))
        one = fa.broadcast_const(FQ, 1, (n,), device=self.device).contiguous()
        self.points = g1.JacobianPoints(x.contiguous(), y.contiguous(), one)

    def commit(self, coeffs_mont):
        from snarkos_tpu_torch.ops import g1, kzg

        return g1.decode_points(kzg.commit(self.points, coeffs_mont))[0]


def tau(config: dict) -> int:
    from benchmark.reference.bls12_377 import R

    return pow(22, config["tau_exponent"], R)


def build(config: dict, device: str) -> System:
    from snarkos_tpu_torch.ops import _build

    if device != "cpu":
        _build.build()  # every missing kernel and host engine at once
    return System(config, device)


class Cell:
    def __init__(self, system: System, config: dict, traffic: dict, seed: int):
        import torch

        self.system, self.config = system, config
        self.device = system.device
        self.units = system.n
        size = int(traffic["pool"])
        g = torch.Generator(device=system.device)
        g.manual_seed(seed)
        pool = torch.randint(0, 1 << 16, (size, 16, system.n), generator=g,
                             device=system.device, dtype=torch.int32)
        pool[:, 15] = torch.randint(0, R_TOP_LIMB, (size, system.n), generator=g,
                                    device=system.device, dtype=torch.int32)
        self.pool = pool

    def call(self, i: int):
        return self.system.commit(self.pool[i % len(self.pool)])

    def warm(self):
        for i in range(2):
            self.call(i)

    def check(self, window, seed: int) -> dict:
        from benchmark import harness
        from benchmark.reference import bls12_377 as curve
        from benchmark.reference import kzg as ref_kzg

        picked = harness.sample(window.done, self.config["check_sample"], seed)
        wrong = 0
        for rec in picked:
            limbs = self.pool[rec.index % len(self.pool)].cpu().numpy()
            ref = ref_kzg.commitment(limbs, self.system.tau)
            got = rec.output
            if not (isinstance(got, tuple) and len(got) == 3 and curve.on_curve(got)
                    and curve.to_bytes(got) == ref):
                wrong += 1
        return {"mismatched": {"value": wrong, "limit": 0, "sampled": len(picked)}}
