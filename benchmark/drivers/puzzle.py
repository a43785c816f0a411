"""The Prover's puzzle: ``Puzzle.prove_batch`` of consecutive nonces, as the
Prover role's puzzle loop sends them (``node/roles.py``), with no proof
target, so that every nonce's solution comes back to be judged.

Configuration keys: ``log_degree`` (K = 2^log_degree coefficients a
nonce). Traffic keys: ``batch`` (nonces a request).

A seed gives the epoch hash, the prover's address and the first nonce;
request i proves nonces first + 1 + i batch, ..., first + (i + 1) batch,
mod 2^64. The reference recomputes one solution of every slot of the batch
(position 0 to batch - 1), each from a batch drawn from the seed, so that a
fault confined to one slot shows in every run; each whole (commitment,
eval_y, witness, solution id), in worker processes. The one number
compared, ``mismatched``, counts the sampled solutions that differ from the
reference and every nonce of a completed batch that came back without a
solution; its limit is 0.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import subprocess
import sys

MASK64 = (1 << 64) - 1


def build(config: dict, device: str):
    """The program's puzzle for the configuration's log degree on
    ``device``: its dev SRS built there."""
    from snarkos_tpu_torch.ops import _build, puzzle

    if device != "cpu":
        _build.build()  # every missing kernel and host engine at once
    return puzzle.global_puzzle(config["log_degree"], device)


def seed_inputs(seed: int) -> tuple:
    """(epoch hash, address, first nonce) of a seed."""
    h = hashlib.sha256(f"benchmark.puzzle:{seed}".encode()).digest()
    epoch_hash = hashlib.sha256(b"epoch" + h).digest()
    address = "aleo1" + hashlib.sha256(b"address" + h).hexdigest()[:58]
    return epoch_hash, address, int.from_bytes(h[:8], "little")


class Cell:
    def __init__(self, system, config: dict, traffic: dict, seed: int):
        self.system, self.config = system, config
        self.device = system.device
        self.batch = int(traffic["batch"])
        self.units = self.batch
        self.k = 1 << config["log_degree"]
        self.epoch_hash, self.address, self.first = seed_inputs(seed)

    def nonces(self, i: int) -> list:
        base = self.first + 1 + i * self.batch
        return [(base + j) & MASK64 for j in range(self.batch)]

    def call(self, i: int) -> list:
        return self.system.prove_batch(self.epoch_hash, self.address, self.nonces(i))

    def warm(self):
        """Two batches of this cell's shape on nonces the window does not
        send (the epoch program is built by the first)."""
        for i in (-2, -1):
            self.system.prove_batch(self.epoch_hash, self.address, self.nonces(i - (1 << 40)))

    def check(self, window, seed: int) -> dict:
        missing, batches = 0, []
        for rec in window.done:
            sols = list(rec.output or [])
            missing += max(0, self.batch - len(sols))
            batches.append(list(zip(self.nonces(rec.index), sols)))
        picked = sample_slots(batches, self.batch, seed)
        refs = reference_solutions(self.epoch_hash, self.address, [n for n, _ in picked],
                                   self.config["log_degree"])
        wrong = sum(1 for (_, sol), ref in zip(picked, refs) if _as_dict(sol) != ref)
        return {"mismatched": {"value": wrong + missing, "limit": 0, "sampled": len(picked),
                               "missing": missing}}


def sample_slots(batches: list, width: int, seed: int) -> list:
    """One answer of every slot 0 .. width - 1, each from a batch drawn
    from the seed, the batches distinct while there are enough; a slot that
    the drawn batch did not fill is left out (it counts as missing)."""
    if not batches:
        return []
    rng = random.Random(f"check:{seed}")
    drawn = rng.sample(range(len(batches)), min(width, len(batches)))
    picked = []
    for slot in range(width):
        answers = batches[drawn[slot % len(drawn)]]
        if slot < len(answers):
            picked.append(answers[slot])
    return picked


def _as_dict(sol) -> dict:
    return {"commitment": sol.commitment.hex(), "eval_y": sol.eval_y,
            "witness": sol.witness.hex(), "solution_id": sol.solution_id}


def reference_solutions(epoch_hash: bytes, address: str, nonces: list, log_degree: int,
                        workers: int | None = None) -> list:
    """The reference's solutions of ``nonces``, in order, from
    ``min(len(nonces), cpu count)`` worker processes (``python3 -m
    benchmark.reference.worker``), each started and waited for here."""
    if not nonces:
        return []
    workers = max(1, min(len(nonces), workers or os.cpu_count() or 1))
    shares = [nonces[w::workers] for w in range(workers)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs, results = [], []
    try:
        for share in shares:
            p = subprocess.Popen([sys.executable, "-m", "benchmark.reference.worker"],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=root,
                                 text=True)
            procs.append(p)
            p.stdin.write(json.dumps({"epoch_hash": epoch_hash.hex(), "address": address,
                                      "nonces": share, "log_degree": log_degree}))
            p.stdin.close()
        for p in procs:
            out = p.stdout.read()
            if p.wait() != 0:
                raise RuntimeError(f"reference worker exited {p.returncode}")
            results.append(json.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            p.stdout.close()
    by_nonce = {}
    for share, res in zip(shares, results):
        by_nonce.update(zip(share, res))
    return [by_nonce[n] for n in nonces]
