"""The PyTorch port stands alone: no module of snarkos_tpu_torch, nor
chip_smoke.py, imports JAX, the JAX package or its native engines
(``native/``, loaded through ``snarkos_tpu.utils.native``); no kernel wrapper catches an
exception around a launch (a CUDA tensor launches its kernel or raises); the
entry points default to the card and refuse to run without one."""

import ast
import os

import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "snarkos_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "snarkos_tpu", "native")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = [m for m in _imported(tree) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _calls_kernel(node) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if name == "launch" or name.endswith("_kernel"):
                return True
    return False


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_fallback_around_kernel_launch(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.handlers:
            assert not any(_calls_kernel(stmt) for stmt in node.body), (
                f"{path}:{node.lineno} catches an exception around a kernel launch")


def test_entry_points_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from snarkos_tpu_torch import convert
    from snarkos_tpu_torch.ops import _build
    from snarkos_tpu_torch.ops.puzzle import Puzzle, PuzzleSRS

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Puzzle(log_degree=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PuzzleSRS.dev(log_degree=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.points(*[torch.zeros((24, 1), dtype=torch.int32).numpy()] * 3)
    # the verifier half: the device is resolved before any file is read or
    # any point is decoded
    from snarkos_tpu_torch.crypto import srs_artifact
    from snarkos_tpu_torch.crypto.ref import g1 as ref_g1, kzg as ref_kzg
    from snarkos_tpu_torch.ops import kzg

    with pytest.raises(RuntimeError, match="no CUDA device"):
        PuzzleSRS.from_artifact("no-such-artifact.srs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        srs_artifact.load_srs("no-such-artifact.srs")
    srs = ref_kzg.SRS(powers_g1=[ref_g1.GENERATOR], h=None, tau_h=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kzg.batch_verify(srs, [(ref_g1.GENERATOR, 1, 1, ref_g1.INFINITY)])
    # the pipeline step builds its inputs on the card by default
    from snarkos_tpu_torch import entry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    assert _build.resolve_device("cpu").type == "cpu"


def test_global_puzzle_keys_the_device(monkeypatch):
    """The cached puzzle is handed out only for its own log degree and
    device: a CPU instance never answers a call for the card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import types

    from snarkos_tpu_torch.ops import puzzle

    stub = types.SimpleNamespace(log_degree=3, device=torch.device("cpu"))
    monkeypatch.setattr(puzzle, "_PUZZLE", stub)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        puzzle.global_puzzle(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        puzzle.global_puzzle()
    assert puzzle.global_puzzle(3, "cpu") is stub
    assert puzzle.global_puzzle(device="cpu") is stub


def test_kernel_wrappers_reject_cpu_tensors():
    """The launchers take only what their kernels take; they never run the
    plain version."""
    from snarkos_tpu_torch.ops import g1, g1_kernels, msm_kernels, ntt, poseidon, puzzle
    from snarkos_tpu_torch.ops import modarith as fa
    from snarkos_tpu_torch.ops.fieldspec import FQ, FR

    a = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.mont_mul_kernel(FR, a, a)
    with pytest.raises(ValueError, match="expected"):
        fa.mont_mul_kernel(FQ, a, a)
    state = torch.zeros((3, 16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        poseidon.permute_kernel(state, 2)
    with pytest.raises(ValueError, match="expected"):
        poseidon.permute_kernel(state, 4)
    v = torch.zeros((16, 2, 4), dtype=torch.int32)
    perm = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        puzzle.epoch_step_kernel(v, perm, perm, a)
    p = g1.infinity((4,))
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.add_kernel(p, p)
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.horner_kernel(p, p, 3)
    idx = torch.zeros(4, dtype=torch.int64)
    mask = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.bucket_fixup_kernel((p.x, p.y, p.z), idx, (p.x, p.y, p.z), idx, mask, mask)
    flag = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        g1_kernels.seg_prefix_kernel(flag, p.x, p.y, p.z)
    xs = torch.zeros((24, 2, 4), dtype=torch.int32)
    fl = torch.zeros((1, 2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_scan_serial_kernel(xs, xs, fl)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_scan_kernel(xs, xs, fl, 2)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_scan_fast_kernel(xs, xs, fl, fl, 2)
    with pytest.raises(ValueError, match="CUDA"):
        msm_kernels.bucket_total_kernel(p.x, p.y, p.z)
    with pytest.raises(ValueError, match="CUDA"):
        ntt.pass_kernel(v, torch.empty_like(v), a[:, :3], 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ntt.pass_kernel(v, v, a[:, :3], 1, 1)
    assert fa.mont_mul_kernel.launches == 0
    assert ntt.pass_kernel.launches == 0
    assert poseidon.permute_kernel.launches == puzzle.epoch_step_kernel.launches == 0
    assert g1_kernels.seg_prefix_kernel.launches == 0
    assert g1_kernels.horner_kernel.launches == g1_kernels.bucket_fixup_kernel.launches == 0
    assert msm_kernels.bucket_scan_fast_kernel.launches == 0
    assert msm_kernels.bucket_total_kernel.launches == 0
