"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch.core import kernels_grand, kernels_jacobi, kernels_multilayer, kernels_rowlayer

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tensorcircuit_ng_tpu_torch"


def test_import_leaves_jax_out():
    # tests/conftest.py imports jax into this process, so look from a fresh one
    code = (
        "import sys\n"
        "import tensorcircuit_ng_tpu_torch\n"
        "from tensorcircuit_ng_tpu_torch.core import kernels, kernels_stack, kernels_jacobi, linalg, _build\n"
        "from tensorcircuit_ng_tpu_torch.core import kernels_multilayer\n"
        "from tensorcircuit_ng_tpu_torch.models import tebd\n"
        "from tensorcircuit_ng_tpu_torch import convert\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'tensorcircuit_ng_tpu' or m.startswith('tensorcircuit_ng_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_source(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "tensorcircuit_ng_tpu"), f"{path}: imports {mod}"


def test_cuda_default_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.Circuit(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tct.Circuit(4, device="cuda")


def test_tebd_default_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.ParallelTEBD(6, 4, initial="neel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tct.ParallelTEBD(6, 4, device="cuda")
    with tct.set_device("cpu"):
        assert tct.ParallelTEBD(6, 4).gammas.device == torch.device("cpu")


def test_tebd_state_defaults_to_card(monkeypatch):
    """``convert.tebd_state``, like the other converters, runs on the card
    unless asked."""
    g, lam = tct.ParallelTEBD.initial_tensors(4, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.convert.tebd_state(g, lam)
    with tct.set_device("cpu"):
        tg, tlam = tct.convert.tebd_state(g, lam)
    assert tg.device == tlam.device == torch.device("cpu")
    assert tg.dtype == torch.complex64 and tlam.dtype == torch.float32


@pytest.mark.parametrize("fn", ["params", "state", "planes"])
def test_convert_defaults_to_card(monkeypatch, fn):
    """convert's entry points, like Circuit, run on the card unless asked."""
    x = np.ones(256, dtype=np.complex64) if fn != "params" else np.ones((2, 2, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tct.set_device("cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tct.convert, fn)(x)
    with tct.set_device("cpu"):
        out = getattr(tct.convert, fn)(x)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(t.device == torch.device("cpu") for t in outs)


def test_device_and_dtype_scopes_restore():
    before = tct.get_device(), tct.dtypestr()
    with tct.set_device("cpu"):
        assert tct.get_device() == "cpu"
        assert tct.Circuit(3).device == torch.device("cpu")
        with tct.set_dtype("float64") as (c, r):
            assert (c, r) == ("complex128", "float64")
            assert tct.Circuit(3).state().dtype == torch.complex128
    assert (tct.get_device(), tct.dtypestr()) == before


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither CPU nor CUDA never reaches a plain version."""
    sr = torch.empty((8, 128), device="meta")
    th = torch.zeros(3)
    with pytest.raises(ValueError, match="no kernel"):
        kernels_rowlayer.zzrx_fwd(((0, 1),), 10, torch.zeros(1), th, sr, sr)
    m = torch.empty((2, 2, 2), device="meta")
    lane = torch.empty((2, 128, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels_grand.grand_zzrx_fwd(
            ((0, 1),), 10, torch.zeros((2, 1)), torch.zeros((2, 2)), sr, sr, m, m, lane, lane
        )
    with pytest.raises(ValueError, match="no kernel"):
        kernels_rowlayer.zzrx_bwd(((0, 1),), 10, torch.zeros(1), th, sr, sr, sr, sr)
    ks = torch.empty((2, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels_grand.grand_zzrx_bwd(
            ((0, 1),), 10, torch.zeros((2, 1)), torch.zeros((2, 1)), ks, ks, sr, sr,
            m, m, lane, lane,
        )
    planes = torch.empty((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels_jacobi.jacobi_rotations(planes, planes, 10, True)


def test_h_layer_on_inputs_needs_unported_kernel():
    """h_layer on ``inputs=`` is not folded: it runs as a constant row layer
    (K8 backward on the card; here the plain versions) and matches the
    dense H^{(x)n} on the input state.  The name dates from before the row
    kernels were ported, when this raised NotImplementedError."""
    n = 9
    rng = np.random.default_rng(0)
    psi = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    psi /= np.linalg.norm(psi)
    c = tct.Circuit(n, inputs=psi, device="cpu")
    c.h_layer()
    hn = np.ones((1, 1))
    for _ in range(n):
        hn = np.kron(hn, np.array([[1, 1], [1, -1]]) / np.sqrt(2))
    np.testing.assert_allclose(c.state().numpy(), hn @ psi, rtol=0, atol=2e-6)


def test_row_kernel_wrappers_refuse_other_devices():
    """K6, K7 and K8 take a plain version only for CPU tensors."""
    sr = torch.empty((8, 128), device="meta")
    g = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="no kernel"):
        kernels_rowlayer.row_fwd(g, g, sr, sr)
    with pytest.raises(ValueError, match="no kernel"):
        kernels_rowlayer.row_bwd(g, g, sr, sr, sr, sr)
    with pytest.raises(ValueError, match="no kernel"):
        kernels_rowlayer.row_bwd_const(g, g, sr, sr)


def test_multilayer_and_rotx_wrappers_refuse_other_devices():
    """K9, K10, K11 and K12 take a plain version only for CPU tensors."""
    sr = torch.empty((8, 256), device="meta")
    m = torch.empty((2, 256, 256), device="meta")
    zz, th = torch.zeros((2, 1)), torch.zeros((2, 3))
    with pytest.raises(ValueError, match="no kernel"):
        kernels_multilayer.ml_fwd(((0, 1),), 11, zz, th, sr, sr, m, m)
    with pytest.raises(ValueError, match="no kernel"):
        kernels_multilayer.ml_bwd(((0, 1),), 11, zz, th, sr, sr, sr, sr, m, m)
    sr = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels_rowlayer.rotx_fwd(torch.zeros(3), sr, sr)
    with pytest.raises(ValueError, match="no kernel"):
        kernels_rowlayer.rotx_bwd(torch.zeros(3), sr, sr, sr, sr)
