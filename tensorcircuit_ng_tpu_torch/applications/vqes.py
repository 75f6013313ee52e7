"""VQNHE: variational quantum-neural hybrid eigensolver.

Counterpart of reference ``applications/vqes.py`` (tf.keras models + graph
building, ``:212-676``): the neural post-processor is a function
``(params, bitstrings) -> log f`` of a dict of tensors (MLP or RBM, real or
complex), the circuit is any parameterized ansatz over the port's
``Circuit``, and the hybrid energy

    E = <psi_f| H |psi_f> / <psi_f|psi_f>,   psi_f(s) = f(s) * psi_theta(s)

is computed densely (small-n regime, same as the reference, H on the
device) and optimized jointly by ``torch.optim.Adam`` with one parameter
group for the circuit and one for the model.  The initial parameters are
drawn from numpy as in the JAX package, so one seed starts both alike.
arXiv:2106.05105.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..backend import backend as K

Tensor = Any

__all__ = ["paulistring", "construct_matrix", "vqe_energy", "VQNHE"]


def paulistring(term: Sequence[int], device: Any = None) -> torch.Tensor:
    """Dense matrix of one Pauli string given per-qubit codes (0..3), in
    the configured dtype on ``device``."""
    from ..quantum import PauliStringSum2Dense

    return PauliStringSum2Dense([[int(x) for x in term]], [1.0], device=config.resolve_device(device))


def construct_matrix(ham: List[List[float]], device: Any = None) -> torch.Tensor:
    """Dense H from rows ``[weight, code_1, ..., code_n]`` (reference
    ``:55``), in the configured dtype on ``device``."""
    from ..quantum import PauliStringSum2Dense

    ls = [[int(x) for x in row[1:]] for row in ham]
    ws = [float(row[0]) for row in ham]
    return PauliStringSum2Dense(ls, ws, device=config.resolve_device(device))


construct_matrix_v2 = construct_matrix
construct_matrix_v3 = construct_matrix


def vqe_energy(c: Any, h: List[List[float]], reuse: bool = True) -> torch.Tensor:
    """⟨ψ|H|ψ⟩ for a circuit and list-form Hamiltonian (reference ``:114``)."""
    psi = c.state()
    hm = construct_matrix(h, device=psi.device)
    return torch.real(torch.vdot(psi, hm @ psi))


def vqe_energy_shortcut(c: Any, h: Tensor) -> torch.Tensor:
    psi = c.state()
    h = h if isinstance(h, torch.Tensor) else torch.as_tensor(np.asarray(h), device=psi.device)
    return torch.real(torch.vdot(psi, h.to(psi.dtype) @ psi))


def _all_bitstrings(n: int) -> np.ndarray:
    idx = np.arange(2**n)
    return ((idx[:, None] >> (n - 1 - np.arange(n))) & 1).astype(np.float32)


def _f32(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32).clone()
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


class VQNHE:
    """Joint circuit + neural-network wavefunction optimizer.

    :param n: qubit count
    :param hamiltonian: rows ``[w, code_1..code_n]`` (codes 0=I,1=X,2=Y,3=Z)
    :param model_type: "real" | "complex" | "rbm" | "complex-rbm"
    :param ansatz: "hea" (hardware-efficient rx/zz layers) or "hn"
        (Hadamard + neural only)
    :param nlayers: ansatz depth
    :param units: hidden width of the MLP models
    :param device: where H, the state and the parameters live
    """

    def __init__(
        self,
        n: int,
        hamiltonian: List[List[float]],
        model_type: str = "real",
        ansatz: str = "hea",
        nlayers: int = 2,
        units: int = 16,
        seed: int = 42,
        device: Any = None,
    ) -> None:
        self.n = n
        self.device = config.resolve_device(device)
        self.h = construct_matrix(hamiltonian, device=self.device)
        self.model_type = model_type
        self.ansatz = ansatz
        self.nlayers = nlayers
        self.units = units
        self.basis = torch.as_tensor(_all_bitstrings(n), device=self.device)
        rng = np.random.default_rng(seed)
        self.circuit_params = _f32(rng.normal(size=self._cparam_shape()) * 0.1, self.device)
        self.model_params = self._init_model(rng)

    # ------------------------------------------------------------- circuit

    def _cparam_shape(self) -> Tuple[int, ...]:
        return (self.nlayers, 2, self.n)

    def circuit_state(self, params: Tensor) -> torch.Tensor:
        from ..models.circuit import Circuit

        c = Circuit(self.n, device=self.device)
        c.h_layer()
        if self.ansatz == "hn":
            return c.state()
        pairs = [(i, i + 1) for i in range(self.n - 1)]
        for l in range(self.nlayers):
            c.rzz_product(pairs, params[l, 0, : self.n - 1])
            c.rx_layer(params[l, 1])
        return c.state()

    # -------------------------------------------------------------- models

    def _init_model(self, rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        u, n = self.units, self.n

        def mat(*shape):
            return _f32(rng.normal(size=shape) * 0.1, self.device)

        if self.model_type in ("real", "complex"):
            p = {"w1": mat(n, u), "b1": mat(u), "w2": mat(u, 1), "b2": mat(1)}
            if self.model_type == "complex":
                p.update({"pw1": mat(n, u), "pb1": mat(u), "pw2": mat(u, 1), "pb2": mat(1)})
            return p
        if self.model_type in ("rbm", "complex-rbm"):
            p = {"a": mat(n), "b": mat(u), "w": mat(n, u)}
            if self.model_type == "complex-rbm":
                p.update({"pa": mat(n), "pb": mat(u), "pw": mat(n, u)})
            return p
        raise ValueError(f"unknown model_type {self.model_type!r}")

    def _log_f(self, p: Dict[str, torch.Tensor], s: torch.Tensor) -> torch.Tensor:
        """log f(s) per basis state; complex for phase-carrying models."""
        if self.model_type in ("real", "complex"):
            h = torch.tanh(s @ p["w1"] + p["b1"])
            logmod = (h @ p["w2"] + p["b2"])[:, 0]
            if self.model_type == "real":
                return logmod.to(torch.complex64)
            ph = torch.tanh(s @ p["pw1"] + p["pb1"])
            phase = (ph @ p["pw2"] + p["pb2"])[:, 0]
            return logmod + 1j * phase.to(torch.complex64)
        # RBM: log f = a.s + sum log cosh(s W + b)
        logmod = s @ p["a"] + torch.sum(torch.log(torch.cosh(s @ p["w"] + p["b"])), dim=-1)
        if self.model_type == "rbm":
            return logmod.to(torch.complex64)
        phase = s @ p["pa"] + torch.sum(torch.log(torch.cosh(s @ p["pw"] + p["pb"])), dim=-1)
        return logmod + 1j * phase.to(torch.complex64)

    # -------------------------------------------------------------- energy

    def energy(self, cparams: Tensor, mparams: Dict[str, torch.Tensor]) -> torch.Tensor:
        psi = self.circuit_state(cparams)
        logf = self._log_f(mparams, self.basis)
        logf = logf - torch.amax(torch.real(logf))  # overflow guard
        psi_f = psi * torch.exp(logf).to(psi.dtype)
        num = torch.real(torch.vdot(psi_f, self.h @ psi_f))
        den = torch.real(torch.vdot(psi_f, psi_f))
        return num / den

    def plain_energy(self, cparams: Optional[Tensor] = None) -> float:
        cparams = self.circuit_params if cparams is None else cparams
        with torch.no_grad():
            psi = self.circuit_state(cparams)
            return float(torch.real(torch.vdot(psi, self.h @ psi)))

    # ------------------------------------------------------------ training

    def training(
        self,
        maxiter: int = 200,
        lr_circuit: float = 1e-2,
        lr_model: float = 5e-3,
        verbose: bool = False,
        jit: bool = True,
        history: Optional[List[float]] = None,
    ) -> Tuple[float, torch.Tensor, Dict[str, torch.Tensor]]:
        """Joint optimization; returns (best energy, circuit params, nn params).

        One ``torch.optim.Adam`` with two parameter groups (``lr_circuit``
        and ``lr_model``); the energy's value and both gradients go through
        ``backend.jit`` (a captured CUDA graph on the card; ``jit=False``
        runs them eagerly).  ``history``, if given, collects each step's
        energy."""
        cp = self.circuit_params.detach().clone()
        mp = {k: v.detach().clone() for k, v in self.model_params.items()}
        opt = torch.optim.Adam([{"params": [cp], "lr": lr_circuit},
                                {"params": list(mp.values()), "lr": lr_model}])
        step = K.jit(K.value_and_grad(self.energy, argnums=(0, 1)), jit_compile=jit)
        best = float("inf")
        for it in range(maxiter):
            e, (gc, gm) = step(cp, mp)
            cp.grad = gc
            for k, v in mp.items():
                v.grad = gm[k]
            opt.step()
            e = float(e)
            if history is not None:
                history.append(e)
            if e < best:
                best = e
                self.circuit_params = cp.detach().clone()
                self.model_params = {k: v.detach().clone() for k, v in mp.items()}
            if verbose and it % 50 == 0:
                print(f"iter {it}: E = {e:.6f}")
        return best, self.circuit_params, self.model_params

    multi_training = training  # reference API alias (single-process here)

    # ------------------------------------------------------ reference surface
    # (applications/vqes.py:72-676)

    def create_circuit(self, ansatz: Optional[str] = None, **kws: Any) -> Callable[[Tensor], Tensor]:
        """Return the ``params -> state`` function of the chosen ansatz (ref names
        create_circuit/create_hea_circuit/create_hn_circuit/create_hea2_circuit)."""
        if ansatz is not None:
            self.ansatz = ansatz
        return self.circuit_state

    def create_hea_circuit(self, **kws: Any) -> Callable[[Tensor], Tensor]:
        return self.create_circuit("hea", **kws)

    def create_hea2_circuit(self, **kws: Any) -> Callable[[Tensor], Tensor]:
        return self.create_circuit("hea", **kws)

    def create_hn_circuit(self, **kws: Any) -> Callable[[Tensor], Tensor]:
        return self.create_circuit("hn", **kws)

    def create_functional_circuit(self, fn: Callable[[Tensor], Tensor]) -> Callable[[Tensor], Tensor]:
        """Install a user ``params -> state`` function as the ansatz (ref name)."""
        self.circuit_state = fn  # type: ignore[assignment]
        return fn

    def create_model(self, model_type: Optional[str] = None, **kws: Any) -> Dict[str, torch.Tensor]:
        """(Re)initialize the neural post-processor (reference create_*_model)."""
        if model_type is not None:
            self.model_type = model_type
        rng = np.random.default_rng(kws.pop("seed", 0))
        self.model_params = self._init_model(rng)
        return self.model_params

    def create_real_model(self, **kws: Any) -> Dict[str, torch.Tensor]:
        return self.create_model("real", **kws)

    def create_complex_model(self, **kws: Any) -> Dict[str, torch.Tensor]:
        return self.create_model("complex", **kws)

    def create_real_rbm_model(self, **kws: Any) -> Dict[str, torch.Tensor]:
        return self.create_model("rbm", **kws)

    def create_complex_rbm_model(self, **kws: Any) -> Dict[str, torch.Tensor]:
        return self.create_model("complex-rbm", **kws)

    def assign(self, cparams: Optional[Tensor] = None, mparams: Optional[Any] = None) -> None:
        """Overwrite current variational parameters (reference ``assign``):
        arrays or tensors, carried to float32 on the device."""
        if cparams is not None:
            self.circuit_params = _f32(cparams, self.device)
        if mparams is not None:
            self.model_params = {k: _f32(v, self.device) for k, v in mparams.items()}

    def evaluation(self, cparams: Optional[Tensor] = None, mparams: Optional[Any] = None) -> Tuple[float, float]:
        """(hybrid energy, plain circuit energy) at given/current params."""
        cp = self.circuit_params if cparams is None else _f32(cparams, self.device)
        mp = self.model_params if mparams is None else {k: _f32(v, self.device) for k, v in mparams.items()}
        with torch.no_grad():
            e = float(self.energy(cp, mp))
        return e, self.plain_energy(cp)

    def plain_evaluation(self, cparams: Optional[Tensor] = None) -> float:
        return self.plain_energy(cparams)

    def save(self, path: str) -> None:
        """Pickle current parameters as numpy arrays (reference ``save``):
        the JAX package's ``load`` reads the file, and this ``load`` reads
        its files."""
        import pickle

        with open(path, "wb") as f:
            pickle.dump(
                {
                    "circuit_params": self.circuit_params.detach().cpu().numpy(),
                    "model_params": {k: v.detach().cpu().numpy() for k, v in self.model_params.items()},
                    "model_type": self.model_type,
                    "ansatz": self.ansatz,
                },
                f,
            )

    def load(self, path: str) -> None:
        """Restore parameters from :meth:`save` output (reference ``load``)."""
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f)
        self.model_type = data["model_type"]
        self.ansatz = data["ansatz"]
        self.assign(data["circuit_params"], data["model_params"])

    recover = load  # reference alias


# ======================================================================
# reference-parity surface (applications/vqes.py:72-676)
# ======================================================================

construct_matrix_tf = construct_matrix  # reference TF-era alias


class Linear:
    """Complex-weight dense layer (reference ``vqes.py:139``), functional form.

    ``layer = Linear(units, input_dim); y = layer(params, x)`` with
    ``params = layer.init(rng)`` holding real and imaginary kernels
    (``wr``, ``wi``: ``(input_dim, units)``; ``br``, ``bi``), float32 on
    ``device``; the JAX package's dicts carry over by name.
    """

    def __init__(self, units: int, input_dim: int, stddev: float = 0.1, device: Any = None):
        self.units = units
        self.input_dim = input_dim
        self.stddev = stddev
        self.device = config.resolve_device(device)

    def init(self, rng: Optional[np.random.Generator] = None) -> Dict[str, torch.Tensor]:
        rng = rng or np.random.default_rng()
        shape = (self.input_dim, self.units)
        return {
            "wr": _f32(rng.normal(scale=self.stddev, size=shape), self.device),
            "wi": _f32(rng.normal(scale=self.stddev, size=shape), self.device),
            "br": torch.zeros((self.units,), dtype=torch.float32, device=self.device),
            "bi": torch.zeros((self.units,), dtype=torch.float32, device=self.device),
        }

    def __call__(self, params: Dict[str, torch.Tensor], x: Tensor) -> torch.Tensor:
        w = params["wr"] + 1j * params["wi"]
        b = params["br"] + 1j * params["bi"]
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=w.device)
        return x.to(w.dtype) @ w + b

    call = __call__  # TF-era alias


def JointSchedule(
    steps: int = 300,
    lr_first: float = 1e-3,
    lr_second: float = 1e-2,
) -> Callable[[int], float]:
    """Two-stage learning-rate schedule (reference ``vqes.py:183``): lr_first
    before ``steps``, lr_second after — a step-indexed callable (e.g. for
    ``torch.optim.lr_scheduler.LambdaLR`` as a factor of lr=1)."""

    def schedule(count: Any) -> float:
        return lr_first if float(count) < steps else lr_second

    return schedule
