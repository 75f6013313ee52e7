"""Experimental utilities: chunked vmap, the quantum Fisher information
(QNG), parameter-shift and finite-difference gradients, parameter
checkpoints, layered circuits, a traced function's export and the
process-group broadcasts.

Counterpart of ``tensorcircuit_ng_tpu/experimental.py`` on the backend's
``torch.func`` transforms.  The kernel paths define no forward mode (as the
JAX package's ``custom_vjp`` kernels), so ``qng(..., mode="rev")`` is their
route.  ``jax_jitted_function_save``/``_load`` keep the JAX names and
serialize a ``torch.export`` program; ``broadcast_py_object*`` send a
picklable object over the ``torch.distributed`` world
(``parallel.initialize_distributed``).
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree

from .backend import _argnums
from .backend import backend as K

Tensor = Any

#: the sentinel that pads ragged index batches
PADDING_VALUE = -1

__all__ = [
    "adaptive_vmap",
    "qng",
    "qng2",
    "dynamics_matrix",
    "dynamics_rhs",
    "parameter_shift_grad",
    "parameter_shift_grad_v2",
    "finite_difference_differentiator",
    "save_params",
    "load_params",
    "scan_circuit_layers",
    "hamiltonian_evol",
    "evol_local",
    "evol_global",
    "jax_jitted_function_save",
    "jax_jitted_function_load",
    "jax_func_save",
    "jax_func_load",
    "broadcast_py_object",
    "broadcast_py_object_jax",
    "broadcast_py_object_fs",
]


def adaptive_vmap(
    f: Callable[..., Any],
    vectorized_argnums: Union[int, Sequence[int]] = 0,
    static_argnums: Optional[Sequence[int]] = None,
    chunk_size: Optional[int] = None,
) -> Callable[..., Any]:
    """``backend.vmap`` in chunks of ``chunk_size`` along the batch (the
    remainder a last, shorter chunk), the outputs concatenated: the
    memory of one chunk at a time."""
    vf = K.vmap(f, vectorized_argnums=vectorized_argnums)
    if chunk_size is None:
        return vf
    vargs = _argnums(vectorized_argnums)

    def wrapper(*args: Any, **kws: Any) -> Any:
        total = args[vargs[0]].shape[0]
        outs = []
        for lo in range(0, total, chunk_size):
            cargs = [a[lo: lo + chunk_size] if i in vargs else a for i, a in enumerate(args)]
            outs.append(vf(*cargs, **kws))
        return pytree.tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)

    return wrapper


# ------------------------------------------------------------------
# quantum natural gradient
# ------------------------------------------------------------------


def _ri(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.real(x), torch.imag(x)


def _state_jacobian(f: Callable[[Tensor], Tensor], params: torch.Tensor, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ψ, J [dim, nparams]) of the flattened state map, J by forward
    (``"fwd"``) or reverse mode on the real and imaginary planes."""
    sf = lambda p: torch.reshape(f(p), (-1,))  # noqa: E731
    jacfn = torch.func.jacfwd if mode == "fwd" else torch.func.jacrev
    jr, ji = jacfn(lambda p: _ri(sf(p)))(params)
    psi = sf(params)
    dim = psi.shape[0]
    return psi, torch.complex(jr.reshape(dim, -1), ji.reshape(dim, -1)).to(psi.dtype)


def dynamics_matrix(f: Callable[[Tensor], Tensor]) -> Callable[[Tensor], Tensor]:
    r"""A_ij = Re[⟨∂_i ψ|∂_j ψ⟩ - ⟨∂_i ψ|ψ⟩⟨ψ|∂_j ψ⟩] as a function of the
    parameters (reverse mode)."""

    def a_matrix(params: Tensor) -> Tensor:
        psi, jac = _state_jacobian(f, params, "rev")
        braket = jac.mH @ psi
        return torch.real(jac.mH @ jac - torch.outer(braket, torch.conj(braket)))

    return a_matrix


def qng(
    f: Callable[[Tensor], Tensor],
    kernel: str = "qng",
    postprocess: Optional[str] = "qng",
    mode: str = "fwd",
) -> Callable[[Tensor], Tensor]:
    """The quantum Fisher information matrix of the state map ``f: params
    -> psi``, 4 Re[J†J - J†ψψ†J] (``kernel="dynamics"``: without the
    projector term; ``postprocess=None``: without the factor 4).  ``mode``
    "fwd" or "rev" picks the Jacobian's mode ("rev" on the kernel paths)."""

    def qfi(params: Tensor) -> Tensor:
        psi, jac = _state_jacobian(f, params, mode)
        fim = jac.mH @ jac
        if kernel == "qng":
            braket = jac.mH @ psi
            fim = fim - torch.outer(braket, torch.conj(braket))
        fim = torch.real(fim)
        return 4.0 * fim if postprocess == "qng" else fim

    return qfi


def qng2(
    f: Callable[[Tensor], Tensor],
    kernel: str = "qng",
    postprocess: Optional[str] = "qng",
    mode: str = "fwd",
) -> Callable[[Tensor], Tensor]:
    """:func:`qng` (the JAX package's forward-mode form)."""
    return qng(f, kernel=kernel, postprocess=postprocess, mode=mode)


def dynamics_rhs(f: Callable[[Tensor], Tensor], params: Tensor) -> Tensor:
    """Re(J†ψ) of the state map ``f`` at ``params`` (forward mode)."""
    psi, jac = _state_jacobian(f, params, "fwd")
    return torch.real(jac.mH @ psi)


# ------------------------------------------------------------------
# parameter shift
# ------------------------------------------------------------------


def parameter_shift_grad(
    f: Callable[..., Tensor],
    argnums: Union[int, Sequence[int]] = 0,
    jit: bool = False,
    shifts: Tuple[float, float] = (math.pi / 2, 2.0),
) -> Callable[..., Any]:
    r"""The parameter-shift gradient of a real ``f`` for Pauli-generated
    gates: grad_i = [f(x + s e_i) - f(x - s e_i)] / shifts[1] with s =
    shifts[0] (the two-term rule by default), the 2m shifted evaluations
    of each argument vmapped (``backend.vmap``: on the kernel paths one
    launch a shift); ``jit`` wraps it in ``backend.jit``."""
    argnums_t = _argnums(argnums)
    shift, denom = shifts

    def grad_f(*args: Any, **kws: Any) -> Any:
        grads = []
        for an in argnums_t:
            p = args[an]
            flat = torch.reshape(p, (-1,))
            m = flat.shape[0]
            eye = torch.eye(m, dtype=flat.dtype, device=flat.device) * shift

            def eval_shifted(delta: Tensor) -> Tensor:
                newargs = list(args)
                newargs[an] = torch.reshape(flat + delta, p.shape)
                return torch.real(f(*newargs, **kws))

            vf = torch.func.vmap(eval_shifted)
            g = (vf(eye) - vf(-eye)) / denom
            grads.append(torch.reshape(g, p.shape))
        return grads[0] if isinstance(argnums, int) else tuple(grads)

    return K.jit(grad_f) if jit else grad_f


parameter_shift_grad_v2 = parameter_shift_grad


def finite_difference_differentiator(
    f: Callable[..., Tensor],
    argnums: Union[int, Sequence[int]] = 0,
    shifts: Tuple[float, float] = (0.001, 0.002),
) -> Callable[..., Any]:
    """Central finite differences with the step ``shifts[0]``."""
    shift = shifts[0]
    return parameter_shift_grad(f, argnums=argnums, shifts=(shift, 2 * shift))


# ------------------------------------------------------------------
# parameter checkpoints
# ------------------------------------------------------------------


def save_params(path: Any, params: Any = None) -> None:
    """Save a parameter pytree with ``torch.save`` (either argument order:
    ``save_params(path, params)`` or ``save_params(params, path)``)."""
    if not isinstance(path, (str, os.PathLike)):
        path, params = params, path
    torch.save(params, os.path.abspath(path))


def load_params(path: str, template: Any = None) -> Any:
    """The pytree :func:`save_params` wrote; with ``template``, each leaf
    on the device of the template's leaf."""
    params = torch.load(os.path.abspath(path), weights_only=True)
    if template is None:
        return params
    return pytree.tree_map(lambda x, t: x.to(t.device) if isinstance(t, torch.Tensor) else x, params, template)


# ------------------------------------------------------------------
# export of a traced function
# ------------------------------------------------------------------


class _Exported(torch.nn.Module):
    """``f`` as the module ``torch.export`` takes."""

    def __init__(self, f: Callable[..., Any]) -> None:
        super().__init__()
        self.f = f

    def forward(self, *args: Any, **kws: Any) -> Any:
        return self.f(*args, **kws)


def jax_jitted_function_save(path: str, f: Callable[..., Any], *args: Any, **kws: Any) -> None:
    """Trace ``f`` at the example inputs ``args``/``kws`` with
    ``torch.export.export`` and write the program to ``path``
    (``torch.export.save``).  A function that reaches one of the port's
    hand-written CUDA kernels (a CUDA input) raises: the kernels are launched
    through ctypes, which the tracer cannot see; on CPU inputs it exports
    their plain versions."""
    program = torch.export.export(_Exported(f), tuple(args), kwargs=kws or None, strict=False)
    torch.export.save(program, path)


def jax_jitted_function_load(path: str) -> Callable[..., Any]:
    """The function :func:`jax_jitted_function_save` wrote, as a callable
    module."""
    return torch.export.load(path).module()


jax_func_save = jax_jitted_function_save
jax_func_load = jax_jitted_function_load


# ------------------------------------------------------------------
# broadcasts over the process group
# ------------------------------------------------------------------


def _world() -> Tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def broadcast_py_object(obj: Any, root: int = 0) -> Any:
    """A picklable object of process ``root`` on every process: its pickle
    sent by ``torch.distributed.broadcast_object_list``.  A single process
    returns the object unchanged."""
    rank, world = _world()
    if world == 1:
        return obj
    import torch.distributed as dist

    box = [obj if rank == root else None]
    dist.broadcast_object_list(box, src=root)
    return box[0]


def broadcast_py_object_jax(obj: Any, root: int = 0) -> Any:
    """:func:`broadcast_py_object` under the JAX package's name."""
    return broadcast_py_object(obj, root=root)


def broadcast_py_object_fs(obj: Any, root: int = 0, path: Optional[str] = None, timeout: float = 60.0) -> Any:
    """The broadcast through a shared file system: process ``root`` pickles
    ``obj`` to a temporary file and moves it to ``path`` (``os.replace``);
    the others wait for ``path`` (up to ``timeout`` seconds) and read it.
    The rank and world size are ``torch.distributed``'s."""
    if path is None:
        path = os.path.join(tempfile.gettempdir(), "tc_torch_broadcast.pkl")
    rank, world = _world()
    if world == 1:
        return obj
    if rank == root:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, path)
        return obj
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        time.sleep(0.2)
    raise TimeoutError(f"broadcast file {path} did not appear within {timeout}s")


# ------------------------------------------------------------------
# layered circuits
# ------------------------------------------------------------------


def scan_circuit_layers(c: Any, layer_fn: Callable[[Any, Tensor], None], stacked_params: Tensor) -> Any:
    """``layer_fn(circuit, params_i)`` for each leading row of
    ``stacked_params``, each layer on a new circuit of the same type whose
    input is the last one's state; returns the circuit of the final state."""
    psi = c.state()
    n, d = c.nqubits, c._d
    for p in stacked_params:
        cl = type(c)(n, inputs=psi, dim=d)
        layer_fn(cl, p)
        psi = cl.state()
    return type(c)(n, inputs=psi, dim=d)


# ------------------------------------------------------------------
# the time-evolution names
# ------------------------------------------------------------------


def hamiltonian_evol(*args: Any, **kws: Any) -> Any:
    from . import timeevol

    return timeevol.hamiltonian_evol(*args, **kws)


def evol_local(*args: Any, **kws: Any) -> Any:
    from . import timeevol

    return timeevol.evol_local(*args, **kws)


def evol_global(*args: Any, **kws: Any) -> Any:
    from . import timeevol

    return timeevol.evol_global(*args, **kws)
