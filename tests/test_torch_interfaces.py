"""The port's ML bridges against the JAX package's: ``torchnn``
(``QuantumNet``, ``HardwareNet``), ``interfaces/`` (numpy, scipy, torch,
tensorflow, ``tensortrans``) and ``keras``.

Each case runs the same function in both packages (the port's circuit on
the CPU at complex64, the JAX one through its bridge) from the same
numpy-seeded weights: values and gradients within 1e-5, SGD and L-BFGS
trajectories within 1e-5 a step.  ``HardwareNet`` and
``KerasHardwareLayer`` are held to the two-term parameter-shift rule
(exact for these Pauli rotations, so within 1e-5 of autograd too); the
JAX ``KerasHardwareLayer`` returns jax's own gradient (Queue 3 F23 of
``ROADMAP.md``).  Every tensorflow test is in this file, so that one xdist
worker pays for TensorFlow's import.  The public names of each ported
module are diffed against the JAX module's: only the jax bridge and the
flax layer are missing, on purpose.
"""

import functools
import math

import numpy as np
import pytest
import threadpoolctl
import torch

import jax
import jax.numpy as jnp

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu_torch import interfaces, keras, torchnn
from tensorcircuit_ng_tpu_torch.interfaces import tensortrans as tt

TOL = 1e-5
N, NL = 6, 2
LR = 0.05


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_on_cpu():
    """One torch and one BLAS thread (xdist runs six modules at once); the
    port on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1), tct.set_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


PAIRS = [(i, i + 1) for i in range(N - 1)]
SHAPES = [(NL, N - 1), (NL, N)]
W0 = {s: np.random.default_rng(27 + k).normal(size=s) * 0.3 for k, s in enumerate(SHAPES)}


def init(shape):
    return W0[tuple(shape)]


def port_energy(zz, rx):
    """The TFIM energy of ``chip_smoke.tfim_circuit`` (h_layer, NL
    zzrx_layers, ZZ - X) on the port."""
    c = tct.Circuit(N)
    c.h_layer()
    for l in range(NL):
        c.zzrx_layer(PAIRS, zz[l], rx[l])
    return c.expectation_zzx_energy(PAIRS, 1.0, -1.0)


def jax_energy(zz, rx):
    c = tc.Circuit(N)
    c.h_layer()
    for l in range(NL):
        c.zzrx_layer(PAIRS, zz[l], rx[l])
    return jnp.real(c.expectation_zzx_energy(PAIRS, 1.0, -1.0))


def _train(net, steps=3):
    opt = torch.optim.SGD(net.parameters(), lr=LR)
    out = []
    for _ in range(steps):
        opt.zero_grad()
        e = net()
        e.backward()
        out.append((e.item(), [p.grad.detach().clone().numpy() for p in net.parameters()]))
        opt.step()
    return out, [p.detach().clone().numpy() for p in net.parameters()]


@functools.lru_cache(maxsize=None)
def _jax_trajectory():
    """The JAX ``QuantumNet`` (over its torch interface, jitted) trained
    from the same weights: (its start, its steps, its final weights)."""
    from tensorcircuit_ng_tpu.torchnn import QuantumNet as JQuantumNet

    jnet = JQuantumNet(jax_energy, SHAPES, initializer=init, use_jit=True)
    start = [_np(q).copy() for q in jnet.parameters()]
    return (start,) + _train(jnet)


@pytest.mark.parametrize("use_jit", [False, True])
def test_quantum_net_trains_as_jax(use_jit):
    net = torchnn.QuantumNet(port_energy, SHAPES, initializer=init, use_jit=use_jit)
    assert all(p.dtype == torch.float32 and p.device.type == "cpu" for p in net.parameters())
    jstart, jsteps, jfinal = _jax_trajectory()
    for p, q in zip(net.parameters(), jstart):
        np.testing.assert_array_equal(_np(p), q)
    steps, final = _train(net)
    for (e, g), (je, jg) in zip(steps, jsteps):
        assert abs(e - je) < TOL
        for a, b in zip(g, jg):
            np.testing.assert_allclose(a, b, atol=TOL)
    for a, b in zip(final, jfinal):
        np.testing.assert_allclose(a, b, atol=TOL)
    assert steps[-1][0] < steps[0][0]
    assert torchnn.TorchLayer is torchnn.QuantumNet
    # an input after the weights, and an interface around f
    wrapped = torchnn.QuantumNet(lambda w, x: torch.sum(torch.cos(w) * x), (3,), initializer=lambda s: np.ones(s),
                                 use_interface=interfaces.torch_interface)
    y = wrapped(np.array([1.0, 2.0, 3.0], dtype=np.float32))
    y.backward()
    np.testing.assert_allclose(_np(wrapped.ws[0].grad), -np.sin(1.0) * np.array([1.0, 2.0, 3.0]), atol=1e-6)


def test_trainable_jit_vector_output_and_plain_call():
    f = interfaces.torch.trainable_jit(lambda a, b: torch.stack([torch.sin(a).sum(), (a * b).sum()]))
    a = torch.tensor([0.3, 0.5], requires_grad=True)
    b = torch.tensor([1.0, 2.0])
    y = f(a, b)
    (y * torch.tensor([2.0, 3.0])).sum().backward()
    np.testing.assert_allclose(_np(a.grad), 2 * np.cos([0.3, 0.5]) + 3 * np.array([1.0, 2.0]), atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(_np(f(a, b)), _np(y), atol=0)


def test_hardware_net_gradient_equals_jax_and_autograd():
    """The parameter-shift gradient against the JAX ``HardwareNet``'s and
    against autograd on the TFIM energy of one packed weight (n=4, L=1);
    on two weights (the n=6, L=2 energy in (zz, rx)) the port's against
    autograd, where the JAX one raises (Queue 3 F25: it shifts only its
    first weight)."""
    from tensorcircuit_ng_tpu.torchnn import HardwareNet as JHardwareNet

    n, nl = 4, 1
    pairs = [(i, i + 1) for i in range(n - 1)]

    def packed(w):
        c = tct.Circuit(n)
        c.h_layer()
        c.zzrx_layer(pairs, w[0, 0, : n - 1], w[0, 1])
        return c.expectation_zzx_energy(pairs, 1.0, -1.0)

    def jpacked(w):
        c = tc.Circuit(n)
        c.h_layer()
        c.zzrx_layer(pairs, w[0, 0, : n - 1], w[0, 1])
        return jnp.real(c.expectation_zzx_energy(pairs, 1.0, -1.0))

    w0 = np.random.default_rng(31).normal(size=(nl, 2, n)) * 0.3
    net = torchnn.HardwareNet(packed, (nl, 2, n), initializer=lambda s: w0)
    torch.manual_seed(0)
    jnet = JHardwareNet(jax.jit(jpacked), (nl, 2, n))
    with torch.no_grad():
        jnet.ws[0].copy_(torch.as_tensor(w0, dtype=torch.float32))
    y, jy = net(), jnet()
    y.backward()
    jy.backward()
    assert abs(y.item() - jy.item()) < TOL
    w = net.ws[0].detach().clone().requires_grad_()
    (auto,) = torch.autograd.grad(packed(w), w)
    np.testing.assert_allclose(_np(net.ws[0].grad), _np(jnet.ws[0].grad), atol=TOL)
    np.testing.assert_allclose(_np(net.ws[0].grad), _np(auto), atol=TOL)
    two = torchnn.HardwareNet(port_energy, SHAPES, initializer=init)
    two().backward()
    zz, rx = (p.detach().clone().requires_grad_() for p in two.parameters())
    for p, a in zip(two.parameters(), torch.autograd.grad(port_energy(zz, rx), (zz, rx))):
        np.testing.assert_allclose(_np(p.grad), _np(a), atol=TOL)
    jtwo = JHardwareNet(lambda a, b: jnp.sum(jnp.sin(a)) + jnp.sum(jnp.cos(b)), [(2,), (3,)])
    with pytest.raises(RuntimeError, match="incorrect number of gradients"):
        jtwo().backward()
    assert torchnn.TorchHardwareLayer is torchnn.HardwareNet


def _two_qubit(mod, npm):
    def f(p):
        c = mod.Circuit(2)
        c.rx(0, theta=p[0])
        c.ry(1, theta=p[1])
        c.cnot(0, 1)
        return npm.real(c.expectation_ps(z=[1]))

    return f


def test_numpy_and_scipy_interfaces_equal_jax():
    from scipy.optimize import minimize
    from tensorcircuit_ng_tpu import interfaces as jint

    f, jf = _two_qubit(tct, torch), _two_qubit(tc, jnp)
    x = np.array([0.3, 0.2], dtype=np.float32)
    for jit in (False, True):
        got = interfaces.numpy_interface(f, jit=jit)(x)
        assert isinstance(got, np.ndarray) and abs(float(got) - float(jint.numpy_interface(jf, jit=jit)(x))) < TOL
    fs = interfaces.scipy_optimize_interface(f, shape=(2,), jit=True)
    jfs = jint.scipy_optimize_interface(jf, shape=(2,), jit=True)
    x0 = np.array([0.3, 0.2])
    for x in (x0, x0 + 0.4):
        (v, g), (jv, jg) = fs(x), jfs(x)
        assert isinstance(v, float) and g.dtype == np.float64 and g.shape == (2,)
        assert abs(v - jv) < TOL
        np.testing.assert_allclose(g, jg, atol=TOL)
    assert abs(interfaces.scipy_interface(f, shape=(2,), gradient=False)(x0) - jfs(x0)[0]) < TOL
    r = minimize(fs, x0, jac=True, method="L-BFGS-B")
    jr = minimize(jfs, x0, jac=True, method="L-BFGS-B")
    assert r.fun < -0.99 and abs(r.fun - jr.fun) < TOL
    np.testing.assert_allclose(r.x, jr.x, atol=1e-3)


def test_torch_interface_moves_foreign_inputs():
    f = _two_qubit(tct, torch)
    ft = interfaces.torch_interface(f, jit=True)
    p = torch.tensor([0.4, 0.1], requires_grad=True)
    v = ft(p)
    v.backward()
    np.testing.assert_allclose(_np(v), np.cos(0.4) * np.cos(0.1), atol=1e-6)
    np.testing.assert_allclose(_np(p.grad), [-np.sin(0.4) * np.cos(0.1), -np.cos(0.4) * np.sin(0.1)], atol=1e-6)
    for foreign in (np.array([0.4, 0.1], dtype=np.float32), jnp.asarray([0.4, 0.1])):
        for dl in (False, True):
            assert abs(float(interfaces.torch_interface(f, enable_dlpack=dl)(foreign)) - v.item()) < 1e-6
    kw = interfaces.torch_interface_kws(lambda p, scale: scale * f(p), scale=2.0)
    assert abs(kw(p).item() - 2 * v.item()) < 1e-6
    assert interfaces.pytorch_interface is interfaces.torch_interface


def test_tensortrans_surface():
    t = torch.ones(3)
    a = jnp.arange(3.0)
    assert tt.which_backend(t, return_backend=False) == "torch"
    assert tt.which_backend(a, return_backend=False) == "jax"
    assert tt.which_backend(np.ones(2), return_backend=False) == "numpy"
    assert tt.which_dtype(t) == "float32" and tt.which_dtype(np.ones(2, np.int32)) == "int32"
    back = tt.general_args_to_backend({"a": a, "b": [np.ones(2)]})
    assert isinstance(back["a"], torch.Tensor) and isinstance(back["b"][0], torch.Tensor)
    np.testing.assert_array_equal(_np(back["a"]), [0.0, 1.0, 2.0])
    # DLPack shares memory: a CPU tensor into torch is the same storage
    same = tt.general_args_to_backend(t, target_backend="torch")
    assert same.data_ptr() == t.data_ptr()
    assert tt.general_args_to_backend(t, dtype="float64").dtype == torch.float64
    assert tt.tensor_to_backend_jittable(t) is t
    jt = tt.tensor_to_backend_jittable(a)
    assert isinstance(jt, torch.Tensor) and jt.tolist() == [0.0, 1.0, 2.0]
    np.testing.assert_array_equal(tt.tensor_to_numpy(a), [0.0, 1.0, 2.0])
    assert tt.tensor_to_numpy(2.5) == 2.5 and tt.tensor_to_numpy(None) is None
    assert isinstance(tt.numpy_to_tensor(np.ones(2)), torch.Tensor)
    assert isinstance(tt.numpy_to_tensor(np.ones(2), "numpy"), np.ndarray)
    np.testing.assert_array_equal(torch.from_dlpack(tt.tensor_to_dlpack(t)).numpy(), np.ones(3))
    nested = tt.general_args_to_numpy({"x": (t, jnp.ones(2)), "y": 3})
    assert isinstance(nested["x"][0], np.ndarray) and isinstance(nested["x"][1], np.ndarray) and nested["y"] == 3
    assert tt.numpy_args_to_backend([np.ones(2)], dtype="float64")[0].dtype == torch.float64
    for bad in (lambda: tt.general_args_to_backend(t, target_backend="jax"),
                lambda: tt.numpy_args_to_backend(np.ones(2), target="jax"),
                lambda: tt.numpy_to_tensor(np.ones(2), "jax")):
        with pytest.raises(ValueError, match="does not import jax"):
            bad()
    trg = tt.args_to_tensor(lambda x: torch.trace(x), argnums=[0], gate_to_tensor=True)
    assert abs(complex(trg(tct.Gate(np.eye(2)))) - 2) < 1e-6
    assert trg(np.eye(2)).dtype == torch.complex64
    qop = tct.QuOperator.from_tensor(torch.eye(4, dtype=torch.complex64).reshape(2, 2, 2, 2))
    assert tt.qop_to_matrix(qop).shape == (4, 4) and tt.gate_to_matrix(3) == 3


def test_tensorflow_interface_value_and_grad_equal_jax():
    tf = pytest.importorskip("tensorflow")
    from tensorcircuit_ng_tpu.interfaces.tensorflow import tensorflow_interface as jtf_interface

    def complex_in(w, z):
        """A real function of a complex input: its gradient in the JAX
        package's convention."""
        return torch.real(torch.sum(torch.conj(z) * z * torch.sin(w)))

    def jcomplex_in(w, z):
        return jnp.real(jnp.sum(jnp.conj(z) * z * jnp.sin(w)))

    for jit in (False, True):
        f_tf = interfaces.tensorflow_interface(_two_qubit(tct, torch), jit=jit)
        jf_tf = jtf_interface(_two_qubit(tc, jnp), jit=jit)
        x = tf.Variable([0.3, 0.5], dtype=tf.float32)
        grads = []
        for fn in (f_tf, jf_tf):
            with tf.GradientTape() as tape:
                y = fn(x)
            grads.append((float(y), tape.gradient(y, x).numpy()))
        assert abs(grads[0][0] - grads[1][0]) < TOL
        np.testing.assert_allclose(grads[0][1], grads[1][1], atol=TOL)
    w = tf.Variable([0.2, 0.7], dtype=tf.float32)
    z = tf.Variable([1.0 + 2.0j, -0.5j], dtype=tf.complex64)
    out = []
    for fn in (interfaces.tf_interface(complex_in), jtf_interface(jcomplex_in)):
        with tf.GradientTape() as tape:
            y = fn(w, z)
        gw, gz = tape.gradient(y, [w, z])
        out.append((float(y), gw.numpy(), gz.numpy()))
    assert abs(out[0][0] - out[1][0]) < TOL
    np.testing.assert_allclose(out[0][1], out[1][1], atol=TOL)
    np.testing.assert_allclose(out[0][2], out[1][2], atol=TOL)
    from tensorcircuit_ng_tpu_torch.interfaces.tensorflow import tf_dtype, tf_wrapper

    assert tf_dtype("float32") == tf.float32 and tf_dtype(np.complex64) == tf.complex64
    y = tf_wrapper(lambda a: a * 2)(tf.constant([1.0, 2.0]))
    assert isinstance(y, tf.Tensor) and y.numpy().tolist() == [2.0, 4.0]


def _keras_f(w, x):
    c = tct.Circuit(2)
    c.rx(0, theta=w[0] + x[0])
    c.rx(1, theta=w[1] + x[1])
    c.cnot(0, 1)
    return torch.real(c.expectation_ps(z=[1]))


def test_keras_layer_trains():
    tf = pytest.importorskip("tensorflow")

    layer = keras.KerasLayer(_keras_f, weights_shape=(2,))
    x = tf.constant([[0.1, 0.2], [0.3, -0.2]], dtype=tf.float32)
    with tf.GradientTape() as tape:
        y = layer(x)
        loss = tf.reduce_sum((y + 1.0) ** 2)
    assert y.shape == (2,)
    grads = tape.gradient(loss, layer.trainable_variables)
    assert grads and all(np.isfinite(g.numpy()).all() for g in grads)
    # the batched value: one row at a time through the port
    w = torch.as_tensor(layer.trainable_variables[0].numpy())
    want = [float(_keras_f(w, torch.as_tensor(row))) for row in x.numpy()]
    np.testing.assert_allclose(y.numpy(), want, atol=TOL)
    opt = tf.keras.optimizers.SGD(0.4)
    before = float(loss)
    for _ in range(6):
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum((layer(x) + 1.0) ** 2)
        opt.apply_gradients(zip(tape.gradient(loss, layer.trainable_variables), layer.trainable_variables))
    assert float(loss) < 0.75 * before


def test_f23_keras_hardware_layer_uses_parameter_shift():
    """Queue 3 F23: the JAX ``KerasHardwareLayer`` builds the shift rule
    and drops it (``keras.py:122-123``).  f = Σ w² + x has the shift
    rule's gradient π·w (shift π/2, denominator 2), not autograd's 2w: the
    port's layer gives π·w, the JAX one 2w."""
    tf = pytest.importorskip("tensorflow")
    from tensorcircuit_ng_tpu.keras import KerasHardwareLayer as JKerasHardwareLayer

    x = tf.constant([[0.5]], dtype=tf.float32)
    got = []
    for make, f in ((keras.KerasHardwareLayer, lambda w, xi: torch.sum(w**2) + xi[0]),
                    (JKerasHardwareLayer, lambda w, xi: jnp.sum(w**2) + xi[0])):
        layer = make(f, weights_shape=(2,))
        with tf.GradientTape() as tape:
            y = layer(x)
        w = layer.trainable_variables[0].numpy()
        got.append((w, tape.gradient(y, layer.trainable_variables)[0].numpy()))
    np.testing.assert_allclose(got[0][1], math.pi * got[0][0], rtol=1e-5)
    np.testing.assert_allclose(got[1][1], 2 * got[1][0], rtol=1e-5)  # the JAX record
    # on Pauli rotations the shift rule is exact: the hardware layer's
    # gradient equals the autograd layer's
    xs = tf.constant([[0.1, 0.2]], dtype=tf.float32)
    hw = keras.HardwareLayer(_keras_f, weights_shape=(2,))
    hw(xs)
    ad = keras.KerasLayer(_keras_f, weights_shape=(2,))
    ad(xs)
    ad.trainable_variables[0].assign(hw.trainable_variables[0])
    gs = []
    for layer in (hw, ad):
        with tf.GradientTape() as tape:
            y = layer(xs)
        gs.append(tape.gradient(y, layer.trainable_variables)[0].numpy())
    np.testing.assert_allclose(gs[0], gs[1], atol=TOL)
    assert keras.output_asis_loss(None, 3.0) == 3.0 and keras.QuantumLayer is None


def test_keras_save_and_load_func(tmp_path):
    path = str(tmp_path / "f.pt2")
    x = torch.tensor([0.3, 0.2])
    keras.save_func(_two_qubit(tct, torch), path, x)
    assert abs(keras.load_func(path)(x).item() - _two_qubit(tct, torch)(x).item()) < 1e-6


def _public(mod):
    return {n for n in getattr(mod, "__all__", dir(mod)) if not n.startswith("_")}


def test_public_names_against_jax():
    """Each ported module's public names against the JAX module's: only the
    jax bridge (``interfaces/jax.py``) and the flax layer are missing, and
    the flax layer's name stays (as None, the JAX package's no-flax
    branch)."""
    import tensorcircuit_ng_tpu.interfaces as ji
    import tensorcircuit_ng_tpu.interfaces.numpy as jnp_if
    import tensorcircuit_ng_tpu.interfaces.scipy as jsp_if
    import tensorcircuit_ng_tpu.interfaces.tensorflow as jtf_if
    import tensorcircuit_ng_tpu.interfaces.tensortrans as jtt
    import tensorcircuit_ng_tpu.interfaces.torch as jto_if
    import tensorcircuit_ng_tpu.keras as jkeras
    import tensorcircuit_ng_tpu.torchnn as jtorchnn
    from tensorcircuit_ng_tpu_torch.interfaces import numpy as np_if
    from tensorcircuit_ng_tpu_torch.interfaces import scipy as sp_if
    from tensorcircuit_ng_tpu_torch.interfaces import tensorflow as tf_if
    from tensorcircuit_ng_tpu_torch.interfaces import torch as to_if

    left_out = {"jax_interface", "jax_wrapper", "create_jax_function"}
    pairs = [(ji, interfaces), (jnp_if, np_if), (jsp_if, sp_if), (jto_if, to_if), (jkeras, keras),
             (jtorchnn, torchnn)]
    for jmod, mod in pairs:
        assert _public(jmod) - _public(mod) <= left_out, jmod.__name__
    assert _public(ji) - _public(interfaces) == {"jax_interface"}
    jtf_names = {n for n in dir(jtf_if) if not n.startswith("_") and callable(getattr(jtf_if, n))
                 and getattr(getattr(jtf_if, n), "__module__", "") == jtf_if.__name__}
    assert jtf_names <= _public(tf_if)
    jtt_names = {n for n in dir(jtt) if not n.startswith("_") and callable(getattr(jtt, n))
                 and getattr(getattr(jtt, n), "__module__", "") == jtt.__name__}
    assert jtt_names <= _public(tt)
    for name in ("QuantumNet", "TorchLayer", "HardwareNet", "TorchHardwareLayer", "KerasLayer",
                 "KerasHardwareLayer", "interfaces", "keras", "torchnn", "zx"):
        assert getattr(tct, name) is not None and hasattr(tc, name)
    import tensorcircuit_ng_tpu.zx as jzx
    from tensorcircuit_ng_tpu_torch import zx

    assert _public(jzx) == _public(zx)
    for sub in ("converter", "evaluator", "graph", "graph_s", "noise_model", "scalar_graph", "simplifier",
                "stabilizertcircuit", "utils"):
        jm, m = getattr(jzx, sub), getattr(zx, sub)
        assert _public(jm) - _public(m) == set(), sub
