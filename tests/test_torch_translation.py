"""The port's translation, drawing and compiler against the JAX package:
``translation.py`` (JSON, OpenQASM, eqasm, ``perm_matrix``), the circuits'
I/O methods, ``vis.py``, ``compiler/``, the contractor's debug options on
the dense readouts (F20 of ``ROADMAP.md`` Queue 3), and the small gaps of
done items (``is_dm``, ``mpogates``, ``diaggates``, ``Gate.shape``,
``statevec.project_qubit``, ``native_tableau_available``).

The same circuits, from numpy inputs of one seed, are built in both
packages (the port's on the CPU, complex64).  Tolerances: the JSON and
OpenQASM texts, the LaTeX and the text drawings are equal strings; states
of the two packages within 1e-6 (1e-5 for ``MPSCircuit``, whose SVDs
round differently in the two packages); compiled QIRs item by item (names, wires,
parameters within 1e-7, gate matrices within 1e-6).
"""

import json

import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import translation as jtr
from tensorcircuit_ng_tpu import vis as jvis
from tensorcircuit_ng_tpu.compiler import composed_compiler as jcc
from tensorcircuit_ng_tpu.compiler import simple_compiler as jsc
from tensorcircuit_ng_tpu.core import contractor as jcontractor
from tensorcircuit_ng_tpu.core import statevec as jstatevec
from tensorcircuit_ng_tpu_torch import translation as ptr
from tensorcircuit_ng_tpu_torch import vis as pvis
from tensorcircuit_ng_tpu_torch.compiler import composed_compiler as pcc
from tensorcircuit_ng_tpu_torch.compiler import simple_compiler as psc
from tensorcircuit_ng_tpu_torch.core import contractor as pcontractor
from tensorcircuit_ng_tpu_torch.core import statevec as pstatevec

STATE_TOL = 1e-6
PARAM_TOL = 1e-7
GATE_TOL = 1e-6
#: the MPS simulators' states: their SVDs round differently
MPS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _jax_at_complex64():
    tc.set_dtype("complex64")
    yield
    tc.set_dtype("complex64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_on_cpu():
    """One torch and one BLAS thread (xdist runs six modules at once); the
    port's circuits on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1), tct.set_device("cpu"):
        yield
    torch.set_num_threads(threads)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs():
    rng = np.random.default_rng(26)
    return {
        "zz": rng.uniform(-1, 1, 2).astype(np.float32),
        "rx": rng.uniform(-1, 1, 4).astype(np.float32),
        "rx2": rng.uniform(-1, 1, 4).astype(np.float32),
        "u1": np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0],
        "u2": np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0],
        "angles": rng.uniform(-np.pi, np.pi, 6),
    }


def _qasm_circuit(mod, x):
    """Fused layers, a one-qubit ``unitary``, parameterised gates and the
    named gates that OpenQASM 2 writes."""
    c = mod.Circuit(4)
    c.h_layer()
    c.zzrx_layer([(0, 1), (2, 3)], x["zz"], x["rx"])
    c.rx_layer(x["rx2"])
    c.unitary(3, unitary=x["u1"])
    a = x["angles"]
    c.u(2, theta=a[0], phi=a[1], lbd=a[2])
    c.rzz(1, 2, theta=a[3])
    c.crx(0, 2, theta=a[4])
    c.phase(1, theta=a[5])
    c.cnot(0, 3)
    c.toffoli(0, 1, 2)
    c.swap(1, 3)
    c.sd(0)
    c.multicz(0, 1, 2)
    return c


def _json_circuit(mod, x):
    """The QASM circuit with a ``multicontrol`` and a two-qubit ``unitary``."""
    c = _qasm_circuit(mod, x)
    c.multicontrol(0, 1, 2, ctrl=[1, 0], unitary=np.array([[0, 1], [1, 0]]))
    c.unitary(1, 3, unitary=x["u2"])
    return c


def _state_close(a, b, tol=STATE_TOL):
    assert np.abs(_np(a.state()) - np.asarray(b.state())).max() < tol


# ----------------------------------------------------------------------
# JSON
# ----------------------------------------------------------------------


def test_json_text_and_round_trip_match_jax(tmp_path):
    """Equal JSON texts; the port's import gives the JAX circuit's state.
    The JAX ``json2qir`` reads ``ctrl=[1, 0]`` back as the number 1 and
    raises (F21, kept in the JAX package); the port reads a list of ints as
    a list and a pair of floats as a scalar."""
    x = _inputs()
    cj, cp = _json_circuit(tc, x), _json_circuit(tct, x)
    sj, sp = cj.to_json(), cp.to_json()
    assert sp == sj
    assert ptr.circuit_to_json(cp, simplified=True) == jtr.circuit_to_json(cj, simplified=True)
    assert ptr.circuit_to_json(cp, as_str=False) == jtr.circuit_to_json(cj, as_str=False)
    c2 = tct.Circuit.from_json(sp)
    _state_close(c2, cj)
    with pytest.raises(TypeError):
        tc.Circuit.from_json(sj)
    f = str(tmp_path / "c.json")
    cp.to_json(file=f)
    _state_close(tct.Circuit.from_json_file(f, device="cpu"), cj)
    # the JAX package's reading of a circuit without multicontrol
    qj = _qasm_circuit(tc, x)
    _state_close(tct.Circuit.from_json(_qasm_circuit(tct, x).to_json()), tc.Circuit.from_json(qj.to_json()))


def test_json_gate_tensors_land_on_the_circuit_device():
    """A gate tensor read from JSON is a tensor on the target circuit's
    device; without a device it stays numpy, as the JAX package's does."""
    x = _inputs()
    data = json.loads(_json_circuit(tct, x).to_json())["qir"]
    qir = ptr.json2qir(data, device="cpu")
    tensors = [it["gate"].tensor for it in qir if it.get("gatef") is None]
    assert tensors and all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in tensors)
    assert all(isinstance(it["gate"].tensor, np.ndarray) for it in ptr.json2qir(data) if it.get("gatef") is None)
    jqir = jtr.json2qir([it for it in data if it["name"] != "multicontrol"])
    pqir = ptr.json2qir([it for it in data if it["name"] != "multicontrol"])
    assert [(a["name"], a["index"]) for a in pqir] == [(b["name"], b["index"]) for b in jqir]
    for a, b in zip(pqir, jqir):
        assert a.get("parameters", {}).keys() == b.get("parameters", {}).keys()
    c = tct.Circuit.from_json(_json_circuit(tct, x).to_json(), device="cpu")
    assert c.device.type == "cpu"


def test_tensor_codec_perm_matrix_ctrl_state_match_jax():
    rng = np.random.default_rng(1)
    t = rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))
    assert ptr.tensor_to_json(t) == jtr.tensor_to_json(t)
    assert ptr.tensor_to_json(torch.as_tensor(t)) == jtr.tensor_to_json(t)
    np.testing.assert_array_equal(ptr.json_to_tensor(ptr.tensor_to_json(t)), jtr.json_to_tensor(jtr.tensor_to_json(t)))
    for n in range(1, 5):
        np.testing.assert_array_equal(ptr.perm_matrix(n), jtr.perm_matrix(n))
    for s, k in (("5", 3), ("0", 2), ("6", 4)):
        assert ptr.ctrl_str2ctrl_state(s, k) == jtr.ctrl_str2ctrl_state(s, k)


# ----------------------------------------------------------------------
# OpenQASM and eqasm
# ----------------------------------------------------------------------


def test_qasm_text_and_import_match_jax(tmp_path):
    x = _inputs()
    cj, cp = _qasm_circuit(tc, x), _qasm_circuit(tct, x)
    qj, qp = cj.to_openqasm(), cp.to_openqasm()
    assert qp == qj
    assert ptr.circuit_to_qasm(cp) == jtr.circuit_to_qasm(cj)
    pj, pp = tc.Circuit.from_openqasm(qj), tct.Circuit.from_openqasm(qp)
    _state_close(pp, pj)
    assert abs(abs(np.vdot(_np(pp.state()), np.asarray(cj.state()))) - 1) < STATE_TOL
    f = str(tmp_path / "c.qasm")
    cp.to_openqasm_file(f)
    _state_close(tct.Circuit.from_openqasm_file(f, device="cpu"), pj)
    for mod in (tc, tct):
        with pytest.raises(ValueError, match="OpenQASM 2"):
            _json_circuit(mod, x).to_openqasm()


def test_qasm_expressions_and_eqasm_match_jax():
    qasm = """OPENQASM 2.0;
include "qelib1.inc";
qreg q[3];
creg c[3];
h q[0];
rz(pi/2) q[1];   // a comment
u3(0.3, -pi/4, 2*pi/3) q[2];
cp(-0.5*pi) q[0],q[2];
cx q[0],q[1];
barrier q[0],q[1];
measure q[0] -> c[0];
"""
    cj, cp = jtr.qasm2tc(qasm), ptr.qasm2tc(qasm)
    assert [(i["name"], i["index"]) for i in cp.to_qir()] == [(i["name"], i["index"]) for i in cj.to_qir()]
    for a, b in zip(cp.to_qir(), cj.to_qir()):
        for k, v in b.get("parameters", {}).items():
            assert abs(float(a["parameters"][k]) - float(v)) < PARAM_TOL
    _state_close(cp, cj)
    with pytest.raises(ValueError, match="disallowed"):
        ptr.qasm2tc('OPENQASM 2.0;\nqreg q[1];\nrz(__import__) q[0];\n')
    eqasm = "\n".join(
        ["h", "h", "q0,q1", "h", "h", "h", "bs 0 H q0", "bs 0 RZ_2 q0", "bs 0 Z/2 q1", "bs 0 -Z/2 q0",
         "bs 0 CZ (q0, q1)", "bs 0 X q1", "end"]
    )
    ej, ep = jtr.eqasm2tc(eqasm), ptr.eqasm2tc(eqasm)
    assert [i["name"] for i in ep.to_qir()] == [i["name"] for i in ej.to_qir()] == ["h", "rz", "rz", "rz", "cz", "x"]
    _state_close(ep, ej)
    assert ptr.eqasm2tc(eqasm, nqubits=2, device="cpu").device.type == "cpu"


# ----------------------------------------------------------------------
# the circuits' other I/O methods, drawing
# ----------------------------------------------------------------------


def test_qsim_file_matches_jax(tmp_path):
    qs = tmp_path / "c.qsim"
    qs.write_text("3\n0 h 0\n0 h 1\n1 cz 0 1\n2 rx 1 0.5\n2 rz 2 -0.25\n3 fs 1 2 0.4 0.3\n"
                  "4 x_1_2 0\n4 y_1_2 2\n5 hz_1_2 1\n6 cnot 2 0\n")
    cj, cp = tc.Circuit.from_qsim_file(str(qs)), tct.Circuit.from_qsim_file(str(qs), device="cpu")
    assert [i["name"] for i in cp.to_qir()] == [i["name"] for i in cj.to_qir()]
    _state_close(cp, cj)


def test_vis_tex_and_drawings_match_jax(tmp_path):
    x = _inputs()
    cj, cp = _json_circuit(tc, x), _json_circuit(tct, x)
    assert cp.vis_tex() == cj.vis_tex()
    assert cp.vis_tex(measure=[0, 2], standalone=True) == cj.vis_tex(measure=[0, 2], standalone=True)
    assert pvis.circuit_to_tex(cp) == jvis.circuit_to_tex(cj)
    assert pvis.circuit_to_tex(cp, init=["0", "1", "+", "-"], return_string_table=True) == jvis.circuit_to_tex(
        cj, init=["0", "1", "+", "-"], return_string_table=True)
    assert pvis.qir2tex(cp._expanded_qir(), 4) == jvis.qir2tex(cj._expanded_qir(), 4)
    assert pvis.draw(cp) == jvis.draw(cj)
    assert str(cp.draw()) == str(cj.draw())
    for name in ("ccnot", "cphase", "rx"):
        assert pvis.gate_name_trans(name) == jvis.gate_name_trans(name)
    tex = pvis.circuit_to_tex(cp, standalone=True)
    pdf = pvis.render_pdf(tex, filename="p", path=str(tmp_path))
    assert pdf == jvis.render_pdf(tex, filename="j", path=str(tmp_path))
    assert pdf is None or pdf.endswith("p.pdf")


def test_other_circuit_classes_take_the_io_methods():
    """``DMCircuit``, ``MPSCircuit`` and ``StabilizerCircuit`` read and
    write the same texts as the JAX package's classes."""
    x = _inputs()
    text = _qasm_circuit(tct, x).to_openqasm()
    dj, dp = tc.DMCircuit.from_openqasm(text), tct.DMCircuit.from_openqasm(text, device="cpu")
    assert np.abs(_np(dp.state()) - np.asarray(dj.state())).max() < STATE_TOL
    mp = tct.MPSCircuit.from_json(_qasm_circuit(tct, x).to_json(), device="cpu")
    mj = tc.MPSCircuit.from_json(_qasm_circuit(tc, x).to_json())
    assert np.abs(_np(mp.wavefunction()) - np.asarray(mj.wavefunction())).max() < MPS_TOL
    cliff = 'OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[3];\nh q[0];\ncx q[0],q[1];\ns q[2];\ncz q[1],q[2];\n'
    sp, sj = tct.StabilizerCircuit.from_openqasm(cliff, device="cpu"), tc.StabilizerCircuit.from_openqasm(cliff)
    assert sp.to_openqasm() == sj.to_openqasm()
    assert sp.to_json() == sj.to_json()
    assert np.abs(_np(sp.state()) - np.asarray(sj.state())).max() < STATE_TOL


# ----------------------------------------------------------------------
# compiler/
# ----------------------------------------------------------------------


def _same_qir(qp, qj):
    assert [(it.get("name"), tuple(it["index"])) for it in qp] == [(it.get("name"), tuple(it["index"])) for it in qj]
    for a, b in zip(qp, qj):
        pa, pb = a.get("parameters") or {}, b.get("parameters") or {}
        assert pa.keys() == pb.keys()
        for k in pb:
            assert np.abs(np.asarray(_np(pa[k]), complex) - np.asarray(pb[k], complex)).max() < PARAM_TOL
        if b.get("gate") is not None:
            ma, mb = _np(a["gate"].matrix()), np.asarray(b["gate"].matrix())
            assert np.abs(ma - mb).max() < GATE_TOL


def _compile_workloads(mod):
    c1 = mod.Circuit(3)
    c1.rz(0, theta=0.3)
    c1.rz(0, theta=-0.3)
    c1.rx(1, theta=0.2)
    c1.rx(1, theta=0.3)
    c1.h(2)
    c1.h(2)
    c1.s(0)
    c1.sd(0)
    c1.t(1)
    c1.t(1)
    c1.x(2)
    c1.y(2)
    c1.rzz(0, 1, theta=0.3)
    c1.rzz(0, 1, theta=0.5)
    c1.cnot(0, 1)
    c1.u(2, theta=0.7, phi=0.2, lbd=0.9)
    c1.rz(1, theta=0.0)
    c2 = mod.Circuit(2)
    c2.rx(0, theta=0.4)
    c2.ry(1, theta=0.7)
    c2.u(0, theta=0.3, phi=0.2, lbd=0.1)
    c2.cx(0, 1)
    c2.cx(0, 1)
    c3 = mod.Circuit(4)
    c3.h_layer()
    c3.zzrx_layer([(0, 1), (2, 3)], np.array([0.1, 0.2], np.float32), np.array([0.3, 0.4, 0.5, 0.6], np.float32))
    c3.zzrx_layer([(0, 1), (2, 3)], np.array([0.7, 0.8], np.float32), np.array([0.9, 1.0, 1.1, 1.2], np.float32))
    return [c1, c2, c3]


def test_compiler_passes_match_jax():
    """``simple_compile`` and each pass on a circuit and on its QIR give the
    JAX package's QIR; the compiled circuits keep the state up to a global
    phase."""
    for cp, cj in zip(_compile_workloads(tct), _compile_workloads(tc)):
        (sp, ip), (sj, ij) = psc.simple_compile(cp), jsc.simple_compile(cj)
        assert ip == ij == {}
        _same_qir(sp.to_qir(), sj.to_qir())
        _same_qir(psc.simple_compile(cp, output="qir"), jsc.simple_compile(cj, output="qir"))
        assert sp.device.type == "cpu"
        psi0 = np.asarray(cj.state())
        for pf, jf in ((psc.replace_r, jsc.replace_r), (psc.replace_u, jsc.replace_u),
                       (psc.prune, jsc.prune), (psc.merge, jsc.merge)):
            _same_qir(pf(cp).to_qir(), jf(cj).to_qir())
            _same_qir(pf(list(cp.to_qir())), jf(list(cj.to_qir())))
        for c in (sp, psc.replace_r(cp), psc.replace_u(cp)):
            psi = _np(c.state())
            k = np.argmax(np.abs(psi0))
            assert np.abs(psi - psi0 * psi[k] / psi0[k]).max() < 1e-5
        _same_qir(psc.prune_pass(list(cp.to_qir())), jsc.prune_pass(list(cj.to_qir())))
        _same_qir(psc.merge_pass(list(cp.to_qir())), jsc.merge_pass(list(cj.to_qir())))
        _same_qir(psc.replace_u_pass(list(cp.to_qir())), jsc.replace_u_pass(list(cj.to_qir())))
    assert psc.default_merge_rules == jsc.default_merge_rules


def test_default_compile_and_compiler_chain_match_jax():
    cp, cj = _compile_workloads(tct)[0], _compile_workloads(tc)[0]
    (dp, ip), (dj, ij) = pcc.default_compile(cp), jcc.default_compile(cj)
    assert ip == ij
    _same_qir(dp.to_qir(), dj.to_qir())
    comp_p = pcc.Compiler([psc.simple_compile, psc.simple_compile])
    comp_j = jcc.Compiler([jsc.simple_compile, jsc.simple_compile])
    comp_p.add_options({"output": "circuit"})
    comp_j.add_options({"output": "circuit"})
    (xp, ip), (xj, ij) = comp_p(cp, {"a": 1}), comp_j(cj, {"a": 1})
    assert ip == ij
    _same_qir(xp.to_qir(), xj.to_qir())
    with pytest.raises(AssertionError):
        comp_p.add_options([{}])


class _MockLayout:
    def __init__(self, perm):
        self._perm = perm

    def final_index_layout(self):
        return self._perm


class _MockCompiled:
    def __init__(self, src, perm):
        self.num_qubits = len(perm)
        self.layout = _MockLayout(perm)
        self._src = src


def test_mapping_info_and_mock_qiskit_compile_match_jax():
    for info, lpm, pos in ((None, {0: 2, 1: 0, 2: 1}, None),
                           ({"logical_physical_mapping": {0: 1, 1: 0, 2: 2}}, {0: 2, 1: 0, 2: 1}, None),
                           ({"positional_logical_mapping": {0: 3, 1: 1}, "logical_physical_mapping": {3: 0, 1: 1}},
                            {0: 1, 1: 0}, None),
                           (None, {0: 0, 1: 1}, {0: 1, 1: 0})):
        assert pcc.compose_mapping_info(info, lpm, pos) == jcc.compose_mapping_info(info, lpm, pos)

    def run(mod, cc):
        c = mod.Circuit(3)
        c.h(0)
        c.cx(0, 1)
        c.rz(2, theta=0.3)
        c.measure_instruction(2)
        c.measure_instruction(0)
        seen = {}

        def mock_transpile(qc, **opts):
            seen["opts"] = opts
            return _MockCompiled(qc, [2, 0, 1])

        _, info = cc.qiskit_compile(c, output="qiskit", compiled_options={"optimization_level": 1},
                                    _transpile_fn=mock_transpile)
        compiled, info2 = cc.qiskit_compile(_MockCompiled(None, [1, 2, 0]), info=info, output="qiskit",
                                            _transpile_fn=lambda qc, **o: _MockCompiled(qc, [1, 2, 0]))
        return seen, info, info2, cc.positional_logical_mapping_of(c)

    assert run(tct, pcc) == run(tc, jcc)


# ----------------------------------------------------------------------
# F20 and the small gaps
# ----------------------------------------------------------------------


def test_f20_dense_readouts_honour_the_debug_options(capsys):
    """F20: under ``set_contractor("greedy", contraction_info=True,
    debug_level=2)`` the dense ``expectation`` and ``expectation_ps`` give a
    complex zero of shape () and print the JAX package's cost line, once a
    circuit shape; with ``contraction_info`` alone the value is computed
    and the line printed for the new shape."""
    z = tc.gates.z().tensor
    lines = {}
    for mod, ctr in ((tc, jcontractor), (tct, pcontractor)):
        ctr._INFO_PRINTED.clear()
        mod.set_contractor("greedy", contraction_info=True, debug_level=2)
        try:
            c = mod.Circuit(4)
            c.h(0)
            c.cnot(0, 1)
            e1 = c.expectation((z, [0]), (z, [1]))
            e2 = c.expectation_ps(z=[0, 1])
            out1 = capsys.readouterr().out
            mod.set_contractor("greedy", contraction_info=True)
            c.x(2)
            e3 = c.expectation_ps(z=[0, 1])
            out2 = capsys.readouterr().out
        finally:
            mod.set_contractor("greedy")
            ctr._INFO_PRINTED.clear()
        for e in (e1, e2):
            assert tuple(e.shape) == () and complex(_np(e)) == 0
        assert abs(complex(_np(e3)) - 1.0) < STATE_TOL
        lines[mod.__name__] = (out1, out2)
        if mod is tct:
            assert e1.dtype == e2.dtype == torch.complex64
    assert lines["tensorcircuit_ng_tpu_torch"] == lines["tensorcircuit_ng_tpu"]
    out1, out2 = lines["tensorcircuit_ng_tpu"]
    assert out1.count("log10[FLOPs]: 2.283  log2[SIZE]: 4.000  gates: 2") == 1
    assert out2.count("gates: 3") == 1


def test_small_gaps_match_jax():
    for cls in ("Circuit", "DMCircuit", "MPSCircuit", "StabilizerCircuit"):
        pc, jc = getattr(tct, cls), getattr(tc, cls)
        assert pc.is_dm == jc.is_dm
        assert pc.mpogates == jc.mpogates and pc.diaggates == jc.diaggates
    from tensorcircuit_ng_tpu.models import abstractcircuit as jac
    from tensorcircuit_ng_tpu_torch.models import abstractcircuit as pac

    for name in ("sgates", "vgates", "mpogates", "diaggates", "gate_aliases", "defined_gates"):
        assert getattr(pac, name) == getattr(jac, name)
    g = tct.gates.cnot()
    assert g.shape == tc.gates.cnot().shape == (2, 2, 2, 2)
    assert tct.gates.rx(theta=torch.tensor(0.3)).shape == (2, 2)
    rng = np.random.default_rng(3)
    psi = rng.normal(size=16) + 1j * rng.normal(size=16)
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64)
    for wire, outcome in ((0, 1), (3, 0)):
        p = pstatevec.project_qubit(torch.as_tensor(psi), wire, outcome)
        j = jstatevec.project_qubit(psi, wire, outcome)
        assert np.abs(_np(p) - np.asarray(j)).max() < STATE_TOL
    from tensorcircuit_ng_tpu.models import stabilizercircuit as jstab
    from tensorcircuit_ng_tpu_torch.models import stabilizercircuit as pstab

    assert callable(pstab.native_tableau_available) and callable(jstab.native_tableau_available)


def test_io_phase_checks_on_cpu():
    """``chip_smoke.py``'s phase 22 at a small size on the CPU."""
    import chip_smoke

    times = chip_smoke._io_checks(tct, "cpu", (), **chip_smoke.IO_SMALL)
    assert any(label.startswith("(d)") for label in times)
