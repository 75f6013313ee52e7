"""The port's ``cloud/`` and small helpers against the JAX package: the
provider API and the local provider, ``wrapper``'s expectations, the
tencent and tianyan providers under the JAX package's offline mocks (a mock
transport, a mock platform), ``ReadoutMit.cals_from_api``, ``utils.py``,
``about.py`` and ``asciiart.py``.

Nothing opens a connection: the remote providers talk to in-memory mocks,
and ``apis._TOKEN_FILE`` points into ``tmp_path``.  The port's circuits run
on the CPU at complex64.  Tolerances: counts drawn by numpy from the same
seed over the two packages' states are equal; counts sampled by the port
are held against exact probabilities within 5 standard deviations; exact
expectations within 1e-6; calibrations and mitigated values from the same
counts within 1e-9.
"""

import numpy as np
import pytest
import threadpoolctl
import torch

import tensorcircuit_ng_tpu as tc
import tensorcircuit_ng_tpu_torch as tct
from tensorcircuit_ng_tpu import utils as jutils
from tensorcircuit_ng_tpu.cloud import apis as japis
from tensorcircuit_ng_tpu.cloud import tencent as jtx
from tensorcircuit_ng_tpu.cloud import tianyan as jty
from tensorcircuit_ng_tpu.cloud import utils as jcloud_utils
from tensorcircuit_ng_tpu.cloud import wrapper as jwrapper
from tensorcircuit_ng_tpu.results import ReadoutMit as JReadoutMit
from tensorcircuit_ng_tpu_torch import asciiart, utils
from tensorcircuit_ng_tpu_torch.cloud import apis, local, quafu_provider
from tensorcircuit_ng_tpu_torch.cloud import tencent as tx
from tensorcircuit_ng_tpu_torch.cloud import tianyan as ty
from tensorcircuit_ng_tpu_torch.cloud import utils as cloud_utils
from tensorcircuit_ng_tpu_torch.cloud import wrapper
from tensorcircuit_ng_tpu_torch.cloud.abstraction import Device, Provider, TaskUnfinished, TCException
from tensorcircuit_ng_tpu_torch.results import ReadoutMit

EXACT_TOL = 1e-6
SAME = 1e-9
SIGMAS = 5.0


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


@pytest.fixture(autouse=True)
def _tokens_in_tmp(tmp_path, monkeypatch):
    """Both packages' token files in ``tmp_path``; their defaults restored."""
    monkeypatch.setattr(apis, "_TOKEN_FILE", str(tmp_path / "port.auth.json"))
    monkeypatch.setattr(japis, "_TOKEN_FILE", str(tmp_path / "jax.auth.json"))
    yield
    for mod in (apis, japis):
        mod.set_provider("local")
        mod.set_device("default")
        mod._tokens.clear()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bell(mod, n=2):
    c = mod.Circuit(n)
    c.h(0)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    return c


def _workload(mod):
    c = mod.Circuit(3)
    c.h(0)
    c.ry(1, theta=0.7)
    c.cnot(0, 2)
    c.rx(2, theta=-0.4)
    c.cz(1, 2)
    return c


def _within_sigmas(counts, probs, shots):
    """Each outcome's count within 5 binomial standard deviations of
    shots * p (and no outcome of probability 0)."""
    n = len(next(iter(counts)))
    for i, p in enumerate(probs):
        k = counts.get(format(i, f"0{n}b"), 0)
        sd = np.sqrt(shots * p * (1 - p))
        assert abs(k - shots * p) <= SIGMAS * sd + 1e-9, (i, k, shots * p)


def _tencent_workload(mod):
    """A circuit of the gates the mock chip takes (no rx)."""
    c = mod.Circuit(3)
    c.h(0)
    c.ry(1, theta=0.7)
    c.cnot(0, 2)
    c.cz(1, 2)
    return c


def _probs(c):
    return np.abs(_np(c.state()).astype(np.complex128)) ** 2


# ----------------------------------------------------------------------
# the API and the local provider
# ----------------------------------------------------------------------


def test_local_provider_counts_and_api():
    apis.set_provider("local")
    apis.set_device("default")
    c = _workload(tct)
    t = apis.submit_task(circuit=c, shots=8192)
    res = t.results()
    assert sum(res.values()) == 8192 and t.state() == "completed"
    _within_sigmas(res, _probs(c), 8192)
    assert [d.name for d in apis.list_devices()] == [d.name for d in japis.list_devices()]
    assert apis.list_properties() == japis.list_properties()
    ts = apis.submit_task(device="local::default", circuit=[_bell(tct), c], shots=[100, 200])
    assert [sum(x.results().values()) for x in ts] == [100, 200]
    assert set(ts[0].results()) <= {"00", "11"}
    # the same status gives the circuit's own sample
    st = np.random.default_rng(0).uniform(size=(64, 1))
    one = local.submit_task(Device("default"), circuit=c, shots=64, status=st)
    assert one.results() == {k: int(v) for k, v in c.sample(batch=64, allow_state=True, status=st,
                                                             format="count_dict_bin").items()}
    assert apis.get_task(t.id_) is t and t in apis.list_tasks()
    assert apis.get_task_details(t)["state"] == "completed"
    t2 = apis.resubmit_task(t, circuit=c, shots=10)
    assert sum(t2.results().values()) == 10
    apis.remove_task(t2)
    assert t2.id_ not in [x.id_ for x in apis.list_tasks()]
    t.add_details(logical_physical_mapping={0: 0})
    assert t.get_logical_physical_mapping() == {0: 0}
    with pytest.raises(TCException):
        raise TaskUnfinished("abc", "pending")
    assert repr(Device("tencent::9gmon")) == repr(japis.Device("tencent::9gmon")) == "Device(tencent::9gmon)"


def test_tokens_and_codec_match_jax():
    for mod in (apis, japis):
        assert mod.b64decode_s(mod.b64encode_s("secret")) == "secret"
        mod.set_token("tok-1", provider="tencent")
        mod._tokens.clear()
        assert mod.get_token("tencent") == "tok-1"  # read back from the token file
        assert mod.get_token("tianyan") is None
    with open(apis._TOKEN_FILE) as f, open(japis._TOKEN_FILE) as g:
        assert f.read() == g.read()
    assert apis.set_provider("tencent").name == japis.set_provider("tencent").name == "tencent"
    assert apis.get_provider().get_token() == "tok-1"
    assert sorted(set(apis.avail_providers)) == sorted(set(japis.avail_providers))
    assert apis.package_name == "tensorcircuit_ng_tpu_torch"


def test_reconnect_and_transport():
    calls = {"n": 0}

    @cloud_utils.reconnect(tries=3, sleep=0.0)
    def flaky():
        calls["n"] += 1
        if calls["n"] < 2:
            raise ConnectionError("down")
        return 7

    assert flaky() == 7 and calls["n"] == 2

    @cloud_utils.reconnect(tries=3, sleep=0.0)
    def refused():
        calls["n"] += 1
        raise cloud_utils.HttpStatusError("404")

    with pytest.raises(cloud_utils.HttpStatusError):
        refused()
    assert calls["n"] == 3
    seen = []
    cloud_utils.set_transport(lambda m, u, b, h: seen.append((m, u, b)) or {"ok": 1})
    try:
        assert cloud_utils.rpost_json("https://example.invalid/x", body={"a": 1}) == {"ok": 1}
        assert cloud_utils.rget("https://example.invalid/y") == {"ok": 1}
    finally:
        cloud_utils.set_transport(None)
    assert seen == [("POST", "https://example.invalid/x", {"a": 1}), ("GET", "https://example.invalid/y", None)]
    cloud_utils.set_proxy("http://localhost:1")
    assert cloud_utils._PROXY == {"http": "http://localhost:1", "https": "http://localhost:1"}
    cloud_utils.set_proxy(None)


# ----------------------------------------------------------------------
# wrapper
# ----------------------------------------------------------------------


def test_batch_expectation_ps_exact_and_local():
    pss = [[3, 3, 0], [1, 0, 1], [0, 3, 3], [2, 2, 0]]
    cp, cj = _workload(tct), _workload(tc)
    exact_p, exact_j = wrapper.batch_expectation_ps(cp, pss), jwrapper.batch_expectation_ps(cj, pss)
    assert np.abs(exact_p - exact_j).max() < EXACT_TOL
    ws = [0.5, -1.0, 2.0, 0.25]
    assert abs(wrapper.batch_expectation_ps(cp, pss, ws=ws) - jwrapper.batch_expectation_ps(cj, pss, ws=ws)) < EXACT_TOL
    shots = 8192
    sampled = wrapper.batch_expectation_ps(cp, pss, device="local::default", shots=shots, with_rem=False)
    # a ±1 variable: the standard deviation of the mean is sqrt((1 - <P>^2) / shots)
    assert np.all(np.abs(sampled - exact_p) <= SIGMAS * np.sqrt((1 - exact_p**2) / shots) + 1e-9)
    mitigated = wrapper.batch_expectation_ps(cp, pss[:2], device="local::default", shots=shots)
    assert np.all(np.abs(mitigated - exact_p[:2]) < 0.1)
    v = wrapper.sample_expectation_ps(cp, z=[0, 2], shots=shots)
    e = float(np.real(_np(cp.expectation_ps(z=[0, 2]))))
    assert abs(v - e) <= SIGMAS * np.sqrt((1 - e**2) / shots)
    v = wrapper.sample_expectation_ps(cp, device="local::default", x=[0], z=[2], shots=shots)
    e = float(np.real(_np(cp.expectation_ps(x=[0], z=[2]))))
    assert abs(v - e) <= SIGMAS * np.sqrt((1 - e**2) / shots)
    counts = [{"00": 30, "11": 50, "01": 20}, {"10": 7, "00": 3}]
    assert abs(wrapper.reduce_and_evaluate(counts, [0.3, -2.0])
               - jwrapper.reduce_and_evaluate(counts, [0.3, -2.0])) < SAME
    execute = wrapper.batch_submit_template("local::default")
    res = execute([_bell(tct)], 50)
    assert len(res) == 1 and sum(res[0].values()) == 50


# ----------------------------------------------------------------------
# tencent, under the JAX package's mock QOS
# ----------------------------------------------------------------------


class MockQOS:
    """In-memory stand-in for the tencent QOS API (the JAX package's
    offline suite's), executing OpenQASM with ``qasm2tc`` of either package
    and drawing counts by a numpy generator of seed 11."""

    def __init__(self, qasm2tc):
        self.qasm2tc = qasm2tc
        self.tasks = {}
        self.counter = 0
        self.devices = [
            {"id": "simulator:tc", "type": "SIMULATOR", "state": "on"},
            {"id": "9gmon", "type": "CHIP", "state": "on"},
        ]
        self.device_detail = {
            "id": "9gmon",
            "type": "CHIP",
            "state": "on",
            "links": [
                {"A": 0, "B": 1, "CZErrRate": 0.01, "at": 1673605888},
                {"A": 1, "B": 2, "CZErrRate": 0.02, "at": 1673605888},
            ],
            "bits": [
                {"Qubit": 0, "T1": 30.0, "T2": 5.0},
                {"Qubit": 1, "T1": 32.0, "T2": 6.0},
                {"Qubit": 2, "T1": 28.0, "T2": 4.5},
            ],
            "langs": ["OPENQASM"],
        }

    def _execute(self, source, shots):
        c = self.qasm2tc(source)
        p = np.abs(_np(c.state())) ** 2
        p = p / p.sum()
        rng = np.random.default_rng(11)
        counts = {}
        for s in rng.choice(len(p), size=shots, p=p):
            key = format(int(s), f"0{c._nqubits}b")
            counts[key] = counts.get(key, 0) + 1
        return counts

    def _submit_one(self, job):
        if "rx(" in job["source"]:
            return {"err": "gate rx not supported on this device"}
        self.counter += 1
        tid = f"qos-{self.counter}"
        self.tasks[tid] = {
            "id": tid,
            "state": "completed",
            "at": 1666752095915849,
            "ts": {"completed": 1666752099915849, "pending": 1666752095915849},
            "shots": job["shots"],
            "source": job["source"],
            "device": job["device"],
            "result": {"counts": self._execute(job["source"], job["shots"])},
            "optimization": {"pairs": {"0": 0, "1": 1}},
        }
        return {"id": tid, "state": "pending"}

    def __call__(self, method, url, body, headers):
        assert headers["Authorization"].startswith("Bearer "), headers
        endpoint = url.split("/qos/api/")[1].split("?")[0]
        if endpoint == "device/find":
            return {"devices": self.devices}
        if endpoint == "device/detail":
            if body["id"] != "9gmon":
                return {"err": f"unknown device {body['id']}"}
            return {"device": self.device_detail}
        if endpoint == "task/submit":
            jobs = body if isinstance(body, list) else [body]
            return {"tasks": [self._submit_one(j) for j in jobs]}
        if endpoint == "task/detail":
            t = self.tasks.get(body["id"])
            return {"task": t} if t else {"err": "task not found"}
        if endpoint == "task/find":
            sel = [{"id": t["id"], "device": t["device"]} for t in self.tasks.values()
                   if body.get("device") is None or t["device"].startswith(body["device"])]
            return {"tasks": sel}
        if endpoint == "task/start":
            old = self.tasks[body["id"]]
            return {"tasks": [self._submit_one({k: old[k] for k in ("device", "shots", "source")})]}
        if endpoint == "task/remove":
            self.tasks.pop(body["id"], None)
            return {"ok": True}
        raise AssertionError(f"unexpected endpoint {endpoint}")


def _tencent_flow(mod, txm, utils_mod, apis_mod, qasm2tc):
    """The JAX suite's tencent flow on one package: device listing and
    properties, a submit and its counts, the QOS options, a batch with a
    rejected task, the lifecycle and the prettified details."""
    qos = MockQOS(qasm2tc)
    utils_mod.set_transport(qos)
    apis_mod.set_token("faketoken-123", provider="tencent")
    try:
        out = {}
        devs = txm.list_devices()
        out["devs"] = [d.name for d in devs]
        props = txm.list_properties(devs[1])
        out["props"] = (props["links"][(0, 1)]["CZErrRate"], props["bits"][2]["T1"], props["native_gates"])
        with pytest.raises(RuntimeError, match="unknown device"):
            txm.list_properties(txm.Device("nope", txm.Provider.from_name("tencent")))
        dev = txm.Device("9gmon", txm.Provider.from_name("tencent"))
        task = txm.submit_task(dev, circuit=_tencent_workload(mod), shots=4096)
        det = txm.get_task_details(task)
        out["counts"] = det["results"]
        assert task.results() == det["results"] and det["state"] == "completed"
        out["mapping"] = task.get_logical_physical_mapping()
        out["dev_str"] = qos.tasks[task.id_]["device"]
        t = txm.submit_task(dev, circuit=_bell(mod), shots=16, enable_qos_qubit_mapping=False,
                            enable_qos_gate_decomposition=False, enable_qos_initial_mapping=True, qos_dry_run=True)
        out["dry"] = qos.tasks[t.id_]["device"]
        t2 = txm.submit_task(txm.Device("9gmon?o=7", txm.Provider.from_name("tencent")), circuit=_bell(mod), shots=16)
        out["pre"] = qos.tasks[t2.id_]["device"]
        badc = mod.Circuit(1)
        badc.rx(0, theta=0.3)
        tasks = txm.submit_task(dev, circuit=[_bell(mod), badc, _bell(mod)], shots=[64, 64, 128])
        out["batch"] = sorted(qos.tasks[x.id_]["shots"] for x in tasks)
        with pytest.raises(ValueError, match="All tasks submitted failed"):
            txm.submit_task(dev, circuit=[badc, badc], shots=8)
        c = mod.Circuit(1)
        c.h(0)
        c.s(0)
        c.t(0)
        out["fold"] = (txm._fold_phase_gates(c.to_openqasm()), txm._fold_phase_gates("rz(-pi/2) q[1];"),
                       txm._fold_phase_gates("rz(0.3) q[1];"))
        found = txm.list_tasks(dev)
        out["found"] = [f.id_ for f in found]
        t3 = txm.resubmit_task(task)
        txm.remove_task(task)
        out["after"] = (t3.id_, [f.id_ for f in txm.list_tasks(dev)])
        pretty = txm.get_task_details(t3, prettify=True)
        out["pretty"] = (pretty["at"], pretty["ts"]["completed"], pretty["optimization"]["pairs"])
        out["frontend"] = _np(pretty["frontend"].state())
        return out
    finally:
        utils_mod.set_transport(None)


def test_tencent_offline_suite_matches_jax():
    op = _tencent_flow(tct, tx, cloud_utils, apis, lambda s: tct.translation.qasm2tc(s, device="cpu"))
    oj = _tencent_flow(tc, jtx, jcloud_utils, japis, tc.translation.qasm2tc)
    fp, fj = op.pop("frontend"), oj.pop("frontend")
    assert op == oj
    assert np.abs(fp - fj).max() < EXACT_TOL
    assert op["dev_str"] == "9gmon?o=3" and op["dry"] == "9gmon?o=4&dry" and op["batch"] == [64, 128]
    _within_sigmas(op["counts"], _probs(_tencent_workload(tct)), 4096)


# ----------------------------------------------------------------------
# tianyan, under the JAX package's mock platform
# ----------------------------------------------------------------------


def _qcis_circuit(mod):
    c = mod.Circuit(3)
    c.h(0)
    c.cnot(0, 1)
    c.cy(1, 2)
    c.swap(0, 2)
    c.rx(0, theta=0.3)
    c.ry(1, theta=-0.8)
    c.rz(2, theta=1.1)
    c.t(0)
    c.sd(1)
    c.toffoli(0, 1, 2)
    c.iswap(0, 1)
    c.measure_instruction(2)
    c.measure_instruction(0)
    return c


def test_qcis_translation_lowering_and_simulation_match_jax():
    qp, qj = ty.circuit_to_qcis(_qcis_circuit(tct)), jty.circuit_to_qcis(_qcis_circuit(tc))
    assert qp == qj
    assert ty.lower_to_native(qp) == jty.lower_to_native(qj)
    (cp, mp), (cj, mj) = ty.parse_qcis(qp, device="cpu"), jty.parse_qcis(qj)
    assert mp == mj == [2, 0]
    assert np.abs(_np(cp.state()) - np.asarray(cj.state())).max() < EXACT_TOL
    native = ty.lower_to_native(qp)
    c2, _ = ty.parse_qcis(native)
    psi1, psi2 = _np(cp.state()), _np(c2.state())
    k = np.argmax(np.abs(psi1))
    assert np.abs(psi2 - psi1 * psi2[k] / psi1[k]).max() < 1e-5
    assert ty.simulate_qcis(qp, shots=2000, seed=42) == jty.simulate_qcis(qj, shots=2000, seed=42)
    coupling = [(0, 1), (1, 2)]
    assert ty.validate_topology(_qcis_circuit(tct).to_qir(), coupling) == jty.validate_topology(
        _qcis_circuit(tc).to_qir(), coupling)
    with pytest.raises(ValueError, match="partial iSwap"):
        ty.qir2qcis([{"name": "iswap", "index": (0, 1), "parameters": {"theta": torch.tensor(0.5)}}], 2)


class MockPlatform:
    """The TianYan service of the JAX package's offline suite: stores
    experiments and runs their QCIS with ``simulate`` (seed 42)."""

    def __init__(self, simulate):
        self.simulate = simulate
        self.machines = [{"name": "tianyan_sim"}, {"name": "tianyan504"}]
        self.config = {}
        self.experiments = {}
        self.fail_ids = set()
        self.counter = 0

    def query_machine_list(self):
        return self.machines

    def download_config(self, machine):
        return self.config.get(machine, {})

    def submit_experiment(self, qcis, machine, shots, exp_name):
        self.counter += 1
        tid = f"exp{self.counter}"
        self.experiments[tid] = (qcis, shots)
        return tid

    def query_experiment(self, tid):
        if tid in self.fail_ids:
            return [{"experimentTaskId": tid, "state": "failed", "err": "calibration"}]
        qcis, shots = self.experiments[tid]
        counts = self.simulate(qcis, shots=shots, seed=42)
        result = [sorted(range(len(next(iter(counts)))))]
        for bits, cnt in counts.items():
            result.extend([[int(b) for b in bits]] * cnt)
        return [{"experimentTaskId": tid, "resultStatus": result}]


def _tianyan_flow(mod, tym):
    pf = MockPlatform(tym.simulate_qcis)
    tym.set_platform(pf)
    try:
        out = {"devices": [d.name for d in tym.list_devices()]}
        dev = tym.Device("tianyan_sim", tym.Provider.from_name("tianyan"))
        task = tym.submit_task(dev, circuit=_workload(mod), shots=4000)
        out["details"] = tym.get_task_details(task)
        out["counts"] = task.results()
        out["batch"] = len(tym.submit_task(dev, circuit=[_bell(mod), _bell(mod)], shots=[100, 50]))
        t2 = tym.resubmit_task(task)
        tym.get_task_details(t2)
        out["resubmit"] = t2.results()
        pf.config["tianyan504"] = {"overview": {
            "coupler_map": {"c01": ["Q0", "Q1"], "c12": ["Q1", "Q2"]},
            "qubits": ["Q0", "Q1", "Q2", "Q3"],
            "disabledQubits": "Q3",
        }}
        dev504 = tym.Device("tianyan504", tym.Provider.from_name("tianyan"))
        tym.submit_task(dev504, circuit=_bell(mod), shots=10)
        bad = mod.Circuit(3)
        bad.h(0)
        bad.cnot(0, 2)
        with pytest.raises(ValueError, match="no coupler"):
            tym.submit_task(dev504, circuit=bad, shots=10)
        bad2 = mod.Circuit(4)
        bad2.x(3)
        with pytest.raises(ValueError, match="not usable"):
            tym.submit_task(dev504, circuit=bad2, shots=10)
        out["props"] = tym.get_device_properties(dev504)
        pf.fail_ids.add(f"exp{pf.counter + 1}")
        failed = tym.submit_task(dev, circuit=_bell(mod), shots=10)
        out["failed"] = (failed.id_, tym.get_task_details(failed))
        out["from_qasm"] = tym.submit_task(dev, source=_bell(mod).to_openqasm(), lang="OPENQASM", shots=8).id_
        return out
    finally:
        tym.set_platform(None)


def test_tianyan_offline_suite_matches_jax():
    op, oj = _tianyan_flow(tct, ty), _tianyan_flow(tc, jty)
    assert op == oj
    assert op["details"]["state"] == "completed" and sum(op["counts"].values()) == 4000
    assert op["failed"][1]["state"] == "failed" and "calibration" in op["failed"][1]["err"]
    assert op["props"]["qubits"] == [0, 1, 2] and (0, 1) in op["props"]["coupling_map"]
    _within_sigmas(op["counts"], _probs(_workload(tct)), 4000)


def test_quafu_provider_keeps_its_registry():
    """The quafu SDK is not installed: its calls raise ImportError, and the
    client-side registry answers in both packages."""
    from tensorcircuit_ng_tpu.cloud import quafu_provider as jquafu

    for q in (quafu_provider, jquafu):
        with pytest.raises(ImportError):
            q.list_devices()
        with pytest.raises(ValueError, match="stored"):
            q.resubmit_task("nope")
        assert q.list_tasks() == []


# ----------------------------------------------------------------------
# ReadoutMit.cals_from_api
# ----------------------------------------------------------------------


class _CalibratedDevice(Device):
    """A device whose properties list readout fidelities per qubit."""

    PROPS = {"qubits": {"0": {"ReadoutF0": 0.97, "ReadoutF1": 0.93},
                        "1": {"readout_fidelity_0": 0.95, "readout_fidelity_1": 0.9}}}

    def list_properties(self):
        return self.PROPS


def test_cals_from_api_matches_jax():
    """From a mock provider's device (the cloud API's default device in
    both packages) the port's calibrations equal the JAX package's, and so
    do the mitigated values.  The JAX ``cals_from_api`` raises on its
    ``device=`` argument (it calls ``apis.get_device(device)``, which takes
    none) and on the local provider's properties (``"qubits": 30``): F22,
    kept in the JAX package; the port takes a device name or ``Device`` and
    reads a count of qubits as no per-qubit data."""
    from tensorcircuit_ng_tpu.cloud.abstraction import Device as JDevice

    class JDev(JDevice):
        def list_properties(self):
            return _CalibratedDevice.PROPS

    apis.set_device(_CalibratedDevice("mock", Provider.from_name("mock")))
    japis.set_device(JDev("mock", japis.Provider.from_name("mock")))
    mp, mj = ReadoutMit(lambda cs, shots: []), JReadoutMit(lambda cs, shots: [])
    mp.cals_from_api(3)
    mj.cals_from_api(3)
    assert mp.qubits == mj.qubits == [0, 1, 2]
    for q in mp.qubits:
        assert np.abs(mp.single_qubit_cals[q] - mj.single_qubit_cals[q]).max() < SAME
    counts = {"000": 400, "011": 100, "101": 300, "111": 224}
    assert abs(mp.expectation(counts, z=[0, 1], method="inverse")
               - mj.expectation(counts, z=[0, 1], method="inverse")) < SAME
    m2 = ReadoutMit(lambda cs, shots: [])
    m2.cals_from_api([1], device=_CalibratedDevice("mock", Provider.from_name("mock")))
    assert np.abs(m2.single_qubit_cals[1] - mp.single_qubit_cals[1]).max() < SAME
    with pytest.raises(TypeError):
        mj.cals_from_api([1], device="mock::mock")
    apis.set_device("local::default")
    japis.set_device("local::default")
    m3 = ReadoutMit(lambda cs, shots: [])
    m3.cals_from_api(2)
    assert np.abs(m3.single_qubit_cals[0] - np.array([[0.99, 0.02], [0.01, 0.98]])).max() < SAME
    with pytest.raises(AttributeError):
        JReadoutMit(lambda cs, shots: []).cals_from_api(2)


# ----------------------------------------------------------------------
# utils.py, about.py, asciiart.py
# ----------------------------------------------------------------------


def test_utils_match_jax(capsys):
    x = torch.arange(16.0)
    out, staging, running = utils.benchmark(lambda v: torch.sum(v * v), x, tries=3, verbose=True)
    assert float(out) == 1240.0 and staging >= 0 and running >= 0
    assert "staging time" in capsys.readouterr().out
    for mod in (utils, jutils):

        @mod.arg_alias(alias_dict={"theta": ["angle", "t"]})
        def g(theta=0.0):
            return theta

        assert g(angle=1.5) == 1.5 and g(t=2.0) == 2.0 and g(0.5) == 0.5
        assert mod.return_partial(lambda: (1, 2, 3), [0, 2])() == (1, 3)
        assert mod.return_partial(lambda: (1, 2, 3), 1)() == 2
        assert mod.append(lambda a: a + 1, lambda b: b * 2, str)(3) == "8"
        assert mod.is_sequence([1]) and not mod.is_sequence(1)
        assert mod.is_number(np.float32(1.0)) and not mod.is_number("1")
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    cost = utils.cost_analysis(lambda p, q: p @ q, a, b)
    assert cost["flops"] == 2 * 8 * 16 * 4
    assert cost["bytes accessed"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_about_cite_and_ascii_art(capsys):
    report = tct.about()
    assert "Torch version" in report and "tensorcircuit_ng_tpu_torch version: 0.1.0" in report
    assert tct.cite() == tc.cite()
    capsys.readouterr()
    assert "tpu_torch" in str(asciiart.gpu_art)
    assert str(asciiart.lucky(3)) in asciiart._FORTUNES
    asciiart.set_ascii("bye", {"bye": "so long"})
    assert asciiart.get_message("unknown") == "so long"
    asciiart.set_ascii("welcome")
