"""One rank of the two-process check in ``tests/test_torch_parallel.py``.

Run as ``python tests/torch_parallel_worker.py RANK PORT FS_PATH`` twice
(ranks 0 and 1) with a free local port: the two processes form a gloo
group on the CPU and run the port's process-group paths, then print one
JSON line of their results.  The inputs are made here from fixed seeds;
the test builds the JAX package's dense values from the same functions.
It imports torch and the port only.
"""

import json
import sys

import numpy as np
import torch

TERM_N = 6
DC_N = 6
SV_N = 5
TIMEOUT_S = 60


def term_inputs():
    """(structures, weights, angles) of a TFIM-like sum of 11 Pauli strings."""
    ls, ws = [], []
    for i in range(TERM_N - 1):
        l = [0] * TERM_N
        l[i] = l[i + 1] = 3
        ls.append(l)
        ws.append(1.0)
    for i in range(TERM_N):
        l = [0] * TERM_N
        l[i] = 1
        ls.append(l)
        ws.append(-1.0)
    th = np.random.default_rng(3).normal(size=TERM_N) * 0.3
    return np.array(ls), np.array(ws), th


def term_state(mod, th, **kw):
    c = mod.Circuit(TERM_N, **kw)
    for i in range(TERM_N):
        c.h(i)
    for i in range(TERM_N - 1):
        c.rzz(i, i + 1, theta=th[i])
    for i in range(TERM_N):
        c.rx(i, theta=th[i])
    return c


def dc_circuit(mod, params, **kw):
    c = mod.Circuit(DC_N, **kw)
    for i in range(DC_N):
        c.ry(i, theta=0.3 * i + 0.2)
    for i in range(DC_N - 1):
        c.cnot(i, i + 1)
    for i in range(DC_N):
        c.rx(i, theta=params[i])
    for i in range(DC_N - 1):
        c.cnot(i, i + 1)
    return c


def dc_params():
    return np.random.default_rng(2).normal(size=DC_N)


def sv_inputs():
    """(zz, rx, theta) of the group-mesh circuit."""
    rng = np.random.default_rng(5)
    return rng.normal(size=SV_N) * 0.3, rng.normal(size=SV_N) * 0.4, 0.7


def sv_pairs():
    return [(i, (i + 1) % SV_N) for i in range(SV_N)]


def sv_circuit(mod, zz, rx, theta, **kw):
    """A ring TFIM layer, then rx(theta) on top wire 0 and a CNOT from it."""
    c = mod.Circuit(SV_N, **kw)
    c.h_layer()
    c.zzrx_layer(sv_pairs(), zz, rx)
    c.rx(0, theta=theta)
    c.cnot(0, 3)
    return c


def _np(x):
    return x.detach().cpu().numpy().tolist()


def main(rank: int, port: int, fs_path: str) -> None:
    import torch.distributed as dist

    import tensorcircuit_ng_tpu_torch as tct
    from tensorcircuit_ng_tpu_torch import experimental, parallel

    torch.set_num_threads(1)
    parallel.initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo", timeout=TIMEOUT_S)
    try:
        out = {"rank": rank}
        out["bcast"] = experimental.broadcast_py_object({"from": rank, "v": [1, 2, 3]} if rank == 0 else None)
        out["bcast_fs"] = experimental.broadcast_py_object_fs(
            {"fs_from": rank} if rank == 0 else None, path=fs_path, timeout=TIMEOUT_S)
        with tct.set_device("cpu"):
            mesh = parallel.default_mesh("devices")
            out["mesh"] = repr(mesh)
            ls, ws, th = term_inputs()
            energy = parallel.term_sharded_expectation(
                lambda p: term_state(tct, p).state(), ls, ws, mesh, "devices")
            p = torch.tensor(th, dtype=torch.float32, requires_grad=True)
            e = energy(p)
            (g,) = torch.autograd.grad(e, p)
            out["term"] = [e.item(), _np(g)]

            def ir_fn(params):
                return dc_circuit(tct, params).expectation_before((tct.gates.z(), [0]), (tct.gates.z(), [1]))

            params = torch.tensor(dc_params(), dtype=torch.float32)
            dc = parallel.DistributedContractor(ir_fn, params, options={"target_size": 2**3}, mesh=mesh)
            v, g = dc.value_and_grad(params, op=lambda x: torch.abs(x) ** 2)
            out["dc"] = [float(v), _np(g), dc.report()["num_slices"], complex(dc.value(params)).real]

            smesh = parallel.ProcessGroupMesh("sv")
            zz, rx, theta = sv_inputs()
            zz_t = torch.tensor(zz, dtype=torch.float32, requires_grad=True)
            th_t = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
            c = sv_circuit(tct, zz_t, rx, th_t, mesh=smesh)
            ez = c.expectation_ps(z=[0, 2]).real
            ex = c.expectation((tct.gates.x(), [0])).real
            gz = torch.autograd.grad(ez, [zz_t, th_t], retain_graph=True)
            en = c.expectation_zzx_energy(sv_pairs(), 1.0, 0.7)
            gen = torch.autograd.grad(en, [zz_t, th_t])
            out["sv"] = [ez.item(), ex.item(), _np(gz[0]), gz[1].item(), en.item(), _np(gen[0]), gen[1].item(),
                         _np(c.state().gather())]
        print(json.dumps(out, default=complex_pair))
    finally:
        dist.destroy_process_group()


def complex_pair(z):
    return [z.real, z.imag]


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
