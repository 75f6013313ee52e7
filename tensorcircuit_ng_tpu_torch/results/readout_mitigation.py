"""Scalable readout-error mitigation (reference ``results/readout_mitigation.py:43-790``).

The port's copy of ``tensorcircuit_ng_tpu/results/readout_mitigation.py``
(host numpy on the port's ``Circuit``); ``cals_from_api`` reads a cloud
device's calibration through the port's ``cloud/``.

``ReadoutMit(execute)`` takes a user ``execute: circuits, shots -> [counts]``
callable so mitigation is testable offline (reference ``:44-72``); supports
local (tensor-product) calibration (``cals_from_system:257``), inverse and
constrained-least-squares correction, and M3-style subspace mitigation
(reference ``:705`` ``_direct_solver`` / ``:722`` ``_matvec_solver``, which
the reference delegates to the external ``mthree`` package).

The M3 machinery here is a from-scratch vectorized redesign: with the
observed bitstrings as an (m, n) bit matrix ``X`` and per-qubit 2x2
calibrations ``A_q``, the reduced matrix has the closed form

    log A~[i, j] = alpha + u_i + v_j + (X diag(w) X^T)_{ij}

(every 2x2 log-cal splits as ``L[x,y] = L00 + a1 x + a2 y + w xy`` over
bits), so building the m x m subspace matrix — and the matrix-free GMRES
matvec — is ONE rank-n BLAS matmul plus an elementwise exp, chunked to
bound memory.  The 2^n calibration kron is never materialized; mitigating
30-qubit counts with 10k shots takes well under a second.  Hamming-distance
truncation reuses the same Gram product (d_ij = h_i + h_j - 2 (X X^T)_ij).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import counts as counts_mod

ct = Dict[str, int]

__all__ = ["ReadoutMit"]

#: above this many observed bitstrings, M3_auto switches direct -> iterative
M3_DIRECT_MAX = 4096

#: chunk of subspace rows materialized at once by the scalable builders
_CHUNK = 1024


def _log_cal_factors(
    cals: Sequence[np.ndarray],
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray]:
    """Split per-qubit log-cals into (alpha, a1, a2, w) rank-structure terms.

    ``L_q[x, y] = L00 + a1_q x + a2_q y + w_q x y`` for bits x (measured)
    and y (prepared); summing over qubits gives the module-docstring form.
    """
    ls = np.stack([np.log(np.clip(np.asarray(c, float), 1e-30, None)) for c in cals])
    l00, l01 = ls[:, 0, 0], ls[:, 0, 1]
    l10, l11 = ls[:, 1, 0], ls[:, 1, 1]
    alpha = float(l00.sum())
    return alpha, l10 - l00, l01 - l00, l11 + l00 - l10 - l01


class ReadoutMit:
    def __init__(self, execute: Callable[..., List[ct]]):
        self.execute = execute
        self.single_qubit_cals: Optional[Dict[int, np.ndarray]] = None
        self.global_cal: Optional[np.ndarray] = None
        self.n: Optional[int] = None

    # ------------------------------------------------------------------
    # calibration
    # ------------------------------------------------------------------

    def cals_from_system(self, qubits: Any, shots: int = 8192, method: str = "local") -> None:
        """Run calibration circuits through ``execute`` (reference ``:257``)."""
        from ..models.circuit import Circuit

        if isinstance(qubits, int):
            qubits = list(range(qubits))
        qubits = list(qubits)
        n = len(qubits)
        self.n = n
        if method == "local":
            c0 = Circuit(n)
            c1 = Circuit(n)
            for i in range(n):
                c1.x(i)
            res = self.execute([c0, c1], shots)
            self.single_qubit_cals = {}
            for i in range(n):
                m = np.zeros((2, 2))
                for prep, cnt in enumerate(res):
                    marg = counts_mod.marginal_count(cnt, [i])
                    tot = sum(marg.values())
                    m[0, prep] = marg.get("0", 0) / tot
                    m[1, prep] = marg.get("1", 0) / tot
                self.single_qubit_cals[qubits[i]] = m
            self.qubits = qubits
        elif method == "global":
            circuits = []
            for basis in range(2**n):
                c = Circuit(n)
                for i in range(n):
                    if (basis >> (n - 1 - i)) & 1:
                        c.x(i)
                circuits.append(c)
            res = self.execute(circuits, shots)
            a = np.zeros((2**n, 2**n))
            for prep, cnt in enumerate(res):
                v = counts_mod.count2vec(cnt)
                a[:, prep] = v
            self.global_cal = a
            self.qubits = qubits
        else:
            raise ValueError(f"unknown calibration method {method!r}")

    def set_local_cals(self, cals: Dict[int, np.ndarray]) -> None:
        self.single_qubit_cals = {k: np.asarray(v) for k, v in cals.items()}
        self.qubits = sorted(cals)
        self.n = len(self.qubits)

    def cals_from_api(self, qubits: Any, device: Optional[Any] = None) -> None:
        """Local calibrations of ``qubits`` (a list, or a count from 0) from
        a cloud device's properties (``device``, a name or a ``Device``, else
        the cloud API's default device): ``props["qubits"][str(q)]``'s
        ``ReadoutF0``/``ReadoutF1`` (or ``readout_fidelity_0/1``), 0.99 and
        0.98 where a qubit or its fidelities are not listed, as they are not
        where ``qubits`` is a count (the local provider's)."""
        from ..cloud import apis
        from ..cloud.abstraction import Device

        if isinstance(qubits, int):
            qubits = list(range(qubits))
        dev = Device.from_name(device) if device is not None else apis.get_device()
        props = dev.list_properties() or {}
        listed = props.get("qubits")
        listed = listed if isinstance(listed, dict) else {}
        cals: Dict[int, np.ndarray] = {}
        for q in qubits:
            info = listed.get(str(q), {})
            p00 = float(info.get("ReadoutF0", info.get("readout_fidelity_0", 0.99)))
            p11 = float(info.get("ReadoutF1", info.get("readout_fidelity_1", 0.98)))
            cals[q] = np.array([[p00, 1 - p11], [1 - p00, p11]])
        self.set_local_cals(cals)

    def local_miti_readout_circ(self) -> List[Any]:
        """|0…0⟩ and |1…1⟩ preparation circuits for local calibration (ref :170)."""
        from ..models.circuit import Circuit

        n = (max(self.qubits) + 1) if getattr(self, "qubits", None) else self.n
        c0 = Circuit(n)
        c1 = Circuit(n)
        for q in self.qubits if getattr(self, "qubits", None) else range(n):
            c1.x(q)
        return [c0, c1]

    def local_miti_readout_circ_by_mask(self, bsl: List[str]) -> List[Any]:
        """Preparation circuits for explicit bitstring masks (reference :187)."""
        from ..models.circuit import Circuit

        n = (max(self.qubits) + 1) if getattr(self, "qubits", None) else self.n
        cs = []
        for bs in bsl:
            c = Circuit(n)
            for j, b in enumerate(bs):
                if b == "1":
                    c.x(j)
            cs.append(c)
        return cs

    def global_miti_readout_circ(self) -> List[Any]:
        """All-2^n basis preparation circuits for global calibration (ref :198)."""
        from ..models.circuit import Circuit

        qubits = self.qubits if getattr(self, "qubits", None) else list(range(self.n))
        n = max(qubits) + 1
        cs = []
        for basis in range(2 ** len(qubits)):
            c = Circuit(n)
            for k, q in enumerate(qubits):
                if (basis >> (len(qubits) - 1 - k)) & 1:
                    c.x(q)
            cs.append(c)
        return cs

    # ------------------------------------------------------------------
    # correction
    # ------------------------------------------------------------------

    def _local_matrix(self, measured_qubits: Sequence[int]) -> np.ndarray:
        mats = [self.single_qubit_cals[q] for q in measured_qubits]
        a = np.eye(1)
        for m in mats:
            a = np.kron(a, m)
        return a

    def apply_correction(
        self,
        count: ct,
        qubits: Optional[Sequence[int]] = None,
        method: str = "inverse",
        **kws: Any,
    ) -> ct:
        """Mitigate a counts dict.

        Methods: ``inverse`` (pinv on the full matrix, small n only),
        ``square`` (constrained least squares, small n only), and the
        scalable subspace family ``M3_auto`` / ``M3_direct`` /
        ``M3_iterative`` (aliases ``m3``/``subspace``/``direct`` map to
        ``M3_auto``); M3 accepts ``distance=``, ``tol=``, ``max_iter=``.
        """
        if qubits is None:
            qubits = self.qubits
        shots = sum(count.values())
        if method.lower() in (
            "m3", "subspace", "direct", "m3_auto", "m3_direct", "m3_iterative",
        ):
            quasi, keys = self._m3_solve(count, qubits, method=method, **kws)
            prob = _nearest_probability(quasi)
            return {
                k: float(p * shots) for k, p in zip(keys, prob) if p > 1e-9
            }
        v = counts_mod.count2vec(count)
        if method in ("inverse", "pseudo_inverse"):
            a = (
                self._local_matrix(qubits)
                if self.single_qubit_cals is not None
                else self.global_cal
            )
            p = np.linalg.pinv(a) @ v
        elif method in ("square", "constrained_least_squares", "cls"):
            a = (
                self._local_matrix(qubits)
                if self.single_qubit_cals is not None
                else self.global_cal
            )
            p = _nnls_normalized(a, v)
        else:
            raise ValueError(f"unknown mitigation method {method!r}")
        p = np.clip(p, 0, None)
        if p.sum() > 0:
            p = p / p.sum()
        out = {}
        n = len(qubits)
        for i in np.nonzero(p > 1e-9)[0]:
            out[format(i, f"0{n}b")] = float(p[i] * shots)
        return out

    # ----- M3 subspace machinery (scalable; reference :560-770 role) ---

    def _m3_setup(self, count: ct, qubits: Sequence[int]):
        """Sorted keys, bit matrix X, rank-structure factors, prob vector."""
        if self.single_qubit_cals is None:
            raise ValueError("M3 methods need local calibration")
        keys = sorted(count)
        n = len(qubits)
        if len(keys[0]) != n:
            raise ValueError(
                f"bitstring length ({len(keys[0])}) does not match qubits ({n})"
            )
        x = np.frombuffer(
            "".join(keys).encode(), dtype=np.uint8
        ).reshape(len(keys), n) - ord("0")
        x = x.astype(np.float64)
        alpha, a1, a2, w = _log_cal_factors(
            [self.single_qubit_cals[q] for q in qubits]
        )
        # shift the log-scale so the largest diagonal entry sits at exp(0):
        # the scale cancels under column normalization, and it keeps every
        # relevant exponent inside numpy exp's fast SIMD range (see
        # _reduced_a_chunk)
        alpha = alpha - float((alpha + x @ (a1 + a2 + w)).max())
        factors = (alpha, a1, a2, w)
        b = np.asarray([count[k] for k in keys], float)
        b = b / b.sum()
        return keys, x, factors, b

    def _reduced_a_chunk(
        self, x, factors, rows: slice, distance: Optional[int]
    ) -> np.ndarray:
        """Rows ``rows`` of the (unnormalized) reduced matrix A~."""
        alpha, a1, a2, w = factors
        xc = x[rows]
        u = xc @ a1
        v = x @ a2
        g = (xc * w) @ x.T
        expo = alpha + u[:, None] + v[None, :] + g
        # _m3_setup shifted the scale so relevant entries sit near exp(0);
        # entries below exp(-85) are numerically irrelevant there, and the
        # clamp keeps numpy's exp on its fast SIMD path (arguments beyond
        # ~-87 drop to a ~100x slower scalar fallback)
        a = np.exp(np.maximum(expo, -85.0))
        if distance is not None and distance < x.shape[1]:
            h = x.sum(1)
            d = h[rows][:, None] + h[None, :] - 2.0 * (xc @ x.T)
            a[d > distance + 0.5] = 0.0
        return a

    def reduced_cal_matrix(
        self,
        count: ct,
        qubits: Optional[Sequence[int]] = None,
        distance: Optional[int] = None,
    ) -> Tuple[np.ndarray, List[str]]:
        """Column-normalized A restricted to observed bitstrings (ref :686).

        Built directly from the per-qubit cals via the rank-structured log
        form — the 2^n kron is never materialized.
        """
        if qubits is None:
            qubits = self.qubits
        if self.single_qubit_cals is None:
            # global-cal fallback: index into the dense matrix (small n)
            keys = sorted(count)
            idx = [int(k, 2) for k in keys]
            return self.global_cal[np.ix_(idx, idx)], keys
        keys, x, factors, _ = self._m3_setup(count, qubits)
        m = len(keys)
        a = np.vstack(
            [
                self._reduced_a_chunk(x, factors, slice(i, min(i + _CHUNK, m)), distance)
                for i in range(0, m, _CHUNK)
            ]
        )
        col = a.sum(0)
        col[col == 0] = 1.0
        return a / col[None, :], keys

    def _col_norms(self, x, factors, distance) -> np.ndarray:
        m = x.shape[0]
        col = np.zeros(m)
        for i in range(0, m, _CHUNK):
            col += self._reduced_a_chunk(
                x, factors, slice(i, min(i + _CHUNK, m)), distance
            ).sum(0)
        col[col == 0] = 1.0
        return col

    def _m3_solve(
        self,
        count: ct,
        qubits: Sequence[int],
        method: str = "M3_auto",
        distance: Optional[int] = None,
        tol: float = 1e-5,
        max_iter: int = 25,
    ) -> Tuple[np.ndarray, List[str]]:
        """Solve the subspace system; returns (quasiprobs, keys)."""
        keys, x, factors, b = self._m3_setup(count, qubits)
        m = len(keys)
        meth = method.lower()
        if meth in ("m3", "subspace", "direct", "m3_auto"):
            meth = "m3_direct" if m <= M3_DIRECT_MAX else "m3_iterative"
        if meth == "m3_direct":
            a, _ = self.reduced_cal_matrix(count, qubits, distance)
            from scipy import linalg as sla

            lu = sla.lu_factor(a, check_finite=False)
            return sla.lu_solve(lu, b, check_finite=False), keys
        # matrix-free GMRES with diagonal preconditioning (reference :722)
        from scipy.sparse import linalg as spla

        col = self._col_norms(x, factors, distance)

        def matvec(vec):
            out = np.empty(m)
            scaled = vec / col
            for i in range(0, m, _CHUNK):
                rows = slice(i, min(i + _CHUNK, m))
                out[rows] = self._reduced_a_chunk(x, factors, rows, distance) @ scaled
            return out

        alpha, a1, a2, w = factors
        diag = np.exp(np.maximum(alpha + x @ (a1 + a2 + w), -85.0)) / col
        lin = spla.LinearOperator((m, m), matvec=matvec)
        pre = spla.LinearOperator((m, m), matvec=lambda v: v / diag)
        try:
            sol, info = spla.gmres(
                lin, b, rtol=tol, atol=tol, maxiter=max_iter, M=pre
            )
        except TypeError:  # scipy < 1.14 keyword
            sol, info = spla.gmres(
                lin, b, tol=tol, atol=tol, maxiter=max_iter, M=pre
            )
        if info != 0:
            raise RuntimeError(f"GMRES did not converge: {info}")
        return sol, keys

    def mitigate_probability(
        self, probability_noise: Any, method: str = "inverse"
    ) -> np.ndarray:
        """Mitigate a probability vector (reference :354)."""
        a = self.get_matrix()
        v = np.asarray(probability_noise, dtype=np.float64)
        if method == "inverse":
            p = np.linalg.pinv(a) @ v
        else:
            p = _nnls_normalized(a, v)
        p = np.clip(p, 0, None)
        return p / p.sum() if p.sum() > 0 else p

    def apply_readout_mitigation(
        self, raw_count: ct, method: str = "inverse"
    ) -> Dict[str, float]:
        """Mitigated quasi-counts (reference :386)."""
        shots = sum(raw_count.values())
        v = counts_mod.count2vec(raw_count)
        p = self.mitigate_probability(v, method=method)
        n = int(np.log2(len(p)))
        return {
            format(i, f"0{n}b"): float(p[i] * shots)
            for i in np.nonzero(np.abs(p) > 1e-12)[0]
        }

    # ------------------------------------------------------------------
    # expectation
    # ------------------------------------------------------------------

    def expectation(
        self,
        count: ct,
        z: Optional[Sequence[int]] = None,
        diagonal_op: Optional[Any] = None,
        method: str = "inverse",
        **kws: Any,
    ) -> float:
        """Mitigated diagonal-observable expectation (reference ``:770``)."""
        if method in (None, "raw"):
            return counts_mod.expectation(count, z=z, diagonal_op=diagonal_op)
        mit = self.apply_correction(count, method=method, **kws)
        return counts_mod.expectation(mit, z=z, diagonal_op=diagonal_op)

    # ------------------------------------------------------------------
    # reference-parity helpers
    # ------------------------------------------------------------------

    def ubs(self, i: int, qubits: Optional[Sequence[Any]]) -> int:
        """Index filter for unused calibration qubits (reference :73)."""
        cal_qubits = self.qubits
        name = "{:0" + str(len(cal_qubits)) + "b}"
        bits = [int(x) for x in name.format(i)]
        vomit = 0
        for k, q in enumerate(cal_qubits):
            if qubits is not None and q not in qubits and bits[k]:
                vomit = 1
        return vomit

    def newrange(self, m: int, qubits: Optional[Sequence[Any]]) -> int:
        """Reindex a bitstring integer onto the used-qubit order (reference :93)."""
        if qubits is None:
            return m
        cal_qubits = [q for q in self.qubits if q in qubits]
        name = "{:0" + str(len(self.qubits)) + "b}"
        bits = {q: b for q, b in zip(self.qubits, name.format(m))}
        out = "".join(bits[q] for q in cal_qubits)
        return int(out, 2) if out else 0

    def get_matrix(self, qubits: Optional[Sequence[Any]] = None) -> np.ndarray:
        """Calibration matrix restricted to ``qubits`` (reference :121)."""
        if self.single_qubit_cals is not None:
            if qubits is None:
                qubits = self.qubits
            return self._local_matrix(list(qubits))
        return self.global_cal

    def mapping_preprocess(
        self,
        counts: ct,
        qubits: Sequence[int],
        positional_logical_mapping: Optional[Dict[int, int]] = None,
        logical_physical_mapping: Optional[Dict[int, int]] = None,
    ) -> Tuple[ct, List[int]]:
        """Rewrite counts keys from positional to physical order (reference :406)."""
        if positional_logical_mapping is None:
            positional_logical_mapping = {i: q for i, q in enumerate(qubits)}
        if logical_physical_mapping is None:
            logical_physical_mapping = {
                q: q for q in positional_logical_mapping.values()
            }
        phys = [
            logical_physical_mapping[positional_logical_mapping[i]]
            for i in range(len(qubits))
        ]
        order = np.argsort(phys)
        new_counts: ct = {}
        for k, vv in counts.items():
            nk = "".join(k[i] for i in order)
            new_counts[nk] = new_counts.get(nk, 0) + vv
        self.use_qubits = sorted(phys)
        return new_counts, sorted(phys)


def _nnls_normalized(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Least squares with nonnegativity + unit-sum via scipy nnls."""
    from scipy.optimize import nnls

    x, _ = nnls(a, b)
    if x.sum() > 0:
        x = x / x.sum()
    return x


def _nearest_probability(quasi: np.ndarray) -> np.ndarray:
    """Project a quasiprobability vector onto the probability simplex.

    Smolin–Gambetta–Smith closest-distribution algorithm (the role of
    mthree's ``nearest_probability_distribution``): sort ascending, zero
    negatives, spread the deficit over the remaining entries.
    """
    q = np.asarray(quasi, float)
    q = q / q.sum() if q.sum() != 0 else q
    order = np.argsort(q)
    out = q.copy()
    deficit = 0.0
    remaining = len(q)
    for pos, i in enumerate(order):
        if out[i] + deficit / remaining < 0:
            deficit += out[i]
            out[i] = 0.0
            remaining -= 1
        else:
            out[order[pos:]] += deficit / remaining
            break
    return np.clip(out, 0, None)
