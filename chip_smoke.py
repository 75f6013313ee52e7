#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the kernels, holds
each against its plain PyTorch version, drives the N=20 TFIM energy path
and its training step (also under ``FUSE_ROWM`` and every switch of the
stack), the n=60 TEBD path, the n=20 HEA training step and the n=20, p=4
QAOA MaxCut training step through the public API, runs the staged
micro-benchmark of K2's design, and times them; then drives the rest of the
circuit API (echo, remapping, Pauli strings, light cone, the unitary) and
sampling (shots in six formats, trajectories, readout error, shot-noise
expectations, feed-forward) and noise at the same width, the contraction
engine past the dense cliff, the MPS simulators, the Hamiltonians and the
QI toolbox, and the backend's transforms (the training step as a captured
CUDA graph, vvag, parameter shift, Adam), time evolution and shadows,
and the stabilizer simulator, QEC detectors, qudits and one U(1) sector.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the kernels from ``tensorcircuit_ng_tpu_torch/core/csrc`` (one
     nvcc for each source, all at once, into ``build/kernels/``); print the
     build time and the card's name and power limit;
  2. kernel parity on the card at the n=20 shapes: K1 ``zzrx_fwd`` with and
     without the lane matrix (and with it at n=22, the shape the n=22 step
     gives K1), K2 ``grand_zzrx_fwd`` at L=4, K3 ``zzrx_bwd`` with and
     without the lane matrix (and with it at n=22, the shape the training
     path gives K3), K4 ``grand_zzrx_bwd`` at L=4 and L=3 (K1-K4 twice: the
     two results must be equal bit for bit),
     each against its plain version on the same CUDA inputs, with unitary
     rx-kron outer and lane matrices; K1's and K2's input planes unwritten;
     K1 alone by a replayed CUDA graph in each of its three variants, and
     one ``torch.matmul`` of its product's shapes at n=22;
  3. the forward path: ``Circuit(20)`` h_layer + 4 zzrx_layer +
     ``expectation_zzx_energy`` for 5 seeded parameter sets (and the state
     of the first), then L=3 once (K1 through the circuit), with the launch
     counts reset just before and read just after; energies against the
     port's CPU path, the state's norm against 1;
  4. the training path, the main path of the training slice: 5 SGD steps
     ``p <- p - 0.01 dE/dp`` (``torch.autograd.grad``) at n=20, L=4 from
     the benchmark's seeded parameters, then one step at n=20, L=3 (K1
     forward + K4 backward) and one at n=22, L=4 (K1 forward, K3 backward
     with the lane matrix), with the launch counts reset just before and
     read just after; energies and gradients against the same steps on the
     port's CPU path;
  5. timings (CUDA events, after warm-up): the evaluation and the training
     step (median of 20), each kernel at its path's shape (K3 at n=22, the
     others at n=20) over 3 rounds of 20 medians and its plain version over
     3 rounds of 5 single calls, reported as median and spread; K2 also by
     a replayed CUDA graph;
  6. torch.profiler windows over 10 L=4 evaluations and 10 L=4 training
     steps: device busy share and device time by kernel name; K3/K4's
     adjoint stages (``csrc/adjoint_stages.cuh``): their plan at n=20 (also
     under the row kron) and n=22 as the card reports it, against the
     Python arithmetic, without local memory; nvcc's registers and spills
     of each stage kernel (a spill fails); dM alone at 32, 64 and 128 row
     chunks; each stage (the outer walk with its sum, the lane pair, dM with
     its colsum, the row stage's two passes and their sum) by device time
     a layer on the training step, beside its bound and one PyTorch call of
     each product (a replayed CUDA graph); K2's stages
     (``csrc/zzrx_fwd.cu`` on the forward row stage and product of
     ``csrc/adjoint_stages.cuh``): its plan at n=20 L=4 as the card reports
     it against the Python arithmetic, registers and spills (a spill
     fails), and each stage (the two row passes, the product beside one
     ``torch.matmul``, the outer pass) by device time a layer on the
     training step beside its bound; K1's stages (``csrc/zzrx_fwd.cu`` on
     the same forward row stage and product): its plan at n=20 with the
     lane as the card reports it against ``zzrx_fwd_plan``, registers and
     spills, and each stage (the zz pass, the other pass, the transpose of
     M, the product beside one ``torch.matmul``) by device time a launch
     on the n=20 L=3 training step (K1 three times a step) beside its
     bound;
  7. the TEBD path, the main path of the TEBD slice: ``ParallelTEBD(60, 64,
     initial="neel")`` on the card for 10 trotter steps with the gate
     stacks of ``bench.py``'s TEBD workload, the launch counts reset just
     before and read just after (K5 must run twice a step); <Z_i> on all
     60 sites, lambda at bond 30 and the norm against the same steps on the
     port's CPU path in complex128, with the complex64 CPU Gram run's
     errors printed beside them; then K5 ``jacobi_svd`` against its plain
     version on the card: the path's own B=30 and B=29 thetas, random,
     decaying, rank-deficient and degenerate 128x128 batches of 30 and a
     (30, 128, 80) panel with V, the random batch without; K5 equal to
     itself over two runs; the trotter step timed (CUDA events), K5, its
     plain version and ``torch.linalg.svd`` timed on the B=30 thetas, K5's
     cluster size, the card's cluster occupancy, K5 at every cluster size
     that runs and K5's time a round, and a torch.profiler window over 3
     steps (one K5 kernel name);
  8. the HEA path, the main path of the single-qubit-layer slice: K6
     ``row_fwd`` and K7 ``row_bwd`` with and without the lane matrix and K8
     ``row_bwd_const`` against their plain versions at n=20 (nkernel=11,
     r=8192; distinct unitary gates, K7 twice, equal bit for bit); 5 SGD
     steps of :func:`hea_energy` at n=20, L=4 on the card, the launch
     counts reset just before and read just after (K6 9, K7 8 and K8 1 a
     step), energies and gradients against the same steps on the port's CPU
     path; the step timed (CUDA events) and profiled, each kernel and its
     plain version timed at the path's shape over 3 rounds (K6 and K7 also
     with the lane); K6's and K7's stage plans at n=20 with and without the
     lane and K8's (each stage kernel's CTAs, threads, shared bytes, CTAs
     an SM, registers, local bytes) against the Python arithmetic, nvcc's
     registers and spills of their passes, K6's product and the transpose
     (a spill fails), and each of their row passes (K6 and K8, one kernel
     instance each: the low pass, then the high one, told apart by their
     order in the trace; K7: the first, the last with its colsum) by device
     time a launch on the HEA step, beside its bound; K6 (with and without
     the lane), K7 and K8 alone by a replayed CUDA graph;
  9. the QAOA path, the main path of the QAOA slice: MaxCut on the n=20
     graph of ``examples/qaoa_maxcut_fused.py`` (37 edges, p=4); K9
     ``ml_fwd`` and K10 ``ml_bwd`` (whole block, 12 row qubits, 256 lanes)
     and K11 ``rotx_fwd`` and K12 ``rotx_bwd`` (nkernel=10, r=8192) against
     their plain versions at the path's shapes (K10 and K12 twice, equal bit
     for bit); the start energy of form (a) (``zzrx_layer`` under
     ``ML_MODE="pallas"``), form (b) (``rzz_product`` + ``rx_layer`` under
     ``USE_ROTX``) and form (a) under the default "stack", within 1e-5
     relative; 5 Adam steps (lr 0.05) of each form on the card, the launch
     counts reset just before and read just after each (K9 and K10 once a
     step, K11 and K12 four times), against the same steps on the port's
     CPU path; each step timed (CUDA events) and profiled, each kernel and
     its plain version timed; the switches restored to their defaults;
     K10's plan at 128, 256, 512 and 1024 lanes (each stage kernel's CTAs,
     threads, shared bytes, CTAs an SM, registers, local bytes; a spill
     fails) and each of its stages (the lane pair, dM with its colsum, the
     row stage's two passes and their sums) by device time a layer on the
     form (a) step, beside its bound and one PyTorch call of each product
     (a replayed CUDA graph); K9's plan at the same widths against the
     Python arithmetic and its stages (the zz pass, the other row pass,
     the product) the same way; K9, K11 and K12 alone by a replayed CUDA
     graph; K11's and K12's plans as the card reports them against the
     Python arithmetic, registers and spills, and their passes (K12's with
     its colsum) by device time a launch on the form (b) step beside their
     bounds;
 10. the FUSE_ROWM path, the main path of the row-kron slice: K1 and K3
     with the row kron M7 (stages K13 ``rowm_fwd`` and K14 ``rowm_bwd``,
     rmx=7, a 128x128 complex M7) with and without the lane against their
     plain versions at n=20 (K3 twice, equal bit for bit); 5 SGD steps of
     the n=20, L=4 TFIM step under ``kernels_stack.FUSE_ROWM = True``, the
     launch counts reset just before and read just after (K1, K3, K13 and
     K14 four times a step, K2 and K4 never), against the default card
     path (K2/K4) and the port's CPU path from the same parameters; the
     start point's value and grad under each setting of the stack's
     switches (FUSE_GRAND, FUSE_GRAND_BWD, both, FUSE_LANE off, FUSE_ROWM
     on) with the launches each gives; K1/K3 with M7 timed with their
     bounds, the step timed under each setting and profiled stage by
     stage under FUSE_ROWM; the switches restored to their defaults; the
     stages' plan at R=128 (tile, grid, shared bytes, CTAs an SM,
     registers, spills: none allowed) and each stage (K13, K14a, K14b with
     its colsum) by device time a launch on the step, its bound and one
     PyTorch call that computes the same product at the same shapes; K1
     with M7 by stage: its plan at rmx=7 against ``zzrx_fwd_plan``, and its
     zz pass (3 walked bits, the only pass), K13, the transpose and the
     product by device time a launch on the step beside their bounds;
 11. the staged micro-benchmark of K2's design (``examples/
     micro_grand_fusion.py`` ``run_micro``): K15 ``micro_grand`` at m1, m2
     and m3 against its plain version on the example's n=20, L=4 inputs
     (twice, equal bit for bit); its plan at each level as the card
     reports it against ``micro_grand_plan``, nvcc's registers and spills
     of its kernels (a spill fails); each level timed by
     ``kernels_micro.run_micro`` (250 back-to-back calls, its launches
     read, the counts reset just before) and by a replayed CUDA graph,
     with its bound; each stage (the gate build, the transpose, the two
     row passes, the product, the outer pass, told apart by name and by
     their order in each complete call; m1's copy) by device time a launch
     beside its bound; ``torch.matmul`` of the product and
     ``copy_`` of m1's planes as library calls; then the CPU references
     of phases 14, 15 (c), 16 and 17 start in a child process that sees
     no card (``python3 chip_smoke.py --references DIR``, 4 threads, in
     that order), after every kernel's
     and step's timing; K1 by events and the TFIM training step are timed
     before it starts and again after phase 13, beside it;
 12. the circuit API at full width (no kernel of its own), on the n=20,
     L=4 TFIM circuit of the training path (:func:`tfim_circuit`) and the
     HEA circuit of phase 8 (:func:`hea_circuit`), each check against the
     port's CPU path on the same inputs: (a) the Loschmidt echo
     (:func:`loschmidt_echo`; the inverse's 176 plain gates launch no
     kernel, the forward part K2), |<0...0|e>|^2 within 1e-4 of 1;
     (b) ``initial_mapping`` under q -> n-1-q (:func:`remapped_tfim_energy`;
     K2/K4) and ``compose`` of the HEA circuit onto a permuted register
     (:func:`composed_hea_energy`; K6/K7), energy and gradient against the
     unmapped circuit's; (c) the TFIM Hamiltonian as 39 Pauli strings
     (:func:`tfim_pauli_strings`) through ``expectation_structures`` against
     ``expectation_zzx_energy``, and ``ps=`` strings with y terms against
     the x/y/z lists and the dense route; (d) the light cone of <Z_w Z_w+1>
     against the dense expectation (K6 a layer, on the TFIM circuit K1 a
     layer); (e) ``matrix()`` of the HEA circuit at n=12: unitarity, its
     first column against ``state()``; (f) ``outcome_probability``,
     ``projected_subsystem``, the free ``expectation`` and ``is_valid``;
     then each route timed (CUDA events, median of 20, busy time under
     torch.profiler) beside the path it stands against, with the launches
     each route gave;
 13. sampling at full width (no kernel of its own) on the same TFIM
     circuit, each route also on the port's CPU path with the same status:
     (a) ``sample(8192, allow_state=True)`` in its six formats and the
     legacy list (they agree and sum to 8192), each index within 1e-4 of
     its float64 cdf interval (:func:`bracket_miss`), a chi-square over 64
     equal-mass groups within 5 sigma; (b) 1024 trajectories
     (``allow_state=False``, a [1024, 20] status): each probability against
     |amplitude|^2, each step's bracket (:func:`trajectory_bracket_miss`),
     the peak memory above the state under 64 MB; (c) ``readout_error``
     on route (a) against the CPU path; (d) ``sample_expectation_ps`` of
     <Z_0 Z_1> and <X_5>, exact against ``expectation_ps`` and from 8192
     shots within 5 sigma; (e) a feed-forward circuit
     (``cond_measurement``, ``conditional_gate``, ``cond_measurement``):
     the outcomes and the final state against the CPU path, one K2 launch
     in all (the three ``state()`` computations extend the kept prefix
     state); then each route timed as in phase 12;
 14. noise at full width (no kernel of its own), each case also on the
     port's CPU path with the same statuses (computed by the child
     process, :func:`_noise_reference`): (a) a noisy TFIM VQE step at
     n=20, L=4 (a depolarizing channel of 0.005 a Pauli after each
     ``zzrx_layer``: 80 sites; 32 trajectories, value and gradient one
     trajectory at a time, then an SGD update), the branches equal on the
     two devices, |dE| and max |dgrad| within 1e-4, K1 4 x 32 times in the
     forward, K3 4 x 32 in the backward, K2/K4 never, the peak memory above
     the start; (b) a noisy HEA energy (amplitude damping 0.02 after each
     CNOT, on each leg: 152 ``general_kraus`` sites; 8 trajectories): each
     branch within 1e-5 of its float64 cdf interval, the energies within
     1e-4 where the branches agree, K6 launched a trajectory as often as a
     noiseless ``state()``; (c) ``expectation_ps(noise_conf=)`` against the
     CPU path within 1e-4, and ``sample_expectation_ps(noise_conf=)`` with a
     readout error within 3 sigma of the exact value of the same
     trajectories; (d) the exact oracle at n=10: the ``DMCircuit`` of the
     noisy TFIM against the CPU path within 1e-5, its trace 1 and its purity
     below 1, and the mean of 512 trajectories of <Z_0 Z_1> and of the
     energy within 4 sigma + 1e-3 of it; then each route timed as in
     phase 12;
 15. the contraction engine at full width (no kernel of its own: each
     pairwise step a ``torch.einsum``): (a) the 5x6 grid random circuit at
     depth 12 (n=30), ``amplitude_before`` planned under "auto" (the
     TreeSA escalation builds the native library with g++), contracted
     whole (largest intermediate 2^27) and over ``choose_slices(ir, 2^26)``,
     each against the dense state's amplitude on the card and a complex128
     contraction, the complex128 sliced and whole sums against each other;
     (b) the 7x7 grid at depth 8 (n=49) past the dense cliff: ``amplitude``
     and ``expectation`` of Z_24 with their gradients in the angles (a
     tensor that needs a grad) against the CPU path; (c) sampling past 2^30
     amplitudes: 64 shots of a 40-qubit GHZ state (all-zero or all-one
     strings) and 8 shots of the n=40 depth-6 brickwork with a status and a
     readout error, bit for bit against the CPU path; (d) ``DMCircuit2`` at
     n=24, depth 4 (depolarizing 0.01 after each CNOT): ``expectation``,
     ``probability`` of three wires, ``measure_jit`` of four and
     ``amplitude`` against the CPU path, and at n=10 its einsum route
     against the dense ``DMCircuit``; the CPU path's brickwork shots come
     from the child process; then each route
     timed (the dense state and the brickwork shots once, inside the
     checks, by events alone) with its busy time and its peak memory above
     the start;
 16. the MPS simulators at full width (no kernel of their own; the card
     truncates by the Gram-eigh SVD, a complex64 chain's SVDs and QRs in
     complex128), each check against the port's CPU path, whose references
     the child process computes: (a) the MPS VQE step of
     ``examples/mps_vqe_truncated.py``'s TFIM ansatz at n=60, chi=64,
     depth 10 (:func:`mps_vqe_circuit`; the energy through 119
     ``expectation_ps`` terms, its gradient in the angles, one SGD step) at
     complex128 and complex64, the energies against the CPU path's
     complex128 exact-SVD run, the gradient against it and against its
     Gram route (tolerances from ``tools/mps_gram_drift.py``); the bond
     dimensions (64 in the middle); (b) the exact regime at n=20,
     depth 4: the MPS energy and gradient against the dense ``Circuit``
     (``h_layer`` + ``zzrx_layer``, K2/K4 launched); (c) 1,024 shots of
     (a)'s evaluated MPS with a status: at complex128 each outcome within
     1e-6 of its float64 cdf interval on the CPU path's chain
     (:func:`mps_bracket_miss`), at complex64 <Z_i Z_i+1> from the shots
     within 5 sigma of ``expectation_ps``; its entropy at bond 30 and rho
     of qubits 29-30; (d) ``dmrg(xxz_mpo(12, 1.0), chi=16, sweeps=6)``
     against the CPU path and the exact ground energy, its tensors fed to
     ``MPSCircuit``, ``FiniteMPS`` and ``Circuit(mps_inputs=)``; (e) the
     QuOperator methods at n=8 (:func:`_qop_values`); then (a)'s value and
     grad, a two-site update on the Gram and on the exact route, the
     shots and the DMRG sweeps timed with busy share and peak memory;
 17. the Hamiltonians and the QI toolbox at full width (no kernel of their
     own), each check against the port's CPU path, whose references the
     child process computes after phase 16's (:func:`_hamiltonian_checks`):
     (a) ``tfim_hamiltonian(20)`` built on the card by
     ``PauliStringSum2COO`` (equal to the CPU path's bit for bit, by
     sha256; its nnz and peak memory) and as ``PauliStringSum2MVP``, the
     ``operator_expectation`` of each on the n=20, L=4 TFIM state and its
     gradient in the angles (K2 forward and K3 a layer backward
     launched: the state's adjoint) against ``expectation_zzx_energy``; (b) the Heisenberg model of the 4x5 grid
     (``templates.graphs.Grid2DCoord(4, 5)``) as COO against
     ``heisenberg_measurements``; (c) ``PauliStringSum2Dense`` of the n=12
     TFIM equal to ``to_dense`` of its COO, their energies on the n=12
     state; (d) the density matrix of qubits 0-9, the entropy, Renyi-2
     entropy and its angle gradient (K3), the mutual information of 0-4
     and 5-9, the negativity and log-negativity with 0-4 transposed, the
     fidelity and trace distance to the state after one SGD step (those
     four on the state's density matrix in complex128), the Gibbs state and free energy of the
     n=10 TFIM, and the stabilizer Renyi entropy of the n=12 state
     (``QI_TOL``, from ``tools/qi_drift.py``); (e) the QAOA ansatz of
     phase 9's graph (n=20, p=4) through ``operator_expectation`` of
     ``ising_hamiltonian`` against ``spin_glass_measurements``; then the
     COO build, the COO's and the product's value and grad, the entropy,
     its gradient and the SRE timed with busy share and peak memory;
 18. the backend's transforms, time evolution and shadows at full width
     (no kernel of their own), each check across devices against the
     port's CPU path, whose references the child process computes after
     phase 17's (:func:`_transform_checks`, :func:`_transform_reference`):
     (a) the n=20, L=4 training step ``backend.jit(backend.value_and_grad
     (energy, argnums=(0, 1)))``, captured as a CUDA graph at its first
     call (K2 and K4 launched in the eager run and in the capture), its 3
     replays equal to the uncaptured step bit for bit and to the CPU path
     within 1e-4; (b) ``jit(vvag(...))`` over 8 seeded restarts (K2/K4
     once a restart), each value and gradient within 1e-5 of its eager
     step, relative, and 1e-4 of the CPU path; (c)
     ``experimental.parameter_shift_grad`` under ``jit`` (2 x 156 shifted
     energies, K2 a shift) against (a)'s autograd gradient; (d) 5 steps of
     ``backend.optimizer(torch.optim.Adam, lr=0.05)`` on (a)'s jitted step
     against the CPU path; (e) the L=4 state evolved to t=0.5 under the
     n=20 TFIM COO by ``krylov_evol`` and ``chebyshev_evol`` in complex128:
     norm, <Z_0>, <X_10> against the CPU path (1e-5) and each other
     (1e-4); (f) 2,048 x 4 shadow snapshots: <Z_0 Z_1>, <X_5> and the
     Renyi-2 entropy of qubits 0-1 within 5 standard errors of the exact
     values; then the captured and uncaptured steps (CUDA events, median
     of 20, and busy time under torch.profiler), vvag, the parameter shift
     and both evolutions (with their peak memory) timed;
 19. the stabilizer simulator, the detectors, qudits and U(1) at full
     width (no kernel of their own; the tableau is host C++ built by g++),
     each check against the port's CPU path, whose references the child
     process computes after phase 18's (:func:`_stab_checks`,
     :func:`_stab_reference`): (a) the distance-3 rotated surface code's
     Z memory (17 qubits, 3 rounds, depolarizing 0.01 after every CNOT on
     both qubits: 144 channel sites) by ``sample_detector`` over 1,024
     shots held as one [1024, 2^17] state (its chunking and peak printed):
     the first 16 shots' detector and observable bits equal to the CPU
     path's on the same statuses (a shot may differ only within 1e-6 of a
     cdf boundary, printed), each rate within 5 sigma of the tableau's
     ``sample_detectors`` of the same program (``depolarize1``) at 4,096
     shots; (b) the distance-5 repetition code (9 qubits, 2 rounds,
     amplitude damping 0.02 on the data between rounds and before the
     readout): ``detector_probabilities_exact`` against the CPU path (1e-5)
     and 8,192 trajectories (5 sigma), and F12's two probes, exact equal to
     trajectories; (c) a random Clifford circuit at n=20, depth 40:
     ``state()`` replayed on the card against the state rebuilt from the
     tableau (|<a|b>| >= 1 - 1e-5), the 1,770 Pauli strings of weight <= 2
     and the 20 stabilizer generators (+-1) on the tableau against the
     dense state, and the native
     ``sample(8192)`` at n=49 against the tableau's <Z_q> (5 sigma);
     (d) ``QuditCircuit`` at d=3, n=12 (4 layers of rx/ry on level pairs,
     a csum chain, rzz): the state, an energy and its gradient against the
     CPU path (1e-5), 8,192 samples against the exact mean level (5
     sigma); (e) ``U1Circuit`` at n=24, k=12 (2,704,156 amplitudes; 4
     brick layers of XY rotations, rz, rzz): <sum Z_i Z_i+1> and its
     gradient against the CPU path (1e-5), 8,192 samples in the sector
     against the exact value (5 sigma), one gate with its maps built and
     cached; each route timed (CUDA events, or the wall clock where
     marked) with its peak memory above the start;
 20. the free-fermion, analog, Pauli-propagation and symbolic simulators
     at full width (:func:`_slice_checks`), each against the port's CPU
     path from the child process;
 21. the parallel engines (no kernel of their own; the sharded engine's
     local steps launch K1/K3 and K6-K8), the sharded engine on one card's
     in-process meshes against the dense engine on the same card
     (:func:`_parallel_checks`): (a) the n=28 TFIM VQE step (h_layer, two
     ring ``zzrx_layer``s, ``expectation_zzx_energy`` and its gradient) on
     4 shards, K1 and K3 launched once a shard a layer, the energy within
     1e-5 relative and the gradient within 2e-4 of ``Circuit(28)``'s;
     (b) a mixed forward at n=30 (a ring layer, a CNOT from top wire 0, rzm,
     multicz, a depolarizing ``unitary_kraus`` on top wire 1) on 4 and 8
     shards: the gathered state, ``amplitude``, a three-wire probability and
     ``expectation_ps`` within 1e-5, 8,192 shots by ``sample_direct`` under
     the bracket rule (1e-6) and ``measure_jit``'s outcomes equal; (c)
     ``term_sharded_expectation`` of the 39 n=20 TFIM strings and
     ``DistributedContractor`` of a 4x4 depth-8 grid's <Z_7> (64 slices) on
     4 shards, values and gradients against the dense ones; (d) the same
     over a one-rank NCCL process group (``initialize_distributed`` with a
     timeout, destroyed at the end), with ``broadcast_py_object`` and a
     one-rank group ``Circuit(mesh=)``; (e) ``ReadoutMit`` on 8,192 card
     shots of a 10-qubit GHZ with a known readout error: the mitigated
     <Z...Z> within 5 sigma of 1; (f) each non-unitary channel kind of F19
     (``amplitudedamping``, ``general_kraus``, ``reset``, ``cond_measure``)
     on a top and a local wire of an n=20 circuit on 4 shards, its branch
     probabilities computed on the shards: the branch equal and the
     gathered state within 1e-5 of the dense card circuit's; each route
     timed with its peak memory;
 22. the circuits' I/O, the compiler and the cloud layer (no kernel of
     their own; host code over the card's states) (:func:`_io_checks`):
     (a) ``bench.py``'s n=20, L=4 TFIM circuit on the card (K2 in
     ``state()``) through ``to_json``/``from_json``, ``to_openqasm``/
     ``from_openqasm`` and ``compiler.simple_compile``, each state within
     1e-4 of the original, and the compiled circuit's energy gradient (K2
     and K4) equal to the original's; (b) the dense dry run of the
     contractor's ``debug_level=2`` with ``contraction_info``: zero and the
     cost line; (c) 8,192 shots of a 10-qubit GHZ from the local cloud
     provider on the card, and ``batch_expectation_ps`` from its counts
     within 5 sigma of the exact values; (d) ``apply_rc(simplify=True)``
     on the GHZ circuit, each twirl's state equal to the GHZ state up to a
     global phase; each part timed by the wall clock.
 23. the ML bridges and ``zx/`` (:func:`_mlzx_checks`; K2/K4 once a step
     in (a)): ``QuantumNet`` on the n=20, L=4 step eager and jitted,
     ``HardwareNet``'s shift gradient, L-BFGS-B, DLPack, the d=3 surface
     code by ``StabilizerTCircuit``, a Clifford+T diagram;
 24. ``applications/`` (:func:`_apps_checks`; no kernel of its own), each
     against the port's CPU path from the child process: (a) VQNHE on the
     n=14 periodic TFIM (a 2 GiB dense H), 20 steps eager and under
     ``backend.jit``, the first 3 energies within 1e-4, every one above
     the exact ground energy; (b) ``QUBO_QAOA`` on a 20-asset portfolio at
     p=3, plain and CVaR 0.1: the angles after 3 steps within 1e-5, 20
     jitted steps lowering the loss, the best of 1,024 shots no worse
     than the start's; (c) ``qaoa_vag`` on a 3-regular 16-node graph and
     the ``DMCircuit`` vag at 8 nodes; (d) ``DQAS_search`` at 8 qubits,
     every sampled architecture equal; (e) MADE n=20 and PixelCNN 16x16
     log-probs (cuDNN's TF32 off), their samplers, NMF's marginals within
     4 sigma; each part timed by events with its peak memory.

Prints the kernels JSON line, then the card's name and power limit, then
``{"ok": true, "device": {...}}`` as the last line.  Needs no network and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N = 20
L = 4
#: the training path's width past the grand path (K3 through _adjoint_chain)
N22 = 22
SEEDS = 5
PAIRS = [(i, i + 1) for i in range(N - 1)]
#: kernel vs plain version, both float32 on the card: relative Frobenius
#: error and max-abs error over max |plain| (sums in another order; the
#: lane matmul sums 128 products)
KERNEL_RTOL = 1e-5
#: energy on the card vs the port's CPU path (E ~ -19, float32 sums over
#: 2^20 amplitudes in another order)
ENERGY_ATOL = 1e-4
#: gradient on the card vs the port's CPU path, max abs over the (L, 2, n)
#: grid (entries up to ~1; each a float32 sum over 2^20 amplitudes a layer)
GRAD_ATOL = 1e-4
#: the training step: SGD rate and number of steps at n=20, L=4
LR = 0.01
STEPS = 5
NORM_ATOL = 1e-5
#: the card's peaks for the bound (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: the TEBD path: bench.py's TEBD workload, 10 trotter steps
TEBD_N, TEBD_CHI, TEBD_STEPS, TEBD_SWEEPS = 60, 64, 10, 10
#: card (float32 K5 Jacobi) vs the port's CPU path in complex128: max |d<Z_i>|
#: over the 60 sites, max |d lambda| at bond 30, and |psi|^2 - 1 (the float32
#: Jacobi with the INV_S_REL floor tracks float64; the complex64 Gram path
#: does not)
TEBD_ATOL = 1e-4
#: K5 vs its plain version, both float32 on the card, per matrix (s_max its
#: largest singular value); the levels quoted are this script's output on
#: an H100:
#: - s within 1e-5 s_max (the same rounds, sums in another order; <= 2.9e-6);
SVD_S_TOL = 1e-5
#: - reconstruction |u diag(s) vh - a|_F / |a|_F <= 1e-4: the algorithm itself,
#:   the plain version, reaches 1.3-2.7e-5 on the random, decaying,
#:   rank-deficient and degenerate batches after 1,270 rounds of float32
#:   rotations, so 1e-5 would fail the plain version too;
SVD_REC_TOL = 1e-4
#: - u columns and vh rows elementwise, where the gap of s_j to its
#:   neighbours (and to 0) exceeds 1e-3 s_max, within 2e-5 s_max / gap_j: a
#:   backward error of 1e-5 s_max on each side moves a singular vector by at
#:   most that over its gap.  Compared after aligning the phase of each pair
#:   (u_j, vh_j), a gauge that the iteration fixes from rounding-level
#:   inputs, so that K5 and its plain version may pick different phases;
SVD_GAP = 1e-3
SVD_VEC_TOL = 2e-5
#: - max |(u^H u - I)_jk| over columns with s > 1e-6 s_max <= 5e-3: about
#:   2e-7 on the thetas and the random batch, but 10 sweeps, the JAX
#:   package's fixed count, leave the degenerate batch (clusters of 32 equal
#:   s) and some decaying matrices unconverged: the plain version itself
#:   stays at 9.2e-4 and 1.2e-4 there.
SVD_ORTH_TOL = 5e-3


def hea_circuit(mod, n, w, **kw):
    """The hardware-efficient ansatz, written against the public ``Circuit``
    API that the port shares with the JAX package (``mod`` is either; the
    CPU tests pass both): h_layer (folded on |0...0>), then for each of the
    L rows of ``w`` (L, 2, n) an ry_layer, a CNOT ladder and an rz_layer,
    and a final h_layer (a constant layer, not folded)."""
    c = mod.Circuit(n, **kw)
    c.h_layer()
    for l in range(w.shape[0]):
        c.ry_layer(w[l, 0])
        for q in range(n - 1):
            c.cnot(q, q + 1)
        c.rz_layer(w[l, 1])
    c.h_layer()
    return c


def hea_energy(mod, n, w, **kw):
    """The HEA VQE energy: :func:`hea_circuit` and the open-chain TFIM
    energy ZZ - X."""
    pairs = [(q, q + 1) for q in range(n - 1)]
    return hea_circuit(mod, n, w, **kw).expectation_zzx_energy(pairs, 1.0, -1.0)


def tfim_circuit(mod, p, n, nl, **kw):
    """The TFIM circuit of the training path (``bench.py``'s), for either
    package: h_layer, then nl zzrx_layers on the open chain with the zz
    angles ``p[l, 0, :n-1]`` and the rx angles ``p[l, 1]``."""
    pairs = [(i, i + 1) for i in range(n - 1)]
    c = mod.Circuit(n, **kw)
    c.h_layer()
    for l in range(nl):
        c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
    return c


def loschmidt_echo(c):
    """``c`` followed by its inverse: |0...0> again, up to rounding."""
    echo = c.copy()
    echo.append(c.inverse())
    return echo


def reversal(n):
    """The qubit mapping q -> n-1-q."""
    return {q: n - 1 - q for q in range(n)}


def remapped_tfim_energy(mod, p, n, nl, mapping, **kw):
    """The open-chain TFIM energy ZZ - X of :func:`tfim_circuit` moved onto
    other wires by ``initial_mapping(mapping)``, with the Hamiltonian's
    pairs mapped the same way: the unmapped energy again."""
    c = tfim_circuit(mod, p, n, nl, **kw).initial_mapping(mapping)
    pairs = [(mapping[i], mapping[i + 1]) for i in range(n - 1)]
    return c.expectation_zzx_energy(pairs, 1.0, -1.0)


def composed_hea_energy(mod, n, w, perm, **kw):
    """The HEA energy of :func:`hea_circuit` composed into an empty circuit
    with its qubit q on wire ``perm[q]``, the Hamiltonian's pairs mapped
    the same way: :func:`hea_energy` again."""
    c = mod.Circuit(n, **kw)
    c.compose(hea_circuit(mod, n, w, **kw), indices=[int(q) for q in perm])
    pairs = [(int(perm[q]), int(perm[q + 1])) for q in range(n - 1)]
    return c.expectation_zzx_energy(pairs, 1.0, -1.0)


def tfim_pauli_strings(n):
    """The open-chain TFIM Hamiltonian ZZ - X as Pauli strings for
    ``expectation_structures``: ``ps`` lists (0/1/2/3 for I/X/Y/Z a qubit),
    n-1 ZZ terms of weight 1 then n X terms of weight -1."""
    structures, weights = [], []
    for i in range(n - 1):
        ps = [0] * n
        ps[i] = ps[i + 1] = 3
        structures.append(ps)
        weights.append(1.0)
    for i in range(n):
        ps = [0] * n
        ps[i] = 1
        structures.append(ps)
        weights.append(-1.0)
    return structures, weights


def qaoa_graph(n, p, seed=7):
    """The weighted MaxCut graph and start parameters of
    ``examples/qaoa_maxcut_fused.py``: vertex i takes ``min(2, n-1-i)``
    partners above it with weights uniform in [0.5, 1.5], then 2p angles
    (γ_1..γ_p, β_1..β_p) uniform in [0.1, 0.5], float32, from the same rng.
    Returns ``(edges [(a, b, w)], params)``."""
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        cand = np.arange(i + 1, n)
        if len(cand):
            for j in rng.choice(cand, size=min(2, len(cand)), replace=False):
                edges.append((i, int(j), float(rng.uniform(0.5, 1.5))))
    return edges, rng.uniform(0.1, 0.5, size=2 * p).astype(np.float32)


def qaoa_energy(mod, arr, n, edges, params, form="zzrx", **kw):
    """The QAOA MaxCut cost Σ w/2 ⟨Z_a Z_b⟩ written against the public
    ``Circuit`` API that the port shares with the JAX package (``mod`` is
    either; ``arr`` makes a float32 array of that framework from numpy):
    h_layer, then for each round r either one ``zzrx_layer(edges, w·γ_r,
    2β_r)`` (``form="zzrx"``) or ``rzz_product(edges, w·γ_r)`` and
    ``rx_layer(2β_r)`` (``form="rzz_rx"``), the same circuit."""
    p = params.shape[0] // 2
    pairs = [(a, b) for a, b, _ in edges]
    w = arr([x for _, _, x in edges])
    ones = arr(np.ones(n))
    c = mod.Circuit(n, **kw)
    c.h_layer()
    for r in range(p):
        if form == "zzrx":
            c.zzrx_layer(pairs, w * params[r], ones * (2.0 * params[p + r]))
        else:
            c.rzz_product(pairs, w * params[r])
            c.rx_layer(ones * (2.0 * params[p + r]))
    return c.expectation_ising_sum(zz_terms=[(a, b, 0.5 * x) for a, b, x in edges])


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _errors(a, b):
    import torch

    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
    return diff, scale, rel


def _time_ms(fn, reps: int = 20, inner: int = 5, warmup: int = 3) -> float:
    """Median over ``reps`` of CUDA-event time per call of ``inner`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def _time_rounds(fn, rounds: int = 3, **kw):
    """(median, min, max) of :func:`_time_ms` over ``rounds`` rounds."""
    ts = [_time_ms(fn, **kw) for _ in range(rounds)]
    return statistics.median(ts), min(ts), max(ts)


#: a plain version is timed over fewer calls (median of 5 single calls a
#: round): it is a yardstick of what the kernel replaces, not a metric
PLAIN_TIMING = {"reps": 5, "inner": 1, "warmup": 1}


def _graph_ms(fn, calls: int = 10):
    """(median, min, max) ms of one call of ``fn`` over 3 rounds of CUDA
    events around the replay of a CUDA graph of ``calls`` calls: device time
    with the host's launch cost taken out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return tuple(t / calls for t in _time_rounds(graph.replay, inner=1))


def _profile(fn, reps: int = 10, cpu: bool = True):
    """(host ms, device-busy ms, [(kernel, ms, launches)]) per call of
    ``fn`` over ``reps`` calls under torch.profiler (host time includes the
    profiler's own cost).  ``cpu=False`` traces the card alone: the same
    kernels, without the host ops' records, which cost the profiler
    seconds on a route of thousands of small ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t) * 1e3 / reps
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    return host, busy, [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps) for e in kernels]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _k1_work(r, npairs, nkernel, lane, rmx=0):
    """(bytes, flops) K1 must move and compute: state planes in and out (and
    the lane planes); zz exponent 2 flops a pair + 6 for the phase, 6 a
    butterfly stage, 8·128 for the complex lane row-matmul, per amplitude.
    With the row kron (rmx > 0, stage K13) its (R, R) planes in, rmx fewer
    butterfly stages and one complex R-deep left product, 8·R."""
    amps = r * 128
    nbytes = 4 * 4 * amps + 4 * (npairs + nkernel + 2 * npairs)
    flops = amps * (2 * npairs + 6 + 6 * (nkernel - rmx))
    if lane:
        nbytes += 2 * 4 * 128 * 128
        flops += amps * 8 * 128
    if rmx:
        nbytes += 2 * 4 * 4**rmx
        flops += amps * 8 * 2**rmx
    return nbytes, flops


def _k3_work(r, npairs, nkernel, lane, rmx=0):
    """(bytes, flops) K3 must move and compute: y and ct in, ds out (and the
    lane planes in, dM out); per amplitude 20 flops a butterfly stage (the
    un-apply, the ct walk, the two dθ sums), 4 a pair + 9 for the zz stage
    (exponent, dzz sum, phase walk) and, with the lane matrix, three complex
    128-deep products (un-lane, ct walk, dM): 3·8·128.  With the row kron
    (stage K14) its planes in and dM7 out, rmx fewer butterfly stages and
    three complex R-deep products (un-apply, ct walk, dM7): 3·8·R."""
    amps = r * 128
    nbytes = 6 * 4 * amps + 4 * (4 * npairs + 2 * (nkernel - rmx))
    flops = amps * (20 * (nkernel - rmx) + 4 * npairs + 9)
    if lane:
        nbytes += 4 * 4 * 128 * 128
        flops += amps * 3 * 8 * 128
    if rmx:
        nbytes += 4 * 4 * 4**rmx
        flops += amps * 3 * 8 * 2**rmx
    return nbytes, flops


def _k4_work(r, npairs, nkernel, nouter, L):
    """(bytes, flops) of K4: L layers of K3 with the lane matrix plus, a
    layer, the outer walk (8·D flops an amplitude) and dθ_outer (4 an outer
    qubit); the L residuals and the seed in, ds out, the outer and lane
    matrices in and the dM planes out."""
    amps = r * 128
    d = 2**nouter
    _, f3 = _k3_work(r, npairs, nkernel, True)
    nbytes = 4 * 4 * amps + L * 2 * 4 * amps
    nbytes += L * (4 * 4 * 128 * 128 + 2 * 4 * d * d + 4 * (4 * npairs + 2 * nkernel + nouter))
    flops = L * (f3 + amps * (8 * d + 4 * nouter))
    return nbytes, flops


def _k2_work(r, npairs, nkernel, nouter, L):
    """(bytes, flops) of K2: the state in and y out, the L residuals out
    and, a layer, the lane and outer planes in; per layer and amplitude
    K1's flops with the lane matrix (:func:`_k1_work`) and the outer
    product, 8·D."""
    amps, d = r * 128, 2**nouter
    _, f1 = _k1_work(r, npairs, nkernel, True)
    nbytes = 4 * 4 * amps + L * 2 * 4 * amps + L * (2 * 4 * 128 * 128 + 2 * 4 * d * d)
    return nbytes, L * (f1 + amps * 8 * d)


def _k2_stage_work(r, npairs, nkernel, nouter):
    """(bytes, flops) of each of K2's stages a layer, by name: the row stage
    (x in, its output out, the layer's angles in; 2 flops a pair + 6 for the
    phase, 6 an rx stage), the product (that output and M in, ks[l] out;
    8·128) and the outer pass (ks[l] and the (D, D) planes in, y out;
    8·D).  L layers of them add up to :func:`_k2_work`'s flops; their bytes
    to it plus what the stages and layers hand each other and the angles."""
    amps, d = r * 128, 2**nouter
    return {
        "row": (16 * amps + 4 * (npairs + nkernel), (2 * npairs + 6 + 6 * nkernel) * amps),
        "product": (16 * amps + 2 * 4 * 128 * 128, 8 * 128 * amps),
        "outer": (16 * amps + 2 * 4 * d * d, 8 * d * amps),
    }


def _k34_stage_work(r, npairs, nkernel, nouter):
    """(bytes, flops) of each stage of K3 with the lane matrix, and of a K4
    layer, by name: the lane pair psi = y @ conj(M)^T and w = ct @ M^T (y
    and ct in, psi and w out, M in; 16·128 flops an amplitude), dM = psiᵀ
    ct (psi and ct in, dM out; 8·128), the row stage (psi and w in, ds out,
    the angles and pair shifts in and the layer's gradients out; 20 flops an
    rx stage, 4 a pair + 9 for the zz stage) and, with nouter > 0 (K4), the
    outer stage (ct and the residual in, w out, the (D, D) planes in and
    dθ_outer out; 8·D flops an amplitude and 4 an outer qubit).  Their flops
    add up to :func:`_k3_work`'s (nouter = 0) and to a layer of
    :func:`_k4_work`'s; their bytes to it plus what the stages hand each
    other."""
    amps, mat = r * 128, 2 * 4 * 128 * 128
    out = {
        "lane pair": (32 * amps + mat, 16 * 128 * amps),
        "dM": (16 * amps + mat, 8 * 128 * amps),
        "row": (24 * amps + 16 * npairs + 8 * nkernel, (20 * nkernel + 4 * npairs + 9) * amps),
    }
    if nouter:
        d = 2**nouter
        out["outer"] = (24 * amps + 2 * 4 * d * d + 4 * nouter, (8 * d + 4 * nouter) * amps)
    return out


#: K4's stages on the TFIM step, by kernel name (csrc/adjoint_stages.cuh
#: and csrc/zzrx_bwd.cu); "+colsum" takes the partials' sum launched
#: right after each
K4_STAGES = {
    "outer+colsum": lambda k: "outer_bwd_kernel" in k,
    "lane pair": lambda k: "wide_nt_kernel<2, true>" in k,
    "dM+colsum": lambda k: "wide_dm_kernel" in k,
    "row hi": lambda k: "ml_row_pass_kernel<false>" in k,
    "row lo+colsum": lambda k: "ml_row_pass_kernel<true>" in k,
    "pair records": lambda k: "ml_pair_records_kernel" in k,
}
#: dM's row chunks measured at n=20 (dm_chunks takes 64 at 128 lanes)
DM_CHUNK_SWEEP = (32, 64, 128)


def _k4_stages(krl, card, stage_us, y, ct, m, pairs22):
    """K3/K4's adjoint stages at the TFIM step's shapes: the plan at n=20
    (and under the row kron, rmx=7) and n=22 as the card reports it, each
    record equal to the Python arithmetic's (``zzrx_bwd_plan``) and without
    local memory; nvcc's registers and spills of every stage kernel in the
    zzrx_bwd and row_layer builds (a spill fails); dM alone at 32, 64 and
    128 row chunks (CUDA events, against psiᵀ ct); each stage's device time
    a layer on the n=20 L=4 step (``stage_us``, from :func:`_stage_times`)
    beside its bound, and one PyTorch call computing each product on the
    same operands (a replayed CUDA graph; never called by the port;
    ``allow_tf32`` is False)."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import _build

    r = y[0].shape[0]
    nkernel, nouter = 10, r.bit_length() - 1 - 10
    npairs = N - 1
    for label, rr, npp, rmx in ((f"n={N}", r, npairs, 0), (f"n={N} rmx=7", r, npairs, 7),
                                (f"n={N22}", 4 * r, len(pairs22), 0)):
        _plan_check(f"K3/K4 at {label}", card, krl.zzrx_bwd_card_plan(rr, nkernel, npp, rmx),
                    krl.zzrx_bwd_plan(rr, nkernel, npp, rmx))
    _ptxas_check("zzrx_bwd", ("wide_nt_kernel", "wide_dm_kernel", "ml_row_pass_kernel", "ml_pair_records_kernel",
                              "colsum_tree_kernel", "outer_bwd_kernel"))
    _ptxas_check("row_layer", ("wide_nt_kernel", "wide_dm_kernel"))
    # dM alone at each chunk count, through the C entry point (the kernels
    # take the rule's count)
    lib = _build.library("zzrx_bwd")
    part = torch.empty(2 * max(DM_CHUNK_SWEEP) * 128 * 128, device=y[0].device)
    dm = torch.empty((2, 128, 128), device=y[0].device)
    want = torch.complex(*y).T @ torch.complex(*ct)

    def dm_at(nc):
        err = lib.tcng_lane_dm(y[0].data_ptr(), y[1].data_ptr(), ct[0].data_ptr(), ct[1].data_ptr(),
                               part.data_ptr(), dm.data_ptr(), r, nc, torch.cuda.current_stream().cuda_stream)
        _build.check("zzrx_bwd", err, f"dM at {nc} chunks")

    nc_rule = krl.zzrx_bwd_plan(r, nkernel, npairs)["dm"]["chunks"]
    for nc in DM_CHUNK_SWEEP:
        dm_at(nc)
        diff, scale, rel = _errors(torch.complex(dm[0], dm[1]), want)
        if rel > KERNEL_RTOL or diff > KERNEL_RTOL * scale:
            _fail(f"dM at {nc} chunks disagrees with psi^T ct: max_abs {diff:.3e}, rel {rel:.3e}")
        t = _time_rounds(lambda nc=nc: dm_at(nc))
        print(f"K3/K4 dM alone at n={N}, {nc} row chunks ({4 * nc} CTAs{', the rule' if nc == nc_rule else ''}; "
              f"with its colsum; CUDA events, median of 3 rounds), {card}: {1e3 * t[0]:.2f} us (min "
              f"{1e3 * t[1]:.2f}, max {1e3 * t[2]:.2f}); max_abs {diff:.2e} from psi^T ct")
    # the products' operands as complex matrices, built outside the timed calls
    yc, cc = torch.complex(*y), torch.complex(*ct)
    mc = torch.complex(*m)
    a2 = torch.stack([yc, cc])
    b2 = torch.stack([mc.conj().T, mc.T]).contiguous()
    psi = yc @ b2[0]
    library = {"lane pair": lambda: torch.matmul(a2, b2), "dM": lambda: torch.matmul(psi.T, cc)}
    with torch.no_grad():
        lib_ms = {k: _graph_ms(f) for k, f in library.items()}
    work = _k34_stage_work(r, npairs, nkernel, nouter)
    rows = {"outer": ["outer+colsum"], "lane pair": ["lane pair"], "dM": ["dM+colsum"],
            "row": ["row hi", "row lo+colsum"]}
    layer = 0.0
    for stage, labels in rows.items():
        us = sum(stage_us[k][0] for k in labels)
        layer += us
        per_step = stage_us[labels[0]][1]
        bound, by = _bound_ms(*work[stage])
        lm = lib_ms.get(stage)
        lib_txt = (f"library call {1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, min "
                   f"{1e3 * lm[1]:.2f}, max {1e3 * lm[2]:.2f})" if lm else "no library call")
        parts = " + ".join(f"{k} {stage_us[k][0]:.2f}" for k in labels)
        print(f"K4 stage {stage} at n={N} L={L}, {card}: {us:.2f} us device a layer ({parts}; torch.profiler "
              f"over 10 training steps, x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / us:.1f} % of it reached; {lib_txt}")
    rec = stage_us["pair records"]
    print(f"K4 a layer at n={N} L={L}, {card}: {layer:.2f} us device (the stages above), plus "
          f"{rec[0]:.2f} us a call for the pair records (x{rec[1]:g} a step)")


#: K1's stages by kernel name (csrc/adjoint_stages.cuh, launched from
#: csrc/zzrx_fwd.cu) on a step that runs no other forward kernel of the
#: header (the n=20 L=3 TFIM step, the FUSE_ROWM step); the transpose of M
#: runs once a call
K1_STAGES = {
    "row zz": lambda k: "fwd_row_pass_kernel<true, false, false>" in k,
    "row hi": lambda k: "fwd_row_pass_kernel<false, false, false>" in k,
    "transpose": lambda k: "transpose_kernel" in k,
    "product": lambda k: "wide_nt_kernel<1, false>" in k,
}
#: K2's stages on the TFIM step: K1's and the outer pass
K2_STAGES = {**K1_STAGES, "outer": lambda k: "outer_fwd_kernel" in k}


def _k2_stages(kg, card, stage_us, x, m, npairs, nkernel, nouter):
    """K2's stages at the TFIM step's shapes: the plan at n=20 L=4 as the
    card reports it, each record equal to ``grand_zzrx_fwd_plan``'s and
    without local memory; nvcc's registers and spills of its stage kernels
    in the zzrx_fwd build (a spill fails); each stage's device time a layer
    on the n=20 L=4 step (``stage_us``, from :func:`_stage_times`) beside
    its bound, and one ``torch.matmul`` of the product's shapes on the
    same operands (a replayed CUDA graph; never called by the port;
    ``allow_tf32`` is False)."""
    import torch

    r = x[0].shape[0]
    _plan_check(f"K2 at n={N} L={L}", card, kg.grand_zzrx_fwd_card_plan(r, nkernel, npairs, L),
                kg.grand_zzrx_fwd_plan(r, nkernel, npairs, L))
    _ptxas_check("zzrx_fwd", ("fwd_row_pass_kernel", "wide_nt_kernel", "outer_fwd_kernel", "transpose_kernel",
                              "ml_pair_records_kernel"))
    xc, mc = torch.complex(*x), torch.complex(*m)
    with torch.no_grad():
        lib_ms = {"product": _graph_ms(lambda: torch.matmul(xc, mc))}
    work = _k2_stage_work(r, npairs, nkernel, nouter)
    rows = {"row": ["row zz", "row hi"], "product": ["product"], "outer": ["outer"]}
    layer = 0.0
    for stage, labels in rows.items():
        us = sum(stage_us[k][0] for k in labels)
        layer += us
        bound, by = _bound_ms(*work[stage])
        lm = lib_ms.get(stage)
        lib_txt = (f"library call torch.matmul {1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, "
                   f"min {1e3 * lm[1]:.2f}, max {1e3 * lm[2]:.2f})" if lm else "no library call")
        parts = " + ".join(f"{k} {stage_us[k][0]:.2f}" for k in labels)
        print(f"K2 stage {stage} at n={N} L={L}, {card}: {us:.2f} us device a layer ({parts}; torch.profiler "
              f"over 10 training steps, x{stage_us[labels[0]][1]:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / us:.1f} % of it reached; {lib_txt}")
    tr = stage_us["transpose"]
    print(f"K2 a layer at n={N} L={L}, {card}: {layer:.2f} us device (the stages above), plus {tr[0]:.2f} us a "
          f"launch for the transpose of M (x{tr[1]:g} a step) and the pair records (in K4's line)")
    return layer


def _k1_stage_work(r, npairs, nkernel, lane, rmx=0):
    """(bytes, flops) of each of K1's stages a launch, by name: "row zz"
    (the zz pass: x in, its output out, the pairs' angles and shifts and
    its bits' angles in; 2 flops a pair + 6 for the phase, 6 an rx bit on
    the low min(6, nkernel - rmx) walked bits), "row hi" (the walked bits
    past 6, in place) where there are two passes, with M7 "K13"
    (:func:`_rowm_stage_work`), and with the lane "transpose" (M in, M^T
    out) and "product" (the row stage's output and M^T in, y out; 8·128).
    Their flops add up to :func:`_k1_work`'s; their bytes to it plus what
    the stages hand each other (the state and M^T), less the rmx angles
    that K13 does not read."""
    amps, mat = r * 128, 2 * 4 * 128 * 128
    nwalk = nkernel - rmx
    lo = min(nwalk, 6)
    hi = nwalk - lo
    out = {"row zz": (16 * amps + 4 * (3 * npairs + lo), (2 * npairs + 6 + 6 * lo) * amps)}
    if hi:
        out["row hi"] = (16 * amps + 4 * hi, 6 * hi * amps)
    if rmx:
        out["K13"] = _rowm_stage_work(r, rmx)["K13"]
    if lane:
        out["transpose"] = (2 * mat, 0)
        out["product"] = (16 * amps + mat, 8 * 128 * amps)
    return out


def _k1_stages(krl, card, stage_us, x, m, npairs, nkernel, rmx, steps):
    """K1 with the lane at the shape of the profiled ``steps`` (the n=20
    L=3 TFIM steps, or the FUSE_ROWM steps with rmx = 7): the plan as the
    card reports it, each record equal to ``zzrx_fwd_plan``'s and without
    local memory; nvcc's registers and spills of its stage kernels in the
    zzrx_fwd build (a spill fails); each stage's device time a call on the
    step (``stage_us``, from :func:`_stage_times`: the zz and the other
    pass are two instances of the pass kernel, told apart by name; the
    transpose runs twice a call) beside its bound, and one ``torch.matmul``
    of the product's shapes on its operands (a replayed CUDA graph; never
    called by the port; ``allow_tf32`` is False)."""
    import torch

    r = x[0].shape[0]
    shape = f"n={N} nkernel={nkernel}" + (f" rmx={rmx}" if rmx else "")
    _plan_check(f"K1 at {shape} with the lane", card, krl.zzrx_fwd_card_plan(r, nkernel, npairs, True, rmx),
                krl.zzrx_fwd_plan(r, nkernel, npairs, True, rmx))
    _ptxas_check("zzrx_fwd", ("fwd_row_pass_kernel", "wide_nt_kernel", "transpose_kernel",
                              "ml_pair_records_kernel"))
    xc, mc = torch.complex(*x), torch.complex(*m)
    with torch.no_grad():
        lib = _graph_ms(lambda: torch.matmul(xc, mc))
    plan = krl.zzrx_fwd_plan(r, nkernel, npairs, True, rmx)
    bits = {"row zz": plan["fwd_row_zz"]["bits"], "row hi": plan["fwd_row_hi"]["bits"]}
    total = 0.0
    for stage, work in _k1_stage_work(r, npairs, nkernel, True, rmx).items():
        us, per_step = stage_us[stage]
        k = 2 if stage == "transpose" else 1  # launches a call: M's two planes
        total += k * us
        bound, by = _bound_ms(*work)
        lib_txt = (f"library call torch.matmul {1e3 * lib[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, "
                   f"min {1e3 * lib[1]:.2f}, max {1e3 * lib[2]:.2f})" if stage == "product" else "no library call")
        walked = f" ({bits[stage]} walked bits)" if stage in bits else ""
        print(f"K1 stage {stage}{walked} at {shape}, {card}: {k * us:.2f} us device a call ({k} x {us:.2f} a launch; "
              f"torch.profiler over 10 {steps}, x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / (k * us):.1f} % of it reached; {lib_txt}")
    bound, by = _bound_ms(*_k1_work(r, npairs, nkernel, True, rmx))
    print(f"K1 a call at {shape} with the lane, {card}: {total:.2f} us device (the stages above, plus the pair "
          f"records in K4's line); bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / total:.1f} % of it reached")


def _rowm_stage_work(r, rmx):
    """(bytes, flops) of each row-kron stage alone, by name: K13 y = M7 x
    (x in, y out, M7 in; 8·R flops an amplitude), K14a x = M7† y and c' =
    M7ᵀ c (y, c in, x, c' out; 16·R), K14b dM7 = Σ c xᵀ (c, x in, dM7 out;
    8·R)."""
    amps, R = r * 128, 2**rmx
    m7 = 2 * 4 * R * R
    return {
        "K13": (16 * amps + m7, 8 * R * amps),
        "K14a": (32 * amps + m7, 16 * R * amps),
        "K14b": (16 * amps + m7, 8 * R * amps),
    }


def _ptxas_report(log: str, needle: str):
    """(registers, spill store bytes, spill load bytes) of each kernel whose
    mangled name holds ``needle``, from nvcc's ``-Xptxas -v`` output."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None or needle not in name:
            continue
        regs, spill = out.get(name, (None, None, None)), re.search(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[name] = (regs[0], int(spill.group(1)), int(spill.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = (int(m.group(1)), regs[1], regs[2])
    return out


def _stage_times(fn, stages, reps: int = 10):
    """(device µs a launch, launches a call) of each stage of ``fn`` under
    torch.profiler tracing the card alone: ``stages`` maps a label to a kernel-name test; a label
    ending in "+colsum" adds the colsum_kernel or colsum_tree_kernel
    launched right after each of its kernels (found in the trace's time
    order).  A stage given as ``(test, k, m)`` is the k-th launch of every
    m adjacent launches that match ``test`` in the trace's time order: the
    passes of one call that share a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the card alone: the kernels' records are the same, and the host ops'
    # records of a step of thousands of small ops cost the profiler tens of
    # seconds (phases 8 and 9)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = [e for e in prof.key_averages() if e.device_type == cuda]
    trace = sorted((e for e in prof.events() if e.device_type == cuda), key=lambda e: e.time_range.start)
    out = {}
    for label, test in stages.items():
        if isinstance(test, tuple):
            test, k, m = test
            idx = [i for i, e in enumerate(trace) if test(e.name)]
            groups = [idx[g:g + m] for g in range(0, len(idx), m)]
            if not idx or any(len(g) != m or g[-1] - g[0] != m - 1 for g in groups):
                _fail(f"stage {label}: the launches of {label} do not come in adjacent groups of {m}")
            us = sum(trace[g[k]].time_range.elapsed_us() for g in groups) / len(groups)
            out[label] = (us, len(groups) / reps)
            continue
        hits = [e for e in by_name if test(e.key)]
        count = sum(e.count for e in hits)
        if count == 0:
            _fail(f"stage {label}: no kernel launched in the profile")
        us = sum(e.self_device_time_total for e in hits) / count
        if label.endswith("+colsum"):
            after = [trace[i + 1] for i, e in enumerate(trace[:-1]) if test(e.name)]
            if not after or any("colsum" not in e.name for e in after):
                _fail(f"{label}: no colsum right after each launch in the trace")
            us += sum(e.time_range.elapsed_us() for e in after) / len(after)
        out[label] = (us, count / reps)
    return out


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _k5_work(b, n, m, sweeps):
    """(bytes, flops) K5 with V must move and compute: A's planes in and out
    and V's planes out; per pair and round 36·m flops on A (16 for the four
    column sums, 20 for the rotation) and 20·n on V."""
    nbytes = 4 * 4 * b * n * m + 2 * 4 * b * n * n
    flops = b * (n // 2) * sweeps * (n - 1) * (36 * m + 20 * n)
    return nbytes, flops


def _svd_batches(rng, b=30, n=128):
    """K5's parity batches beside the path's thetas: (label, (b, m, k)
    complex numpy), spectra that 10 sweeps converge."""

    def g(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    def with_spectrum(s, m, k):
        q1 = np.linalg.qr(g(b, m, k))[0]
        q2 = np.linalg.qr(g(b, k, k))[0]
        return (q1 * s[None, None, :]) @ q2

    return [
        ("random", g(b, n, n)),
        ("decaying", with_spectrum(np.exp(-np.linspace(0, 4, n)), n, n)),
        ("rank-deficient", with_spectrum(
            np.where(np.arange(n) < 21, np.exp(-np.linspace(0, 5, n)), 0.0), n, n)),
        ("degenerate", with_spectrum(np.repeat([1.0, 0.5, 0.25, 0.1], n // 4), n, n)),
        (f"panel {n}x80", with_spectrum(np.exp(-np.linspace(0, 4, 80)), n, 80)),
    ]


def _svd_checks(a, got, want):
    """K5's (u, s, vh) on ``a`` against its plain version's, in complex128:
    (ds / s_max, reconstruction, the plain version's reconstruction, the
    largest |d vector| * gap / s_max over separated columns, how many,
    orthogonality, max |ds|); see the SVD_* tolerances."""
    import torch

    c128 = torch.complex128
    a = a.to(c128)
    u, vh, up, vhp = (x.to(c128) for x in (got[0], got[2], want[0], want[2]))
    s, sp = got[1].double(), want[1].double()
    smax = sp[..., :1]

    def rec(u, s, vh):
        r = u * s[..., None, :].to(c128) @ vh - a
        return (torch.linalg.matrix_norm(r) / torch.linalg.matrix_norm(a)).max().item()

    nxt = torch.cat([sp[..., 1:], torch.zeros_like(smax)], -1)
    prv = torch.cat([torch.full_like(smax, float("inf")), sp[..., :-1]], -1)
    gap = torch.minimum(prv - sp, sp - nxt)
    sep = gap > SVD_GAP * smax
    ph = (up.conj() * u).sum(-2)
    ph = ph / ph.abs().clamp_min(1e-30)  # the gauge phase of each pair
    du = (u * ph.conj()[..., None, :] - up).abs().amax(-2)
    dv = (vh * ph[..., :, None] - vhp).abs().amax(-1)
    vec = torch.where(sep, torch.maximum(du, dv) * gap / smax, torch.zeros_like(du)).max().item()
    keep = s > 1e-6 * s[..., :1]
    eye = torch.eye(u.shape[-1], dtype=c128, device=u.device)
    uhu = (u.conj().transpose(-1, -2) @ u - eye).abs()
    orth = torch.where(keep[..., :, None] & keep[..., None, :], uhu, torch.zeros_like(uhu)).max().item()
    ds = (s - sp).abs()
    return (ds / smax).max().item(), rec(u, s, vh), rec(up, sp, vhp), vec, int(sep.sum()), orth, ds.max().item()


def _mps_norm(eng) -> float:
    """<psi|psi> of a ParallelTEBD state by transfer matrices (the padded
    edge bonds use slot 0 only)."""
    import torch

    ts = eng.to_mps_tensors()
    env = torch.ones((1, 1), dtype=ts[0].dtype, device=ts[0].device)
    for i, t in enumerate(ts):
        t = t[:1] if i == 0 else t
        env = torch.einsum("ab,adc,bde->ce", env, t.conj(), t)
    return env[0, 0].real.item()


def _check_parity(cases, twice=()):
    """Each kernel variant of ``cases`` ({name: [(label, kernel, plain)]})
    against its plain version on the same CUDA inputs, output by output
    (``KERNEL_RTOL``); the kernels named in ``twice`` run twice and must
    agree bit for bit.  Returns the largest max-abs error of each kernel."""
    import torch

    max_err = {}
    with torch.no_grad():
        for kname, variants in cases.items():
            max_err[kname] = 0.0
            for label, kern, plain in variants:
                got = kern()
                again = kern() if kname in twice else got
                torch.cuda.synchronize()
                want = plain()
                if len(got) != len(want):
                    _fail(f"{kname} [{label}] returns {len(got)} outputs, its plain version {len(want)}")
                for i, (a, a2, b) in enumerate(zip(got, again, want)):
                    diff, scale, rel = _errors(a, b)
                    ok = a.shape == b.shape and rel <= KERNEL_RTOL and diff <= KERNEL_RTOL * scale
                    print(f"parity {kname} [{label}] out{i} {tuple(a.shape)}: max_abs {diff:.3e} "
                          f"(max|plain| {scale:.3e}), rel_frob {rel:.3e}, "
                          f"tol {KERNEL_RTOL:g} -> {'ok' if ok else 'FAIL'}")
                    if not ok:
                        _fail(f"{kname} [{label}] disagrees with its plain version")
                    if not torch.equal(a, a2):
                        _fail(f"{kname} [{label}] out{i} differs between two runs")
                    max_err[kname] = max(max_err[kname], diff)
                if kname in twice:
                    print(f"parity {kname} [{label}]: two runs equal bit for bit")
    return max_err


def _row_work(r, nkernel, kind, lane=False):
    """(bytes, flops) of a row kernel: K6 ("fwd") and K8 ("const") read two
    state planes and write two, 14 flops an amplitude a gate (two complex
    products and a sum); K7 ("bwd") reads y and ct and writes ds, 44 flops
    an amplitude a gate (the un-apply, the four dg sums, the ct walk), and
    writes dg; with the lane matrix, its planes in and one complex
    128-deep product an amplitude (K6) or three (K7: un-lane, ct walk, dM)
    with dM out."""
    amps = r * 128
    gates = 2 * 4 * 4 * nkernel
    if kind == "bwd":
        nbytes, flops = 6 * 4 * amps + 2 * gates, 44 * nkernel * amps
    else:
        nbytes, flops = 4 * 4 * amps + gates, 14 * nkernel * amps
    if lane:
        k = 3 if kind == "bwd" else 1
        nbytes += (2 if kind == "bwd" else 1) * 2 * 4 * 128 * 128
        flops += k * 8 * 128 * amps
    return nbytes, flops


def _k7_stage_work(r, nkernel):
    """(bytes, flops) of each stage of K7 with the lane matrix, by name:
    the lane pair and dM as K3's (:func:`_k34_stage_work`), and the row
    stage (psi and w in, ds out, the gates in and dg out; 44 flops an
    amplitude a gate).  Without the lane the row stage is all of K7.  Their
    flops add up to :func:`_row_work`'s; their bytes to it plus what the
    stages hand each other."""
    amps, gates = r * 128, 2 * 4 * 4 * nkernel
    lane = _k34_stage_work(r, 0, nkernel, 0)
    return {"lane pair": lane["lane pair"], "dM": lane["dM"],
            "row": (24 * amps + 2 * gates, 44 * nkernel * amps)}


def _k6_stage_work(r, nkernel, lane=False):
    """(bytes, flops) of each stage of K6 a launch, by name: the row
    stage's "row lo" pass (the low 6 walked bits, launched first: two
    planes in, two out, its gates in; 14 flops an amplitude a bit), "row
    hi" (the walked bits past 6, in place) where there are two passes, and
    with the lane "product" (the row stage's output and M in, y out; one
    complex 128-deep product an amplitude).  Their flops add up to
    :func:`_row_work`'s; their bytes to it plus the planes the stages hand
    each other."""
    amps = r * 128
    lo = min(nkernel, 6)
    hi = nkernel - lo
    out = {"row lo": (16 * amps + 32 * lo, 14 * lo * amps)}
    if hi:
        out["row hi"] = (16 * amps + 32 * hi, 14 * hi * amps)
    if lane:
        out["product"] = (16 * amps + 2 * 4 * 128 * 128, 8 * 128 * amps)
    return out


def _fwd_pass_stages(instance):
    """The two passes of K6, K8 or K11 on a step, by kernel name: both are
    ``fwd_row_pass_kernel<false, GATE, TRANS>`` (csrc/adjoint_stages.cuh),
    the low bits launched first and the high ones right after."""
    test = lambda k: f"fwd_row_pass_kernel<{instance}>" in k  # noqa: E731
    return {"row lo": (test, 0, 2), "row hi": (test, 1, 2)}


#: K6's, K8's and K11's passes on their steps (the gate, the transposed
#: gate and rx)
K6_STAGES = {f"K6 {k}": v for k, v in _fwd_pass_stages("false, true, false").items()}
K8_STAGES = {f"K8 {k}": v for k, v in _fwd_pass_stages("false, true, true").items()}
K11_STAGES = {f"K11 {k}": v for k, v in _fwd_pass_stages("false, false, false").items()}


def _plan_check(name, card, got, want):
    """A stage plan as the card reports it: each record equal to the Python
    arithmetic and without local memory."""
    for stage, p in got.items():
        print(f"{name} plan, {stage}, {card}: {p}")
        if p["local_bytes"] or any(p[k] != v for k, v in want[stage].items()):
            _fail(f"{name} stage {stage}: card plan {p}, Python plan {want[stage]}")


def _ptxas_check(build, needles):
    """nvcc's registers and spills of each kernel of the ``build`` whose
    mangled name holds one of ``needles`` (a spill fails, and so does a
    needle that no kernel's name holds)."""
    from tensorcircuit_ng_tpu_torch.core import _build

    report = {k: v for k, v in _ptxas_report(_build.build_log(build), "").items()
              if any(x in k for x in needles)}
    for m in needles:
        if not any(m in k for k in report):
            _fail(f"no ptxas report of {m} in {build}: {list(report)}")
    for kname, (regs, st, ld) in report.items():
        print(f"ptxas[{build}] ({kname[-60:]}): {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads")
        if regs is None or st or ld:
            _fail(f"{kname} spills or has no register count")


#: the mangled names of K6's, K8's and K11's pass kernels,
#: fwd_row_pass_kernel<false, true, false>, <false, true, true> and
#: <false, false, false>
K6_PASS, K8_PASS, K11_PASS = ("fwd_row_pass_kernelILb0ELb1ELb0E", "fwd_row_pass_kernelILb0ELb1ELb1E",
                              "fwd_row_pass_kernelILb0ELb0ELb0E")


def _k6_k8_plan(krl, card, r, nkernel):
    """K6's stage plan at the HEA shape with and without the lane against
    :func:`kernels_rowlayer.row_fwd_plan` and K8's against
    :func:`kernels_rowlayer.row_bwd_const_plan`, and nvcc's registers and
    spills of their passes and K6's product and transpose in the row_layer
    build."""
    for lane in (False, True):
        _plan_check(f"K6 at n={N} nkernel={nkernel}{' with the lane' if lane else ''}", card,
                    krl.row_fwd_card_plan(r, nkernel, lane), krl.row_fwd_plan(r, nkernel, lane))
    _plan_check(f"K8 at n={N} nkernel={nkernel}", card, krl.row_bwd_const_card_plan(r, nkernel),
                krl.row_bwd_const_plan(r, nkernel))
    _ptxas_check("row_layer", (K6_PASS, K8_PASS, "wide_nt_kernel", "transpose_kernel"))


#: K7's stages on the HEA step, by kernel name (csrc/adjoint_stages.cuh)
K7_STAGES = {
    "row hi": lambda k: "gate_row_pass_kernel<false>" in k,
    "row lo+colsum": lambda k: "gate_row_pass_kernel<true>" in k,
}


def _k7_plan(krl, card, r, nkernel):
    """K7's stage plan at the HEA shape with and without the lane as the
    card reports it, each record equal to :func:`kernels_rowlayer.row_bwd_plan`
    and without local memory, and nvcc's registers and spills of its gate
    passes (a spill fails)."""
    for lane in (False, True):
        _plan_check(f"K7 at n={N} nkernel={nkernel}{' with the lane' if lane else ''}", card,
                    krl.row_bwd_card_plan(r, nkernel, lane), krl.row_bwd_plan(r, nkernel, lane))
    # the two gate passes, gate_row_pass_kernel<false> and <true>
    _ptxas_check("row_layer", ("gate_row_pass_kernelILb0E", "gate_row_pass_kernelILb1E"))


class _SubSteps:
    """Wall-clock seconds of a phase's sub-steps, each from the end of the
    one before (printed by :meth:`report`)."""

    def __init__(self, phase):
        self.phase, self.t, self.steps = phase, time.perf_counter(), []

    def done(self, label):
        now = time.perf_counter()
        self.steps.append((label, now - self.t))
        self.t = now

    def report(self, card):
        for label, sec in self.steps:
            print(f"{self.phase} sub-step, {label}: {sec:.1f} s (wall clock), {card}")


def _hea_phase(tct, krl, dev, card):
    """Phase 8, the HEA path (the main path of the single-qubit-layer
    slice): K6/K7/K8 against their plain versions at the n=20 shapes, 5 SGD
    steps of :func:`hea_energy` at n=20, L=4 on the card against the CPU
    path with the launches of each kernel read, the step timed and
    profiled, each kernel timed at its path shape (K7 also with the lane
    and by a replayed CUDA graph), K6's, K8's (:func:`_k6_k8_plan`) and
    K7's plans (:func:`_k7_plan`) and their row passes a launch on the step
    beside their bound.  Returns the kernels line's entries."""
    import torch

    nrow = N - 7
    nkernel = min(nrow, krl.MAX_KERNEL_QUBITS)
    r = 2**nrow
    rng = np.random.default_rng(17)

    def unitaries(k, dim):
        a = rng.normal(size=(k, dim, dim)) + 1j * rng.normal(size=(k, dim, dim))
        return np.linalg.qr(a)[0]

    def unit_planes():
        z = rng.normal(size=2**N) + 1j * rng.normal(size=2**N)
        return tct.convert.planes(z / np.linalg.norm(z), dev)

    # distinct unitary gates on every kernel qubit and a unitary lane
    # matrix: the backward rebuilds states by un-application
    g = unitaries(nkernel, 2).reshape(nkernel, 4)
    gr, gi = (torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous() for x in (g.real, g.imag))
    m = unitaries(1, 128)[0]
    mr, mi = (torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous() for x in (m.real, m.imag))
    sr, si = unit_planes()
    ctr, cti = unit_planes()
    with torch.no_grad():
        y = krl.row_fwd_plain(gr, gi, sr, si)
        y_lane = krl.row_fwd_plain(gr, gi, sr, si, mr, mi)
    cases = {
        "row_fwd": [
            ("no lane", lambda: krl.row_fwd(gr, gi, sr, si), lambda: krl.row_fwd_plain(gr, gi, sr, si)),
            ("lane", lambda: krl.row_fwd(gr, gi, sr, si, mr, mi),
             lambda: krl.row_fwd_plain(gr, gi, sr, si, mr, mi)),
        ],
        "row_bwd": [
            ("no lane", lambda: krl.row_bwd(gr, gi, *y, ctr, cti),
             lambda: krl.row_bwd_plain(gr, gi, *y, ctr, cti)),
            ("lane", lambda: krl.row_bwd(gr, gi, *y_lane, ctr, cti, mr, mi),
             lambda: krl.row_bwd_plain(gr, gi, *y_lane, ctr, cti, mr, mi)),
        ],
        "row_bwd_const": [
            ("no lane", lambda: krl.row_bwd_const(gr, gi, ctr, cti),
             lambda: krl.row_bwd_const_plain(gr, gi, ctr, cti)),
        ],
    }
    print(f"row-layer parity at n={N}: nkernel={nkernel}, r={r}, distinct unitary gates")
    sub = _SubSteps("phase 8")
    max_err = _check_parity(cases, twice=("row_bwd",))
    sub.done("kernel parity against the plain versions")

    # 5 SGD steps through the public API, on the card and on the CPU
    w0 = np.random.default_rng(42).normal(size=(L, 2, N)) * 0.1
    counters = (krl.row_fwd, krl.row_bwd, krl.row_bwd_const)

    def step(w):
        e = hea_energy(tct, N, w, device=w.device)
        (gw,) = torch.autograd.grad(e, w)
        with torch.no_grad():
            w.sub_(LR * gw)
        return e, gw

    for k in counters:
        k.launches = 0
    w = tct.convert.params(w0, dev).requires_grad_()
    card_steps = [tuple(t.detach().cpu().numpy() for t in step(w)) for _ in range(STEPS)]
    torch.cuda.synchronize()
    sub.done(f"{STEPS} SGD steps on the card")
    launches = {k.__name__: k.launches for k in counters}
    print(f"HEA path launches ({STEPS} steps, n={N} L={L}): {launches}")
    want = {"row_fwd": 2 * L + 1, "row_bwd": 2 * L, "row_bwd_const": 1}
    if any(launches[k] != STEPS * v for k, v in want.items()):
        _fail(f"the HEA path did not launch K6/K7/K8 {want} times a step: {launches}")
    w = tct.convert.params(w0, "cpu").requires_grad_()
    for i in range(STEPS):
        e, gw = (t.detach().numpy() for t in step(w))
        e_card, g_card = card_steps[i]
        de = abs(float(e_card) - float(e))
        dg = float(np.abs(g_card - gw).max())
        print(f"HEA step {i}: E card {float(e_card):.7f} cpu {float(e):.7f} |dE| {de:.2e} (tol {ENERGY_ATOL:g}); "
              f"max|dgrad| {dg:.2e} of max|grad| {float(np.abs(gw).max()):.3e} (tol {GRAD_ATOL:g})")
        if not (np.isfinite(e_card) and np.all(np.isfinite(g_card)) and g_card.shape == (L, 2, N)):
            _fail("HEA step: non-finite or misshapen result")
        if de > ENERGY_ATOL or dg > GRAD_ATOL:
            _fail(f"HEA step {i} on the card disagrees with the CPU path")
    if not card_steps[-1][0] < card_steps[0][0]:
        _fail(f"{STEPS} HEA SGD steps did not lower the energy")
    sub.done(f"{STEPS} SGD steps on the CPU (the reference)")

    # timings: the step, each kernel (the path's variant) and its plain
    # version; K7 also with the lane
    wt = tct.convert.params(w0, dev).requires_grad_()
    step_ms = _time_ms(lambda: step(wt)[0].item(), inner=1)
    sub.done("the step timed by events (20 calls)")
    prof = _profile(lambda: step(wt)[0].item(), cpu=False)
    sub.done("the step profiled (10 calls, the card alone)")
    stage_us = _stage_times(lambda: step(wt)[0].item(), {**K7_STAGES, **K6_STAGES, **K8_STAGES})
    sub.done("the stages by device time (10 calls, the card alone)")
    timed = {k: cases[k][0] for k in cases}  # the path runs no lane variant
    with torch.no_grad():
        times = {k: (_time_rounds(v[1]), _time_rounds(v[2], **PLAIN_TIMING)) for k, v in timed.items()}
        lanes = {k: (_time_rounds(cases[k][1][1]), _time_rounds(cases[k][1][2], **PLAIN_TIMING))
                 for k in ("row_fwd", "row_bwd")}
    sub.done("each kernel and its plain version timed")
    print(f"HEA training step n={N} L={L} (value, grad, SGD update; CUDA events, ends in .item()), "
          f"{card}: {step_ms:.3f} ms (median of 20)")
    host, busy, by_kernel = prof
    print(f"profile HEA step (torch.profiler tracing the card alone, 10 runs), {card}: host {host:.3f} ms under "
          f"the profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; {100 * busy / step_ms:.1f} % "
          f"of the unprofiled {step_ms:.3f} ms), {len(by_kernel)} kernel names")
    for name, ms, count in by_kernel[:14]:
        print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    # the kernels' own device time a launch on the path (the event timing
    # of back-to-back wrapper calls below also holds the wrapper's host time)
    for kname, stage in (("row_fwd", "fwd_row_pass_kernel<false, true, false>"),
                         ("row_bwd", "gate_row_pass_kernel"), ("row_bwd", "colsum_tree_kernel"),
                         ("row_bwd_const", "fwd_row_pass_kernel<false, true, true>")):
        for name, ms, count in by_kernel:
            if stage in name:
                print(f"device time a launch on the HEA step, {kname} {name[:60]}: {1e3 * ms / count:.2f} us "
                      f"(x{count:g}/step)")
    # K6's, K8's and K7's stages: the plan, and each row pass a launch
    # beside its bound (K8's passes move and compute what K6's do)
    _k6_k8_plan(krl, card, r, nkernel)
    work = _k6_stage_work(r, nkernel)
    for kname, stages, plan, kind in (("K6", K6_STAGES, krl.row_fwd_plan(r, nkernel), "fwd"),
                                      ("K8", K8_STAGES, krl.row_bwd_const_plan(r, nkernel), "const")):
        for label in stages:
            us, per_step = stage_us[label]
            stage = label.removeprefix(f"{kname} ")
            bound, by = _bound_ms(*work[stage])
            print(f"{kname} stage {stage} ({plan[stage.replace(' ', '_')]['bits']} walked bits) at n={N} "
                  f"nkernel={nkernel}, {card}: {us:.2f} us device a launch (torch.profiler over 10 HEA steps, "
                  f"x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it "
                  f"reached; no library call")
        k_us = sum(stage_us[k][0] for k in stages)
        bound, by = _bound_ms(*_row_work(r, nkernel, kind))
        print(f"{kname} a launch at n={N} nkernel={nkernel}, {card}: {k_us:.2f} us device (the passes above); bound "
              f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / k_us:.1f} % of it reached")
    _k7_plan(krl, card, r, nkernel)
    plan = krl.row_bwd_plan(r, nkernel)
    work = _k7_stage_work(r, nkernel)
    k7_us = sum(stage_us[k][0] for k in K7_STAGES)
    bound, by = _bound_ms(*work["row"])
    for label in K7_STAGES:
        us, per_step = stage_us[label]
        bits = plan["row_hi" if label == "row hi" else "row_lo"]["bits"]
        print(f"K7 stage {label} ({bits} walked bits) at n={N} nkernel={nkernel}, {card}: {us:.2f} us device a "
              f"launch (torch.profiler over 10 HEA steps, x{per_step:g} a step)")
    print(f"K7 row stage a launch at n={N} nkernel={nkernel}, {card}: {k7_us:.2f} us device (the passes above); "
          f"bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / k7_us:.1f} % of it reached")
    kind = {"row_fwd": "fwd", "row_bwd": "bwd", "row_bwd_const": "const"}
    replaces = {"row_fwd": 296, "row_bwd": 344, "row_bwd_const": 799}
    # each kernel's device time of a call without the host's launch cost
    # (the event timing below of back-to-back wrapper calls is host-bound
    # at this size); K6 also with the lane
    graphs = {("K6", "no lane"): cases["row_fwd"][0][1], ("K6", "lane"): cases["row_fwd"][1][1],
              ("K7", "no lane"): cases["row_bwd"][0][1], ("K8", "no lane"): cases["row_bwd_const"][0][1]}
    with torch.no_grad():
        graphs = {k: _graph_ms(f) for k, f in graphs.items()}
    sub.done("the plans and the replayed CUDA graphs")
    for (kname, label), g in graphs.items():
        print(f"{kname} alone [{label}, n={N} nkernel={nkernel}] by a replayed CUDA graph of 10 calls (median of "
              f"3 rounds), {card}: {1e3 * g[0]:.2f} us (min {1e3 * g[1]:.2f}, max {1e3 * g[2]:.2f})")
    for name, (t, tp) in lanes.items():
        bound, by = _bound_ms(*_row_work(r, nkernel, kind[name], lane=True))
        print(f"kernel {name} [lane, n={N} nkernel={nkernel} r={r}] over 3 rounds, {card}: median {t[0]:.4f} ms "
              f"(min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms (min {tp[1]:.4f}, max "
              f"{tp[2]:.4f}); bound {bound:.4f} ms ({by}); not on the HEA path")
    entries = []
    for name, (t, tp) in times.items():
        bound, by = _bound_ms(*_row_work(r, nkernel, kind[name]))
        print(f"kernel {name} [no lane, n={N} nkernel={nkernel} r={r}] over 3 rounds, {card}: median "
              f"{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms "
              f"(min {tp[1]:.4f}, max {tp[2]:.4f}); bound {bound:.4f} ms ({by}); "
              f"launches {launches[name]} in {STEPS} steps")
        entries.append({
            "name": name, "route": "cuda", "source": "tensorcircuit_ng_tpu_torch/core/csrc/row_layer.cu",
            "replaces": f"tensorcircuit_ng_tpu/core/kernels_rowlayer.py:{replaces[name]}",
            "launches": launches[name], "max_abs_err": max_err[name], "ms": t[0], "plain_ms": tp[0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    sub.report(card)
    return entries


#: QAOA: rounds, Adam rate (``optax.adam(0.05)``'s defaults), and the
#: relative spread allowed between the energies of the two forms and the
#: stack path at the start parameters (one function, float32 sums over 2^20
#: amplitudes taken in three orders)
QAOA_P = 4
QAOA_LR = 0.05
QAOA_FORMS_RTOL = 1e-5


def _ml_work(r, lanes, npairs, nrow, L, kind):
    """(bytes, flops) of K9 ("fwd") or K10 ("bwd") at L layers on the
    (r, lanes) planes.  K9 reads two state planes and writes two, reads the
    angles and the L lane planes; per layer and amplitude 2 flops a pair + 6
    for the phase, 6 an rx stage and 8·lanes for the complex lane product.
    K10 reads y and ct and writes ds, reads the lane planes and writes dM;
    per layer and amplitude three complex lane products (un-lane, ct walk,
    dM), 20 flops an rx stage (un-apply, the two dθ sums, the walk) and 4 a
    pair + 9 for the zz stage (exponent, dzz sum, phase walk and
    un-apply)."""
    amps = r * lanes
    mats = L * 2 * 4 * lanes * lanes
    angles = 4 * L * (npairs + nrow)
    if kind == "fwd":
        return 4 * 4 * amps + mats + angles + 8 * npairs, L * amps * (2 * npairs + 6 + 6 * nrow + 8 * lanes)
    return (6 * 4 * amps + 2 * mats + 2 * angles + 8 * npairs,
            L * amps * (3 * 8 * lanes + 20 * nrow + 4 * npairs + 9))


def _ml_stage_work(r, lanes, npairs, nrow):
    """(bytes, flops) of each of K10's stages a layer, by name: the lane
    pair psi = y @ conj(M)^T and w = ct @ M^T (y, ct and M in, psi and w
    out; 16·lanes flops an amplitude), dM = psiᵀ ct (psi and ct in, dM out;
    8·lanes) and the row stage (psi, w, the angles and the pair shifts in,
    x, ds and the layer's gradients out; 20 flops an rx stage, 4 a pair + 9
    for the zz stage).  Their flops add up to :func:`_ml_work`'s K10 total
    over L layers; their bytes to it plus what the stages hand each other."""
    amps, mat = r * lanes, 2 * 4 * lanes * lanes
    grads = 4 * (npairs + nrow)
    return {
        "lane pair": (32 * amps + mat, 16 * lanes * amps),
        "dM": (16 * amps + mat, 8 * lanes * amps),
        "row": (32 * amps + 2 * grads + 8 * npairs, (20 * nrow + 4 * npairs + 9) * amps),
    }


def _k9_stage_work(r, lanes, npairs, nrow):
    """(bytes, flops) of each of K9's stages a layer, by name: the row
    stage (x in, the row stage's output out, the layer's angles in; 2 flops
    a pair + 6 for the phase, 6 an rx stage) and the product (that output
    and M in, y out; 8·lanes).  L layers of them and the pair shifts read
    once a call add up to :func:`_ml_work`'s K9 flops; their bytes to it
    plus what the stages and layers hand each other."""
    amps = r * lanes
    return {
        "row": (16 * amps + 4 * (npairs + nrow), (2 * npairs + 6 + 6 * nrow) * amps),
        "product": (16 * amps + 2 * 4 * lanes * lanes, 8 * lanes * amps),
    }


#: K9's stages on the form (a) step, by kernel name (csrc/adjoint_stages.cuh,
#: csrc/multilayer.cu)
K9_STAGES = {
    "row zz": lambda k: "fwd_row_pass_kernel<true, false, false>" in k,
    "row hi": lambda k: "fwd_row_pass_kernel<false, false, false>" in k,
    "product": lambda k: "wide_nt_kernel<1, false>" in k,
}


def _rotx_work(r, nkernel, kind):
    """(bytes, flops) of K11 ("fwd": two state planes in, two out, 6 flops
    an amplitude a qubit) or K12 ("bwd": y and ct in, ds and dθ out, 20
    flops an amplitude a qubit: un-apply, the two dθ sums, the walk)."""
    amps = r * 128
    if kind == "fwd":
        return 4 * 4 * amps + 4 * nkernel, 6 * nkernel * amps
    return 6 * 4 * amps + 2 * 4 * nkernel, 20 * nkernel * amps


def _k11_stage_work(r, nkernel):
    """(bytes, flops) of each of K11's passes a launch, by name: "row lo"
    (the low 6 walked bits, launched first: two planes in, two out, its
    angles in; 6 flops an amplitude a bit) and "row hi" (the bits past 6,
    in place) where there are two passes.  Their flops add up to
    :func:`_rotx_work`'s K11 flops; their bytes to it plus the planes the
    first pass hands the second."""
    amps = r * 128
    lo = min(nkernel, 6)
    hi = nkernel - lo
    out = {"row lo": (16 * amps + 4 * lo, 6 * lo * amps)}
    if hi:
        out["row hi"] = (16 * amps + 4 * hi, 6 * hi * amps)
    return out


def _k12_stage_work(r, nkernel):
    """(bytes, flops) of each of K12's stages a launch, by name: the first
    row pass "row hi" (the walked bits past the low 6; y and ct in, psi and
    ct out, its angles in and its dθ partials out; 20 flops an amplitude a
    bit) where there are two passes, the last "row lo" (psi and ct in, ds
    out, the low bits' angles in and partials out) and the partials' sum
    "colsum" (one partial a tile of 2^11 amplitudes and a bit in, dθ out;
    one add each).  Their flops add up to :func:`_rotx_work`'s K12 flops
    plus the colsum's adds; their bytes to it plus the handoffs."""
    amps = r * 128
    ctas = amps // min(amps, 2048)
    lo = min(nkernel, 6)
    hi = nkernel - lo
    out = {}
    if hi:
        out["row hi"] = (32 * amps + 4 * hi + 4 * ctas * hi, 20 * hi * amps)
    out["row lo"] = (24 * amps + 4 * lo + 4 * ctas * lo, 20 * lo * amps)
    out["colsum"] = (4 * ctas * nkernel + 4 * nkernel, ctas * nkernel)
    return out


def _qaoa_phase(tct, krl, dev, card, counters):
    """Phase 9, the QAOA path (the main path of the QAOA slice): K9-K12
    against their plain versions at the path's shapes; the start energy of
    form (a) under ML_MODE="pallas", form (b) under USE_ROTX and form (a)
    under the default "stack"; 5 Adam steps of each form on the card with
    every kernel's launches read, against the same steps on the CPU; the
    steps timed and profiled, each kernel timed at its path shape (K9 also
    by a replayed CUDA graph), K9's and K10's stages (:func:`_ml_stages`).
    The switches are restored afterwards.  Returns the kernels line's
    entries."""
    import torch
    from tensorcircuit_ng_tpu_torch.core import kernels, kernels_multilayer as kml
    from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

    n = N
    edges, params0 = qaoa_graph(n, QAOA_P)
    npairs = len(edges)
    pairs = tuple((a, b) for a, b, _ in edges)
    nrow = min(n - 7, kml.MAX_ML_ROW_QUBITS)
    lanes, r = 2 ** (n - nrow), 2**nrow
    nk = min(n - 7, krl.MAX_KERNEL_QUBITS_ROTX)
    rng = np.random.default_rng(19)

    def unit_planes(width):
        z = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
        return tct.convert.planes(z / np.linalg.norm(z), dev, lanes=width)

    # the path's angles: zz = w·γ_r, rx = 2β_r on every qubit; the lane
    # planes are the transposed rx krons the dispatch builds (unitary)
    p0 = tct.convert.params(params0, dev)
    w = tct.convert.params([x for _, _, x in edges], dev)
    zz = w[None, :] * p0[:QAOA_P, None]
    rx = (2.0 * p0[QAOA_P:, None]).expand(QAOA_P, n).contiguous()
    mr, mi = kst._lane_kron_planes_T(rx[:, nrow:])
    th_row = rx[:, :nrow].contiguous()
    sr, si = unit_planes(lanes)
    ctr, cti = unit_planes(lanes)
    th_k = rx[0, n - 7 - nk:n - 7].contiguous()
    xr, xi = unit_planes(128)
    c2r, c2i = unit_planes(128)
    with torch.no_grad():
        y_ml = kml.ml_fwd_plain(pairs, n, zz, th_row, sr, si, mr, mi)
        y_rx = krl.rotx_fwd_plain(th_k, xr, xi)
    ml = (pairs, n, zz, th_row)
    cases = {
        "ml_fwd": [(f"L={QAOA_P} lanes={lanes}", lambda: kml.ml_fwd(*ml, sr, si, mr, mi),
                    lambda: kml.ml_fwd_plain(*ml, sr, si, mr, mi))],
        "ml_bwd": [(f"L={QAOA_P} lanes={lanes}", lambda: kml.ml_bwd(*ml, *y_ml, ctr, cti, mr, mi),
                    lambda: kml.ml_bwd_plain(*ml, *y_ml, ctr, cti, mr, mi))],
        "rotx_fwd": [(f"nkernel={nk} r={2**(n - 7)}", lambda: krl.rotx_fwd(th_k, xr, xi),
                      lambda: krl.rotx_fwd_plain(th_k, xr, xi))],
        "rotx_bwd": [(f"nkernel={nk} r={2**(n - 7)}", lambda: krl.rotx_bwd(th_k, *y_rx, c2r, c2i),
                      lambda: krl.rotx_bwd_plain(th_k, *y_rx, c2r, c2i))],
    }
    print(f"QAOA kernel parity at n={n}: {npairs} edges, whole-block nrow={nrow}, {lanes} lanes; "
          f"rotx nkernel={nk}")
    sub = _SubSteps("phase 9")
    max_err = _check_parity(cases, twice=("ml_bwd", "rotx_bwd"))
    sub.done("kernel parity against the plain versions")

    forms = {"a": ("zzrx", "pallas", False), "b": ("rzz_rx", "stack", True), "a-stack": ("zzrx", "stack", False)}

    def energy(p, form, device):
        return qaoa_energy(tct, lambda a: tct.convert.params(a, device), n, edges, p, forms[form][0],
                           device=device)

    def use(form):
        kernels.ML_MODE, kernels.USE_ROTX = forms[form][1:]

    def start(device):
        # a copy: on the CPU the tensor would share the numpy start angles,
        # which Adam updates in place
        return tct.convert.params(params0, device).clone().requires_grad_()

    def adam_steps(form, device, steps):
        p = start(device)
        opt = torch.optim.Adam([p], lr=QAOA_LR)
        out = []
        for _ in range(steps):
            e = energy(p, form, device)
            (p.grad,) = torch.autograd.grad(e, p)
            out.append((e.item(), p.grad.cpu().numpy().copy()))
            opt.step()
        return out

    entries, launches = [], {}
    try:
        with torch.no_grad():
            e0 = {}
            for form in forms:
                use(form)
                e0[form] = energy(p0, form, dev).item()
        spread = max(abs(e - e0["a-stack"]) for e in e0.values()) / abs(e0["a-stack"])
        print(f"QAOA n={n} p={QAOA_P} start energy: (a) pallas {e0['a']:.7f}, (b) rotx {e0['b']:.7f}, "
              f"(a) stack {e0['a-stack']:.7f}; relative spread {spread:.2e} (tol {QAOA_FORMS_RTOL:g})")
        if not (np.isfinite(list(e0.values())).all() and spread <= QAOA_FORMS_RTOL):
            _fail("the QAOA forms disagree at the start parameters")

        card_steps = {}
        for form in ("a", "b"):
            use(form)
            for k in counters:
                k.launches = 0
            card_steps[form] = adam_steps(form, dev, STEPS)
            torch.cuda.synchronize()
            launches[form] = {k.__name__: k.launches for k in counters if k.launches}
            print(f"QAOA form ({form}) path launches ({STEPS} Adam steps, n={n} p={QAOA_P}): {launches[form]}")
        sub.done(f"the start energies and {STEPS} Adam steps a form on the card")
        want = {"a": {"ml_fwd": STEPS, "ml_bwd": STEPS},
                "b": {"rotx_fwd": QAOA_P * STEPS, "rotx_bwd": QAOA_P * STEPS}}
        if launches != want:
            _fail(f"the QAOA path did not launch {want}: {launches}")
        for form in ("a", "b"):
            use(form)
            cpu = adam_steps(form, "cpu", STEPS)
            for i, ((e_card, g_card), (e, g)) in enumerate(zip(card_steps[form], cpu)):
                de, dg = abs(e_card - e), float(np.abs(g_card - g).max())
                print(f"QAOA form ({form}) step {i}: E card {e_card:.7f} cpu {e:.7f} |dE| {de:.2e} "
                      f"(tol {ENERGY_ATOL:g}); max|dgrad| {dg:.2e} of max|grad| {float(np.abs(g).max()):.3e} "
                      f"(tol {GRAD_ATOL:g})")
                if not (np.isfinite(e_card) and np.all(np.isfinite(g_card)) and g_card.shape == (2 * QAOA_P,)):
                    _fail("QAOA step: non-finite or misshapen result")
                if de > ENERGY_ATOL or dg > GRAD_ATOL:
                    _fail(f"QAOA form ({form}) step {i} on the card disagrees with the CPU path")
            if not card_steps[form][-1][0] < card_steps[form][0][0]:
                _fail(f"{STEPS} Adam steps of QAOA form ({form}) did not lower the cost")
        sub.done(f"{STEPS} Adam steps a form on the CPU (the reference)")

        # timings: each form's step (value, grad, Adam update), profiled
        step_ms = {}
        for form in ("a", "b"):
            use(form)
            p = start(dev)
            opt = torch.optim.Adam([p], lr=QAOA_LR)

            def step():
                e = energy(p, form, dev)
                (p.grad,) = torch.autograd.grad(e, p)
                opt.step()
                return e.item()

            step_ms[form] = _time_ms(step, inner=1)
            sub.done(f"form ({form})'s step timed by events (20 calls)")
            host, busy, by_kernel = _profile(step, cpu=False)
            sub.done(f"form ({form})'s step profiled (10 calls, the card alone)")
            print(f"QAOA form ({form}) training step n={n} p={QAOA_P} (value, grad, Adam update; CUDA "
                  f"events, ends in .item()), {card}: {step_ms[form]:.3f} ms (median of 20)")
            print(f"profile QAOA form ({form}) step (torch.profiler tracing the card alone, 10 runs), {card}: host "
                  f"{host:.3f} ms under the profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; "
                  f"{100 * busy / step_ms[form]:.1f} % of the unprofiled {step_ms[form]:.3f} ms), "
                  f"{len(by_kernel)} kernel names")
            for name, ms, count in by_kernel[:12]:
                print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
            # the kernels' own device time a launch on the step, stage by stage
            stages = {"a": ("fwd_row_pass_kernel", "transpose_kernel", "wide_nt_kernel<1, false>",
                            "ml_pair_records_kernel", "wide_nt_kernel<2, true>", "wide_dm_kernel", "colsum_kernel",
                            "ml_row_pass_kernel<false>", "ml_row_pass_kernel<true>", "colsum_tree_kernel"),
                      "b": ("fwd_row_pass_kernel<false, false, false>", "ml_row_pass_kernel<false>",
                            "rx_row_pass_kernel", "colsum_tree_kernel")}[form]
            for stage in stages:
                for name, ms, count in by_kernel:
                    if stage in name:
                        print(f"device time a launch on the QAOA form ({form}) step, {name[:60]}: "
                              f"{1e3 * ms / count:.2f} us (x{count:g}/step)")
            if form == "a":
                stage_us = _stage_times(step, {
                    "lane pair": lambda k: "wide_nt_kernel<2, true>" in k,
                    "dM+colsum": lambda k: "wide_dm_kernel" in k,
                    "row hi": lambda k: "ml_row_pass_kernel<false>" in k,
                    "row lo": lambda k: "ml_row_pass_kernel<true>" in k,
                    "row sums": lambda k: "colsum_tree_kernel" in k,
                    **{f"K9 {k}": v for k, v in K9_STAGES.items()},
                })
            else:
                k12_us = _stage_times(step, {**K12_STAGES, **K11_STAGES})
            sub.done(f"form ({form})'s stages by device time (10 calls, the card alone)")
    finally:
        kernels.ML_MODE, kernels.USE_ROTX = "stack", False

    with torch.no_grad():
        times = {k: (_time_rounds(v[0][1]), _time_rounds(v[0][2], **PLAIN_TIMING)) for k, v in cases.items()}
        k9_graph = _graph_ms(cases["ml_fwd"][0][1])
        k11_graph = _graph_ms(cases["rotx_fwd"][0][1])
        k12_graph = _graph_ms(cases["rotx_bwd"][0][1])
    for kname, label, g in (("K9", f"L={QAOA_P} lanes={lanes}", k9_graph), ("K11", f"nkernel={nk}", k11_graph),
                            ("K12", f"nkernel={nk}", k12_graph)):
        print(f"{kname} alone [{label}, n={n}] by a replayed CUDA graph of 10 calls (median of 3 rounds), "
              f"{card}: {1e3 * g[0]:.2f} us (min {1e3 * g[1]:.2f}, max {1e3 * g[2]:.2f})")
    sub.done("each kernel and its plain version timed, the replayed CUDA graphs")
    _ml_stages(kml, card, stage_us, y_ml, (ctr, cti), (mr, mi), npairs, nrow)
    _k11_stages(krl, card, {k: k12_us[k] for k in K11_STAGES}, 2 ** (n - 7), nk)
    _k12_stages(krl, card, {k: k12_us[k] for k in K12_STAGES}, 2 ** (n - 7), nk)
    work = {
        "ml_fwd": _ml_work(r, lanes, npairs, nrow, QAOA_P, "fwd"),
        "ml_bwd": _ml_work(r, lanes, npairs, nrow, QAOA_P, "bwd"),
        "rotx_fwd": _rotx_work(2 ** (n - 7), nk, "fwd"),
        "rotx_bwd": _rotx_work(2 ** (n - 7), nk, "bwd"),
    }
    source = {"ml_fwd": "multilayer", "ml_bwd": "multilayer", "rotx_fwd": "row_layer", "rotx_bwd": "row_layer"}
    replaces = {"ml_fwd": "kernels_multilayer.py:326", "ml_bwd": "kernels_multilayer.py:358",
                "rotx_fwd": "kernels_rowlayer.py:650", "rotx_bwd": "kernels_rowlayer.py:680"}
    for name, (t, tp) in times.items():
        bound, by = _bound_ms(*work[name])
        n_launch = launches["a" if name.startswith("ml") else "b"][name]
        print(f"kernel {name} [{cases[name][0][0]}, n={n}] over 3 rounds, {card}: median {t[0]:.4f} ms "
              f"(min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms (min {tp[1]:.4f}, "
              f"max {tp[2]:.4f}); bound {bound:.4f} ms ({by}); launches {n_launch} in {STEPS} steps")
        entries.append({
            "name": name, "route": "cuda", "source": f"tensorcircuit_ng_tpu_torch/core/csrc/{source[name]}.cu",
            "replaces": f"tensorcircuit_ng_tpu/core/{replaces[name]}", "launches": n_launch,
            "max_abs_err": max_err[name], "ms": t[0], "plain_ms": tp[0], "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    sub.done("the stage plans")
    sub.report(card)
    return entries


#: K12's stages on the form (b) step, by kernel name (csrc/adjoint_stages.cuh)
K12_STAGES = {
    "row hi": lambda k: "ml_row_pass_kernel<false>" in k,
    "row lo": lambda k: "rx_row_pass_kernel" in k,
    "colsum": lambda k: "colsum_tree_kernel" in k,
}


def _k11_stages(krl, card, stage_us, r, nkernel):
    """K11's passes at the QAOA form (b) path's shape: the plan as the card
    reports it against ``rotx_fwd_plan``, nvcc's registers and spills of
    its pass kernel in the row_layer build (a spill fails), and each pass's
    device time a launch on the form (b) step (``stage_us``) beside its
    bound (no one PyTorch call computes a pass)."""
    _plan_check(f"K11 at n={N} nkernel={nkernel}", card, krl.rotx_fwd_card_plan(r, nkernel),
                krl.rotx_fwd_plan(r, nkernel))
    _ptxas_check("row_layer", (K11_PASS,))
    plan = krl.rotx_fwd_plan(r, nkernel)
    work = _k11_stage_work(r, nkernel)
    for label, (us, per_step) in stage_us.items():
        stage = label.removeprefix("K11 ")
        bound, by = _bound_ms(*work[stage])
        print(f"K11 stage {stage} ({plan[stage.replace(' ', '_')]['bits']} walked bits) at n={N} nkernel={nkernel}, "
              f"{card}: {us:.2f} us device a launch (torch.profiler over 10 form (b) steps, x{per_step:g} a "
              f"step); bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it reached; "
              f"no library call")
    total = sum(v[0] for v in stage_us.values())
    bound, by = _bound_ms(*_rotx_work(r, nkernel, "fwd"))
    print(f"K11 a launch at n={N} nkernel={nkernel}, {card}: {total:.2f} us device (the passes above); bound "
          f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / total:.1f} % of it reached")


def _k12_stages(krl, card, stage_us, r, nkernel):
    """K12's passes at the QAOA form (b) path's shape: the plan as the card
    reports it, each record equal to ``rotx_bwd_plan``'s and without local
    memory; nvcc's registers and spills of its passes in the row_layer
    build (a spill fails); each stage's device time a launch on the form
    (b) step (``stage_us``, from :func:`_stage_times`) beside its bound (no
    one PyTorch call computes a stage)."""
    _plan_check(f"K12 at n={N} nkernel={nkernel}", card, krl.rotx_bwd_card_plan(r, nkernel),
                krl.rotx_bwd_plan(r, nkernel))
    _ptxas_check("row_layer", ("ml_row_pass_kernel", "rx_row_pass_kernel", "colsum_tree_kernel"))
    work = _k12_stage_work(r, nkernel)
    total = 0.0
    for stage, (us, per_step) in stage_us.items():
        total += us
        bound, by = _bound_ms(*work[stage])
        print(f"K12 stage {stage} at n={N} nkernel={nkernel}, {card}: {us:.2f} us device a launch (torch.profiler "
              f"over 10 form (b) steps, x{per_step:g} a step); bound {1e3 * bound:.2f} us ({by}), "
              f"{100 * 1e3 * bound / us:.1f} % of it reached; no library call")
    bound, by = _bound_ms(*_rotx_work(r, nkernel, "bwd"))
    print(f"K12 a launch at n={N} nkernel={nkernel}, {card}: {total:.2f} us device (the stages above); bound "
          f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / total:.1f} % of it reached")


#: K9's and K10's widths whose plan phase 9 prints (nrow = 12: n = 19..22)
ML_PLAN_LANES = (128, 256, 512, 1024)


def _ml_stages(kml, card, stage_us, y, ct, m, npairs, nrow):
    """K9's and K10's stages at the QAOA path's shape: the plan at every
    width of ``ML_PLAN_LANES`` (each stage kernel's CTAs, threads, shared
    bytes, CTAs an SM, registers and local bytes; a spill fails; K9's
    records equal to ``ml_fwd_plan``'s), each stage's device time a layer on
    the form (a) step (``stage_us``, from :func:`_stage_times`) beside its
    bound, and one PyTorch call computing each product on the same operands
    (K9's on operands of its shapes; never called by the port;
    ``allow_tf32`` is False)."""
    import torch

    r, lanes = y[0].shape
    for w in ML_PLAN_LANES:
        plan = kml.ml_plan(2**nrow, w, nrow, npairs)
        for stage, p in plan.items():
            print(f"K9/K10 plan at nrow={nrow} lanes={w} (n={nrow + w.bit_length() - 1}), {stage}, {card}: {p}")
            if p["local_bytes"]:
                _fail(f"K9/K10 stage {stage} uses local memory at lanes={w}: {p}")
        for stage, p in kml.ml_fwd_plan(2**nrow, w, nrow, npairs).items():
            if any(plan[stage][k] != v for k, v in p.items()):
                _fail(f"K9 stage {stage} at lanes={w}: card plan {plan[stage]}, Python plan {p}")
    _ptxas_check("multilayer", ("wide_nt_kernel", "wide_dm_kernel", "ml_row_pass_kernel", "ml_pair_records_kernel",
                                "fwd_row_pass_kernel"))
    # the products' operands as complex matrices, built outside the timed calls
    yc, cc = torch.complex(*y), torch.complex(*ct)
    mc = torch.complex(m[0][0], m[1][0])
    a2 = torch.stack([yc, cc])
    b2 = torch.stack([mc.conj().T, mc.T]).contiguous()
    psi = yc @ b2[0]
    # K9's product on operands of its shapes: (r, lanes) @ (lanes, lanes)
    library = {"lane pair": lambda: torch.matmul(a2, b2), "dM": lambda: torch.matmul(psi.T, cc),
               "K9 product": lambda: torch.matmul(yc, mc)}
    with torch.no_grad():
        lib_ms = {k: _graph_ms(f) for k, f in library.items()}
    n = r.bit_length() - 1 + lanes.bit_length() - 1
    for kname, work, rows in (
        ("K10", _ml_stage_work(r, lanes, npairs, nrow),
         {"lane pair": ["lane pair"], "dM": ["dM+colsum"], "row": ["row hi", "row lo", "row sums"]}),
        ("K9", {f"K9 {k}": v for k, v in _k9_stage_work(r, lanes, npairs, nrow).items()},
         {"K9 row": ["K9 row zz", "K9 row hi"], "K9 product": ["K9 product"]}),
    ):
        for stage, labels in rows.items():
            us = sum(stage_us[k][0] for k in labels)
            per_step = stage_us[labels[0]][1]
            bound, by = _bound_ms(*work[stage])
            lm = lib_ms.get(stage)
            lib = (f"library call {1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, min "
                   f"{1e3 * lm[1]:.2f}, max {1e3 * lm[2]:.2f})" if lm else "no library call")
            parts = " + ".join(f"{k} {stage_us[k][0]:.2f}" for k in labels)
            print(f"{kname} stage {stage.removeprefix('K9 ')} at n={n} lanes={lanes}, {card}: {us:.2f} us device "
                  f"a layer ({parts}; torch.profiler over 10 form (a) steps, x{per_step:g} a step); bound "
                  f"{1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it reached; {lib}")


#: the FUSE_ROWM step against the default card path from the same
#: parameters (one function, float32 sums in another order)
ROWM_ATOL = 1e-4
#: the switch settings of the stack (module globals of kernels_stack) and
#: the launches a value-and-grad at n=20, L=4 should give under each
SWITCHES = {
    "default": ({}, {"zzrx_fwd": 0, "grand_zzrx_fwd": 1, "zzrx_bwd": 0, "grand_zzrx_bwd": 1}),
    "FUSE_GRAND=False": ({"FUSE_GRAND": False},
                         {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": 0, "grand_zzrx_bwd": 1}),
    "FUSE_GRAND_BWD=False": ({"FUSE_GRAND_BWD": False},
                             {"zzrx_fwd": 0, "grand_zzrx_fwd": 1, "zzrx_bwd": L, "grand_zzrx_bwd": 0}),
    "both False": ({"FUSE_GRAND": False, "FUSE_GRAND_BWD": False},
                   {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": L, "grand_zzrx_bwd": 0}),
    "FUSE_LANE=False": ({"FUSE_LANE": False},
                        {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": L, "grand_zzrx_bwd": 0}),
    "FUSE_ROWM=True": ({"FUSE_ROWM": True},
                       {"zzrx_fwd": L, "grand_zzrx_fwd": 0, "zzrx_bwd": L, "grand_zzrx_bwd": 0,
                        "rowm_fwd": L, "rowm_bwd": L}),
}


def _tfim_step(tct, p, device, nl=L, n=N):
    """The TFIM value and grad of the training path: h_layer, nl
    zzrx_layers, the open-chain ZZ - X energy."""
    import torch

    pairs = [(i, i + 1) for i in range(n - 1)]
    e = tfim_circuit(tct, p, n, nl, device=device).expectation_zzx_energy(pairs, 1.0, -1.0)
    (g,) = torch.autograd.grad(e, p)
    return e, g


def _rowm_phase(tct, krl, kst, dev, card, counters):
    """Phase 10, the FUSE_ROWM path (the main path of the row-kron slice):
    K1 and K3 with the row kron M7 (stages K13/K14, rmx=7) against their
    plain versions at the path's n=20 shapes (K3 twice, equal bit for bit);
    5 SGD steps of the TFIM step at n=20, L=4 under ``FUSE_ROWM = True``
    against the default card path (K2/K4) and the port's CPU path, with
    every kernel's launches read; the value and grad at the start point
    under each switch setting with its launches; K1/K3 with M7 timed with
    their bounds, the step timed under each setting and profiled under
    FUSE_ROWM, K13/K14 and K1's stages (:func:`_k1_stages`) a launch on
    it.  The switches are restored afterwards.  Returns the kernels line's
    entries."""
    import torch

    nrow, nkernel, nouter, _ = kst._shapes(N)
    rmx = kst._rowm_qubits(nkernel)
    R, r = 2**rmx, 2**nrow
    pairs = tuple(PAIRS)
    rng = np.random.default_rng(23)

    def unit_planes():
        z = rng.normal(size=2**N) + 1j * rng.normal(size=2**N)
        return tct.convert.planes(z / np.linalg.norm(z), dev)

    # the path's operands: unitary rx krons M7 (top rmx kernel bits) and lane
    zz = torch.as_tensor(rng.normal(size=N - 1) * 0.4, dtype=torch.float32, device=dev)
    rx = torch.as_tensor(rng.normal(size=(1, N)) * 0.4, dtype=torch.float32, device=dev)
    th = rx[0, nouter:nrow].contiguous()
    m7r, m7i = (m[0] for m in kst._rx_kron_planes(rx[:, nouter:nouter + rmx]))
    mlr, mli = (m[0] for m in kst._lane_kron_planes_T(rx[:, nrow:]))
    sr, si = unit_planes()
    ctr, cti = unit_planes()
    with torch.no_grad():
        y = krl.zzrx_fwd_plain(pairs, N, zz, th, sr, si, mlr, mli, m7r, m7i)
        y0 = krl.zzrx_fwd_plain(pairs, N, zz, th, sr, si, None, None, m7r, m7i)
    f_lane = (pairs, N, zz, th, sr, si, mlr, mli, m7r, m7i)
    f_bare = (pairs, N, zz, th, sr, si, None, None, m7r, m7i)
    b_lane = (pairs, N, zz, th, *y, ctr, cti, mlr, mli, m7r, m7i)
    b_bare = (pairs, N, zz, th, *y0, ctr, cti, None, None, m7r, m7i)
    cases = {
        "rowm_fwd": [
            ("lane", lambda: krl.rowm_fwd(pairs, N, zz, th, sr, si, m7r, m7i, mlr, mli),
             lambda: krl.zzrx_fwd_plain(*f_lane)),
            ("no lane", lambda: krl.rowm_fwd(pairs, N, zz, th, sr, si, m7r, m7i),
             lambda: krl.zzrx_fwd_plain(*f_bare)),
        ],
        "rowm_bwd": [
            ("lane", lambda: krl.rowm_bwd(pairs, N, zz, th, *y, ctr, cti, m7r, m7i, mlr, mli),
             lambda: krl.zzrx_bwd_plain(*b_lane)),
            ("no lane", lambda: krl.rowm_bwd(pairs, N, zz, th, *y0, ctr, cti, m7r, m7i),
             lambda: krl.zzrx_bwd_plain(*b_bare)),
        ],
    }
    print(f"row-kron parity at n={N}: r={r}, nkernel={nkernel}, rmx={rmx} (M7 {R}x{R}), "
          f"{nkernel - rmx} butterfly bits")
    max_err = _check_parity(cases, twice=("rowm_bwd",))

    defaults = {name: getattr(kst, name) for name in ("FUSE_LANE", "FUSE_ROWM", "FUSE_GRAND", "FUSE_GRAND_BWD")}

    def use(**flags):
        for name, value in {**defaults, **flags}.items():
            setattr(kst, name, value)

    p0 = np.random.default_rng(42).normal(size=(L, 2, N)) * 0.1

    def sgd_steps(device, steps, **flags):
        use(**flags)
        p = tct.convert.params(p0, device).requires_grad_()
        out = []
        for _ in range(steps):
            e, g = _tfim_step(tct, p, device)
            out.append((e.item(), g.cpu().numpy()))
            with torch.no_grad():
                p.sub_(LR * g)
        return out

    entries = []
    try:
        for k in counters:
            k.launches = 0
        rowm_steps = sgd_steps(dev, STEPS, FUSE_ROWM=True)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in counters if k.launches}
        print(f"FUSE_ROWM path launches ({STEPS} SGD steps, n={N} L={L}): {launches}")
        want = {"zzrx_fwd": L * STEPS, "zzrx_bwd": L * STEPS, "rowm_fwd": L * STEPS, "rowm_bwd": L * STEPS}
        if launches != want:
            _fail(f"the FUSE_ROWM path did not launch {want}: {launches}")
        default_steps = sgd_steps(dev, STEPS)
        cpu_steps = sgd_steps("cpu", STEPS, FUSE_ROWM=True)
        for i, ((e, g), (ed, gd), (ec, gc)) in enumerate(zip(rowm_steps, default_steps, cpu_steps)):
            dd, gdd = abs(e - ed), float(np.abs(g - gd).max())
            dc, gdc = abs(e - ec), float(np.abs(g - gc).max())
            print(f"FUSE_ROWM step {i}: E {e:.7f}, default card {ed:.7f} |dE| {dd:.2e} max|dgrad| {gdd:.2e} "
                  f"(tol {ROWM_ATOL:g}); cpu {ec:.7f} |dE| {dc:.2e} max|dgrad| {gdc:.2e} (tol {ENERGY_ATOL:g}, "
                  f"{GRAD_ATOL:g}); max|grad| {float(np.abs(gc).max()):.3e}")
            if not (np.isfinite(e) and np.all(np.isfinite(g)) and g.shape == (L, 2, N)):
                _fail("FUSE_ROWM step: non-finite or misshapen result")
            if dd > ROWM_ATOL or gdd > ROWM_ATOL:
                _fail(f"FUSE_ROWM step {i} disagrees with the default card path")
            if dc > ENERGY_ATOL or gdc > GRAD_ATOL:
                _fail(f"FUSE_ROWM step {i} on the card disagrees with the CPU path")
        if not rowm_steps[-1][0] < rowm_steps[0][0]:
            _fail(f"{STEPS} FUSE_ROWM SGD steps did not lower the energy")

        # the start point under each switch setting, with its launches
        base = None
        for label, (flags, want) in SWITCHES.items():
            for k in counters:
                k.launches = 0
            (e, g), = sgd_steps(dev, 1, **flags)
            torch.cuda.synchronize()
            got = {k.__name__: k.launches for k in counters if k.launches}
            want = {k: v for k, v in want.items() if v}
            base = base or (e, g)
            de, dg = abs(e - base[0]), float(np.abs(g - base[1]).max())
            print(f"switches {label}: E {e:.7f} |dE| {de:.2e} max|dgrad| {dg:.2e} vs default "
                  f"(tol {ROWM_ATOL:g}); launches {got}")
            if got != want:
                _fail(f"switches {label}: launches {got}, expected {want}")
            if de > ROWM_ATOL or dg > ROWM_ATOL:
                _fail(f"switches {label}: value or grad differs from the default")

        # timings: the step under each switch setting (FUSE_ROWM last, then
        # profiled), K1 and K3 with M7 at the path's shape
        pt = tct.convert.params(p0, dev).requires_grad_()

        def step():
            e, g = _tfim_step(tct, pt, "cuda")
            with torch.no_grad():
                pt.sub_(LR * g)
            return e.item()

        for label, (flags, _) in SWITCHES.items():
            use(**flags)
            step_ms = _time_ms(step, inner=1)
            print(f"training step n={N} L={L} under switches {label} (CUDA events, ends in .item()), {card}: "
                  f"{step_ms:.3f} ms (median of 20)")
        host, busy, by_kernel = _profile(step)
        # K1's stages but K13 (its row stage walks nkernel - rmx = 3 bits:
        # one pass), K13 and K14
        k1_stages = {k: K1_STAGES[k] for k in _k1_stage_work(r, len(pairs), nkernel, True, rmx) if k in K1_STAGES}
        stage_us = _stage_times(step, {
            **k1_stages,
            "K13": lambda s: f"rowm_apply_kernel<{R}, false>" in s,
            "K14a": lambda s: f"rowm_apply_kernel<{R}, true>" in s,
            "K14b+colsum": lambda s: f"rowm_dm_kernel<{R}>" in s,
        })
    finally:
        use()
    print(f"FUSE_ROWM training step n={N} L={L} (value, grad, SGD update; CUDA events, ends in .item()), "
          f"{card}: {step_ms:.3f} ms (median of 20)")
    print(f"profile FUSE_ROWM step (torch.profiler, 10 runs), {card}: host {host:.3f} ms under the profiler, "
          f"device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; {100 * busy / step_ms:.1f} % of the "
          f"unprofiled {step_ms:.3f} ms), {len(by_kernel)} kernel names")
    for name, ms, count in by_kernel[:14]:
        print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    for stage in ("fwd_row_pass_kernel<true, false, false>", f"rowm_apply_kernel<{R}, false>", "transpose_kernel",
                  "wide_nt_kernel<1, false>", "ml_pair_records_kernel", "wide_nt_kernel<2, true>", "wide_dm_kernel",
                  f"rowm_apply_kernel<{R}, true>", f"rowm_dm_kernel<{R}>", "ml_row_pass_kernel<true>",
                  "colsum_kernel", "colsum_tree_kernel"):
        for name, ms, count in by_kernel:
            if stage in name:
                print(f"device time a launch on the FUSE_ROWM step, {stage}: {1e3 * ms / count:.2f} us "
                      f"(x{count:g}/step)")
    with torch.no_grad():
        times = {k: (_time_rounds(v[0][1]), _time_rounds(v[0][2], **PLAIN_TIMING)) for k, v in cases.items()}
    _rowm_stages(krl, card, stage_us, y, ctr, cti, m7r, m7i, nkernel, rmx, r)
    _k1_stages(krl, card, stage_us, y, (mlr, mli), len(pairs), nkernel, rmx, "FUSE_ROWM steps")
    work = {"rowm_fwd": _k1_work(r, len(pairs), nkernel, True, rmx),
            "rowm_bwd": _k3_work(r, len(pairs), nkernel, True, rmx)}
    source = {"rowm_fwd": "zzrx_fwd.cu", "rowm_bwd": "zzrx_bwd.cu"}
    replaces = {"rowm_fwd": 966, "rowm_bwd": 979}
    for name, (t, tp) in times.items():
        bound, by = _bound_ms(*work[name])
        print(f"kernel {name} [K{'1' if name == 'rowm_fwd' else '3'} with M7 and the lane, n={N} rmx={rmx}] "
              f"over 3 rounds, {card}: median {t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f}); plain median "
              f"{tp[0]:.4f} ms (min {tp[1]:.4f}, max {tp[2]:.4f}); bound {bound:.4f} ms ({by}); "
              f"launches {launches[name]} in {STEPS} steps")
        entries.append({
            "name": name, "route": "cuda", "source": f"tensorcircuit_ng_tpu_torch/core/csrc/{source[name]}",
            "replaces": f"tensorcircuit_ng_tpu/core/kernels_rowlayer.py:{replaces[name]}",
            "launches": launches[name], "max_abs_err": max_err[name], "ms": t[0], "plain_ms": tp[0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    return entries


def _rowm_stages(krl, card, stage_us, y, ctr, cti, m7r, m7i, nkernel, rmx, r):
    """The row-kron stages at the path's shape: their plan (tile, grid,
    shared bytes, CTAs an SM, registers and spills; a spill at R=128
    fails), each stage's device time a launch on the FUSE_ROWM step
    (``stage_us``, from :func:`_stage_times`), its bound, and one PyTorch
    call computing the same product on operands of the same shapes (the
    port never calls it; ``allow_tf32`` is False)."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import _build

    R = 2**rmx
    plan = krl.rowm_plan(rmx, r)
    for stage, p in (("K13", plan["fwd"]), ("K14a", plan["bwd"]), ("K14b dM7", plan["dm"])):
        print(f"row-kron plan {stage} at R={R}, r={r}, {card}: {p}")
    for lib, needle in (("zzrx_fwd", f"rowm_apply_kernelILi{R}ELb0E"), ("zzrx_bwd", f"rowm_apply_kernelILi{R}ELb1E"),
                        ("zzrx_bwd", f"rowm_dm_kernelILi{R}E")):
        report = _ptxas_report(_build.build_log(lib), needle)
        if len(report) != 1:
            _fail(f"ptxas report of {needle}: {report}")
        (name, (regs, st, ld)), = report.items()
        print(f"ptxas {needle}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
        if regs is None or st or ld:
            _fail(f"{needle} spills or has no register count at R={R}")
    for key in ("fwd", "bwd", "dm"):
        if plan[key]["local_bytes"]:
            _fail(f"row-kron stage {key} uses local memory at R={R}: {plan[key]}")
    for m in range(1, krl.MAX_ROWM_QUBITS + 1):  # every instantiation the stack can take
        p = krl.rowm_plan(m, r)
        print(f"row-kron stages at R={2**m}: " + "; ".join(
            f"{k} {v['registers']} registers, {v['local_bytes']} B local, {v['ctas_per_sm']} CTAs an SM, "
            f"{v['smem']} B shared" for k, v in zip(("K13", "K14a", "K14b"), p.values())))
    # the stages' operands as complex (B, R, C) views, built outside the timed calls
    view = lambda p_r, p_i: torch.reshape(
        krl._rowm_view(torch.complex(p_r, p_i), nkernel, R), (r >> nkernel, R, -1))
    xc = view(*y)
    cc = view(ctr, cti)
    m7 = torch.complex(m7r, m7i)
    a14 = torch.stack([m7.conj().T, m7.T]).unsqueeze(1).contiguous()
    yc = torch.stack([xc, cc])
    library = {
        "K13": lambda: torch.matmul(m7, xc),
        "K14a": lambda: torch.matmul(a14, yc),
        "K14b": lambda: torch.einsum("bic,bjc->ij", cc, xc),
    }
    with torch.no_grad():
        lib_ms = {k: _graph_ms(f) for k, f in library.items()}
    work = _rowm_stage_work(r, rmx)
    for stage in ("K13", "K14a", "K14b"):
        us, per_call = stage_us[stage if stage != "K14b" else "K14b+colsum"]
        bound, by = _bound_ms(*work[stage])
        lm = lib_ms[stage]
        print(f"stage {stage}{' (with its colsum)' if stage == 'K14b' else ''} at n={N} R={R}, {card}: "
              f"{us:.2f} us device a launch (torch.profiler over 10 FUSE_ROWM steps, x{per_call:g} a step); "
              f"bound {1e3 * bound:.2f} us ({by}), {100 * 1e3 * bound / us:.1f} % of it reached; library call "
              f"{1e3 * lm[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, min {1e3 * lm[1]:.2f}, "
              f"max {1e3 * lm[2]:.2f}); {8 * 2**rmx * (2 if stage == 'K14a' else 1)} flops an amplitude")


def _micro_work(level, n, nl):
    """(bytes, flops) of K15 at ``level`` over nl layers: the state planes in
    once and out once (m2/m3 also the lane and outer planes and the angles
    in); per layer and amplitude 6 flops a butterfly (10) and 8·128 for the
    lane product (m2, m3), 8·D for the outer product (m3)."""
    amps = 2**n
    d = 2 ** (n - 17)
    nbytes = 4 * 4 * amps
    if level == 1:
        return nbytes, 0
    nbytes += nl * 4 * (2 * 128 * 128 + 20) + (nl * 2 * 4 * d * d if level == 3 else 0)
    return nbytes, nl * amps * (6 * 10 + 8 * 128 + (8 * d if level == 3 else 0))


def _micro_stage_work(r, nl, d):
    """(bytes, flops) of each of K15's stages a launch, by name: "gates"
    (cs in, the gate planes out), "transpose" (one plane of the L lane
    matrices in and out), the row passes "row lo" (the low 6 row bits:
    two planes in, two out, their gates in; 6 flops an amplitude a bit)
    and "row hi" (the high 4), "product" (the row stage's output and M^T
    in, the output out; 8·128), "outer" (8·D) and "copy" (m1: two planes
    in and out).  Per layer the row passes', product's and outer's flops
    add up to :func:`_micro_work`'s."""
    amps, mat = r * 128, 2 * 4 * 128 * 128
    return {
        "gates": (40 * 10 * nl, 0), "transpose": (mat * nl, 0),
        "row lo": (16 * amps + 32 * 6, 6 * 6 * amps), "row hi": (16 * amps + 32 * 4, 6 * 4 * amps),
        "product": (16 * amps + mat, 8 * 128 * amps), "outer": (16 * amps + 8 * d * d, 8 * d * amps),
        "copy": (16 * amps, 0),
    }


#: K15's kernels by name (csrc/micro_grand.cu on csrc/adjoint_stages.cuh):
#: the gate build, the transpose, K6's row pass, the product, K2's outer
#: pass and m1's copy
MICRO_KERNELS = {
    "gates": lambda k: "micro_gates_kernel" in k,
    "transpose": lambda k: "transpose_kernel" in k,
    "row": lambda k: "fwd_row_pass_kernel<false, true, false>" in k,
    "product": lambda k: "wide_nt_kernel<1, false>" in k,
    "outer": lambda k: "outer_fwd_kernel" in k,
    "copy": lambda k: "copy_kernel" in k,
}


def _micro_call_stages(trace, level, nl):
    """K15's stages at m2 or m3 from a trace of (kernel name, µs) in time
    order: the trace split into calls at each gate build, and each
    complete call (the gate build, the transpose twice, then a layer: the
    row passes, low then high, the product and, at m3, the outer pass)
    read in launch order; a call the profiler recorded only in part is
    left out.  Returns ({stage: [µs of each launch]}, complete calls)."""
    kinds = [next((k for k, t in MICRO_KERNELS.items() if t(name)), None) for name, _ in trace]
    labels = ["gates", "transpose", "transpose"] + (["row lo", "row hi", "product"]
                                                     + (["outer"] if level == 3 else [])) * nl
    want = [lab.split()[0] for lab in labels]
    out = {lab: [] for lab in labels}
    calls = 0
    for i, kind in enumerate(kinds):
        if kind != "gates" or kinds[i:i + len(labels)] != want:
            continue
        calls += 1
        for lab, (_, us) in zip(labels, trace[i:i + len(labels)]):
            out[lab].append(us)
    return out, calls


#: profiler windows of 20 calls that phase 11 may read for K15's stages:
#: the profiler can drop the tail of a window's launches (every kind short
#: of its due, the calls recorded whole up to there; ``tools/micro_trace.py``)
MICRO_WINDOWS = 3


def _micro_stage_times(fn, level, nl, reps: int = 20):
    """(device µs a launch, launches read) of each of K15's stages at m2 or
    m3 from the complete calls of :func:`_micro_call_stages` in one window
    of ``reps`` calls of ``fn`` under torch.profiler, the first of up to
    ``MICRO_WINDOWS`` windows with at least half of its calls complete.
    Each window prints its share of complete calls.  A window whose trace
    holds every launch of its calls but not every call complete fails at
    once: the trace was split wrongly, not cut."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    want = ["gates", "transpose", "transpose"] + (["row", "row", "product"] + (["outer"] if level == 3 else [])) * nl
    due = {k: reps * v for k, v in collections.Counter(want).items()}
    for window in range(1, MICRO_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        trace = sorted((e for e in prof.events() if e.device_type == cuda), key=lambda e: e.time_range.start)
        pairs = [(e.name, e.time_range.elapsed_us()) for e in trace]
        stages, calls = _micro_call_stages(pairs, level, nl)
        seen = collections.Counter(next((k for k, t in MICRO_KERNELS.items() if t(name)), None) for name, _ in pairs)
        short = {k: f"{seen[k]} of {v}" for k, v in due.items() if seen[k] < v}
        print(f"K15 m{level} stage window {window}: {calls} of {reps} calls ({100 * calls / reps:.0f} %) complete in "
              f"the profiler's trace; launches missing from it: {short or 'none'}")
        if calls < reps and not short:
            _fail(f"K15 m{level}: every launch in the trace, yet {reps - calls} of {reps} calls not read whole")
        if 2 * calls >= reps:
            return {lab: (sum(v) / len(v), len(v)) for lab, v in stages.items()}
    _fail(f"K15 m{level}: no window of {MICRO_WINDOWS} with half of its {reps} calls complete in the profiler's trace")


def _micro_phase(tct, dev, card):
    """Phase 11, the staged micro-benchmark of K2's design: K15 at m1, m2
    and m3 against its plain version on the example's n=20, L=4 inputs
    (twice, equal bit for bit); its plan at each level as the card reports
    it against ``micro_grand_plan`` and nvcc's registers and spills of its
    kernels; each level timed by ``run_micro`` (250 back-to-back calls,
    its launches read) and by a replayed CUDA graph beside its bound; each
    stage by device time a launch (torch.profiler) beside its bound; the
    library calls of its work, never called by the port: ``torch.matmul``
    of a layer's complex product and ``copy_`` of the two planes L times
    (m1's function).  Returns the kernels line's entry (the m3 level, the
    whole skeleton; ``library_ms`` the L products by ``torch.matmul``)."""
    import torch
    from tensorcircuit_ng_tpu_torch.core import kernels_micro as km

    args = km.micro_inputs(dev)
    r, nl = args[-1].shape[0], km.L
    d = r // km.RB
    cases = {"micro_grand": [
        (f"m{lv}", lambda lv=lv: km.micro_grand(lv, *args), lambda lv=lv: km.micro_grand_plain(lv, *args))
        for lv in (1, 2, 3)]}
    print(f"micro-benchmark parity at n={km.N}, L={nl}: blocks of {km.RB} rows, random non-unitary inputs")
    max_err = _check_parity(cases, twice=("micro_grand",))
    for lv in (1, 2, 3):
        _plan_check(f"K15 m{lv} at n={km.N} L={nl}", card, km.micro_grand_card_plan(lv, r, nl),
                    km.micro_grand_plan(lv, r, nl))
    _ptxas_check("micro_grand", (K6_PASS, "wide_nt_kernel", "outer_fwd_kernel", "transpose_kernel",
                                 "micro_gates_kernel", "copy_kernel"))
    km.micro_grand.launches = 0
    ms = {lv: km.run_micro(lv) for lv in (1, 2, 3)}
    torch.cuda.synchronize()
    launches = km.micro_grand.launches
    print(f"micro_grand launches in run_micro (3 levels x (1 + 3 x {km.K})): {launches}")
    if launches != 3 * (1 + 3 * km.K):
        _fail(f"run_micro did not launch K15 {3 * (1 + 3 * km.K)} times: {launches}")
    _, mlr, mli, _, _, sr, si = args
    xc = torch.complex(sr, si)
    mcs = [torch.complex(mlr[l], mli[l]) for l in range(nl)]
    bufs = [(torch.empty_like(sr), torch.empty_like(si)) for _ in range(2)]

    def copy_m1():  # m1's function by copy_: the planes to y and a in turn
        xr, xi = sr, si
        for l in range(nl):
            dr, di = bufs[(nl - 1 - l) % 2]
            dr.copy_(xr)
            di.copy_(xi)
            xr, xi = dr, di

    with torch.no_grad():
        graph = {lv: _graph_ms(lambda lv=lv: km.micro_grand(lv, *args)) for lv in (1, 2, 3)}
        plain = {lv: _time_ms(lambda lv=lv: km.micro_grand_plain(lv, *args), **PLAIN_TIMING) for lv in (1, 2, 3)}
        lib = {"product": _graph_ms(lambda: torch.matmul(xc, mcs[0])),
               "products": _graph_ms(lambda: [torch.matmul(xc, m) for m in mcs]), "copy": _graph_ms(copy_m1)}
        copy = _stage_times(lambda: km.micro_grand(1, *args), {"copy": MICRO_KERNELS["copy"]}, reps=20)["copy"]
        stage_us = {1: {"copy": (copy[0], round(20 * copy[1]))},
                    **{lv: _micro_stage_times(lambda lv=lv: km.micro_grand(lv, *args), lv, nl) for lv in (2, 3)}}
    for lv in (1, 2, 3):
        bound, by = _bound_ms(*_micro_work(lv, km.N, nl))
        g = graph[lv]
        print(f"kernel micro_grand m{lv}, {card}: {ms[lv]:.4f} ms a call by events (run_micro: best of 3 x {km.K} "
              f"back-to-back calls, L={nl} layers); {g[0]:.4f} ms by a replayed CUDA graph (10 calls, median of 3 "
              f"rounds, min {g[1]:.4f}, max {g[2]:.4f}); plain {plain[lv]:.4f} ms; bound {bound:.4f} ms ({by}), "
              f"{100 * bound / g[0]:.1f} % of it reached by graph")
    work = _micro_stage_work(r, nl, d)
    # launches a call: the gate build once, the transpose once a plane, the
    # rest once a layer
    per_call = {"gates": 1, "transpose": 2}
    for lv in (1, 2, 3):
        total = 0.0
        for stage, (us, read) in stage_us[lv].items():
            k = per_call.get(stage, nl)
            total += us * k
            bound, by = _bound_ms(*work[stage])
            print(f"K15 m{lv} stage {stage} at n={km.N} L={nl}, {card}: {us:.2f} us device a launch (torch.profiler "
                  f"over 20 calls, the mean of {read} launches; x{k} a call); bound {1e3 * bound:.2f} us ({by}), "
                  f"{100 * 1e3 * bound / us:.1f} % of it reached")
        print(f"K15 m{lv} a call at n={km.N} L={nl}, {card}: {total:.2f} us device (the stages above), "
              f"{1e3 * graph[lv][0]:.2f} us by graph")
    for name, what in (("product", "torch.matmul of one layer's complex (8192,128)@(128,128) product"),
                       ("products", f"the {nl} layers' products by torch.matmul"),
                       ("copy", f"m1's function by copy_: the two planes {nl} times")):
        t = lib[name]
        print(f"library call, {what}, {card}: {1e3 * t[0]:.2f} us (CUDA graph of 10 calls, median of 3 rounds, "
              f"min {1e3 * t[1]:.2f}, max {1e3 * t[2]:.2f})")
    print(f"K15 m1 by graph against copy_ of the planes, {card}: {1e3 * graph[1][0]:.2f} us against "
          f"{1e3 * lib['copy'][0]:.2f} us ({100 * (graph[1][0] / lib['copy'][0] - 1):+.1f} %)")
    bound, by = _bound_ms(*_micro_work(3, km.N, nl))
    return [{
        "name": "micro_grand", "route": "cuda", "source": "tensorcircuit_ng_tpu_torch/core/csrc/micro_grand.cu",
        "replaces": "examples/micro_grand_fusion.py:132", "launches": launches,
        "max_abs_err": max_err["micro_grand"], "ms": ms[3], "plain_ms": plain[3], "bound_ms": bound,
        "bound_by": by, "library_ms": lib["products"][0],
    }]


#: phase 12, the circuit API at full width (n=20, L=4; matrix() at n=12):
#: the echo's |<0...0|e>|^2 within 1e-4 of 1 and the echo state against the
#: CPU path within 1e-5 (amplitudes <= 1, 176 dense float32 gates);
ECHO_FID_TOL = 1e-4
STATE_ATOL = 1e-5
#: the remapped energies and gradients against the unmapped ones and the
#: CPU path, and the 39 Pauli strings and the light cone against the fused
#: and the dense readouts (E ~ -19.6 is 1.9e-6 an ulp in float32; each
#: entry a float32 sum over 2^20 amplitudes in another order);
MAP_E_ATOL = 1e-5
MAP_G_ATOL = 1e-4
#: U U^H - I, U against the CPU path (complex64 rounding over ~170 gate
#: layers on every column) and U[:, 0] against state(); the readouts that
#: pick or slice the same amplitudes (outcome probabilities, subsystems,
#: the free expectation, Pauli strings through two routes)
UNITARY_ATOL = 1e-5
SAME_ATOL = 1e-6
N_UNITARY = 12


#: the measurement tie-break added to each uniform (both packages)
MEASURE_EPS = 0.31415926e-12


def bracket_miss(idx, u, p):
    """How far the uniforms ``u`` of an inverse-CDF sample lie outside the
    intervals of their indices ``idx`` on the float64 cdf of ``p``: the
    largest of cdf[i-1] - u and u - cdf[i] over the shots, so at most 0
    where every index is the float64 one (a float32 cumsum over 2^n entries
    may pick a neighbour within its rounding)."""
    p = np.asarray(p, dtype=np.float64)
    cdf = np.cumsum(p / p.sum())
    idx = np.asarray(idx).astype(np.int64).reshape(-1)
    u = np.asarray(u, dtype=np.float64).reshape(-1)
    lo = np.where(idx > 0, cdf[np.maximum(idx - 1, 0)], 0.0)
    return float(np.max(np.maximum(lo - u, u - cdf[idx])))


def trajectory_bracket_miss(samples, status, p, d=2):
    """:func:`bracket_miss` for each step of the trajectory sampler: at
    step k the uniform ``status[:, k]`` + the tie-break against the float64
    conditional cdf of qudit k given the measured prefix (the block sums of
    ``p``).  Returns the largest miss over shots and steps."""
    p = np.asarray(p, dtype=np.float64)
    samples = np.asarray(samples).astype(np.int64)
    status = np.asarray(status, dtype=np.float64)
    n = samples.shape[1]
    levels = [p]
    for k in range(n - 1, -1, -1):
        levels.append(levels[-1].reshape(d**k, d).sum(axis=1))
    levels = levels[::-1]
    block = np.zeros(samples.shape[0], dtype=np.int64)
    miss = -np.inf
    for k in range(n):
        sums = levels[k + 1][block[:, None] * d + np.arange(d)]
        cdf = np.cumsum(sums / sums.sum(axis=1, keepdims=True), axis=1)
        o = samples[:, k]
        u = status[:, k] + MEASURE_EPS
        lo = np.where(o > 0, cdf[np.arange(len(o)), np.maximum(o - 1, 0)], 0.0)
        miss = max(miss, float(np.max(np.maximum(lo - u, u - cdf[np.arange(len(o)), o]))))
        block = block * d + o
    return miss


def _launched(counters):
    """The counters that moved since the last reset (host-side counts)."""
    return {k.__name__: k.launches for k in counters if k.launches}


def _reset(counters):
    for k in counters:
        k.launches = 0


def _check(label, err, tol):
    print(f"  {label}: {err:.3e} (tol {tol:g})")
    if not err <= tol:
        _fail(f"phase 12, {label}: {err} > {tol}")


def _hea_unitary(tct, n_u, nl, device):
    """Phase 12 (e)'s circuit unitary: :func:`hea_circuit` at n_u with its
    angles from a seed, in full float32."""
    import torch

    wu = np.random.default_rng(12).normal(size=(nl, 2, n_u)) * 0.5
    with torch.no_grad(), tct.config.full_float32():
        hu = hea_circuit(tct, n_u, tct.convert.params(wu, device), device=device)
        return hu, hu.matrix()


def _api_checks(tct, dev, counters, n=N, nl=L, n_u=N_UNITARY):
    """Phase 12's checks (a)-(f) on the n-qubit TFIM circuit of the
    training path and the HEA circuit of phase 8, both on ``dev``, each
    against the port's CPU path on the same inputs (the kernels' launches
    are required only on the card).  Returns what the timings reuse."""
    import torch

    card = torch.device(dev).type == "cuda"
    pairs = [(i, i + 1) for i in range(n - 1)]
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1  # bench.py's parameters
    z, x = np.diag([1.0, -1.0]), np.array([[0.0, 1.0], [1.0, 0.0]])

    def params(a, device, grad=False):
        p = tct.convert.params(a, device)
        return p.requires_grad_() if grad else p

    def need(launches, names, what):
        if card and not all(launches.get(k, 0) for k in names):
            _fail(f"phase 12, {what}: {names} not launched ({launches})")

    spent = {}  # seconds of wall time: each check, and the CPU references in it

    def on_cpu(key, fn):
        t = time.perf_counter()
        out = fn()
        spent[f"CPU {key}"] = spent.get(f"CPU {key}", 0.0) + time.perf_counter() - t
        return out

    last = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        spent[key], last[0] = now - last[0], now

    print(f"circuit API (n={n}, L={nl}):")
    # (a) the Loschmidt echo: the inverse is plain gates, the forward K2
    with torch.no_grad():
        c = tfim_circuit(tct, params(g0, dev), n, nl, device=dev)
        inv = c.inverse()
        if inv.gate_count() != nl * (2 * n - 1) + n:
            _fail(f"phase 12: the inverse has {inv.gate_count()} gates")
        _reset(counters)
        inv.state()
        if _launched(counters):
            _fail(f"phase 12: the inverse launched kernels: {_launched(counters)}")
        _reset(counters)
        echo = loschmidt_echo(c).state()
        echo_launches = _launched(counters)
        need(echo_launches, ["grand_zzrx_fwd"], "the echo")
        fid = abs(echo[0].item()) ** 2
        echo_cpu = on_cpu("(a)", lambda: loschmidt_echo(
            tfim_circuit(tct, params(g0, "cpu"), n, nl, device="cpu")).state())
    print(f"  (a) echo: the inverse has {inv.gate_count()} gates and launched no kernel; the echo "
          f"launched {echo_launches}; |<0|e>|^2 = {fid:.9f}")
    _check("(a) |<0|e>|^2 - 1", abs(fid - 1.0), ECHO_FID_TOL)
    _check("(a) echo state, card against the CPU", (echo.cpu() - echo_cpu).abs().max().item(), STATE_ATOL)
    lap("(a)")

    # (b) remapping: the reversal of the TFIM circuit, the HEA circuit
    # composed onto a permuted register; energy and grad of the same p
    def tfim_vg(device, mapping):
        p = params(g0, device, True)
        if mapping is None:
            e = tfim_circuit(tct, p, n, nl, device=device).expectation_zzx_energy(pairs, 1.0, -1.0)
        else:
            e = remapped_tfim_energy(tct, p, n, nl, mapping, device=device)
        (g,) = torch.autograd.grad(e, p)
        return e.item(), g.cpu().numpy()

    perm = np.random.default_rng(5).permutation(n)

    def hea_vg(device, perm):
        w = params(g0, device, True)
        if perm is None:
            e = hea_energy(tct, n, w, device=device)
        else:
            e = composed_hea_energy(tct, n, w, perm, device=device)
        (g,) = torch.autograd.grad(e, w)
        return e.item(), g.cpu().numpy()

    for label, vg, mapping, names in (
        ("initial_mapping(q -> n-1-q)", tfim_vg, reversal(n), ["grand_zzrx_fwd", "grand_zzrx_bwd"]),
        ("HEA compose onto a permuted register", hea_vg, perm, ["row_fwd", "row_bwd"]),
    ):
        _reset(counters)
        e_m, g_m = vg(dev, mapping)
        launches = _launched(counters)
        need(launches, names, label)
        e_u, g_u = vg(dev, None)
        e_c, g_c = on_cpu("(b)", lambda: vg("cpu", mapping))
        if not (np.isfinite(e_m) and np.all(np.isfinite(g_m)) and g_m.shape == (nl, 2, n)):
            _fail(f"phase 12, {label}: non-finite or misshapen result")
        print(f"  (b) {label}: E {e_m:.7f} (unmapped {e_u:.7f}, CPU {e_c:.7f}); launched {launches}")
        _check("(b) |dE| against the unmapped circuit", abs(e_m - e_u), MAP_E_ATOL)
        _check("(b) max|dgrad| against the unmapped circuit", float(np.abs(g_m - g_u).max()), MAP_G_ATOL)
        _check("(b) |dE| against the CPU", abs(e_m - e_c), MAP_E_ATOL)
        _check("(b) max|dgrad| against the CPU", float(np.abs(g_m - g_c).max()), MAP_G_ATOL)

    lap("(b)")

    # (c) the Hamiltonian as Pauli strings; y strings through three routes
    structures, weights = tfim_pauli_strings(n)
    with torch.no_grad():
        es = c.expectation_structures(structures, weights)
        ez = c.expectation_zzx_energy(pairs, 1.0, -1.0).item()
        print(f"  (c) {len(structures)} Pauli strings: {es.real.item():.7f} (imag {es.imag.item():.1e}); "
              f"fused energy {ez:.7f}")
        _check("(c) expectation_structures against expectation_zzx_energy", abs(es.item() - ez), MAP_E_ATOL)
        paulis = tct.gates.pauli_gates()
        for ps in ([2, 3] + [0] * (n - 3) + [1], [0] * (n // 2) + [2, 2, 3] + [0] * (n - n // 2 - 3)):
            got = c.expectation_ps(ps=ps)
            lists = c.expectation_ps(**{k: [i for i, v in enumerate(ps) if v == code]
                                        for k, code in (("x", 1), ("y", 2), ("z", 3))})
            dense = c.expectation(*[(paulis[v], [i]) for i, v in enumerate(ps) if v])
            _check(f"(c) ps={''.join(map(str, ps))} against x/y/z lists and the dense route",
                   max(abs(got - lists).item(), abs(got - dense).item()), SAME_ATOL)

    lap("(c)")

    # (d) the light cone: items one by one, the zzrx layers through K1
    w_card = params(g0, dev)
    with torch.no_grad():
        hc = hea_circuit(tct, n, w_card, device=dev)
        for label, circuit, names in (("HEA", hc, ["row_fwd"]), ("TFIM", c, ["zzrx_fwd", "row_fwd"])):
            for wire in (0, n // 2):
                obs = ((z, [wire]), (z, [wire + 1]))
                _reset(counters)
                lc = circuit.expectation(*obs, enable_lightcone=True)
                launches = _launched(counters)
                need(launches, names, f"the {label} light cone")
                dense = circuit.expectation(*obs)
                print(f"  (d) {label} <Z_{wire} Z_{wire + 1}> light cone {lc.real.item():.7f}, "
                      f"dense {dense.real.item():.7f}; launched {launches}")
                _check(f"(d) {label} light cone against dense", abs(lc - dense).item(), MAP_E_ATOL)

    lap("(d)")

    # (e) the circuit unitary of the HEA circuit at n_u
    hu, u = _hea_unitary(tct, n_u, nl, dev)
    with torch.no_grad(), tct.config.full_float32():
        eye = torch.eye(2**n_u, dtype=u.dtype, device=u.device)
        defect = (u @ u.conj().T - eye).abs().max().item()
        col = (u[:, 0] - hu.state()).abs().max().item()
        # on the card machine this runs beside the child process, which
        # meanwhile computes phase 14's references (PERF.md, PR 21)
        u_cpu = on_cpu("(e)", lambda: _hea_unitary(tct, n_u, nl, "cpu")[1])
        du = (u.cpu() - u_cpu).abs().max().item()
    print(f"  (e) matrix() n={n_u}: {tuple(u.shape)} {u.dtype} on {u.device}, "
          f"{hu.gate_count()} items, {len(hu._expanded_qir())} gates")
    _check("(e) max|U U^H - I|", defect, UNITARY_ATOL)
    _check("(e) U[:, 0] against state()", col, SAME_ATOL)
    _check("(e) U against the CPU", du, UNITARY_ATOL)

    lap("(e)")

    # (f) subsystems and the free expectation
    rng = np.random.default_rng(3)
    with torch.no_grad():
        psi, probs = c.state(), c.probability()
        bits = rng.integers(0, 2, size=(16, n))
        idx = torch.as_tensor(bits @ (2 ** np.arange(n - 1, -1, -1)), device=psi.device)
        outcome = torch.stack([c.outcome_probability(b.tolist()) for b in bits])
        _check("(f) outcome_probability at 16 bitstrings against probability()",
               (outcome - probs[idx]).abs().max().item(), SAME_ATOL)
        traceout, left = rng.integers(0, 2, size=n), (2, 7, 13 % n)
        sub = c.projected_subsystem(torch.as_tensor(traceout, device=psi.device), left)
        sl = tuple(slice(None) if q in left else int(traceout[q]) for q in range(n))
        want = torch.reshape(torch.reshape(psi, (2,) * n)[sl], (-1,))
        _check(f"(f) projected_subsystem{left} against the sliced state",
               (sub - want / torch.linalg.vector_norm(want)).abs().max().item(), SAME_ATOL)
        ops = [(z, [3]), (x, [7 % n])]
        ref = c.expectation(*ops)
        free = max(abs(tct.expectation(*ops, ket=psi) - ref).item(),
                   abs(tct.expectation(*ops, ket=2 * psi, bra=psi, normalization=True) - ref).item())
        _check("(f) free expectation(ket=, bra=) against c.expectation", free, SAME_ATOL)
        if not c.is_valid():
            _fail("phase 12: is_valid() is false")
    print("  (f) is_valid(): True")
    lap("(f)")
    print("  wall time of the checks: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return {"c": c, "g0": g0, "hu": hu, "structures": (structures, weights), "tfim_vg": tfim_vg}


def _api_phase(tct, card, counters):
    """Phase 12, the circuit API at full width: :func:`_api_checks` on the
    card, then each route timed by CUDA events (median of 20 after warm-up)
    beside what it stands against, with its busy time under torch.profiler
    (5 calls, the card's activity alone)."""
    import torch

    dev = torch.device("cuda")
    got = _api_checks(tct, dev, counters)
    c, hu = got["c"], got["hu"]
    structures, weights = got["structures"]
    pairs = [(i, i + 1) for i in range(N - 1)]
    zz = ((np.diag([1.0, -1.0]), [0]), (np.diag([1.0, -1.0]), [1]))
    p = tct.convert.params(got["g0"], dev)
    timed = {
        "echo state (copy, inverse, 196 items)": lambda: loschmidt_echo(c).state()[0].item(),
        "initial_mapping energy + grad": lambda: got["tfim_vg"](dev, reversal(N)),
        "unmapped energy + grad (the training step's value and grad)": lambda: got["tfim_vg"](dev, None),
        "39 Pauli strings (a new circuit each call)":
            lambda: tfim_circuit(tct, p, N, L, device=dev).expectation_structures(structures, weights).item(),
        "fused expectation_zzx_energy (a new circuit each call)":
            lambda: tfim_circuit(tct, p, N, L, device=dev).expectation_zzx_energy(pairs, 1.0, -1.0).item(),
        "HEA <Z_0 Z_1> light cone": lambda: hea_circuit(tct, N, p, device=dev).expectation(
            *zz, enable_lightcone=True).item(),
        "HEA <Z_0 Z_1> dense": lambda: hea_circuit(tct, N, p, device=dev).expectation(*zz).item(),
        "TFIM <Z_0 Z_1> light cone": lambda: tfim_circuit(tct, p, N, L, device=dev).expectation(
            *zz, enable_lightcone=True).item(),
        "TFIM <Z_0 Z_1> dense": lambda: tfim_circuit(tct, p, N, L, device=dev).expectation(*zz).item(),
        f"matrix() n={N_UNITARY}": lambda: hu.matrix()[0, 0].item(),
    }
    for label, fn in timed.items():
        with torch.no_grad() if "grad" not in label else torch.enable_grad():
            ms = _time_ms(fn, inner=1)
            host, busy, by_kernel = _profile(fn, reps=5, cpu=False)
        top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in by_kernel[:3])
        print(f"phase 12 time, {label}: {ms:.3f} ms (CUDA events, median of 20), busy {busy:.3f} ms "
              f"({100 * busy / ms:.1f} %; profiler, 5 calls), {card}; top kernels {top}")


#: phase 13, sampling at full width (n=20, L=4): 8,192 shots by inverse
#: CDF, 1,024 trajectories.  A float32 cumsum over 2^20 entries drifts from
#: the float64 one by ~1e-6 to 1e-4 of the mass, wider than an entry, so
#: each index is held to its float64 cdf interval within BRACKET_TOL;
BRACKET_TOL = 1e-4
#: a trajectory's probability against |amplitude|^2 (a product of 20
#: float32 conditionals), and the readout-confused p against the CPU path;
TRAJ_PROB_RTOL = 1e-4
READOUT_ATOL = 1e-6
#: the exact Pauli expectations against expectation_ps (float32 sums over
#: 2^20 entries in another order), and the peak memory of 1,024 trajectories
#: above the state (one state a shot would be 8.6 GB)
SEP_ATOL = 1e-5
TRAJ_PEAK_MB = 64
SAMPLE_SHOTS = 8192
TRAJ_SHOTS = 1024


def _chi2_equal_mass(counts, p, bins=64):
    """(chi-square, degrees of freedom) of ``counts`` against ``p`` over
    ``bins`` groups of outcomes of about equal mass, the most likely first:
    at the TFIM state's nearly flat p no single outcome expects a shot."""
    order = np.argsort(-p, kind="stable")
    group = np.minimum((np.cumsum(p[order]) * bins).astype(np.int64), bins - 1)
    expect = np.bincount(group, weights=p[order], minlength=bins) * counts.sum()
    seen = np.bincount(group, weights=counts[order], minlength=bins)
    keep = expect > 0
    return float(np.sum((seen[keep] - expect[keep]) ** 2 / expect[keep])), int(keep.sum()) - 1


def _sampling_checks(tct, dev, counters, n=N, nl=L, shots=SAMPLE_SHOTS, traj=TRAJ_SHOTS, bracket_tol=BRACKET_TOL):
    """Phase 13's checks (a)-(e) on the n-qubit TFIM circuit of the
    training path on ``dev``, each route also on the port's CPU path with
    the same status (once a route; on the CPU the two are one).  Returns
    what the timings reuse."""
    import torch

    card = torch.device(dev).type == "cuda"
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1  # bench.py's parameters
    rng = np.random.default_rng(13)
    u = rng.random(shots).astype(np.float32)
    big_u = rng.random((traj, n)).astype(np.float32)
    radix = 2 ** np.arange(n - 1, -1, -1)
    spent = {}
    last = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        spent[key], last[0] = now - last[0], now

    def on_cpu(key, fn):
        t = time.perf_counter()
        out = fn()
        spent[f"CPU {key}"] = spent.get(f"CPU {key}", 0.0) + time.perf_counter() - t
        return out

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 13, {label}: {err} > {tol}")

    def circuit(device):
        return tfim_circuit(tct, tct.convert.params(g0, device), n, nl, device=device)

    print(f"sampling (n={n}, L={nl}, {shots} shots, {traj} trajectories):")
    with torch.no_grad():
        c = circuit(dev)
        _reset(counters)
        psi = c.state()
        state_launches = _launched(counters)
        p = c.probability()
        p64 = p.double().cpu().numpy()
        c_cpu = on_cpu("(a)", lambda: circuit("cpu"))
        p_cpu = on_cpu("(a)", lambda: c_cpu.probability().double().numpy())
        u_dev = torch.as_tensor(u, device=dev)
        # (a) allow_state: six formats, the legacy list, the bracket, chi-square
        out = {f: c.sample(batch=shots, allow_state=True, status=u_dev, format=f)
               for f in ("sample_int", "sample_bin", "count_vector", "count_tuple", "count_dict_bin",
                         "count_dict_int", None)}
        idx = out["sample_int"].cpu().numpy().astype(np.int64)
        cv = out["count_vector"].cpu().numpy()
        vals, cnts = (x.cpu().numpy() for x in out["count_tuple"])
        legacy = np.stack([b.cpu().numpy() for b, _ in out[None]])
        bits = (idx[:, None] >> np.arange(n - 1, -1, -1)) & 1
        sums = [int(cv.sum()), int(cnts.sum()), sum(out["count_dict_bin"].values()),
                sum(out["count_dict_int"].values())]
        agree = {
            "sample_int on a second call": torch.equal(
                out["sample_int"], c.sample(batch=shots, allow_state=True, status=u_dev, format="sample_int")),
            "sample_bin": np.array_equal(out["sample_bin"].cpu().numpy(), bits),
            "legacy list": np.array_equal(legacy, bits),
            "count_vector": np.array_equal(cv, np.bincount(idx, minlength=2**n)),
            "count_tuple": np.array_equal(vals, np.flatnonzero(cv)) and np.array_equal(cnts, cv[vals]),
            "count_dict_int": out["count_dict_int"] == {int(k): int(cv[k]) for k in vals},
            "count_dict_bin": out["count_dict_bin"] == {format(int(k), f"0{n}b"): int(cv[k]) for k in vals},
        }
        if sums != [shots] * 4 or not all(agree.values()):
            _fail(f"phase 13 (a): sums {sums} (want {shots}); disagreeing with sample_int: "
                  f"{[k for k, v in agree.items() if not v]}")
        idx_cpu = on_cpu("(a)", lambda: c_cpu.sample(batch=shots, allow_state=True, status=u,
                                                     format="sample_int").numpy())
        chi2, dof = _chi2_equal_mass(cv.astype(np.float64), p64 / p64.sum())
        print(f"  (a) {shots} shots in six formats and the legacy list: they agree (and with a second call), "
              f"each sums to {shots}; "
              f"{len(vals)} distinct outcomes; max p {p64.max():.3e}; {int(np.sum(idx != idx_cpu))} indices "
              f"differ from the CPU path's; state() launched {state_launches}")
        check("(a) bracket miss against the card's float64 cdf", bracket_miss(idx, u, p64), bracket_tol)
        check("(a) CPU path's bracket miss against its float64 cdf", bracket_miss(idx_cpu, u, p_cpu), bracket_tol)
        check(f"(a) chi-square over {dof + 1} equal-mass groups, |chi2 - dof| / sqrt(2 dof)",
              abs(chi2 - dof) / np.sqrt(2 * dof), 5.0)
        lap("(a)")

        # (b) trajectories: no state a shot
        big_dev = torch.as_tensor(big_u, device=dev)
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rows = c.sample(batch=traj, allow_state=False, status=big_dev)
        if card:
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
        tbits = np.stack([b.cpu().numpy() for b, _ in rows]).astype(np.int64)
        tprob = np.array([q.item() for _, q in rows])
        amp2 = (psi.abs() ** 2).double().cpu().numpy()[tbits @ radix]
        rows_cpu = on_cpu("(b)", lambda: c_cpu.sample(batch=traj, allow_state=False, status=big_u))
        tbits_cpu = np.stack([b.numpy() for b, _ in rows_cpu]).astype(np.int64)
        print(f"  (b) {traj} trajectories: {int(np.sum(np.any(tbits != tbits_cpu, axis=1)))} differ from the "
              f"CPU path's; probabilities {tprob.min():.3e}-{tprob.max():.3e}"
              + (f"; peak memory above the state {peak_mb:.2f} MB (one state a shot: "
                 f"{traj * psi.numel() * psi.element_size() / 1e9:.1f} GB)" if card else ""))
        check("(b) max relative |prob - |amplitude|^2|", float(np.max(np.abs(tprob - amp2) / amp2)), TRAJ_PROB_RTOL)
        check("(b) step bracket miss against the card's float64 block sums",
              trajectory_bracket_miss(tbits, big_u, p64), bracket_tol)
        check("(b) CPU path's step bracket miss", trajectory_bracket_miss(tbits_cpu, big_u, p_cpu), bracket_tol)
        if card:
            check("(b) peak memory above the state, MB", peak_mb, TRAJ_PEAK_MB)
        lap("(b)")

        # (c) readout error on the allow_state route
        err = [[0.98, 0.97]] * n
        pr = c.readouterror_bs(err, p / torch.sum(p))
        pr_cpu = on_cpu("(c)", lambda: c_cpu.readouterror_bs(err, torch.as_tensor(p_cpu / p_cpu.sum())))
        ridx = c.sample(batch=shots, allow_state=True, readout_error=err, status=u_dev, format="sample_int")
        pr64 = pr.double().cpu().numpy()
        print(f"  (c) readout_error [[0.98, 0.97]] * {n}: sum of p {pr64.sum():.7f}")
        check("(c) max|p - p_CPU|", float(np.max(np.abs(pr64 - pr_cpu.numpy()))), READOUT_ATOL)
        check("(c) bracket miss against the confused p", bracket_miss(ridx.cpu().numpy(), u, pr64), bracket_tol)
        lap("(c)")

        # (d) sample_expectation_ps: exact, and 8192 shots with a status
        for label, kw in (("<Z_0 Z_1>", {"z": [0, 1]}), ("<X_5>", {"x": [5 % n]})):
            exact = c.sample_expectation_ps(**kw).item()
            ps = c.expectation_ps(**kw).real.item()
            est = c.sample_expectation_ps(**kw, shots=shots, status=u_dev).item()
            rot = c.copy()
            for q in kw.get("x", ()):
                rot.h(q)
            prot = rot.probability()
            ridx = tct.backend.probability_sample(shots, prot, status=u_dev).cpu().numpy().astype(np.int64)
            parity = np.ones(shots)
            for w in list(kw.get("x", ())) + list(kw.get("z", ())):
                parity = parity * (1 - 2 * ((ridx >> (n - 1 - w)) & 1))
            est_cpu = on_cpu("(d)", lambda kw=kw: c_cpu.sample_expectation_ps(**kw, shots=shots, status=u).item())
            sigma = np.sqrt(max(1 - exact**2, 1e-12) / shots)
            print(f"  (d) {label}: exact {exact:.7f} (expectation_ps {ps:.7f}), {shots} shots {est:.7f} "
                  f"(CPU path {est_cpu:.7f}), sigma {sigma:.2e}")
            check(f"(d) {label} exact against expectation_ps", abs(exact - ps), SEP_ATOL)
            check(f"(d) {label} shots against the parity of the same indices", abs(est - parity.mean()), 1e-6)
            check(f"(d) {label} bracket miss", bracket_miss(ridx, u, prot.double().cpu().numpy()), bracket_tol)
            check(f"(d) {label} |shots - exact| / sigma", abs(est - exact) / sigma, 5.0)
        lap("(d)")

        # (e) feed-forward: measure, correct, measure; one K2 in all: each
        # state() after the first extends the kept prefix state
        def feed_forward(device, s0, s1):
            f = circuit(device)
            m0 = f.cond_measurement(0, status=s0)
            f.conditional_gate(m0, [np.eye(2), np.array([[0.0, 1.0], [1.0, 0.0]])], 1)
            m1 = f.cond_measurement(1, status=s1)
            return f, m0, m1

        for s0, s1 in ((0.7, 0.2),):  # qubit 0 reads 1 here: the X correction runs
            _reset(counters)
            f, m0, m1 = feed_forward(dev, torch.tensor(s0, device=dev), torch.tensor(s1, device=dev))
            final = f.state()
            ff_launches = _launched(counters)
            f_cpu, m0c, m1c = on_cpu("(e)", lambda: feed_forward("cpu", s0, s1))
            final_cpu = on_cpu("(e)", f_cpu.state)
            got = (int(m0.item()), int(m1.item()))
            print(f"  (e) feed-forward, status ({s0}, {s1}): outcomes {got} (CPU {(int(m0c), int(m1c))}); "
                  f"launched {ff_launches} for 3 state() computations")
            if got != (int(m0c), int(m1c)):
                _fail(f"phase 13 (e): outcomes {got} differ from the CPU path's")
            if card and ff_launches != {"grand_zzrx_fwd": 1}:
                _fail(f"phase 13 (e): expected one K2 launch for the three state()s, launched {ff_launches}")
            check("(e) final state against the CPU path", (final.cpu() - final_cpu).abs().max().item(), STATE_ATOL)
            check("(e) |norm - 1|", abs(torch.linalg.vector_norm(final).item() - 1.0), STATE_ATOL)
        lap("(e)")
    print("  wall time of the checks: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return {"c": c, "u": u_dev, "big_u": big_dev, "feed_forward": feed_forward, "err": err}


def _sampling_phase(tct, card, counters):
    """Phase 13, sampling at full width: :func:`_sampling_checks` on the
    card, then each route timed by CUDA events (median of 20 after warm-up)
    with its busy time under torch.profiler (5 calls, the card alone)."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    got = _sampling_checks(tct, dev, counters)
    t1 = time.perf_counter()
    c, u, big_u = got["c"], got["u"], got["big_u"]
    s0, s1 = torch.tensor(0.7, device=dev), torch.tensor(0.2, device=dev)
    timed = {
        f"(a) {SAMPLE_SHOTS} shots, sample_int (cached state)":
            lambda: c.sample(batch=SAMPLE_SHOTS, allow_state=True, status=u, format="sample_int")[-1].item(),
        f"(a) {SAMPLE_SHOTS} shots, count_dict_bin (cached state)":
            lambda: c.sample(batch=SAMPLE_SHOTS, allow_state=True, status=u, format="count_dict_bin"),
        f"(b) {TRAJ_SHOTS} trajectories, sample_int (cached state)":
            lambda: c.sample(batch=TRAJ_SHOTS, status=big_u, format="sample_int")[-1].item(),
        f"(c) {SAMPLE_SHOTS} shots with readout_error":
            lambda: c.sample(batch=SAMPLE_SHOTS, allow_state=True, readout_error=got["err"], status=u,
                             format="sample_int")[-1].item(),
        f"(d) sample_expectation_ps <X_5>, {SAMPLE_SHOTS} shots (a copy: K2 and h)":
            lambda: c.sample_expectation_ps(x=[5], shots=SAMPLE_SHOTS, status=u).item(),
        "(e) feed-forward circuit (1 K2)": lambda: got["feed_forward"](dev, s0, s1)[0].state()[0].item(),
    }
    with torch.no_grad():
        for label, fn in timed.items():
            ms = _time_ms(fn, inner=1)
            host, busy, by_kernel = _profile(fn, reps=5, cpu=False)
            top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in by_kernel[:3])
            print(f"phase 13 time, {label}: {ms:.3f} ms (CUDA events, median of 20), busy {busy:.3f} ms "
                  f"({100 * busy / ms:.1f} %; profiler, 5 calls), {card}; top kernels {top}")
    print(f"phase 13 wall time: checks {t1 - t0:.1f} s, timing {time.perf_counter() - t1:.1f} s")


#: phase 14, noise at full width: the depolarizing strength a Pauli after
#: each zzrx_layer, the trajectories of the noisy TFIM step, the amplitude
#: damping after each CNOT of the HEA and its trajectories, the trajectories
#: and shots of the API entry points, and the exact oracle's width and its
#: trajectories
NOISE_P = 0.005
NOISE_NMC = 32
HEA_GAMMA = 0.02
HEA_NMC = 8
API_NMC = 16
API_SHOTS = 8192
DM_N = 10
DM_NMC = 512
#: the trajectories of (a), (b) and (c) that the CPU path also runs (one
#: n=20 trajectory there takes 1.2-2.9 s); every branch of (a) is compared
CPU_TRAJ, CPU_HEA, CPU_API = 8, 3, 4
#: a branch against its float64 cdf interval: the float32 branch
#: probabilities of one device against the float64 sums of the same
#: numbers (phase 13's bracket, one site at a time)
BRANCH_TOL = 1e-5
#: the density matrix on the card against the CPU path (2^20 float32
#: entries, each a sum over the Kraus branches of 40 channels)
DM_ATOL = 1e-5


def channel_branches(c):
    """The branch each channel item of ``c`` took, in QIR order (a tensor
    on the circuit's device)."""
    import torch

    return torch.stack([item["channel_branch"] for item in c.to_qir() if item.get("is_channel")])


def channel_probs(c):
    """The branch probabilities of each channel item of ``c``, (sites,
    branches), on the circuit's device."""
    import torch

    return torch.stack([item["channel_probs"] for item in c.to_qir() if item.get("is_channel")])


def branch_miss(branches, u, probs):
    """How far past its float64 cdf interval [cdf[b-1], cdf[b]] each uniform
    ``u`` + the tie-break lies, at most (0 when every branch is inside):
    ``probs`` (sites, branches) are one device's float32 probabilities."""
    cdf = np.cumsum(np.asarray(probs, dtype=np.float64), axis=1)
    b = np.asarray(branches, dtype=np.int64)
    u = np.asarray(u, dtype=np.float64) + MEASURE_EPS
    rows = np.arange(len(b))
    lo = np.where(b > 0, cdf[rows, np.maximum(b - 1, 0)], 0.0)
    return float(np.max(np.maximum(lo - u, u - cdf[rows, b])))


def _noise_inputs(tct, n=N, nl=L, nmc=NOISE_NMC, hea_nmc=HEA_NMC, api_nmc=API_NMC, shots=API_SHOTS):
    """Phase 14's parameters (bench.py's), noise configurations and numpy
    statuses, the same for every device: (a)'s, (b)'s and (c)'s statuses
    from one seeded generator, returned positioned for (d)'s."""
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1
    rng = np.random.default_rng(14)
    nc = tct.NoiseConf()
    nc.add_noise("zzrx_layer", tct.channels.depolarizingchannel(NOISE_P, NOISE_P, NOISE_P))
    s_a = rng.random((nmc, nc.channel_count(tfim_circuit(tct, g0, n, nl, device="cpu")))).astype(np.float32)
    nc_hea = tct.NoiseConf()
    nc_hea.add_noise("cnot", tct.channels.amplitudedampingchannel(HEA_GAMMA, 1.0))
    num = nc_hea.channel_count(hea_circuit(tct, n, tct.convert.params(g0, "cpu"), device="cpu"))
    s_b = rng.random((hea_nmc, num)).astype(np.float32)
    nc_ro = tct.NoiseConf()
    nc_ro.add_noise("zzrx_layer", tct.channels.depolarizingchannel(NOISE_P, NOISE_P, NOISE_P))
    nc_ro.add_noise("readout", [[0.98, 0.97]] * n)
    s_c = rng.random((api_nmc, s_a.shape[1])).astype(np.float32)
    u_c = rng.random(shots).astype(np.float32)
    return {"n": n, "nl": nl, "g0": g0, "rng": rng, "nc": nc, "nc_hea": nc_hea, "nc_ro": nc_ro, "s_a": s_a,
            "s_b": s_b, "s_c": s_c, "u_c": u_c}


def _noisy_tfim(tct, x, p, device, st):
    """One trajectory of (a)'s noisy TFIM: (its circuit, its energy)."""
    n, nl = x["n"], x["nl"]
    cn = tct.circuit_with_noise(tfim_circuit(tct, p, n, nl, device=device), x["nc"], status=st)
    return cn, cn.expectation_zzx_energy([(i, i + 1) for i in range(n - 1)], 1.0, -1.0)


def _noisy_tfim_step(tct, x, device, status, counters=(), launches=None):
    """(a)'s step: the mean energy and gradient over the trajectories of
    ``status``, one at a time, and the SGD update; each trajectory's energy
    and gradient (with ``launches``, each one's forward and backward
    launches)."""
    import torch

    p = tct.convert.params(x["g0"], device).requires_grad_()
    es, gs = [], []
    for k in range(len(status)):
        _reset(counters)
        _, e = _noisy_tfim(tct, x, p, device, status[k])
        if launches is not None:
            launches["forward"].append(_launched(counters))
            _reset(counters)
        (g,) = torch.autograd.grad(e, p)
        if launches is not None:
            launches["backward"].append(_launched(counters))
        es.append(e.detach())
        gs.append(g)
    e, g = torch.stack(es), torch.stack(gs)
    return e.mean(), g.mean(dim=0), p.detach() - LR * g.mean(dim=0), e, g


def _noisy_tfim_branches(tct, x, device, status):
    """Every trajectory's branches (the channels are unitary: no state is
    computed)."""
    import torch

    with torch.no_grad():
        return torch.stack([channel_branches(tct.circuit_with_noise(
            tfim_circuit(tct, x["g0"], x["n"], x["nl"], device=device), x["nc"], status=st)) for st in status])


def _noisy_hea(tct, x, c, st):
    """One trajectory of (b)'s noisy HEA circuit ``c``: (its circuit, its
    energy)."""
    cn = tct.circuit_with_noise(c, x["nc_hea"], status=st)
    return cn, cn.expectation_zzx_energy([(i, i + 1) for i in range(x["n"] - 1)], 1.0, -1.0).item()


def _noisy_dm(tct, x, device, dm_n):
    """(d)'s exact oracle: the noisy TFIM at dm_n as a ``DMCircuit``."""
    gd = np.random.default_rng(42).normal(size=(x["nl"], 2, dm_n)) * 0.1
    cd = tfim_circuit(tct, tct.convert.params(gd, device), dm_n, x["nl"], device=device)
    return tct.circuit_with_noise(cd.to_dm_circuit(), x["nc"])


def _noise_reference(tct, n=N, nl=L, nmc=NOISE_NMC, hea_nmc=HEA_NMC, api_nmc=API_NMC, shots=API_SHOTS, dm_n=DM_N,
                     cpu_traj=CPU_TRAJ, cpu_hea=CPU_HEA, cpu_api=CPU_API, **_):
    """Phase 14's references on the port's CPU path, from the inputs of
    :func:`_noise_inputs`: (a)'s branches of every trajectory and the
    energies and gradients of the first ``cpu_traj``, (b)'s energy,
    branches and branch probabilities of the first ``cpu_hea``, (c)'s
    <Z_0 Z_1> over the first ``cpu_api``, and (d)'s density matrix."""
    import torch

    x = _noise_inputs(tct, n, nl, nmc, hea_nmc, api_nmc, shots)
    t0 = time.perf_counter()
    ref = {"branches": _noisy_tfim_branches(tct, x, "cpu", x["s_a"])}
    ref["e"], ref["g"] = _noisy_tfim_step(tct, x, "cpu", x["s_a"][:cpu_traj])[3:]
    with torch.no_grad():
        c_hea = hea_circuit(tct, n, tct.convert.params(x["g0"], "cpu"), device="cpu")
        ref["hea"] = []
        for k in range(cpu_hea):
            cc, e = _noisy_hea(tct, x, c_hea, x["s_b"][k])
            ref["hea"].append((e, channel_branches(cc).numpy(), channel_probs(cc).double().numpy()))
        c = tfim_circuit(tct, tct.convert.params(x["g0"], "cpu"), n, nl, device="cpu")
        ref["zz01"] = c.expectation_ps(z=[0, 1], noise_conf=x["nc"], status=x["s_c"][:cpu_api]).item()
        ref["rho"] = _noisy_dm(tct, x, "cpu", dm_n).densitymatrix()
    ref["seconds"] = time.perf_counter() - t0
    return ref


def _noise_checks(tct, dev, counters, n=N, nl=L, nmc=NOISE_NMC, hea_nmc=HEA_NMC, api_nmc=API_NMC,
                  shots=API_SHOTS, dm_n=DM_N, dm_nmc=DM_NMC, cpu_traj=CPU_TRAJ, cpu_hea=CPU_HEA, cpu_api=CPU_API,
                  ref=None):
    """Phase 14's checks (a)-(d) on ``dev``, each case also on the port's
    CPU path with the same statuses: the first ``cpu_traj``, ``cpu_hea``
    and ``cpu_api`` trajectories of (a)-(c), every branch of (a), and (d)'s
    density matrix (:func:`_noise_reference`, or ``ref()`` when a callable
    gives it, fetched after (a)'s card step; on the CPU the two paths are
    one; the kernels' launches are required only on the card).  Returns
    what the timings reuse."""
    import torch

    card = torch.device(dev).type == "cuda"
    x = _noise_inputs(tct, n, nl, nmc, hea_nmc, api_nmc, shots)
    g0, rng, nc, s_a = x["g0"], x["rng"], x["nc"], x["s_a"]
    pairs = [(i, i + 1) for i in range(n - 1)]
    names = [k.__name__ for k in counters]
    spent = {}
    last = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        spent[key], last[0] = now - last[0], now

    refs = {}

    def cpu_ref():
        if not refs:
            t = time.perf_counter()
            refs.update(ref() if callable(ref) else ref or _noise_reference(
                tct, n, nl, nmc, hea_nmc, api_nmc, shots, dm_n, cpu_traj, cpu_hea, cpu_api))
            spent["CPU references"] = time.perf_counter() - t
        return refs

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 14, {label}: {err} > {tol}")

    def need(label, launched, want):
        if card and {k: v for k, v in launched.items() if k in names} != want:
            _fail(f"phase 14 {label}: expected launches {want}, got {launched}")

    # (a) the noisy TFIM step: value and grad one trajectory at a time
    def tfim_trajectory(p, device, st):
        return _noisy_tfim(tct, x, p, device, st)

    print(f"noise (n={n}, L={nl}; depolarizing {NOISE_P} a Pauli after each zzrx_layer, "
          f"{s_a.shape[1]} sites, {nmc} trajectories):")
    launches = {"forward": [], "backward": []}
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    e_a, g_a, p_new, e_k, g_k = _noisy_tfim_step(tct, x, dev, torch.as_tensor(s_a, device=dev), counters, launches)
    if card:
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    b_a = _noisy_tfim_branches(tct, x, dev, torch.as_tensor(s_a, device=dev))
    b_ac, e_kc, g_kc = cpu_ref()["branches"], cpu_ref()["e"], cpu_ref()["g"]
    fwd = {k: sum(d.get(k, 0) for d in launches["forward"]) for k in names}
    bwd = {k: sum(d.get(k, 0) for d in launches["backward"]) for k in names}
    fwd, bwd = ({k: v for k, v in d.items() if v} for d in (fwd, bwd))
    differ = int((b_a.cpu() != b_ac).sum())
    print(f"  (a) E {e_a.item():.7f}, |grad| {g_a.abs().max().item():.4f}; {int((b_a != 0).sum())} non-identity "
          f"branches of {b_a.numel()}, {differ} differ from the CPU path's; forward launched {fwd}, backward {bwd}"
          + (f"; peak memory above the start {peak_mb:.2f} MB" if card else ""))
    if differ:
        _fail(f"phase 14 (a): {differ} branches differ from the CPU path's")
    need("(a) forward", fwd, {"zzrx_fwd": nl * nmc})
    need("(a) backward", bwd, {"zzrx_bwd": nl * nmc})
    with torch.no_grad():  # the same trajectories (the branches do not read the state) after the update
        e_new = torch.stack([tfim_trajectory(p_new, dev, st)[1] for st in torch.as_tensor(s_a, device=dev)]).mean()
    print(f"  (a) after one SGD step (rate {LR}): E {e_new.item():.7f}")
    if not e_new.item() < e_a.item():
        _fail(f"phase 14 (a): the SGD step raised the energy, {e_a.item()} -> {e_new.item()}")
    check(f"(a) max |E - E_CPU| over trajectories 0-{cpu_traj - 1}",
          (e_k[:cpu_traj].cpu() - e_kc).abs().max().item(), ENERGY_ATOL)
    check(f"(a) max |grad - grad_CPU| over trajectories 0-{cpu_traj - 1}",
          (g_k[:cpu_traj].cpu() - g_kc).abs().max().item(), GRAD_ATOL)
    lap("(a)")

    # (b) the noisy HEA energy: general_kraus reads the state at each site
    nc_hea, s_b = x["nc_hea"], x["s_b"]
    num = s_b.shape[1]
    with torch.no_grad():
        c_hea = hea_circuit(tct, n, tct.convert.params(g0, dev), device=dev)
        _reset(counters)
        hea_circuit(tct, n, tct.convert.params(g0, dev), device=dev).state()
        clean = _launched(counters)
        rows, traj_launches = [], []
        s_b_dev = torch.as_tensor(s_b, device=dev)
        for k in range(hea_nmc):
            _reset(counters)
            cn, e = _noisy_hea(tct, x, c_hea, s_b_dev[k])
            traj_launches.append(_launched(counters))
            rows.append([e, None, channel_branches(cn).cpu().numpy(), None,
                         channel_probs(cn).double().cpu().numpy(), None])
            if k < cpu_hea:
                rows[k][1], rows[k][3], rows[k][5] = cpu_ref()["hea"][k]
    miss = max(branch_miss(b, s_b[k], pr) for k, (_, _, b, _, pr, _) in enumerate(rows))
    miss_cpu = max(branch_miss(r[3], s_b[k], r[5]) for k, r in enumerate(rows[:cpu_hea]))
    same = [k for k, r in enumerate(rows[:cpu_hea]) if np.array_equal(r[2], r[3])]
    print(f"  (b) HEA, amplitude damping {HEA_GAMMA} after each CNOT: {num} sites, {hea_nmc} trajectories; "
          f"{len(same)} of the {cpu_hea} on the CPU path with every branch equal to its; "
          f"{sum(int(r[2].sum()) for r in rows)} decays; "
          f"a trajectory launched {traj_launches[0]}, a noiseless state() {clean}")
    check("(b) branch bracket miss against the card's float64 cdf", miss, BRANCH_TOL)
    check("(b) CPU path's branch bracket miss", miss_cpu, BRANCH_TOL)
    for k, (e, ec, b, bc, pr, _) in enumerate(rows[:cpu_hea]):
        if k in same:
            continue
        site = int(np.flatnonzero(b != bc)[0])
        edge = np.cumsum(pr[site])[min(b[site], bc[site])]
        check(f"(b) trajectory {k}: first differing site's |u - cdf boundary|",
              abs(float(s_b[k, site]) + MEASURE_EPS - edge), BRANCH_TOL)
    if same:
        check("(b) max |E - E_CPU| where the branches agree", max(abs(rows[k][0] - rows[k][1]) for k in same),
              ENERGY_ATOL)
    k6 = [d.get("row_fwd", 0) for d in traj_launches]
    if card and (set(k6) != {clean.get("row_fwd", 0)} or not k6[0]):
        _fail(f"phase 14 (b): K6 launches a trajectory {k6}, a noiseless state() {clean}")
    lap("(b)")

    # (c) the API entry points on the noisy TFIM
    nc_ro, s_c, u_c = x["nc_ro"], x["s_c"], x["u_c"]
    with torch.no_grad():
        c = tfim_circuit(tct, tct.convert.params(g0, dev), n, nl, device=dev)
        s_c_dev, u_c_dev = torch.as_tensor(s_c, device=dev), torch.as_tensor(u_c, device=dev)
        zz01 = c.expectation_ps(z=[0, 1], noise_conf=nc, status=s_c_dev).item()
        zz01_few = c.expectation_ps(z=[0, 1], noise_conf=nc, status=s_c_dev[:cpu_api]).item()
        zz01_cpu = cpu_ref()["zz01"]
        est = c.sample_expectation_ps(x=[5 % n], noise_conf=nc_ro, nmc=api_nmc, shots=shots, status=u_c_dev,
                                      statusc=s_c_dev).item()
        exact = c.sample_expectation_ps(x=[5 % n], noise_conf=nc_ro, nmc=api_nmc, statusc=s_c_dev).item()
    sigma = np.sqrt(max(1 - exact**2, 1e-12) / shots)
    print(f"  (c) expectation_ps <Z_0 Z_1>, {api_nmc} trajectories: {zz01:.7f}; the first {cpu_api}: "
          f"{zz01_few:.7f} (CPU {zz01_cpu:.7f}); "
          f"sample_expectation_ps <X_5> with readout error: {shots} shots {est:.7f}, exact {exact:.7f}, "
          f"sigma {sigma:.2e}")
    check(f"(c) |<Z_0 Z_1> - CPU| over {cpu_api} trajectories", abs(zz01_few - zz01_cpu), ENERGY_ATOL)
    check("(c) |shots - exact| / sigma", abs(est - exact) / sigma, 3.0)
    lap("(c)")

    # (d) the exact oracle at n=dm_n: DMCircuit against the trajectory mean
    gd = np.random.default_rng(42).normal(size=(nl, 2, dm_n)) * 0.1
    pairs_d = [(i, i + 1) for i in range(dm_n - 1)]
    with torch.no_grad():
        def dm(device):
            return _noisy_dm(tct, x, device, dm_n)

        def dm_values(d):
            zz = d.expectation_ps(z=[0, 1]).real.item()
            e = sum(d.expectation_ps(z=[a, b]).real.item() for a, b in pairs_d)
            return zz, e - sum(d.expectation_ps(x=[q]).real.item() for q in range(dm_n))

        d = dm(dev)
        rho = d.densitymatrix()
        rho_cpu = cpu_ref()["rho"]
        zz_dm, e_dm = dm_values(d)
        cd = tfim_circuit(tct, tct.convert.params(gd, dev), dm_n, nl, device=dev)
        s_d = torch.as_tensor(rng.random((dm_nmc, nc.channel_count(cd))).astype(np.float32), device=dev)
        vals = []
        for k in range(dm_nmc):
            cn = tct.circuit_with_noise(cd, nc, status=s_d[k])
            vals.append(torch.stack([cn.expectation_ps(z=[0, 1]).real,
                                     cn.expectation_zzx_energy(pairs_d, 1.0, -1.0).real]))
        vals = torch.stack(vals).double().cpu().numpy()
    mean, sd = vals.mean(axis=0), vals.std(axis=0, ddof=1) / np.sqrt(dm_nmc)
    tr = torch.trace(rho).real.item()
    purity = d.purity().item()
    print(f"  (d) DMCircuit n={dm_n} ({rho.numel()} entries): trace {tr:.7f}, purity {purity:.6f}; "
          f"<Z_0 Z_1> {zz_dm:.6f} exact, {mean[0]:.6f} +- {sd[0]:.1e} over {dm_nmc} trajectories; "
          f"energy {e_dm:.6f} exact, {mean[1]:.6f} +- {sd[1]:.1e}")
    check("(d) max |rho - rho_CPU|", (rho.cpu() - rho_cpu).abs().max().item(), DM_ATOL)
    check("(d) |tr rho - 1|", abs(tr - 1.0), DM_ATOL)
    if not purity < 1.0:
        _fail(f"phase 14 (d): purity {purity} is not below 1")
    check("(d) <Z_0 Z_1>: |mean - exact| - 4 sigma", abs(mean[0] - zz_dm) - 4 * sd[0], 1e-3)
    check("(d) energy: |mean - exact| - 4 sigma", abs(mean[1] - e_dm) - 4 * sd[1], 1e-3)
    lap("(d)")
    print("  wall time of the checks: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return {"g0": g0, "nc": nc, "nc_ro": nc_ro, "nc_hea": nc_hea, "s_a": s_a, "s_b": s_b, "s_c": s_c,
            "u_c": u_c, "c": c, "c_hea": c_hea, "tfim_trajectory": tfim_trajectory, "dm": dm}


def _noise_phase(tct, card, counters, job):
    """Phase 14, noise at full width: :func:`_noise_checks` on the card
    against the CPU references of the child process, then each route timed by CUDA events (median of 3 after a warm-up) with
    its busy time under torch.profiler (one call, the card alone) and the
    launches of one call."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def reference():
        ref, waited = _await_reference(job, "noise")
        print(f"  the CPU path's references from the child process ({REF_THREADS} threads, {ref['seconds']:.1f} s): "
              f"waited {waited:.1f} s")
        return ref

    got = _noise_checks(tct, dev, counters, ref=reference)
    t1 = time.perf_counter()
    c, nc, pairs = got["c"], got["nc"], [(i, i + 1) for i in range(N - 1)]
    s_a = torch.as_tensor(got["s_a"], device=dev)
    s_b = torch.as_tensor(got["s_b"], device=dev)
    s_c = torch.as_tensor(got["s_c"], device=dev)
    u_c = torch.as_tensor(got["u_c"], device=dev)
    p = tct.convert.params(got["g0"], dev).requires_grad_()

    def tfim_vg():
        _, e = got["tfim_trajectory"](p, dev, s_a[0])
        return torch.autograd.grad(e, p)[0][0, 0, 0].item()

    timed = {
        "(a) one noisy TFIM trajectory, value and grad (80 channel sites)": tfim_vg,
        "(a) one noisy TFIM trajectory, energy": lambda: got["tfim_trajectory"](p, dev, s_a[0])[1].item(),
        "(b) one noisy HEA trajectory, energy (152 general_kraus sites)":
            lambda: tct.circuit_with_noise(got["c_hea"], got["nc_hea"], status=s_b[0]).expectation_zzx_energy(
                pairs, 1.0, -1.0).item(),
        f"(c) expectation_ps(noise_conf=), {CPU_API} trajectories":
            lambda: c.expectation_ps(z=[0, 1], noise_conf=nc, status=s_c[:CPU_API]).item(),
        f"(c) sample_expectation_ps(noise_conf=), {CPU_API} trajectories, {API_SHOTS} shots":
            lambda: c.sample_expectation_ps(x=[5], noise_conf=got["nc_ro"], shots=API_SHOTS, status=u_c,
                                            statusc=s_c[:CPU_API]).item(),
        f"(d) DMCircuit n={DM_N}, the noisy density matrix":
            lambda: got["dm"](dev).densitymatrix()[0, 0].real.item(),
    }
    for label, fn in timed.items():
        with torch.no_grad() if "grad" not in label else torch.enable_grad():
            ms = _time_ms(fn, reps=3, inner=1, warmup=1)
            _reset(counters)
            fn()
            launched = _launched(counters)
            host, busy, by_kernel = _profile(fn, reps=1, cpu=False)
        top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in by_kernel[:3])
        print(f"phase 14 time, {label}: {ms:.3f} ms (CUDA events, median of 3), busy {busy:.3f} ms "
              f"({100 * busy / ms:.1f} %; profiler, one call), launched {launched}, {card}; top kernels {top}")
    print(f"phase 14 wall time: checks {t1 - t0:.1f} s, timing {time.perf_counter() - t1:.1f} s")


#: phase 15, the contraction engine at full width: (a) the 5x6 grid at
#: depth 12 (n=30; 207 operands, largest intermediate 2^27, 10^11.8 FLOPs:
#: the plan escalates to TreeSA) contracted whole and over the slices of
#: choose_slices(ir, 2^26), against the dense state; (b) past the dense
#: cliff, the 7x7 grid at depth 8 (n=49; 2^23, 10^10 FLOPs); (c) sampling
#: past 2^30 amplitudes; (d) DMCircuit2 past its cliff of 14 qubits
GRID_A = (5, 6, 12)
GRID_B = (7, 7, 8)
SLICE_TARGET = 2**26
GHZ_N, GHZ_SHOTS = 40, 64
BRICK_N, BRICK_DEPTH, BRICK_SHOTS = 40, 6, 8
READOUT = (0.97, 0.95)
DM2_N, DM2_DEPTH, DM2_P, DM2_SMALL = 24, 4, 0.01, 10
#: the complex64 amplitude of (a), each route against the other and against
#: the complex128 contraction, over |a_128|: this check's complex128 run on
#: an H100 puts the complex64 routes 2.6e-6 (sliced), 3.6e-6 (whole) and
#: 6.5e-6 (dense: ~900 float32 gate applications) from the complex128
#: amplitude, so 1e-4 leaves a factor 15 for another rounding order
GRID_RTOL = 1e-4
#: the same check at complex128: the unsliced and the sliced contraction
GRID_RTOL_128 = 1e-10
#: (b) on the card against the CPU path, both complex64: the amplitude over
#: |a|, each gradient over the largest entry of its CPU gradient, the
#: expectation and its gradient absolutely (<Z> and its derivatives <= 1)
WIDE_RTOL = 1e-4
WIDE_ATOL = 1e-5
#: (d) on the card against the CPU path (and the n=10 einsum route against
#: the dense DMCircuit), complex64, absolutely: probabilities and <Z> <= 1
DM2_ATOL = 1e-5


def grid_patterns(rows, cols):
    """The four CZ patterns of a rows x cols grid (qubit r*cols + c), used in
    turn: horizontal pairs from even columns, vertical pairs from even rows,
    horizontal pairs from odd columns, vertical pairs from odd rows."""
    q = lambda r, c: r * cols + c  # noqa: E731
    return [
        [(q(r, c), q(r, c + 1)) for r in range(rows) for c in range(0, cols - 1, 2)],
        [(q(r, c), q(r + 1, c)) for r in range(0, rows - 1, 2) for c in range(cols)],
        [(q(r, c), q(r, c + 1)) for r in range(rows) for c in range(1, cols - 1, 2)],
        [(q(r, c), q(r + 1, c)) for r in range(1, rows - 1, 2) for c in range(cols)],
    ]


def grid_angles(n, depth, seed=7):
    """(depth, 2, n) normal angles: rz, then ry, on each qubit a layer."""
    return np.random.default_rng(seed).normal(size=(depth, 2, n))


def grid_circuit(mod, rows, cols, depth, angles, **kw):
    """A grid random circuit: H on every qubit, then per layer rz and ry on
    each qubit (``rz_layer``/``ry_layer``; the IR expands them) and CZ on
    the layer's pattern.  ``angles`` (depth, 2, n) may be a tensor that
    needs a grad."""
    c = mod.Circuit(rows * cols, **kw)
    c.h_layer()
    pats = grid_patterns(rows, cols)
    for layer in range(depth):
        c.rz_layer(angles[layer, 0])
        c.ry_layer(angles[layer, 1])
        for a, b in pats[layer % 4]:
            c.cz(a, b)
    return c


def brickwork_circuit(mod, n, depth, seed=7, **kw):
    """``examples/benchmark_40q_amplitude.py``'s circuit: H on every qubit,
    then per layer a CNOT brick and rz, rx on each qubit."""
    th = np.random.default_rng(seed).normal(size=(depth, n, 2)).astype(np.float32)
    c = mod.Circuit(n, **kw)
    for i in range(n):
        c.h(i)
    for layer in range(depth):
        for i in range(layer % 2, n - 1, 2):
            c.cnot(i, i + 1)
        for i in range(n):
            c.rz(i, theta=float(th[layer, i, 0]))
            c.rx(i, theta=float(th[layer, i, 1]))
    return c


def ghz_circuit(mod, n, **kw):
    c = mod.Circuit(n, **kw)
    c.h(0)
    for i in range(n - 1):
        c.cnot(i, i + 1)
    return c


def brickwork_shots(mod, n, depth, shots, device):
    """(c)'s brickwork shots with a readout error on ``device``, from
    seeded uniforms: a numpy array [shots, n]."""
    st = np.random.default_rng(16).random((shots, n))
    return brickwork_circuit(mod, n, depth, device=device).sample(
        batch=shots, status=st, readout_error=[list(READOUT)] * n, format="sample_bin").cpu().numpy()


def noisy_brickwork_dm(mod, n, depth, p=DM2_P, seed=11, cls="DMCircuit2", **kw):
    """A 1D brickwork ``DMCircuit2``: H on every qubit, then per layer a CNOT
    brick with depolarizing ``p`` (a Pauli) on both legs after each CNOT,
    and ry on each qubit."""
    th = np.random.default_rng(seed).normal(size=(depth, n))
    c = getattr(mod, cls)(n, **kw)
    for i in range(n):
        c.h(i)
    for layer in range(depth):
        for i in range(layer % 2, n - 1, 2):
            c.cnot(i, i + 1)
            for q in (i, i + 1):
                c.depolarizing(q, px=p, py=p, pz=p)
        for i in range(n):
            c.ry(i, theta=float(th[layer, i]))
    return c


def _contraction_checks(tct, dev, grid_a=GRID_A, grid_b=GRID_B, slice_target=SLICE_TARGET, ghz=(GHZ_N, GHZ_SHOTS),
                        brick=(BRICK_N, BRICK_DEPTH, BRICK_SHOTS), dm2=(DM2_N, DM2_DEPTH), dm2_small=DM2_SMALL,
                        brick_ref=None):
    """Phase 15's checks (a)-(d) on ``dev``, each against the port's CPU
    path (on the CPU the two are one) or another route on ``dev``; the CPU
    path's brickwork shots from ``brick_ref()`` when it is given (else
    computed here).  Returns what the timings reuse."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import contractor as ctr

    zmat = np.diag([1.0, -1.0])
    spent = {}
    last = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        spent[key], last[0] = now - last[0], now

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 15, {label}: {err} > {tol}")

    # (a) the grid amplitude: plan, whole, sliced, dense
    rows, cols, depth = grid_a
    n = rows * cols
    ang = grid_angles(n, depth)
    c = grid_circuit(tct, rows, cols, depth, ang, device=dev)
    t = time.perf_counter()
    ir = c.amplitude_before("0" * n)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    info = ctr.contraction_info(ir)
    plan_s = time.perf_counter() - t
    sliced = ctr.choose_slices(ir, slice_target)
    nsl = 2 ** len(sliced)
    print(f"  (a) {rows}x{cols} grid depth {depth}: {len(ir.inputs)} operands, IR built in {build_s:.3f} s, "
          f"planned in {plan_s:.3f} s (opt_einsum auto, then TreeSA), log10[FLOPs] {info['log10[FLOPs]']:.3f}, "
          f"log2[largest intermediate] {info['log2[SIZE]']:.1f}; choose_slices(ir, {slice_target}): "
          f"{len(sliced)} indices {sliced}, {nsl} slices")
    first = {}

    def timed_first(key, fn):
        t = time.perf_counter()
        out = fn()
        out.sum().item()
        first[key] = time.perf_counter() - t
        return out

    with torch.no_grad():
        a_whole = timed_first("whole", lambda: ctr.contract_ir(ir))
        # the sliced network is planned anew (above 10^10 FLOPs: TreeSA again)
        a_sliced = timed_first("sliced", lambda: ctr.sliced_contract_ir(ir, sliced))
        # the profiler's digest of the dense state's launches would cost
        # more than the state: its busy share is not measured
        a_dense, dense_cost = _once(lambda: c.state(reuse=False)[0], dev, profile_it=False)
        with tct.runtime_dtype("complex128"):
            c128 = grid_circuit(tct, rows, cols, depth, ang, device=dev)
            ir128 = c128.amplitude_before("0" * n)
            a128 = timed_first("complex128 whole", lambda: ctr.contract_ir(ir128))
            a128_sliced = timed_first("complex128 sliced", lambda: ctr.sliced_contract_ir(ir128, sliced))
        del c128, ir128
    sub = ctr.contraction_info(ctr._without(ir, sliced))
    print("  (a) first calls (wall, with their planning): "
          + ", ".join(f"{k} {v:.2f} s" for k, v in first.items())
          + f"; a slice: log10[FLOPs] {sub['log10[FLOPs]']:.3f}, log2[largest intermediate] {sub['log2[SIZE]']:.1f}")
    for name, v in (("whole", a_whole), ("sliced", a_sliced), ("dense", a_dense), ("complex128", a128)):
        if v.shape != () or not torch.isfinite(torch.view_as_real(v)).all():
            _fail(f"phase 15 (a): the {name} amplitude is non-finite or misshapen: {v}")
    scale = abs(a128.item())
    print(f"  (a) amplitude <0|C|0>: whole {a_whole.item():.6e}, sliced {a_sliced.item():.6e}, "
          f"dense {a_dense.item():.6e}, complex128 {a128.item():.9e}; complex64 against complex128: whole "
          f"{abs(a_whole.item() - a128.item()) / scale:.2e}, sliced {abs(a_sliced.item() - a128.item()) / scale:.2e}, "
          f"dense {abs(a_dense.item() - a128.item()) / scale:.2e} of |a|")
    check("(a) complex128 |sliced - whole| / |a|", abs(a128_sliced.item() - a128.item()) / scale, GRID_RTOL_128)
    check("(a) |whole - dense| / |a|", abs(a_whole.item() - a_dense.item()) / scale, GRID_RTOL)
    check("(a) |sliced - dense| / |a|", abs(a_sliced.item() - a_dense.item()) / scale, GRID_RTOL)
    for name, v in (("whole", a_whole), ("sliced", a_sliced), ("dense", a_dense)):
        check(f"(a) |{name} - complex128| / |a|", abs(v.item() - a128.item()) / scale, GRID_RTOL)
    lap("(a)")

    # (b) past the dense cliff, with the angles' gradient
    rows, cols, depth = grid_b
    nb = rows * cols
    ang_b = grid_angles(nb, depth, seed=8)
    bits = "".join(str(b) for b in np.random.default_rng(9).integers(0, 2, nb))
    mid = nb // 2

    def wide(device):
        # a circuit a quantity: the two share the gates' autograd graph
        th = torch.tensor(ang_b, dtype=torch.float32, device=device, requires_grad=True)
        amp = grid_circuit(tct, rows, cols, depth, th, device=device).amplitude(bits)
        (g_amp,) = torch.autograd.grad(torch.abs(amp) ** 2, th)
        e = grid_circuit(tct, rows, cols, depth, th, device=device).expectation((zmat, [mid])).real
        (g_e,) = torch.autograd.grad(e, th)
        return amp.detach(), g_amp, e.detach(), g_e

    ir_b = grid_circuit(tct, rows, cols, depth, ang_b, device=dev).amplitude_before(bits)
    info_b = ctr.contraction_info(ir_b)
    got = wide(dev)
    want = wide("cpu")
    amp, g_amp, e, g_e = got
    for v in got:
        if not torch.isfinite(torch.view_as_real(v) if v.is_complex() else v).all():
            _fail("phase 15 (b): non-finite result")
    print(f"  (b) {rows}x{cols} grid depth {depth} (n={nb}): {len(ir_b.inputs)} operands, log10[FLOPs] "
          f"{info_b['log10[FLOPs]']:.3f}, log2[largest intermediate] {info_b['log2[SIZE]']:.1f}; amplitude "
          f"{amp.item():.6e}, <Z_{mid}> {e.item():.7f}")
    check("(b) |amplitude - CPU| / |a|", abs(amp.item() - want[0].item()) / abs(want[0].item()), WIDE_RTOL)
    check("(b) max |d|a|^2/dtheta - CPU| / max |CPU|",
          ((g_amp.cpu() - want[1]).abs().max() / want[1].abs().max()).item(), WIDE_RTOL)
    check(f"(b) |<Z_{mid}> - CPU|", abs(e.item() - want[2].item()), WIDE_ATOL)
    check(f"(b) max |d<Z_{mid}>/dtheta - CPU|", (g_e.cpu() - want[3]).abs().max().item(), WIDE_ATOL)
    lap("(b)")

    # (c) sampling past 2^30 amplitudes
    n_g, shots = ghz
    s = ghz_circuit(tct, n_g, device=dev).sample(
        batch=shots, status=np.random.default_rng(15).random((shots, n_g)), format="sample_bin").cpu().numpy()
    ones = int(s[:, 0].sum())
    print(f"  (c) GHZ n={n_g}: {shots} shots, {ones} all-one, {shots - ones} all-zero")
    if s.shape != (shots, n_g) or not np.all(s == s[:, :1]) or ones in (0, shots):
        _fail(f"phase 15 (c): GHZ samples are not all-zero and all-one strings: {s.sum(axis=1)}")
    n_w, depth_w, shots_w = brick
    # timed by events alone: the profiler's digest of the shots' launches
    # took ~40 s of the checks
    got_s, brick_cost = _once(lambda: brickwork_shots(tct, n_w, depth_w, shots_w, dev), dev, profile_it=False)
    want_s = brickwork_shots(tct, n_w, depth_w, shots_w, "cpu") if brick_ref is None else brick_ref()
    print(f"  (c) brickwork n={n_w} depth {depth_w}: {shots_w} shots with a readout error, ones a shot "
          f"{got_s.sum(axis=1).tolist()}")
    if not np.array_equal(got_s, want_s):
        _fail(f"phase 15 (c): {int((got_s != want_s).sum())} bits differ from the CPU path's")
    lap("(c)")

    # (d) DMCircuit2 past its cliff, and its einsum route below it
    n_d, depth_d = dm2
    wires = (3, n_d // 2, n_d - 4)
    mwires = (1, n_d // 2, n_d // 2 + 1, n_d - 2)
    mstatus = np.random.default_rng(17).random(len(mwires))
    dbits = "".join(str(b) for b in np.random.default_rng(18).integers(0, 2, n_d))

    def dm2_values(device):
        cd = noisy_brickwork_dm(tct, n_d, depth_d, device=device)
        return (cd.expectation((zmat, [n_d // 2])).real, cd.probability(*wires),
                cd.measure_jit(*mwires, with_prob=True, status=mstatus), cd.amplitude(dbits).real)

    got_d = dm2_values(dev)
    want_d = dm2_values("cpu")
    print(f"  (d) DMCircuit2 n={n_d} depth {depth_d}: <Z_{n_d // 2}> {got_d[0].item():.7f}, probability{wires} "
          f"{[round(x, 6) for x in got_d[1].tolist()]} (sum {got_d[1].sum().item():.7f}), measure_jit{mwires} "
          f"{got_d[2][0].tolist()} with p {got_d[2][1].item():.6f}, <l|rho|l> {got_d[3].item():.4e}")
    check("(d) |<Z> - CPU|", abs(got_d[0].item() - want_d[0].item()), DM2_ATOL)
    check("(d) max |probability - CPU|", (got_d[1].cpu() - want_d[1]).abs().max().item(), DM2_ATOL)
    check("(d) |sum probability - 1|", abs(got_d[1].sum().item() - 1.0), DM2_ATOL)
    if not torch.equal(got_d[2][0].cpu(), want_d[2][0]):
        _fail(f"phase 15 (d): measure_jit outcomes {got_d[2][0].tolist()} differ from the CPU path's")
    check("(d) |measure_jit p - CPU|", abs(got_d[2][1].item() - want_d[2][1].item()), DM2_ATOL)
    check("(d) |<l|rho|l> - CPU| / CPU", abs(got_d[3].item() - want_d[3].item()) / abs(want_d[3].item()), WIDE_RTOL)
    cs = noisy_brickwork_dm(tct, dm2_small, depth_d, device=dev)
    ops = ((zmat, [dm2_small // 2]), (zmat, [dm2_small // 2 + 1]))
    e_ir = ctr.contract_ir(cs.expectation_before(*ops)).real.item()
    e_dense = cs.expectation(*ops).real.item()
    print(f"  (d) DMCircuit2 n={dm2_small}: <Z Z> einsum route {e_ir:.7f}, dense {e_dense:.7f}")
    check(f"(d) n={dm2_small} |einsum - dense DMCircuit|", abs(e_ir - e_dense), DM2_ATOL)
    lap("(d)")
    print("  wall time of the checks: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return {"ir": ir, "sliced": sliced, "wide": wide, "dm2_values": dm2_values,
            "once": {f"(a) the same, dense state (2^{n}; rz_layer/ry_layer and CZ)": dense_cost,
                     f"(c) brickwork n={n_w} depth {depth_w}, {shots_w} shots with a readout error": brick_cost}}


def _once(fn, dev, profile_it=True):
    """(fn(), cost) of one call: on a card the cost is (ms by CUDA events,
    busy ms under torch.profiler tracing the card alone, peak MiB above the
    start, the top kernels), for a route too long to repeat; None on the
    CPU.  ``profile_it=False`` leaves the profiler out (busy None, no
    kernels): digesting ~150,000 launches costs it tens of seconds."""
    import contextlib

    import torch

    if torch.device(dev).type != "cuda":
        return fn(), None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with (profile(activities=[ProfilerActivity.CUDA]) if profile_it else contextlib.nullcontext()) as prof:
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
    if not profile_it:
        return out, (start.elapsed_time(stop), None, (torch.cuda.max_memory_allocated() - base) / 2**20, [])
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [(e.key, e.self_device_time_total / 1e3, e.count) for e in kernels[:3]]
    return out, (start.elapsed_time(stop), busy, (torch.cuda.max_memory_allocated() - base) / 2**20, top)


def _contraction_phase(tct, card, job):
    """Phase 15, the contraction engine at full width: :func:`_contraction_checks`
    on the card, then each route timed by CUDA events (median of 3 after a
    warm-up) with its busy time under torch.profiler (one call, the card
    alone) and its peak memory above the start."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import contractor as ctr

    dev = torch.device("cuda")
    t0 = time.perf_counter()

    def brick_ref():
        ref, waited = _await_reference(job, "brickwork")
        print(f"  (c) the CPU path's brickwork shots from the child process ({REF_THREADS} threads, "
              f"{ref['seconds']:.1f} s): waited {waited:.1f} s")
        return ref["shots"]

    got = _contraction_checks(tct, dev, brick_ref=brick_ref)
    t1 = time.perf_counter()
    ir, sliced = got["ir"], got["sliced"]
    timed = {
        f"(a) {GRID_A[0]}x{GRID_A[1]} grid depth {GRID_A[2]} amplitude, whole": lambda: ctr.contract_ir(ir).item(),
        f"(a) the same, {2 ** len(sliced)} slices": lambda: ctr.sliced_contract_ir(ir, sliced).item(),
        f"(b) {GRID_B[0]}x{GRID_B[1]} grid depth {GRID_B[2]} (n={GRID_B[0] * GRID_B[1]}), amplitude and <Z>, "
        "values and grads": lambda: got["wide"](dev),
        f"(d) DMCircuit2 n={DM2_N}, <Z>, probability, measure_jit, amplitude": lambda: got["dm2_values"](dev),
    }
    for label, (ms, busy, peak, top) in got["once"].items():
        top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in top)
        busy = "busy not measured" if busy is None else (
            f"busy {busy:.3f} ms ({100 * busy / ms:.1f} %; profiler, the same call)")
        print(f"phase 15 time, {label}: {ms:.3f} ms (CUDA events, one call), {busy}, peak {peak:.1f} MiB above "
              f"the start, {card}; top kernels {top or 'not traced'}")
    for label, fn in timed.items():
        with torch.no_grad() if "grad" not in label else torch.enable_grad():
            ms = _time_ms(fn, reps=3, inner=1, warmup=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            host, busy, by_kernel = _profile(fn, reps=1, cpu=False)
        top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in by_kernel[:3])
        print(f"phase 15 time, {label}: {ms:.3f} ms (CUDA events, median of 3), busy {busy:.3f} ms "
              f"({100 * busy / ms:.1f} %; profiler, one call), peak {peak:.1f} MiB above the start, {card}; "
              f"top kernels {top}")
    print(f"phase 15 wall time: checks {t1 - t0:.1f} s, timing {time.perf_counter() - t1:.1f} s")


#: phase 16, the MPS simulators at full width: (a) the MPS VQE step of
#: examples/mps_vqe_truncated.py's TFIM ansatz at the TEBD path's width
#: (bench.py's n=60, chi=64) and depth 10; (b) the exact regime at n=20,
#: depth 4 (every bond 16 or less) against the dense circuit; (c) 1,024
#: shots of (a)'s updated MPS; (d) DMRG of the n=12 Heisenberg chain and its
#: three consumers; (e) the QuOperator methods at n=8
MPS_SIZES = {"n": 60, "chi": 64, "depth": 10, "n_b": 20, "depth_b": 4, "shots": 1024,
             "n_d": 12, "chi_d": 16, "sweeps_d": 6, "n_e": 8}
#: the CPU references of phases 14, 15 (c), 16 and 17 run in a child process
#: started after phase 11 (the kernels' and the steps' timings), on this
#: many threads, while the card runs phases 12-17
REF_THREADS = 4
#: (a) on the card against the port's CPU path at complex128 (the exact
#: SVD): (|dE|/|E|, max |dgrad|/max |grad|, |dE after the SGD step|/|E
#: after|).  The card truncates with the Gram-eigh SVD, a complex64
#: chain's SVDs and QRs in complex128 (``core/linalg.py``).  Set from the
#: CPU path's own drift at full width, run on the card machine's CPU
#: (``tools/mps_gram_drift.py``, 8 threads; PERF.md, PR 21): the Gram
#: route at complex128 5.1e-12, 3.3e-8 and 2.2e-11, at complex64 4.6e-7,
#: 7.0e-6 and 1.4e-7 (the exact SVD's gradient equal to a central
#: difference to 1e-9 at the angle where the two routes differ most);
#: each tolerance is about 10-200x its drift
MPS_TOL = {"complex128": (1e-9, 1e-6, 1e-9), "complex64": (1e-5, 1e-4, 1e-5)}
#: (a)'s gradient on the card against the CPU path's Gram route at
#: complex128: the two Gram routes differ only in their eigh's rounding,
#: no more than the Gram route from the exact SVD on the CPU (3.3e-8 and
#: 7.0e-6 above; PR 21's card run: 2.2e-8 at complex128, 2.6e-6 at
#: complex64, the complex64 chain decomposed in complex128)
MPS_GRAM_GRAD_TOL = {"complex128": 1e-6, "complex64": 1e-4}
#: (c) the entropy and rho of (a)'s evaluated MPS at complex128 against
#: the CPU path: the two SVDs' states agree to ~1e-11 in energy
MPS_STATE_TOL = 1e-6
#: (b) the exact regime, MPS against the dense circuit on the card, both
#: complex64: |dE| and max |dgrad|
MPS_EXACT_ATOL = 1e-4
#: (c) a shot's outcome may leave the float64 cdf interval of the CPU
#: path's chain by this much (phase 13's bracket rule)
MPS_BRACKET_TOL = 1e-6
#: (d) DMRG on the card against the CPU path; against the exact ground
#: energy (examples/dmrg_ground_state.py's bound); the dense <H> of
#: Circuit(mps_inputs=) against the DMRG energy
DMRG_ATOL = 1e-8
DMRG_EXACT_ATOL = 1e-3
DMRG_DENSE_ATOL = 1e-6
#: (e) the QuOperator methods on the card against the CPU path, complex64
QOP_ATOL = 1e-5
#: (e)'s 3-site gate for the mpo method: exp(-i 0.4 Z X Z)
MPO_GATE = np.cos(0.4) * np.eye(8) - 1j * np.sin(0.4) * np.kron(
    np.kron(np.diag([1.0, -1.0]), [[0.0, 1.0], [1.0, 0.0]]), np.diag([1.0, -1.0]))


def mps_vqe_angles(n, depth, seed=42):
    """examples/mps_vqe_truncated.py's angles: (depth, 2, n) normals x 0.1."""
    return np.random.default_rng(seed).normal(size=(depth, 2, n)) * 0.1


def mps_vqe_circuit(mod, p, n, chi, **kw):
    """The TFIM ansatz on an ``MPSCircuit`` with bond cap ``chi``: h on each
    qubit, then each layer l rzz(p[l, 1, i]) on the n-1 bonds and
    rx(p[l, 0, i]) on each qubit."""
    c = mod.MPSCircuit(n, split={"max_singular_values": chi}, **kw)
    for i in range(n):
        c.h(i)
    for l in range(p.shape[0]):
        for i in range(n - 1):
            c.rzz(i, i + 1, theta=p[l, 1, i])
        for i in range(n):
            c.rx(i, theta=p[l, 0, i])
    return c


def tfim_energy_ps(c, n):
    """Σ <Z_i Z_i+1> - Σ <X_i> through ``expectation_ps`` (2n-1 terms)."""
    e = 0.0
    for i in range(n - 1):
        e = e + c.expectation_ps(z=[i, i + 1]).real
    for i in range(n):
        e = e - c.expectation_ps(x=[i]).real
    return e


def dense_vqe_energy(mod, p, n, **kw):
    """The same ansatz and energy on the dense ``Circuit``: ``h_layer`` and a
    ``zzrx_layer`` a layer (rzz and the layer's zz share exp(-i θ/2 ZZ))."""
    c = mod.Circuit(n, **kw)
    c.h_layer()
    pairs = [(i, i + 1) for i in range(n - 1)]
    for l in range(p.shape[0]):
        c.zzrx_layer(pairs, p[l, 1, : n - 1], p[l, 0])
    return c.expectation_zzx_energy(pairs, 1.0, -1.0)


def heisenberg_energy_ps(c, n):
    """Σ <X_i X_i+1 + Y_i Y_i+1 + Z_i Z_i+1> through ``expectation_ps``."""
    e = 0.0
    for i in range(n - 1):
        for key in ("x", "y", "z"):
            e = e + c.expectation_ps(**{key: [i, i + 1]}).real
    return e


def heisenberg_ground(n):
    """The exact ground energy of the open Heisenberg chain (xxz_mpo(n, 1.0))
    from numpy's eigvalsh of its dense 2^n x 2^n matrix."""
    idx = np.arange(2**n)
    h = np.zeros((2**n, 2**n))
    for i in range(n - 1):
        a, b = n - 1 - i, n - 2 - i
        differ = ((idx >> a) & 1) != ((idx >> b) & 1)
        h[idx, idx] += np.where(differ, -1.0, 1.0)
        h[(idx ^ (1 << a) ^ (1 << b))[differ], idx[differ]] += 2.0  # XX + YY on |01>, |10>
    return float(np.linalg.eigvalsh(h)[0])


def mps_bracket_miss(chain, bits, status, d=2):
    """How far the uniforms (+ the tie-break) of MPS shots lie outside the
    float64 cdf intervals of their outcomes, each step's conditional taken
    on the right-canonical ``chain`` (complex128) given the shot's earlier
    outcomes: at most 0 where every outcome is the float64 one."""
    import torch

    bits = torch.as_tensor(np.asarray(bits), dtype=torch.int64)
    status = np.asarray(status, dtype=np.float64)
    rows = torch.arange(bits.shape[0])
    v, miss = None, -np.inf
    for k, t in enumerate(chain):
        t = t.to(torch.complex128)
        m = t[0].expand(bits.shape[0], *t[0].shape) if v is None else torch.einsum("sb,bdc->sdc", v, t)
        w = torch.sum(torch.abs(m) ** 2, dim=2)
        cdf = torch.cumsum(w / torch.sum(w, dim=1, keepdim=True), dim=1).numpy()
        o = bits[:, k].numpy()
        u = status[:, k] + MEASURE_EPS
        lo = np.where(o > 0, cdf[np.arange(len(o)), np.maximum(o - 1, 0)], 0.0)
        miss = max(miss, float(np.max(np.maximum(lo - u, u - cdf[np.arange(len(o)), o]))))
        row = m[rows, bits[:, k]]
        v = row / torch.linalg.vector_norm(row, dim=1, keepdim=True).to(row.dtype)
    return miss


def mps_vqe_step(tct, dev, g0, n, chi):
    """(a): the energy and its gradient in the angles, one SGD step, and the
    energy after it, in the configured dtype on ``dev``; returns (E, grad,
    E after, the evaluated circuit, the updated circuit)."""
    import torch

    p = torch.as_tensor(g0, device=dev).to(getattr(torch, tct.config.rdtypestr())).requires_grad_()
    c0 = mps_vqe_circuit(tct, p, n, chi, device=dev)
    e = tfim_energy_ps(c0, n)
    (g,) = torch.autograd.grad(e, p)
    c0._tensors = [t.detach() for t in c0._tensors]
    with torch.no_grad():
        c1 = mps_vqe_circuit(tct, p - LR * g, n, chi, device=dev)
        e1 = tfim_energy_ps(c1, n)
    return e.detach(), g, e1, c0, c1


def mps_status(shots, n, seed=7):
    return np.random.default_rng(seed).uniform(size=(shots, n))


def _mps_reference(tct, n, chi, depth, n_b, depth_b, shots, n_d, chi_d, sweeps_d, n_e, drift=True, log=None):
    """Phase 16's references on the port's CPU path: (a) at complex128 with
    the exact SVD, its evaluated chain (right-canonical) and its shots, the
    entropy and ρ of (c), (a) again on the Gram route at complex128 (the
    card's route), DMRG (d) and the exact ground energy; with ``drift``, (a) on the
    Gram route at complex64 and with the exact SVD at complex64 too, each
    passed to ``log`` as it ends.  Returns a dict of CPU tensors and
    numbers."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import linalg

    ref = {}
    g0 = mps_vqe_angles(n, depth)
    t0 = time.perf_counter()
    saved = linalg.USE_GRAM_SVD
    try:
        linalg.USE_GRAM_SVD = False
        with tct.set_dtype("complex128"):
            e, g, e1, c0, c1 = mps_vqe_step(tct, "cpu", g0, n, chi)
            ref.update(e=e.item(), g=g, e1=e1.item(), bonds=c1.get_bond_dimensions())
            with torch.no_grad():
                ref["chain"] = c0._right_canonical()
                ref["bits"] = c0.sample(shots, status=mps_status(shots, n), format="sample_bin")
                ref["entropy"] = c0.entanglement_entropy(n // 2).item()
                ref["rho"] = c0.reduced_density_matrix([n // 2 - 1, n // 2])
        ref["seconds (a)"] = time.perf_counter() - t0
        if log:
            log(f"exact complex128: E {ref['e']:.12f}, E after {ref['e1']:.12f} ({ref['seconds (a)']:.1f} s)")
        routes = [("gram128", True, "complex128")]
        if drift:
            routes += [("gram64", True, "complex64"), ("exact64", False, "complex64")]
        for route, gram, dtype in routes:
            t0 = time.perf_counter()
            linalg.USE_GRAM_SVD = gram
            with tct.set_dtype(dtype):
                e, g, e1, _, _ = mps_vqe_step(tct, "cpu", g0, n, chi)
            ref[f"drift {route}"] = _mps_errors(ref, e.item(), g, e1.item())
            ref[f"g {route}"] = g.detach()
            ref[f"seconds {route}"] = time.perf_counter() - t0
            if log:
                log(f"{route}: |dE|/|E|, max |dgrad|/max |grad|, |dE after|/|E after| = "
                    f"{ref[f'drift {route}']} ({ref[f'seconds {route}']:.1f} s)")
    finally:
        linalg.USE_GRAM_SVD = saved
    t0 = time.perf_counter()
    e_d, a_d = tct.dmrg.dmrg(tct.dmrg.xxz_mpo(n_d, 1.0), chi=chi_d, sweeps=sweeps_d, device="cpu")
    ref["dmrg"] = e_d
    ref["seconds (d)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref["ground"] = heisenberg_ground(n_d)
    ref["seconds ground"] = time.perf_counter() - t0
    return ref


def _mps_errors(ref, e, g, e1):
    """(|dE|/|E|, max |dgrad|/max |grad|, |dE after|/|E after|) against ``ref``."""
    gr = ref["g"]
    dg = (g.detach().cpu().to(gr.dtype) - gr).abs().max().item() / gr.abs().max().item()
    return abs(e - ref["e"]) / abs(ref["e"]), dg, abs(e1 - ref["e1"]) / abs(ref["e1"])


def _reference_child(out):
    """``python3 chip_smoke.py --references DIR``: the port's CPU path of
    phase 14 (:func:`_noise_reference`), then phase 15 (c)'s brickwork
    shots, then :func:`_mps_reference` at phase 16's full sizes, then
    :func:`_hamiltonian_values` at phase 17's, then
    :func:`_transform_reference` at phase 18's, then :func:`_stab_reference`
    at phase 19's, then :func:`_slice_reference` at phase 20's, then
    :func:`_apps_reference` at phase 24's, each saved
    (torch.save) into
    DIR as it ends (:data:`REFERENCES`).  The Gram-against-exact drift is left to
    ``tools/mps_gram_drift.py``: three more runs of (a) on the CPU would
    crowd phases 12-16."""
    import torch

    torch.set_num_threads(REF_THREADS)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import tensorcircuit_ng_tpu_torch as tct

    def save(name, value):
        path = os.path.join(out, REFERENCES[name])
        torch.save(value, path + ".part")
        os.replace(path + ".part", path)

    with tct.set_device("cpu"):
        save("noise", _noise_reference(tct))
        t0 = time.perf_counter()
        shots = brickwork_shots(tct, BRICK_N, BRICK_DEPTH, BRICK_SHOTS, "cpu")
        save("brickwork", {"shots": shots, "seconds": time.perf_counter() - t0})
        save("mps", _mps_reference(tct, **MPS_SIZES, drift=False))
        t0 = time.perf_counter()
        ham = _hamiltonian_values(tct, "cpu", **HAM_SIZES)
        save("ham", {**ham, "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        transform = _transform_reference(tct, **TRANSFORM_SIZES)
        save("transform", {**transform, "seconds": time.perf_counter() - t0})
        save("stab", _stab_reference(tct, **STAB_SIZES))
        save("slice", _slice_reference(tct, **SLICE_SIZES))
        save("apps", _apps_reference(tct, **APPS_SIZES))
    return 0


def _mps_checks(tct, dev, ref, counters=(), n=60, chi=64, depth=10, n_b=20, depth_b=4, shots=1024, n_d=12,
                chi_d=16, sweeps_d=6, n_e=8):
    """Phase 16's checks (a)-(e) on ``dev`` against ``ref``
    (:func:`_mps_reference` of the same sizes; on the CPU the two paths are
    one), or against ``ref()`` once (a)'s steps on ``dev`` have run.
    Returns what the timings reuse."""
    import torch

    card = torch.device(dev).type == "cuda"
    spent = {}
    last = [time.perf_counter()]

    def lap(key):
        now = time.perf_counter()
        spent[key], last[0] = now - last[0], now

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 16, {label}: {err} > {tol}")

    print("MPS simulators:")
    # (a) the MPS VQE step at n, chi: complex128 and complex64 on dev
    g0 = mps_vqe_angles(n, depth)
    out, once = {}, {}
    for dtype in ("complex128", "complex64"):
        with tct.set_dtype(dtype):
            # the complex64 step is the timed one (one call; on a card by
            # events and peak memory: the profiler's digest of its ~300,000
            # launches took ~190 s, so its busy share stands in the update's
            # and the shots' lines)
            out[dtype], cost = _once(lambda: mps_vqe_step(tct, dev, g0, n, chi), dev, profile_it=False)
        if dtype == "complex64" and cost:
            once[f"(a) value, grad and the energy after the SGD step, n={n} chi={chi} depth {depth}, "
                 "complex64"] = cost
    if callable(ref):
        ref = ref()
    for key in sorted(k for k in ref if k.startswith("drift ")):
        de, dg, de1 = ref[key]
        print(f"  CPU path, {key[6:]} against exact complex128: |dE|/|E| {de:.3e}, max |dgrad|/max |grad| "
              f"{dg:.3e}, |dE after|/|E after| {de1:.3e} ({ref['seconds ' + key[6:]]:.1f} s)")
    for dtype in ("complex128", "complex64"):
        e, g, e1 = out[dtype][:3]
        de, dg, de1 = _mps_errors(ref, e.item(), g, e1.item())
        if not (np.isfinite(e.item()) and torch.isfinite(g).all() and e1.item() < e.item()):
            _fail(f"phase 16 (a) {dtype}: E {e.item()}, E after {e1.item()}: non-finite or not lowered")
        print(f"  (a) n={n} chi={chi} depth {depth}, {dtype}: E {e.item():.10f}, E after the step "
              f"{e1.item():.10f} (CPU complex128 {ref['e']:.10f}, {ref['e1']:.10f})")
        labels = ("|dE|/|E|", "max |dgrad|/max |grad|", "|dE after|/|E after|")
        for label, err, tol in zip(labels, (de, dg, de1), MPS_TOL[dtype]):
            check(f"(a) {dtype} {label} against the CPU path's exact SVD", err, tol)
        gg = ref["g gram128"]
        check(f"(a) {dtype} max |dgrad|/max |grad| against the CPU path's Gram route",
              (g.detach().cpu().to(gg.dtype) - gg).abs().max().item() / gg.abs().max().item(), MPS_GRAM_GRAD_TOL[dtype])
    bonds = out["complex128"][4].get_bond_dimensions()
    print(f"  (a) bond dimensions {bonds}")
    if bonds != ref["bonds"] or bonds[n // 2 - 1] != min(chi, 2**depth, 2 ** (n // 2)):
        _fail(f"phase 16 (a): bond dimensions {bonds}, the CPU path's {ref['bonds']}")
    lap("(a)")

    # (b) the exact regime: the MPS energy and gradient against the dense
    # circuit of the same gates (K2/K4 on the card)
    gb = mps_vqe_angles(n_b, depth_b, seed=43)
    with tct.set_dtype("complex64"):
        p_m = torch.as_tensor(gb, device=dev).to(torch.float32).requires_grad_()
        c_b = mps_vqe_circuit(tct, p_m, n_b, chi, device=dev)
        e_m = tfim_energy_ps(c_b, n_b)
        (g_m,) = torch.autograd.grad(e_m, p_m)
        p_d = torch.as_tensor(gb, device=dev).to(torch.float32).requires_grad_()
        _reset(counters)
        e_dn = dense_vqe_energy(tct, p_d, n_b, device=dev)
        (g_dn,) = torch.autograd.grad(e_dn, p_d)
    launched = _launched(counters)
    if card and counters and not all(launched.get(k, 0) for k in ("grand_zzrx_fwd", "grand_zzrx_bwd")):
        _fail(f"phase 16 (b): K2/K4 not launched by the dense side ({launched})")
    print(f"  (b) n={n_b} depth {depth_b}: bonds {c_b.get_bond_dimensions()}, MPS E {e_m.item():.7f}, "
          f"dense E {e_dn.item():.7f}; the dense side launched {launched}")
    if max(c_b.get_bond_dimensions()) > 2**depth_b:
        _fail(f"phase 16 (b): bonds {c_b.get_bond_dimensions()} past 2^{depth_b}")
    check("(b) |E MPS - E dense|", abs(e_m.item() - e_dn.item()), MPS_EXACT_ATOL)
    check("(b) max |grad MPS - grad dense|", (g_m - g_dn).abs().max().item(), MPS_EXACT_ATOL)
    lap("(b)")

    # (c) shots of (a)'s evaluated MPS, its entropy and a two-site rho
    status = mps_status(shots, n)
    with tct.set_dtype("complex128"), torch.no_grad():
        c128 = out["complex128"][3]
        bits = c128.sample(shots, status=status, format="sample_bin")
        entropy = c128.entanglement_entropy(n // 2).item()
        rho = c128.reduced_density_matrix([n // 2 - 1, n // 2])
    same = int((bits.cpu() == ref["bits"]).all(dim=1).sum())
    miss = mps_bracket_miss(ref["chain"], bits.cpu(), status)
    print(f"  (c) {shots} shots at complex128: {same} equal to the CPU path's, bracket miss {miss:.3e}")
    check("(c) bracket miss on the CPU path's chain", miss, MPS_BRACKET_TOL)
    check("(c) |entropy - CPU|", abs(entropy - ref["entropy"]), MPS_STATE_TOL)
    check("(c) max |rho - CPU|", (rho.cpu() - ref["rho"]).abs().max().item(), MPS_STATE_TOL)
    c64 = out["complex64"][3]
    with tct.set_dtype("complex64"), torch.no_grad():
        bits64 = c64.sample(shots, status=status, format="sample_bin").cpu().numpy()
        worst = 0.0
        for i in range(n - 1):
            zz = c64.expectation_ps(z=[i, i + 1]).real.item()
            est = float(np.mean((1 - 2 * bits64[:, i]) * (1 - 2 * bits64[:, i + 1])))
            worst = max(worst, abs(est - zz) / max(np.sqrt((1 - zz * zz) / shots), 1e-3))
    print(f"  (c) {shots} shots at complex64: <Z_i Z_i+1> from the shots, the largest |shots - exact| / sigma "
          f"{worst:.2f}")
    check("(c) complex64 <ZZ> from the shots, in sigma", worst, 5.0)
    lap("(c)")

    # (d) DMRG of the Heisenberg chain, and its tensors' three consumers
    (e_d, a_d), cost = _once(lambda: tct.dmrg.dmrg(tct.dmrg.xxz_mpo(n_d, 1.0), chi=chi_d, sweeps=sweeps_d,
                                                   device=dev), dev)
    if cost:
        once[f"(d) DMRG n={n_d} chi={chi_d}, {sweeps_d} sweeps"] = cost
    print(f"  (d) DMRG n={n_d} chi={chi_d} {sweeps_d} sweeps: {e_d:.12f} (CPU {ref['dmrg']:.12f}, exact "
          f"{ref['ground']:.12f})")
    check("(d) |E - CPU|", abs(e_d - ref["dmrg"]), DMRG_ATOL)
    check("(d) |E - exact|", abs(e_d - ref["ground"]), DMRG_EXACT_ATOL)
    z = np.diag([1.0, -1.0])
    with tct.set_dtype("complex128"):
        m_d = tct.MPSCircuit(n_d, tensors=a_d, device=dev)
        check("(d) |MPSCircuit(tensors=) <H> - E|", abs(heisenberg_energy_ps(m_d, n_d).item() - e_d), DMRG_ATOL)
        corr = torch.stack(tct.FiniteMPS(a_d, device=dev).measure_two_body_correlator(z, z, n_d // 2 - 1,
                                                                                      range(n_d)))
        c_d = tct.Circuit(n_d, mps_inputs=a_d, device=dev)
        check("(d) |Circuit(mps_inputs=) <H> - E|", abs(heisenberg_energy_ps(c_d, n_d).item() - e_d), DMRG_DENSE_ATOL)
        dense = torch.stack([c_d.expectation_ps(z=[n_d // 2 - 1, j]) if j != n_d // 2 - 1
                             else torch.ones((), dtype=corr.dtype, device=corr.device) for j in range(n_d)])
        check("(d) max |FiniteMPS <Z Z_j> - dense|", (corr - dense).abs().max().item(), DMRG_ATOL)
    lap("(d)")

    # (e) the QuOperator methods, against the CPU path
    got, want = _qop_values(tct, dev, n_e), _qop_values(tct, "cpu", n_e)
    for key in want:
        check(f"(e) {key}, max |card - CPU|", (got[key].cpu() - want[key]).abs().max().item(), QOP_ATOL)
    for key, (a, b) in _qop_pairs(got).items():
        check(f"(e) {key}", (a - b).abs().max().item(), QOP_ATOL)
    lap("(e)")
    print("  wall time of the checks: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return {"c128": out["complex128"][3], "c64": c64, "status": status, "once": once}


def _qop_circuit(tct, n, dev, cls="Circuit", **kw):
    rng = np.random.default_rng(5)
    c = getattr(tct, cls)(n, device=dev, **kw)
    for i in range(n):
        c.ry(i, theta=float(rng.normal()))
    for i in range(n - 1):
        c.cnot(i, i + 1)
    c.rzz(0, n - 1, theta=0.4)
    return c


def _qop_values(tct, dev, n):
    """(e)'s readouts on ``dev``: the QuVector and QuOperator of a circuit,
    the mpo method with a 3-site MPO, DMCircuit's QuOperator and its
    mps_inputs, the QuOperator algebra; each a tensor."""
    import torch

    qu = tct.quantum
    c = _qop_circuit(tct, n, dev)
    mpo = [t.numpy() for t in tct.MPSCircuit(3, device="cpu").gate_to_mpo(MPO_GATE, 3)]
    cm = _qop_circuit(tct, n, dev)
    cm.mpo(1, 2, 3, mpo=mpo)
    ca = _qop_circuit(tct, n, dev)
    ca.any(1, 2, 3, unitary=MPO_GATE)
    m = tct.MPSCircuit(n, device=dev)
    for i in range(n):
        m.ry(i, theta=0.3 * i + 0.1)
    m.cnot(0, 1)
    m.rzz(2, 5 % n, theta=0.7)
    dm = _qop_circuit(tct, min(n, 6), dev, cls="DMCircuit")
    dm.depolarizing(0, px=0.05, py=0.05, pz=0.05)
    qv = c.get_quvector()
    qo = c.get_quoperator()
    rho = qv.projector()
    op = qu.QuOperator.from_tensor(torch.as_tensor([[0.0, 1.0], [1.0, 0.0]], device=dev))
    big = op | qu.identity((2,) * (n - 1), device=dev)
    return {
        "quvector": qv.eval().reshape(-1),
        "quoperator": qo.eval_matrix(),
        "mpo state": cm.state(),
        "any state": ca.state(),
        "dm quoperator": dm.get_dm_as_quoperator().eval_matrix(),
        "dm mps_inputs": tct.DMCircuit(n, mps_inputs=m, device=dev).densitymatrix(),
        "dm dense inputs": tct.DMCircuit(n, inputs=m.wavefunction(), device=dev).densitymatrix(),
        "<psi|X_0|psi>": (qv.adjoint() @ big @ qv).eval().reshape(1),
        "partial trace": rho.partial_trace(list(range(2, n))).eval_matrix(),
        "state": c.state(),
        "matrix": c.matrix(),
        "<X_0>": c.expectation_ps(x=[0]).reshape(1).to(torch.complex64),
    }


def _qop_pairs(v):
    """(e)'s identities within one path: each pair should agree."""
    return {
        "QuVector against state()": (v["quvector"], v["state"]),
        "QuOperator against matrix()": (v["quoperator"], v["matrix"]),
        "mpo(tn2qop MPO) against any(matrix)": (v["mpo state"], v["any state"]),
        "DMCircuit(mps_inputs=) against DMCircuit(inputs=dense)": (v["dm mps_inputs"], v["dm dense inputs"]),
        "<psi|X_0 (x) I|psi> against expectation_ps": (v["<psi|X_0|psi>"].to(v["<X_0>"].dtype), v["<X_0>"]),
    }


#: the files of the CPU references' child process, under build/
REFERENCES = {"noise": "phase14_reference.pt", "brickwork": "phase15_brickwork.pt", "mps": "phase16_reference.pt",
              "ham": "phase17_reference.pt", "transform": "phase18_reference.pt", "stab": "phase19_reference.pt",
              "slice": "phase20_reference.pt", "apps": "phase24_reference.pt"}
#: the longest a phase waits for one of them
REF_TIMEOUT = 600


def _start_references(here):
    """Start :func:`_reference_child` in a child process that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty), its output in
    ``build/references.log``; killed at exit if still running.  Returns
    (the process, the directory of its results, the log's path)."""
    import atexit

    out = os.path.join(here, "build")
    os.makedirs(out, exist_ok=True)
    for name in REFERENCES.values():
        if os.path.exists(os.path.join(out, name)):
            os.remove(os.path.join(out, name))
    log = os.path.join(out, "references.log")
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--references", out], cwd=here,
                                stdout=fh, stderr=subprocess.STDOUT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, log


def _await_reference(job, name):
    """(the child's ``name`` result, the seconds waited for it); fails if
    the child ends without it or it takes longer than :data:`REF_TIMEOUT`."""
    import torch

    proc, out, log = job
    path = os.path.join(out, REFERENCES[name])
    t0 = time.perf_counter()
    while not os.path.exists(path) and proc.poll() is None and time.perf_counter() - t0 < REF_TIMEOUT:
        time.sleep(0.1)
    waited = time.perf_counter() - t0
    if not os.path.exists(path):
        rc = proc.poll()
        if rc is None:
            proc.kill()
            rc = "killed at the time limit"
        with open(log) as fh:
            print(fh.read()[-4000:])
        _fail(f"the CPU references' process ended with {rc} before its {name} result")
    return torch.load(path, weights_only=False), waited


def _mps_phase(tct, card, counters, job):
    """Phase 16, the MPS simulators at full width: :func:`_mps_checks` on
    the card (its complex64 step of (a) and its DMRG sweeps timed once,
    inside the checks) against the CPU references of the child process of
    :func:`_start_references`, waited for after (a)'s steps on the card;
    then a two-site update on each SVD route and the shots, each by CUDA
    events with its busy time under torch.profiler (the card alone) and
    its peak memory above the start."""
    import torch

    from tensorcircuit_ng_tpu_torch.core import linalg

    wait = {}

    def reference():
        ref, wait["s"] = _await_reference(job, "mps")
        print(f"phase 16 CPU references (the child process, {REF_THREADS} threads, beside phases 12-16): waited "
              f"{wait['s']:.1f} s after (a)'s steps on the card; "
              + ", ".join(f"{k[8:]} {v:.1f} s" for k, v in ref.items() if k.startswith("seconds ")))
        return ref

    dev = torch.device("cuda")
    t1 = time.perf_counter()
    got = _mps_checks(tct, dev, reference, counters, **MPS_SIZES)
    t2 = time.perf_counter()
    n, chi = MPS_SIZES["n"], MPS_SIZES["chi"]
    for label, (ms, busy, peak, top) in got["once"].items():
        top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in top)
        busy = "busy not measured" if busy is None else (
            f"busy {busy:.3f} ms ({100 * busy / ms:.1f} %; profiler, the same call)")
        print(f"phase 16 time, {label}: {ms:.3f} ms (CUDA events, one call), {busy}, peak {peak:.1f} MiB above "
              f"the start, {card}; top kernels {top or 'not traced'}")
    c128 = got["c128"].copy()
    rzz = tct.gates.rzz_matrix(0.3).astype(np.complex128)
    status = torch.as_tensor(got["status"], device=dev)
    saved = linalg.USE_GRAM_SVD
    timed = {}
    for route, gram in (("Gram-eigh", True), ("exact", False)):
        def update(gram=gram):
            linalg.USE_GRAM_SVD = gram
            try:
                c128.apply_adjacent_double_gate(rzz, n // 2 - 1, n // 2)
            finally:
                linalg.USE_GRAM_SVD = saved
        timed[f"(a) one two-site update at bond {n // 2} (chi={chi}), {route} SVD, complex128"] = update
    timed[f"(c) {MPS_SIZES['shots']} shots of (a)'s MPS, complex64"] = lambda: got["c64"].sample(
        MPS_SIZES["shots"], status=status)
    with torch.no_grad():
        for label, fn in timed.items():
            ms = _time_ms(fn, reps=10, inner=2, warmup=2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            host, busy, by_kernel = _profile(fn, reps=4, cpu=False)
            top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in by_kernel[:3])
            print(f"phase 16 time, {label}: {ms:.3f} ms (CUDA events, median of 10), busy {busy:.3f} ms "
                  f"({100 * busy / ms:.1f} %; profiler, 4 calls), peak {peak:.1f} MiB above the start, {card}; "
                  f"top kernels {top}")
    print(f"phase 16 wall time: checks {t2 - t1:.1f} s (of which waiting {wait['s']:.1f} s), timing "
          f"{time.perf_counter() - t2:.1f} s")


#: phase 17, the Hamiltonians and the QI toolbox at full width (no kernel
#: of their own): (a) the TFIM Hamiltonian of the training path at n=20 as
#: a COO matrix and as a matrix-free product on its L=4 state (K2 forward;
#: the state's adjoint walks K3 a layer, the matrix-level boundary: K4
#: serves the fused energy's angle-level one); (b) the Heisenberg model of the 4x5 grid on the same
#: state; (c) the dense TFIM at n=12; (d) the QI toolbox on the n=20
#: state: the density matrix of qubits 0-9, its entropies, mutual
#: information, negativity and distances, the Gibbs state of the n=10 TFIM
#: and the stabilizer Renyi entropy of the n=12 state; (e) the QAOA ansatz
#: of phase 9's MaxCut graph (n=20, p=4) against its term-by-term energy
HAM_SIZES = {"n": 20, "nl": L, "grid": (4, 5), "n_dense": 12, "n_gibbs": 10, "qaoa": (20, QAOA_P)}
#: the same checks at a CPU test's size
HAM_SMALL = {"n": 8, "nl": 2, "grid": (2, 4), "n_dense": 6, "n_gibbs": 4, "qaoa": (8, 2)}
#: (a), (b), (e): an energy and its gradient on one device against another
#: route to it (the fused ZZ - X energy, the term-by-term sums) and against
#: the CPU path, complex64 (phase 12's ENERGY_ATOL and GRAD_ATOL)
HAM_ATOL = 1e-4
#: (c) the dense matrix's <H> against the COO route's at n=12, one device
HAM_DENSE_ATOL = 1e-5
#: (d) each QI quantity on the card against the CPU path.  Set from the CPU
#: path's complex64 against its complex128 at full width
#: (``tools/qi_drift.py``; PERF.md, PR 21): the density matrix 8.4e-10, the
#: entropy 5.2e-5, the Renyi-2 entropy 4.3e-7, the mutual information
#: 4.8e-5, the entropy's gradient 3.5e-7 (largest entry 0.35), the Gibbs
#: state 8.5e-8, the SRE 7.7e-8: about 10x each.  The free energy's 1.7e-6
#: understated the card: its -S/beta is a complex64 eigvalsh entropy of a
#: 1024^2 Gibbs state whose smallest eigenvalues (e^-20 of the largest)
#: are rounding, and the card was 5.1e-5 off the CPU path (PERF.md, PR 21
#: run 2): held to the entropy's 1e-3.
#: The half-chain density matrix is nearly pure (two eigenvalues above
#: 1e-6), and past its rank a complex64 matrix's spectrum is rounding: a
#: complex64 eigvalsh moves the negativity by 1.7e-2 and the fidelity by
#: 6.9e-2, and even in complex128 the complex64 rho's own rounding moved
#: the card's fidelity 5.5e-5 from the CPU path's (110x that route's CPU
#: drift).  So the negativities, fidelity and trace distance take the
#: density matrix of the state in complex128: 9.6e-9, 1.6e-8, 6.5e-9 and
#: 2.1e-8 of drift, each held to 1e-5
QI_TOL = {"rho": 1e-6, "entropy": 1e-3, "renyi": 1e-5, "mutual": 1e-3, "negativity": 1e-5, "log_negativity": 1e-5,
          "fidelity": 1e-5, "trace_distance": 1e-5, "gibbs": 1e-6, "free_energy": 1e-3, "sre": 1e-6,
          "entropy_grad": 1e-5}


def _digest(t):
    """sha256 of a COO tensor's index and value bytes (coalesced order)."""
    import hashlib

    h = hashlib.sha256(t.indices().cpu().numpy().tobytes())
    h.update(t.values().cpu().resolve_conj().numpy().tobytes())
    return h.hexdigest()


def _qaoa_ising(qn, qp):
    """Phase 9's MaxCut graph (:func:`qaoa_graph`) as a networkx graph,
    its Z-string structures and weights, and its start angles interleaved
    (γ_1, β_1, ...) for ``QAOA_ansatz_for_Ising``."""
    import networkx as nx

    edges, params = qaoa_graph(qn, qp)
    g = nx.Graph()
    for i in range(qn):
        g.add_node(i, weight=0.0)
    structures, weights = [], []
    for a, b, w in edges:
        g.add_edge(a, b, weight=w)
        s = [0] * qn
        s[a] = s[b] = 3
        structures.append(s)
        weights.append(w)
    return g, structures, weights, np.stack([params[:qp], params[qp:]], axis=1).reshape(-1)


def _hamiltonian_values(tct, dev, counters=(), n=20, nl=L, grid=(4, 5), n_dense=12, n_gibbs=10, qaoa=(20, QAOA_P)):
    """Phase 17's quantities on ``dev`` (complex64), each moved to the
    CPU: the readouts (a)-(e) checks compare, and the launches of (a).
    On a card the COO build's peak memory above the start is measured."""
    import torch

    qu, tm = tct.quantum, tct.templates
    card = torch.device(dev).type == "cuda"
    out = {}
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1  # bench.py's parameters
    pairs = [(i, i + 1) for i in range(n - 1)]

    def cpu(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) else x

    # (a) the COO build, its <H> and gradient, the matrix-free product's
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    h = tm.hamiltonians.tfim_hamiltonian(n, device=dev)
    if card:
        torch.cuda.synchronize()
        out["coo peak MiB"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    out["nnz"], out["digest"] = h.values().numel(), _digest(h)
    mvp = qu.PauliStringSum2MVP(*tfim_pauli_strings(n))
    for route, ham in (("coo", h), ("mvp", mvp), ("fused", None)):
        p = tct.convert.params(g0, dev).requires_grad_()
        _reset(counters)
        c = tfim_circuit(tct, p, n, nl, device=dev)
        e = (c.expectation_zzx_energy(pairs, 1.0, -1.0) if ham is None
             else tm.measurements.operator_expectation(c, ham))
        (g,) = torch.autograd.grad(e, p)
        out[f"e {route}"], out[f"g {route}"], out[f"launched {route}"] = e.item(), cpu(g), _launched(counters)
        if ham is None:
            p1 = (p - LR * g).detach()
    # (b) the 2D Heisenberg model on the same state
    with torch.no_grad():
        c = tfim_circuit(tct, tct.convert.params(g0, dev), n, nl, device=dev)
        lattice = tm.graphs.Grid2DCoord(*grid).lattice_graph(pbc=False)
        hb = tm.hamiltonians.heisenberg_hamiltonian(lattice, device=dev)
        out["heisenberg nnz"] = hb.values().numel()
        out["e heisenberg coo"] = tm.measurements.operator_expectation(c, hb).item()
        out["e heisenberg terms"] = tm.measurements.heisenberg_measurements(c, lattice).item()
        psi, psi1 = c.state(), tfim_circuit(tct, p1, n, nl, device=dev).state()
        # (c) the dense TFIM at n_dense, against its COO
        ls, ws = tfim_pauli_strings(n_dense)
        dense, coo = qu.PauliStringSum2Dense(ls, ws, device=dev), qu.PauliStringSum2COO(ls, ws, device=dev)
        out["dense equal"] = bool(torch.equal(dense, tct.backend.to_dense(coo)))
        c12 = tfim_circuit(tct, tct.convert.params(g0[:, :, :n_dense], dev), n_dense, nl, device=dev)
        out["e dense"] = tm.measurements.operator_expectation(c12, dense).item()
        out["e dense coo"] = tm.measurements.operator_expectation(c12, coo).item()
        # (d) the QI toolbox on the n-qubit state
        half = n // 2
        rho = qu.reduced_density_matrix(psi, subsystem_to_keep=list(range(half)))
        rho1 = qu.reduced_density_matrix(psi1, subsystem_to_keep=list(range(half)))
        # the spectra past rho's rank are rounding: the four below take rho
        # from the state in complex128 (QI_TOL)
        r128, r128_1 = (qu.reduced_density_matrix(x.to(torch.complex128), subsystem_to_keep=list(range(half)))
                        for x in (psi, psi1))
        ta = list(range(half // 2))
        out["rho"] = cpu(rho)
        out["entropy"] = qu.entanglement_entropy(psi, half).item()
        out["renyi"] = qu.renyi_entanglement_entropy(psi, half, k=2).item()
        out["mutual"] = qu.mutual_information(rho, cut=ta).item()
        out["negativity"] = qu.entanglement_negativity(r128, ta).item()
        out["log_negativity"] = qu.log_negativity(r128, ta).item()
        out["fidelity"] = qu.fidelity(r128, r128_1).item()
        out["trace_distance"] = qu.trace_distance(r128, r128_1).item()
        out["negativity complex64"] = qu.entanglement_negativity(rho, ta).item()
        out["fidelity complex64"] = qu.fidelity(rho, rho1).item()
        hg = qu.PauliStringSum2Dense(*tfim_pauli_strings(n_gibbs), device=dev)
        gibbs = qu.gibbs_state(hg, 1.0)
        out["gibbs"], out["free_energy"] = cpu(gibbs), qu.free_energy(gibbs, hg, 1.0).item()
        out["sre"] = qu.stabilizer_renyi_entropy(c12.state()).item()
    p = tct.convert.params(g0, dev).requires_grad_()
    _reset(counters)
    s = qu.entanglement_entropy(tfim_circuit(tct, p, n, nl, device=dev).state(), half)
    (gs,) = torch.autograd.grad(s, p)
    out["entropy_grad"], out["launched entropy"] = cpu(gs), _launched(counters)
    # (e) the QAOA ansatz of phase 9's graph
    graph, structures, weights, angles = _qaoa_ising(*qaoa)
    with torch.no_grad():
        cq = tm.ansatz.QAOA_ansatz_for_Ising(angles, qaoa[1], structures, weights, device=dev)
        out["e qaoa coo"] = tm.measurements.operator_expectation(
            cq, tm.hamiltonians.ising_hamiltonian(graph, device=dev)).item()
        out["e qaoa terms"] = tm.measurements.spin_glass_measurements(cq, graph).item()
    return out


def _hamiltonian_checks(tct, dev, counters=(), ref=None, **sizes):
    """Phase 17's checks (a)-(e) on ``dev``: each route against another
    route to the same number on ``dev``, and against the port's CPU path
    (``ref``, :func:`_hamiltonian_values` on the CPU, or a callable giving
    it; computed here when None: on the CPU the two paths are one).  The
    launches of K2 and K3 are required in (a) on a card.  Returns the card's
    values."""
    import torch

    sizes = {**HAM_SIZES, **sizes}
    card = torch.device(dev).type == "cuda"
    n = sizes["n"]

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 17, {label}: {err} > {tol}")

    got = _hamiltonian_values(tct, dev, counters, **sizes)
    ref = (got if not card else _hamiltonian_values(tct, "cpu", **sizes)) if ref is None else (
        ref() if callable(ref) else ref)
    print("Hamiltonians and the QI toolbox:")
    peak = f", peak {got['coo peak MiB']:.1f} MiB above the start" if "coo peak MiB" in got else ""
    print(f"  (a) tfim_hamiltonian({n}) as COO: nnz {got['nnz']}{peak}; sha256 {got['digest'][:16]}..., the CPU "
          f"path's {ref['digest'][:16]}...; E fused {got['e fused']:.7f}, COO {got['e coo']:.7f}, MVP "
          f"{got['e mvp']:.7f}")
    if got["digest"] != ref["digest"] or got["nnz"] != ref["nnz"]:
        _fail("phase 17 (a): the COO matrix differs from the CPU path's (indices or values)")
    for route in ("coo", "mvp"):
        if card and counters and not all(got[f"launched {route}"].get(k, 0) for k in ("grand_zzrx_fwd", "zzrx_bwd")):
            _fail(f"phase 17 (a) {route}: K2/K3 not launched ({got[f'launched {route}']})")
        print(f"  (a) {route} launched {got[f'launched {route}']}")
        check(f"(a) |E {route} - E fused|", abs(got[f"e {route}"] - got["e fused"]), HAM_ATOL)
        check(f"(a) max |grad {route} - grad fused|", (got[f"g {route}"] - got["g fused"]).abs().max().item(), HAM_ATOL)
        check(f"(a) |E {route} - CPU|", abs(got[f"e {route}"] - ref[f"e {route}"]), HAM_ATOL)
        check(f"(a) max |grad {route} - CPU|", (got[f"g {route}"] - ref[f"g {route}"]).abs().max().item(), HAM_ATOL)
    print(f"  (b) Heisenberg on the {sizes['grid'][0]}x{sizes['grid'][1]} grid: nnz {got['heisenberg nnz']}, E COO "
          f"{got['e heisenberg coo']:.7f}, term by term {got['e heisenberg terms']:.7f}")
    check("(b) |E COO - E term by term|", abs(got["e heisenberg coo"] - got["e heisenberg terms"]), HAM_ATOL)
    check("(b) |E COO - CPU|", abs(got["e heisenberg coo"] - ref["e heisenberg coo"]), HAM_ATOL)
    if not got["dense equal"]:
        _fail(f"phase 17 (c): PauliStringSum2Dense({sizes['n_dense']}) differs from to_dense of the COO")
    print(f"  (c) dense TFIM n={sizes['n_dense']}: equal to to_dense(COO) bit for bit; E dense {got['e dense']:.7f}, "
          f"COO {got['e dense coo']:.7f}")
    check("(c) |E dense - E COO|", abs(got["e dense"] - got["e dense coo"]), HAM_DENSE_ATOL)
    check("(c) |E dense - CPU|", abs(got["e dense"] - ref["e dense"]), HAM_ATOL)
    print(f"  (d) S {got['entropy']:.9f}, S_2 {got['renyi']:.9f}, I {got['mutual']:.9f}, N {got['negativity']:.9f} "
          f"(complex64 spectrum {got['negativity complex64']:.6f}), log N {got['log_negativity']:.9f}, F "
          f"{got['fidelity']:.9f} (complex64 spectrum {got['fidelity complex64']:.6f}), T {got['trace_distance']:.9f}, "
          f"free energy {got['free_energy']:.7f}, SRE {got['sre']:.9f}; entropy grad launched {got['launched entropy']}")
    if card and counters and not got["launched entropy"].get("zzrx_bwd", 0):
        _fail(f"phase 17 (d): K3 not launched by the entropy's gradient ({got['launched entropy']})")
    for key, tol in QI_TOL.items():
        a, b = got[key], ref[key]
        err = (a - b).abs().max().item() if isinstance(a, torch.Tensor) else abs(a - b)
        check(f"(d) {key} against the CPU path", err, tol)
    print(f"  (e) QAOA n={sizes['qaoa'][0]} p={sizes['qaoa'][1]}: E COO {got['e qaoa coo']:.7f}, term by term "
          f"{got['e qaoa terms']:.7f}")
    check("(e) |E COO - E term by term|", abs(got["e qaoa coo"] - got["e qaoa terms"]), HAM_ATOL)
    check("(e) |E COO - CPU|", abs(got["e qaoa coo"] - ref["e qaoa coo"]), HAM_ATOL)
    check("(e) |E term by term - CPU|", abs(got["e qaoa terms"] - ref["e qaoa terms"]), HAM_ATOL)
    return got


def _hamiltonian_phase(tct, card, counters, job):
    """Phase 17: :func:`_hamiltonian_checks` on the card against the CPU
    references of the child process, then each route timed by CUDA events
    (median of 3) with its busy time under torch.profiler (the card alone,
    one call) and its peak memory above the start."""
    import torch

    qu, tm = tct.quantum, tct.templates
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    wait = {}

    def reference():
        ref, wait["s"] = _await_reference(job, "ham")
        print(f"phase 17 CPU references (the child process): waited {wait['s']:.1f} s; {ref['seconds']:.1f} s there")
        return ref

    _hamiltonian_checks(tct, dev, counters, ref=reference)
    t1 = time.perf_counter()
    n, nl = HAM_SIZES["n"], HAM_SIZES["nl"]
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1
    h = tm.hamiltonians.tfim_hamiltonian(n, device=dev)
    mvp = qu.PauliStringSum2MVP(*tfim_pauli_strings(n))
    n12 = HAM_SIZES["n_dense"]
    psi12 = tfim_circuit(tct, tct.convert.params(g0[:, :, :n12], dev), n12, nl, device=dev).state()

    def value_and_grad(fn):
        p = tct.convert.params(g0, dev).requires_grad_()
        v = fn(tfim_circuit(tct, p, n, nl, device=dev))
        (g,) = torch.autograd.grad(v, p)
        return g[0, 0, 0].item()

    timed = {
        f"(a) PauliStringSum2COO of the TFIM, n={n} (the build)": lambda: tm.hamiltonians.tfim_hamiltonian(
            n, device=dev).values()[0].item(),
        "(a) COO <H> and its grad in the angles (K2, cuSPARSE, K3 a layer)": lambda: value_and_grad(
            lambda c: tm.measurements.operator_expectation(c, h)),
        "(a) matrix-free <H> and its grad (39 strings)": lambda: value_and_grad(
            lambda c: tm.measurements.operator_expectation(c, mvp)),
        f"(d) entanglement_entropy(cut={n // 2}) of the state (1024^2 eigvalsh)": lambda: qu.entanglement_entropy(
            tfim_circuit(tct, tct.convert.params(g0, dev), n, nl, device=dev).state(), n // 2).item(),
        "(d) its gradient in the angles (K3 a layer)": lambda: value_and_grad(
            lambda c: qu.entanglement_entropy(c.state(), n // 2)),
        f"(d) stabilizer_renyi_entropy, n={n12} (a 4096^2 table)": lambda: qu.stabilizer_renyi_entropy(psi12).item(),
    }
    for label, fn in timed.items():
        with torch.no_grad() if "grad" not in label else torch.enable_grad():
            ms = _time_ms(fn, reps=3, inner=1, warmup=1)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            host, busy, by_kernel = _profile(fn, reps=1, cpu=False)
        top = ", ".join(f"{name[:40]} {t:.3f} x{k:g}" for name, t, k in by_kernel[:3])
        print(f"phase 17 time, {label}: {ms:.3f} ms (CUDA events, median of 3), busy {busy:.3f} ms "
              f"({100 * busy / ms:.1f} %; profiler, one call), peak {peak:.1f} MiB above the start, {card}; "
              f"top kernels {top}")
    print(f"phase 17 wall time: checks {t1 - t0:.1f} s (of which waiting {wait.get('s', 0.0):.1f} s), timing "
          f"{time.perf_counter() - t1:.1f} s")


# ---- phase 18: the backend's transforms, time evolution and shadows -------

#: phase 18's sizes: the main path (n, nl), vvag's restarts, Adam's steps,
#: the evolution time, the Krylov dimension (‖H‖·t ≤ 19.5 at n=20: 30
#: complex128 Lanczos steps agree with Chebyshev to 3e-16 on the CPU), the
#: shadow settings and shots a setting
TRANSFORM_SIZES = {"n": N, "nl": L, "restarts": 8, "steps": 5, "t": 0.5, "krylov": 30, "settings": 2048,
                   "repeat": 4}
#: the same checks at a CPU test's size
TRANSFORM_SMALL = {"n": 8, "nl": 2, "restarts": 3, "steps": 2, "t": 0.5, "krylov": 20, "settings": 512,
                   "repeat": 4}
#: (a), (b), (d): the card against the port's CPU path (phase 4's tolerance)
TRANSFORM_ATOL = 1e-4
#: (b): each restart's value and gradient against its own eager step on
#: the same device, relative to the largest entry
VVAG_RTOL = 1e-5
#: (c): the parameter-shift gradient against autograd's, relative to the
#: largest entry (the two-term rule is exact for rx and the zz phase; float32)
SHIFT_RTOL = 1e-4
#: (d): Adam's rate (optax.adam(0.05)'s b1, b2, eps)
ADAM_LR = 0.05
#: (e): the norm, <Z_0> and <X_n/2> after exp(-iHt) (complex128) against
#: the CPU path, and Krylov against Chebyshev on one device
EVOL_ATOL = 1e-5
EVOL_METHODS_ATOL = 1e-4
#: (f): the shadow estimates within this many standard errors of the exact
SHADOW_SIGMAS = 5.0


def transform_energy(tct, n, nl, device):
    """The main path as a function of the angles ``(zz (nl, n-1), rx (nl,
    n))`` (``bench.py:204-227``'s circuit: h_layer, nl zzrx_layers, the
    fused ZZ - X energy)."""
    pairs = [(i, i + 1) for i in range(n - 1)]

    def energy(zz, rx):
        c = tct.Circuit(n, device=device)
        c.h_layer()
        for l in range(nl):
            c.zzrx_layer(pairs, zz[l], rx[l])
        return c.expectation_zzx_energy(pairs, 1.0, -1.0)

    return energy


def transform_angles(n, nl, b=None, seed=42):
    """``(zz, rx)`` numpy angles from ``bench.py``'s seeded parameters (b
    restarts from another seed: (b, nl, 2, n) stacked)."""
    if b is None:
        g0 = np.random.default_rng(seed).normal(size=(nl, 2, n)) * 0.1
        return g0[:, 0, : n - 1], g0[:, 1]
    return np.random.default_rng(seed + 1).normal(size=(b, nl, 2, n)) * 0.1


def _tfim_coo_state(tct, dev, n, nl):
    """(the TFIM COO on ``dev``, phase 17's L=nl state there, the bound
    ‖H‖ ≤ Σ|w| = 2n - 1 as spectral bounds), both in complex128: a
    complex64 Lanczos run drifts by 1e-4 in the norm at n=20, more than
    the check across devices allows."""
    import torch

    with tct.set_dtype("complex128"):
        h = tct.templates.hamiltonians.tfim_hamiltonian(n, device=dev)
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1
    psi = tfim_circuit(tct, tct.convert.params(g0, dev), n, nl, device=dev).state().to(torch.complex128)
    return h, psi, (2.0 * n - 1, -(2.0 * n - 1))


def _evol_readouts(tct, psi, n):
    """(norm, <Z_0>, <X_n/2>) of a state, as Python floats."""
    import torch
    from tensorcircuit_ng_tpu_torch.core import statevec

    x = np.array([[0.0, 1.0], [1.0, 0.0]])
    z = np.diag([1.0, -1.0])
    norm = torch.linalg.vector_norm(psi).item()
    ez = torch.real(torch.vdot(psi, statevec.apply_unitary(psi, z, [0]))).item()
    ex = torch.real(torch.vdot(psi, statevec.apply_unitary(psi, x, [n // 2]))).item()
    return norm, ez, ex


def _transform_reference(tct, n=N, nl=L, restarts=8, steps=5, t=0.5, krylov=30, **_):
    """Phase 18's CPU references (the port's CPU path, where ``jit`` runs
    eagerly): (a) the value and gradient, (b) each restart's, (d) the
    energies of the Adam steps, (e) the readouts of the evolved state
    (Krylov)."""
    import torch

    K = tct.backend
    energy = transform_energy(tct, n, nl, "cpu")
    zz, rx = (tct.convert.params(a, "cpu") for a in transform_angles(n, nl))
    out = {}
    e, (gz, gr) = K.value_and_grad(energy, argnums=(0, 1))(zz, rx)
    out["a"] = (e.item(), gz, gr)
    energy_p = lambda p: energy(p[:, 0, : n - 1], p[:, 1])  # noqa: E731
    ps = tct.convert.params(transform_angles(n, nl, restarts), "cpu")
    out["b"] = [K.value_and_grad(energy_p)(p) for p in ps]
    out["d"] = _adam_energies(tct, K.value_and_grad(energy, argnums=(0, 1)), zz, rx, steps)
    h, psi, _ = _tfim_coo_state(tct, "cpu", n, nl)
    # the CPU path's evolved state (Krylov; Chebyshev agrees to 3e-16 there)
    out["e"] = _evol_readouts(tct, tct.timeevol.krylov_evol(h, psi, t, krylov), n)
    return out


def _adam_energies(tct, step, zz, rx, steps):
    """The energies of ``steps`` Adam steps (``backend.optimizer``) of the
    value-and-grad ``step`` from (zz, rx)."""
    import torch

    opt = tct.backend.optimizer(torch.optim.Adam, lr=ADAM_LR)
    energies = []
    for _ in range(steps):
        e, grads = step(zz, rx)
        energies.append(e.item())
        zz, rx = opt.update(grads, (zz, rx))
    return energies


def _transform_checks(tct, dev, counters=(), ref=None, **sizes):
    """Phase 18's checks (a)-(f) on ``dev``, the ones across devices last
    against the port's CPU path (``ref``: :func:`_transform_reference` or
    a callable giving it, asked for after the card's work; computed here
    when None).  On a card the launches of K2 and K4 are required, the
    captured step must equal the uncaptured one bit for bit, and the
    routes are timed; returns the times.  ``counters`` empty: no launch
    is required (the plain path below n=18)."""
    import torch
    from tensorcircuit_ng_tpu_torch.core import statevec

    sizes = {**TRANSFORM_SIZES, **sizes}
    n, nl, b, steps, t = sizes["n"], sizes["nl"], sizes["restarts"], sizes["steps"], sizes["t"]
    card = torch.device(dev).type == "cuda"
    K = tct.backend
    times = {}

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 18, {label}: {err} > {tol}")

    def need(label, got, names, count):
        print(f"  {label} launches: {got}")
        if card and counters and any(got.get(k, 0) != count for k in names):
            _fail(f"phase 18, {label}: launches {got}, want {names} {count} times each")

    def lap(key, fn, reps=20):
        if card:
            times[key] = _time_ms(fn, reps=reps, inner=1, warmup=1)

    def grads_err(a, b):
        return max((x.detach().cpu() - y.detach().cpu()).abs().max().item() for x, y in zip(a, b))

    energy = transform_energy(tct, n, nl, dev)
    zz, rx = (tct.convert.params(a, dev) for a in transform_angles(n, nl))
    vg = K.value_and_grad(energy, argnums=(0, 1))
    # (a) the training step under jit: K2 forward and K4 backward in the graph
    jvg = K.jit(vg)
    _reset(counters)
    first = jvg(zz, rx)
    if card:
        torch.cuda.synchronize()
    need("(a) jit's first call (eager, then the capture)", _launched(counters),
         ("grand_zzrx_fwd", "grand_zzrx_bwd"), 2)
    _reset(counters)
    replays = [jvg(zz, rx) for _ in range(3)]
    if card:
        torch.cuda.synchronize()
        print(f"  (a) launches counted over 3 replays (a replay runs no Python): {_launched(counters) or 'none'}; "
              f"graphs captured {jvg.captures}")
    eager = vg(zz, rx)
    if card:
        same = all(torch.equal(r[0], eager[0]) and all(torch.equal(x, y) for x, y in zip(r[1], eager[1]))
                   for r in replays)
        print(f"  (a) 3 replays equal to the uncaptured step bit for bit: {same}")
        if not same or jvg.captures != 1:
            _fail("phase 18 (a): the captured step differs from the uncaptured one")
    lap("(a) the step under jit (a graph replay)", lambda: jvg(zz, rx)[0])
    lap("(a) the uncaptured step", lambda: vg(zz, rx)[0])
    if card:
        for key, fn in (("(a) busy, under jit", lambda: jvg(zz, rx)), ("(a) busy, uncaptured", lambda: vg(zz, rx))):
            times[key] = _profile(fn, reps=10, cpu=False)[1]

    # (b) vvag over b seeded restarts: the vmap rule runs K2/K4 once a restart
    energy_p = lambda p: energy(p[:, 0, : n - 1], p[:, 1])  # noqa: E731
    ps = tct.convert.params(transform_angles(n, nl, b), dev)
    vvag = K.vvag(energy_p, argnums=0, vectorized_argnums=0)
    _reset(counters)
    vvag(ps)
    need(f"(b) vvag over {b} restarts", _launched(counters), ("grand_zzrx_fwd", "grand_zzrx_bwd"), b)
    jvvag = K.jit(vvag)
    _reset(counters)
    jvvag(ps)
    need("(b) jit of vvag's first call (eager, then the capture)", _launched(counters),
         ("grand_zzrx_fwd", "grand_zzrx_bwd"), 2 * b)
    jvs, jgs = jvvag(ps)
    for i in range(b):
        e1, g1 = K.value_and_grad(energy_p)(ps[i])
        check(f"(b) restart {i} |dE|/|E| against its eager step", abs(jvs[i].item() - e1.item()) / abs(e1.item()),
              VVAG_RTOL)
        check(f"(b) restart {i} max |dgrad| against its eager step, relative",
              (jgs[i] - g1).abs().max().item() / max(g1.abs().max().item(), 1e-30), VVAG_RTOL)
    lap(f"(b) jit of vvag, {b} restarts", lambda: jvvag(ps)[0], reps=5)

    # (c) parameter shift: 2 x nl (2n - 1) shifted energies, vmapped, K2 a shift
    shift = K.jit(tct.experimental.parameter_shift_grad(energy, argnums=(0, 1)))
    m = zz.numel() + rx.numel()
    _reset(counters)
    shift(zz, rx)
    need(f"(c) parameter shift's first call ({2 * m} shifted energies, eager then captured)",
         _launched(counters), ("grand_zzrx_fwd",), 2 * 2 * m)
    scale = max(x.abs().max().item() for x in eager[1])
    check("(c) parameter shift under jit against autograd, max |dgrad| / max |grad|",
          grads_err(shift(zz, rx), eager[1]) / scale, SHIFT_RTOL)
    lap(f"(c) parameter shift under jit ({2 * m} energies)", lambda: shift(zz, rx)[0], reps=3)

    # (d) Adam on the jitted step
    adam = _adam_energies(tct, jvg, zz, rx, steps)
    if not adam[-1] < adam[0]:
        _fail("phase 18 (d): Adam did not lower the energy")

    # (e) time evolution of the TFIM state by Krylov and by Chebyshev
    h, psi, bounds = _tfim_coo_state(tct, dev, n, nl)
    te = tct.timeevol
    evolved = {"krylov": lambda: te.krylov_evol(h, psi, t, sizes["krylov"]),
               "chebyshev": lambda: te.chebyshev_evol(h, psi, t, bounds)}
    reads = {}
    for name, fn in evolved.items():
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        reads[name] = _evol_readouts(tct, fn(), n)
        if card:
            times[f"(e) {name} peak MiB"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        lap(f"(e) {name} to t={t}", lambda fn=fn: fn()[0], reps=3)
    for label, a, c in zip(("norm", "<Z_0>", f"<X_{n // 2}>"), reads["krylov"], reads["chebyshev"]):
        check(f"(e) Krylov against Chebyshev, {label}", abs(a - c), EVOL_METHODS_ATOL)

    # (f) classical shadows of the same state
    ns, repeat = sizes["settings"], sizes["repeat"]
    srng = np.random.default_rng(5)
    strings = srng.integers(0, 3, size=(ns, n))
    status = srng.random((ns, repeat))
    sh = tct.shadows
    t0 = time.perf_counter()
    snaps = sh.shadow_snapshots(psi, strings, status)
    if card:
        torch.cuda.synchronize()
        times[f"(f) {ns} x {repeat} snapshots, wall"] = (time.perf_counter() - t0) * 1e3
    for label, kw, wires, op in (("Z_0 Z_1", {"z": [0, 1]}, [0, 1], np.kron(np.diag([1.0, -1]), np.diag([1.0, -1]))),
                                 ("X_5", {"x": [5]}, [5], np.array([[0.0, 1], [1, 0]]))):
        ests = torch.stack(sh.expectation_ps_shadow(snaps, strings, k=ns, **kw)).cpu().numpy()
        exact = torch.real(torch.vdot(psi, statevec.apply_unitary(psi, op, wires))).item()
        sigma = ests.std() / np.sqrt(ns)
        print(f"  (f) <{label}> shadow {ests.mean():.5f} exact {exact:.5f} sigma {sigma:.5f}")
        check(f"(f) <{label}> |shadow - exact| / sigma", abs(ests.mean() - exact) / sigma, SHADOW_SIGMAS)
    rho = statevec.reduced_density_matrix(psi, [0, 1])
    s_exact = -np.log(torch.real(torch.trace(rho @ rho)).item())
    s_all = sh.renyi_entropy_2(snaps, [0, 1])
    groups = 16
    purities = [np.exp(-sh.renyi_entropy_2(g, [0, 1])) for g in snaps.cpu().numpy().reshape(groups, -1, repeat, n)]
    sigma_s = np.std(purities) / np.sqrt(groups) / np.exp(-s_all)
    print(f"  (f) Renyi-2 of qubits 0-1: shadow {s_all:.5f} exact {s_exact:.5f} sigma {sigma_s:.5f} "
          f"({groups} groups)")
    check("(f) Renyi-2 |shadow - exact| / sigma", abs(s_all - s_exact) / sigma_s, SHADOW_SIGMAS)

    # against the port's CPU path
    reference = ref() if callable(ref) else (ref if ref is not None else _transform_reference(tct, **sizes))
    e_ref, gz_ref, gr_ref = reference["a"]
    for i, (e, g) in enumerate([first] + replays):
        check(f"(a) call {i} |dE| against the CPU path", abs(e.item() - e_ref), TRANSFORM_ATOL)
        check(f"(a) call {i} max |dgrad| against the CPU path", grads_err(g, (gz_ref, gr_ref)), TRANSFORM_ATOL)
    for i, (e_c, g_c) in enumerate(reference["b"]):
        check(f"(b) restart {i} |dE| against the CPU path", abs(jvs[i].item() - e_c.item()), TRANSFORM_ATOL)
        check(f"(b) restart {i} max |dgrad| against the CPU path", grads_err([jgs[i]], [g_c]), TRANSFORM_ATOL)
    for i, (e, e_c) in enumerate(zip(adam, reference["d"])):
        check(f"(d) Adam step {i} E {e:.7f} against the CPU path", abs(e - e_c), TRANSFORM_ATOL)
    for name in evolved:
        for label, a, c in zip(("norm", "<Z_0>", f"<X_{n // 2}>"), reads[name], reference["e"]):
            check(f"(e) {name} {label} {a:.10f} against the CPU path", abs(a - c), EVOL_ATOL)
    return times


def _transform_phase(tct, card, counters, job):
    """Phase 18: :func:`_transform_checks` on the card against the CPU
    references of the child process, then its times."""
    t0 = time.perf_counter()
    wait = {}

    def reference():
        ref, wait["s"] = _await_reference(job, "transform")
        print(f"phase 18 CPU references (the child process): waited {wait['s']:.1f} s; "
              f"{ref['seconds']:.1f} s there")
        return ref

    times = _transform_checks(tct, "cuda", counters, ref=reference)
    for key, ms in times.items():
        unit = "" if "MiB" in key else " ms"
        how = "" if "MiB" in key or "busy" in key or "wall" in key else " (CUDA events, median)"
        print(f"phase 18 time, {key}: {ms:.4f}{unit}{how}, {card}")
    print(f"phase 18 wall time: {time.perf_counter() - t0:.1f} s (of which waiting {wait.get('s', 0.0):.1f} s)")



# ---- phase 19: the stabilizer simulator, detectors, qudits, U(1) -----------

#: phase 19's sizes: (a) the rotated surface code's distance, rounds,
#: depolarizing p, shots on the card, the shots held against the CPU path,
#: the tableau's shots; (b) the repetition code's distance, rounds, damping
#: and trajectories; (c) the random Clifford circuit's width and depth and
#: the sampled circuit's width; (d) the qudits; (e) the U(1) sector
STAB_SIZES = {"sc_d": 3, "sc_rounds": 3, "sc_p": 0.01, "sc_shots": 1024, "sc_ref": 16, "sc_tab": 4096,
              "rep_d": 5, "rep_rounds": 2, "rep_gamma": 0.02, "rep_traj": 8192,
              "cl_n": 20, "cl_depth": 40, "cl_wide": 49, "samples": 8192,
              "q_n": 12, "q_d": 3, "q_layers": 4, "u_n": 24, "u_k": 12, "u_layers": 4}
#: the same checks at a CPU test's size
STAB_SMALL = {"sc_d": 3, "sc_rounds": 1, "sc_p": 0.01, "sc_shots": 16, "sc_ref": 4, "sc_tab": 400,
              "rep_d": 3, "rep_rounds": 2, "rep_gamma": 0.05, "rep_traj": 2048,
              "cl_n": 8, "cl_depth": 10, "cl_wide": 30, "samples": 2048,
              "q_n": 4, "q_d": 3, "q_layers": 2, "u_n": 8, "u_k": 4, "u_layers": 2}
#: (b), (d), (e): the card against the port's CPU path (complex64)
STAB_ATOL = 1e-5
#: (a): a shot may differ from the CPU path's only where a uniform lies this
#: near a cdf boundary (the sampling phases' bracket rule)
STAB_BRACKET = 1e-6
#: (a), (b), (c), (d), (e): sampled rates within this many standard errors
STAB_SIGMAS = 5.0
#: (c): |<replayed|rebuilt>| at least 1 - this
STAB_OVERLAP_TOL = 1e-5


def surface_layout(d):
    """The rotated surface code of distance d: (data coordinates, X-measure
    coordinates, Z-measure coordinates), data at odd (x, y), measures at
    even ones (stim's ``surface_code:rotated_memory_z`` layout)."""
    data = [(2 * i + 1, 2 * j + 1) for i in range(d) for j in range(d)]
    xm, zm = [], []
    for x in range(d + 1):
        for y in range(d + 1):
            parity = (x % 2) != (y % 2)
            if (x in (0, d) and parity) or (y in (0, d) and not parity):
                continue
            (xm if parity else zm).append((2 * x, 2 * y))
    return data, xm, zm


def surface_code_program(tct, d, rounds, p, tableau=False, cls=None, after_round=None, **kw):
    """The Z-memory experiment of the rotated surface code: ``rounds`` rounds
    of the X and Z checks (stim's CNOT orders), a depolarizing channel of
    total ``p`` on both qubits after every CNOT (a ``Circuit`` channel
    site, or the tableau's lazy ``depolarize1``), measure and reset of the
    measure qubits, detectors between rounds, the data measured at the end,
    the Z checks closed on it and one observable (a row of data).  A
    ``Circuit`` reset is a record, a tableau one is not: each program's
    detectors count their own records.  ``cls`` builds the program on
    another class with the tableau's instructions (``zx.StabilizerTCircuit``);
    ``after_round(c, r, data)`` adds gates after round r (data: the data
    qubits' indices)."""
    data, xm, zm = surface_layout(d)
    coords = data + xm + zm
    idx = {c: k for k, c in enumerate(coords)}
    mq = [idx[m] for m in xm + zm]
    if cls is None:
        cls = tct.StabilizerCircuit if tableau else tct.Circuit
    c = cls(len(coords), **kw)
    det = c.detector if tableau else c.detector_instruction
    per_round = len(mq) * (1 if tableau else 2)

    def noise(q):
        if tableau:
            c.depolarize1(q, p=p)
        else:
            c.depolarizing(q, px=p / 3, py=p / 3, pz=p / 3)

    def cnot(a, b):
        c.cnot(a, b)
        noise(a)
        noise(b)

    x_order = [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    z_order = [(1, 1), (-1, 1), (1, -1), (-1, -1)]
    for r in range(rounds):
        for m in xm:
            c.h(idx[m])
        for k in range(4):
            for m in xm:
                q = (m[0] + x_order[k][0], m[1] + x_order[k][1])
                if q in data:
                    cnot(idx[m], idx[q])
            for m in zm:
                q = (m[0] + z_order[k][0], m[1] + z_order[k][1])
                if q in data:
                    cnot(idx[q], idx[m])
        for m in xm:
            c.h(idx[m])
        c.measure_instruction(*mq)
        c.reset_instruction(*mq)
        for j, m in enumerate(xm + zm):
            cur = -(per_round - j)
            if r:
                det(cur, cur - per_round)
            elif m in zm:
                det(cur)
        if after_round is not None:
            after_round(c, r, [idx[q] for q in data])
    c.measure_instruction(*range(len(data)))
    nd = len(data)
    for j, m in enumerate(xm + zm):
        if m in zm:
            near = [data.index((m[0] + a, m[1] + b)) for a, b in z_order if (m[0] + a, m[1] + b) in data]
            det(*[-(nd - k) for k in near], -(nd + per_round - j))
    row = [-(nd - data.index(q)) for q in data if q[1] == 1]
    if tableau:
        c.observable_include(*row)
    else:
        c.observable_instruction(*row)
    return c


def repetition_program(tct, d, rounds, gamma, **kw):
    """The distance-d repetition code (d data qubits in |1>, d-1 measure
    qubits between them): ``rounds`` rounds of ZZ checks with measure and
    reset, amplitude damping ``gamma`` on the data before each later round
    and before the final data measurement, detectors between rounds, the
    checks closed on the data, and data qubit 0 as the observable."""
    n = 2 * d - 1
    c = tct.Circuit(n, **kw)
    ms = list(range(d, n))
    per_round = 2 * len(ms)
    for q in range(d):
        c.x(q)
    for r in range(rounds):
        if r:
            for q in range(d):
                c.amplitudedamping(q, gamma=gamma, p=1.0)
        for j in range(d - 1):
            c.cnot(j, d + j)
            c.cnot(j + 1, d + j)
        c.measure_instruction(*ms)
        c.reset_instruction(*ms)
        for j in range(d - 1):
            cur = -(per_round - j)
            if r:
                c.detector_instruction(cur, cur - per_round)
            else:
                c.detector_instruction(cur)
    for q in range(d):
        c.amplitudedamping(q, gamma=gamma, p=1.0)
    c.measure_instruction(*range(d))
    for j in range(d - 1):
        c.detector_instruction(-(d - j), -(d - j - 1), -(d + per_round - j))
    c.observable_instruction(-d)
    return c


def f12_programs(tct, **kw):
    """Queue 3 F12's two probes: a detector before a later record, and a
    record named twice."""
    c1 = tct.Circuit(2, **kw)
    c1.x(0)
    c1.measure_instruction(0)
    c1.detector_instruction(-1)
    c1.measure_instruction(1)
    c2 = tct.Circuit(2, **kw)
    c2.x(0)
    c2.measure_instruction(0)
    c2.detector_instruction(-1, -1)
    return c1, c2


def detector_statuses(c, shots, seed=19):
    """Seeded uniforms for the measurements and the channel sites of ``c``."""
    rng = np.random.default_rng(seed)
    return rng.random((shots, max(c._num_measures(), 1))), rng.random((shots, max(c._num_channels(), 1)))


def clifford_program(tct, n, depth, seed, **kw):
    """A random Clifford circuit: ``depth`` layers of a random one-qubit
    Clifford a qubit and CNOT or CZ on a random pairing."""
    rng = np.random.default_rng(seed)
    c = tct.StabilizerCircuit(n, **kw)
    ones = ["h", "s", "sd", "x", "y", "z", "sx"]
    for _ in range(depth):
        for q in range(n):
            getattr(c, ones[rng.integers(len(ones))])(q)
        perm = rng.permutation(n)
        for a, b in zip(perm[0::2], perm[1::2]):
            getattr(c, "cnot" if rng.random() < 0.5 else "cz")(int(a), int(b))
    return c


def weight2_strings(n):
    """Every Pauli string of weight 1 and 2 on n qubits, as (x, y, z) lists."""
    out = []
    for q in range(n):
        for k in "xyz":
            out.append({k: [q]})
    for a in range(n):
        for b in range(a + 1, n):
            for ka in "xyz":
                for kb in "xyz":
                    s = {"x": [], "y": [], "z": []}
                    s[ka].append(a)
                    s[kb].append(b)
                    out.append(s)
    return out


def qudit_op(d):
    """A Hermitian one-qudit observable: the centred level plus a hopping."""
    return np.diag(np.arange(d) - (d - 1) / 2.0) + 0.3 * (np.eye(d, k=1) + np.eye(d, k=-1))


def qudit_circuit(tct, p, n, d, layers, **kw):
    """``layers`` layers of rx (levels 0-1) and ry (levels 1-2) on every
    qudit, a csum chain and rzz on neighbours, after the Fourier H; ``p``
    (layers, 3, n) angles."""
    c = tct.QuditCircuit(n, dim=d, **kw)
    for q in range(n):
        c.h(q)
    for l in range(layers):
        for q in range(n):
            c.rx(q, theta=p[l, 0, q], j=0, k=1)
            c.ry(q, theta=p[l, 1, q], j=1, k=2)
        for q in range(n - 1):
            c.csum(q, q + 1)
        for q in range(n - 1):
            c.rzz(q, q + 1, theta=p[l, 2, q])
    return c


def qudit_energy(tct, p, n, d, layers, **kw):
    c = qudit_circuit(tct, p, n, d, layers, **kw)
    op = qudit_op(d)
    return c, sum(c.expectation((op, [q])) for q in range(n)).real


def xy_gate(t, cdt):
    """exp(-i t (XX + YY)/2), the hopping rotation, from a tensor angle."""
    import torch

    c, s = torch.cos(t).to(cdt), torch.sin(t).to(cdt)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([o, z, z, z]), torch.stack([z, c, -1j * s, z]),
                        torch.stack([z, -1j * s, c, z]), torch.stack([z, z, z, o])])


def u1_circuit(tct, p, n, k, layers, **kw):
    """From the Neel-like filling of k sites, ``layers`` brick layers of XY
    rotations (even pairs, then odd), rz on every site and rzz on
    neighbours; ``p`` (layers, 3, n) angles."""
    c = tct.U1Circuit(n, filled=list(range(0, 2 * k, 2)) if 2 * k <= n else list(range(k)), **kw)
    cdt = tct.config.torch_dtype()
    for l in range(layers):
        for start in (0, 1):
            for a in range(start, n - 1, 2):
                c.unitary(a, a + 1, unitary=xy_gate(p[l, 0, a], cdt))
        for q in range(n):
            c.rz(q, theta=p[l, 1, q])
        for q in range(n - 1):
            c.rzz(q, q + 1, theta=p[l, 2, q])
    return c


def u1_energy(tct, p, n, k, layers, **kw):
    c = u1_circuit(tct, p, n, k, layers, **kw)
    return c, sum(c.expectation_ps(z=[i, i + 1]) for i in range(n - 1)).real


def stab_angles(layers, n, seed):
    return np.random.default_rng(seed).normal(size=(layers, 3, n)) * 0.5


def _stab_values(tct, dev, sizes):
    """What phase 19 holds across devices, computed on ``dev``: (a) the
    first ``sc_ref`` shots of the surface code, (b) the exact detector
    probabilities of the repetition code, (d) the qudit state, energy and
    gradient, (e) the U(1) energy and gradient."""
    import torch

    s = sizes
    out = {}
    sc = surface_code_program(tct, s["sc_d"], s["sc_rounds"], s["sc_p"], device=dev)
    st, sc_c = detector_statuses(sc, s["sc_shots"])
    det, obs, margin = sc.sample_detector(s["sc_ref"], status=st[: s["sc_ref"]], statusc=sc_c[: s["sc_ref"]],
                                          with_observable=True, with_margin=True)
    out["a det"], out["a obs"], out["a margin"] = det.cpu(), obs.cpu(), margin.cpu()
    rep = repetition_program(tct, s["rep_d"], s["rep_rounds"], s["rep_gamma"], device=dev)
    out["b exact"] = rep.detector_probabilities_exact().cpu()
    qp = tct.convert.params(stab_angles(s["q_layers"], s["q_n"], 23), dev).requires_grad_()
    c, e = qudit_energy(tct, qp, s["q_n"], s["q_d"], s["q_layers"], device=dev)
    (g,) = torch.autograd.grad(e, qp)
    out["d state"], out["d e"], out["d g"] = c.state().detach().cpu(), e.item(), g.cpu()
    up = tct.convert.params(stab_angles(s["u_layers"], s["u_n"], 29), dev).requires_grad_()
    c, e = u1_energy(tct, up, s["u_n"], s["u_k"], s["u_layers"], device=dev)
    (g,) = torch.autograd.grad(e, up)
    out["e e"], out["e g"] = e.item(), g.cpu()
    return out


def _stab_reference(tct, **sizes):
    """Phase 19's CPU references: :func:`_stab_values` on the CPU and the
    tableau's ``sample_detectors`` of the surface code at ``sc_tab`` shots."""
    s = {**STAB_SIZES, **sizes}
    t0 = time.perf_counter()
    out = _stab_values(tct, "cpu", s)
    tab = surface_code_program(tct, s["sc_d"], s["sc_rounds"], s["sc_p"], tableau=True, device="cpu")
    t1 = time.perf_counter()
    out["a tableau"] = tab.sample_detectors(s["sc_tab"], seed=19)
    out["seconds tableau"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    return out


def _rates_agree(label, a, na, b, nb, check):
    """Each column's rate of ``a`` (na shots) against ``b`` (nb shots)
    within :data:`STAB_SIGMAS` standard errors of the difference (the
    pooled rate, at least one event's worth)."""
    ra, rb = a.mean(axis=0), b.mean(axis=0)
    pool = np.clip((ra * na + rb * nb) / (na + nb), 1.0 / (na + nb), 1.0)
    sigma = np.sqrt(pool * (1 - pool) * (1.0 / na + 1.0 / nb))
    worst = float(np.max(np.abs(ra - rb) / sigma)) if ra.size else 0.0
    check(f"{label} max |rate difference| / sigma over {ra.size} columns", worst, STAB_SIGMAS)
    return ra, rb


def _stab_checks(tct, dev, counters=(), ref=None, **sizes):
    """Phase 19's checks (a)-(e) on ``dev``, against the port's CPU path
    (``ref``: :func:`_stab_reference` or a callable giving it, asked for
    after the work on ``dev``; computed here when None).  Returns the
    routes' times (CUDA events on a card, else the wall clock) and peaks."""
    import torch
    from tensorcircuit_ng_tpu_torch.core import native_tableau, statevec
    from tensorcircuit_ng_tpu_torch.models import detectors as detmod

    s = {**STAB_SIZES, **sizes}
    dev = torch.device(dev)
    card = dev.type == "cuda"
    times = {}

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 19, {label}: {err} > {tol}")

    def timed(label, fn):
        """``fn()`` once, timed by CUDA events (card) or the wall clock,
        with its peak memory above the start (card)."""
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            times[label] = (a.elapsed_time(b), "CUDA events, one call",
                            (torch.cuda.max_memory_allocated() - base) / 2**20)
        else:
            t0 = time.perf_counter()
            out = fn()
            times[label] = ((time.perf_counter() - t0) * 1e3, "wall clock, one call", None)
        return out

    print("stabilizer simulator, detectors, qudits, U(1):")
    t0 = time.perf_counter()
    native_tableau.native_tableau_available()
    print(f"  libtableau loaded in {time.perf_counter() - t0:.2f} s (built by g++ at the process's first use, "
          f"{native_tableau.library_path().name})")
    got = _stab_values(tct, dev, s)
    # (a) the surface code's trajectories, the shots as one state
    sc = surface_code_program(tct, s["sc_d"], s["sc_rounds"], s["sc_p"], device=dev)
    n_sc = sc.nqubits
    st, sc_c = detector_statuses(sc, s["sc_shots"])
    st_d, sc_d = (torch.as_tensor(a, device=dev) for a in (st, sc_c))
    chunk = detmod.detector_chunk(s["sc_shots"], 2**n_sc, tct.config.torch_dtype(), dev)
    det, obs = timed(f"(a) sample_detector, surface code d={s['sc_d']} ({n_sc} qubits), {s['sc_rounds']} rounds, "
                     f"{s['sc_shots']} shots", lambda: sc.sample_detector(s["sc_shots"], status=st_d, statusc=sc_d,
                                                                           with_observable=True))
    print(f"  (a) {n_sc} qubits, {sc._num_channels()} channel sites, {sc._num_measures()} records, "
          f"{det.shape[1]} detectors; {s['sc_shots']} shots as a [{s['sc_shots']}, 2^{n_sc}] state: "
          f"{-(-s['sc_shots'] // chunk)} chunk(s) of at most {chunk} shots "
          f"({s['sc_shots'] * 2**n_sc * 8 / 2**30:.3f} GiB of complex64 state)")
    det, obs = det.cpu().numpy(), obs.cpu().numpy()
    if det.shape != (s["sc_shots"], det.shape[1]) or not set(np.unique(det)) <= {0, 1}:
        _fail(f"phase 19 (a): detector bits of shape {det.shape}, values {np.unique(det)}")
    # (b) exact detector probabilities of the repetition code
    rep = repetition_program(tct, s["rep_d"], s["rep_rounds"], s["rep_gamma"], device=dev)
    exact = timed(f"(b) detector_probabilities_exact, repetition code d={s['rep_d']} ({rep.nqubits} qubits)",
                  lambda: rep.detector_probabilities_exact()).cpu().numpy()
    st_b, sc_b = detector_statuses(rep, s["rep_traj"], seed=20)
    rates = timed(f"(b) {s['rep_traj']} trajectories of the same", lambda: rep.detector_probabilities(
        s["rep_traj"], status=torch.as_tensor(st_b, device=dev), statusc=torch.as_tensor(sc_b, device=dev)))
    rates = rates.cpu().numpy()
    print(f"  (b) exact {np.array2string(exact, precision=5)}; {s['rep_traj']} trajectories "
          f"{np.array2string(rates, precision=5)}")
    sigma = np.sqrt(np.maximum(exact * (1 - exact), 1.0 / s["rep_traj"]) / s["rep_traj"])
    check("(b) max |trajectories - exact| / sigma", float(np.max(np.abs(rates - exact) / sigma)), STAB_SIGMAS)
    if not exact.max() > 0:
        _fail(f"phase 19 (b): no detector fires ({exact})")
    for label, c, fire in zip(("detector before a later record", "a record named twice"), f12_programs(tct, device=dev),
                              (1.0, 0.0)):
        e = c.detector_probabilities_exact().cpu().numpy()
        t = c.sample_detector(64).cpu().numpy().mean(axis=0)
        print(f"  (b) F12 probe, {label}: exact {e.tolist()}, 64 trajectories {t.tolist()}, expected [{fire}]")
        check(f"(b) F12 {label}: |exact - trajectories|", float(np.max(np.abs(e - t))), 1e-6)
        check(f"(b) F12 {label}: |exact - expected|", float(np.max(np.abs(e - fire))), 1e-6)
    # (c) the stabilizer simulator: the dense state on the device, Pauli
    # strings, the native sampler
    cl = timed(f"(c) random Clifford circuit n={s['cl_n']}, depth {s['cl_depth']} on the tableau",
               lambda: clifford_program(tct, s["cl_n"], s["cl_depth"], 5, device=dev))
    replayed = timed(f"(c) state() replayed through Circuit ({len(cl.to_qir())} gates)", lambda: cl.state())
    rebuilt = timed(f"(c) state() rebuilt from the {s['cl_n']} stabilizers",
                    lambda: tct.StabilizerCircuit(s["cl_n"], tableau_inputs=cl.get_tableau(), device=dev).state())
    overlap = torch.abs(torch.vdot(replayed, rebuilt)).item()
    check("(c) 1 - |<replayed|rebuilt>|", 1 - overlap, STAB_OVERLAP_TOL)
    xs, zs_, _ = cl.get_tableau().stabilizers()
    strings = weight2_strings(s["cl_n"]) + [
        {"x": [q for q in range(s["cl_n"]) if xs[j, q] and not zs_[j, q]],
         "y": [q for q in range(s["cl_n"]) if xs[j, q] and zs_[j, q]],
         "z": [q for q in range(s["cl_n"]) if zs_[j, q] and not xs[j, q]]} for j in range(s["cl_n"])]
    tab_vals = timed(f"(c) {len(strings)} Pauli strings (weight <= 2 and the generators) on the tableau",
                     lambda: np.array([cl.expectation_ps(**ps).item() for ps in strings]))
    dense_vals = timed(f"(c) the same on the dense state", lambda: torch.stack(
        [torch.real(statevec.expectation_ps(replayed, **ps)) for ps in strings]).cpu().numpy())
    print(f"  (c) {len(strings) - s['cl_n']} strings of weight <= 2 and the {s['cl_n']} stabilizer generators: "
          f"{int(np.sum(tab_vals != 0))} nonzero on the tableau")
    if not np.all(np.abs(tab_vals[-s["cl_n"]:]) == 1):
        _fail("phase 19 (c): a stabilizer generator's expectation is not +-1")
    check(f"(c) max |tableau - dense| over {len(strings)} strings", float(np.max(np.abs(tab_vals - dense_vals))),
          STAB_ATOL)
    wide = clifford_program(tct, s["cl_wide"], s["cl_depth"], 6, device=dev)
    t0 = time.perf_counter()
    bits = wide.sample(s["samples"], format="sample_bin", random_generator=np.random.default_rng(7))
    times[f"(c) native sample({s['samples']}), n={s['cl_wide']}"] = (
        (time.perf_counter() - t0) * 1e3, "wall clock, one call, to the bits on the device", None)
    means = bits.to(torch.float64).mean(dim=0).cpu().numpy()
    zs = np.array([wide.expectation_ps(z=[q]).item() for q in range(s["cl_wide"])])
    want = (1 - zs) / 2
    det_q = zs != 0
    if not np.array_equal(means[det_q], want[det_q]):
        _fail("phase 19 (c): a determined qubit's samples disagree with the tableau's <Z>")
    check(f"(c) max |mean - 1/2| / sigma over the {int(np.sum(~det_q))} random qubits",
          float(np.max(np.abs(means[~det_q] - 0.5)) / np.sqrt(0.25 / s["samples"])) if (~det_q).any() else 0.0,
          STAB_SIGMAS)
    # (d) qudits: samples of the evaluated state
    qp = tct.convert.params(stab_angles(s["q_layers"], s["q_n"], 23), dev)
    with torch.no_grad():
        qc, _ = timed(f"(d) qudit energy d={s['q_d']}, n={s['q_n']}", lambda: qudit_energy(
            tct, qp, s["q_n"], s["q_d"], s["q_layers"], device=dev))
    qg = tct.convert.params(stab_angles(s["q_layers"], s["q_n"], 23), dev).requires_grad_()
    timed("(d) its value and gradient", lambda: torch.autograd.grad(
        qudit_energy(tct, qg, s["q_n"], s["q_d"], s["q_layers"], device=dev)[1], qg))
    st_q = torch.as_tensor(np.random.default_rng(8).random(s["samples"]), device=dev)
    shots = timed(f"(d) sample({s['samples']}, allow_state=True)", lambda: qc.sample(
        s["samples"], allow_state=True, status=st_q, format="sample_bin"))
    level = (shots[:, 0].to(torch.float64) - (s["q_d"] - 1) / 2).cpu().numpy()
    exact0 = qc.expectation((np.diag(np.arange(s["q_d"]) - (s["q_d"] - 1) / 2.0), [0])).real.item()
    check("(d) |shot mean of qudit 0's level - <level>| / sigma",
          abs(level.mean() - exact0) / max(level.std() / np.sqrt(s["samples"]), 1e-12), STAB_SIGMAS)
    # (e) U(1): samples, and one gate with its maps cached and uncached
    up = tct.convert.params(stab_angles(s["u_layers"], s["u_n"], 29), dev)
    with torch.no_grad():
        uc = timed(f"(e) U1Circuit n={s['u_n']}, k={s['u_k']}: the circuit", lambda: u1_circuit(
            tct, up, s["u_n"], s["u_k"], s["u_layers"], device=dev))
    ug = tct.convert.params(stab_angles(s["u_layers"], s["u_n"], 29), dev).requires_grad_()
    timed("(e) <sum Z_i Z_i+1> and its gradient", lambda: torch.autograd.grad(
        u1_energy(tct, ug, s["u_n"], s["u_k"], s["u_layers"], device=dev)[1], ug))
    st_u = torch.as_tensor(np.random.default_rng(9).random(s["samples"]), device=dev)
    ubits = timed(f"(e) sample({s['samples']})", lambda: uc.sample(s["samples"], status=st_u, format="sample_bin"))
    if not bool((ubits.sum(dim=1) == s["u_k"]).all()):
        _fail("phase 19 (e): a sample leaves the sector")
    zz = (1 - 2 * ubits[:, :-1].to(torch.float64)) * (1 - 2 * ubits[:, 1:].to(torch.float64))
    shots_zz = zz.sum(dim=1).cpu().numpy()
    with torch.no_grad():
        exact_zz = sum(uc.expectation_ps(z=[i, i + 1]) for i in range(s["u_n"] - 1)).real.item()
    check("(e) |shot mean of sum Z_i Z_i+1 - exact| / sigma",
          abs(shots_zz.mean() - exact_zz) / max(shots_zz.std() / np.sqrt(s["samples"]), 1e-12), STAB_SIGMAS)
    print(f"  (e) sector dimension {uc.sector_dim}; {len(uc._maps)} wire tuples of maps kept")
    m = xy_gate(torch.tensor(0.3, device=dev), tct.config.torch_dtype())

    def gate(cached):
        if not cached:
            uc._maps.pop((0, 1), None)
        with torch.no_grad():
            uc.unitary(0, 1, unitary=m)

    for cached in (False, True):
        label = f"(e) one XY gate on the {uc.sector_dim}-amplitude sector, maps {'cached' if cached else 'built'}"
        samples = []
        for _ in range(5):
            timed(label, lambda: gate(cached))
            samples.append(times[label][0])
        times[label] = (statistics.median(samples), ("CUDA events" if card else "wall clock") + ", median of 5",
                        times[label][2])
    # against the port's CPU path
    reference = ref() if callable(ref) else (ref if ref is not None else _stab_reference(tct, **sizes))
    k = s["sc_ref"]
    cpu_bits = np.concatenate([reference["a det"].numpy(), reference["a obs"].numpy()], axis=1)
    card_bits = np.concatenate([got["a det"].numpy(), got["a obs"].numpy()], axis=1)
    margin = np.minimum(reference["a margin"].numpy(), got["a margin"].numpy())
    differ = np.any(cpu_bits != card_bits, axis=1)
    for i in np.nonzero(differ)[0]:
        print(f"  (a) shot {i} differs from the CPU path's; its nearest uniform lies {margin[i]:.3e} from a cdf "
              f"boundary")
    print(f"  (a) the first {k} shots: {int(differ.sum())} differ from the CPU path's, least margin "
          f"{margin.min():.3e}")
    if (differ & (margin > STAB_BRACKET)).any():
        _fail(f"phase 19 (a): shots {np.nonzero(differ & (margin > STAB_BRACKET))[0].tolist()} differ from the CPU "
              f"path's away from a cdf boundary")
    if not np.array_equal(card_bits, np.concatenate([det[:k], obs[:k]], axis=1)):
        _fail("phase 19 (a): the first shots of the full run differ from the same shots run alone")
    tab_det, tab_obs = reference["a tableau"]
    ra, rb = _rates_agree(f"(a) {s['sc_shots']} trajectories against {s['sc_tab']} tableau shots",
                          np.concatenate([det, obs], axis=1), s["sc_shots"],
                          np.concatenate([tab_det, tab_obs], axis=1).astype(np.float64), s["sc_tab"], check)
    print(f"  (a) detector rates: card {np.array2string(ra, precision=4)}; tableau {np.array2string(rb, precision=4)}")
    check("(b) max |exact - CPU path|", float(np.max(np.abs(exact - reference["b exact"].numpy()))), STAB_ATOL)
    check("(d) max |state - CPU path|", (got["d state"] - reference["d state"]).abs().max().item(), STAB_ATOL)
    check("(d) |E - CPU path|", abs(got["d e"] - reference["d e"]), STAB_ATOL)
    check("(d) max |grad - CPU path|", (got["d g"] - reference["d g"]).abs().max().item(), STAB_ATOL)
    check("(e) |<sum ZZ> - CPU path|", abs(got["e e"] - reference["e e"]), STAB_ATOL)
    check("(e) max |grad - CPU path|", (got["e g"] - reference["e g"]).abs().max().item(), STAB_ATOL)
    print(f"  (d) E {got['d e']:.7f}; (e) <sum ZZ> {got['e e']:.7f}; the tableau's {s['sc_tab']} shots took "
          f"{reference['seconds tableau']:.1f} s on the CPU")
    return times


def _stab_phase(tct, card, job):
    """Phase 19: :func:`_stab_checks` on the card against the CPU references
    of the child process, then its times."""
    t0 = time.perf_counter()
    wait = {}

    def reference():
        ref, wait["s"] = _await_reference(job, "stab")
        print(f"phase 19 CPU references (the child process): waited {wait['s']:.1f} s; {ref['seconds']:.1f} s there")
        return ref

    times = _stab_checks(tct, "cuda", ref=reference)
    for label, (ms, how, peak) in times.items():
        mem = f", peak {peak:.1f} MiB above the start" if peak is not None else ""
        print(f"phase 19 time, {label}: {ms:.3f} ms ({how}){mem}, {card}")
    print(f"phase 19 wall time: {time.perf_counter() - t0:.1f} s (of which waiting {wait.get('s', 0.0):.1f} s)")


# ---- phase 20: analog circuits, free fermions, Pauli propagation, symbols -

#: phase 20's sizes: (a) the analog circuit's width and zzrx layers, its
#: global block's duration T and drive Ω, the local block's wires; (b) the
#: free-fermion chain, its hopping layers (each every bond, even then odd),
#: the measured sites, the asymmetry's block and angles; (c) the exact and
#: the truncated propagation's widths and weights, and their brick layers;
#: (d) the symbolic circuit's width and layers
SLICE_SIZES = {"a_n": 18, "a_nl": L, "a_T": 0.5, "a_omega": 1.2, "a_local": 4,
               "f_L": 512, "f_layers": 4, "f_meas": 32, "f_block": 64, "f_angles": 100,
               "p_n": 10, "p_k": 10, "p_wide": 40, "p_wide_k": 3, "p_layers": 4,
               "s_n": 4, "s_layers": 3}
#: the same checks at a CPU test's size
SLICE_SMALL = {"a_n": 8, "a_nl": 2, "a_T": 0.5, "a_omega": 1.2, "a_local": 3,
               "f_L": 16, "f_layers": 2, "f_meas": 4, "f_block": 4, "f_angles": 8,
               "p_n": 6, "p_k": 6, "p_wide": 10, "p_wide_k": 2, "p_layers": 2,
               "s_n": 3, "s_layers": 2}
#: (a): the value and gradients against the CPU path, and the local block
#: H = θ/(2T) X against rx(θ): the ODE's tolerance
ANALOG_ATOL = 1e-4
#: (a): the blocks' absolute ODE tolerance, set for amplitudes of 2^-9: at
#: the default 1.4e-7 the n=18 state's norm drifted 4.5e-5 on the card (25
#: steps); at 1e-9 the n=16 one drifts 5.4e-7 on the CPU (48 steps)
ANALOG_ODE_ATOL = 1e-9
#: (b): each readout against the CPU path, relative to its own size
FGS_RTOL = 1e-4
#: (b): C² = C and C = C† on the card
FGS_PROJ_ATOL = 1e-4
#: (b): Σ occupations after the number-conserving hopping layers
FGS_NUMBER_ATOL = 1e-3
#: (b): a measured site's occupation against its outcome
FGS_OUTCOME_ATOL = 1e-5
#: (c) and (d): float32 propagation against the dense state and the CPU
#: path; the bound symbolic circuit against the substituted expression
SLICE_ATOL = 1e-5


def _hermitian_mvp(h):
    """v -> h @ v for a hermitian sparse ``h``, its backward the same
    product (h^H = h), so that no transpose of ``h`` is made."""
    import torch

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            return h @ v

        @staticmethod
        def backward(ctx, g):
            return h @ g

    return Product.apply


def analog_local_hamiltonian(k, seed=31):
    """H_0 of phase 20 (a)'s local block: a seeded hermitian 2^k x 2^k
    matrix of spectral norm 1."""
    a = np.random.default_rng(seed).normal(size=(2**k, 2**k, 2)) @ np.array([1.0, 1.0j])
    h = (a + a.conj().T) / 2
    return h / np.linalg.norm(h, 2)


def analog_circuit(tct, p, omega, n, nl, T, local, device):
    """Phase 20 (a)'s hybrid circuit: the TFIM main path (h_layer and nl
    zzrx_layers on the chain, angles ``p``), a global block H(t) = Σ Z_i
    Z_{i+1} + Ω sin(πt/T) Σ X_i over [0, T] (the port's COO, built once on
    the device and kept as CSR, the drive scaled per t), rx(0.1 (q+1)) on
    every qubit, a local block (1 + t) H_0 on wires 0..local-1 over [0, T];
    both blocks at the absolute tolerance :data:`ANALOG_ODE_ATOL`."""
    import torch

    pairs = [(i, i + 1) for i in range(n - 1)]
    with tct.set_device(device):
        hzz = tct.PauliStringSum2COO([[3 if q in (i, i + 1) else 0 for q in range(n)] for i in range(n - 1)])
        hx = tct.PauliStringSum2COO([[1 if q == i else 0 for q in range(n)] for i in range(n)])
    zz, xs = (_hermitian_mvp(h.to_sparse_csr()) for h in (hzz, hx))
    c = tct.AnalogCircuit(n, device=device)
    c.h_layer()
    for l in range(nl):
        c.zzrx_layer(pairs, p[l, 0, : n - 1], p[l, 1])
    c.add_analog_block(lambda t: (lambda v: zz(v) + omega * torch.sin(np.pi * t / T) * xs(v)), T,
                       atol=ANALOG_ODE_ATOL)
    for q in range(n):
        c.rx(q, theta=0.1 * (q + 1))
    h0 = torch.as_tensor(analog_local_hamiltonian(local), dtype=tct.config.torch_dtype(), device=device)
    c.add_analog_block(lambda t: (1 + t) * h0, T, index=list(range(local)), atol=ANALOG_ODE_ATOL)
    return c


def analog_stack_kernels(kst, n, nl):
    """The stack's launches on (a)'s value and gradient: K2 once (the fused
    pair under ``FUSE_GRAND``) or K1 a layer forward, and K3 a layer
    backward (the circuit hands a state to the ODE, so the matrix-level
    boundary: K4 rides only the Ising energy's angle-level one)."""
    nrow, _, nouter, _ = kst._shapes(n)
    grand = (kst.FUSE_GRAND and kst.FUSE_LANE and not kst.FUSE_ROWM and nouter >= 1 and nl % 2 == 0
             and nrow <= kst.MAX_GRAND_ROW_QUBITS)
    return {**({"grand_zzrx_fwd": 1} if grand else {"zzrx_fwd": nl}), "zzrx_bwd": nl}


def fgs_bonds(L):
    """A hopping layer's bonds: the even ones, then the odd ones."""
    return [(i, i + 1) for i in range(0, L - 1, 2)] + [(i, i + 1) for i in range(1, L - 1, 2)]


def fgs_inputs(L, layers, meas, block, nangles, seed=47):
    """Phase 20 (b)'s seeded inputs: the hopping χ a layer and bond (and a
    second state's last layer, 0.01 away), a random BdG M (hopping plus
    pairing, norm O(1)), the measured sites and their uniforms, the charge
    moment's and the asymmetry's angles, the nearest-neighbour hopping M of
    the energy."""
    from tensorcircuit_ng_tpu_torch.models.fgs import FGSSimulator

    rng = np.random.default_rng(seed)
    nb = L - 1
    chi = 0.4 * (rng.normal(size=(layers, nb)) + 1j * rng.normal(size=(layers, nb)))
    h = rng.normal(size=(L, L)) + 1j * rng.normal(size=(L, L))
    d = rng.normal(size=(L, L)) + 1j * rng.normal(size=(L, L))
    hop = np.diag(-np.ones(L - 1), 1) + np.diag(-np.ones(L - 1), -1)
    return {
        "chi": chi, "chi2": chi[-1] + 0.01 * (rng.normal(size=nb) + 1j * rng.normal(size=nb)),
        "m": FGSSimulator.bdg((h + h.conj().T) / (2 * np.sqrt(L)), (d - d.T) / (2 * np.sqrt(L))),
        "sites": rng.choice(L, size=meas, replace=False), "status": rng.random(meas),
        "cm_angles": rng.uniform(-np.pi, np.pi, size=2), "angles": rng.uniform(-np.pi, np.pi, size=(nangles, 2)),
        "hop": FGSSimulator.bdg(hop, np.zeros((L, L))), "L": L, "layers": layers, "block": block,
    }


def fgs_layers(tct, x, device, last=None):
    """Néel filling and the hopping layers on ``device``; ``last`` replaces
    the last layer's χ (a leaf for the gradient)."""
    import torch

    L = x["L"]
    f = tct.FGSSimulator(L, filled=range(0, L, 2), device=device)
    chi = torch.as_tensor(x["chi"]).to(device=device, dtype=tct.config.torch_dtype())
    for l in range(x["layers"]):
        cl = last if (last is not None and l == x["layers"] - 1) else chi[l]
        for b, (i, j) in enumerate(fgs_bonds(L)):
            f.evol_hp(i, j, cl[b])
    return f


def _fgs_values(tct, x, device, timed):
    """Phase 20 (b) on ``device``: the readouts held across devices and the
    invariants on the device itself."""
    import torch

    L, cdt = x["L"], tct.config.torch_dtype()
    out = {}
    last = torch.as_tensor(x["chi"][-1]).to(device=device, dtype=cdt).requires_grad_()
    hop = torch.as_tensor(x["hop"]).to(device=device, dtype=cdt)

    def hopping():
        f = fgs_layers(tct, x, device, last)
        e = torch.real(torch.sum(hop * f.get_cmatrix().T)) / 2
        (g,) = torch.autograd.grad(e, last)
        return f, e, g

    f, e, g = timed(f"(b) Néel and {x['layers']} hopping layers ({x['layers'] * (L - 1)} evol_hp), the energy "
                    f"tr(M C)/2 and its gradient in the last layer's {L - 1} χ", hopping)
    out["energy"], out["grad"] = e.item(), g.detach().cpu()
    f = tct.FGSSimulator(L, alpha=f.alpha.detach(), device=device)
    c = f.get_cmatrix()
    out["c hop"] = c.cpu()
    out["number"] = torch.sum(torch.real(torch.diagonal(c)[L:])).item()
    other = fgs_layers(tct, {**x, "chi": np.concatenate([x["chi"][:-1], x["chi2"][None]])}, device)
    out["overlap"] = timed(f"(b) overlap with a second state (|det| of a {L}x{L} matrix by QR)",
                           lambda: f.overlap(other)).item()
    timed(f"(b) evol_hamiltonian of a random BdG M ({2 * L}x{2 * L} matrix_exp)", lambda: f.evol_hamiltonian(x["m"], 0.3))
    status = torch.as_tensor(x["status"]).to(device)
    out["outcomes"] = timed(f"(b) cond_measure on {len(x['sites'])} sites (an exact projection and a QR each)",
                            lambda: torch.stack([f.cond_measure(int(i), status[k]) for k, i in
                                                 enumerate(x["sites"])])).cpu()
    c = f.get_cmatrix()
    out["c final"] = c.cpu()
    out["measured occupations"] = torch.stack([f.occupation(int(i)) for i in x["sites"]]).cpu()
    out["idempotent"] = (c @ c - c).abs().max().item()
    out["hermitian"] = (c - c.mH).abs().max().item()
    half = range(L // 2)
    out["entropy"] = timed(f"(b) entropy of {L // 2} sites", lambda: f.entropy(half)).item()
    out["renyi"] = f.renyi_entropy(half, 2).item()
    trace = list(range(x["block"], L))
    out["charge moment"] = complex(f.charge_moment(x["cm_angles"], 2, trace))
    out["asymmetry"] = timed(f"(b) renyi_entanglement_asymmetry(n=2), {len(x['angles'])} angles, a {x['block']}-site "
                             f"block", lambda: f.renyi_entanglement_asymmetry(2, trace, status=x["angles"])).item()
    return out


def pp_circuit(tct, n, layers, seed=53, **kw):
    """Phase 20 (c)'s circuit: h_layer and one zzrx_layer (fused items),
    then ``layers`` brick layers of rx and rz on every qubit and cnot and
    rzz on alternating pairs.  Returns the circuit and its QIR cut into
    ``layers`` segments (the fused items with the first)."""
    rng = np.random.default_rng(seed)
    c = tct.Circuit(n, **kw)
    c.h_layer()
    c.zzrx_layer([(i, i + 1) for i in range(n - 1)], 0.5 * rng.normal(size=n - 1), 0.5 * rng.normal(size=n))
    bounds = [0]
    for layer in range(layers):
        for q in range(n):
            c.rx(q, theta=float(rng.normal()))
            c.rz(q, theta=float(rng.normal()))
        for q in range(layer % 2, n - 1, 2):
            c.cnot(q, q + 1)
            c.rzz(q, q + 1, theta=float(rng.normal()))
        bounds.append(len(c.to_qir()))
    qir = c.to_qir()
    return c, [qir[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def symbol_circuit(tct, n, layers, **kw):
    """Phase 20 (d)'s circuit over the symbols θ and φ: a layer is rx(θ (q+1)/n)
    or ry(φ + q) on every qubit, cnots on alternating pairs and rzz(θ or φ)
    on the chain.  Returns the circuit and the symbols."""
    import sympy as sp

    th, ph = sp.symbols("theta phi", real=True)
    c = tct.SymbolCircuit(n, **kw)
    for layer in range(layers):
        for q in range(n):
            if layer % 2 == 0:
                c.rx(q, theta=th * (q + 1) / n)
            else:
                c.ry(q, theta=ph + q)
        for q in range(layer % 2, n - 1, 2):
            c.cnot(q, q + 1)
        for q in range(n - 1):
            c.rzz(q, q + 1, theta=ph if q % 2 else th)
    return c, (th, ph)


def _slice_values(tct, dev, sizes, timed=None, counters=()):
    """What phase 20 holds across devices, computed on ``dev``: (a) ⟨Z_0
    Z_1⟩ of the analog circuit, its gradients in Ω and the zz angles (and
    the stack's launches on a card), (b) :func:`_fgs_values`, (c) the
    truncated propagation's scan over the brick layers."""
    import torch

    s = sizes
    timed = timed or (lambda label, fn: fn())
    out = {}
    n, nl = s["a_n"], s["a_nl"]
    p = tct.convert.params(np.random.default_rng(42).normal(size=(nl, 2, N))[:, :, :n] * 0.1, dev).requires_grad_()
    omega = torch.tensor(s["a_omega"], dtype=torch.float32, device=dev, requires_grad=True)
    c = timed(f"(a) AnalogCircuit n={n}, its blocks' COO as CSR", lambda: analog_circuit(
        tct, p, omega, n, nl, s["a_T"], s["a_local"], dev))
    _reset(counters)

    def value_and_grad():
        e = torch.real(c.expectation_ps(z=[0, 1]))
        g_om, g_p = torch.autograd.grad(e, (omega, p))
        return e, g_om, g_p

    e, g_om, g_p = timed(f"(a) <Z_0 Z_1> and its gradient in Ω and the angles (two ODE blocks)", value_and_grad)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["a launched"] = _launched(counters)
    out["a e"], out["a g omega"], out["a g zz"] = e.item(), g_om.item(), g_p[:, 0, : n - 1].detach().cpu()
    with torch.no_grad():
        out["a norm"] = torch.linalg.vector_norm(c.state()).item()
    x = fgs_inputs(s["f_L"], s["f_layers"], s["f_meas"], s["f_block"], s["f_angles"])
    out.update({f"b {k}": v for k, v in _fgs_values(tct, x, dev, timed).items()})
    ps = [0] * s["p_wide"]
    ps[s["p_wide"] // 2 - 1] = ps[s["p_wide"] // 2] = 3
    cw, segs = pp_circuit(tct, s["p_wide"], s["p_layers"], device=dev)
    eng = timed(f"(c) PauliPropagationEngine(n={s['p_wide']}, k={s['p_wide_k']}), the basis on the device",
                lambda: tct.PauliPropagationEngine(s["p_wide"], s["p_wide_k"], device=dev))
    out["c dim"] = eng.dim
    out["c scan"] = timed(f"(c) compute_expectation_scan over {s['p_layers']} segments ({len(cw.to_qir())} items, "
                          f"the maps built)", lambda: eng.compute_expectation_scan(segs, ps)).cpu()
    out["c engine"], out["c circuit"], out["c ps"] = eng, cw, ps
    return out


def _slice_reference(tct, **sizes):
    """Phase 20's CPU references: :func:`_slice_values` on the CPU."""
    import torch

    s = {**SLICE_SIZES, **sizes}
    t0 = time.perf_counter()
    out = _slice_values(tct, torch.device("cpu"), s)
    for key in ("c engine", "c circuit", "c ps"):
        del out[key]
    out["seconds"] = time.perf_counter() - t0
    return out


def _slice_checks(tct, dev, counters=(), ref=None, **sizes):
    """Phase 20's checks (a)-(d) on ``dev``: (a) and (b) against the port's
    CPU path (``ref``: :func:`_slice_reference` or a callable giving it,
    asked for after the work on ``dev``; computed here when None) and their
    invariants, (c) at k = n against the dense state and truncated against
    the CPU path, (d) the bound circuit against the substituted expression.
    Returns the routes' times (CUDA events on a card, else the wall clock)
    and peaks."""
    import sympy as sp
    import torch
    from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

    s = {**SLICE_SIZES, **sizes}
    dev = torch.device(dev)
    card = dev.type == "cuda"
    times = {}

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 20, {label}: {err} > {tol}")

    def rel(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-300)

    def timed(label, fn):
        """``fn()`` once, timed by CUDA events (card) or the wall clock,
        with its peak memory above the start (card)."""
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            times[label] = (a.elapsed_time(b), "CUDA events, one call",
                            (torch.cuda.max_memory_allocated() - base) / 2**20)
        else:
            t0 = time.perf_counter()
            out = fn()
            times[label] = ((time.perf_counter() - t0) * 1e3, "wall clock, one call", None)
        return out

    wall = [time.perf_counter()]

    def section(label):
        """The wall-clock time since the last section, timed routes included."""
        wall.append(time.perf_counter())
        times[f"section {label}"] = (1e3 * (wall[-1] - wall[-2]), "wall clock, the section", None)

    print("analog circuits, free fermions, Pauli propagation, symbolic circuits:")
    got = _slice_values(tct, dev, s, timed, counters)
    section("(a)-(c) on the device (_slice_values)")
    # (a) the analog circuit
    n = s["a_n"]
    print(f"  (a) n={n}: <Z_0 Z_1> {got['a e']:.7f}, d/dΩ {got['a g omega']:.7f}, |ψ| {got['a norm']:.8f}; "
          f"launched {got['a launched']}")
    if card and counters:
        want = analog_stack_kernels(kst, n, s["a_nl"])
        if got["a launched"] != want:
            _fail(f"phase 20 (a): the stack launched {got['a launched']}, not {want}")
    check("(a) ||ψ| - 1|", abs(got["a norm"] - 1.0), NORM_ATOL)
    th = 0.7
    plain = tct.Circuit(n, device=dev)
    blocked = tct.AnalogCircuit(n, device=dev)
    for c in (plain, blocked):
        c.h_layer()
        c.cnot(0, 1)
    plain.rx(3, theta=th)
    xm = torch.tensor([[0, 1], [1, 0]], dtype=tct.config.torch_dtype(), device=dev)
    blocked.add_analog_block(lambda t: th / (2 * s["a_T"]) * xm, s["a_T"], index=[3])
    with torch.no_grad():
        check("(a) max |local block θ/(2T) X - rx(θ)|", (blocked.state() - plain.state()).abs().max().item(),
              ANALOG_ATOL)
    section("(a) the local block against rx")
    # (c) exact propagation against the dense state on this device
    n1, k1 = s["p_n"], s["p_k"]
    c1, _ = pp_circuit(tct, n1, s["p_layers"], device=dev)
    ps1 = [0] * n1
    ps1[n1 // 2 - 1] = ps1[n1 // 2] = 3
    eng1 = timed(f"(c) PauliPropagationEngine(n={n1}, k={k1}), the basis on the device",
                 lambda: tct.PauliPropagationEngine(n1, k1, device=dev))
    v1 = timed(f"(c) exact propagation, n={n1} k={k1} ({eng1.dim} strings), the maps built",
               lambda: eng1.propagate(c1, ps1))
    v2 = timed(f"(c) the same, the maps cached", lambda: eng1.propagate(c1, ps1))
    if not torch.equal(v1, v2):
        _fail("phase 20 (c): two propagations of one input differ")
    dense = torch.real(c1.expectation_ps(z=[n1 // 2 - 1, n1 // 2])).item()
    prop = eng1.expectation_zero_state(v1).item()
    print(f"  (c) n={n1} k={k1}: {eng1.dim} strings, <Z Z> propagated {prop:.7f}, dense {dense:.7f}; the same bits twice")
    check(f"(c) |propagated - dense|, n={n1} k={k1}", abs(prop - dense), SLICE_ATOL)
    eng, cw, ps = got["c engine"], got["c circuit"], got["c ps"]
    zz = timed(f"(c) pauli_propagation(n={s['p_wide']}, k={s['p_wide_k']})",
               lambda: tct.pauli_propagation(cw, ps, k=s["p_wide_k"])).item()
    rng = np.random.default_rng(59)
    u = torch.as_tensor(np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0],
                        dtype=tct.config.torch_dtype(), device=dev)
    coeffs = eng.observable_vector(ps)
    wires = (0, s["p_wide"] - 1)  # a support no gate of the circuit has
    timed(f"(c) one two-qubit gate on {eng.dim} strings, its maps built", lambda: eng.apply_gate(coeffs, u, wires))
    timed(f"(c) the same gate, its maps cached", lambda: eng.apply_gate(coeffs, u, wires))
    held = sum(t.numel() * t.element_size() for maps in eng._gate_map_cache.values() for t in maps if t is not None)
    print(f"  (c) n={s['p_wide']} k={s['p_wide_k']}: {eng.dim} strings and the sink; <Z Z> {zz:.7f}; scan "
          f"{np.array2string(got['c scan'].numpy(), precision=6)}; {len(eng._gate_map_cache)} wire tuples' maps "
          f"held, {held / 2**20:.1f} MiB")
    times[f"(c) the cached maps of {len(eng._gate_map_cache)} wire tuples (bytes held)"] = (0.0, "not a time",
                                                                                          held / 2**20)
    check("(c) |pauli_propagation - the scan's last value|", abs(zz - got["c scan"][-1].item()), SLICE_ATOL)
    section("(c) exact propagation, pauli_propagation and one gate")
    # (d) the symbolic circuit and F14's probe
    sc, (sth, sph) = symbol_circuit(tct, s["s_n"], s["s_layers"], device=dev)
    vals = {sth: 0.3, sph: -0.7}
    wf = timed(f"(d) SymbolCircuit n={s['s_n']}, {len(sc.to_qir())} gates: wavefunction() (host sympy)",
               lambda: sc.wavefunction())
    sub = np.asarray(sp.lambdify((sth, sph), wf, "numpy", cse=True)(0.3, -0.7), dtype=complex).reshape(-1)
    bound = timed("(d) to_circuit(bindings).state() on the device", lambda: sc.to_circuit(vals).state())
    check("(d) max |bound state - substituted wavefunction|", float(np.abs(bound.cpu().numpy() - sub).max()), SLICE_ATOL)
    probe = tct.SymbolCircuit(2, inputs=np.array([0, 1, 0, 0], dtype=complex), device=dev)
    probe.rx(0, theta=sth)
    probe.cnot(0, 1)
    sym = np.asarray(sp.N(probe.wavefunction().subs({sth: 0.3})), dtype=complex).reshape(-1)
    check("(d) F14 probe: max |to_circuit state - symbolic state|",
          float(np.abs(probe.to_circuit({sth: 0.3}).state().cpu().numpy() - sym).max()), SLICE_ATOL)
    section("(d) the symbolic circuit (host sympy, lambdify with cse) and F14's probe")
    # (b) the invariants on this device
    x = fgs_inputs(s["f_L"], s["f_layers"], s["f_meas"], s["f_block"], s["f_angles"])
    check("(b) max |C² - C|", got["b idempotent"], FGS_PROJ_ATOL)
    check("(b) max |C - C†|", got["b hermitian"], FGS_PROJ_ATOL)
    check(f"(b) |Σ occupations - {s['f_L'] // 2}| after the hopping layers", abs(got["b number"] - s["f_L"] // 2),
          FGS_NUMBER_ATOL)
    check("(b) max |occupation - outcome| of the measured sites",
          (got["b measured occupations"] - got["b outcomes"]).abs().max().item(), FGS_OUTCOME_ATOL)
    print(f"  (b) L={s['f_L']}: E {got['b energy']:.6f}, outcomes {''.join(str(int(o)) for o in got['b outcomes'])}, "
          f"S {got['b entropy']:.6f}, S_2 {got['b renyi']:.6f}, Z_2 {got['b charge moment']:.4e}, asymmetry "
          f"{got['b asymmetry']:.6f}, overlap {got['b overlap']:.6f}")
    # (a), (b), (c) against the CPU path
    reference = got if (ref is None and not card) else _slice_reference(tct, **sizes) if ref is None else (
        ref() if callable(ref) else ref)
    check("(a) |<Z_0 Z_1> - CPU|", abs(got["a e"] - reference["a e"]), ANALOG_ATOL)
    check("(a) |d/dΩ - CPU|", abs(got["a g omega"] - reference["a g omega"]), ANALOG_ATOL)
    check("(a) max |d/dzz - CPU|", (got["a g zz"] - reference["a g zz"]).abs().max().item(), ANALOG_ATOL)
    if not torch.equal(got["b outcomes"], reference["b outcomes"]):
        _fail(f"phase 20 (b): outcomes {got['b outcomes'].tolist()} differ from the CPU path's "
              f"{reference['b outcomes'].tolist()}")
    for key in ("energy", "grad", "c hop", "overlap", "c final", "entropy", "renyi", "charge moment", "asymmetry"):
        check(f"(b) {key}: relative |card - CPU|", rel(got[f"b {key}"], reference[f"b {key}"]), FGS_RTOL)
    if got["c dim"] != reference["c dim"]:
        _fail(f"phase 20 (c): {got['c dim']} strings, the CPU path {reference['c dim']}")
    check("(c) max |scan - CPU|", (got["c scan"] - reference["c scan"]).abs().max().item(), SLICE_ATOL)
    section("(b)'s invariants and the comparisons with the CPU path")
    return times


def _slice_phase(tct, card, counters, job):
    """Phase 20: :func:`_slice_checks` on the card against the CPU references
    of the child process, then its times."""
    t0 = time.perf_counter()
    wait = {}

    def reference():
        ref, wait["s"] = _await_reference(job, "slice")
        print(f"phase 20 CPU references (the child process): waited {wait['s']:.1f} s; {ref['seconds']:.1f} s there")
        return ref

    times = _slice_checks(tct, "cuda", counters, ref=reference)
    for label, (ms, how, peak) in times.items():
        mem = f", peak {peak:.1f} MiB above the start" if peak is not None else ""
        print(f"phase 20 time, {label}: {ms:.3f} ms ({how}){mem}, {card}")
    print(f"phase 20 wall time: {time.perf_counter() - t0:.1f} s (of which waiting {wait.get('s', 0.0):.1f} s)")


#: phase 21, the parallel engines: (a) the sharded VQE step's width and
#: shard count, (b) the mixed forward's width and shard counts, its shots,
#: (c) the term-sharded TFIM's width and depth and the contracted grid
#: (rows, cols, depth) with its slice target, (e) the GHZ width and shots,
#: (f) the width of F19's channel circuit
PAR_SIZES = {"a_n": 28, "a_shards": 4, "b_n": 30, "b_shards": (4, 8), "shots": 8192, "c_n": N, "c_nl": L,
             "c_grid": (4, 4, 8), "c_target": 2**7, "e_n": 10, "e_shots": 8192, "f_n": N}
PAR_SMALL = {"a_n": 10, "a_shards": 4, "b_n": 9, "b_shards": (2, 4), "shots": 512, "c_n": 8, "c_nl": 2,
             "c_grid": (3, 3, 4), "c_target": 2**3, "e_n": 6, "e_shots": 2048, "f_n": 8}
#: the sharded energy against the dense one, relative
PAR_ENERGY_RTOL = 1e-5
#: the sharded gradient against the dense one (float32 sums over 2^28
#: amplitudes in another order), as the JAX package holds its own
PAR_GRAD_ATOL = 2e-4
#: the gathered state and the readouts against the dense engine's
PAR_STATE_ATOL = 1e-5
#: each shot within this of its float64 cdf interval (the bracket rule)
PAR_BRACKET_TOL = 1e-6
#: the mitigated <Z...Z> within this many standard errors of the exact value
PAR_SIGMAS = 5.0
#: the readout error of (e): [P(0|0), P(1|1)] on every qubit
PAR_READOUT = (0.97, 0.95)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_mixed_circuit(tct, n, status, **kw):
    """(b)'s mixed QIR: h_layer, a ring zzrx_layer, cnot(0, 2n/3), rzm,
    multicz and a depolarizing ``unitary_kraus`` on top wire 1."""
    rng = np.random.default_rng(29)
    c = tct.Circuit(n, **kw)
    c.h_layer()
    c.zzrx_layer([(i, (i + 1) % n) for i in range(n)], rng.normal(size=n) * 0.3, rng.normal(size=n) * 0.4)
    c.cnot(0, 2 * n // 3)
    c.rzm(1, n // 2 + 2, n - 1, theta=0.3)
    c.multicz(0, n // 3, n - 5)
    paulis = [np.eye(2), np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0])]
    c.unitary_kraus([np.sqrt(p) * m for p, m in zip((0.7, 0.1, 0.1, 0.1), paulis)], 1, status=status)
    return c


def par_probe_circuit(tct, n, **kw):
    """(f)'s input, F19's probe: h and ry(0.2 (q + 1)) on every qubit, then
    cnot(0, 3) and cnot(1, 4)."""
    c = tct.Circuit(n, **kw)
    for q in range(n):
        c.h(q)
        c.ry(q, theta=0.2 * (q + 1))
    c.cnot(0, 3)
    c.cnot(1, 4)
    return c


#: (f)'s channels, each with a fixed status: on top wire 1 or 0 of 4 shards
PAR_CHANNELS = {
    "amplitudedamping(1, gamma=0.3)": lambda c: c.amplitudedamping(1, gamma=0.3, status=0.35),
    "general_kraus([sqrt(0.7) I, sqrt(0.3) Z], 0)": lambda c: c.general_kraus(
        [np.sqrt(0.7) * np.eye(2), np.sqrt(0.3) * np.diag([1.0, -1.0])], 0, status=0.5),
    "reset(0)": lambda c: c.reset(0, status=0.4),
    "cond_measure(1)": lambda c: c.cond_measure(1, status=0.3),
    "amplitudedamping on a local wire": lambda c: c.amplitudedamping(c.nqubits - 1, gamma=0.3, status=0.35),
}


def _bracket_miss_cdf(idx, u, cdf):
    """:func:`bracket_miss` on a float64 cdf already on the device."""
    import torch

    idx = idx.to(torch.int64).reshape(-1)
    u = u.to(torch.float64).reshape(-1)
    lo = torch.where(idx > 0, cdf[torch.clamp(idx - 1, min=0)], torch.zeros_like(u))
    return torch.max(torch.maximum(lo - u, u - cdf[idx])).item()


def _parallel_checks(tct, dev, counters=(), **sizes):
    """Phase 21's checks (a)-(e) on ``dev``, the sharded engine (in-process
    meshes of shards on ``dev``) against the dense engine on the same
    device; (d) on a one-rank process group (NCCL on a card, gloo on the
    CPU).  Returns the routes' times (CUDA events on a card, else the wall
    clock) and peak memory above the start."""
    import torch
    import torch.distributed as dist
    from tensorcircuit_ng_tpu_torch import experimental, parallel
    from tensorcircuit_ng_tpu_torch.core import statevec
    from tensorcircuit_ng_tpu_torch.results import ReadoutMit

    s = {**PAR_SIZES, **sizes}
    dev = torch.device(dev)
    card = dev.type == "cuda"
    times = {}
    t0 = time.perf_counter()

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 21, {label}: {err} > {tol}")

    def part(label):
        held = f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB held" if card else ""
        print(f"  ({label}) starts at {time.perf_counter() - t0:.1f} s{held}")

    def sync():
        if card:
            torch.cuda.synchronize()

    def timed(label, fn, reps=3):
        """``fn()``, its time and its peak memory above the start."""
        sync()
        if card:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            ms = _time_ms(fn, reps=reps, inner=1, warmup=0)
            times[label] = (ms, "CUDA events, median of %d" % reps, peak)
        else:
            t = time.perf_counter()
            out = fn()
            times[label] = ((time.perf_counter() - t) * 1e3, "wall clock, one call", None)
        return out

    def mesh(k, axis="sv"):
        return parallel.Mesh([dev] * k, (axis,))

    def forward(c):
        """``c``'s state from its first item, kept for the readouts."""
        c._state_cache = None
        return c.state()

    # ---- (a) the sharded VQE step ------------------------------------
    part("a")
    n, k = s["a_n"], s["a_shards"]
    pairs = [(i, (i + 1) % n) for i in range(n)]
    p = torch.tensor(np.random.default_rng(42).normal(size=(2, 2, n)) * 0.2, dtype=torch.float32, device=dev,
                     requires_grad=True)

    def vqe_step(m=None):
        c = tct.Circuit(n, mesh=m) if m is not None else tct.Circuit(n, device=dev)
        c.h_layer()
        for layer in range(2):
            c.zzrx_layer(pairs, p[layer, 0], p[layer, 1])
        e = c.expectation_zzx_energy(pairs, 1.0, 0.7)
        return e.detach(), torch.autograd.grad(e, p)[0]

    ma = mesh(k)
    _reset(counters)
    e_s, g_s = vqe_step(ma)
    sync()
    launched = _launched(counters)
    print(f"  (a) launches of the sharded step (n={n}, {k} shards, 2 layers): {launched}")
    if card and (launched.get("zzrx_fwd") != 2 * k or launched.get("zzrx_bwd") != 2 * k
                 or set(launched) - {"zzrx_fwd", "zzrx_bwd"}):
        _fail(f"phase 21 (a): K1 and K3 not launched {2 * k} times each (one a shard a layer): {launched}")
    e_d, g_d = vqe_step()
    check(f"(a) energy n={n} sharded over {k} against dense, relative", abs(e_s.item() - e_d.item()) / abs(
        e_d.item()), PAR_ENERGY_RTOL)
    check("(a) gradient, sharded against dense", (g_s - g_d).abs().max().item(), PAR_GRAD_ATOL)
    timed(f"(a) the sharded VQE step n={n}, {k} shards of one card (value and gradient)", lambda: vqe_step(ma))
    timed(f"(a) the dense VQE step n={n} (K2/K4)", lambda: vqe_step())
    del e_s, g_s, e_d, g_d

    # ---- (b) the mixed forward over 2 shard counts ---------------------
    part("b")
    n = s["b_n"]
    rng = np.random.default_rng(31)
    u = torch.tensor(rng.uniform(size=s["shots"]), dtype=torch.float32, device=dev)
    mst = np.array([0.3, 0.6, 0.8])
    wires = [0, n // 2, n - 1]
    bits = [int(b) for b in rng.integers(0, 2, size=n)]
    with torch.no_grad():
        cd = par_mixed_circuit(tct, n, 0.83, device=dev)
        dense = timed(f"(b) the dense forward n={n}", lambda: forward(cd), reps=1)
        want = {"amp": cd.amplitude(bits), "prob": statevec.marginal_probability(dense, wires),
                "ps": cd.expectation_ps(x=[0], y=[n // 2], z=[n - 1]), "m": cd.measure_jit(*wires, with_prob=True,
                                                                                          status=mst)}
        pd = torch.abs(dense) ** 2
        cdf = torch.cumsum(pd.to(torch.float64), 0)
        cdf = cdf / cdf[-1]
        del pd
        for k in s["b_shards"]:
            cs = par_mixed_circuit(tct, n, 0.83, mesh=mesh(k))
            psi = timed(f"(b) the sharded forward n={n}, {k} shards", lambda: forward(cs), reps=1)
            full = timed(f"(b) {k} shards: gather", psi.gather, reps=1)
            err = max((full[i:i + 2**26] - dense[i:i + 2**26]).abs().max().item() for i in range(0, 2**n, 2**26))
            del full
            check(f"(b) {k} shards: the gathered state against the dense state", err, PAR_STATE_ATOL)
            eng = cs._mesh_engine
            amp = timed(f"(b) {k} shards: amplitude", lambda: cs.amplitude(bits))
            check(f"(b) {k} shards: amplitude", abs(complex(amp) - complex(want["amp"])), PAR_STATE_ATOL)
            prob = timed(f"(b) {k} shards: probability of wires {wires}", lambda: eng.probability(psi, wires))
            check(f"(b) {k} shards: probability of wires {wires}", (prob - want["prob"]).abs().max().item(),
                  PAR_STATE_ATOL)
            ps = timed(f"(b) {k} shards: expectation_ps x top, y and z local",
                       lambda: cs.expectation_ps(x=[0], y=[n // 2], z=[n - 1]))
            check(f"(b) {k} shards: expectation_ps", abs(complex(ps) - complex(want["ps"])), PAR_STATE_ATOL)
            idx = timed(f"(b) {k} shards: {s['shots']} shots by sample_direct",
                        lambda: cs.sample(batch=s["shots"], status=u, format="sample_int"))
            check(f"(b) {k} shards: {s['shots']} shots, bracket miss", _bracket_miss_cdf(idx, u, cdf),
                  PAR_BRACKET_TOL)
            m = timed(f"(b) {k} shards: measure_jit of wires {wires}",
                      lambda: cs.measure_jit(*wires, with_prob=True, status=mst))
            if not torch.equal(m[0], want["m"][0]):
                _fail(f"phase 21 (b): measure_jit outcomes {m[0].tolist()} against dense {want['m'][0].tolist()}")
            check(f"(b) {k} shards: measure_jit probability", abs(m[1].item() - want["m"][1].item()), PAR_STATE_ATOL)
            del cs, psi
        del cd, dense, cdf
    if card:
        torch.cuda.empty_cache()

    # ---- (c) term sharding and the distributed contractor ------------
    part("c")
    n, nl = s["c_n"], s["c_nl"]
    structures, weights = tfim_pauli_strings(n)
    open_pairs = [(i, i + 1) for i in range(n - 1)]
    pc = torch.tensor(np.random.default_rng(7).normal(size=(nl, 2, n)) * 0.3, dtype=torch.float32, device=dev,
                      requires_grad=True)
    e_ref = tfim_circuit(tct, pc, n, nl, device=dev).expectation_zzx_energy(open_pairs, 1.0, -1.0)
    g_ref = torch.autograd.grad(e_ref, pc)[0]

    def term_vg(m):
        energy = parallel.term_sharded_expectation(lambda q: tfim_circuit(tct, q, n, nl, device=dev).state(),
                                                   structures, weights, m, m.axis_names[0])
        e = energy(pc)
        return e.detach(), torch.autograd.grad(e, pc)[0]

    e_t, g_t = timed(f"(c) term_sharded_expectation, {len(weights)} TFIM strings at n={n} over 4 shards, "
                     "value and gradient", lambda: term_vg(mesh(4, "devices")))
    check("(c) term-sharded energy against the fused dense energy", abs(e_t.item() - e_ref.item()), ENERGY_ATOL)
    check("(c) term-sharded gradient", (g_t - g_ref).abs().max().item(), GRAD_ATOL)
    rows, cols, depth = s["c_grid"]
    ang = torch.tensor(grid_angles(rows * cols, depth), dtype=torch.float32, device=dev, requires_grad=True)
    zq = (rows * cols) // 2 - 1

    def ir_fn(a):
        return grid_circuit(tct, rows, cols, depth, a, device=dev).expectation_before((tct.gates.z(), [zq]))

    v_ref = grid_circuit(tct, rows, cols, depth, ang, device=dev).expectation((tct.gates.z(), [zq]))
    l_ref = torch.abs(v_ref) ** 2
    gl_ref = torch.autograd.grad(l_ref, ang)[0]
    part("c, the slice search")
    dc = parallel.DistributedContractor(ir_fn, ang.detach(), options={"target_size": s["c_target"]},
                                        mesh=mesh(4, "devices"))
    print(f"  (c) DistributedContractor {rows}x{cols} depth {depth} <Z_{zq}>: {dc.report()}")
    if dc.report()["num_slices"] < 2:
        _fail(f"phase 21 (c): the contraction was not sliced: {dc.report()}")
    v = timed(f"(c) DistributedContractor value, {dc.report()['num_slices']} slices over 4 shards",
              lambda: dc.value(ang.detach()))
    check("(c) DistributedContractor value against the dense expectation", abs(complex(v) - complex(v_ref.detach())),
          PAR_STATE_ATOL)
    l, gl = timed("(c) DistributedContractor value_and_grad of |v|^2",
                  lambda: dc.value_and_grad(ang.detach(), op=lambda x: torch.abs(x) ** 2), reps=1)
    check("(c) |v|^2 and its gradient against the dense autograd",
          max(abs(l.item() - l_ref.item()), (gl - gl_ref).abs().max().item()), GRAD_ATOL)

    # ---- (d) the process-group path, world size 1 --------------------
    part("d")
    backend = "nccl" if card else "gloo"
    parallel.initialize_distributed(f"localhost:{_free_port()}", 1, 0, backend=backend, timeout=120)
    part("d, the group initialized")
    try:
        got = experimental.broadcast_py_object({"phase": 21, "backend": backend})
        if got != {"phase": 21, "backend": backend}:
            _fail(f"phase 21 (d): broadcast_py_object gave {got}")
        gm = parallel.ProcessGroupMesh("devices")
        print(f"  (d) {gm}, backend {dist.get_backend()}")
        e_g, g_g = timed(f"(d) term_sharded_expectation over the {backend} group", lambda: term_vg(gm))
        check(f"(d) {backend}: term-sharded energy and gradient",
              max(abs(e_g.item() - e_ref.item()), (g_g - g_ref).abs().max().item()), GRAD_ATOL)
        dcg = parallel.DistributedContractor(ir_fn, ang.detach(), options={"target_size": s["c_target"]}, mesh=gm)
        l, gl = timed(f"(d) DistributedContractor value_and_grad over the {backend} group",
                      lambda: dcg.value_and_grad(ang.detach(), op=lambda x: torch.abs(x) ** 2), reps=1)
        check(f"(d) {backend}: |v|^2 and its gradient", max(abs(l.item() - l_ref.item()),
                                                            (gl - gl_ref).abs().max().item()), GRAD_ATOL)
        sm = parallel.ProcessGroupMesh("sv")
        c = tfim_circuit(tct, pc, n, nl, mesh=sm)
        e = c.expectation_zzx_energy(open_pairs, 1.0, -1.0)
        g = torch.autograd.grad(e, pc)[0]
        check(f"(d) {backend}: a one-rank group Circuit(mesh=): energy and gradient",
              max(abs(e.item() - e_ref.item()), (g - g_ref).abs().max().item()), GRAD_ATOL)
        with torch.no_grad():
            out, _ = c.measure_jit(0, n - 1)
        if out.shape != (2,) or not bool(((out == 0) | (out == 1)).all()):
            _fail(f"phase 21 (d): measure_jit over the group gave {out}")
        sync()
    finally:
        part("d, the checks ended")
        dist.destroy_process_group()

    # ---- (e) readout mitigation on the card's shots --------------------
    part("e")
    n = s["e_n"]
    c = tct.Circuit(n, device=dev)
    c.h(0)
    for i in range(n - 1):
        c.cnot(i, i + 1)
    err = [list(PAR_READOUT)] * n
    ue = torch.tensor(np.random.default_rng(5).uniform(size=s["e_shots"]), dtype=torch.float32, device=dev)
    counts = timed(f"(e) {s['e_shots']} GHZ shots n={n} with a readout error, count_dict_bin", lambda: c.sample(
        batch=s["e_shots"], allow_state=True, readout_error=err, status=ue, format="count_dict_bin"))
    p00, p11 = PAR_READOUT
    mit = ReadoutMit(lambda circuits, shots: [])
    mit.set_local_cals({q: np.array([[p00, 1 - p11], [1 - p00, p11]]) for q in range(n)})
    raw = mit.expectation(counts, z=list(range(n)), method="raw")
    got = mit.expectation(counts, z=list(range(n)), method="inverse")
    # the local inverse's estimate is the shots' mean of f(b) = prod_q
    # [(1 + p11 - p00) if b_q = 0 else -(1 + p00 - p11)] / (p00 + p11 - 1):
    # its standard error from the shots' spread of f
    f = {b: np.prod([(1 + p11 - p00) if ch == "0" else -(1 + p00 - p11) for ch in b]) / (p00 + p11 - 1) ** n
         for b in counts}
    shots = sum(counts.values())
    mean_f2 = sum(c_b * f[b] ** 2 for b, c_b in counts.items()) / shots
    sigma = np.sqrt(max(mean_f2 - got**2, 1e-12) / shots)
    print(f"  (e) <Z...Z> raw {raw:.5f}, mitigated {got:.5f}, exact 1, sigma {sigma:.5f}")
    check("(e) mitigated <Z...Z> against 1, in sigmas", abs(got - 1.0) / sigma, PAR_SIGMAS)

    # ---- (f) F19: the non-unitary channels on the shards ---------------
    part("f")
    n = s["f_n"]
    mf = mesh(4)
    with torch.no_grad():
        for label, channel in PAR_CHANNELS.items():
            cd = par_probe_circuit(tct, n, device=dev)
            branch_d = int(channel(cd))
            psi_d = cd.state()

            def on_shards():
                cs = par_probe_circuit(tct, n, mesh=mf)
                return int(channel(cs)), cs.state()

            branch_s, psi_s = timed(f"(f) {label} on 4 shards n={n} (the circuit, the channel, state())", on_shards)
            if type(psi_s).__name__ != "ShardedState":
                _fail(f"phase 21 (f): {label} left a {type(psi_s).__name__}, not a ShardedState")
            print(f"  (f) {label}: branch {branch_s} on 4 shards, {branch_d} dense")
            if branch_s != branch_d:
                _fail(f"phase 21 (f): {label} picked branch {branch_s} on the shards, {branch_d} dense")
            check(f"(f) {label}: the gathered state against the dense card circuit",
                  (psi_s.gather() - psi_d).abs().max().item(), PAR_STATE_ATOL)
    part("end")
    return times


def _parallel_phase(tct, card, counters):
    """Phase 21: :func:`_parallel_checks` on the card, then its times."""
    t0 = time.perf_counter()
    times = _parallel_checks(tct, "cuda", counters)
    for label, (ms, how, peak) in times.items():
        mem = f", peak {peak:.1f} MiB above the start" if peak is not None else ""
        print(f"phase 21 time, {label}: {ms:.3f} ms ({how}){mem}, {card}")
    print(f"phase 21 wall time: {time.perf_counter() - t0:.1f} s")


#: phase 22, the I/O, compiler and cloud layer: (a) the TFIM circuit's
#: width and depth, (c) the GHZ width and its shots
IO_SIZES = {"n": N, "nl": L, "ghz_n": 10, "shots": 8192}
IO_SMALL = {"n": 8, "nl": 2, "ghz_n": 6, "shots": 2048}
#: a round trip's state against the original's (per-gate einsums against
#: the fused kernels, float32)
IO_STATE_ATOL = 1e-4
#: a value of the shots within this many standard deviations of the exact one
IO_SIGMAS = 5.0
#: a twirled circuit's readout against the original's
IO_VALUE_ATOL = 1e-5


def _io_checks(tct, dev, counters=(), **sizes):
    """Phase 22's checks (a)-(d) on ``dev``; returns each part's wall time
    (ms)."""
    import contextlib
    import io
    import random

    import torch
    from tensorcircuit_ng_tpu_torch import compiler
    from tensorcircuit_ng_tpu_torch.cloud import apis, wrapper
    from tensorcircuit_ng_tpu_torch.core import contractor
    from tensorcircuit_ng_tpu_torch.results import qem

    s = {**IO_SIZES, **sizes}
    dev = torch.device(dev)
    card = dev.type == "cuda"
    times = {}

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 22, {label}: {err} > {tol}")

    def timed(label, fn):
        if card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        if card:
            torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t) * 1e3
        return out

    # ---- (a) the TFIM circuit through JSON, OpenQASM and the compiler --
    n, nl = s["n"], s["nl"]
    pairs = [(i, i + 1) for i in range(n - 1)]
    p = torch.tensor(np.random.default_rng(22).normal(size=(nl, 2, n)) * 0.3, dtype=torch.float32, device=dev)
    c = tfim_circuit(tct, p, n, nl, device=dev)
    _reset(counters)
    with torch.no_grad():
        psi = timed(f"(a) the TFIM state n={n} L={nl}", c.state)
    launched = _launched(counters)
    print(f"  (a) launches of the TFIM state: {launched}")
    if card and n == N and launched.get("grand_zzrx_fwd") != 1:
        _fail(f"phase 22 (a): K2 not launched once for the n={n} state: {launched}")
    text = timed("(a) to_json", c.to_json)
    qasm = timed("(a) to_openqasm", c.to_openqasm)
    print(f"  (a) JSON {len(text)} characters, OpenQASM {len(qasm.splitlines())} lines")
    with torch.no_grad():
        cj = timed("(a) from_json", lambda: tct.Circuit.from_json(text, device=dev))
        cq = timed("(a) from_openqasm", lambda: tct.Circuit.from_openqasm(qasm, device=dev))
        cc, _ = timed("(a) compiler.simple_compile", lambda: compiler.simple_compile(c))
        for label, other in (("from_json", cj), ("from_openqasm", cq), ("simple_compile", cc)):
            if other.device != c.device:
                _fail(f"phase 22 (a): {label} built its circuit on {other.device}, not {c.device}")
            phi = timed(f"(a) the state of {label}'s circuit ({len(other.to_qir())} QIR items)", other.state)
            check(f"(a) {label}: max |dpsi| against the original", (phi - psi).abs().max().item(), IO_STATE_ATOL)

    def energy_grad(make):
        q = p.clone().requires_grad_(True)
        e = make(q).expectation_zzx_energy(pairs, 1.0, -1.0)
        return e.detach(), torch.autograd.grad(e, q)[0]

    e0, g0 = energy_grad(lambda q: tfim_circuit(tct, q, n, nl, device=dev))
    _reset(counters)
    e1, g1 = timed("(a) the compiled circuit's energy and gradient",
                   lambda: energy_grad(lambda q: compiler.simple_compile(tfim_circuit(tct, q, n, nl, device=dev))[0]))
    launched = _launched(counters)
    print(f"  (a) launches of the compiled circuit's energy and gradient: {launched}")
    if card and n == N and (launched.get("grand_zzrx_fwd") != 1 or launched.get("grand_zzrx_bwd") != 1):
        _fail(f"phase 22 (a): K2 and K4 not launched once each for the compiled circuit: {launched}")
    check("(a) the compiled circuit's energy and gradient against the original's",
          max(abs(e1.item() - e0.item()), (g1 - g0).abs().max().item()), IO_VALUE_ATOL)

    # ---- (b) the dense dry run --------------------------------------
    contractor._INFO_PRINTED.discard(("dense", n, 2, len(c.to_qir())))
    out = io.StringIO()
    with tct.runtime_contractor("greedy", contraction_info=True, debug_level=2), contextlib.redirect_stdout(out):
        z = timed("(b) expectation_ps under debug_level=2", lambda: c.expectation_ps(z=[0, 1]))
    printed = out.getvalue()
    print("  (b) " + printed.strip().replace("\n", "\n  (b) "))
    if tuple(z.shape) != () or z.item() != 0 or z.dtype != torch.complex64 or "log10[FLOPs]" not in printed:
        _fail(f"phase 22 (b): the dry run gave {z!r} and printed {printed!r}")

    # ---- (c) GHZ counts from the local cloud provider -----------------
    g = tct.Circuit(s["ghz_n"], device=dev)
    g.h(0)
    for q in range(s["ghz_n"] - 1):
        g.cnot(q, q + 1)
    shots = s["shots"]
    u = torch.tensor(np.random.default_rng(8).uniform(size=shots), dtype=torch.float32, device=dev)
    task = timed(f"(c) {shots} GHZ shots n={s['ghz_n']} from the local provider",
                 lambda: apis.submit_task(device="local::default", circuit=g, shots=shots, status=u))
    counts = task.results()
    ends = {"0" * s["ghz_n"], "1" * s["ghz_n"]}
    if sum(counts.values()) != shots or not set(counts) <= ends:
        _fail(f"phase 22 (c): the GHZ counts are {counts}")
    check("(c) the count of |0...0> against shots / 2, in sigmas",
          abs(counts.get("0" * s["ghz_n"], 0) - shots / 2) / np.sqrt(shots / 4), IO_SIGMAS)
    pss = [[3] + [0] * (s["ghz_n"] - 2) + [3], [1] * s["ghz_n"], [3] + [0] * (s["ghz_n"] - 1)]
    exact = wrapper.batch_expectation_ps(g, pss)
    got = timed(f"(c) batch_expectation_ps of {len(pss)} strings from {shots} shots each",
                lambda: wrapper.batch_expectation_ps(g, pss, device="local::default", shots=shots, with_rem=False))
    print(f"  (c) exact {np.round(exact, 6).tolist()}, from the shots {np.round(got, 6).tolist()}")
    sigma = np.sqrt(np.maximum(1 - exact**2, 0) / shots)
    if not np.all(np.abs(got - exact) <= IO_SIGMAS * sigma + 1e-6):
        _fail(f"phase 22 (c): batch_expectation_ps {got} against {exact}, sigma {sigma}")

    # ---- (d) twirling with the compiler -------------------------------
    random.seed(22)
    zz = lambda x: float(torch.real(x.expectation_ps(z=[0, s["ghz_n"] - 1])))  # noqa: E731
    value, twirled = timed("(d) apply_rc(simplify=True), 4 twirls",
                           lambda: qem.apply_rc(g, zz, num_to_average=4))
    check("(d) the twirled <Z_0 Z_n-1> against the GHZ value", abs(value - zz(g)), IO_VALUE_ATOL)
    psi_g = g.state()
    overlap = min(abs(torch.vdot(t.state(), psi_g).item()) for t in twirled)
    check("(d) 1 - min |<twirl|GHZ>| over the twirls", 1 - overlap, IO_VALUE_ATOL)
    print(f"  (d) twirled circuits of {[len(t.to_qir()) for t in twirled]} items from {len(g.to_qir())}")
    return times


def _io_phase(tct, card, counters):
    """Phase 22: :func:`_io_checks` on the card, then its times."""
    t0 = time.perf_counter()
    times = _io_checks(tct, "cuda", counters)
    for label, ms in times.items():
        print(f"phase 22 time, {label}: {ms:.3f} ms (wall clock, one call), {card}")
    print(f"phase 22 wall time: {time.perf_counter() - t0:.1f} s, {card}")


# ---- phase 23: the ML bridges and zx/ --------------------------------------

#: phase 23's sizes: (a) the main path and its steps, (b) the hardware
#: net's width and depth, (c) L-BFGS-B's iterations, (d) the surface code
#: (phase 19 (a)'s) and its shots, the shots held against the CPU path,
#: the tableau's shots, (e) the Clifford+T circuit's width and gates
MLZX_SIZES = {"n": N, "nl": L, "steps": STEPS, "hw_n": 10, "hw_nl": 2, "lbfgs": 5,
              "sc_d": 3, "sc_rounds": 3, "sc_p": 0.01, "sc_shots": 1024, "sc_ref": 16, "sc_tab": 4096,
              "zx_n": 10, "zx_gates": 60}
#: the same checks at a CPU test's size
MLZX_SMALL = {"n": 8, "nl": 2, "steps": 2, "hw_n": 4, "hw_nl": 1, "lbfgs": 2,
              "sc_d": 2, "sc_rounds": 2, "sc_p": 0.02, "sc_shots": 256, "sc_ref": 8, "sc_tab": 400,
              "zx_n": 4, "zx_gates": 16}
#: (a): the module's energies and parameters against the bare steps (the
#: same kernels; torch.optim.SGD rounds its update as p.sub_(lr * g) may not)
MLZX_STEP_ATOL = 1e-6
#: (b), (c): a parameter-shift or jitted value and gradient against the
#: eager autograd ones (phase 4's tolerance)
MLZX_GRAD_ATOL = 1e-4
#: (d): a shot may differ from the CPU path's only this near a threshold
MLZX_BRACKET = 1e-6
#: (d): rates within this many standard errors
MLZX_SIGMAS = 5.0
#: (e): the diagram's matrix against ``Circuit.matrix()`` up to a phase
MLZX_MATRIX_ATOL = 1e-5


def clifford_t_circuit(mod, n, gates, seed=23, **kw):
    """A random Clifford+T circuit of ``gates`` gates (h, s, t, x, z, a
    CNOT or a CZ on neighbours), for either package."""
    rng = np.random.default_rng(seed)
    c = mod.Circuit(n, **kw)
    for _ in range(gates):
        r = rng.random()
        if r < 0.6:
            getattr(c, ["h", "s", "t", "x", "z", "h", "t"][rng.integers(7)])(int(rng.integers(n)))
        else:
            q = int(rng.integers(n - 1))
            (c.cnot if r < 0.85 else c.cz)(q, q + 1)
    return c


def _phase_aligned_err(a, b):
    """max |a/|a| - e^{iφ} b/|b||, φ the best phase (complex128 on the host)."""
    a = a.detach().cpu().numpy().astype(np.complex128).reshape(-1)
    b = b.detach().cpu().numpy().astype(np.complex128).reshape(-1)
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    ph = np.vdot(b, a)
    return float(np.abs(a - ph / abs(ph) * b).max())


def _mlzx_checks(tct, dev, counters=(), ref=None, **sizes):
    """Phase 23's checks (a)-(e) on ``dev``: the ML bridges on the main path
    and ``zx/``'s sampler and diagrams.  ``ref``: a callable giving phase
    19's CPU references (the tableau's detector shots), else the tableau
    runs here.  Returns each part's (ms, how, peak MiB or None)."""
    import scipy.optimize
    import torch
    from tensorcircuit_ng_tpu_torch import interfaces, torchnn, zx
    from tensorcircuit_ng_tpu_torch.backend import backend as K
    from tensorcircuit_ng_tpu_torch.interfaces import tensortrans
    from tensorcircuit_ng_tpu_torch.models import detectors as detmod
    from tensorcircuit_ng_tpu_torch.zx import scalar_graph

    s = {**MLZX_SIZES, **sizes}
    dev = torch.device(dev)
    card = dev.type == "cuda"
    times = {}

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 23, {label}: {err} > {tol}")

    def timed(label, fn):
        """``fn()`` once: CUDA events and the peak memory above the start on
        the card, the wall clock on the CPU."""
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            times[label] = (a.elapsed_time(b), "CUDA events", (torch.cuda.max_memory_allocated() - base) / 2**20)
        else:
            t = time.perf_counter()
            out = fn()
            times[label] = ((time.perf_counter() - t) * 1e3, "wall clock", None)
        return out

    def launched():
        got = _launched(counters)
        _reset(counters)
        return got

    main_path = card and s["n"] == N and s["nl"] % 2 == 0

    # ---- (a) QuantumNet around the main path, eager and under jit -----
    n, nl, steps = s["n"], s["nl"], s["steps"]
    pairs = [(i, i + 1) for i in range(n - 1)]
    g0 = np.random.default_rng(42).normal(size=(nl, 2, n)) * 0.1  # phase 4's seed

    def energy(p):
        return tfim_circuit(tct, p, n, nl, device=dev).expectation_zzx_energy(pairs, 1.0, -1.0)

    p = tct.convert.params(g0, dev).requires_grad_()
    bare = []
    for _ in range(steps):
        e = energy(p)
        (g,) = torch.autograd.grad(e, p)
        bare.append(e.item())
        with torch.no_grad():
            p.sub_(LR * g)
        bare.append(p.detach().clone())
    bare_e, bare_p = bare[0::2], bare[1::2]
    with tct.set_device(dev):
        nets = {"eager": torchnn.QuantumNet(energy, (nl, 2, n), initializer=lambda shape: g0),
                "use_jit=True": torchnn.QuantumNet(energy, (nl, 2, n), initializer=lambda shape: g0, use_jit=True)}
    for label, net in nets.items():
        opt = torch.optim.SGD(net.parameters(), lr=LR)
        _reset(counters)

        def train():
            out = []
            for _ in range(steps):
                opt.zero_grad()
                e = net()
                e.backward()
                opt.step()
                out.append((e.detach(), net.ws[0].detach().clone()))
            return out

        got = timed(f"(a) QuantumNet {label}, {steps} SGD steps n={n} L={nl}", train)
        lau = launched()
        replays = net.f.fused.replays if label != "eager" else 0
        print(f"  (a) {label}: launches {lau}; CUDA graph replays {replays}")
        if main_path:
            want = {"grand_zzrx_fwd": steps, "grand_zzrx_bwd": steps} if label == "eager" else \
                {"grand_zzrx_fwd": 2, "grand_zzrx_bwd": 2}
            if {k: lau.get(k) for k in want} != want or replays != (0 if label == "eager" else steps - 1):
                _fail(f"phase 23 (a) {label}: K2/K4 not once a step: {lau}, {replays} replays")
        de = max(abs(e.item() - be) for (e, _), be in zip(got, bare_e))
        dp = max((q - bp).abs().max().item() for (_, q), bp in zip(got, bare_p))
        check(f"(a) {label}: max |dE| against the bare steps", de, MLZX_STEP_ATOL)
        check(f"(a) {label}: max |dparams| against the bare steps", dp, MLZX_STEP_ATOL)
        print(f"  (a) {label}: E {got[0][0].item():.7f} -> {got[-1][0].item():.7f}")

    # ---- (b) HardwareNet: the parameter-shift gradient ----------------
    hn, hl = s["hw_n"], s["hw_nl"]
    hpairs = [(i, i + 1) for i in range(hn - 1)]
    h0 = np.random.default_rng(45).normal(size=(hl, 2, hn)) * 0.3

    def hw_energy(w):
        return tfim_circuit(tct, w, hn, hl, device=dev).expectation_zzx_energy(hpairs, 1.0, -1.0)

    with tct.set_device(dev):
        hw = torchnn.HardwareNet(hw_energy, (hl, 2, hn), initializer=lambda shape: h0)
    _reset(counters)
    timed(f"(b) HardwareNet forward and parameter-shift backward n={hn} L={hl} ({2 * h0.size} shifted energies)",
          lambda: hw().backward())
    print(f"  (b) launches: {launched()}")
    w = hw.ws[0].detach().clone().requires_grad_()
    (auto,) = torch.autograd.grad(hw_energy(w), w)
    check("(b) max |parameter shift - autograd|", (hw.ws[0].grad - auto).abs().max().item(), MLZX_GRAD_ATOL)

    # ---- (c) scipy's L-BFGS-B and numpy through the bridges ------------
    with tct.set_device(dev):
        fs = interfaces.scipy_optimize_interface(energy, shape=(nl, 2, n), jit=True)
        seen = []

        def objective(x):
            v, gr = fs(x)
            seen.append((x.copy(), v, gr))
            return v, gr

        res = timed(f"(c) scipy L-BFGS-B, {s['lbfgs']} iterations n={n} L={nl} (jitted value and grad)",
                    lambda: scipy.optimize.minimize(objective, g0.reshape(-1), jac=True, method="L-BFGS-B",
                                                    options={"maxiter": s["lbfgs"]}))
        worst = 0.0
        for x, v, gr in seen:
            q = torch.as_tensor(x.reshape(nl, 2, n), dtype=torch.float32, device=dev).requires_grad_()
            e = energy(q)
            (ge,) = torch.autograd.grad(e, q)
            worst = max(worst, abs(v - e.item()), float(np.abs(gr - ge.cpu().numpy().reshape(-1)).max()))
        print(f"  (c) L-BFGS-B: {res.nit} iterations, {len(seen)} evaluations, E {seen[0][1]:.7f} -> {res.fun:.7f}")
        check(f"(c) max |value or grad - the bare step's| over {len(seen)} evaluations", worst, MLZX_GRAD_ATOL)
        if not res.fun < seen[0][1]:
            _fail("phase 23 (c): L-BFGS-B did not lower the energy")
        x_np = g0.astype(np.float32)
        out = timed("(c) numpy_interface round trip of the energy",
                    lambda: interfaces.numpy_interface(energy)(x_np))
        with torch.no_grad():
            e0 = energy(tct.convert.params(g0, dev)).item()
        if not isinstance(out, np.ndarray):
            _fail(f"phase 23 (c): numpy_interface returned {type(out)}")
        check("(c) numpy_interface against the eager energy", abs(float(out) - e0), MLZX_STEP_ATOL)
        t = torch.randn(4, 2**n, device=dev)
        moved = tensortrans.general_args_to_backend(t, target_backend="torch")
        print(f"  (c) DLPack into torch: data_ptr {moved.data_ptr():#x} (the input's {t.data_ptr():#x}), "
              f"{moved.device}")
        if moved.data_ptr() != t.data_ptr() or moved.device != t.device:
            _fail("phase 23 (c): general_args_to_backend copied a tensor of the device")

    # ---- (d) StabilizerTCircuit: the surface code as one batched state --
    d_, rounds, pe, shots = s["sc_d"], s["sc_rounds"], s["sc_p"], s["sc_shots"]
    sc = surface_code_program(tct, d_, rounds, pe, tableau=True, cls=zx.StabilizerTCircuit, seed=23, device=dev)
    program, sampler, prepared = sc._compile()
    nq = sc.nqubits
    chunk = detmod.detector_chunk(shots, 2**nq, torch.complex64, dev)
    print(f"  (d) surface code d={d_}: {nq} qubits, {rounds} rounds, {len(prepared.steps)} steps, "
          f"{prepared.num_f} f-bits ({len(sampler.channels)} channels after simplification), "
          f"{prepared.num_records} records, {prepared.num_detectors} detectors; {shots} shots as a "
          f"[{shots}, 2^{nq}] state ({shots * 2**nq * 8 / 2**30:.3f} GiB), {-(-shots // chunk)} chunk(s)")
    det = timed(f"(d) sample_detectors, {shots} shots", lambda: sc.sample_detectors(shots))
    f = timed(f"(d) ChannelSampler.sample_jax, {shots} shots", lambda: sampler.sample_jax(shots)[0])
    gen = torch.Generator(device=dev).manual_seed(7)
    u = torch.rand((shots, len(prepared.visible_pos)), generator=gen, device=dev)
    comp = program.components[0]
    bits, margin = timed(f"(d) sample_fn on given f-bits and uniforms, {shots} shots",
                         lambda: comp.sample_fn(f, u, with_margin=True))
    k = s["sc_ref"]
    cpu_comp = scalar_graph.compile_program(prepared, device="cpu").components[0]
    cbits, cmargin = cpu_comp.sample_fn(f[:k].cpu(), u[:k].cpu(), with_margin=True)
    differ = (bits[:k].cpu() != cbits).any(dim=1).numpy()
    near = np.minimum(margin[:k].cpu().numpy(), cmargin.numpy())
    for i in np.nonzero(differ)[0]:
        print(f"  (d) shot {i} differs from the CPU path's; its nearest uniform lies {near[i]:.3e} from 1 - p1")
    print(f"  (d) the first {k} shots: {int(differ.sum())} differ from the CPU path's, least margin "
          f"{float(near.min()):.3e}")
    if np.any(differ & (near > MLZX_BRACKET)):
        _fail(f"phase 23 (d): shots {np.nonzero(differ & (near > MLZX_BRACKET))[0].tolist()} differ from the CPU "
              "path's away from a threshold")
    if ref is not None:
        tab_det, tab_obs = ref()["a tableau"]
    else:
        tab = surface_code_program(tct, d_, rounds, pe, tableau=True, device="cpu")
        tab_det, tab_obs = tab.sample_detectors(s["sc_tab"], seed=19)
    tab_all = np.concatenate([tab_det, tab_obs], axis=1).astype(np.float64)
    ra, rb = _rates_agree(f"(d) {shots} shots against {s['sc_tab']} tableau shots",
                          det.cpu().numpy().astype(np.float64), shots, tab_all, s["sc_tab"], check)
    print(f"  (d) rates: zx {np.array2string(ra, precision=4)}; tableau {np.array2string(rb, precision=4)}")

    def t_gate(c, r, data):
        if r == 0:
            c.t(data[len(data) // 2])

    sct = surface_code_program(tct, d_, max(rounds, 2), pe, tableau=True, cls=zx.StabilizerTCircuit, seed=29, device=dev,
                               after_round=t_gate)
    det_t = timed(f"(d) sample_detectors with a T gate, {shots} shots", lambda: sct.sample_detectors(shots))
    dense = surface_code_program(tct, d_, max(rounds, 2), pe, device=dev, after_round=t_gate)
    st, stc = detector_statuses(dense, shots, seed=23)
    dd, do = timed(f"(d) the dense sample_detector with a T gate, {shots} shots",
                   lambda: dense.sample_detector(shots, status=torch.as_tensor(st, device=dev),
                                                 statusc=torch.as_tensor(stc, device=dev), with_observable=True))
    dense_all = np.concatenate([dd.cpu().numpy(), do.cpu().numpy()], axis=1).astype(np.float64)
    ra, rb = _rates_agree(f"(d) T gate: {shots} zx shots against {shots} dense shots",
                          det_t.cpu().numpy().astype(np.float64), shots, dense_all, shots, check)
    print(f"  (d) T gate rates: zx {np.array2string(ra, precision=4)}; dense {np.array2string(rb, precision=4)}")
    if card:
        print(f"  (d) peak memory above the start: sample_detectors {times[f'(d) sample_detectors, {shots} shots'][2]:.1f}"
              f" MiB, sample_fn {times[f'(d) sample_fn on given f-bits and uniforms, {shots} shots'][2]:.1f} MiB")

    # ---- (e) a Clifford+T circuit as a ZX diagram ---------------------
    zn = s["zx_n"]
    cz = clifford_t_circuit(tct, zn, s["zx_gates"], device=dev)
    g = zx.circuit_to_zx(cz)
    n0 = g.num_spiders()
    removed = timed(f"(e) simplify, {zn} qubits, {s['zx_gates']} gates", lambda: zx.simplify(g))
    m = timed(f"(e) to_matrix through the contractor, {zn} qubits", lambda: g.to_matrix(device=dev))
    u_c = timed(f"(e) Circuit.matrix(), {zn} qubits", cz.matrix)
    print(f"  (e) {n0} spiders, {removed} removed by simplify, {g.num_spiders()} left; t_count "
          f"{zx.simplifier.t_count(g)}; matrix on {m.device}")
    if m.device.type != dev.type:
        _fail(f"phase 23 (e): the diagram's matrix is on {m.device}")
    check("(e) max |diagram - Circuit.matrix()| up to a phase", _phase_aligned_err(m, u_c), MLZX_MATRIX_ATOL)
    return times


def _mlzx_phase(tct, card, counters, job):
    """Phase 23: :func:`_mlzx_checks` on the card, (d) against phase 19's
    tableau shots from the child process, then its times."""
    t0 = time.perf_counter()
    times = _mlzx_checks(tct, "cuda", counters, ref=lambda: _await_reference(job, "stab")[0])
    for label, (ms, how, peak) in times.items():
        mem = f", peak {peak:.1f} MiB above the start" if peak is not None else ""
        print(f"phase 23 time, {label}: {ms:.3f} ms ({how}){mem}, {card}")
    print(f"phase 23 wall time: {time.perf_counter() - t0:.1f} s, {card}")


# ---- phase 24: applications/ -----------------------------------------------

#: phase 24's sizes: (a) VQNHE's periodic TFIM chain, ansatz layers, hidden
#: units, training steps and the steps held against the CPU path; (b) the
#: portfolio's assets, trading days and budget, QAOA layers, Adam steps,
#: CVaR alpha and the steps held; (c) the vag graph's nodes and the noisy
#: (DMCircuit) graph's; (d) DQAS's qubits, slots, batch and steps; (e)
#: MADE's spins, width and configurations, PixelCNN's side, depth, filters
#: and configurations, NMF's side and draws
APPS_SIZES = {"vq_n": 14, "vq_nl": 2, "vq_units": 16, "vq_steps": 20, "vq_ref": 3,
              "qa_n": 20, "qa_days": 250, "qa_budget": 10, "qa_nl": 3, "qa_steps": 20, "qa_alpha": 0.1,
              "qa_ref": 3, "vg_n": 16, "nz_n": 8, "dq_n": 8, "dq_slots": 4, "dq_batch": 16, "dq_steps": 10,
              "made_n": 20, "made_hidden": 64, "made_k": 4096, "pc_side": 16, "pc_depth": 3, "pc_filters": 32,
              "pc_k": 256, "nmf_side": 16, "nmf_draws": 8192}
#: the same checks at a CPU test's size
APPS_SMALL = {"vq_n": 6, "vq_nl": 2, "vq_units": 8, "vq_steps": 4, "vq_ref": 2,
              "qa_n": 6, "qa_days": 60, "qa_budget": 2, "qa_nl": 2, "qa_steps": 4, "qa_alpha": 0.25, "qa_ref": 2,
              "vg_n": 6, "nz_n": 4, "dq_n": 4, "dq_slots": 2, "dq_batch": 4, "dq_steps": 2,
              "made_n": 6, "made_hidden": 16, "made_k": 64, "pc_side": 4, "pc_depth": 2, "pc_filters": 8,
              "pc_k": 16, "nmf_side": 4, "nmf_draws": 2048}
#: (a) energies, (c) losses and gradient matrices, (d) losses: against the
#: CPU path (float32 sums over the state in another order)
APPS_ATOL = 1e-4
#: (b): the jitted run's losses at the start and after each of the first
#: ``qa_ref`` Adam steps against the CPU path, relative to their size (a
#: float32 sum over 2^n probabilities)
APPS_LOSS_RTOL = 1e-5
#: (e): log-probs against the CPU path, relative to their size (a float32
#: sum of one term a site)
APPS_LOGP_RTOL = 1e-5
#: (e): sampled marginals within this many standard errors
APPS_SIGMAS = 4.0


def tfim_rows(n):
    """The periodic n-site TFIM H = -Σ Z_i Z_i+1 - Σ X_i as VQNHE rows
    ``[weight, code_1, ..., code_n]``: n ZZ rows, n X rows."""
    rows = [[-1.0] + [3 if q in (i, (i + 1) % n) else 0 for q in range(n)] for i in range(n)]
    return rows + [[-1.0] + [1 if q == i else 0 for q in range(n)] for i in range(n)]


def portfolio_qubo(finance, n, days, budget, seed=0):
    """The budgeted mean-variance QUBO (q 0.5, t 1) of ``n`` seeded random
    walks of ``days`` daily prices."""
    rng = np.random.default_rng(seed)
    prices = 100.0 * np.cumprod(1.0 + rng.normal(0.0005, 0.01, size=(n, days)), axis=1)
    sd = finance.StockData(prices)
    return finance.QUBO_from_portfolio(sd.get_covariance(), sd.get_return(), q=0.5, B=budget, t=1.0)


def qubo_readout(tct, Q, params, nlayers, dev, alpha=None, shots=1024, seed=71):
    """What ``QUBO_QAOA`` minimises at ``params`` (the mean energy, or with
    ``alpha`` its CVaR), and the lowest energy among ``shots`` shots of the
    QAOA state (inverse-CDF draws of seeded uniforms) with its bitstring:
    what a user reading the shots keeps."""
    import torch
    from tensorcircuit_ng_tpu_torch.applications import optimization

    structures, weights, offset = tct.templates.conversions.QUBO_to_Ising(Q)
    energies = optimization.ising_energy_vector(structures, weights, offset, device=dev)
    with torch.no_grad():
        p = tct.templates.ansatz.QAOA_ansatz_for_Ising(params, nlayers, structures, weights,
                                                       device=dev).probability()
        p = p / torch.sum(p)
        objective = torch.sum(p * energies) if alpha is None else optimization.cvar_loss(p, energies, alpha)
    status = np.random.default_rng(seed).uniform(size=shots)
    idx = tct.backend.probability_sample(shots, p, status=status).long()
    k = int(idx[torch.argmin(energies[idx])])
    return objective.item(), float(energies[k]), format(k, f"0{len(Q)}b")


def _apps_values(tct, dev, s, timed=None, full=False):
    """What phase 24 holds across devices, computed on ``dev``: (a) VQNHE's
    eager energies, (b) the QAOA losses at the start and after each of the
    first ``qa_ref`` Adam steps (plain and CVaR), (c) ``qaoa_vag`` and
    ``qaoa_noise_vag``'s losses and gradient matrices, (d) DQAS's sampled
    architectures and losses, (e) MADE's and PixelCNN's log-probs.  With
    ``full`` also the runs the card alone makes: (a) all ``vq_steps`` steps eager and jitted, (b) all
    ``qa_steps`` steps, and the objective and best shot at the start and at
    the end, (e) the samplers.  ``QUBO_QAOA`` goes through ``backend.jit``
    in both (eager on the CPU)."""
    import torch
    from tensorcircuit_ng_tpu_torch.applications import (dqas, finance, graphdata, layers, optimization, vags, van,
                                                         vqes)

    timed = timed or (lambda label, fn: fn())
    out = {}
    # (a) VQNHE
    n = s["vq_n"]
    kw = dict(model_type="complex", ansatz="hea", nlayers=s["vq_nl"], units=s["vq_units"], device=dev)
    steps = s["vq_steps"] if full else s["vq_ref"]
    for label in ("eager", "jit") if full else ("eager",):
        v = vqes.VQNHE(n, tfim_rows(n), **kw)
        hist = []
        timed(f"(a) VQNHE n={n}, {steps} training steps, {label}",
              lambda: v.training(maxiter=steps, jit=label == "jit", history=hist))
        out[f"a {label}"] = hist
    # (b) QUBO-QAOA on the portfolio
    Q = portfolio_qubo(finance, s["qa_n"], s["qa_days"], s["qa_budget"])
    steps = s["qa_steps"] if full else s["qa_ref"] + 1
    alphas = (("plain", None), ("cvar", s["qa_alpha"]))
    for label, alpha in alphas:
        losses = []
        out[f"b {label} run"] = timed(
            f"(b) QUBO_QAOA {s['qa_n']} assets, p={s['qa_nl']}, {steps} Adam steps, {label}",
            lambda: optimization.QUBO_QAOA(Q, nlayers=s["qa_nl"], steps=steps, alpha=alpha, device=dev,
                                           callback=lambda i, x: losses.append(x)))
        out[f"b {label} losses"] = losses
    if full:
        out["b start"] = optimization.QUBO_QAOA(Q, nlayers=s["qa_nl"], steps=0, device=dev)
        out["b Q"] = Q
        for label, alpha in alphas:
            out[f"b {label} readout"] = qubo_readout(tct, Q, out[f"b {label} run"][0], s["qa_nl"], dev, alpha)
            out[f"b {label} start readout"] = qubo_readout(tct, Q, out["b start"][0], s["qa_nl"], dev, alpha)
    # (c) the vag kernels
    g = next(graphdata.regular_graph_generator(3, s["vg_n"], seed=31))
    dqas.set_op_pool([layers.Hlayer, layers.rxlayer, layers.zzlayer, layers.rylayer])
    nnp = torch.as_tensor(np.random.default_rng(33).uniform(size=(5, 4)), dtype=torch.float32, device=dev)
    loss, gm = timed(f"(c) qaoa_vag, 3-regular {s['vg_n']} nodes, 5 layers",
                     lambda: vags.qaoa_vag(g, nnp, [0, 2, 1, 2, 1]))
    out["c vag"] = (loss.item(), gm.cpu())
    gz = next(graphdata.regular_graph_generator(3, s["nz_n"], seed=37))
    dqas.set_op_pool([layers.Hlayer, (layers.zzlayer_bitflip, gz, (0.01, 0.01, 0.02)),
                      (layers.rxlayer, gz, layers.bitfliplayer, (0.03, 0.0, 0.0))])
    loss, gm = timed(f"(c) qaoa_noise_vag by DMCircuit, 3-regular {s['nz_n']} nodes, 5 layers",
                     lambda: vags.qaoa_noise_vag(gz, nnp[:, :3], [0, 1, 2, 1, 2]))
    out["c noise"] = (loss.item(), gm.cpu())
    # (d) DQAS over five layers.py ops
    dn = s["dq_n"]
    ring = graphdata.graph1D(dn)
    pool = [layers.Hlayer, layers.rxlayer, layers.rylayer, layers.zzlayer, layers.xxlayer]
    seen = []

    def loss_fn(ops, params):
        """Minus the expected cut of the ring (one readout of the state)."""
        seen.append(list(ops))
        c = tct.Circuit(dn, device=dev)
        for k, op in enumerate(ops):
            pool[op](c, params[k, 0], ring)
        return vags.ave_func(c.state(), ring, (float, torch.neg))[0]

    best, _, hist = timed(f"(d) DQAS_search, {dn} qubits, {s['dq_slots']} slots, batch {s['dq_batch']}, "
                          f"{s['dq_steps']} steps", lambda: dqas.DQAS_search(
                              pool, s["dq_slots"], loss_fn, batch=s["dq_batch"], steps=s["dq_steps"], seed=41,
                              device=dev))
    out["d"] = {"seen": seen, "history": hist, "best": best}
    # (e) the samplers' log-probs
    mn = s["made_n"]
    made = van.MADE(mn, s["made_hidden"], device=dev, generator=torch.Generator().manual_seed(43))
    xs = torch.as_tensor(np.random.default_rng(47).integers(0, 2, size=(s["made_k"], mn)), dtype=torch.float32,
                         device=dev)
    with torch.no_grad():
        out["e made"] = timed(f"(e) MADE n={mn} hidden {s['made_hidden']}: log-probs of {s['made_k']} "
                              "configurations", lambda: made.log_prob(xs)).cpu()
    side = s["pc_side"]
    pc = van.PixelCNN(2, s["pc_depth"], s["pc_filters"], device=dev, generator=torch.Generator().manual_seed(53))
    ys = torch.as_tensor(np.random.default_rng(59).integers(0, 2, size=(s["pc_k"], side, side)), device=dev)
    with torch.no_grad():
        out["e pixelcnn"] = timed(f"(e) PixelCNN {side}x{side} depth {s['pc_depth']} filters {s['pc_filters']}: "
                                  f"log-probs of {s['pc_k']} configurations", lambda: pc.log_prob(ys)).cpu()
        if full:
            gen = torch.Generator(device=dev).manual_seed(61)
            out["e made sample"] = timed(f"(e) MADE sample({s['made_k']})", lambda: made.sample(gen, s["made_k"]))
            out["e made logit0"] = made.logits(torch.zeros((1, mn), device=dev))[0, 0].item()
            out["e pixelcnn sample"] = timed(f"(e) PixelCNN sample({s['pc_k']})",
                                             lambda: pc.sample(gen, s["pc_k"], side, side))
            nmf = van.NMF(2, (side, side), device=dev, generator=torch.Generator().manual_seed(67))
            out["e nmf"] = (nmf, timed(f"(e) NMF {side}x{side} sample({s['nmf_draws']})",
                                       lambda: nmf.sample(gen, s["nmf_draws"])))
    return out


def _apps_reference(tct, **sizes):
    """Phase 24's CPU references: :func:`_apps_values` on the CPU."""
    import torch

    s = {**APPS_SIZES, **sizes}
    t0 = time.perf_counter()
    out = _apps_values(tct, torch.device("cpu"), s)
    out["seconds"] = time.perf_counter() - t0
    return out


def _apps_checks(tct, dev, counters=(), ref=None, **sizes):
    """Phase 24's checks (a)-(e) on ``dev``, the application layer at the
    sizes its users run: (a) VQNHE on the n=14 periodic TFIM, eager and
    jitted, (b) QUBO-QAOA on a 20-asset portfolio, plain and CVaR, (c) the
    DQAS vag kernels, (d) ``DQAS_search``, (e) the autoregressive samplers;
    each against the port's CPU path (``ref``: :func:`_apps_reference` or a
    callable giving it, asked for after the work on ``dev``; computed here
    when None) and its invariants.  Returns each part's (ms, how, peak MiB
    or None)."""
    import torch
    from tensorcircuit_ng_tpu_torch.applications import physics

    s = {**APPS_SIZES, **sizes}
    dev = torch.device(dev)
    card = dev.type == "cuda"
    if card and (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32):
        _fail("phase 24: TF32 is on (the port's rule: no TF32)")
    times = {}

    def check(label, err, tol):
        print(f"  {label}: {err:.3e} (tol {tol:g})")
        if not err <= tol:
            _fail(f"phase 24, {label}: {err} > {tol}")

    def timed(label, fn):
        """``fn()`` once: CUDA events and the peak memory above the start on
        the card, the wall clock on the CPU."""
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            times[label] = (a.elapsed_time(b), "CUDA events", (torch.cuda.max_memory_allocated() - base) / 2**20)
        else:
            t = time.perf_counter()
            out = fn()
            times[label] = ((time.perf_counter() - t) * 1e3, "wall clock", None)
        return out

    _reset(counters)
    got = _apps_values(tct, dev, s, timed, full=True)
    print(f"  launches of the port's kernels over the phase: {_launched(counters)}")
    if callable(ref):
        ref = ref()
    if ref is None:
        ref = _apps_values(tct, torch.device("cpu"), s)

    # (a) VQNHE
    n, k = s["vq_n"], s["vq_ref"]
    floor = physics.TFIM1Denergy(n)
    for label in ("eager", "jit"):
        e = got[f"a {label}"]
        print(f"  (a) {label}: E {e[0]:.7f} -> {e[-1]:.7f} over {len(e)} steps (exact ground {floor:.7f}, CPU "
              f"{', '.join(f'{x:.7f}' for x in ref['a eager'])})")
        check(f"(a) {label}: max |E - CPU| over the first {k} steps",
              max(abs(a - b) for a, b in zip(e[:k], ref["a eager"])), APPS_ATOL)
        check(f"(a) {label}: max (E_exact - E) over the steps (variational bound)", max(floor - x for x in e),
              APPS_ATOL)
        if not e[-1] < e[0]:
            _fail(f"phase 24 (a) {label}: the last energy {e[-1]} is not below the first {e[0]}")
    # (b) QUBO-QAOA
    Q = got["b Q"]
    _, e_start, bits_start = got["b start"]
    for label, objective in (("plain", "mean energy"), ("cvar", f"CVaR {s['qa_alpha']}")):
        losses, held = got[f"b {label} losses"], ref[f"b {label} losses"]
        if len(held) != s["qa_ref"] + 1 or len(losses) != s["qa_steps"]:
            _fail(f"phase 24 (b) {label}: {len(losses)} losses on {dev.type}, {len(held)} held on the CPU")
        check(f"(b) {label}: max |loss - CPU| / max(1, |loss|) at the start and after each of the first "
              f"{s['qa_ref']} steps of the timed run",
              max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(losses, held)), APPS_LOSS_RTOL)
        p, e_best, bits = got[f"b {label} run"]
        x = np.array([int(b) for b in bits], dtype=float)
        obj, shot, shot_bits = got[f"b {label} readout"]
        obj_start, shot_start, shot_bits_start = got[f"b {label} start readout"]
        print(f"  (b) {label}: loss {losses[0]:.6f} -> {losses[-1]:.6f}; {objective} at the end {obj:.6f} (at the "
              f"start {obj_start:.6f}); the most probable bitstring {bits} (x^T Q x {x @ Q @ x:.6f}, energy "
              f"{e_best:.6f}; at the start {bits_start}, {e_start:.6f}); the best of 1,024 shots {shot_bits} "
              f"({shot:.6f}; at the start {shot_bits_start}, {shot_start:.6f})")
        if not losses[-1] < losses[0]:
            _fail(f"phase 24 (b) {label}: the last loss {losses[-1]} is not below the first {losses[0]}")
        if not obj < obj_start:
            _fail(f"phase 24 (b) {label}: the {objective} at the end {obj} is not below the start's {obj_start}")
        if not shot <= shot_start:
            _fail(f"phase 24 (b) {label}: the best shot's energy {shot} is above the start's {shot_start}")
        check(f"(b) {label}: |energy - x^T Q x| of the most probable bitstring", abs(e_best - x @ Q @ x),
              APPS_ATOL * max(1.0, abs(e_best)))
    # (c) the vag kernels
    for key, name in (("c vag", "qaoa_vag"), ("c noise", "qaoa_noise_vag")):
        (l1, g1), (l2, g2) = got[key], ref[key]
        print(f"  (c) {name}: loss {l1:.7f} (CPU {l2:.7f}), {int((g1 != 0).sum())} gradient entries")
        check(f"(c) {name}: |loss - CPU|", abs(l1 - l2), APPS_ATOL)
        check(f"(c) {name}: max |gradient - CPU|", (g1 - g2).abs().max().item(), APPS_ATOL)
    # (d) DQAS
    d, rd = got["d"], ref["d"]
    per = s["dq_batch"]
    same = [d["seen"][i * per:(i + 1) * per] == rd["seen"][i * per:(i + 1) * per] for i in range(s["dq_steps"])]
    print(f"  (d) {len(d['seen'])} architectures sampled; steps equal to the CPU path's: {sum(same)} of "
          f"{len(same)}; mean loss {d['history'][0]:.6f} -> {d['history'][-1]:.6f}; best {d['best']}")
    if not all(same) or len(d["seen"]) != len(rd["seen"]):
        _fail(f"phase 24 (d): the sampled architectures differ from the CPU path's at steps "
              f"{[i for i, x in enumerate(same) if not x]}")
    check("(d) max |mean loss - CPU| over the steps", max(abs(a - b) for a, b in zip(d["history"], rd["history"])),
          APPS_ATOL)
    # (e) the samplers
    for key, name in (("e made", "MADE"), ("e pixelcnn", "PixelCNN")):
        a, b = got[key], ref[key]
        check(f"(e) {name}: max |log p - CPU| / max(1, |log p|) over {a.numel()} configurations",
              ((a - b).abs() / b.abs().clamp(min=1.0)).max().item(), APPS_LOGP_RTOL)
    xs = got["e made sample"]
    p0 = 1.0 / (1.0 + np.exp(-got["e made logit0"]))
    z = abs(xs[:, 0].mean().item() - p0) / np.sqrt(p0 * (1 - p0) / xs.shape[0])
    check(f"(e) MADE sample: site 0's marginal against sigmoid(logit 0) = {p0:.4f}, in sigma", z, APPS_SIGMAS)
    if not set(xs.unique().tolist()) <= {0.0, 1.0} or xs.device.type != dev.type:
        _fail(f"phase 24 (e): MADE samples {xs.unique().tolist()} on {xs.device}")
    ps = got["e pixelcnn sample"]
    if tuple(ps.shape) != (s["pc_k"], s["pc_side"], s["pc_side"]) or not set(ps.unique().tolist()) <= {0, 1}:
        _fail(f"phase 24 (e): PixelCNN samples of shape {tuple(ps.shape)}, values {ps.unique().tolist()}")
    nmf, draws = got["e nmf"]
    with torch.no_grad():
        p1 = torch.softmax(nmf.meanfield, dim=-1)[..., 1].double().cpu()
    sigma = (p1 * (1 - p1) / draws.shape[0]).sqrt()
    check(f"(e) NMF: max |marginal - exact| over {p1.numel()} sites, in sigma",
          ((draws.double().mean(0).cpu() - p1).abs() / sigma).max().item(), APPS_SIGMAS)
    return times


def _apps_phase(tct, card, counters, job):
    """Phase 24: :func:`_apps_checks` on the card against the CPU references
    of the child process, then its times."""
    t0 = time.perf_counter()
    wait = {}

    def reference():
        ref, wait["s"] = _await_reference(job, "apps")
        print(f"phase 24 CPU references (the child process): waited {wait['s']:.1f} s; {ref['seconds']:.1f} s there")
        return ref

    times = _apps_checks(tct, "cuda", counters, ref=reference)
    for label, (ms, how, peak) in times.items():
        mem = f", peak {peak:.1f} MiB above the start" if peak is not None else ""
        print(f"phase 24 time, {label}: {ms:.3f} ms ({how}){mem}, {card}")
    print(f"phase 24 wall time: {time.perf_counter() - t0:.1f} s (of which waiting {wait.get('s', 0.0):.1f} s), "
          f"{card}")


def main() -> int:
    import torch

    t_start = time.time()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import tensorcircuit_ng_tpu_torch as tct
    from tensorcircuit_ng_tpu_torch.core import _build
    from tensorcircuit_ng_tpu_torch.core import kernels_grand as kg
    from tensorcircuit_ng_tpu_torch.core import kernels_rowlayer as krl
    from tensorcircuit_ng_tpu_torch.core import kernels_stack as kst

    if not os.path.abspath(tct.__file__).startswith(here + os.sep):
        _fail(f"imported the port from {tct.__file__}, not from this checkout")
    bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "tensorcircuit_ng_tpu."))]
    if bad or "tensorcircuit_ng_tpu" in sys.modules:
        _fail(f"JAX modules imported: {bad}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. build -------------------------------------------------------
    t0 = time.time()
    built = _build.build_all()
    build_s = time.time() - t0
    card = _card()
    print(f"build: {build_s:.2f} s for {built or 'nothing (cached)'} in {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    print(f"phase 1 ended at {time.time() - t_start:.1f} s")

    # ---- 2. kernel parity at the n=20 shapes -----------------------------
    nrow, nkernel, nouter, _ = kst._shapes(N)
    r = 2**nrow
    rng = np.random.default_rng(7)
    psi = rng.normal(size=2**N) + 1j * rng.normal(size=2**N)
    psi /= np.linalg.norm(psi)
    sr, si = tct.convert.planes(psi, dev)
    zz = torch.as_tensor(rng.normal(size=(L, N - 1)) * 0.4, dtype=torch.float32, device=dev)
    # unitary rx krons: the backward kernels rebuild states by un-application
    rx = torch.as_tensor(rng.normal(size=(L, N)) * 0.4, dtype=torch.float32, device=dev)
    mor, moi = kst._rx_kron_planes(rx[:, :nouter])
    mlr, mli = kst._lane_kron_planes_T(rx[:, nrow:])
    thk = rx[:, nouter:nrow].contiguous()
    pairs = tuple(PAIRS)
    with torch.no_grad():
        # backward inputs: the forward's residuals and a seeded cotangent
        ksr, ksi, _, _ = kg.grand_zzrx_fwd(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli)
    ctr, cti = tct.convert.planes(rng.normal(size=2**N) + 1j * rng.normal(size=2**N), dev)
    ctr, cti = ctr / 2 ** (N / 2), cti / 2 ** (N / 2)
    k4 = {nl: (pairs, N, zz[:nl], thk[:nl], ksr[:nl], ksi[:nl], ctr, cti,
               mor[:nl], moi[:nl], mlr[:nl], mli[:nl]) for nl in (L, 3)}
    # K3's main-path shape: the n=22 step (nrow=15, past the grand path)
    # takes K3 with the lane matrix once a layer, on a K1-fused residual
    nrow22, nkernel22, nouter22, _ = kst._shapes(N22)
    r22 = 2**nrow22
    pairs22 = tuple((i, i + 1) for i in range(N22 - 1))
    psi22 = rng.normal(size=2**N22) + 1j * rng.normal(size=2**N22)
    s22r, s22i = tct.convert.planes(psi22 / np.linalg.norm(psi22), dev)
    zz22 = torch.as_tensor(rng.normal(size=N22 - 1) * 0.4, dtype=torch.float32, device=dev)
    rx22 = torch.as_tensor(rng.normal(size=(1, N22)) * 0.4, dtype=torch.float32, device=dev)
    ml22r, ml22i = (m[0] for m in kst._lane_kron_planes_T(rx22[:, nrow22:]))
    th22 = rx22[0, nouter22:nrow22].contiguous()
    with torch.no_grad():
        k22r, k22i = krl.zzrx_fwd(pairs22, N22, zz22, th22, s22r, s22i, ml22r, ml22i)
    c22r, c22i = tct.convert.planes(rng.normal(size=2**N22) + 1j * rng.normal(size=2**N22), dev)
    c22r, c22i = c22r / 2 ** (N22 / 2), c22i / 2 ** (N22 / 2)
    k3_22 = (pairs22, N22, zz22, th22, k22r, k22i, c22r, c22i, ml22r, ml22i)
    k1_22 = (pairs22, N22, zz22, th22, s22r, s22i, ml22r, ml22i)
    cases = {
        "zzrx_fwd": [
            ("no lane", lambda: krl.zzrx_fwd(pairs, N, zz[0], thk[0], sr, si),
             lambda: krl.zzrx_fwd_plain(pairs, N, zz[0], thk[0], sr, si)),
            ("lane", lambda: krl.zzrx_fwd(pairs, N, zz[0], thk[0], sr, si, mlr[0], mli[0]),
             lambda: krl.zzrx_fwd_plain(pairs, N, zz[0], thk[0], sr, si, mlr[0], mli[0])),
            (f"lane n={N22}", lambda: krl.zzrx_fwd(*k1_22), lambda: krl.zzrx_fwd_plain(*k1_22)),
        ],
        "grand_zzrx_fwd": [
            (f"L={L}", lambda: kg.grand_zzrx_fwd(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli),
             lambda: kg.grand_zzrx_fwd_plain(pairs, N, zz, thk, sr, si, mor, moi, mlr, mli)),
        ],
        "zzrx_bwd": [
            ("no lane", lambda: krl.zzrx_bwd(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti),
             lambda: krl.zzrx_bwd_plain(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti)),
            ("lane", lambda: krl.zzrx_bwd(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti, mlr[0], mli[0]),
             lambda: krl.zzrx_bwd_plain(pairs, N, zz[0], thk[0], ksr[0], ksi[0], ctr, cti, mlr[0], mli[0])),
            (f"lane n={N22}", lambda: krl.zzrx_bwd(*k3_22), lambda: krl.zzrx_bwd_plain(*k3_22)),
        ],
        "grand_zzrx_bwd": [
            (f"L={nl}", lambda nl=nl: kg.grand_zzrx_bwd(*k4[nl]),
             lambda nl=nl: kg.grand_zzrx_bwd_plain(*k4[nl]))
            for nl in (L, 3)
        ],
    }
    s_in = (sr.clone(), si.clone(), s22r.clone(), s22i.clone())
    max_err = _check_parity(cases, twice=("zzrx_fwd", "grand_zzrx_fwd", "zzrx_bwd", "grand_zzrx_bwd"))
    if not all(torch.equal(a, b) for a, b in zip(s_in, (sr, si, s22r, s22i))):
        _fail("K1 or K2 wrote its input planes")
    # K1 alone by a replayed CUDA graph (with the lane, without it, and at
    # n=22, K1's shape on the n=22 step), and one torch.matmul of the
    # product's shapes at n=22 (never called by the port)
    with torch.no_grad():
        k1_graph = {label: _graph_ms(kern) for label, kern, _ in cases["zzrx_fwd"]}
        x22c, m22c = torch.complex(s22r, s22i), torch.complex(ml22r, ml22i)
        k1_lib22 = _graph_ms(lambda: torch.matmul(x22c, m22c))
    for label, g in k1_graph.items():
        print(f"K1 alone [{label}{'' if 'n=' in label else f', n={N}'}] by a replayed CUDA graph of 10 calls (median "
              f"of 3 rounds), {card}: {1e3 * g[0]:.2f} us (min {1e3 * g[1]:.2f}, max {1e3 * g[2]:.2f})")
    print(f"K1's product at n={N22}: library call torch.matmul {1e3 * k1_lib22[0]:.2f} us (CUDA graph of 10 calls, "
          f"median of 3 rounds, min {1e3 * k1_lib22[1]:.2f}, max {1e3 * k1_lib22[2]:.2f}), {card}")

    print(f"phase 2 ended at {time.time() - t_start:.1f} s")

    # ---- 3. the forward path through the public API ----------------------
    def circuit_energy(params, nl, device, n=N):
        c = tfim_circuit(tct, params, n, nl, device=device)
        return c, c.expectation_zzx_energy([(i, i + 1) for i in range(n - 1)], 1.0, -1.0)

    prng = np.random.default_rng(42)
    grids = [prng.normal(size=(L, 2, N)) * 0.1 for _ in range(SEEDS)]
    grid3 = prng.normal(size=(3, 2, N)) * 0.1
    krl.zzrx_fwd.launches = 0
    kg.grand_zzrx_fwd.launches = 0
    with torch.no_grad():
        on_card = []
        for i, g in enumerate(grids):
            c, e = circuit_energy(tct.convert.params(g, dev), L, "cuda")
            on_card.append(e)
            if i == 0:
                norm0 = torch.linalg.vector_norm(c.state())
        _, e3 = circuit_energy(tct.convert.params(grid3, dev), 3, "cuda")
        torch.cuda.synchronize()
    launches = {"zzrx_fwd": krl.zzrx_fwd.launches, "grand_zzrx_fwd": kg.grand_zzrx_fwd.launches}
    print(f"forward path launches: {launches}")
    if launches["grand_zzrx_fwd"] < SEEDS or launches["zzrx_fwd"] < 3:
        _fail(f"the forward path did not go through the kernels: {launches}")
    with torch.no_grad():
        for i, g in enumerate(grids + [grid3]):
            nl = g.shape[0]
            _, e_cpu = circuit_energy(tct.convert.params(g, "cpu"), nl, "cpu")
            e = (on_card + [e3])[i].item()
            de = abs(e - e_cpu.item())
            print(f"energy L={nl} set {i}: card {e:.7f} cpu {e_cpu.item():.7f} |dE| {de:.2e} (tol {ENERGY_ATOL:g})")
            if not (np.isfinite(e) and de <= ENERGY_ATOL):
                _fail("energy on the card disagrees with the CPU path")
    if abs(norm0.item() - 1.0) > NORM_ATOL:
        _fail(f"state norm {norm0.item()}")
    print(f"state norm {norm0.item():.7f} (tol {NORM_ATOL:g})")

    print(f"phase 3 ended at {time.time() - t_start:.1f} s")

    # ---- 4. the training path through the public API ---------------------
    def value_and_grad(p, nl, device, n=N):
        _, e = circuit_energy(p, nl, device, n)
        (g,) = torch.autograd.grad(e, p)
        return e, g

    def sgd(p, g):
        with torch.no_grad():
            p.sub_(LR * g)

    train = [  # (label, n, L, steps, parameters from the benchmark's seed)
        (f"n={N} L={L}", N, L, STEPS, np.random.default_rng(42).normal(size=(L, 2, N)) * 0.1),
        (f"n={N} L=3", N, 3, 1, np.random.default_rng(43).normal(size=(3, 2, N)) * 0.1),
        (f"n={N22} L={L}", N22, L, 1, np.random.default_rng(44).normal(size=(L, 2, N22)) * 0.1),
    ]
    counters = (krl.zzrx_fwd, kg.grand_zzrx_fwd, krl.zzrx_bwd, kg.grand_zzrx_bwd)
    for k in counters:
        k.launches = 0
    card_steps = []
    for label, n, nl, steps, g0 in train:
        p = tct.convert.params(g0, dev).requires_grad_()
        for _ in range(steps):
            e, g = value_and_grad(p, nl, "cuda", n)
            card_steps.append((e.item(), g.cpu().numpy()))
            sgd(p, g)
    torch.cuda.synchronize()
    train_launches = {k.__name__: k.launches for k in counters}
    print(f"training path launches: {train_launches}")
    if train_launches["grand_zzrx_bwd"] < STEPS + 1 or train_launches["zzrx_bwd"] < L:
        _fail(f"the training path did not go through the backward kernels: {train_launches}")
    i = 0
    for label, n, nl, steps, g0 in train:
        p = tct.convert.params(g0, "cpu").requires_grad_()
        for step in range(steps):
            e, g = value_and_grad(p, nl, "cpu", n)
            e_card, g_card = card_steps[i]
            i += 1
            de = abs(e_card - e.item())
            dg = float(np.abs(g_card - g.numpy()).max())
            print(f"training {label} step {step}: E card {e_card:.7f} cpu {e.item():.7f} |dE| {de:.2e} "
                  f"(tol {ENERGY_ATOL:g}); max|dgrad| {dg:.2e} of max|grad| "
                  f"{float(np.abs(g.numpy()).max()):.3e} (tol {GRAD_ATOL:g})")
            if not (np.isfinite(e_card) and np.all(np.isfinite(g_card)) and g_card.shape == (nl, 2, n)):
                _fail(f"training {label}: non-finite or misshapen result")
            if de > ENERGY_ATOL or dg > GRAD_ATOL:
                _fail(f"training {label} step {step} on the card disagrees with the CPU path")
            sgd(p, g)
    if not card_steps[STEPS - 1][0] < card_steps[0][0]:
        _fail("5 SGD steps did not lower the energy")

    print(f"phase 4 ended at {time.time() - t_start:.1f} s")

    # ---- 5. timings --------------------------------------------------------
    p4 = tct.convert.params(grids[0], dev)
    p3 = tct.convert.params(grid3, dev)
    pt = tct.convert.params(grids[0], dev).requires_grad_()

    def train_step():
        e, g = value_and_grad(pt, L, "cuda")
        sgd(pt, g)
        return e.item()

    step_ms = _time_ms(train_step, inner=1)
    with torch.no_grad():
        # one evaluation ends in ``.item()``, which waits for the card
        e4_ms = _time_ms(lambda: circuit_energy(p4, L, "cuda")[1].item(), inner=1)
        e3_ms = _time_ms(lambda: circuit_energy(p3, 3, "cuda")[1].item(), inner=1)
        timed = {  # the main-path variant of each kernel, at its path's shape
            "zzrx_fwd": cases["zzrx_fwd"][1],
            "grand_zzrx_fwd": cases["grand_zzrx_fwd"][0],
            "zzrx_bwd": cases["zzrx_bwd"][2],
            "grand_zzrx_bwd": cases["grand_zzrx_bwd"][0],
        }
        times = {k: (_time_rounds(v[1]), _time_rounds(v[2], **PLAIN_TIMING)) for k, v in timed.items()}
        k2_graph = _graph_ms(timed["grand_zzrx_fwd"][1])
    for name, (t, tp) in times.items():
        print(f"kernel {name} [{timed[name][0]}] over 3 rounds, {card}: median {t[0]:.4f} ms "
              f"(min {t[1]:.4f}, max {t[2]:.4f}); plain median {tp[0]:.4f} ms "
              f"(min {tp[1]:.4f}, max {tp[2]:.4f})")
    print(f"K2 alone [L={L}, n={N}] by a replayed CUDA graph of 10 calls (median of 3 rounds), {card}: "
          f"{1e3 * k2_graph[0]:.2f} us (min {1e3 * k2_graph[1]:.2f}, max {1e3 * k2_graph[2]:.2f})")
    print(f"energy evaluation (CUDA events, ends in .item()), {card}: "
          f"L={L} {e4_ms:.3f} ms, L=3 {e3_ms:.3f} ms (median of 20)")
    print(f"training step n={N} L={L} (value, grad, SGD update; CUDA events, ends in .item()), "
          f"{card}: {step_ms:.3f} ms (median of 20)")
    work = {
        "zzrx_fwd": _k1_work(r, len(PAIRS), nkernel, True),
        "grand_zzrx_fwd": _k2_work(r, len(PAIRS), nkernel, nouter, L),
        "zzrx_bwd": _k3_work(r22, len(pairs22), nkernel22, True),
        "grand_zzrx_bwd": _k4_work(r, len(PAIRS), nkernel, nouter, L),
    }
    replaces = {
        "zzrx_fwd": "tensorcircuit_ng_tpu/core/kernels_rowlayer.py:1208",
        "grand_zzrx_fwd": "tensorcircuit_ng_tpu/core/kernels_grand.py:147",
        "zzrx_bwd": "tensorcircuit_ng_tpu/core/kernels_rowlayer.py:1276",
        "grand_zzrx_bwd": "tensorcircuit_ng_tpu/core/kernels_grand.py:392",
    }
    sources = {"zzrx_fwd": "zzrx_fwd", "grand_zzrx_fwd": "zzrx_fwd",
               "zzrx_bwd": "zzrx_bwd", "grand_zzrx_bwd": "zzrx_bwd"}
    # each kernel's launches on its path: the forward path for K1/K2, the
    # training path for K3/K4
    path_launches = {**launches, "zzrx_bwd": train_launches["zzrx_bwd"],
                     "grand_zzrx_bwd": train_launches["grand_zzrx_bwd"]}
    kernels_line = {"kernels": []}
    for name in timed:
        bound, by = _bound_ms(*work[name])
        kernels_line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"tensorcircuit_ng_tpu_torch/core/csrc/{sources[name]}.cu",
            "replaces": replaces[name], "launches": path_launches[name],
            "max_abs_err": max_err[name], "ms": times[name][0][0], "plain_ms": times[name][1][0],
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
    for k in kernels_line["kernels"]:
        n_path = N22 if k["name"] == "zzrx_bwd" else N
        print(f"kernel {k['name']} (n={n_path}), {card}: {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), launches {k['launches']}")

    print(f"phase 5 ended at {time.time() - t_start:.1f} s")

    # ---- 6. where the time of an evaluation and of a step goes -----------
    with torch.no_grad():
        prof_eval = _profile(lambda: circuit_energy(p4, L, "cuda")[1].item())
    prof_step = _profile(train_step)
    for what, unprofiled, (host, busy, by_kernel) in (
        ("evaluation", e4_ms, prof_eval), ("training step", step_ms, prof_step)
    ):
        print(f"profile L={L} {what} (torch.profiler, 10 runs), {card}: host {host:.3f} ms "
              f"under the profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; "
              f"{100 * busy / unprofiled:.1f} % of the unprofiled {unprofiled:.3f} ms), "
              f"{len(by_kernel)} kernel names")
        for name, ms, count in by_kernel[:12]:
            print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    # K4's and K2's stages a layer on the step, their bounds and one torch
    # call of each product
    step_stages = _stage_times(train_step, {**K4_STAGES, **{f"K2 {k}": v for k, v in K2_STAGES.items()}})
    _k4_stages(krl, card, step_stages, (ksr[L - 1], ksi[L - 1]), (ctr, cti), (mlr[L - 1], mli[L - 1]), pairs22)
    _k2_stages(kg, card, {k[3:]: v for k, v in step_stages.items() if k.startswith("K2 ")}, (sr, si),
               (mlr[0], mli[0]), len(PAIRS), nkernel, nouter)
    # K1's stages a launch on the n=20 L=3 step (K1 a layer, then K4)
    pt3 = tct.convert.params(grid3, dev).requires_grad_()

    def train_step3():
        e, g = value_and_grad(pt3, 3, "cuda")
        sgd(pt3, g)
        return e.item()

    _k1_stages(krl, card, _stage_times(train_step3, K1_STAGES), (sr, si), (mlr[0], mli[0]), len(PAIRS), nkernel,
               0, "n=20 L=3 steps")

    print(f"phase 6 ended at {time.time() - t_start:.1f} s")

    # ---- 7. the TEBD path through the public API ------------------------
    import scipy.linalg
    from tensorcircuit_ng_tpu_torch.core import kernels_jacobi as kj

    px = np.array([[0, 1], [1, 0.0]])
    pz = np.diag([1.0, -1.0])
    hb = -np.kron(pz, pz) - 0.5 * (np.kron(px, np.eye(2)) + np.kron(np.eye(2), px))
    gate = scipy.linalg.expm(-0.05j * hb).astype(np.complex64)  # bench.py's gate
    even = np.stack([gate] * len(range(0, TEBD_N - 1, 2)))
    odd = np.stack([gate] * len(range(1, TEBD_N - 1, 2)))
    mid = TEBD_N // 2

    def tebd_run(device, dtype="complex64"):
        eng = tct.ParallelTEBD(TEBD_N, TEBD_CHI, initial="neel", dtype=dtype, device=device)
        for _ in range(TEBD_STEPS):
            eng.trotter_step(even, odd)
        return eng

    def observables(eng):
        zs = np.array([eng.expectation_single(pz, i).real.item() for i in range(TEBD_N)])
        return zs, eng.lambdas[mid].double().cpu().numpy(), _mps_norm(eng)

    all_counters = counters + (kj.jacobi_rotations,)
    for k in all_counters:
        k.launches = 0
    with torch.no_grad():
        eng_card = tebd_run("cuda")
        torch.cuda.synchronize()
    tebd_launches = {k.__name__: k.launches for k in all_counters}
    print(f"TEBD path launches ({TEBD_STEPS} trotter steps): {tebd_launches}")
    if tebd_launches["jacobi_rotations"] != 2 * TEBD_STEPS:
        _fail(f"the TEBD path did not run K5 twice a step: {tebd_launches}")
    with torch.no_grad():
        on_card = observables(eng_card)
        ref = observables(tebd_run("cpu", "complex128"))
        gram32 = observables(tebd_run("cpu", "complex64"))
    for label, (zs, lam, nrm) in (("card (K5 Jacobi, float32)", on_card),
                                  ("CPU Gram complex64, contrast", gram32)):
        dz = float(np.abs(zs - ref[0]).max())
        dl = float(np.abs(lam - ref[1]).max())
        print(f"TEBD n={TEBD_N} chi={TEBD_CHI} {TEBD_STEPS} steps, {label} vs CPU complex128: "
              f"max|d<Z_i>| {dz:.3e}, max|d lambda_{mid}| {dl:.3e}, |psi|^2 {nrm:.7f} "
              f"(CPU complex128 {ref[2]:.7f})")
        if label.startswith("card"):
            if not (np.all(np.isfinite(zs)) and np.all(np.isfinite(lam)) and zs.shape == (TEBD_N,)):
                _fail("TEBD on the card: non-finite or misshapen observables")
            if dz > TEBD_ATOL or dl > TEBD_ATOL or abs(nrm - 1.0) > TEBD_ATOL:
                _fail(f"TEBD on the card disagrees with the complex128 CPU path (tol {TEBD_ATOL:g})")
    print(f"TEBD tolerance {TEBD_ATOL:g} on <Z_i>, lambda_{mid} and |psi|^2 - 1")

    with torch.no_grad(), tct.config.full_float32():
        th_even = eng_card._layer_thetas(even, 0)[0]
        th_odd = eng_card._layer_thetas(odd, 1)[0]
    batches = [("path thetas B=30", th_even, True), ("path thetas B=29", th_odd, True)]
    batches += [(label, torch.as_tensor(a.astype(np.complex64), device=dev), True)
                for label, a in _svd_batches(np.random.default_rng(11))]
    # without V, vh = S^-1 U^H A amplifies U's noise columns by 1/s: a
    # full-rank batch (on the rank-deficient thetas the plain version itself
    # reconstructs to 0.18 only)
    batches.append(("random, no V", batches[2][1], False))
    k5_err = 0.0
    with torch.no_grad():
        for label, a, with_v in batches:
            got = kj.jacobi_svd_nodiff(a, TEBD_SWEEPS, with_v)
            torch.cuda.synchronize()
            want = kj.jacobi_svd_nodiff(a, TEBD_SWEEPS, with_v, rotations=kj.jacobi_rotations_plain)
            ds, rec, rec_plain, vec, nsep, orth, ds_abs = _svd_checks(a, got, want)
            orth_plain = _svd_checks(a, want, want)[5]
            ok = (ds <= SVD_S_TOL and rec <= SVD_REC_TOL and vec <= SVD_VEC_TOL
                  and orth <= SVD_ORTH_TOL and got[0].shape == want[0].shape)
            print(f"parity jacobi_svd [{label}] {tuple(a.shape)}: max|ds|/s_max {ds:.2e} (tol {SVD_S_TOL:g}), "
                  f"rec {rec:.2e} (plain {rec_plain:.2e}, tol {SVD_REC_TOL:g}), vectors on {nsep} "
                  f"separated columns {vec:.2e} s_max/gap (tol {SVD_VEC_TOL:g}), "
                  f"|u^H u - I| {orth:.2e} (plain {orth_plain:.2e}, tol {SVD_ORTH_TOL:g}) "
                  f"-> {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"jacobi_svd [{label}] disagrees with its plain version")
            k5_err = max(k5_err, ds_abs)
        at = th_even.transpose(-1, -2)
        ar, ai = at.real.contiguous(), at.imag.contiguous()
        once = kj.jacobi_rotations(ar, ai, TEBD_SWEEPS, True)
        again = kj.jacobi_rotations(ar, ai, TEBD_SWEEPS, True)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(once, again)):
            _fail("jacobi_svd differs between two runs")
        print("parity jacobi_svd [path thetas B=30]: two runs equal bit for bit")

        g0, l0 = eng_card.gammas.clone(), eng_card.lambdas.clone()

        def tebd_steps():
            eng = tct.ParallelTEBD.from_state(g0, l0)
            for _ in range(TEBD_STEPS):
                eng.trotter_step(even, odd)
            return eng.lambdas[mid, 0].item()

        tebd_ms = _time_ms(tebd_steps, reps=5, inner=1) / TEBD_STEPS
        k5_t = _time_rounds(lambda: kj.jacobi_rotations(ar, ai, TEBD_SWEEPS, True))
        plain_reps = 3
        k5_plain = _time_ms(lambda: kj.jacobi_rotations_plain(ar, ai, TEBD_SWEEPS, True),
                            reps=plain_reps, inner=1, warmup=1)
        k5_lib = _time_ms(lambda: torch.linalg.svd(th_even, full_matrices=False), reps=10, inner=1)
        eng_p = tct.ParallelTEBD.from_state(g0, l0)
        prof_tebd = _profile(lambda: (eng_p.trotter_step(even, odd), eng_p.lambdas[mid, 0].item()), reps=3)
    print(f"TEBD trotter step n={TEBD_N} chi={TEBD_CHI} (even + odd layer; CUDA events over "
          f"{TEBD_STEPS} steps ending in .item(), median of 5), {card}: {tebd_ms:.3f} ms")
    print(f"kernel jacobi_svd [B=30 path thetas, with V] over 3 rounds, {card}: median {k5_t[0]:.4f} ms "
          f"(min {k5_t[1]:.4f}, max {k5_t[2]:.4f}); plain median of {plain_reps} calls {k5_plain:.2f} ms; "
          f"torch.linalg.svd {k5_lib:.4f} ms (median of 10)")
    rounds = TEBD_SWEEPS * (th_even.shape[-1] - 1)
    nb, m_, n_ = th_even.shape
    k5_c = kj.cluster_size(dev, nb, n_, m_, True)
    active = {c: kj._max_active_clusters(torch.cuda.current_device(), n_, m_, True, c) for c in kj._CLUSTERS
              if kj._smem_bytes(n_, m_, True, c) <= kj._MAX_SMEM_BYTES}
    print(f"K5 cluster: {k5_c} CTAs a matrix ({nb * k5_c} CTAs) for B={nb} {n_}x{m_} with V; "
          f"cudaOccupancyMaxActiveClusters by cluster size {active}, {card}")
    # the rule's evidence: the same call at every cluster size that runs,
    # through the C entry point (the wrapper has no cluster argument)
    lib = _build.library("jacobi_svd")
    outs = [torch.empty_like(ar), torch.empty_like(ai), torch.empty((nb, n_, n_), device=dev),
            torch.empty((nb, n_, n_), device=dev)]

    def k5_at(c):
        err = lib.tcng_jacobi_svd(ar.data_ptr(), ai.data_ptr(), *[o.data_ptr() for o in outs], nb, n_, m_,
                                  TEBD_SWEEPS, c, torch.cuda.current_stream().cuda_stream)
        _build.check("jacobi_svd", err, f"jacobi_svd at cluster size {c}")

    by_c = {c: _time_ms(lambda c=c: k5_at(c), reps=5, inner=5, warmup=1) for c in active}
    print("kernel jacobi_svd by cluster size (ms, median of 5): "
          + ", ".join(f"C={c} {t:.4f}" for c, t in by_c.items()) + f"; the rule took {k5_c}, {card}")
    print(f"kernel jacobi_svd a round: {k5_t[0] / rounds * 1e3:.3f} us (median {k5_t[0]:.4f} ms / {rounds} "
          f"rounds), {card}")
    host, busy, by_kernel = prof_tebd
    k5_names = [(name, ms, count) for name, ms, count in by_kernel if "jacobi" in name]
    for name, ms, count in k5_names:
        print(f"profile K5 kernel: {name} device {ms:.4f} ms x{count:g} a trotter step, {card}")
    if len(k5_names) != 1:
        _fail(f"the profiler shows {len(k5_names)} K5 kernel names, not one: {k5_names}")
    print(f"profile TEBD trotter step (torch.profiler, 3 steps), {card}: host {host:.3f} ms under the "
          f"profiler, device busy {busy:.3f} ms ({100 * busy / host:.1f} % of it; "
          f"{100 * busy / tebd_ms:.1f} % of the unprofiled {tebd_ms:.3f} ms), {len(by_kernel)} kernel names")
    for name, ms, count in by_kernel[:12]:
        print(f"  device {ms:.4f} ms x{count:g}/run  {name[:90]}")
    bound, by = _bound_ms(*_k5_work(th_even.shape[0], 128, 128, TEBD_SWEEPS))
    kernels_line["kernels"].append({
        "name": "jacobi_svd", "route": "cuda",
        "source": "tensorcircuit_ng_tpu_torch/core/csrc/jacobi_svd.cu",
        "replaces": "tensorcircuit_ng_tpu/core/kernels_jacobi.py:416",
        "launches": tebd_launches["jacobi_rotations"], "max_abs_err": k5_err,
        "ms": k5_t[0], "plain_ms": k5_plain, "bound_ms": bound, "bound_by": by, "library_ms": k5_lib,
    })
    print(f"kernel jacobi_svd (B=30, 128x128, {TEBD_SWEEPS} sweeps, with V), {card}: {k5_t[0]:.4f} ms, "
          f"plain {k5_plain:.2f} ms, bound {bound:.4f} ms ({by}), torch.linalg.svd {k5_lib:.4f} ms, "
          f"launches {tebd_launches['jacobi_rotations']}")
    print(f"phase 7 ended at {time.time() - t_start:.1f} s")

    # ---- 8. the HEA path: K6, K7 and K8 --------------------------------
    hea_line = _hea_phase(tct, krl, dev, card)
    kernels_line["kernels"].extend(hea_line)
    print(f"phase 8 ended at {time.time() - t_start:.1f} s")

    # ---- 9. the QAOA path: K9, K10, K11 and K12 ------------------------
    from tensorcircuit_ng_tpu_torch.core import kernels_multilayer as kml

    every_counter = all_counters + (krl.row_fwd, krl.row_bwd, krl.row_bwd_const, kml.ml_fwd,
                                    kml.ml_bwd, krl.rotx_fwd, krl.rotx_bwd)
    kernels_line["kernels"].extend(_qaoa_phase(tct, krl, dev, card, every_counter))
    print(f"phase 9 ended at {time.time() - t_start:.1f} s")

    # ---- 10. the FUSE_ROWM path: K13 and K14 inside K1 and K3 ----------
    every_counter += (krl.rowm_fwd, krl.rowm_bwd)
    kernels_line["kernels"].extend(_rowm_phase(tct, krl, kst, dev, card, every_counter))
    print(f"phase 10 ended at {time.time() - t_start:.1f} s")

    # ---- 11. the staged micro-benchmark: K15 ----------------------------
    kernels_line["kernels"].extend(_micro_phase(tct, dev, card))
    print(f"phase 11 ended at {time.time() - t_start:.1f} s")

    # the CPU references of phases 15 (c) and 16 run in a child process
    # beside phases 12-16, after every kernel's and step's timing; how far
    # it moves a host-bound time: the same two timings without it and
    # beside it (after phase 13)
    def probe():
        with torch.no_grad():
            k1 = _time_rounds(timed["zzrx_fwd"][1])[0]
        return {"K1 by events (the kernels line's ms)": k1, f"TFIM training step n={N} L={L}": _time_ms(
            train_step, inner=1)}

    alone = probe()
    ref_job = _start_references(here)

    # ---- 12. the circuit API at full width -----------------------------
    from tensorcircuit_ng_tpu_torch.core import kernels_micro

    every_counter += (kernels_micro.micro_grand,)
    _api_phase(tct, card, every_counter)
    print(f"phase 12 ended at {time.time() - t_start:.1f} s")

    # ---- 13. sampling and feed-forward at full width -------------------
    _sampling_phase(tct, card, every_counter)
    print(f"phase 13 ended at {time.time() - t_start:.1f} s")
    running = ref_job[0].poll() is None
    beside = probe()
    for key in alone:
        print(f"host contention, {key}: {alone[key]:.4f} ms without the child process, {beside[key]:.4f} ms "
              f"beside it ({'running' if running else 'ended before'}), {card}")

    # ---- 14. noise at full width ---------------------------------------
    _noise_phase(tct, card, every_counter, ref_job)
    print(f"phase 14 ended at {time.time() - t_start:.1f} s")

    # ---- 15. the contraction engine at full width ----------------------
    _contraction_phase(tct, card, ref_job)
    print(f"phase 15 ended at {time.time() - t_start:.1f} s")

    # ---- 16. the MPS simulators at full width ---------------------------
    _mps_phase(tct, card, every_counter, ref_job)
    print(f"phase 16 ended at {time.time() - t_start:.1f} s")

    # ---- 17. the Hamiltonians and the QI toolbox at full width ----------
    _hamiltonian_phase(tct, card, every_counter, ref_job)
    print(f"phase 17 ended at {time.time() - t_start:.1f} s")

    # ---- 18. the backend's transforms, time evolution, shadows ---------
    _transform_phase(tct, card, every_counter, ref_job)
    print(f"phase 18 ended at {time.time() - t_start:.1f} s")

    # ---- 19. the stabilizer simulator, detectors, qudits, U(1) ----------
    _stab_phase(tct, card, ref_job)
    print(f"phase 19 ended at {time.time() - t_start:.1f} s")

    # ---- 20. analog circuits, free fermions, Pauli propagation, symbols -
    _slice_phase(tct, card, every_counter, ref_job)
    print(f"phase 20 ended at {time.time() - t_start:.1f} s")

    # ---- 21. the parallel engines: sharded state, terms, slices, group --
    _parallel_phase(tct, card, every_counter)
    print(f"phase 21 ended at {time.time() - t_start:.1f} s")

    # ---- 22. the circuits' I/O, the compiler and the cloud layer --------
    _io_phase(tct, card, every_counter)
    print(f"phase 22 ended at {time.time() - t_start:.1f} s")

    # ---- 23. the ML bridges and zx/ --------------------------------------
    _mlzx_phase(tct, card, every_counter, ref_job)
    print(f"phase 23 ended at {time.time() - t_start:.1f} s")

    # ---- 24. applications/: VQNHE, QUBO-QAOA, vags, DQAS, samplers -------
    _apps_phase(tct, card, every_counter, ref_job)
    print(f"phase 24 ended at {time.time() - t_start:.1f} s")
    print(f"smoke total: {time.time() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--references"]:
        sys.exit(_reference_child(sys.argv[2]))
    sys.exit(main())
