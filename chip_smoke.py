#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (rdcfes_tpu_torch) on one NVIDIA GPU, and
check it: the PIHNA transient step on TET4 (phases 2-5), the hyperelastic
solid load step (phases 6-8), the generic (HEX8) transient path with
PIHNA and ADPM plus the launch-cost calibration (phases 9-12), the CLI
with its PIHNA, ADPM, PROTEAS, RIPF and solid drivers (phase 13), and
the coupled HCC driver on the moving mesh with process_mesh (phase 14),
the PIHNA driver with AMR and the native Gmsh parser (phase 15), the
mixed (HEX8 + PYRAMID5 + TET4, PRISM6) and TET10 meshes (phase 16),
PROTEAS, RIPF, ExodusII export and AMR on mixed and TET10 meshes (phase
17), the solid on mixed and TET10 meshes with remeshing (phase 18), 2D
(TRI3, QUAD4, QUAD8, QUAD9), HEX20 and HEX27 meshes and the dense
element-matrix path (phase 19), and the transient systems'
dtype=float32 serving mode with ADPM's local parity at its shipped rtol
(phase 20), and the multi-device halo system, 4 shards on the card, and
`parallel/n_devices` in the PIHNA driver (phase 21), and the halo system
on TET10, QUAD4 and MixedMesh, with the mixed PIHNA (AMR) and ADPM
drivers on 4 shards (phase 22), and the moving mesh and the solid's halo
Newton on 4 shards, with the HCC and solid drivers there (phase 23), and
the replicated-iterate system on 4 shards with the block-CSR helpers
(phase 24).

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py --phases 0,1,2           # device, build, kernels
    python3 chip_smoke.py --phases 0,1,6,7,8       # the solid slice
    python3 chip_smoke.py --phases 0,1,9,10,11,12  # HEX8, ADPM, calibration
    python3 chip_smoke.py --phases 0,1,13          # the CLI drivers
    python3 chip_smoke.py --phases 0,1,14          # HCC, process_mesh
    python3 chip_smoke.py --phases 0,1,6,14        # K5 at both its shapes
    python3 chip_smoke.py --phases 0,1,15          # AMR, the native parser
    python3 chip_smoke.py --phases 0,1,16          # mixed and TET10 meshes
    python3 chip_smoke.py --phases 0,1,17          # PROTEAS, RIPF, AMR on them
    python3 chip_smoke.py --phases 0,1,18          # the solid on them
    python3 chip_smoke.py --phases 0,1,19          # 2D, HEX20/27, dense path
    python3 chip_smoke.py --phases 0,1,20          # f32 mode, ADPM parity
    python3 chip_smoke.py --phases 0,1,21          # the multi-device smoke
    python3 chip_smoke.py --phases 0,1,22          # halo: more types, mixed
    python3 chip_smoke.py --phases 0,1,23          # moving halo, halo solid
    python3 chip_smoke.py --phases 0,1,24          # sharded system, bcsr

Phases, one output line each (any failure raises, exit code != 0):
  0 device  the CUDA device (never the CPU) and nvidia-smi's name and
            power limit of the card
  1 build   compile csrc/*.cu with nvcc (sm_90a), one process per source,
            and beside them native/meshkit.cpp with the host g++, seconds
            taken; ptxas's registers, shared memory and spills of every
            kernel instance (K8's HEX20 / HEX27 tile instances also their
            dynamic shared memory at 5 and 8 species)
  2 kernels each transient kernel against its plain PyTorch version on
            the bench mesh and initial state (f64 within 1e-13, f32 within
            1e-5, relative to the largest plain value), K4 also at the
            block-Jacobi diagonal's width; median CUDA-event time of 20
            calls for the kernel, the plain version and, where one exists,
            one library call computing the same function
  3 oracle  3 mixed-precision steps on box_tet_mesh(4,4,4) against the
            independent NumPy/SuperLU transcription oracle/pihna_numpy.py,
            per-step relative L2 within 1e-8 (the BASELINE.json contract)
  4 paths   3 steps at bench size through the kernels and through the
            plain versions, per-step relative L2 within 1e-10
  5 slice   the bench workload (bench.py:46-125): PIHNA, 24,389 nodes x 5,
            131,712 TET4, dt 0.1, 120 steps of run_steps with
            precision="mixed", precond_refresh=20, rtol=3e-11, after one
            warm-up run; launch counts reset just before the timed run
  6 solid kernels  K5 (f32, f64) and K4's matrix assembly (f32, f64) at
            the solid bench's shapes, on the tangent assembled at
            perturbed positions, against their plain versions (f64 within
            1e-13, f32 within 1e-5), timed as in phase 2; K5 also two
            launches bit-equal, and timed per call after a 128 MB read
            that flushes the L2 (flushed_ms) and as 50 back-to-back
            launches over 50 (b2b_ms); K5 f32 also on the tangent
            padded with 6 zero slots (ell_matvec_f32_pad6: L = 33, a
            width whose slot groups take two passes)
  7 solid paths  one load step on box_hex_mesh(12,12,12) with exact-f64
            options through the kernels and through the plain versions,
            relative L2 of the displacements within 1e-10
  8 solid slice  the solid bench leg (bench.py:290-341): box_hex_mesh(48,
            48,48), 110,592 HEX8, f32 tangent, modified Newton,
            mixed-precision Krylov, run_solver(x0, 0.5) after one warm-up;
            launch counts reset just before the timed run; |R|/|R0| <= 1e-6
            re-checked on the plain f64 residual; then one run timed stage
            by stage and one under torch.profiler for the device's busy
            share

  9 generic kernels  every launch of the HEX8 and ADPM steps at its own
            shapes: K8, K6 (f32, f64) and K4 (f32 and f64 at W = V, f64 at
            W = V V) on box_hex_mesh(48,48,48) (110,592 HEX8) with the
            PIHNA bench deck's live blocks and again with ADPM's
            taxis-active blocks (V = 3, live D planes); K1-K4 on the ADPM
            legs' TET4 28^3 mesh with ADPM's blocks; and K7 at the
            calibration's shapes (table (192,128), indices (4608,128));
            K6 again on box_hex_mesh(5,5,5) (E = 125: odd, a ragged last
            tile); each against its plain version (f64 within 1e-13, f32
            within 1e-5; K7 exact), timed as in phase 2; index_add_ beside
            K4, torch.gather beside K7
  10 calibration  time = a + b n fitted from n = 8 and n = 40 back-to-back
            eager bodies with one synchronize at the end (the counterpart
            of scripts/microbench_calib.py): a scalar sqrt chain, a 67 MB
            and a 2.3 MB stream, a 2.3 MB transpose + sqrt, the
            restriction gather at the TET4 bench's shapes through K4, K7,
            and K6 f32 and K3 f32 with the PIHNA blocks on
            box_hex_mesh(12,12,12) and box_tet_mesh(12,12,12); a is the
            fixed cost, b the cost per body, beside the host's cost of
            issuing a body (the loop before the synchronize) and its
            CUDA-event time; then the host time of each piece of a launch
            (allocation, stream, ctypes call, a torch op, a whole K4
            wrapper call on a tiny table)
  11 generic paths  kernels vs plain versions, per-step relative L2 within
            1e-10: 3 mixed-precision PIHNA steps (both solved to rtol
            1e-12) and 3 ADPM taxis-active steps (rtol 1e-11, each from a
            common state) on box_hex_mesh(6,6,6); then 3 ADPM steps on
            box_tet_mesh(4,4,4) against oracle/adpm_numpy.py, each step
            from the oracle's state (local parity), within 1e-8
  12 generic slice  PIHNA, 5 species, the bench deck and initial state on
            box_hex_mesh(48,48,48) with brain bounds: 5 warm-up steps,
            then 40 timed steps of run_steps (precision="mixed",
            precond_refresh=20, rtol=3e-11), launch counts reset just
            before; residuals <= rtol, state finite and non-negative; one
            run of 10 steps under torch.profiler for the device's busy
            share.  Then the ADPM legs on the affine path: bench.py:158-192
            (TET4 28^3, taxis amplitude 50, rtol 1e-9, precond_refresh=10),
            50 timed steps; and bench.py:241-276's deck regime (amplitude
            1e3, subcycle=16), 2 outer steps with every residual <= 1e-8.
            The compiled-C++ denominators (BASELINE_MEASURED.json) are
            printed beside the results, not asserted
  13 drivers  rdcfes_tpu_torch.cli.main in process, in generated case
            directories, launch counts reset just before each run and
            read just after: `-m pihna` on cases.make_pihna_case(n=28,
            n_steps=40) (131,712 TET4, the run/PIHNA deck; CSV header +
            5 rows, 5 VTU, a PVD of 5 DataSets, the last frame's five
            species finite and >= 0, K1, K2, K3 f64, K4 f64 launched and
            K3 f32 not); `-m adpm` on make_adpm_case(n=28, n_steps=40)
            with the taxis amplitude of bench.py:158-192 (outputs at 0,
            20, 40, the same checks); `-m proteas input=input.dat` on
            make_proteas_case(n=28, n_steps=40) (131,712 TET4; the CSV
            empty, as the reference's; 5 VTU, a PVD of 5 DataSets, the
            same checks); `-m ripf` on make_ripf_case(n=24, n_steps=120)
            (15,625 nodes, 82,944 TET4, the size of run/RIPF133; 6 CSV
            rows, 6 VTU at 0, 10, 30, 60, 90, 120, every field finite, HU
            within [-1000, 1000], cc and fb >= 0, K1 launched at least
            twice a step: the step and the field rebuild; K1, K2, K3 f64,
            K4 f64 launched and K3 f32 not, for both; before each of the
            two runs, K1, K2, K3 f64 and K4 f64 (and its block-Jacobi
            diagonal) held against their plain versions within 1e-13 at
            the driver's own shapes and live planes, its system on its
            case mesh at the case's initial state, RIPF's K1 also on
            the field rebuild's (3, N) nodal stack); `-s` on
            box_hex_mesh(48,48,48)
            (110,592 HEX8) with the solid bench's deck (bench.py:290-341,
            loading_step 0.5: two load steps, each converged; every VTU
            field finite; K4 f32 and K5 f32 launched).  Each run prints
            its wall time, PerfLog's totals by phase, the solve phase's
            rate beside the compiled-C++ denominator (18.87 and 83.11
            steps/s, 2.95 s a load step; printed, not asserted; PROTEAS
            and RIPF have none) and its launches.  Then `python3 -m rdcfes_tpu_torch.cli -m pihna` as
            a subprocess on make_pihna_case(n=6, n_steps=3): exit code 0
            and the artifacts present
  14 coupled  (a) the moving mesh, kernels vs plain versions, per-step
            relative L2 within 1e-10: 3 HCC steps of run_steps(coords=)
            and 2 of step(coords=), each at its own seeded smooth
            non-affine displacement, with every HCC block live (rtol
            1e-12), on box_tet_mesh(12,12,12) (K1-K4) and
            box_hex_mesh(6,6,6) (K8, K6, K4); (b) K1, K2, K3 f64, K4
            f64 and its block-Jacobi diagonal with the HCC driver's
            system and blocks on make_hcc_case(n=28)'s mesh (24,389
            nodes, 131,712 TET4, V = 3) at the case's initial state, on
            the geometry of the positions after one converged load step,
            and K4 f32 (the assembly) and K5 (f32, f64) on the TET4
            solid's tangent there, against their plain versions (f64
            within 1e-13, f32 within 1e-5), timed as in phase 2, K5 as
            in phase 6; the solid's residual and tangent assembled three
            times there, and its penalty residual computed three times,
            each bit-equal to the first (the penalty terms are summed in
            a fixed order, through K4); (c)
            `-c hcc` in process on make_hcc_case(n=28, n_steps=100,
            n_loading=10), the shipped schedule's first quarter (dt
            0.01), launch counts reset just before and read just after:
            VTU frames 0, 50 and 100 and a PVD of 3 DataSets, every field
            finite, l, c, n >= 0, the mesh moved (max |u| > 0, Points !=
            undeformed), 10
            converged Newton solves, K1, K2, K3 f64, K4 f64, K4 f32 and
            K5 f32 launched and K3 f32 not; its wall time, PerfLog's
            totals, RDC steps/s, s a load step, the Newton and inner
            iterations and the launches, and what the RDC solves did
            (breakdowns, zero-iteration steps, the other steps'
            iterations) beside each frame's largest l, c and n, K3 f64's
            launches and a checksum of the last frame (sha256 of its VTU
            file), so two calls can be compared, printed, not asserted;
            (d) `python3 -m
            rdcfes_tpu_torch.cli -u process_mesh` as a process on the
            case mesh, its answers on stdin (scale 2, a translation,
            rotations of 30/45/60 degrees): exit code 0, the .msh, .ex2
            and .config written, the .msh re-read at the transformed
            coordinates within the writer's 6 significant digits
  15 amr    (a) make_pihna_case(n=28)'s mesh (24,389 nodes, 131,712 TET4)
            read by the native meshkit parser and by the NumPy parser:
            equal arrays, both parse times; (b) `-m pihna` in process on
            make_pihna_case(n=28, n_steps=30), the shipped deck with
            refinement_step = 10 and mesh/AMR/max_steps = 2 (AMR at steps
            10 and 20), once with mesh/AMR/strategy = bisection and once with
            1to8, launch counts reset just before and read
            just after: the element count before and after each AMR step
            and the hanging-node count, the amr scope's seconds and the
            wall time, K1-K4's launches, each run_steps call's inner
            iterations and final residual; every step's residual <= the
            rtol, the CSV and the 13 VTU frames, the last frame's
            species finite and >= 0 on the refined mesh's cells, K1, K2,
            K3 f64 and K4 f64 launched and K3 f32 not; then K1-K4 at the
            refined mesh's shapes, with the final state and the PIHNA
            blocks, against their plain versions (f64 within 1e-13), and
            with 1to8 u_h = (u_a + u_b) / 2 in the final state within
            1e-12 relative; (c) checkpoint and resume across AMR:
            make_pihna_case(n=12, n_steps=10), 1to8 at step 4, a
            checkpoint at step 6, then a resume from it: the final state
            within 1e-12 relative of the uninterrupted run's
  16 mixed  (a) the K8 and K6 (f32, f64) instances of each element type
            against their plain versions (f64 within 1e-13, f32 within
            1e-6), timed as in phase 2, with PIHNA's bench deck and state:
            on box_mixed_mesh(28,28,28) with brain bounds (25,173 nodes)
            its HEX8 (10,976) and PYRAMID5 (3,920) blocks, K1-K3 at its
            TET4 block (62,720) and K4 (f32, f64, and the block-Jacobi
            diagonal) at its one table over the three blocks, index_add_
            beside it; PRISM6 on box_hex_mesh(28)'s cells split in two
            (43,904); TET10 on tet4_to_tet10(box_tet_mesh(28)) (131,712
            elements, 185,193 nodes) with K4 there, and K8 and K6 again
            with ADPM's blocks (V = 3: the f32 instances ptxas spills 8-16
            bytes in); each new instance's ms, bound and share of the
            bound; (b) 3
            MixedTransientRDCSystem steps on the same mixed mesh, f64 at
            rtol 1e-14, kernels vs plain versions from a common state,
            per-step relative L2 within 1e-10; (c) cli.main in process,
            every run_steps call recorded, launch counts reset just before
            each run and read just after: `-m pihna` on
            make_pihna_case(n=28, n_steps=40, mixed=True), `-m adpm` on
            make_adpm_case(n=28, n_steps=40, mixed=True) at phase 13's
            taxis amplitude, `-m pihna` on that PIHNA case's Gmsh file
            rewritten with its hexes split into prisms (PRISM6, PYRAMID5,
            TET4; 20 steps) and `-m pihna` on make_pihna_case(n=28,
            n_steps=20, order=2) (TET10; its state runs away from step
            ~23, below): the CSV, the VTU frames and the PVD, the last
            frame's species finite and >= 0, every step's residual <= the
            rtol; the wall time, PerfLog's phases, the inner iterations
            and the last residual; before that run, that TET10 case's
            mesh and deck stepped in f64 through the kernels for up to 30
            steps, each step's iterations, residual and largest v
            printed, the run stopped at the first failed solve, and at
            steps 1, 10 and 20 the plain versions' step from the same
            state within 1e-10 relative L2; (d) each K8 and K6
            instance, and K1-K4, launched on the runs whose mesh has its
            element type (the TET10 run in f64: K6 f32 not launched)
  17 mixed drivers  (a) every kernel the new systems launch against its
            plain version (f64 within 1e-13, f32 within 1e-6), timed as
            in phase 2: K1-K3 at the TET4 block, K8 and K6 at each other
            block, K4 (f64, the block-Jacobi diagonal, and f32 on a
            mixed-precision system) at the system's one table, with
            PROTEAS's blocks and dose (V = 5) on make_proteas_case(n=28,
            mixed=True) and order=2, with RIPF's blocks and rebuilt fields
            (V = 3, seeded time derivatives, the day-1 dose) on
            make_ripf_case(n=24, mixed=True) and order=2, and RIPF's
            field rebuild on each block (K1 on TET4, K8 on the others);
            then the same at the shapes of the mixed PIHNA mesh after its
            first constrained adaptation and of the TET10 PIHNA mesh
            after its bisection, with PIHNA's blocks at the run's state;
            (b) 3 f64 steps of the constrained MixedTransientRDCSystem on
            that adapted mixed mesh at rtol 1e-13, kernels vs plain
            versions from a common state, per-step relative L2 within
            1e-10; (c) cli.main in process, every run_steps call
            recorded, launch counts reset just before each run and read
            just after: `-m proteas` on make_proteas_case(n=28,
            n_steps=20) and `-m ripf` on make_ripf_case(n=24,
            n_steps=30), each with mixed=True and with order=2 (the
            artifacts, the last frame's species finite and >= 0, RIPF's
            HU within [-1000, 1000] and its field rebuild's K1 / K8
            launched at least twice a step on each block); `-u
            process_mesh` in process on the mixed and the TET10 PROTEAS
            case meshes, the ExodusII file read back with scipy (one block
            per element type, their element total, the node count); `-m
            pihna` with AMR on make_pihna_case(n=20, mixed=True)
            (refinement_step 10, two adaptations, 30 steps, an output
            every 10) and on
            make_pihna_case(n=28, order=2) (refinement_step 5, one
            bisection, 10 steps, before the runaway of 16b): elements and
            hanging nodes after each adaptation, the amr scope's seconds,
            the last frame's cells the refined mesh's, on the mixed mesh
            u_h = (u_a + u_b) / 2 within 1e-12; each run's wall time,
            PerfLog's phases, inner iterations, residuals and launches per
            kernel instance, every residual <= the rtol

  19 slice 6 and the dense path  (a) the K1-K3 instances of TRI3 on
            box_tri_mesh(512, 512) (524,288 elements, 263,169 nodes) and
            the K8 and K6 instances of QUAD4 on box_quad_mesh(512, 512),
            QUAD9 and QUAD8 raised from box_quad_mesh(256, 256) (65,536
            elements), HEX27 and HEX20 raised from box_hex_mesh(24, 24, 24)
            (13,824 elements), all in the brain box, with PIHNA's bench
            blocks at each mesh's bench state, and K4 at their tables
            (f32, f64, the block-Jacobi diagonal), against their plain
            versions (f64 within 1e-13, f32 within 1e-5), timed as in
            phase 2, each K8 row's share of its bound printed; K8 f64 and
            f32 at HEX20 and HEX27 also on the tile-edge mesh of
            tests/test_torch_gpu.py (box_hex_mesh(5, 5, 3) raised: 75
            elements, three 32-element tiles, the last ragged; elements
            shuffled, nodes jittered) at 1, 5 and 8 species; K4 at the
            dense path's W = 25 over the slot table of box_tet_mesh(28),
            index_add_ beside it; (b) 3 PIHNA steps on
            each of the six meshes, mixed precision at rtol 1e-12, kernels
            vs plain versions from a common state, per-step relative L2
            within 1e-10, every instance of the type launched; (c) `-m
            pihna` in process, 20 steps at the driver's settings (an
            output at the first and the last), on Gmsh files of QUAD4
            512^2, TRI3 512^2 and HEX27 24^3: the artifacts, every
            residual <= the rtol, PerfLog's phases, steps/s and the
            launches; (d) TransientRDCSystem(box_tet_mesh(28), 5,
            physics=pihna_physics), mixed precision, precond_refresh 20,
            10 steps at rtol 1e-14, each within 1e-10 relative L2 of the
            qp path's step from the same state, its steps/s; `assemble`
            through the kernels and the plain versions within 1e-13
  20 the f32 serving mode and ADPM's local parity  (a) K1 f32 and K2
            f32 at TET4 28^3 and TRI3 512^2, K8 f32 at every instance on
            the meshes of phases 9, 16 and 19, against their plain f32
            versions within 1e-5 of the largest value, timed as in phase
            2 (bound: the f32 bytes over the HBM rate); (b) the PIHNA
            bench in dtype=torch.float32 (rtol 3e-11 floored to 1e-6,
            precond_refresh 20, 120 steps of run_steps after 5 warm-up
            steps): steps/s, inner iterations, every residual <= 1e-6, a
            finite non-negative f32 state, only f32 kernel instances
            launched (K1-K4), each step's relative L2 to the port's f64
            run of the same case, and 3 kernel steps against 3 plain
            steps within 1e-5; (c) the same for HEX8 PIHNA on
            box_hex_mesh(48) (40 steps; K8, K6, K4) and the mixed case
            make_pihna_case(n=28, mixed=True) (20 steps); (d) 10 dense f32
            steps on TET4 28^3 (Ke in f32), each within 1e-5 of the f32
            qp path's step from the same state, `assemble` within 1e-5 of
            its plain version; (e) PARITY.md section 10's local parity:
            AdpmOracle's 60-step trajectory on TET4 28^3 (computed in a
            spawned process from the end of the build, on one host CPU
            at the lowest priority; its assembly, and
            Jacobi-BiCGStab to 1e-13 of |F|, held first to the oracle's
            direct solve on 12^3 within 1e-12), the ADPM taxis-active
            system re-seeded from each state for one step at rtol 1e-9,
            worst relative L2 to the oracle's next state <= 1e-8; (f) 3
            f32 PIHNA steps on 20a's TRI3, PRISM6, TET10, QUAD4, QUAD8,
            QUAD9, HEX20 and HEX27 meshes: residuals <= 1e-6, the type's
            f32 instances launched and no f64 kernel
  21 the multi-device halo system, D = 4 shards all on the card
            (parallel.halo.HaloShardedSystem)  (a) K1, K2, K3 f64 and K4
            f64 (over node_gather and over rev_gather, the reverse add)
            at the largest shard of the PIHNA bench mesh, K8, K6 f64 and
            K4 at the largest shard of box_hex_mesh(24), against their
            plain versions, timed as in phase 2; (b) the qp-path halo
            system on the bench mesh and state, 10 steps at rtol 3e-11,
            against the single-device f64 system with the drivers'
            settings: per-step relative L2 <= 1e-8, the plan (D, No_max,
            Gtot, deltas, ghost share of the local slab, ghost bytes an
            exchange), inner iterations of both, steps/s of both, the
            halo steps' launches; (c) the same on HEX8 box_hex_mesh(24),
            5 steps; (d) `-m pihna` on make_pihna_case(n=28), 10 steps,
            one bisection AMR pass at step 5, at parallel/n_devices = 4
            and without: CSV rows within 1e-8, the VTU's processor_ID the
            plan's; phase 15's 12^3 resume case on 4 shards, resumed
            from its step-6 checkpoint, ends on the uninterrupted row
  22 the halo system on the other element types and on MixedMesh, D = 4
            shards all on the card  (a) K8, K6 f64 and K4 f64 (over
            node_gather and rev_gather) at the largest shard of TET10
            box_tet_mesh(28) order 2 and of QUAD4 box_quad_mesh(512);
            at the largest shard of the mixed case's mesh that holds all
            three blocks, K1, K2, K3 f64 at its TET4 block, K8 and K6 f64
            at its HEX8 and PYRAMID5 blocks, K4 f64 over its one table
            over the blocks and over its rev_gather; each against its
            plain version, timed as in phase 2; (b) the qp-path halo
            system on TET10 28^3 and QUAD4 512^2, 5 steps each at rtol
            3e-11, against the single-device f64 system: per-step
            relative L2 <= 1e-8, inner iterations within 2 of each
            other, steps/s of both, the halo steps' launches; (c) the
            same on the mixed case's mesh (box_mixed_mesh(28), brain
            bounds), 10 steps, against MixedTransientRDCSystem in f64;
            (d) `-m pihna` on make_pihna_case(n=28, mixed=True), 20
            steps, one 1:8 AMR pass of its TET4 block at step 10 (hanging
            nodes on the plan), at parallel/n_devices = 4 and without:
            CSV rows within 1e-8, the VTU's processor_ID the plan's;
            (e) `-m adpm` on make_adpm_case(n=28, mixed=True) at the
            taxis amplitude 50, 2 steps, an output each, at 4 shards and
            without: the final species and the CSV's time and
            concentrations within 1e-8, processor_ID the plan's
  23 the moving mesh and the solid's halo Newton on D = 4 shards of the
      card: (a) K4 f64 at the largest shard of the solid bench mesh
      (box_hex_mesh(48), 110,592 HEX8) over its node_gather at W = 3
      and 9, over its face group's fgather and over its rev_gather
      (W = 3 and 9), each against its plain version (1.2e-15) beside
      index_add_, and the shard's batched Ke product (torch.bmm, a
      library call, timed, not a kernel row); (b) HaloSolidSystem
      against the single-device SolidSystem, both with the f64 tangent
      and f64 BiCGStab, one load step run_solver(x0, 0.5) at penalty
      1e6: the positions' relative L2 (<= 1e-8), Newton and inner
      iterations and s a load step of both, the plan; (c) the moving
      halo system against the single-device moving system, 5 HCC steps
      each at rtol 3e-11 at smoothly moved positions, on
      make_hcc_case(n=28)'s TET4 mesh and on the mixed case's mesh:
      each step's relative L2 (<= 1e-8), inner iterations and steps/s
      of both; (d) `-c hcc` on make_hcc_case(n=28), 10 steps and one
      load step, and `-s` on phase 13's solid deck, 2 load steps, at
      parallel/n_devices = 4 and without, both with the f64 tangent,
      f64 Krylov and full Newton steps to a relative residual of 1e-8
      (HCC) or 1e-12 (solid; the decks' step rules off): the last frame's
      c, u_z and VM
      as the drivers hand them to the VTU writer within 1e-8 (rtol and
      atol 1e-8 (1 + max), the reference's _run_both), the halo systems
      stepped, the solve and newton scopes of both
  24 the replicated-iterate system (parallel.sharding.
      ShardedTransientSystem), D = 4 shards all on the card: (a) at
      shard 0 of the PIHNA bench mesh (32,928 of its 131,712 TET4) K1
      and K4 f64 over the shard's (C, N) table for the right-hand side,
      the block-Jacobi diagonal and a matvec's element products, and K8
      and K4 the same at shard 0 of box_hex_mesh(24) (3,456 HEX8), each
      against its plain version, timed as in phase 2, index_add_ beside
      K4; (b) 3 PIHNA steps (the dense physics, f64, rtol 1e-12) on the
      bench mesh and state against the single-device dense f64 system:
      step 1 within 3e-8 of each species' scale, every step within
      1e-4, every residual < 1e-10, K1 and K4 launched over these steps
      alone, steps/s of both; (c) on the bench mesh's node-pair
      sparsity with one step's PIHNA operator: K4 over the rows' table
      against its plain version (index_add_ beside it), bcsr_matvec
      within 1e-13 of its plain version, solve_bcsr (BiCGStab, block
      Jacobi, rtol 1e-12) within 1e-10 relative L2 of the plain solve,
      its residual <= 1e-10

A kernel row's bound is the larger of the bytes its function needs over
the HBM rate and its operations over the peak rate of their type; K4's
and K5's bytes count the live entries of their gather tables and ELL
rows, not the pad.  After the phases, a "walls" line: each phase's wall
seconds.  Then nvidia-smi's name and power limit of the card once more,
and one JSON line {"kernels": [...]}: one row per kernel variant with
the numbers of its first shapes, the launches of every path that ran
(zeros included) and, under "also", its rows at the other shapes; and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import numpy as np
import torch

from rdcfes_tpu_torch.fem import _build
from rdcfes_tpu_torch.fem import kernels as K
from rdcfes_tpu_torch.fem.assembly import ell_structure
from rdcfes_tpu_torch.fem.bcsr import to_ell
from rdcfes_tpu_torch.fem.weakform import (block_diag, block_diag_affine,
                                           block_rhs, diffusion_presum)
from rdcfes_tpu_torch.mesh import box_hex_mesh, box_tet_mesh
from rdcfes_tpu_torch.models import adpm
from rdcfes_tpu_torch.models.pihna import default_params, pihna_blocks
from rdcfes_tpu_torch.solvers.newton import NewtonOptions
from rdcfes_tpu_torch.systems import TransientRDCSystem
from rdcfes_tpu_torch.systems.solid import SolidSystem
from rdcfes_tpu_torch.utils.device import cuda_device

F32, F64 = torch.float32, torch.float64
CSRC = "rdcfes_tpu_torch/csrc/"
# variant -> (source, the TPU kernel it replaces)
KERNELS = {
    "gather_interp_affine_f64": (CSRC + "gather_interp_affine.cu",
                                 "rdcfes_tpu/fem/pallas_df64.py:334"),
    "rhs_affine_f64": (CSRC + "rhs_affine.cu",
                       "rdcfes_tpu/fem/pallas_df64.py:240"),
    "apply_affine_f32": (CSRC + "apply_affine.cu",
                         "rdcfes_tpu/fem/pallas_apply.py:150"),
    "apply_affine_f64": (CSRC + "apply_affine.cu",
                         "rdcfes_tpu/fem/pallas_perm.py:274"),
    "restrict_f32": (CSRC + "restrict.cu",
                     "rdcfes_tpu/fem/pallas_perm.py:203"),
    "restrict_f64": (CSRC + "restrict.cu",
                     "rdcfes_tpu/fem/pallas_perm.py:298"),
    "ell_matvec_f32": (CSRC + "ell_matvec.cu",
                       "rdcfes_tpu/fem/bcsr.py:60"),
    "ell_matvec_f64": (CSRC + "ell_matvec.cu",
                       "rdcfes_tpu/fem/bcsr.py:60"),
    "apply_generic_f32": (CSRC + "apply_generic.cuh",
                          "rdcfes_tpu/fem/pallas_apply.py:263"),
    "apply_generic_f64": (CSRC + "apply_generic.cuh",
                          "rdcfes_tpu/fem/pallas_apply.py:263"),
    "take_along_f32": (CSRC + "take_along.cu",
                       "scripts/microbench_calib.py:84"),
    "gather_interp_generic_f64": (CSRC + "gather_interp_generic.cu",
                                  "rdcfes_tpu/fem/pallas_perm.py:274"),
}
# the K8 and K6 instances of the mixed-mesh and TET10 element types, rows
# of their own (the HEX8 instance's numbers are its variant's rows)
KERNELS.update({f"{v}:{e}": KERNELS[v]
                for v in ("gather_interp_generic_f64", "apply_generic_f32",
                          "apply_generic_f64")
                for e in ("pyramid5", "prism6", "tet10", "quad4", "quad8",
                          "quad9", "hex20", "hex27")})
# the f32 instances of K1, K2 and K8 (the dtype=float32 mode): the gather
# of the reference's f32 mode (pallas_perm.py:244) and the f32
# counterpart of its right-hand side kernel
KERNELS.update({
    "gather_interp_affine_f32": (CSRC + "gather_interp_affine.cu",
                                 "rdcfes_tpu/fem/pallas_perm.py:244"),
    "rhs_affine_f32": (CSRC + "rhs_affine.cu",
                       "rdcfes_tpu/fem/pallas_df64.py:240"),
    "gather_interp_generic_f32": (CSRC + "gather_interp_generic.cu",
                                  "rdcfes_tpu/fem/pallas_perm.py:244")})
KERNELS.update({f"gather_interp_generic_f32:{e}":
                KERNELS["gather_interp_generic_f32"]
                for e in ("pyramid5", "prism6", "tet10", "quad4", "quad8",
                          "quad9", "hex20", "hex27")})
# the K1-K3 instances of TRI3 (TET4's are their variants' rows)
KERNELS.update({f"{v}:tri3": KERNELS[v]
                for v in ("gather_interp_affine_f64", "rhs_affine_f64",
                          "apply_affine_f32", "apply_affine_f64",
                          "gather_interp_affine_f32", "rhs_affine_f32")})
BENCH_STEPS = 120
# NVIDIA H100 SXM data sheet: HBM3 rate; dense f32 and f64 rates outside
# the tensor cores (the kernels here use the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F32: 67e12, F64: 34e12}
HEX_N = 48        # the generic slice: 48^3 = 110,592 HEX8, 117,649 nodes
HEX_WARMUP, HEX_STEPS = 5, 40
BRAIN = ((0, 150.0), (0, 180.0), (0, 150.0))
ADPM_STEPS = 50
# compiled-C++ denominators (BASELINE_MEASURED.json, 8 ideal MPI ranks)
ADPM_BASELINE_STEPS_PER_S = 83.11
ADPM_DECK_BASELINE_OUTER_STEPS_PER_S = 3.516
SOLID_N = 48  # bench.py:313: 48^3 = 110,592 HEX8, 117,649 nodes
SOLID_PT = 0.5
SOLID_BCS = {0: (0.0, 0.0, 0.0), 5: (np.nan, np.nan, -0.05)}
SOLID_MATERIALS = {0: {"young": 1.0e3, "poisson": 0.3}}
SOLID_BENCH_OPTS = NewtonOptions(max_nonlinear_iterations=20,
                                 relative_residual_tolerance=1e-6,
                                 relative_step_tolerance=1e-6,
                                 reuse_tangent=True,
                                 linear_precision="mixed")
SOLID_EXACT_OPTS = NewtonOptions(max_nonlinear_iterations=20,
                                 relative_residual_tolerance=1e-10,
                                 relative_step_tolerance=1e-10,
                                 absolute_residual_tolerance=1e-10,
                                 linear_precision="f64")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------
def bench_case(mesh=None):
    """The headline bench leg's mesh (or `mesh`), deck and initial
    state."""
    if mesh is None:
        mesh = box_tet_mesh(28, 28, 28, bounds=BRAIN)
    Kk = 2.39e5
    params = default_params()
    params.update(
        dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
        cells_max_capacity_exponent=3.0, cytokines_max_capacity=1.0e-8,
        necrosis_c=500.0 / Kk, necrosis_h=200.0 / Kk, necrosis_v=300.0 / Kk,
        produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82, switch_h2n=0.5,
        diffuse_v=0.5, produce_v=10.0,
        secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, decay_a=5678.4,
    )
    params = {k: float(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    u0 = np.zeros((mesh.n_nodes, 5))
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0[:, 1] = 2000.0 * np.exp(-r2 / (2 * 25.0**2))
    u0[:, 2] = 500.0 * np.exp(-r2 / (2 * 30.0**2))
    u0[:, 3] = 7200.0 * (1.0 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    return mesh, params, u0


def oracle_case():
    """The oracle parity case (tests/test_parity_oracle.py): every PIHNA
    term active on a small brain-like box."""
    mesh = box_tet_mesh(4, 4, 4, bounds=((0, 20.0), (0, 20.0), (0, 20.0)))
    Kk = 2.39e5
    p = default_params()
    p.update(
        dt=0.1, cells_min_capacity=1.0, cells_max_capacity=Kk,
        cells_max_capacity_exponent=3.0, cytokines_max_capacity=1e-8,
        necrosis_c=500 / Kk, necrosis_h=200 / Kk, necrosis_v=300 / Kk,
        produce_c=-2.5, switch_c2h=1.0, switch_h2c=1.82, switch_h2n=0.5,
        diffuse_c=0.5, taxis_c=2e-5, diffuse_h=1.0, taxis_h=4e-5,
        diffuse_v=0.2, taxis_v=1e-4, produce_v=10.0,
        secrete_a_c=2.77e-13, secrete_a_h=5.22e-10, uptake_a_v=1e-3,
        decay_a=5678.4,
    )
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 0] = 50.0 * np.exp(-r2 / 20.0)
    u0[:, 1] = 2000.0 * np.exp(-r2 / 30.0)
    u0[:, 2] = 500.0 * np.exp(-r2 / 25.0)
    u0[:, 3] = 7200.0 * np.exp(-r2 / 200.0)
    u0[:, 4] = 1e-10 * np.exp(-r2 / 50.0)
    return mesh, p, u0


def adpm_case(mesh, amplitude):
    """The ADPM bench legs' deck and state on `mesh` (bench.py:158-181,
    :241-261): taxis amplitude 50 (taxis-active leg) or 1e3 (deck regime).
    Returns (params, u0 (N, 3), tracts (E, 3))."""
    p = adpm.default_params()
    p.update(
        dt=0.05,
        decay_PrP=1.0e-4, decay_PrP_pulse0=0.01, decay_PrP_pulse1=10.0,
        taxis1_A_b=amplitude, taxis1_A_b_pulse0=-1.0,
        taxis1_A_b_pulse1=0.01,
        taxis1_Tau=amplitude, taxis1_Tau_pulse0=-1.0,
        taxis1_Tau_pulse1=0.01,
        decay_Tau=1.0e1, decay_Tau_pulse0=0.0005, decay_Tau_pulse1=1.0e20,
        diffuse_A_b=2e-4, diffuse_A_b_pulse0=-1.0, diffuse_A_b_pulse1=1e20,
    )
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(0)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 1e-3 * np.exp(-r2 / (2 * 20.0**2))
    u0[:, 2] = 1e-4 * np.exp(-r2 / (2 * 15.0**2))
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    return p, u0, tracts


def adpm_oracle_case():
    """The ADPM oracle parity case (tests/test_parity_oracle.py:128-146):
    response functions, tract-gated taxis and diffusion all active."""
    mesh = box_tet_mesh(4, 4, 4, bounds=((0, 20.0), (0, 20.0), (0, 20.0)))
    p = adpm.default_params()
    p.update(dt=0.05,
             decay_PrP=1e-4, decay_PrP_pulse0=0.01, decay_PrP_pulse1=10.0,
             diffuse_A_b=0.05, taxis1_A_b=0.5, taxis2_A_b=0.2,
             produce_A_b=0.3, produce_A_b_s0=0.2, produce_A_b_s1=0.8,
             transform_A_b=0.1, transform_A_b_t0=0.01, transform_A_b_t1=0.1,
             transform_A_b_t2=0.5, transform_A_b_t3=0.9,
             decay_A_b=0.05,
             diffuse_Tau=0.02, taxis1_Tau=0.3, decay_Tau=1.0)
    p = {k: float(v) for k, v in p.items()}
    rng = np.random.default_rng(5)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = 0.3 * np.exp(-r2 / 30.0)
    u0[:, 2] = 0.1 * np.exp(-r2 / 20.0)
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    return mesh, p, u0, tracts


def make_adpm(mesh, dev, rtol, ops=K.KERNEL_OPS, precond_refresh=10):
    return TransientRDCSystem(mesh, 3, adpm.adpm_blocks, rtol=rtol,
                              precision="mixed",
                              precond_refresh=precond_refresh, device=dev,
                              ops=ops)


def adpm_fields(tracts, dev):
    return {"tracts": torch.as_tensor(tracts, dtype=F64, device=dev),
            "time": 1.0}


def make_system(mesh, dev, ops=K.KERNEL_OPS, precond_refresh=20,
                rtol=3e-11):
    return TransientRDCSystem(mesh, 5, pihna_blocks, rtol=rtol,
                              precision="mixed",
                              precond_refresh=precond_refresh, device=dev,
                              ops=ops)


def make_solid(n, dev, opts, tangent_precision, ops=K.KERNEL_OPS):
    """The solid bench leg's system (bench.py:290-341) on box_hex_mesh(n)."""
    return SolidSystem(box_hex_mesh(n, n, n), materials=SOLID_MATERIALS,
                       bcs=SOLID_BCS, penalty=1.0e6, newton=opts,
                       tangent_precision=tangent_precision, device=dev,
                       ops=ops)


def rel_l2(a: torch.Tensor, b) -> float:
    a = a.detach().cpu().numpy()
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device():
    dev = cuda_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("0 device", device=dev, kind=repr(torch.cuda.get_device_name(dev)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return dev, card


def _ptxas_table(log: str):
    """(kernel, registers, static shared memory bytes, spill stores, spill
    loads) per entry function of nvcc's -Xptxas -v output."""
    import re

    rows, name, spill = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            rows.append((_demangle(name), int(m.group(1)),
                         int(smem.group(1)) if smem else 0) + spill)
            name = None
    return rows


def _demangle(sym: str) -> str:
    """'...20apply_generic_kernelIdLi5ELi8ELi8EE...' ->
    'apply_generic_kernel<d,5,8,8>' (kernels are named after their
    source: csrc/<stem>.cu holds <stem>_kernel or <stem>_<part>_kernel)."""
    import re

    stems = "|".join(p.stem for p in _build.CSRC.glob("*.cu"))
    m = re.search(rf"((?:{stems})(?:_[a-z]+)?_kernel)"
                  r"(?:I([fd])((?:Li\d+E)*))?", sym)
    if not m:
        return sym
    args = [m.group(2)] + re.findall(r"Li(\d+)E", m.group(3) or "")
    return m.group(1) + (f"<{','.join(args)}>" if m.group(2) else "")


def phase_build():
    from rdcfes_tpu_torch import native

    res = _build.build()
    _build.library()
    mk = native.build()
    native.library()
    rows = _ptxas_table(res.log)
    say("1 build", seconds=f"{res.seconds:.3f}", lib=res.path.name,
        kernels=len(rows), meshkit_seconds=f"{mk.seconds:.3f}",
        meshkit=mk.path.name)
    for name, regs, smem, st, ld in rows:
        print(f"    ptxas: {name} registers={regs} smem={smem} "
              f"spill_stores={st} spill_loads={ld}{_tile_smem(name)}",
              flush=True)


def _tile_smem(name: str) -> str:
    """K8's tile instances take their shared memory at launch: the
    corners (V, K, 32) and phi (Q, K) of csrc/gather_interp_generic.cu's
    tile_smem, here at 5 species and at K.MAX_V."""
    import re

    m = re.fullmatch(r"gather_interp_generic_tile_kernel<([fd]),(\d+),"
                     r"(\d+),\d+>", name)
    if not m:
        return ""
    size = 8 if m.group(1) == "d" else 4
    Kc, Q = int(m.group(2)), int(m.group(3))
    smem = lambda V: (V * Kc * 32 + Q * Kc) * size
    return (f" dynamic_smem_v5={smem(5)} "
            f"dynamic_smem_v{K.MAX_V}={smem(K.MAX_V)}")


def cuda_ms(fn, runs: int = 20) -> float:
    """Median device time of one call, CUDA events.  Each call is queued
    behind a device sleep so the host's launch cost stays off the clock
    as far as the sleep covers it."""
    fn()
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


_FLUSH = []


def _flush_l2() -> None:
    """Read 128 MB, 2.5 times the 50 MB L2, so that the next kernel finds
    its inputs in HBM; a read leaves clean lines, so that kernel pays no
    writebacks for the flush."""
    if not _FLUSH:
        _FLUSH.append(torch.ones(32 << 20, dtype=F32, device="cuda"))
    _FLUSH[0].sum()


def cuda_ms_flushed(fn, runs: int = 20) -> float:
    """cuda_ms with the L2 flushed before each call (inside the device
    sleep's cover, outside the events)."""
    fn()
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        _flush_l2()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_b2b(fn, n: int = 50, reps: int = 5) -> float:
    """Device time of n back-to-back calls over n (median of reps), all
    queued behind one device sleep that covers issuing them, so that each
    launch overlaps the tail of the one before."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def restrict_bytes(flat, table, n_out: int) -> int:
    """The bytes K4's function needs: the source (W, M) read once, the
    index of each live table entry (< M) read once, the (W, n_out) sums
    written once; the table's pad entries are storage, not work."""
    live = int((table < flat.shape[1]).sum())
    return (nbytes(flat) + live * table.element_size()
            + flat.shape[0] * n_out * flat.element_size())


def ell_bytes(nnz: int, values, cols, x) -> int:
    """The bytes K5's function needs: each of the nnz 3x3 blocks and its
    column index read once, x read once, y (x's shape) written once; the
    ELL rows' pad slots are storage, not work."""
    return (nnz * (9 * values.element_size() + cols.element_size())
            + 2 * nbytes(x))


def bound(n_bytes: int, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate of their type."""
    t_b = n_bytes / PEAK_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def measure(phase, name, kern, plain, tol, library=None, n_bytes=0,
            flops=0.0, dtype=F64, k5=None):
    """Kernel vs plain version on the same inputs, then the timings; the
    launches made here do not count (counts are reset before each main
    path).  k5: the L2 state of the inputs between calls, for K5's extra
    timings and its bit-equality (_k5_extra)."""
    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    abs_err, rel = _err(out, ref)
    row = {"max_abs_err": abs_err, "rel_err": rel, "ms": cuda_ms(kern),
           "plain_ms": cuda_ms(plain),
           "library_ms": cuda_ms(library) if library else None,
           **bound(n_bytes, flops, dtype)}
    say(phase, name=name, max_abs_err=f"{abs_err:.3e}", rel_err=f"{rel:.3e}",
        tol=tol, ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.4f}",
        library_ms=("none" if library is None
                    else f"{row['library_ms']:.4f}"),
        bound_ms=f"{row['bound_ms']:.4f}", bound_by=row["bound_by"])
    require(rel <= tol, f"{name}: relative error {rel:.3e} > {tol}")
    if k5 is not None:
        row.update(_k5_extra(phase, name, kern, row, **k5))
    return row


def _k5_extra(phase, name, kern, row, l2, values):
    """K5's second launch bit-equal to its first; its time per call after
    an L2 flush and of 50 back-to-back calls, beside two yardsticks of the
    same timer: a one-element fill (the floor of a launch that moves
    nothing) and values.sum() after a flush (one streaming read of the
    values alone)."""
    require(torch.equal(kern(), kern()), f"{name}: two launches differ")
    extra = {"flushed_ms": cuda_ms_flushed(kern), "b2b_ms": cuda_ms_b2b(kern)}
    one = values.new_zeros(1)
    floor_ms = cuda_ms(lambda: one.fill_(1.0))
    stream_ms = cuda_ms_flushed(lambda: values.sum())
    say(phase + " k5", name=name, l2=repr(l2), bitequal=True,
        ms=f"{row['ms']:.4f}", flushed_ms=f"{extra['flushed_ms']:.4f}",
        b2b_ms=f"{extra['b2b_ms']:.4f}", bound_ms=f"{row['bound_ms']:.4f}",
        flushed_share=f"{row['bound_ms'] / extra['flushed_ms']:.4f}",
        b2b_share=f"{row['bound_ms'] / extra['b2b_ms']:.4f}",
        floor_ms=f"{floor_ms:.4f}", values_sum_flushed_ms=f"{stream_ms:.4f}")
    return extra


def _err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    return abs_err, abs_err / scale


def run_cases(phase, cases, main, also, label="", first=None):
    """measure() every case.  A key is a variant name, or 'variant@what'
    for a second shape of the same variant.  Rows of plain keys without a
    label go to main[variant], the others to also[variant][label what];
    `first`, if given, keeps each variant's first row measured here."""
    for key, c in cases.items():
        variant, _, sub = key.partition("@")
        tag = " ".join(x for x in (label, sub) if x)
        row = measure(phase, f"{variant} ({tag})" if tag else variant, **c)
        if tag:
            also.setdefault(variant, {})[tag] = row
        else:
            main[variant] = row
        if first is not None:
            first.setdefault(variant, row)


def restrict_case(flat, s):
    """K4 on system `s`: flat (W, K E) -> (W, N) through s.node_gather,
    beside index_add_ over the flattened connectivity."""
    W, dt, ng = flat.shape[0], flat.dtype, s.node_gather
    N = s.mesh.n_nodes
    conn_flat = s.conn_T.reshape(-1).long()
    live = int((ng < flat.shape[1]).sum())
    return dict(
        kern=lambda: K.restrict(flat, ng),
        plain=lambda: K.restrict_plain(flat, ng),
        tol=1e-5 if dt == F32 else 1e-13,
        library=lambda: torch.zeros((W, N), dtype=dt, device=flat.device
                                    ).index_add_(1, conn_flat, flat),
        n_bytes=restrict_bytes(flat, ng, N), flops=float(W * live),
        dtype=dt)


def affine_cases(phase, s, u, blocks_of, g=None):
    """K1-K4 cases on the affine (TET4) system `s` at the state u (V, N)
    f64 and the geometry g (default: its rest geometry), with the
    coefficient blocks blocks_of(u_qp, grad_qp) builds there: every
    launch a step makes, at the step's shapes (K4 for the right-hand side
    and both matvecs, W = V, and for the block-Jacobi diagonal, W = V V)."""
    V, mesh = s.n_vars, s.mesh
    g = s.geom if g is None else g
    u_qp, gx1 = K.gather_interp_affine_plain(u, s.conn_T, s.phi, g.dphi)
    grad_qp = gx1[:, None].expand(V, u_qp.shape[1], 3, gx1.shape[-1])
    wfb = blocks_of(u_qp, grad_qp)
    rhs = K.stack_rhs(wfb)
    st64 = K.stack_apply(wfb, diffusion_presum(wfb, g.JxW))
    wfb32 = wfb.cast(F32)
    st32 = K.stack_apply(wfb32, diffusion_presum(wfb32, g.JxW32))
    u32 = u.to(F32)
    flat64 = K.rhs_affine_plain(rhs, g.JxW, s.phi, g.dphi).reshape(V, -1)
    flat32 = K.apply_affine_plain(u32, s.conn_T, s.phi, g.JxW32, g.dphi32,
                                  st32).reshape(V, -1)
    diag64 = block_diag_affine(wfb, s.phi, g.JxW, g.dphi[None]).reshape(
        V * V, -1)
    E = mesh.n_elems
    Kc, Q = s.conn_T.shape[0], g.JxW.shape[0]
    fe = flat64.reshape(V, Kc, E)
    nC, nD, nE = len(st64.idxC), len(st64.idxD), len(st64.idxE)
    apply_flops = 2.0 * E * Kc * (V * (Q + 3) + nC * Q + 3 * nD * Q + 3 * nE)
    cases = {
        "gather_interp_affine_f64": dict(
            kern=lambda: K.gather_interp_affine(u, s.conn_T, s.phi, g.dphi),
            plain=lambda: K.gather_interp_affine_plain(u, s.conn_T, s.phi,
                                                       g.dphi), tol=1e-13,
            n_bytes=nbytes(u, s.conn_T, g.dphi, u_qp, gx1),
            flops=2.0 * V * Kc * E * (Q + 3)),
        "rhs_affine_f64": dict(
            kern=lambda: K.rhs_affine(rhs, g.JxW, s.phi, g.dphi),
            plain=lambda: K.rhs_affine_plain(rhs, g.JxW, s.phi, g.dphi),
            tol=1e-13, n_bytes=nbytes(rhs.A, rhs.B, g.JxW, g.dphi, fe),
            flops=2.0 * Kc * Q * E * (len(rhs.idxA) + 3 * len(rhs.idxB))),
        "apply_affine_f32": dict(
            kern=lambda: K.apply_affine(u32, s.conn_T, s.phi, g.JxW32,
                                        g.dphi32, st32),
            plain=lambda: K.apply_affine_plain(u32, s.conn_T, s.phi, g.JxW32,
                                               g.dphi32, st32), tol=1e-5,
            n_bytes=nbytes(u32, s.conn_T, g.JxW32, g.dphi32, st32.C,
                           st32.D, st32.Epre, flat32), flops=apply_flops,
            dtype=F32),
        "apply_affine_f64": dict(
            kern=lambda: K.apply_affine(u, s.conn_T, s.phi, g.JxW, g.dphi,
                                        st64),
            plain=lambda: K.apply_affine_plain(u, s.conn_T, s.phi, g.JxW,
                                               g.dphi, st64), tol=1e-13,
            n_bytes=nbytes(u, s.conn_T, g.JxW, g.dphi, st64.C, st64.D,
                           st64.Epre, fe), flops=apply_flops),
        "restrict_f32": restrict_case(flat32, s),
        "restrict_f64": restrict_case(flat64, s),
        "restrict_f64@diagonal": restrict_case(diag64, s),
    }
    say(phase + " shapes", V=V, K=Kc, Q=Q, E=E, N=mesh.n_nodes,
        C=s.node_gather.shape[0], live=f"C:{nC} D:{nD} E:{nE} "
        f"A:{len(rhs.idxA)} B:{len(rhs.idxB)}")
    return cases


def phase_kernels(dev, also):
    mesh, params, u0 = bench_case()
    s = make_system(mesh, dev)
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    results = {}
    run_cases("2 kernel", affine_cases(
        "2 kernels", s, u, lambda uq, gq: pihna_blocks(uq, gq, {}, params)),
        results, also)
    return results


def phase_oracle(dev):
    from oracle.pihna_numpy import PihnaOracle

    mesh, p, u0 = oracle_case()
    orc = PihnaOracle(mesh.coords, mesh.connectivity, p)
    s = make_system(mesh, dev, precond_refresh=1)
    st = s.initial_state(u0)
    uo = u0.copy()
    worst = 0.0
    for _ in range(3):
        st, _, _ = s.step(st, params=p)
        uo, _ = orc.step(uo)
        worst = max(worst, rel_l2(st["u"], uo))
    say("3 oracle", steps=3, worst_rel_l2=f"{worst:.3e}", bar=1e-8)
    require(np.isfinite(uo).all() and worst < 1e-8,
            f"oracle parity violated: worst rel L2 {worst:.3e}")


def phase_paths(dev):
    mesh, params, u0 = bench_case()
    a = make_system(mesh, dev)
    b = make_system(mesh, dev, ops=K.PLAIN_OPS)
    sa, sb = a.initial_state(u0), b.initial_state(u0)
    worst = 0.0
    for _ in range(3):
        sa, _, _ = a.step(sa, params=params)
        sb, _, _ = b.step(sb, params=params)
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
    say("4 paths", steps=3, worst_rel_l2=f"{worst:.3e}", bar=1e-10)
    require(worst < 1e-10, f"kernel vs plain path: {worst:.3e}")


def phase_slice(dev):
    mesh, params, u0 = bench_case()
    s = make_system(mesh, dev)
    st, _, _ = s.run_steps(s.initial_state(u0), BENCH_STEPS, params=params)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    st, its, ress = s.run_steps(s.initial_state(u0), BENCH_STEPS,
                                params=params)
    u = st["u"].cpu().numpy()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    final_res = float(ress[-1])
    say("5 slice", steps=BENCH_STEPS, seconds=f"{wall:.4f}",
        steps_per_s=f"{BENCH_STEPS / wall:.4f}",
        inner_iters_total=int(its.sum()), final_residual=f"{final_res:.3e}",
        max_residual=f"{float(ress.max()):.3e}", n_nodes=mesh.n_nodes,
        n_elems=mesh.n_elems)
    say("5 launches", **counts)
    require(np.isfinite(u).all(), "non-finite state")
    require((u >= 0).all(), "negative state after the clamp")
    require(final_res <= 3e-11, f"final residual {final_res:.3e} > 3e-11")
    missing = [k for k in K.TRANSIENT_VARIANTS if counts[k] == 0]
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    return counts


def _flat_targets(table, n_src: int):
    """The target (column) of every entry of a flat source buffer of
    n_src entries, read off its K4 gather table (C, M): the inverse of
    fem.assembly.invert_scatter, on the device."""
    t = table.long()
    live = t < n_src
    out = torch.empty(n_src, dtype=torch.long, device=t.device)
    out[t[live]] = torch.arange(t.shape[1], device=t.device).expand_as(
        t)[live]
    return out


def solid_cases(S, x, pt, pad=True, residual=False):
    """K4's matrix assembly (f32, f64) and K5 (f32, f64; with `pad` f32
    also with 6 zero slots more) cases on solid `S` at positions x (N, 3)
    and pseudo-time pt: the element blocks of every element block,
    concatenated as the system's one gather table takes them, and the
    tangent assembled there, beside index_add_ and a cuSPARSE CSR mv of
    the same operator; with `residual` also K4 at the residual's width
    (W = 3, f64 and f32).  Returns (cases, what the prints need)."""
    dev = x.device
    rng = np.random.default_rng(7)
    N = S.mesh.n_nodes
    pt64 = torch.tensor(pt, dtype=F64, device=dev)
    fk = S._elements(x, pt64, True)
    flat64 = S._concat([Ke for _, Ke in fk], 9)
    fe64 = S._concat([Fe for Fe, _ in fk], 3) if residual else None
    del fk
    flat32 = S._concat([Ke for _, Ke in S._elements(
        x.to(F32), pt64.to(F32), True, f32=True)], 9)
    _, values = S.assemble(x.T.contiguous(), pt)  # the system's tangent
    cols_np, slot_np = ell_structure(S.sp)
    cols = torch.as_tensor(cols_np, device=dev)
    vell = to_ell(values, torch.as_tensor(slot_np, device=dev))
    vell32, vell64 = vell.to(F32), vell.to(F64)
    del vell
    xv64 = torch.as_tensor(rng.standard_normal((3, N)), dtype=F64,
                           device=dev)
    xv32 = xv64.to(F32)
    nnz, sg = S.sp.nnz, S.slot_gather
    slots_flat = _flat_targets(sg, flat32.shape[1])
    # the same operator as a scalar CSR matrix (3N x 3N, node-major dofs)
    # for the library SpMV; built once, outside the timings
    rows = torch.as_tensor(S.sp.rows, device=dev).long()
    bcols = torch.as_tensor(S.sp.cols, device=dev).long()
    vw = torch.arange(3, device=dev)
    r_idx = (3 * rows[None, None, :] + vw[:, None, None]).expand(3, 3, nnz)
    c_idx = (3 * bcols[None, None, :] + vw[None, :, None]).expand(3, 3, nnz)
    coo = torch.sparse_coo_tensor(
        torch.stack([r_idx.reshape(-1), c_idx.reshape(-1)]),
        values.reshape(-1).to(F64), (3 * N, 3 * N)).coalesce()
    csr64 = coo.to_sparse_csr()
    csr32 = csr64.to(F32)
    del coo, r_idx, c_idx, values
    xi64, xi32 = xv64.T.reshape(-1), xv32.T.reshape(-1)
    mv_flops = 2.0 * 9 * nnz

    def k5(vell, cols, xv):
        """K5's extra timings: the L2 state of its inputs between
        calls."""
        held = nbytes(vell, cols, xv, xv)
        l2 = (f"{held / 1e6:.1f} MB > 50 MB L2: cold in every timing"
              if held > 50e6 else
              f"{held / 1e6:.1f} MB fit the 50 MB L2: warm in ms and "
              f"b2b_ms, cold in flushed_ms")
        return dict(l2=l2, values=vell)

    def k4(flat, table, targets, n_out, tol):
        W, dt = flat.shape[0], flat.dtype
        entries = int((table < flat.shape[1]).sum())
        return dict(
            kern=lambda: K.restrict(flat, table),
            plain=lambda: K.restrict_plain(flat, table), tol=tol,
            library=lambda: torch.zeros((W, n_out), dtype=dt, device=dev
                                        ).index_add_(1, targets, flat),
            n_bytes=restrict_bytes(flat, table, n_out),
            flops=float(W * entries), dtype=dt)

    cases = {
        "restrict_f32": k4(flat32, sg, slots_flat, nnz, 1e-5),
        "restrict_f64": k4(flat64, sg, slots_flat, nnz, 1e-13),
        "ell_matvec_f32": dict(
            kern=lambda: K.ell_matvec(vell32, cols, xv32),
            plain=lambda: K.ell_matvec_plain(vell32, cols, xv32), tol=1e-5,
            library=lambda: torch.mv(csr32, xi32),
            n_bytes=ell_bytes(nnz, vell32, cols, xv32), flops=mv_flops,
            dtype=F32, k5=k5(vell32, cols, xv32)),
        "ell_matvec_f64": dict(
            kern=lambda: K.ell_matvec(vell64, cols, xv64),
            plain=lambda: K.ell_matvec_plain(vell64, cols, xv64), tol=1e-13,
            library=lambda: torch.mv(csr64, xi64),
            n_bytes=ell_bytes(nnz, vell64, cols, xv64), flops=mv_flops,
            k5=k5(vell64, cols, xv64)),
    }
    L = cols.shape[0]
    if pad:
        # the same operator at a width no mesh here gives: 6 more slots,
        # each a zero block on a valid column
        vpad32 = torch.cat([vell32, vell32.new_zeros((3, 3, 6, N))], dim=2)
        cpad = torch.cat([cols, cols[-1:].expand(6, N)]).contiguous()
        cases["ell_matvec_f32_pad6"] = dict(
            kern=lambda: K.ell_matvec(vpad32, cpad, xv32),
            plain=lambda: K.ell_matvec_plain(vpad32, cpad, xv32), tol=1e-5,
            library=lambda: torch.mv(csr32, xi32),
            n_bytes=ell_bytes(nnz, vpad32, cpad, xv32), flops=mv_flops,
            dtype=F32,
            k5=k5(vpad32, cpad, xv32))
    if residual:
        ng = S.node_gather
        targets = _flat_targets(ng, fe64.shape[1])
        cases["restrict_f64@residual"] = k4(fe64, ng, targets, N, 1e-13)
        cases["restrict_f32@residual"] = k4(fe64.to(F32), ng, targets, N,
                                            1e-5)
    lib_err = float((torch.mv(csr64, xi64).reshape(N, 3).T
                     - K.ell_matvec_plain(vell64, cols, xv64)).abs().max())
    shapes = (f"E={S.mesh.n_elems} N={N} nnz={nnz} L={L} "
              f"C={sg.shape[0]} KKE={flat32.shape[1]}"
              + (f" C_res={S.node_gather.shape[0]} KE={fe64.shape[1]}"
                 if residual else ""))
    return cases, shapes, lib_err


def phase_solid_kernels(dev, S):
    """K5 and K4's matrix assembly at the solid bench's shapes, on the
    tangent assembled at seeded perturbed positions."""
    rng = np.random.default_rng(6)
    N = S.mesh.n_nodes
    h = 1.0 / SOLID_N
    X0 = S.initial_positions()
    x = X0 + torch.as_tensor(0.05 * h * rng.standard_normal((N, 3)),
                             dtype=F64, device=dev)
    cases, shapes, lib_err = solid_cases(S, x, SOLID_PT)
    results = {name: measure("6 solid kernel", name, **c)
               for name, c in cases.items()}
    say("6 solid kernels", shapes=shapes,
        library_spmv_max_abs_diff=f"{lib_err:.3e}")
    for name, row in results.items():
        nb = cases[name]["n_bytes"]
        say("6 achieved", name=name, bytes=nb,
            tb_per_s=f"{nb / (row['ms'] * 1e-3) / 1e12:.4f}")
    return results


def phase_solid_paths(dev):
    """One exact-f64 load step on box_hex_mesh(12,12,12), kernels vs
    plain versions."""
    us = []
    for ops in (K.KERNEL_OPS, K.PLAIN_OPS):
        s = make_solid(12, dev, SOLID_EXACT_OPTS, "f64", ops=ops)
        r = s.run_solver(s.initial_positions(), SOLID_PT)
        require(r.converged, "exact-f64 load step did not converge")
        us.append(s.displacement(r.x))
        say("7 path", ops="kernels" if ops is K.KERNEL_OPS else "plain",
            newton_iters=r.iters, linear_iters=r.linear_iters,
            r_ratio=f"{r.residual_norm / r.initial_residual_norm:.3e}")
    err = rel_l2(us[0], us[1])
    say("7 paths", rel_l2_displacement=f"{err:.3e}", bar=1e-10)
    require(err <= 1e-10, f"solid kernel vs plain path: {err:.3e}")


class _StageTimer:
    """Synchronised host-clock totals of the outermost assemble,
    assemble_residual and linear-solve calls of one load step."""

    def __init__(self, S):
        self.S, self.totals, self.calls, self.depth = S, {}, {}, 0
        for obj, attr, name in ((S, "assemble", "tangent_assembly"),
                                (S, "assemble_residual", "residual_only"),
                                (S._newton, "_linear_solve", "linear")):
            setattr(obj, attr, self._wrap(name, getattr(obj, attr)))

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1
            self.depth -= 1
            return out
        return timed

    def remove(self):
        for obj, attr in ((self.S, "assemble"), (self.S, "assemble_residual"),
                          (self.S._newton, "_linear_solve")):
            delattr(obj, attr)


def _device_busy_s(prof) -> float:
    """Sum of the CUDA kernel intervals of a trace (one stream)."""
    cuda = torch.autograd.DeviceType.CUDA
    return 1e-6 * sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == cuda)


def phase_solid_slice(dev, S):
    x0 = S.initial_positions()
    S.run_solver(x0, SOLID_PT)  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = S.run_solver(x0, SOLID_PT)
    x = res.x.cpu().numpy()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    ratio = res.residual_norm / res.initial_residual_norm
    say("8 solid slice", seconds=f"{wall:.4f}", newton_iters=res.iters,
        linear_iters_total=res.linear_iters, converged=res.converged,
        r_ratio=f"{ratio:.3e}", n_nodes=S.mesh.n_nodes,
        n_elems=S.mesh.n_elems, nnz=S.sp.nnz,
        baseline_s=2.95)
    say("8 launches", **{k: counts[k] for k in K.SOLID_VARIANTS})
    # witness independent of the solver's bookkeeping: the plain f64
    # residual at the final and the initial positions
    P = make_solid(SOLID_N, dev, SOLID_BENCH_OPTS, "f64", ops=K.PLAIN_OPS)
    r_fin = float(torch.linalg.vector_norm(
        P.assemble_residual(res.x.T.contiguous(), SOLID_PT)))
    r_ini = float(torch.linalg.vector_norm(
        P.assemble_residual(x0.T.contiguous(), SOLID_PT)))
    del P
    say("8 witness", plain_f64_r_ratio=f"{r_fin / r_ini:.3e}", bar=1e-6)
    require(np.isfinite(x).all(), "non-finite positions")
    require(res.converged, "the load step did not converge")
    require(r_fin / r_ini <= 1e-6,
            f"plain f64 |R|/|R0| {r_fin / r_ini:.3e} > 1e-6")
    missing = [k for k in K.SOLID_VARIANTS if counts[k] == 0]
    require(not missing, f"kernels never launched on the solid path: "
            f"{missing}")
    # where the time goes: one run timed stage by stage (synchronised),
    # one under the profiler for the device's busy share
    timer = _StageTimer(S)
    t0 = time.perf_counter()
    S.run_solver(x0, SOLID_PT)
    torch.cuda.synchronize()
    staged = time.perf_counter() - t0
    timer.remove()
    say("8 stages", seconds=f"{staged:.4f}", **{
        k: f"{v:.4f}s/{timer.calls[k]}" for k, v in timer.totals.items()})
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.run_solver(x0, SOLID_PT)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    busy = _device_busy_s(prof)
    say("8 profile", seconds=f"{traced:.4f}", device_busy_s=f"{busy:.4f}",
        busy_share=f"{busy / traced:.4f}")
    top = sorted(prof.key_averages(), key=lambda e: -getattr(
        e, "self_device_time_total", 0.0))[:8]
    for e in top:
        print(f"    device: {e.key[:60]} "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms "
              f"x{e.count}", flush=True)
    return counts


def generic_cases(tag, s, x64, blocks_of, f32_tol=1e-5, with_restrict=True):
    """K8, K6 and K4 cases on the generic (HEX8) system `s` at the state
    x64 (V, N), with the coefficient blocks blocks_of(u_qp, grad_qp)
    builds there: every launch a step makes, at the step's shapes (K4
    only with with_restrict)."""
    V, E, g = s.n_vars, s.mesh.n_elems, s.geom
    Kc, Q = s.conn_T.shape[0], g.JxW.shape[0]
    u_qp, grad_qp = K.gather_interp_generic_plain(x64, s.conn_T, s.phi,
                                                  g.dphi)
    wfb = blocks_of(u_qp, grad_qp)
    interp_bytes = nbytes(x64, s.conn_T, g.dphi, u_qp, grad_qp)
    del u_qp, grad_qp
    st64 = K.stack_apply_generic(wfb)
    st32 = K.stack_apply_generic(wfb.cast(F32))
    x32 = x64.to(F32)
    nC, nD, nE = len(st64.idxC), len(st64.idxD), len(st64.idxE)
    # interpolation, the (v, w) responses, the projection back
    flops = 2.0 * E * Q * (4 * Kc * V + nC + 3 * nD + 3 * nE
                           + V * (4 + 4 * Kc))
    cases = {"gather_interp_generic_f64": dict(
        kern=lambda: K.gather_interp_generic(x64, s.conn_T, s.phi, g.dphi),
        plain=lambda: K.gather_interp_generic_plain(x64, s.conn_T, s.phi,
                                                    g.dphi),
        tol=1e-13, n_bytes=interp_bytes, flops=2.0 * 4 * V * Q * Kc * E)}
    for name, x, JxW, dphi, st, tol, dt in (
            ("apply_generic_f32", x32, g.JxW32, g.dphi32, st32, f32_tol,
             F32),
            ("apply_generic_f64", x64, g.JxW, g.dphi, st64, 1e-13, F64)):
        out_bytes = V * Kc * E * x.element_size()
        cases[name] = dict(
            kern=lambda x=x, JxW=JxW, dphi=dphi, st=st: K.apply_generic(
                x, s.conn_T, s.phi, JxW, dphi, st),
            plain=lambda x=x, JxW=JxW, dphi=dphi, st=st:
                K.apply_generic_plain(x, s.conn_T, s.phi, JxW, dphi, st),
            tol=tol, flops=flops, dtype=dt,
            n_bytes=nbytes(x, s.conn_T, JxW, dphi, st.C, st.D, st.E)
            + out_bytes)
    say("9 blocks", deck=tag, V=V, live=f"C:{nC} D:{nD} E:{nE}",
        f32_bytes=cases["apply_generic_f32"]["n_bytes"],
        f64_bytes=cases["apply_generic_f64"]["n_bytes"])
    if not with_restrict:
        return cases
    # K4 at this mesh's node_gather: the matvecs' and the right-hand
    # side's restriction (W = V) and the block-Jacobi diagonal's (W = V V)
    flat32 = K.apply_generic_plain(x32, s.conn_T, s.phi, g.JxW32, g.dphi32,
                                   st32).reshape(V, -1)
    flat64 = block_rhs(wfb, s.phi, g.JxW, g.dphi).reshape(V, -1)
    diag64 = block_diag(wfb, s.phi, g.JxW, g.dphi).reshape(V * V, -1)
    cases["restrict_f32@hex8"] = restrict_case(flat32, s)
    cases["restrict_f64@hex8"] = restrict_case(flat64, s)
    cases["restrict_f64@hex8 diagonal"] = restrict_case(diag64, s)
    return cases


def phase_generic_kernels(dev, S, also):
    """K8, K6 and K4 at the HEX8 slice's shapes with PIHNA's and with
    ADPM's live blocks; K1-K4 at the ADPM bench legs' shapes; K7 at the
    calibration's shapes."""
    mesh = S.mesh
    _, params, u0 = bench_case(mesh)
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    results = {}
    run_cases("9 generic kernel", generic_cases(
        "pihna", S, u, lambda uq, gq: pihna_blocks(uq, gq, {}, params)),
        results, also)
    # ADPM's taxis-active blocks on the same mesh: V = 3, live D planes
    pa, ua0, tracts = adpm_case(mesh, 50.0)
    A = make_adpm(mesh, dev, 1e-9)
    ua = torch.as_tensor(np.ascontiguousarray(ua0.T), dtype=F64, device=dev)
    f = adpm_fields(tracts, dev)
    run_cases("9 generic kernel", generic_cases(
        "adpm", A, ua, lambda uq, gq: adpm.adpm_blocks(uq, gq, f, pa)),
        results, also, label="adpm")
    del A, f
    # K6 where E is odd and not a multiple of the tile (125 HEX8): rows
    # that are not 16-byte aligned and a ragged last tile
    odd = make_system(box_hex_mesh(5, 5, 5, bounds=BRAIN), dev)
    _, _, uo0 = bench_case(odd.mesh)
    uo = torch.as_tensor(np.ascontiguousarray(uo0.T), dtype=F64, device=dev)
    run_cases("9 generic kernel", {
        k: c for k, c in generic_cases(
            "pihna odd E", odd, uo,
            lambda uq, gq: pihna_blocks(uq, gq, {}, params)).items()
        if k.startswith("apply_generic")}, results, also, label="odd E")
    del odd
    # the ADPM bench legs' own mesh and blocks (TET4 28^3, V = 3)
    tet = box_tet_mesh(28, 28, 28, bounds=BRAIN)
    pa, ua0, tracts = adpm_case(tet, 50.0)
    A = make_adpm(tet, dev, 1e-9)
    ua = torch.as_tensor(np.ascontiguousarray(ua0.T), dtype=F64, device=dev)
    f = adpm_fields(tracts, dev)
    run_cases("9 affine kernel", affine_cases(
        "9 adpm tet4", A, ua, lambda uq, gq: adpm.adpm_blocks(uq, gq, f, pa)),
        results, also, label="adpm tet4")
    del A, f
    rng = np.random.default_rng(0)
    Sx, M = 192, 4608
    tbl = torch.as_tensor(rng.standard_normal((Sx, 128)), dtype=F32,
                          device=dev)
    idx = torch.as_tensor(rng.integers(0, Sx, (M, 128)), dtype=torch.int32,
                          device=dev)
    idx64 = idx.long()
    results["take_along_f32"] = measure(
        "9 generic kernel", "take_along_f32",
        kern=lambda: K.take_along(tbl, idx),
        plain=lambda: K.take_along_plain(tbl, idx), tol=0.0,
        library=lambda: torch.gather(tbl, 0, idx64),
        n_bytes=nbytes(tbl, idx) + M * 128 * 4, flops=0.0, dtype=F32)
    say("9 generic kernels", shapes=f"K=8 Q=8 E={mesh.n_elems} "
        f"N={mesh.n_nodes} C={S.node_gather.shape[0]}; adpm tet4 "
        f"E={tet.n_elems} N={tet.n_nodes}; take_along S={Sx} M={M} L=128")
    return results


def _fit(label, body, ns=(8, 40)):
    """time = a + b n of n back-to-back eager bodies closed by one
    synchronize: median host time of 3 runs for each n.  Beside it the
    same fit of the loop alone, before the synchronize (the host's cost
    of issuing a body, its launches included), and the CUDA-event time of
    one body on the device: b is the larger of the two where either
    bounds it."""
    def loop_ms(n):
        for _ in range(3):
            body()
        ts, issue = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                body()
            issue.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts)), 1e3 * float(np.median(issue))
    (t1, h1), (t2, h2) = loop_ms(ns[0]), loop_ms(ns[1])
    b = (t2 - t1) / (ns[1] - ns[0])
    a = t1 - b * ns[0]
    host_b = (h2 - h1) / (ns[1] - ns[0])
    dev_ms = cuda_ms(body)
    say("10 fit", body=repr(label), per_body_ms=f"{b:.5f}",
        fixed_ms=f"{a:.5f}", n8_ms=f"{t1:.5f}", n40_ms=f"{t2:.5f}",
        host_per_body_ms=f"{host_b:.5f}", device_ms=f"{dev_ms:.5f}")
    return {"per_body_ms": b, "fixed_ms": a, "host_per_body_ms": host_b,
            "device_ms": dev_ms}


def _host_us(label, fn, n=200):
    """Mean host time of one call of fn over n calls issued back to back
    (the queue drained before; n stays far below the launch queue's
    depth)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    say("10 host", piece=repr(label), us_per_call=f"{us:.3f}")
    return us


def phase_calibration(dev):
    """Per-launch host cost against real work, for unfoldable bodies of
    known device cost (scripts/microbench_calib.py:41-109)."""
    rng = np.random.default_rng(0)
    box = {}

    def chain(name, x0, fn):
        box[name] = x0

        def body():
            box[name] = fn(box[name])
        return body

    scalar = torch.tensor(1.5, dtype=F64, device=dev)
    big = torch.as_tensor(rng.standard_normal(16_777_216), dtype=F32,
                          device=dev)
    sm = torch.as_tensor(rng.standard_normal((4_608, 128)), dtype=F32,
                         device=dev)
    V, N, C, KE = 5, 24_389, 24, 4 * 131_712
    ng = torch.as_tensor(rng.integers(0, KE + 1, (C, N)), dtype=torch.int32,
                         device=dev)
    buf = torch.as_tensor(rng.standard_normal((V, KE)), dtype=F32,
                          device=dev)
    Sx, M = 192, 4_608
    tbl = torch.as_tensor(rng.standard_normal((Sx, 128)), dtype=F32,
                          device=dev)
    idx = torch.as_tensor(rng.integers(0, Sx, (M, 128)), dtype=torch.int32,
                          device=dev)
    # K6 f32 and K3 f32 at host-bound sizes, on the PIHNA blocks at the
    # bench state: the launch path's host cost per matvec apply
    hex_s = make_system(box_hex_mesh(12, 12, 12, bounds=BRAIN), dev)
    tet_s = make_system(box_tet_mesh(12, 12, 12, bounds=BRAIN), dev)
    _, params, _ = bench_case(hex_s.mesh)
    applies = {}
    for name, s in (("apply_generic K6 f32", hex_s),
                    ("apply_affine K3 f32", tet_s)):
        _, _, u0 = bench_case(s.mesh)
        u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64,
                            device=dev)
        if s is hex_s:
            uq, gq = K.gather_interp_generic_plain(u, s.conn_T, s.phi,
                                                   s.geom.dphi)
            st = K.stack_apply_generic(
                pihna_blocks(uq, gq, {}, params).cast(F32))
            args = (s.conn_T, s.phi, s.geom.JxW32, s.geom.dphi32, st)
            applies[name] = (K.apply_generic, u.to(F32), args)
        else:
            uq, g1 = K.gather_interp_affine_plain(u, s.conn_T, s.phi,
                                                  s.geom.dphi)
            gq = g1[:, None].expand(5, uq.shape[1], 3, g1.shape[-1])
            wfb = pihna_blocks(uq, gq, {}, params).cast(F32)
            st = K.stack_apply(wfb, diffusion_presum(wfb, s.geom.JxW32))
            args = (s.conn_T, s.phi, s.geom.JxW32, s.geom.dphi32, st)
            applies[name] = (K.apply_affine, u.to(F32), args)
    K.reset_launch_counts()
    fits = {
        "scalar sqrt chain": _fit("scalar sqrt chain", chain(
            "s", scalar, lambda c: torch.sqrt(c * c + 1.0))),
        "stream sqrt 67MB": _fit("stream sqrt 67MB", chain(
            "b", big, lambda c: torch.sqrt(c * c + 1e-9))),
        "stream sqrt 2.3MB": _fit("stream sqrt 2.3MB", chain(
            "m", sm, lambda c: torch.sqrt(c * c + 1e-9))),
        "transpose 2.3MB + sqrt": _fit("transpose 2.3MB + sqrt", chain(
            "t", sm, lambda c: torch.sqrt(
                c.T.reshape(4_608, 128) ** 2 + 1e-9))),
        "restrict K4 f32": _fit("restrict K4 f32",
                                lambda: K.restrict(buf, ng)),
        "take_along K7": _fit("take_along K7",
                              lambda: K.take_along(tbl, idx)),
    }
    for name, (fn, x, args) in applies.items():
        fits[name] = _fit(name, lambda fn=fn, x=x, args=args: fn(x, *args))
    # the pieces of one launch through a wrapper, host time each
    tiny_ng = torch.as_tensor(rng.integers(0, 1025, (4, 256)),
                              dtype=torch.int32, device=dev)
    tiny = torch.as_tensor(rng.standard_normal((5, 1024)), dtype=F32,
                           device=dev)
    # the floor of a CUDA-event time: one tiny elementwise kernel
    fits["neg (5, 1024) f32"] = _fit("neg (5, 1024) f32",
                                     lambda: torch.neg(tiny))
    empty_plan = K._plan("restrict_plan", 0, 0, 0, dev.index)
    kf = K._fn("restrict_f32")
    raw = torch._C._cuda_getCurrentRawStream
    for label, fn in (
            ("torch.empty (5, 1024) f32", lambda: torch.empty(
                (5, 1024), dtype=F32, device=dev)),
            ("new_empty (5, 1024)", lambda: tiny.new_empty((5, 1024))),
            ("raw current stream", lambda: raw(dev.index)),
            ("torch.cuda.current_device", torch.cuda.current_device),
            ("ctypes call, no launch (K4, N = 0)",
             lambda: kf(empty_plan[1], 0, 0, 1, 0, 0)),
            ("torch.neg (5, 1024) f32", lambda: torch.neg(tiny)),
            ("K4 wrapper, (5, 1024) -> 256 nodes",
             lambda: K.restrict(tiny, tiny_ng))):
        fits["host: " + label] = {"us_per_call": _host_us(label, fn)}
    counts = K.launch_counts()
    say("10 launches", **{k: counts[k] for k in (
        "take_along_f32", "restrict_f32", "apply_generic_f32",
        "apply_affine_f32")})
    require(all(counts[k] > 0 for k in (
        "take_along_f32", "restrict_f32", "apply_generic_f32",
        "apply_affine_f32")), "the calibration missed a kernel")
    return fits, counts


def phase_generic_paths(dev):
    """Kernels vs plain versions on small HEX8 meshes, and ADPM on TET4
    against the independent NumPy/SuperLU oracle."""
    from oracle.adpm_numpy import AdpmOracle

    hexm = box_hex_mesh(6, 6, 6, bounds=((0, 20.0), (0, 20.0), (0, 20.0)))
    _, params, _ = bench_case(hexm)
    r2 = ((hexm.coords - hexm.coords.mean(0)) ** 2).sum(axis=1)
    rng = np.random.default_rng(0)
    u0 = np.zeros((hexm.n_nodes, 5))
    u0[:, 1] = 2000.0 * np.exp(-r2 / 30.0)
    u0[:, 2] = 500.0 * np.exp(-r2 / 25.0)
    u0[:, 3] = 7200.0 * (1.0 + 0.1 * rng.random(hexm.n_nodes))
    u0[:, 4] = 1e-10
    # both solves converge to rtol 1e-12, so that what is left between
    # them is the kernels' arithmetic and not two solver exits at 3e-11
    a = make_system(hexm, dev, rtol=1e-12)
    b = make_system(hexm, dev, ops=K.PLAIN_OPS, rtol=1e-12)
    sa, sb = a.initial_state(u0), b.initial_state(u0)
    worst = 0.0
    for _ in range(3):
        sa, ia, ra = a.step(sa, params=params)
        sb, ib, rb = b.step(sb, params=params)
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
        require(max(float(ra), float(rb)) <= 1e-12,
                f"HEX8 PIHNA residuals {float(ra):.3e}, {float(rb):.3e}")
    say("11 paths", model="pihna", mesh="hex 6^3", steps=3, rtol=1e-12,
        worst_rel_l2=f"{worst:.3e}", bar=1e-10)
    require(worst < 1e-10, f"HEX8 PIHNA kernel vs plain path: {worst:.3e}")

    # ADPM taxis-active: every step from a common state (the kernel
    # path's), since taxis amplifies differences along a trajectory
    pa, ua0, tracts = adpm_case(hexm, 50.0)
    ua0[:, 1] = 1e-3 * np.exp(-r2 / 30.0)
    ua0[:, 2] = 1e-4 * np.exp(-r2 / 20.0)
    f = adpm_fields(tracts, dev)
    a = make_adpm(hexm, dev, 1e-11, precond_refresh=1)
    b = make_adpm(hexm, dev, 1e-11, ops=K.PLAIN_OPS, precond_refresh=1)
    sa = a.initial_state(ua0)
    worst = 0.0
    for _ in range(3):
        sb, _, _ = b.step(sa, fields=f, params=pa)
        sa, _, _ = a.step(sa, fields=f, params=pa)
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
    say("11 paths", model="adpm taxis-active", mesh="hex 6^3", steps=3,
        worst_rel_l2=f"{worst:.3e}", bar=1e-10)
    require(worst < 1e-10, f"HEX8 ADPM kernel vs plain path: {worst:.3e}")

    mesh, po, uo, tr = adpm_oracle_case()
    orc = AdpmOracle(mesh.coords, mesh.connectivity, tr, po)
    s = make_adpm(mesh, dev, 3e-11, precond_refresh=1)
    f = adpm_fields(tr, dev)
    worst = 0.0
    for _ in range(3):
        st, _, _ = s.step(s.initial_state(uo), fields=f, params=po)
        uo, _ = orc.step(uo, time=1.0)
        worst = max(worst, rel_l2(st["u"], uo))
    say("11 oracle", model="adpm", mesh="tet 4^3", steps=3,
        worst_local_rel_l2=f"{worst:.3e}", bar=1e-8)
    require(np.isfinite(uo).all() and worst < 1e-8,
            f"ADPM oracle parity violated: worst rel L2 {worst:.3e}")


def _timed_run(s, state, n, **kw):
    """run_steps with the launch counts reset just before and read just
    after; the state is fetched to the host inside the clock."""
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    st, its, ress = s.run_steps(state, n, **kw)
    u = st["u"].cpu().numpy()
    wall = time.perf_counter() - t0
    return u, its, ress, wall, K.launch_counts()


def _require_launched(counts, variants, what):
    missing = [k for k in variants if counts[k] == 0]
    require(not missing, f"kernels never launched on {what}: {missing}")


def phase_generic_slice(dev, S):
    from torch.profiler import ProfilerActivity, profile

    mesh = S.mesh
    _, params, u0 = bench_case(mesh)
    S.run_steps(S.initial_state(u0), HEX_WARMUP, params=params)
    u, its, ress, wall, counts = _timed_run(S, S.initial_state(u0),
                                            HEX_STEPS, params=params)
    say("12 hex8 pihna", steps=HEX_STEPS, seconds=f"{wall:.4f}",
        steps_per_s=f"{HEX_STEPS / wall:.4f}",
        inner_iters_total=int(its.sum()),
        final_residual=f"{float(ress[-1]):.3e}",
        max_residual=f"{float(ress.max()):.3e}", n_nodes=mesh.n_nodes,
        n_elems=mesh.n_elems)
    say("12 hex8 launches", **{k: counts[k] for k in K.GENERIC_VARIANTS})
    require(np.isfinite(u).all(), "non-finite state")
    require((u >= 0).all(), "negative state after the clamp")
    require(float(ress.max()) <= 3e-11,
            f"residual {float(ress.max()):.3e} > 3e-11")
    _require_launched(counts, K.GENERIC_VARIANTS, "the HEX8 path")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S.run_steps(S.initial_state(u0), 10, params=params)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    busy = _device_busy_s(prof)
    say("12 hex8 profile", steps=10, seconds=f"{traced:.4f}",
        device_busy_s=f"{busy:.4f}", busy_share=f"{busy / traced:.4f}")
    top = sorted(prof.key_averages(), key=lambda e: -getattr(
        e, "self_device_time_total", 0.0))[:8]
    for e in top:
        print(f"    device: {e.key[:60]} "
              f"{getattr(e, 'self_device_time_total', 0.0) / 1e3:.3f} ms "
              f"x{e.count}", flush=True)
    paths = {"hex8_pihna": counts}

    # the ADPM legs on the affine path
    tet = box_tet_mesh(28, 28, 28, bounds=BRAIN)
    pa, ua0, tracts = adpm_case(tet, 50.0)
    A = make_adpm(tet, dev, 1e-9)
    f = adpm_fields(tracts, dev)
    A.run_steps(A.initial_state(ua0), 10, fields=f, params=pa)
    u, its, ress, wall, counts = _timed_run(A, A.initial_state(ua0),
                                            ADPM_STEPS, fields=f, params=pa)
    say("12 adpm taxis-active", steps=ADPM_STEPS, seconds=f"{wall:.4f}",
        steps_per_s=f"{ADPM_STEPS / wall:.4f}",
        inner_iters_total=int(its.sum()),
        final_residual=f"{float(ress[-1]):.3e}",
        max_residual=f"{float(ress.max()):.3e}", n_nodes=tet.n_nodes,
        n_elems=tet.n_elems,
        baseline_steps_per_s=ADPM_BASELINE_STEPS_PER_S)
    say("12 adpm launches", **{k: counts[k] for k in K.TRANSIENT_VARIANTS})
    require(np.isfinite(u).all(), "ADPM: non-finite state")
    require(float(ress.max()) <= 1e-9,
            f"ADPM: residual {float(ress.max()):.3e} > 1e-9")
    _require_launched(counts, K.TRANSIENT_VARIANTS, "the ADPM path")
    paths["adpm"] = counts

    pd, ud0, tracts = adpm_case(tet, 1e3)
    D = make_adpm(tet, dev, 3e-11)
    D.run_steps(D.initial_state(ud0), 1, fields=f, params=pd, subcycle=16)
    u, its, ress, wall, counts = _timed_run(D, D.initial_state(ud0), 2,
                                            fields=f, params=pd, subcycle=16)
    say("12 adpm deck regime", outer_steps=2, subcycle=16,
        seconds=f"{wall:.4f}", outer_steps_per_s=f"{2 / wall:.4f}",
        inner_iters_total=int(its.sum()),
        max_residual=f"{float(ress.max()):.3e}",
        baseline_outer_steps_per_s=ADPM_DECK_BASELINE_OUTER_STEPS_PER_S)
    require(np.isfinite(u).all(), "ADPM deck regime: non-finite state")
    require(tuple(its.shape) == (2,) and tuple(ress.shape) == (2,),
            "subcycled run_steps must report per outer step")
    require(float(ress.max()) <= 1e-8,
            f"ADPM deck regime: residual {float(ress.max()):.3e} > 1e-8")
    _require_launched(counts, K.TRANSIENT_VARIANTS, "the ADPM deck regime")
    paths["adpm_deck"] = counts
    return paths



# ----------------------------------------------------------------------
# phase 13: the CLI drivers
# ----------------------------------------------------------------------
# PIHNA 40 steps (120 until the solid's remeshing runs joined phase 18:
# the script then took 806 s on an NVIDIA H100 80GB HBM3 at 700 W)
DRV_N, DRV_PIHNA_STEPS, DRV_ADPM_STEPS = 28, 40, 40
DRV_PROTEAS_STEPS = 40
# 24^3: 15,625 nodes, the size of run/RIPF133 (15,700 nodes)
DRV_RIPF_N, DRV_RIPF_STEPS = 24, 120
DRV_PIHNA_BASELINE_STEPS_PER_S = 18.87  # BASELINE_MEASURED.json
DRV_SOLID_BASELINE_S = 2.95
DRV_PHASES = ("mesh io", "initial conditions", "system setup", "solve",
              "csv output", "vtu output")
DRV_SOLID_PHASES = ("mesh io", "system setup", "newton solve",
                    "post process", "vtu output")
DRV_TRANSIENT = ("gather_interp_affine_f64", "rhs_affine_f64",
                 "apply_affine_f64", "restrict_f64")
DRV_SOLID = ("restrict_f32", "ell_matvec_f32")
# the solid bench leg (bench.py:290-341) as a deck; the tangent and the
# Krylov precision are the card's defaults (f32, mixed)
DRV_SOLID_DECK = """directory = simulation
input_GMSH = input.msh
loading_step = 0.5
BCs = ' 0 5 '
BC/0/displacement/0 = 0.0
BC/0/displacement/1 = 0.0
BC/0/displacement/2 = 0.0
BC/5/displacement/0 = NAN
BC/5/displacement/1 = NAN
BC/5/displacement/2 = -0.05
BCs/displacement_penalty = 1.0e6
materials = ' 0 '
material/0/Hyperelastic/Young = 1.0e3
material/0/Hyperelastic/Poisson = 0.3
solver/nonlinear/max_nonlinear_iterations = 20
solver/nonlinear/relative_residual_tolerance = 1e-6
solver/nonlinear/relative_step_tolerance = 1e-6
solver/nonlinear/reuse_tangent = true
"""


def _vtu_arrays(path):
    """{name: float array} of the Float64 DataArrays of one VTU file."""
    import re

    with open(path) as f:
        text = f.read()
    return {name: np.array(body.split(), dtype=np.float64)
            for name, body in re.findall(
                r'<DataArray type="Float64" Name="([^"]+)"[^>]*>\n(.*?)\n'
                r"        </DataArray>", text, re.S)}


def _perf_totals(stdout: str) -> dict:
    """Phase -> total seconds from the PerfLog report a driver prints."""
    tail = stdout.split(" Performance log:")[-1].splitlines()[2:]
    out = {}
    for line in tail:
        if line.startswith(" TOTAL"):
            break
        out[line[1:29].strip()] = float(line[37:49])
    return out


def _drive(case_dir, argv, dev):
    """cli.main(argv) in case_dir with the launch counts reset just before
    and read just after; the driver's stdout is kept, not shown."""
    import contextlib
    import io
    import os

    from rdcfes_tpu_torch import cli

    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(case_dir)
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        os.chdir(cwd)
    require(rc == 0, f"cli.main({argv}) returned {rc}")
    return wall, counts, buf.getvalue()


def _transient_artifacts(out_dir, base, outputs, species,
                         csv="output.csv", csv_kind="header"):
    """The CSV (csv_kind "header": a header + one row per output, "rows":
    one row per output, "empty": nothing), one VTU per output, a PVD with
    as many DataSets, the last frame's species finite and >= 0."""
    import os

    rows = open(os.path.join(out_dir, csv)).read().splitlines()
    want = {"header": 1 + len(outputs), "rows": len(outputs),
            "empty": 0}[csv_kind]
    require(len(rows) == want, f"{out_dir}: CSV has {len(rows)} lines, "
            f"not {want}")
    require(csv_kind != "header" or rows[0].startswith('"TIME"'),
            f"{out_dir}: no CSV header")
    for t in outputs:
        require(os.path.exists(os.path.join(out_dir, f"{base}-{t}.vtu")),
                f"{out_dir}: no VTU at t = {t}")
    pvd = open(os.path.join(out_dir, base + ".pvd")).read()
    require(pvd.count("<DataSet") == len(outputs) and "</Collection>" in pvd,
            f"{out_dir}: PVD with {pvd.count('<DataSet')} DataSets")
    last = _vtu_arrays(os.path.join(out_dir, f"{base}-{outputs[-1]}.vtu"))
    for name in species:
        v = last[name]
        require(np.isfinite(v).all() and (v >= 0).all(),
                f"{out_dir}: {name} not finite and >= 0")
    return rows


def _say_driver(tag, wall, stdout, counts, variants, **kw):
    totals = _perf_totals(stdout)
    phases = DRV_SOLID_PHASES if tag == "solid" else DRV_PHASES
    say("13 " + tag, seconds=f"{wall:.4f}",
        **{k.replace(" ", "_") + "_s": f"{totals.get(k, 0.0):.4f}"
           for k in phases}, **kw)
    say(f"13 {tag} launches", **{k: counts[k] for k in variants})
    return totals


def phase_drivers(dev, also):
    """The CLI in process at full width (PIHNA, ADPM and PROTEAS on
    131,712 TET4, RIPF on 82,944 TET4, the solid on 110,592 HEX8), then as `python3 -m rdcfes_tpu_torch.cli`
    in a subprocess on a small case."""
    import os
    import shutil
    import sys
    import tempfile

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.mesh import gmsh
    from rdcfes_tpu_torch.systems import solid as solid_mod

    root = tempfile.mkdtemp(prefix="rdcfes_drivers_")
    total = {k: 0 for k in KERNELS}
    try:
        d = cases.make_pihna_case(os.path.join(root, "pihna"), n=DRV_N,
                                  n_steps=DRV_PIHNA_STEPS)
        wall, counts, out = _drive(d, ["-m", "pihna"], dev)
        outputs = list(range(0, DRV_PIHNA_STEPS + 1, 10))
        _transient_artifacts(os.path.join(d, "PIHNA_simulation"),
                             "Brain_Model", outputs,
                             ("n", "c", "h", "v", "a"))
        require(out.count(" ==== Step") == DRV_PIHNA_STEPS, "PIHNA banners")
        totals = _say_driver("pihna", wall, out, counts,
                             DRV_TRANSIENT + ("apply_affine_f32",),
                             steps=DRV_PIHNA_STEPS)
        say("13 pihna rate",
            solve_steps_per_s=f"{DRV_PIHNA_STEPS / totals['solve']:.4f}",
            baseline_steps_per_s=DRV_PIHNA_BASELINE_STEPS_PER_S)
        _require_launched(counts, DRV_TRANSIENT, "the PIHNA driver")
        require(counts["apply_affine_f32"] == 0,
                "the PIHNA driver runs f64: K3 f32 launched")
        for k in total:
            total[k] += counts.get(k, 0)

        d = cases.make_adpm_case(os.path.join(root, "adpm"), n=DRV_N,
                                 n_steps=DRV_ADPM_STEPS)
        # the case deck's taxis amplitude 1e3 is bench.py's deck regime,
        # which needs subcycle=16 (phase 12); the driver, as the
        # reference's, steps the full dt, where its f64 BiCGStab does not
        # converge at this width: run the taxis-active leg's amplitude 50
        # (bench.py:158-192) instead
        deck = open(os.path.join(d, "input.dat")).read()
        require(deck.count("0.999999e+3") == 2, "ADPM case deck changed")
        with open(os.path.join(d, "input.dat"), "w") as f:
            f.write(deck.replace("0.999999e+3", "50.0"))
        wall, counts, out = _drive(d, ["-m", "adpm"], dev)
        (res_dir,) = [e for e in os.listdir(d)
                      if os.path.isdir(os.path.join(d, e))]
        rows = _transient_artifacts(os.path.join(d, res_dir), "Brain_Model",
                                    list(range(0, DRV_ADPM_STEPS + 1, 20)),
                                    ("PrP", "A_b", "Tau"))
        require("CONCENTRATION__A_b__10" in rows[0]
                and "VOLUME__Tau__20" in rows[0], "ADPM CSV header")
        totals = _say_driver("adpm", wall, out, counts,
                             DRV_TRANSIENT + ("apply_affine_f32",),
                             steps=DRV_ADPM_STEPS)
        say("13 adpm rate",
            solve_steps_per_s=f"{DRV_ADPM_STEPS / totals['solve']:.4f}",
            baseline_steps_per_s=ADPM_BASELINE_STEPS_PER_S)
        _require_launched(counts, DRV_TRANSIENT, "the ADPM driver")
        require(counts["apply_affine_f32"] == 0,
                "the ADPM driver runs f64: K3 f32 launched")
        for k in total:
            total[k] += counts.get(k, 0)

        d = cases.make_proteas_case(os.path.join(root, "proteas"), n=DRV_N,
                                    n_steps=DRV_PROTEAS_STEPS)
        _driver_kernels("13 driver", "proteas", d, "proteas", dev, also)
        wall, counts, out = _drive(d, ["-m", "proteas", "input=input.dat"],
                                   dev)
        _transient_artifacts(os.path.join(d, "simulation"), "out",
                             list(range(0, DRV_PROTEAS_STEPS + 1, 10)),
                             ("hos", "tum", "nec", "vsc", "oed"),
                             csv="simulation.csv", csv_kind="empty")
        require(out.count(" ==== Step") == DRV_PROTEAS_STEPS,
                "PROTEAS banners")
        totals = _say_driver("proteas", wall, out, counts,
                             DRV_TRANSIENT + ("apply_affine_f32",),
                             steps=DRV_PROTEAS_STEPS)
        say("13 proteas rate",
            solve_steps_per_s=f"{DRV_PROTEAS_STEPS / totals['solve']:.4f}",
            baseline="none (BASELINE_MEASURED.json has no PROTEAS run)")
        _require_launched(counts, DRV_TRANSIENT, "the PROTEAS driver")
        require(counts["apply_affine_f32"] == 0,
                "the PROTEAS driver runs f64: K3 f32 launched")
        for k in total:
            total[k] += counts.get(k, 0)

        d = cases.make_ripf_case(os.path.join(root, "ripf"), n=DRV_RIPF_N,
                                 n_steps=DRV_RIPF_STEPS)
        _driver_kernels("13 driver", "ripf", d, "ripf", dev, also)
        wall, counts, out = _drive(d, ["-m", "ripf"], dev)
        (res_dir,) = [e for e in os.listdir(d)
                      if os.path.isdir(os.path.join(d, e))]
        outputs = [0, 10, 30, 60, 90, 120]
        _transient_artifacts(os.path.join(d, res_dir), "Lung_Model",
                             outputs, ("cc", "fb"), csv_kind="rows")
        last = _vtu_arrays(os.path.join(d, res_dir,
                                        f"Lung_Model-{outputs[-1]}.vtu"))
        require(all(np.isfinite(v).all() for v in last.values())
                and np.abs(last["HU"]).max() <= 1000.0,
                "RIPF: a field not finite or HU outside [-1000, 1000]")
        require(out.count(" ==== Step") == DRV_RIPF_STEPS, "RIPF banners")
        totals = _say_driver("ripf", wall, out, counts,
                             DRV_TRANSIENT + ("apply_affine_f32",),
                             steps=DRV_RIPF_STEPS)
        say("13 ripf rate",
            solve_steps_per_s=f"{DRV_RIPF_STEPS / totals['solve']:.4f}",
            baseline="none (BASELINE_MEASURED.json has no RIPF run)")
        _require_launched(counts, DRV_TRANSIENT, "the RIPF driver")
        # K1 twice a step: the step's interpolation and the field rebuild
        require(counts["gather_interp_affine_f64"] >= 2 * DRV_RIPF_STEPS,
                "the RIPF driver's field rebuild did not launch K1")
        require(counts["apply_affine_f32"] == 0,
                "the RIPF driver runs f64: K3 f32 launched")
        for k in total:
            total[k] += counts.get(k, 0)

        d = os.path.join(root, "solid")
        os.makedirs(d)
        gmsh.write(box_hex_mesh(SOLID_N, SOLID_N, SOLID_N),
                   os.path.join(d, "input.msh"))
        with open(os.path.join(d, "input.dat"), "w") as f:
            f.write(DRV_SOLID_DECK)
        results = []
        run_solver = solid_mod.SolidSystem.run_solver

        def recorded(self, x, pseudo_time):
            r = run_solver(self, x, pseudo_time)
            results.append(r)
            return r

        solid_mod.SolidSystem.run_solver = recorded
        try:
            wall, counts, out = _drive(d, ["-s"], dev)
        finally:
            solid_mod.SolidSystem.run_solver = run_solver
        require(len(results) == 2, f"{len(results)} load steps, not 2")
        for i, r in enumerate(results):
            rel = r.residual_norm / r.initial_residual_norm
            say("13 solid load step", step=i + 1, converged=r.converged,
                newton_iters=r.iters, linear_iters=r.linear_iters,
                residual=f"{r.residual_norm:.3e}", rel_residual=f"{rel:.3e}")
            require(r.converged, f"solid load step {i + 1} did not converge")
        last = _vtu_arrays(os.path.join(d, "simulation",
                                        "output4paraview-2.vtu"))
        require(len(last) == 18 and all(np.isfinite(v).all()
                                         for v in last.values()),
                "solid VTU fields not all finite")
        totals = _say_driver("solid", wall, out, counts, DRV_SOLID,
                             load_steps=2)
        say("13 solid rate",
            s_per_load_step=f"{totals['newton solve'] / 2:.4f}",
            baseline_s=DRV_SOLID_BASELINE_S)
        _require_launched(counts, DRV_SOLID, "the solid driver")
        for k in total:
            total[k] += counts.get(k, 0)

        d = cases.make_pihna_case(os.path.join(root, "module"), n=6,
                                  n_steps=3)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "rdcfes_tpu_torch.cli",
                            "-m", "pihna"], cwd=d, env=env,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        require(p.returncode == 0,
                "python3 -m rdcfes_tpu_torch.cli -m pihna exited "
                f"{p.returncode}: {p.stderr[-2000:]}")
        _transient_artifacts(os.path.join(d, "PIHNA_simulation"),
                             "Brain_Model", [0], ("n", "c", "h", "v", "a"))
        say("13 module", command="python3 -m rdcfes_tpu_torch.cli -m pihna",
            exit_code=p.returncode, seconds=f"{wall:.4f}",
            banners=p.stdout.count(" ==== Step"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


# ----------------------------------------------------------------------
# phase 14: the coupled HCC driver and process_mesh
# ----------------------------------------------------------------------
# the shipped schedule's first quarter (dt 0.01, a load step every 10
# steps; 400 steps and 40 load steps until the script's depth was cut
# for phase 18): the state diverges from step ~24 all the same
HCC_N, HCC_STEPS, HCC_LOADING = 28, 100, 10
# every HCC block live (the CPU tests' live deck): 8 C, 2 D, 1 E planes
HCC_LIVE = {"dt": 0.05, "cells_min_capacity": 0.05,
            "cells_max_capacity": 1.0, "cells_max_capacity_exponent": 3.0,
            "produce_l": 0.2, "diffuse_c": 0.3, "mechano_c": 0.4,
            "produce_c": 0.5, "necrosis_l": 0.05, "necrosis_c": 0.1,
            "necrosis_pressure": 0.0}
HCC_PHASES = ("mesh io", "initial conditions", "system setup", "rds solve",
              "solid solve", "post process", "vtu output")
HCC_KERNELS = DRV_TRANSIENT + DRV_SOLID
HCC_OUTPUTS = (0, HCC_STEPS // 2, HCC_STEPS)


def _moved(coords, seed, amp):
    """A seeded smooth, non-affine displacement of coords (N, 3) in a box
    of unit size: a rigid motion would leave JxW as it is and hide a
    stale table."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(1.0, 2.5, (3, 3))
    phase = rng.uniform(0.0, 2 * np.pi, 3)
    return coords + amp * np.sin(np.pi * coords @ k.T + phase)


def _hcc_state(coords):
    r2 = ((coords - 0.5) ** 2).sum(axis=1)
    rng = np.random.default_rng(9)
    return np.stack([0.6 - 0.4 * np.exp(-r2 / 0.1),
                     0.4 * np.exp(-r2 / 0.1) + 0.02 * rng.random(len(r2)),
                     0.05 * np.exp(-r2 / 0.05)], axis=1)


def _moving_paths(dev, mesh, tag, amp):
    """3 steps of run_steps(coords=) and 2 of step(coords=), each at its
    own displacement, through the kernels and the plain versions."""
    from rdcfes_tpu_torch.models.hcc import hcc_blocks

    systems = [TransientRDCSystem(mesh, 3, hcc_blocks, rtol=1e-12,
                                  moving_mesh=True, device=dev, ops=ops)
               for ops in (K.KERNEL_OPS, K.PLAIN_OPS)]
    u0 = _hcc_state(mesh.coords)
    states = [s.initial_state(u0) for s in systems]
    worst, its = 0.0, []
    for i in range(5):
        x = torch.as_tensor(_moved(mesh.coords, i, amp), dtype=F64,
                            device=dev)
        for j, s in enumerate(systems):
            if i < 3:
                states[j], it, _ = s.run_steps(states[j], 1,
                                               params=HCC_LIVE, coords=x)
                it = int(it[0])
            else:
                states[j], it, _ = s.step(states[j], params=HCC_LIVE,
                                          coords=x)
                it = int(it)
            its.append(it)
        worst = max(worst, rel_l2(states[0]["u"], states[1]["u"]))
    u = states[0]["u"].cpu().numpy()
    say("14a moving paths", mesh=tag, n_nodes=mesh.n_nodes,
        n_elems=mesh.n_elems, steps="3 run_steps + 2 step",
        worst_rel_l2=f"{worst:.3e}", bar=1e-10, inner_iters=its[::2])
    require(np.isfinite(u).all(), f"moving {tag}: non-finite state")
    require(worst <= 1e-10, f"moving {tag} kernels vs plain: {worst:.3e}")


def _hcc_kernels(d, dev, also):
    """K1-K4 f64 with the HCC driver's system and blocks on its case mesh
    at the case's initial state, on the geometry of the positions after
    one converged load step; K4 f32 (the assembly) and K5 on the TET4
    solid's tangent there.  Rows go under "also", labelled "hc"."""
    import os

    from rdcfes_tpu_torch.drivers import coupled_hcc as dhcc
    from rdcfes_tpu_torch.drivers import solid as dsolid
    from rdcfes_tpu_torch.drivers.common import make_rdc_system
    from rdcfes_tpu_torch.io import dat
    from rdcfes_tpu_torch.io.getpot import Deck
    from rdcfes_tpu_torch.mesh import gmsh
    from rdcfes_tpu_torch.models.hcc import hcc_blocks

    deck = Deck(os.path.join(d, "input.dat"))
    mesh = gmsh.read(os.path.join(d, deck("input_GMSH", "")))
    u0 = dat.read_stream(os.path.join(d, deck("input_nodal", "")),
                         mesh.n_nodes, 3)
    params = dhcc.load_params(deck)
    s = make_rdc_system(mesh, 3, hcc_blocks, deck, device=dev,
                        moving_mesh=True)
    S = SolidSystem(mesh, materials=dsolid.load_materials(deck),
                    bcs=dsolid.load_bcs(deck),
                    penalty=deck("BCs/displacement_penalty", 1.0e5),
                    fibres=dsolid.load_fibres(deck, mesh),
                    newton=dsolid.load_newton_options(deck, dev),
                    tangent_precision=dsolid.load_tangent_precision(deck,
                                                                    dev),
                    device=dev)
    pt = deck("time_step", 1.0) * HCC_STEPS / HCC_LOADING
    r = S.run_solver(S.initial_positions(), pt)
    require(r.converged, "the HCC case's first load step did not converge")
    du = float(S.displacement(r.x).abs().max())
    require(du > 0.0, "the first load step did not move the mesh")
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    cases = {k: c for k, c in affine_cases(
        "14b hcc", s, u, lambda uq, gq: hcc_blocks(uq, gq, {}, params),
        s._geom_from_coords(r.x)).items()
        if k.partition("@")[0] in DRV_TRANSIENT}
    # the solid's scatters are ordered sums: assemblies, and penalty
    # residuals, are bit-equal from run to run
    x_T = r.x.T.contiguous()
    R1, V1 = S.assemble(x_T, pt)
    zero = torch.zeros_like(x_T)
    P1 = S._penalty_bc_residual(r.x, pt, zero)
    for _ in range(2):
        R2, V2 = S.assemble(x_T, pt)
        require(torch.equal(R1, R2) and torch.equal(V1, V2),
                "HCC: two assemblies of the solid differ")
        require(torch.equal(P1, S._penalty_bc_residual(r.x, pt, zero)),
                "HCC: two penalty residuals differ")
    say("14b hcc bit-equal", assemblies=3, penalty_residuals=3,
        tangent_dtype=str(V1.dtype).replace("torch.", ""),
        residual_norm=f"{float(R1.norm()):.6e}",
        penalty_norm=f"{float(P1.norm()):.6e}")
    scases, shapes, _ = solid_cases(S, r.x, pt)
    cases["restrict_f32@asm"] = scases["restrict_f32"]
    cases["ell_matvec_f32"] = scases["ell_matvec_f32"]
    cases["ell_matvec_f64"] = scases["ell_matvec_f64"]
    say("14b hcc solid shapes", shapes=shapes, newton_iters=r.iters,
        max_abs_u=f"{du:.6e}")
    run_cases("14b hcc kernel", cases, {}, also, label="hc")


def _process_mesh_module(root, case_mesh):
    """`python3 -m rdcfes_tpu_torch.cli -u process_mesh` as a process, fed
    its answers on stdin."""
    import os
    import sys

    from rdcfes_tpu_torch.mesh import gmsh, transform

    d = os.path.join(root, "process_mesh")
    os.makedirs(d)
    src = gmsh.read(case_mesh)
    gmsh.write(src, os.path.join(d, "in.msh"))
    answers = "in.msh\n2\n1.5\n-2\n0.25\n30\n45\n60\n1\nout\n"
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "rdcfes_tpu_torch.cli", "-u",
                        "process_mesh"], cwd=d, env=env, input=answers,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    require(p.returncode == 0, "python3 -m rdcfes_tpu_torch.cli -u "
            f"process_mesh exited {p.returncode}: {p.stderr[-2000:]}")
    for ext in (".msh", ".ex2", ".config"):
        require(os.path.exists(os.path.join(d, "out" + ext)),
                f"process_mesh wrote no out{ext}")
    want = transform.transform_mesh(gmsh.read(os.path.join(d, "in.msh")),
                                    2.0, (1.5, -2.0, 0.25),
                                    (30.0, 45.0, 60.0)).coords
    back = gmsh.read(os.path.join(d, "out.msh")).coords
    # the Gmsh writer prints 6 significant digits
    err = float(np.abs(back - want).max() / np.abs(want).max())
    say("14d module", command="python3 -m rdcfes_tpu_torch.cli -u "
        "process_mesh", exit_code=p.returncode, seconds=f"{wall:.4f}",
        n_nodes=len(back), max_rel_coord_err=f"{err:.3e}", bar=1e-5)
    require(err <= 1e-5, f"process_mesh coords off by {err:.3e}")


def phase_coupled(dev, also):
    """The moving paths, kernels vs plain (a); the kernels at the HCC
    driver's shapes on a deformed geometry (b); `-c hcc` in process on
    the shipped schedule at full width (c); `-u process_mesh` as a
    process (d)."""
    import hashlib
    import os
    import shutil
    import tempfile

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.systems import solid as solid_mod
    from rdcfes_tpu_torch.systems import transient as transient_mod

    _moving_paths(dev, box_tet_mesh(12, 12, 12), "TET4 12^3", 0.02)
    _moving_paths(dev, box_hex_mesh(6, 6, 6), "HEX8 6^3", 0.03)

    root = tempfile.mkdtemp(prefix="rdcfes_hcc_")
    try:
        d = cases.make_hcc_case(os.path.join(root, "hcc"), n=HCC_N,
                                n_steps=HCC_STEPS, n_loading=HCC_LOADING)
        _hcc_kernels(d, dev, also)

        newton, inner, maxiter = [], [], []
        run_solver = solid_mod.SolidSystem.run_solver
        run_steps = transient_mod.TransientRDCSystem.run_steps

        def rec_solver(self, x, pseudo_time):
            r = run_solver(self, x, pseudo_time)
            newton.append(r)
            return r

        def rec_run_steps(self, *a, **kw):
            out = run_steps(self, *a, **kw)
            inner.extend(int(i) for i in out[1])
            maxiter.append(self.maxiter)
            return out

        solid_mod.SolidSystem.run_solver = rec_solver
        transient_mod.TransientRDCSystem.run_steps = rec_run_steps
        try:
            wall, counts, out = _drive(d, ["-c", "hcc"], dev)
        finally:
            solid_mod.SolidSystem.run_solver = run_solver
            transient_mod.TransientRDCSystem.run_steps = run_steps
        sim = os.path.join(d, "simulation")
        for t in HCC_OUTPUTS:
            require(os.path.exists(os.path.join(sim, f"out-{t}.vtu")),
                    f"HCC: no VTU at t = {t}")
        pvd = open(os.path.join(sim, "out.pvd")).read()
        require(pvd.count("<DataSet") == len(HCC_OUTPUTS)
                and "</Collection>" in pvd, "HCC: PVD DataSets")
        last = _vtu_arrays(os.path.join(sim, f"out-{HCC_OUTPUTS[-1]}.vtu"))
        require(len(last) == 21 and all(np.isfinite(v).all()
                                         for v in last.values()),
                f"HCC: {len(last)} VTU arrays, not all finite")
        for name in ("l", "c", "n"):
            require((last[name] >= 0).all(), f"HCC: {name} < 0")
        u_max = max(float(np.abs(last[k]).max())
                    for k in ("u_x", "u_y", "u_z"))
        pts = last["position"].reshape(-1, 3)
        und = np.stack([last["undeformed_" + a] for a in "xyz"], axis=1)
        require(u_max > 0.0 and not np.array_equal(pts, und),
                "HCC: the mesh did not move")
        require(out.count(" ==== Step") == HCC_STEPS, "HCC banners")
        require(len(newton) == HCC_LOADING,
                f"HCC: {len(newton)} Newton solves, not {HCC_LOADING}")
        require(all(r.converged for r in newton),
                "HCC: a load step did not converge")
        require(len(inner) == HCC_STEPS, f"HCC: {len(inner)} RDC steps")
        totals = _perf_totals(out)
        say("14c hcc", seconds=f"{wall:.4f}",
            **{k.replace(" ", "_") + "_s": f"{totals.get(k, 0.0):.4f}"
               for k in HCC_PHASES}, steps=HCC_STEPS,
            load_steps=HCC_LOADING)
        say("14c hcc rate",
            rds_steps_per_s=f"{HCC_STEPS / totals['rds solve']:.4f}",
            s_per_load_step=f"{totals['solid solve'] / HCC_LOADING:.4f}",
            rds_inner_iters=sum(inner),
            newton_iters=sum(int(r.iters) for r in newton),
            newton_linear_iters=sum(int(r.linear_iters) for r in newton),
            max_abs_u=f"{u_max:.6e}")
        say("14c hcc launches", **{k: counts[k] for k in
                                   HCC_KERNELS + ("apply_affine_f32",)})
        # what the RDC solves did, step by step: a BiCGStab breakdown
        # reports maxiter, and a step whose residual is not a number
        # takes 0 iterations; the largest species values show the state
        its = np.array(inner)
        broke = np.nonzero(its >= maxiter[0])[0]
        solved = its[(its > 0) & (its < maxiter[0])]
        frames = {t: _vtu_arrays(os.path.join(sim, f"out-{t}.vtu"))
                  for t in HCC_OUTPUTS}
        with open(os.path.join(sim, f"out-{HCC_OUTPUTS[-1]}.vtu"),
                  "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        say("14c hcc solves", k3_f64_launches=counts["apply_affine_f64"],
            last_frame_sha256=digest, breakdowns=len(broke),
            first_breakdown_step=int(broke[0]) + 1 if len(broke) else None,
            zero_iteration_steps=int((its == 0).sum()),
            first_zero_iteration_step=(int(np.argmax(its == 0)) + 1
                                       if (its == 0).any() else None),
            iters_of_other_steps=int(solved.sum()),
            median_iters_of_other_steps=(float(np.median(solved))
                                         if len(solved) else None),
            **{f"max_{n}_at_{t}": f"{float(frames[t][n].max()):.3e}"
               for t in HCC_OUTPUTS for n in ("l", "c", "n")})
        _require_launched(counts, HCC_KERNELS, "the HCC driver")
        require(counts["apply_affine_f32"] == 0,
                "the HCC driver runs f64: K3 f32 launched")

        _process_mesh_module(root, os.path.join(d, "HCC_Model.msh"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


# ----------------------------------------------------------------------
# phase 15: the PIHNA driver with AMR, and the native Gmsh parser
# ----------------------------------------------------------------------
# two adaptations, at steps 10 and 20 of 30: only the second can
# coarsen, and the 1to8 run's second mesh is the largest K1-K4 shape of
# the script; the depth is what the script's time limit leaves (PERF.md
# §4 lists each cut)
AMR_N, AMR_STEPS, AMR_EVERY, AMR_PASSES = 28, 30, 10, 2
AMR_OUTPUTS = tuple(range(0, AMR_STEPS + 1, 10))
# the resume run: AMR at step 4, a checkpoint at step 6 (12^3 with brain
# bounds: its refined nodes are exact in the Gmsh writer's 6 digits)
AMR_RESUME_N, AMR_RESUME_STEPS, AMR_RESUME_AT, AMR_RESUME_CKPT = 12, 10, 4, 6


def _amr_deck(d, every, passes, strategy, extra=""):
    """The PIHNA case deck with AMR every `every` steps, `passes` times,
    by `strategy`."""
    import os

    path = os.path.join(d, "input.dat")
    text = open(path).read()
    require("refinement_step = 10000" in text
            and "mesh/AMR/max_steps = 1" in text, "PIHNA case deck changed")
    text = text.replace("refinement_step = 10000",
                        f"refinement_step = {every}")
    text = text.replace("mesh/AMR/max_steps = 1",
                        f"mesh/AMR/max_steps = {passes}")
    with open(path, "w") as f:
        f.write(text + f"mesh/AMR/strategy = {strategy}\n" + extra)


def _drive_recorded(d, dev):
    """_drive(-m pihna) recording each run_steps call: (steps, inner
    iterations, residuals, the system, the final state)."""
    from rdcfes_tpu_torch.systems import transient as transient_mod

    calls = []
    run_steps = transient_mod.TransientRDCSystem.run_steps

    def recorded(self, state, n, *a, **kw):
        out = run_steps(self, state, n, *a, **kw)
        calls.append((n, out[1].tolist(), out[2].tolist(), self, out[0]))
        return out

    transient_mod.TransientRDCSystem.run_steps = recorded
    try:
        wall, counts, out = _drive(d, ["-m", "pihna"], dev)
    finally:
        transient_mod.TransientRDCSystem.run_steps = run_steps
    return wall, counts, out, calls


def _parsers(path):
    """The native meshkit parser and the NumPy parser on one file."""
    from rdcfes_tpu_torch.mesh import gmsh
    from rdcfes_tpu_torch.native import read_gmsh_native

    t0 = time.perf_counter()
    a = read_gmsh_native(path)
    t1 = time.perf_counter()
    b = gmsh.read_numpy(path)
    t2 = time.perf_counter()
    for name in ("coords", "connectivity", "subdomain_id", "boundary_faces",
                 "boundary_elem", "boundary_side", "boundary_id"):
        require(np.array_equal(getattr(a, name), getattr(b, name)),
                f"the parsers' {name} differ")
    say("15a parsers", n_nodes=a.n_nodes, n_elems=a.n_elems,
        native_s=f"{t1 - t0:.4f}", numpy_s=f"{t2 - t1:.4f}",
        equal_arrays=True)


def _amr_run(root, strategy, dev, also):
    """`-m pihna` with AMR at steps 10 and 20 by `strategy`, its checks,
    and K1-K4 at the shapes of the mesh after the second adaptation."""
    import os
    import re

    from rdcfes_tpu_torch import cases

    d = cases.make_pihna_case(os.path.join(root, strategy), n=AMR_N,
                              n_steps=AMR_STEPS)
    if strategy == "bisection":
        _parsers(os.path.join(d, "Brain_Model.msh"))
    _amr_deck(d, AMR_EVERY, AMR_PASSES, strategy)
    wall, counts, out, calls = _drive_recorded(d, dev)
    amr = re.findall(r"AMR step (\d+): adapted to (\d+) elements"
                     r"(?: \((\d+) hanging nodes\))?", out)
    require(len(amr) == AMR_PASSES,
            f"AMR {strategy}: {len(amr)} adaptations, not {AMR_PASSES}")
    require(out.count(" ==== Step") == AMR_STEPS, f"AMR {strategy}: banners")
    res_dir = os.path.join(d, "PIHNA_simulation")
    _transient_artifacts(res_dir, "Brain_Model", AMR_OUTPUTS,
                         ("n", "c", "h", "v", "a"))
    with open(os.path.join(res_dir,
                           f"Brain_Model-{AMR_OUTPUTS[-1]}.vtu")) as f:
        cells = int(re.search(r'NumberOfCells="(\d+)"', f.read()).group(1))
    _, _, _, s, state = calls[-1]
    require(cells == s.mesh.n_elems == int(amr[-1][1]),
            f"AMR {strategy}: the last frame has {cells} cells")
    ress = [r for c in calls for r in c[2]]
    require(sum(c[0] for c in calls) == AMR_STEPS, "AMR: steps")
    require(max(ress) <= s.rtol, f"AMR {strategy}: a residual "
            f"{max(ress):.3e} > rtol {s.rtol}")
    totals = _perf_totals(out)
    before = AMR_N ** 3 * 6
    say(f"15 amr {strategy}", seconds=f"{wall:.4f}",
        amr_s=f"{totals.get('amr', 0.0):.4f}",
        **{k.replace(" ", "_") + "_s": f"{totals.get(k, 0.0):.4f}"
           for k in DRV_PHASES},
        steps=AMR_STEPS, elements_before=before,
        **{f"elements_after_step_{t}": e for t, e, _ in amr},
        **({f"hanging_after_step_{t}": h for t, _, h in amr}
           if strategy == "1to8" else {}),
        final_nodes=s.mesh.n_nodes)
    say(f"15 amr {strategy} solves",
        **{f"call{i}": f"{n}steps/{sum(its)}iters/{ress_[-1]:.3e}"
           for i, (n, its, ress_, _, _) in enumerate(calls)})
    say(f"15 amr {strategy} launches",
        **{k: counts[k] for k in DRV_TRANSIENT + ("apply_affine_f32",)})
    _require_launched(counts, DRV_TRANSIENT, f"the AMR ({strategy}) driver")
    require(counts["apply_affine_f32"] == 0,
            "the PIHNA driver runs f64: K3 f32 launched")
    params = _pihna_deck_params(d)
    u = state["u"].T.contiguous()
    kcases = {k: c for k, c in affine_cases(
        f"15 amr {strategy}", s, u,
        lambda uq, gq: pihna_blocks(uq, gq, {}, params)).items()
        if k.partition("@")[0] in DRV_TRANSIENT}
    run_cases("15 amr kernel", kcases, {}, also, label=f"amr {strategy}")
    if strategy == "1to8":
        c = s.cons
        require(c is not None and c.n_hanging == int(amr[-1][2]),
                "AMR 1to8: the system's constraints")
        uu = state["u"]
        err = float((uu[c.hang] - 0.5 * (uu[c.a] + uu[c.b])).abs().max()
                    / uu.abs().max())
        say("15 amr 1to8 constraint", hanging=c.n_hanging,
            max_rel_err=f"{err:.3e}", bar=1e-12)
        require(err <= 1e-12, f"u_h != (u_a + u_b) / 2: {err:.3e}")
    return counts


def _pihna_deck_params(d):
    import os

    from rdcfes_tpu_torch.drivers import pihna as dpihna
    from rdcfes_tpu_torch.io.getpot import Deck

    return dpihna.load_params(Deck(os.path.join(d, "input.dat")))


def _amr_resume(root, dev):
    """1to8 AMR at step 4, a checkpoint at step 6; the resumed run's final
    state against the uninterrupted run's."""
    import os
    import shutil

    from rdcfes_tpu_torch import cases

    d = cases.make_pihna_case(os.path.join(root, "resume"), n=AMR_RESUME_N,
                              n_steps=AMR_RESUME_STEPS)
    _amr_deck(d, AMR_RESUME_AT, 1, "1to8",
              f"checkpoint/step = {AMR_RESUME_CKPT}\n")
    wall, _, out, calls = _drive_recorded(d, dev)
    full = calls[-1][4]["u"]
    ck = os.path.join(root, "checkpoint")
    os.makedirs(ck)
    for name in ("checkpoint.npz", "checkpoint_mesh.msh"):
        shutil.copy(os.path.join(d, "PIHNA_simulation", name), ck)
    with open(os.path.join(d, "input.dat"), "a") as f:
        f.write(f"checkpoint/resume = {ck}/checkpoint.npz\n")
    wall2, _, out2, calls2 = _drive_recorded(d, dev)
    require("resumed on AMR mesh" in out2, "AMR resume: not on the AMR mesh")
    resumed = calls2[-1][4]["u"]
    require(resumed.shape == full.shape, "AMR resume: shapes differ")
    err = float((resumed - full).abs().max() / full.abs().max())
    say("15c amr resume", seconds=f"{wall:.4f}", resume_seconds=f"{wall2:.4f}",
        n_nodes=full.shape[0], hanging=calls[-1][3].cons.n_hanging,
        resumed_steps=sum(c[0] for c in calls2), max_rel_err=f"{err:.3e}",
        bar=1e-12)
    require(err <= 1e-12, f"AMR resume: {err:.3e} from the uninterrupted run")


def phase_amr(dev, also):
    """The native parser against the NumPy one (a); the PIHNA driver with
    AMR by bisection and by 1to8 at full width (b); checkpoint and resume
    across AMR (c)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="rdcfes_amr_")
    try:
        paths = {f"amr {st}": _amr_run(root, st, dev, also)
                 for st in ("bisection", "1to8")}
        _amr_resume(root, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


# phase 16: mixed (HEX8 + PYRAMID5 + TET4, and PRISM6) and TET10 meshes
MIX_N = 28  # box_mixed_mesh(28, 28, 28): 25,173 nodes; 10,976 HEX8,
#             3,920 PYRAMID5 and 62,720 TET4
# mixed PIHNA 40 steps (120 until the script's depth was cut for phase
# 18)
MIX_PIHNA_STEPS, MIX_ADPM_STEPS, PRISM_STEPS = 40, 40, 20
# the TET10 PIHNA case runs away from step ~23 in f64, as the reference's
# does (at n = 20: `python -m tests.test_torch_tet10 20 22`, on a machine
# with JAX): the driver run takes the steps before it, 16b's trajectory 30
T10_STEPS, T10_TRAJ_STEPS, T10_CHECK_AT = 20, 30, (1, 10, 20)
MIX_INSTANCES = tuple(f"{v}:{e}" for v in ("gather_interp_generic_f64",
                                           "apply_generic_f32",
                                           "apply_generic_f64")
                      for e in ("hex8", "pyramid5"))
T10_INSTANCES = ("gather_interp_generic_f64:tet10", "apply_generic_f64:tet10")
PRISM_INSTANCES = tuple(f"{v}:prism6" for v in ("gather_interp_generic_f64",
                                                "apply_generic_f32",
                                                "apply_generic_f64"))
MIX_PATH = DRV_TRANSIENT + ("apply_affine_f32", "restrict_f32") \
    + MIX_INSTANCES


def _prism_conn(hex_conn):
    """Each HEX8 cell split into two PRISM6 along its (v0, v2, v6, v4)
    diagonal plane, bottom triangles counterclockwise seen from above:
    conforming across cells, and each of the cell's four side faces stays
    one prism's quad."""
    return np.concatenate([hex_conn[:, [0, 1, 2, 4, 5, 6]],
                           hex_conn[:, [0, 2, 3, 4, 6, 7]]])


def _block_shim(blk, g, n_vars, n_nodes):
    """What generic_cases and affine_cases read of a system, for one
    ElementBlock with its geometry g (node_gather: the block's own)."""
    from types import SimpleNamespace as NS

    from rdcfes_tpu_torch.fem.assembly import block_node_gather

    ng = block_node_gather([blk.conn_T.T.cpu().numpy()], n_nodes)
    return NS(n_vars=n_vars, geom=g, conn_T=blk.conn_T, phi=blk.phi,
              node_gather=torch.as_tensor(ng, device=blk.conn_T.device),
              mesh=NS(n_elems=blk.conn_T.shape[1], n_nodes=n_nodes))


def _restrict_concat(label, flat, ng, conns):
    """K4 on one table over several blocks (flat (W, sum K_b E_b)),
    beside index_add_ over the blocks' concatenated connectivities."""
    W, dt = flat.shape[0], flat.dtype
    N = ng.shape[1]
    conn_flat = torch.cat([c.reshape(-1) for c in conns]).long()
    live = int((ng < flat.shape[1]).sum())
    return {f"restrict_{'f32' if dt == F32 else 'f64'}@{label}": dict(
        kern=lambda: K.restrict(flat, ng),
        plain=lambda: K.restrict_plain(flat, ng),
        tol=1e-5 if dt == F32 else 1e-13,
        library=lambda: torch.zeros((W, N), dtype=dt, device=flat.device
                                    ).index_add_(1, conn_flat, flat),
        n_bytes=restrict_bytes(flat, ng, N), flops=float(W * live),
        dtype=dt)}


def _say_bounds(rows, names):
    for name in names:
        r = rows[name]
        say("16 bound", name=name, ms=f"{r['ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}",
            pct_of_bound=f"{100.0 * r['bound_ms'] / r['ms']:.1f}",
            plain_ms=f"{r['plain_ms']:.4f}")


def _mixed_block_cases(dev, mesh, s, params, u, results, also):
    """K8 and K6 at each generic block of the MixedTransientRDCSystem s,
    K1-K3 at its TET4 block, K4 at its one table over every block."""
    from rdcfes_tpu_torch.fem.weakform import block_diag, block_diag_affine

    blocks_of = lambda uq, gq: pihna_blocks(uq, gq, {}, params)
    V, N = s.n_vars, mesh.n_nodes
    flats32, flats64, diags = [], [], []
    for blk, g in zip(s.blocks, s.geoms):
        shim = _block_shim(blk, g, V, N)
        elem = blk.elem_type.lower()
        if blk.affine:
            cases = {f"{k}@mixed tet4": c
                     for k, c in affine_cases("16 mixed tet4", shim, u,
                                              blocks_of).items()
                     if not k.startswith("restrict")}
            u_qp, gx1 = K.gather_interp_affine_plain(u, blk.conn_T, blk.phi,
                                                     g.dphi)
            gq = gx1[:, None].expand(V, u_qp.shape[1], 3, gx1.shape[-1])
        else:
            cases = {}
            for k, c in generic_cases(f"mixed {elem}", shim, u, blocks_of,
                                      f32_tol=1e-6,
                                      with_restrict=False).items():
                # the HEX8 instance's main row is phase 9's
                cases[f"{k}@mixed hex8" if elem == "hex8"
                      else f"{k}:{elem}"] = c
            u_qp, gq = K.gather_interp_generic_plain(u, blk.conn_T, blk.phi,
                                                     g.dphi)
        run_cases("16 mixed kernel", cases, results, also)
        wfb = blocks_of(u_qp, gq)
        st32 = blk.stacks(wfb.cast(F32), g.JxW32)
        flats32.append(blk.apply(K.PLAIN_OPS, u.to(F32), st32, g.JxW32,
                                 g.dphi32).reshape(V, -1))
        flats64.append(blk.rhs(K.PLAIN_OPS, wfb, g).reshape(V, -1))
        diags.append((block_diag_affine(wfb, blk.phi, g.JxW, g.dphi[None])
                      if blk.affine else block_diag(wfb, blk.phi, g.JxW,
                                                    g.dphi)
                      ).reshape(V * V, -1))
        del wfb, st32
    conns = [blk.conn_T for blk in s.blocks]
    cases = {}
    cases.update(_restrict_concat("mixed", torch.cat(flats32, 1),
                                  s.node_gather, conns))
    cases.update(_restrict_concat("mixed", torch.cat(flats64, 1),
                                  s.node_gather, conns))
    cases.update({k + " diagonal": c for k, c in _restrict_concat(
        "mixed", torch.cat(diags, 1), s.node_gather, conns).items()})
    run_cases("16 mixed kernel", cases, results, also)
    say("16 mixed shapes", N=N, C=s.node_gather.shape[0],
        **{b.elem_type: b.conn_T.shape[1] for b in s.blocks})


def _prism_cases(dev, results, also):
    """K8 and K6 at PRISM6 on box_hex_mesh(28)'s cells split in two
    (43,904 elements), with PIHNA's bench blocks."""
    from rdcfes_tpu_torch.systems.transient import ElementBlock

    hexm = box_hex_mesh(MIX_N, MIX_N, MIX_N, bounds=BRAIN)
    _, params, u0 = bench_case(hexm)
    blk = ElementBlock("PRISM6", _prism_conn(hexm.connectivity), dev)
    g = blk.geometry(torch.as_tensor(hexm.coords, dtype=F64, device=dev))
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    cases = {f"{k}:prism6": c for k, c in generic_cases(
        "prism6", _block_shim(blk, g, 5, hexm.n_nodes), u,
        lambda uq, gq: pihna_blocks(uq, gq, {}, params), f32_tol=1e-6,
        with_restrict=False).items()}
    run_cases("16 prism kernel", cases, results, also)
    say("16 prism shapes", E=blk.conn_T.shape[1], N=hexm.n_nodes)


def _tet10_cases(dev, results, also):
    """K8 and K6 at TET10 on tet4_to_tet10(box_tet_mesh(28)) (131,712
    elements), K4 at its table, with PIHNA's bench blocks."""
    from rdcfes_tpu_torch.mesh import tet4_to_tet10

    mesh = tet4_to_tet10(box_tet_mesh(MIX_N, MIX_N, MIX_N, bounds=BRAIN))
    _, params, u0 = bench_case(mesh)
    s = make_system(mesh, dev)
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    blocks_of = lambda uq, gq: pihna_blocks(uq, gq, {}, params)
    cases = {f"{k}:tet10": c for k, c in generic_cases(
        "tet10", s, u, blocks_of, f32_tol=1e-6,
        with_restrict=False).items()}
    run_cases("16 tet10 kernel", cases, results, also)
    # ADPM's V = 3: the instances ptxas spills a few bytes in (f32, V <= 3)
    pa, ua0, tracts = adpm_case(mesh, 50.0)
    f = adpm_fields(tracts, dev)
    ua = torch.as_tensor(np.ascontiguousarray(ua0.T), dtype=F64, device=dev)
    sa = make_adpm(mesh, dev, 1e-9)
    cases = {f"{k}:tet10@adpm": c for k, c in generic_cases(
        "tet10 adpm", sa, ua, lambda uq, gq: adpm.adpm_blocks(uq, gq, f, pa),
        f32_tol=1e-6, with_restrict=False).items()}
    run_cases("16 tet10 kernel", cases, results, also)
    del sa, f
    blk, g = s.blocks[0], s.geom
    u_qp, gq = K.gather_interp_generic_plain(u, blk.conn_T, blk.phi, g.dphi)
    wfb = blocks_of(u_qp, gq)
    del u_qp, gq
    V = s.n_vars
    flat32 = blk.apply(K.PLAIN_OPS, u.to(F32),
                       blk.stacks(wfb.cast(F32), g.JxW32), g.JxW32,
                       g.dphi32).reshape(V, -1)
    flat64 = blk.rhs(K.PLAIN_OPS, wfb, g).reshape(V, -1)
    cases = {}
    cases.update(_restrict_concat("tet10", flat32, s.node_gather,
                                  [blk.conn_T]))
    cases.update(_restrict_concat("tet10", flat64, s.node_gather,
                                  [blk.conn_T]))
    run_cases("16 tet10 kernel", cases, results, also)
    say("16 tet10 shapes", E=mesh.n_elems, N=mesh.n_nodes,
        C=s.node_gather.shape[0])


def _mixed_paths(dev, mesh):
    """3 MixedTransientRDCSystem steps in f64 at rtol 1e-14 through the
    kernels and through the plain versions, each from the kernel path's
    state."""
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    _, params, u0 = bench_case(mesh)
    a, b = (MixedTransientRDCSystem(mesh, 5, pihna_blocks, rtol=1e-14,
                                    device=dev, ops=ops)
            for ops in (K.KERNEL_OPS, K.PLAIN_OPS))
    sa = a.initial_state(u0)
    worst, iters = 0.0, []
    for _ in range(3):
        sb, _, rb = b.step(sa, params=params)
        sa, ia, ra = a.step(sa, params=params)
        iters.append(int(ia))
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
        require(max(float(ra), float(rb)) <= 1e-14,
                f"mixed paths: residuals {float(ra):.3e}, {float(rb):.3e}")
    say("16b paths", mesh=f"box_mixed_mesh({MIX_N})", steps=3, rtol=1e-14,
        precision="f64", iters=iters, worst_rel_l2=f"{worst:.3e}",
        bar=1e-10)
    require(worst <= 1e-10, f"mixed kernel vs plain path: {worst:.3e}")


def _tet10_trajectory(dev, d):
    """The TET10 PIHNA case (its mesh and deck, the driver's f64 BiCGStab
    at rtol 3e-11) stepped through the kernels until a solve fails or
    T10_TRAJ_STEPS, each step's iterations, residual and largest v
    printed; at the steps of T10_CHECK_AT the plain versions take the
    same step from the same state, relative L2 within 1e-10.  Every step
    before the first failed solve converges."""
    import os

    from rdcfes_tpu_torch.mesh import gmsh

    mesh = gmsh.read(os.path.join(d, "Brain_Model.msh"))
    params = _pihna_deck_params(d)
    u0 = np.loadtxt(os.path.join(d, "Brain_Model_Initial_Nodal_Field.dat"))
    a, b = (TransientRDCSystem(mesh, 5, pihna_blocks, rtol=3e-11,
                               device=dev, ops=ops)
            for ops in (K.KERNEL_OPS, K.PLAIN_OPS))
    st, rows, worst, failed = a.initial_state(u0), [], 0.0, None
    for k in range(1, T10_TRAJ_STEPS + 1):
        if k in T10_CHECK_AT:
            sb, _, _ = b.step(st, params=params)
        st, it, res = a.step(st, params=params)
        it, res = int(it), float(res)
        rows.append(f"{k}:{it}:{res:.2e}:{float(st['u'][:, 3].max()):.3e}")
        if k in T10_CHECK_AT:
            worst = max(worst, rel_l2(st["u"], sb["u"]))
        if not (res <= a.rtol) or it >= a.maxiter:
            failed = k
            break
    say("16b tet10 steps", mesh=f"tet4_to_tet10(box_tet_mesh({MIX_N}))",
        precision="f64", rtol=a.rtol, step_iters_residual_vmax=" ".join(rows))
    say("16b tet10 paths", checked_at=list(T10_CHECK_AT),
        worst_rel_l2=f"{worst:.3e}", bar=1e-10,
        first_failed_solve=failed if failed else "none")
    require(worst <= 1e-10, f"TET10 kernel vs plain path: {worst:.3e}")
    require(failed is None or failed > max(T10_CHECK_AT),
            f"TET10: a solve failed at step {failed}, before the checks")


def _drive_mixed(tag, d, argv, dev, steps, species, outputs, res_dir, want,
                 absent=(), phase="16c", base="Brain_Model",
                 csv="output.csv", csv_kind="header"):
    """One driver run through cli.main with every run_steps call
    recorded: the artifacts, the banners, every residual <= rtol, the
    kernels of `want` launched and those of `absent` not.  Returns the
    launch counts, the driver's stdout, the results directory and the
    recorded calls (steps, iterations, residuals, system, state)."""
    import os

    from rdcfes_tpu_torch.systems.transient import TransientRDCSystem

    calls = []
    fn = TransientRDCSystem.run_steps

    def recorded(self, state, n, *a, **kw):
        out = fn(self, state, n, *a, **kw)
        calls.append((n, out[1].tolist(), out[2].tolist(), self, out[0]))
        return out

    TransientRDCSystem.run_steps = recorded
    try:
        wall, counts, out = _drive(d, argv, dev)
    finally:
        TransientRDCSystem.run_steps = fn
    rdir = os.path.join(d, res_dir) if res_dir else os.path.join(d, next(
        e for e in os.listdir(d) if os.path.isdir(os.path.join(d, e))))
    _transient_artifacts(rdir, base, outputs, species, csv=csv,
                         csv_kind=csv_kind)
    require(out.count(" ==== Step") == steps, f"{tag}: banners")
    require(sum(c[0] for c in calls) == steps, f"{tag}: run_steps steps")
    s = calls[-1][3]
    ress = [r for c in calls for r in c[2]]
    its = [i for c in calls for i in c[1]]
    totals = _perf_totals(out)
    say(f"{phase} {tag}", seconds=f"{wall:.4f}",
        **{k.replace(" ", "_") + "_s": f"{totals.get(k, 0.0):.4f}"
           for k in DRV_PHASES},
        steps=steps, solve_steps_per_s=f"{steps / totals['solve']:.4f}",
        inner_iters_total=sum(its), inner_iters_max=max(its),
        last_residual=f"{ress[-1]:.3e}", max_residual=f"{max(ress):.3e}",
        rtol=s.rtol, precision=s.precision, n_nodes=s.mesh.n_nodes,
        n_elems=s.mesh.n_elems, fields="finite, >= 0")
    say(f"{phase} {tag} launches", **{k: counts[k] for k in want + absent})
    require(max(ress) <= s.rtol,
            f"{tag}: a residual {max(ress):.3e} > rtol {s.rtol}")
    _require_launched(counts, want, f"the {tag} driver")
    require(not any(counts[k] for k in absent),
            f"{tag}: launched {[k for k in absent if counts[k]]}")
    return counts, out, rdir, calls


def phase_mixed(dev, also):
    """(a) each K6 and K8 instance of PYRAMID5, PRISM6 and TET10 (and
    HEX8's, and K1-K4, at the mixed mesh's blocks) against its plain
    version at full width; (b) three MixedTransientRDCSystem steps,
    kernels against plain versions; (c) the PIHNA and ADPM drivers on
    the mixed box, the PIHNA driver on a Gmsh file whose hexes are split
    into prisms, and the PIHNA driver on TET10."""
    import os
    import shutil
    import tempfile

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.mesh import MeshBlock, MixedMesh, box_mixed_mesh
    from rdcfes_tpu_torch.mesh import gmsh
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    results = {}
    mesh = box_mixed_mesh(MIX_N, MIX_N, MIX_N, bounds=BRAIN)
    _, params, u0 = bench_case(mesh)
    s = MixedTransientRDCSystem(mesh, 5, pihna_blocks, precision="mixed",
                                device=dev)
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64, device=dev)
    _mixed_block_cases(dev, mesh, s, params, u, results, also)
    del s, u
    _prism_cases(dev, results, also)
    _tet10_cases(dev, results, also)
    _say_bounds(results, [k for k in results if ":" in k])
    _mixed_paths(dev, mesh)

    root = tempfile.mkdtemp(prefix="rdcfes_mixed_")
    paths = {}
    try:
        d = cases.make_pihna_case(os.path.join(root, "pihna"), n=MIX_N,
                                  n_steps=MIX_PIHNA_STEPS, mixed=True)
        paths["mixed pihna"] = _drive_mixed(
            "mixed pihna", d, ["-m", "pihna"], dev, MIX_PIHNA_STEPS,
            ("n", "c", "h", "v", "a"),
            list(range(0, MIX_PIHNA_STEPS + 1, 10)), "PIHNA_simulation",
            MIX_PATH)[0]

        d = cases.make_adpm_case(os.path.join(root, "adpm"), n=MIX_N,
                                 n_steps=MIX_ADPM_STEPS, mixed=True)
        # the taxis-active amplitude, as phase 13's ADPM run
        deck = open(os.path.join(d, "input.dat")).read()
        require(deck.count("0.999999e+3") == 2, "ADPM case deck changed")
        with open(os.path.join(d, "input.dat"), "w") as f:
            f.write(deck.replace("0.999999e+3", "50.0"))
        paths["mixed adpm"] = _drive_mixed(
            "mixed adpm", d, ["-m", "adpm"], dev, MIX_ADPM_STEPS,
            ("PrP", "A_b", "Tau"), list(range(0, MIX_ADPM_STEPS + 1, 20)),
            None, MIX_PATH)[0]

        # the PIHNA case's mesh with its hexes split into prisms, written
        # and read back as a Gmsh file (PRISM6, PYRAMID5, TET4)
        d = cases.make_pihna_case(os.path.join(root, "prism"), n=MIX_N,
                                  n_steps=PRISM_STEPS, mixed=True)
        m = gmsh.read(os.path.join(d, "Brain_Model.msh"))
        hexb = m.blocks[0]
        require(hexb.elem_type == "HEX8", "mixed case: first block")
        pm = MixedMesh(coords=m.coords, blocks=[
            MeshBlock("PRISM6", _prism_conn(hexb.connectivity))]
            + m.blocks[1:])
        gmsh.write(pm, os.path.join(d, "Brain_Model.msh"))
        rng = np.random.default_rng(0)
        structure = np.zeros((pm.n_elems, 2))
        structure[:, 0] = 40.0 + 5.0 * rng.random(pm.n_elems)
        np.savetxt(os.path.join(d, "Brain_Model_Initial_Elemental_Field.dat"),
                   structure)
        paths["prism pihna"] = _drive_mixed(
            "prism pihna", d, ["-m", "pihna"], dev, PRISM_STEPS,
            ("n", "c", "h", "v", "a"), list(range(0, PRISM_STEPS + 1, 10)),
            "PIHNA_simulation",
            DRV_TRANSIENT + ("apply_affine_f32",) + PRISM_INSTANCES
            + tuple(k for k in MIX_INSTANCES
                    if k.endswith("pyramid5")))[0]

        d = cases.make_pihna_case(os.path.join(root, "tet10"), n=MIX_N,
                                  n_steps=T10_STEPS, order=2)
        _tet10_trajectory(dev, d)
        paths["tet10 pihna"] = _drive_mixed(
            "tet10 pihna", d, ["-m", "pihna"], dev, T10_STEPS,
            ("n", "c", "h", "v", "a"), list(range(0, T10_STEPS + 1, 10)),
            "PIHNA_simulation", T10_INSTANCES + ("restrict_f64",),
            absent=("apply_generic_f32:tet10", "apply_affine_f64"))[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return results, paths


# ----------------------------------------------------------------------
# phase 17: PROTEAS and RIPF on mixed and TET10 meshes, their ExodusII
# export, and AMR on mixed and TET10 meshes in the PIHNA driver
# ----------------------------------------------------------------------
P17_PROTEAS_N, P17_PROTEAS_STEPS = 28, 20
# RIPF 30 steps and the mixed AMR run 30 steps with AMR at 10 and 20,
# an output every 10, on make_pihna_case(n=20, mixed=True) (n = 28 until
# phase 24 came): the depth the script's time limit leaves (PERF.md §4);
# the second adaptation refines a MixedMesh that already has hanging
# nodes and is the one that can coarsen.  TET10 AMR at step 5 of 10 (at
# 10 of 20 until phase 24 came), before its runaway (phase 16)
P17_RIPF_N, P17_RIPF_STEPS = 24, 30
RIPF_OUTPUTS = (0, 10, 30)  # the case deck's points up to P17_RIPF_STEPS
P17_MIX_AMR_N = 20
P17_MIX_AMR_STEPS, P17_MIX_AMR_EVERY, P17_MIX_AMR_PASSES = 30, 10, 2
P17_MIX_AMR_OUTPUT = 10
P17_T10_AMR_STEPS, P17_T10_AMR_EVERY = 10, 5
PROTEAS_SPECIES = ("hos", "tum", "nec", "vsc", "oed")
PIHNA_SPECIES = ("n", "c", "h", "v", "a")
T10_ABSENT = ("apply_generic_f32:tet10", "apply_affine_f64")
# process_mesh's answers: the mesh, scale 1, no translation or rotation
P17_EXPORT_ANSWERS = "in.msh\n1\n0\n0\n0\n0\n0\n0\n1\nout\n"
EXODUS_NAMES = {"TET4": "TETRA4", "HEX8": "HEX8", "PRISM6": "WEDGE6",
                "PYRAMID5": "PYRAMID5", "TET10": "TETRA10"}


def _generic_name(variant, elem):
    """The launch-count name of a K6 or K8 instance (HEX8's is the
    variant's own)."""
    return variant if elem == "hex8" else f"{variant}:{elem}"


def _system_cases(phase, tag, s, u, fields, blocks_fn, also, first=None):
    """Every kernel launch of a step of the system `s` (single-type or
    mixed) at its shapes: per block K1-K3 (TET4) or K8 and K6 (the other
    types) with the coefficient blocks that blocks_fn(u_qp, grad_qp, the
    block's fields) builds at the state u (V, N) f64; then K4 over the
    system's one table at the right-hand side's and the block-Jacobi
    diagonal's widths.  The f32 kernels (K3, K6, K4 at the f32 matvec's
    width) only on a mixed-precision system: an f64 one launches none.
    Rows go under "also", labelled `tag`."""
    from rdcfes_tpu_torch.fem.weakform import block_diag, block_diag_affine

    V, N = s.n_vars, s.mesh.n_nodes
    mixed = s.precision == "mixed"
    run = lambda cases: run_cases(
        f"{phase} kernel", {k: c for k, c in cases.items()
                            if mixed or "_f32" not in k}, {}, also,
        first=first)
    flats32, flats64, diags = [], [], []
    for bi, (blk, g) in enumerate(zip(s.blocks, s.geoms)):
        f = s._fields_for_block(bi, fields)
        blocks_of = lambda uq, gq, f=f: blocks_fn(uq, gq, f)
        shim = _block_shim(blk, g, V, N)
        elem = blk.elem_type.lower()
        if blk.affine:
            cases = {f"{k}@{tag}": c for k, c in affine_cases(
                f"{phase} {tag} {elem}", shim, u, blocks_of).items()
                if not k.startswith("restrict")}
            u_qp, gx1 = K.gather_interp_affine_plain(u, blk.conn_T, blk.phi,
                                                     g.dphi)
            gq = gx1[:, None].expand(V, u_qp.shape[1], 3, gx1.shape[-1])
        else:
            cases = {f"{_generic_name(k, elem)}@{tag}": c
                     for k, c in generic_cases(
                         f"{tag} {elem}", shim, u, blocks_of, f32_tol=1e-6,
                         with_restrict=False).items()}
            u_qp, gq = K.gather_interp_generic_plain(u, blk.conn_T, blk.phi,
                                                     g.dphi)
        run(cases)
        wfb = blocks_of(u_qp, gq)
        del u_qp, gq
        if mixed:
            st32 = blk.stacks(wfb.cast(F32), g.JxW32)
            flats32.append(blk.apply(K.PLAIN_OPS, u.to(F32), st32, g.JxW32,
                                     g.dphi32).reshape(V, -1))
        flats64.append(blk.rhs(K.PLAIN_OPS, wfb, g).reshape(V, -1))
        diags.append((block_diag_affine(wfb, blk.phi, g.JxW, g.dphi[None])
                      if blk.affine else block_diag(wfb, blk.phi, g.JxW,
                                                    g.dphi)
                      ).reshape(V * V, -1))
        del wfb
    conns = [blk.conn_T for blk in s.blocks]
    cases = {}
    for flat in ([torch.cat(flats32, 1)] if flats32 else []) + [
            torch.cat(flats64, 1)]:
        cases.update(_restrict_concat(tag, flat, s.node_gather, conns))
    cases.update({k + " diagonal": c for k, c in _restrict_concat(
        tag, torch.cat(diags, 1), s.node_gather, conns).items()})
    run(cases)
    say(f"{phase} shapes", system=tag.replace(" ", "_"), V=V, N=N,
        C=s.node_gather.shape[0], precision=s.precision,
        **{b.elem_type: b.conn_T.shape[1] for b in s.blocks})


def _driver_kernels(phase, tag, d, driver, dev, also, first=None):
    """The kernels of a PROTEAS or RIPF case's system at its shapes and
    live planes (_system_cases), at the case's initial state, with the
    driver's fields: PROTEAS the dose at each block's quadrature points;
    RIPF seeded time derivatives and the day-1 dose through the field
    rebuild, which is also held on each block (K1 on TET4, K8 on the
    others, on its (3, N) nodal stack).  Rows go under "also",
    labelled `tag`."""
    import os

    from rdcfes_tpu_torch.drivers import proteas as dproteas
    from rdcfes_tpu_torch.drivers import ripf as dripf
    from rdcfes_tpu_torch.drivers.common import make_rdc_system
    from rdcfes_tpu_torch.io import dat
    from rdcfes_tpu_torch.io.getpot import Deck
    from rdcfes_tpu_torch.mesh import gmsh
    from rdcfes_tpu_torch.models.proteas import proteas_blocks
    from rdcfes_tpu_torch.models.ripf import ripf_blocks, rt_dose_schedule

    deck = Deck(os.path.join(d, "input.dat"))
    path = lambda key: os.path.join(d, deck(key, ""))
    mesh = gmsh.read(path("input_GMSH"))
    N = mesh.n_nodes
    as_dev = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
    if driver == "proteas":
        u0 = dat.read_rows_tolerant(path("input_nodal"), N, 5)
        aux = dat.read_rows_tolerant(path("input_nodal_aux"), N, 2)
        params = dproteas.load_params(deck)
        s = make_rdc_system(mesh, 5, proteas_blocks, deck, device=dev)
        rtd = dproteas.rtd_at_qp(mesh, aux)
        fields = {"RTD": (tuple(map(as_dev, rtd)) if isinstance(rtd, tuple)
                          else as_dev(rtd))}
        blocks_fn = lambda uq, gq, f: proteas_blocks(uq, gq, f, params)
    else:
        u0 = dat.read_stream(path("input_nodal"), N, 3)
        rt = as_dev(dat.read_stream(path("input_nodal_RT"), N, 2))
        params = dripf.load_params(deck)
        s = make_rdc_system(mesh, 3, ripf_blocks, deck, device=dev)
        rng = np.random.default_rng(13)
        dose = rt_dose_schedule(rt[:, 0], rt[:, 1], 1.0,
                                deck("RT_dose/broad/fractions", 1),
                                deck("RT_dose/focus/fractions", 1))
        nodal = torch.cat([as_dev(0.01 * rng.standard_normal((2, N))),
                           dose[None]])
        fields = dripf.qp_fields(s, nodal)
        for key in ("lambda_RT_r", "omicro_RT_r"):
            fields[key] = params["_fb_" + key] or float(int(dose.max()))
        blocks_fn = lambda uq, gq, f: ripf_blocks(uq, gq, f, params)
        rebuild = {}
        for blk, g in zip(s.blocks, s.geoms):
            Kc, E = blk.conn_T.shape
            Q = g.JxW.shape[0]
            fn = (K.gather_interp_affine if blk.affine
                  else K.gather_interp_generic)
            pl = (K.gather_interp_affine_plain if blk.affine
                  else K.gather_interp_generic_plain)
            out = pl(nodal, blk.conn_T, blk.phi, g.dphi)
            name = ("gather_interp_affine_f64" if blk.affine else
                    _generic_name("gather_interp_generic_f64",
                                  blk.elem_type.lower()))
            rebuild[f"{name}@field rebuild"] = dict(
                kern=lambda fn=fn, b=blk, g=g: fn(nodal, b.conn_T, b.phi,
                                                  g.dphi),
                plain=lambda pl=pl, b=blk, g=g: pl(nodal, b.conn_T, b.phi,
                                                   g.dphi),
                tol=1e-13, n_bytes=nbytes(nodal, blk.conn_T, g.dphi, *out),
                flops=2.0 * 3 * Kc * E * ((Q + 3) if blk.affine
                                          else 4 * Q))
        run_cases(f"{phase} kernel", rebuild, {}, also, label=tag,
                  first=first)
    _system_cases(phase, tag, s, as_dev(np.ascontiguousarray(u0.T)), fields,
                  blocks_fn, also, first)


def _p17_transient(root, driver, kind, dev, also, first):
    """PROTEAS (20 steps, n = 28) or RIPF (30 steps, n = 24) on the
    mixed or the TET10 case: its kernels held first (_driver_kernels),
    then the driver through cli.main (_drive_mixed): the artifacts, every
    residual <= rtol, the kernels of its mesh launched; RIPF's fields
    finite, HU within [-1000, 1000], the field rebuild's K1 / K8 launched
    at least twice a step on each block."""
    import os

    from rdcfes_tpu_torch import cases

    proteas = driver == "proteas"
    n, steps = ((P17_PROTEAS_N, P17_PROTEAS_STEPS) if proteas
                else (P17_RIPF_N, P17_RIPF_STEPS))
    make = cases.make_proteas_case if proteas else cases.make_ripf_case
    kw = {"mixed": True} if kind == "mixed" else {"order": 2}
    d = make(os.path.join(root, f"{driver}_{kind}"), n=n, n_steps=steps,
             **kw)
    tag = f"{kind} {driver}"
    _driver_kernels("17a", tag, d, driver, dev, also, first)
    want, absent = ((MIX_PATH, ()) if kind == "mixed"
                    else (T10_INSTANCES + ("restrict_f64",), T10_ABSENT))
    if proteas:
        counts, _, rdir, _ = _drive_mixed(
            tag, d, ["-m", "proteas", "input=input.dat"], dev, steps,
            PROTEAS_SPECIES, list(range(0, steps + 1, steps // 4)),
            "simulation", want, absent, phase="17c", base="out",
            csv="simulation.csv", csv_kind="empty")
        return counts, os.path.join(d, "Proteas_Model.msh")
    counts, _, rdir, _ = _drive_mixed(
        tag, d, ["-m", "ripf"], dev, steps, ("cc", "fb"),
        list(RIPF_OUTPUTS), None, want, absent, phase="17c",
        base="Lung_Model", csv_kind="rows")
    last = _vtu_arrays(os.path.join(rdir,
                                    f"Lung_Model-{RIPF_OUTPUTS[-1]}.vtu"))
    require(all(np.isfinite(v).all() for v in last.values())
            and np.abs(last["HU"]).max() <= 1000.0,
            f"{tag}: a field not finite or HU outside [-1000, 1000]")
    rebuild = (("gather_interp_affine_f64", "gather_interp_generic_f64",
                "gather_interp_generic_f64:pyramid5") if kind == "mixed"
               else ("gather_interp_generic_f64:tet10",))
    for k in rebuild:
        require(counts[k] >= 2 * steps,
                f"{tag}: the field rebuild did not launch {k}")
    return counts, None


def _p17_export(root, msh, kind):
    """`-u process_mesh` in process on a case's Gmsh file (scale 1, no
    translation or rotation): the ExodusII file read back with
    scipy.io.netcdf_file, one block per element type of the mesh, their
    element total and the node count the mesh's."""
    import contextlib
    import io
    import os
    import shutil
    import sys

    from scipy.io import netcdf_file

    from rdcfes_tpu_torch.drivers import process_mesh
    from rdcfes_tpu_torch.mesh import gmsh

    d = os.path.join(root, f"export_{kind}")
    os.makedirs(d)
    shutil.copy(msh, os.path.join(d, "in.msh"))
    mesh = gmsh.read(msh)
    cwd, stdin = os.getcwd(), sys.stdin
    out, err = io.StringIO(), io.StringIO()
    os.chdir(d)
    sys.stdin = io.StringIO(P17_EXPORT_ANSWERS)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            process_mesh.run()
        wall = time.perf_counter() - t0
    finally:
        sys.stdin = stdin
        os.chdir(cwd)
    require("NOTE" not in err.getvalue(),
            f"process_mesh ({kind}): {err.getvalue()[-500:]}")
    with netcdf_file(os.path.join(d, "out.ex2"), "r", mmap=False) as f:
        nb = f.dimensions["num_el_blk"]
        types = [f.variables[f"connect{i}"].elem_type.decode()
                 for i in range(1, nb + 1)]
        total = sum(f.dimensions[f"num_el_in_blk{i}"]
                    for i in range(1, nb + 1))
        nodes = f.dimensions["num_nodes"]
    blocks = mesh.blocks if mesh.elem_type == "MIXED" else [mesh]
    say("17c export", mesh=kind, seconds=f"{wall:.4f}", blocks=nb,
        types=",".join(types), elements=total, nodes=nodes,
        ex2_bytes=os.path.getsize(os.path.join(d, "out.ex2")))
    require(types == [EXODUS_NAMES[b.elem_type] for b in blocks]
            and total == mesh.n_elems and nodes == mesh.n_nodes,
            f"process_mesh ({kind}): the ExodusII file does not hold the "
            "mesh")


def _p17_amr(root, kind, dev, also, first):
    """`-m pihna` with AMR: on the mixed case at n = 20 (30 steps, the
    TET4 block refined 1:8 with hanging nodes at steps 10 and 20) or on
    the TET10 case at n = 28 (10 steps, one skeleton bisection at step
    5).  The run's checks
    (_drive_mixed), the elements and hanging nodes after each adaptation,
    the mesh of the last frame; then the kernels at the shapes of the
    mesh after the first adaptation, with the state at the end of the
    first segment on it; on the mixed mesh u_h = (u_a + u_b) / 2 within
    1e-12 at the end of the run.  Returns the launches and that system
    and state."""
    import os
    import re

    from rdcfes_tpu_torch import cases

    if kind == "mixed":
        steps, every, passes = (P17_MIX_AMR_STEPS, P17_MIX_AMR_EVERY,
                                P17_MIX_AMR_PASSES)
        d = cases.make_pihna_case(os.path.join(root, "amr_mixed"),
                                  n=P17_MIX_AMR_N, n_steps=steps,
                                  mixed=True)
        _amr_deck(d, every, passes, "1to8")
        path = os.path.join(d, "input.dat")
        text = open(path).read()
        require("output_step = 10\n" in text, "PIHNA case deck changed")
        with open(path, "w") as f:
            f.write(text.replace("output_step = 10\n",
                                 f"output_step = {P17_MIX_AMR_OUTPUT}\n"))
        want, absent, every_out = MIX_PATH, (), P17_MIX_AMR_OUTPUT
    else:
        steps, every, passes = P17_T10_AMR_STEPS, P17_T10_AMR_EVERY, 1
        d = cases.make_pihna_case(os.path.join(root, "amr_tet10"), n=MIX_N,
                                  n_steps=steps, order=2)
        _amr_deck(d, every, passes, "bisection")
        want, absent = T10_INSTANCES + ("restrict_f64",), T10_ABSENT
        every_out = 10  # the case deck's output_step
    tag = f"{kind} pihna amr"
    outputs = list(range(0, steps + 1, every_out))
    counts, out, rdir, calls = _drive_mixed(
        tag, d, ["-m", "pihna"], dev, steps, PIHNA_SPECIES, outputs,
        "PIHNA_simulation", want, absent, phase="17c")
    elements_before = int(re.search(r"n_elems=(\d+)", out).group(1))
    amr = re.findall(r"AMR step (\d+): adapted to (\d+) elements"
                     r"(?: \((\d+) hanging nodes\))?", out)
    require(len(amr) == passes,
            f"{tag}: {len(amr)} adaptations, not {passes}")
    say(f"17c {tag} adaptations", elements_before=elements_before,
        **{f"elements_after_step_{t}": e for t, e, _ in amr},
        **({f"hanging_after_step_{t}": h for t, _, h in amr}
           if kind == "mixed" else {}),
        amr_s=f"{_perf_totals(out).get('amr', 0.0):.4f}")
    with open(os.path.join(rdir, f"Brain_Model-{outputs[-1]}.vtu")) as f:
        cells = int(re.search(r'NumberOfCells="(\d+)"', f.read()).group(1))
    s_last, st_last = calls[-1][3], calls[-1][4]
    require(cells == s_last.mesh.n_elems == int(amr[-1][1]),
            f"{tag}: the last frame has {cells} cells")
    if kind == "mixed":
        c = s_last.cons
        require(c is not None and c.n_hanging == int(amr[-1][2]),
                f"{tag}: the system's constraints")
        uu = st_last["u"]
        err = float((uu[c.hang] - 0.5 * (uu[c.a] + uu[c.b])).abs().max()
                    / uu.abs().max())
        say(f"17c {tag} constraint", hanging=c.n_hanging,
            max_rel_err=f"{err:.3e}", bar=1e-12)
        require(err <= 1e-12, f"u_h != (u_a + u_b) / 2: {err:.3e}")
    # the first segment on the adapted mesh: its system and final state
    i = next(j for j, c in enumerate(calls)
             if c[3].mesh.n_elems != elements_before)
    s, st = calls[i][3], calls[i][4]
    params = _pihna_deck_params(d)
    _system_cases("17a", f"{kind} amr", s, st["u"].T.contiguous(), {},
                  lambda uq, gq, f: pihna_blocks(uq, gq, f, params), also,
                  first)
    return counts, s, st, params


def _p17_constrained_paths(dev, s, state, params):
    """3 f64 steps of the constrained MixedTransientRDCSystem on the mesh
    after the first adaptation, at rtol 1e-13, through the kernels and
    through the plain versions, each from the kernel path's state; the
    first from the run's state with every master value scaled by a
    seeded factor in [1, 1.05) (the hanging values their masters' mean),
    so that the solves iterate; per-step relative L2 within 1e-10."""
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    c = s.cons
    rows = torch.stack([c.hang, c.a, c.b], 1).cpu().numpy()
    a, b = (MixedTransientRDCSystem(s.mesh, 5, pihna_blocks,
                                    precision="f64", rtol=1e-13,
                                    constraints=rows, device=dev, ops=ops)
            for ops in (K.KERNEL_OPS, K.PLAIN_OPS))
    rng = np.random.default_rng(17)
    u = state["u"] * torch.as_tensor(
        1.0 + 0.05 * rng.random(tuple(state["u"].shape)), device=dev)
    u = c.c_apply(u.T.contiguous()).T
    sa = {"u": u, "u_old": state["u"], "u_older": state["u_old"],
          "u_raw": u}
    worst, iters = 0.0, []
    for _ in range(3):
        sb, _, rb = b.step(sa, params=params)
        sa, ia, ra = a.step(sa, params=params)
        iters.append(int(ia))
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
        require(max(float(ra), float(rb)) <= 1e-13,
                f"17b: residuals {float(ra):.3e}, {float(rb):.3e}")
    say("17b constrained paths", n_nodes=s.mesh.n_nodes,
        n_elems=s.mesh.n_elems, hanging=c.n_hanging, steps=3, rtol=1e-13,
        precision="f64", iters=iters, worst_rel_l2=f"{worst:.3e}",
        bar=1e-10)
    require(worst <= 1e-10,
            f"constrained mixed kernel vs plain path: {worst:.3e}")


def phase_mixed_drivers(dev, also):
    """(a) every kernel the new systems launch against its plain version
    at their shapes, (b) three constrained mixed f64 steps, kernels
    against plain versions, (c) PROTEAS and RIPF on the mixed and the
    TET10 cases, process_mesh exporting both meshes to ExodusII, and the
    PIHNA driver with AMR on the mixed and the TET10 case."""
    import shutil
    import tempfile

    first, paths = {}, {}
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rdcfes_p17_")
    try:
        for kind in ("mixed", "tet10"):
            for driver in ("proteas", "ripf"):
                counts, msh = _p17_transient(root, driver, kind, dev, also,
                                             first)
                paths[f"{kind} {driver}"] = counts
                if msh:
                    _p17_export(root, msh, kind)
        counts, s, st, params = _p17_amr(root, "mixed", dev, also, first)
        paths["mixed pihna amr"] = counts
        _p17_constrained_paths(dev, s, st, params)
        del s, st
        paths["tet10 pihna amr"] = _p17_amr(root, "tet10", dev, also,
                                            first)[0]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("17 done", seconds=f"{time.perf_counter() - t0:.4f}")
    return first, paths


# ----------------------------------------------------------------------
# phase 18: the solid on mixed and TET10 meshes, its constrained Newton
# and remeshing, and HCC on mixed meshes with its remeshing
# ----------------------------------------------------------------------
# box_mixed_mesh(48): 322,560 TET4 + 55,296 HEX8 + 11,520 PYRAMID5,
# 119,953 nodes; tet4_to_tet10(box_tet_mesh(24)): 82,944 TET10, 117,649
# nodes: the solid at the HEX8 bench's node count
P18_MIX_N, P18_T10_N = 48, 24
# 18c's mixed `-s` remeshing run on box_mixed_mesh(32) (48 until phase 23
# came: the depth the script's time limit leaves, PERF.md §4)
P18_MIX_RUN_N = 32
P18_TET_N, P18_HEX_N = 28, 24
P18_CONS_N, P18_RESUME_N = 28, 12
# 10 HCC steps remeshed at step 5: the depth the script's time limit
# leaves (PERF.md §4)
P18_HCC_N, P18_HCC_STEPS, P18_HCC_LOADING, P18_HCC_REMESH = 28, 10, 2, 5
# the solid's CLI runs: the bench deck of phase 13, two load steps, one
# remeshing after the first (f32 tangent and mixed Krylov, the card's)
P18_SOLID_DECK = DRV_SOLID_DECK + ("remeshing_step = 1\n"
                                   "mesh/AMR/max_steps = 1\n")
P18_SOLID_WANT = ("restrict_f32", "restrict_f64", "ell_matvec_f32",
                  "ell_matvec_f64")
P18_HCC_TET_WANT = P18_SOLID_WANT + DRV_TRANSIENT
P18_HCC_MIX_WANT = P18_SOLID_WANT + (
    "gather_interp_affine_f64", "rhs_affine_f64", "apply_affine_f32",
    "apply_affine_f64", "gather_interp_generic_f64",
    "gather_interp_generic_f64:pyramid5", "apply_generic_f32",
    "apply_generic_f32:pyramid5", "apply_generic_f64",
    "apply_generic_f64:pyramid5")


def _p18_mesh(kind, n):
    from rdcfes_tpu_torch.mesh import box_mixed_mesh, tet4_to_tet10

    if kind == "mixed":
        return box_mixed_mesh(n, n, n)
    if kind == "tet10":
        return tet4_to_tet10(box_tet_mesh(n, n, n))
    return box_tet_mesh(n, n, n) if kind == "tet4" else box_hex_mesh(n, n, n)


def _p18_solid(mesh, dev, opts, tangent_precision, ops=K.KERNEL_OPS,
               constraints=None):
    return SolidSystem(mesh, materials=SOLID_MATERIALS, bcs=SOLID_BCS,
                       penalty=1.0e6, newton=opts,
                       tangent_precision=tangent_precision,
                       constraints=constraints, device=dev, ops=ops)


def _p18_kernels(tag, S, x, pt, also, first):
    """18a: K4 (W = 9 and 3, f32 and f64) and K5 (f32, f64) of solid S at
    positions x against their plain versions, with index_add_ and the
    cuSPARSE CSR mv beside them."""
    cases, shapes, lib_err = solid_cases(S, x, pt, pad=False, residual=True)
    cases = {(k if "@" in k else k + "@tangent").replace("@", f"@{tag} "):
             c for k, c in cases.items()}
    say("18a shapes", system=tag.replace(" ", "_"), shapes=shapes.replace(
        " ", ","), library_spmv_max_abs_diff=f"{lib_err:.3e}")
    run_cases("18a kernel", cases, {}, also, first=first)
    del cases


def _p18_paths(tag, mesh, dev, pt=SOLID_PT, constraints=None):
    """18b: one exact-f64 load step through the kernels and through the
    plain versions from the rest positions; the displacements within
    1e-8 of the largest; with constraints every hanging node on its
    masters' midpoint within 1e-12 in both."""
    xs = []
    for ops in (K.KERNEL_OPS, K.PLAIN_OPS):
        s = _p18_solid(mesh, dev, SOLID_EXACT_OPTS, "f64", ops, constraints)
        t0 = time.perf_counter()
        r = s.run_solver(s.initial_positions(), pt)
        torch.cuda.synchronize()
        require(r.converged, f"18b {tag}: the load step did not converge")
        xs.append(r.x)
        say("18b path", system=tag.replace(" ", "_"),
            ops="kernels" if ops is K.KERNEL_OPS else "plain",
            seconds=f"{time.perf_counter() - t0:.4f}",
            newton_iters=r.iters, linear_iters=r.linear_iters,
            r_ratio=f"{r.residual_norm / r.initial_residual_norm:.3e}")
        del s
    X0 = torch.as_tensor(mesh.coords, dtype=F64, device=dev)
    scale = float((xs[1] - X0).abs().max())
    err = float((xs[0] - xs[1]).abs().max()) / scale
    hang = 0.0
    if constraints is not None:
        h, a, b = (torch.as_tensor(constraints[:, i], device=dev).long()
                   for i in range(3))
        hang = max(float((x[h] - 0.5 * (x[a] + x[b])).abs().max()
                         / x.abs().max()) for x in xs)
    say("18b paths", system=tag.replace(" ", "_"), n_nodes=mesh.n_nodes,
        n_elems=mesh.n_elems, max_rel_err_displacement=f"{err:.3e}", bar=1e-8,
        hanging=0 if constraints is None else len(constraints),
        hanging_max_rel_err=f"{hang:.3e}", hanging_bar=1e-12)
    require(err <= 1e-8, f"18b {tag}: kernels vs plain {err:.3e}")
    require(hang <= 1e-12, f"18b {tag}: x_h != (x_a + x_b) / 2")


def _p18_adapted_mixed(n):
    """box_mixed_mesh(n) after one constrained adaptation of the TET4
    elements nearest the centre (30%): (mesh, hanging-node rows)."""
    from rdcfes_tpu_torch.mesh import MixedConstrained

    mm = _p18_mesh("mixed", n)
    conn4 = np.concatenate([b.connectivity[:, :4] for b in mm.blocks])
    r = np.linalg.norm(mm.coords[conn4].mean(axis=1)
                       - mm.coords.mean(axis=0), axis=1)
    out = MixedConstrained.from_mesh(mm).refine_and_coarsen(
        r <= np.quantile(r, 0.3), np.zeros(mm.n_elems, bool))
    require(out is not None and len(out.constraints), "18b: no adaptation")
    return out.mesh, out.constraints


def _p18_moving_rdc(dev, mesh, cons):
    """18b: 3 f64 steps of the moving constrained MixedTransientRDCSystem
    (HCC's blocks) at three displaced geometries, through the kernels and
    through the plain versions, each from the kernel path's state;
    per-step relative L2 within 1e-10."""
    from rdcfes_tpu_torch.models.hcc import hcc_blocks
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    a, b = (MixedTransientRDCSystem(mesh, 3, hcc_blocks, precision="f64",
                                    rtol=1e-13, constraints=cons,
                                    moving_mesh=True, device=dev, ops=ops)
            for ops in (K.KERNEL_OPS, K.PLAIN_OPS))
    c = a.cons
    u0 = torch.as_tensor(_hcc_state(mesh.coords / np.ptp(mesh.coords)),
                         dtype=F64, device=dev)
    sa = a.initial_state(c.c_apply(u0.T.contiguous()).T)
    worst, iters = 0.0, []
    for seed in (1, 2, 3):
        x = torch.as_tensor(_moved(mesh.coords, seed, 0.01), dtype=F64,
                            device=dev)
        sb, _, rb = b.step(sa, params=HCC_LIVE, coords=x)
        sa, ia, ra = a.step(sa, params=HCC_LIVE, coords=x)
        iters.append(int(ia))
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
        require(max(float(ra), float(rb)) <= 1e-13,
                f"18b: residuals {float(ra):.3e}, {float(rb):.3e}")
    uu = sa["u"]
    hang = float((uu[c.hang] - 0.5 * (uu[c.a] + uu[c.b])).abs().max()
                 / uu.abs().max())
    say("18b moving constrained rdc", n_nodes=mesh.n_nodes,
        n_elems=mesh.n_elems, hanging=c.n_hanging, steps=3, rtol=1e-13,
        precision="f64", iters=iters, worst_rel_l2=f"{worst:.3e}",
        bar=1e-10, hanging_max_rel_err=f"{hang:.3e}")
    require(worst <= 1e-10, f"18b moving rdc kernel vs plain: {worst:.3e}")
    require(hang <= 1e-12, "18b: u_h != (u_a + u_b) / 2")


def _p18_record(fn):
    """Run fn() with every load step (system, Newton result) and every
    RDC segment (steps, iterations, residuals, system) recorded."""
    from rdcfes_tpu_torch.systems.transient import TransientRDCSystem

    rec = {"newton": [], "rds": []}
    solver, steps = SolidSystem.run_solver, TransientRDCSystem.run_steps

    def rec_solver(self, x, pt):
        r = solver(self, x, pt)
        rec["newton"].append((self, r))
        return r

    def rec_steps(self, state, n, *a, **kw):
        out = steps(self, state, n, *a, **kw)
        rec["rds"].append((n, out[1].tolist(), out[2].tolist(), self))
        return out

    SolidSystem.run_solver = rec_solver
    TransientRDCSystem.run_steps = rec_steps
    try:
        return fn(), rec
    finally:
        SolidSystem.run_solver = solver
        TransientRDCSystem.run_steps = steps


def _p18_cells(path):
    import re

    with open(path) as f:
        return int(re.search(r'NumberOfCells="(\d+)"', f.read()).group(1))


def _p18_remeshed(tag, out, before, system, step):
    """The remeshing line of a driver's stdout against the system built
    after it: (elements after, hanging nodes)."""
    import re

    m = re.search(rf"remeshing step {step}: adapted to (\d+) elements"
                  r"(?: \((\d+) hanging constraints\))?", out)
    require(m is not None, f"18c {tag}: no remeshing at step {step}")
    after, hanging = int(m.group(1)), int(m.group(2) or 0)
    cons = system._newton.cons
    require(after == system.mesh.n_elems > before
            and hanging == (cons.n_hanging if cons is not None else 0),
            f"18c {tag}: the system after remeshing")
    return after, hanging


def _p18_solid_run(root, kind, n, dev, extra="", keep=None):
    """`-s` in process on the `kind` box at n with remeshing at load step
    1: two converged load steps, the remeshed system, the last frame's
    cells, with constraints x_h = (x_a + x_b) / 2 within 1e-12, and the
    launches of K4 and K5.  `keep` (a directory): a copy of the
    checkpoint of load step 1 and its mesh goes there."""
    import os
    import shutil

    from rdcfes_tpu_torch.drivers import solid as dsolid
    from rdcfes_tpu_torch.mesh import gmsh

    tag = f"solid {kind}"
    d = os.path.join(root, f"solid_{kind}_{n}" + ("_ck" if keep else ""))
    os.makedirs(d)
    mesh = _p18_mesh(kind, n)
    gmsh.write(mesh, os.path.join(d, "input.msh"))
    with open(os.path.join(d, "input.dat"), "w") as f:
        f.write(P18_SOLID_DECK + extra)
    save = dsolid.save_checkpoint

    def keep_step_1(path, state, step, *a, **kw):
        save(path, state, step, *a, **kw)
        if step == 1 and keep:
            for name in ("checkpoint.npz", "checkpoint_mesh.msh"):
                shutil.copy(os.path.join(os.path.dirname(path), name), keep)

    dsolid.save_checkpoint = keep_step_1
    try:
        (wall, counts, out), rec = _p18_record(
            lambda: _drive(d, ["-s"], dev))
    finally:
        dsolid.save_checkpoint = save
    newton = [r for _, r in rec["newton"]]
    require(len(newton) == 2 and all(r.converged for r in newton),
            f"{tag}: the load steps")
    system = rec["newton"][-1][0]
    after, hanging = _p18_remeshed(tag, out, mesh.n_elems, system, 1)
    last = os.path.join(d, "simulation", "output4paraview-2.vtu")
    cells = _p18_cells(last)
    require(cells == after, f"{tag}: the last frame has {cells} cells")
    hang = 0.0
    if hanging:
        c, x = system._newton.cons, newton[-1].x
        hang = float((x[c.hang] - 0.5 * (x[c.a] + x[c.b])).abs().max()
                     / x.abs().max())
        require(hang <= 1e-12, f"{tag}: x_h != (x_a + x_b) / 2")
    totals = _perf_totals(out)
    say(f"18c {tag}", seconds=f"{wall:.4f}",
        **{k.replace(" ", "_") + "_s": f"{totals.get(k, 0.0):.4f}"
           for k in DRV_SOLID_PHASES + ("remeshing",)},
        load_steps=2, newton_iters=[int(r.iters) for r in newton],
        linear_iters=[int(r.linear_iters) for r in newton],
        r_ratio=[f"{r.residual_norm / r.initial_residual_norm:.3e}"
                 for r in newton], converged=True,
        elements_before=mesh.n_elems, elements_after=after,
        hanging=hanging, hanging_max_rel_err=f"{hang:.3e}",
        last_frame_cells=cells, n_nodes_after=system.mesh.n_nodes)
    say(f"18c {tag} launches", **{k: counts[k] for k in P18_SOLID_WANT})
    _require_launched(counts, P18_SOLID_WANT, f"the {tag} driver")
    return counts, system, newton[-1].x, last


def _p18_hcc_run(root, kind, dev, extra="", keep=None):
    """`-c hcc` in process on make_hcc_case(n=28, n_steps=10,
    n_loading=2), mixed or TET4, remeshing at step 5: every RDC residual
    <= rtol, both load steps converged, the remeshed systems, the last
    frame's cells, and the launches.  `keep`: a copy of the checkpoint of
    step 5 and its mesh goes there."""
    import os
    import shutil

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.drivers import coupled_hcc as dhcc

    tag = f"hcc {kind}"
    d = cases.make_hcc_case(os.path.join(root, f"hcc_{kind}"), n=P18_HCC_N,
                            n_steps=P18_HCC_STEPS,
                            n_loading=P18_HCC_LOADING,
                            mixed=kind == "mixed")
    with open(os.path.join(d, "input.dat"), "a") as f:
        f.write(f"remeshing_step = {P18_HCC_REMESH}\n" + extra)
    save = dhcc.save_checkpoint

    def keep_step(path, state, step, *a, **kw):
        save(path, state, step, *a, **kw)
        if step == P18_HCC_REMESH and keep:
            for name in ("checkpoint.npz", "checkpoint_mesh.msh"):
                shutil.copy(os.path.join(os.path.dirname(path), name), keep)

    dhcc.save_checkpoint = keep_step
    try:
        (wall, counts, out), rec = _p18_record(
            lambda: _drive(d, ["-c", "hcc"], dev))
    finally:
        dhcc.save_checkpoint = save
    newton = [r for _, r in rec["newton"]]
    require(len(newton) == P18_HCC_LOADING
            and all(r.converged for r in newton), f"{tag}: the load steps")
    ress = [r for c in rec["rds"] for r in c[2]]
    its = [i for c in rec["rds"] for i in c[1]]
    rds = rec["rds"][-1][3]
    require(len(ress) == P18_HCC_STEPS and max(ress) <= rds.rtol,
            f"{tag}: an RDC residual {max(ress):.3e} > rtol {rds.rtol}")
    before = rec["rds"][0][3].mesh.n_elems
    system = rec["newton"][-1][0]
    after, hanging = _p18_remeshed(tag, out, before, system, P18_HCC_REMESH)
    require(rds.mesh.n_elems == after
            and (rds.cons.n_hanging if rds.cons is not None else 0)
            == hanging, f"{tag}: the RDC system after remeshing")
    last = os.path.join(d, "simulation", f"out-{P18_HCC_STEPS}.vtu")
    cells = _p18_cells(last)
    require(cells == after, f"{tag}: the last frame has {cells} cells")
    totals = _perf_totals(out)
    want = P18_HCC_MIX_WANT if kind == "mixed" else P18_HCC_TET_WANT
    say(f"18c {tag}", seconds=f"{wall:.4f}",
        **{k.replace(" ", "_") + "_s": f"{totals.get(k, 0.0):.4f}"
           for k in HCC_PHASES + ("remeshing",)},
        steps=P18_HCC_STEPS, load_steps=P18_HCC_LOADING,
        rds_inner_iters=sum(its), rds_max_residual=f"{max(ress):.3e}",
        rtol=rds.rtol, precision=rds.precision,
        newton_iters=[int(r.iters) for r in newton],
        linear_iters=[int(r.linear_iters) for r in newton], converged=True,
        elements_before=before, elements_after=after, hanging=hanging,
        last_frame_cells=cells, n_nodes_after=rds.mesh.n_nodes)
    say(f"18c {tag} launches", **{k: counts[k] for k in want})
    _require_launched(counts, want, f"the {tag} driver")
    return counts, d, last


def _p18_resume(tag, d, ck_dir, last, argv, dev):
    """18d: the case in a new directory resumed from the checkpoint in
    ck_dir (written after remeshing): the last frame's Float64 arrays
    equal the uninterrupted run's (`last`) within 1e-12 of each array's
    largest value."""
    import os
    import shutil

    d2 = d.rstrip("/") + "_resumed"
    shutil.copytree(d, d2, ignore=shutil.ignore_patterns("simulation"))
    ck = os.path.join(ck_dir, "checkpoint.npz")
    with np.load(ck) as z:
        require(int(z["amr_done"]) == 1 and "constraints" in z.files,
                f"18d {tag}: the checkpoint after remeshing")
        step = int(z["__step"])
    with open(os.path.join(d2, "input.dat"), "a") as f:
        f.write(f"checkpoint/resume = '{ck}'\n")
    wall, _, out = _drive(d2, argv, dev)
    require("resumed on remeshed grid (" in out, f"18d {tag}: not resumed")
    a = _vtu_arrays(os.path.join(d2, "simulation", os.path.basename(last)))
    b = _vtu_arrays(last)
    require(a.keys() == b.keys(), f"18d {tag}: the arrays")
    errs = {k: float(np.abs(a[k] - b[k]).max())
            / max(float(np.abs(b[k]).max()), 1e-300) for k in b}
    worst = max(errs.values())
    say(f"18d {tag} resume", from_step=step, seconds=f"{wall:.4f}",
        arrays=len(b), worst_rel_err=f"{worst:.3e}", bar=1e-12,
        worst_array=max(errs, key=errs.get))
    require(worst <= 1e-12, f"18d {tag}: resumed != uninterrupted")


def phase_solid_ext(dev, also):
    """(a) K4 and K5 at the solid's new shapes against their plain
    versions, (b) load steps and moving constrained RDC steps through the
    kernels and the plain versions, (c) the solid and HCC CLI runs with
    remeshing, (d) their resumes from a checkpoint written after
    remeshing."""
    import os
    import shutil
    import tempfile

    first, paths = {}, {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    for kind, n in (("tet10", P18_T10_N), ("mixed", P18_MIX_N)):
        mesh = _p18_mesh(kind, n)
        S = _p18_solid(mesh, dev, SOLID_EXACT_OPTS, "f64")
        x = S.initial_positions() + torch.as_tensor(
            0.05 / n * rng.standard_normal((mesh.n_nodes, 3)), dtype=F64,
            device=dev)
        _p18_kernels(f"{kind} {n}", S, x, SOLID_PT, also, first)
        del S, x
        torch.cuda.empty_cache()
        _p18_paths(f"{kind} {n}", mesh, dev)
    mesh, cons = _p18_adapted_mixed(P18_CONS_N)
    _p18_paths(f"mixed {P18_CONS_N} adapted", mesh, dev, constraints=cons)
    _p18_moving_rdc(dev, mesh, cons)
    root = tempfile.mkdtemp(prefix="rdcfes_p18_")
    try:
        counts, S, x, _ = _p18_solid_run(root, "mixed", P18_MIX_RUN_N,
                                         dev)
        paths["solid mixed remesh"] = counts
        _p18_kernels(f"mixed {P18_MIX_RUN_N} adapted", S, x, 1.0, also,
                     first)
        del S, x
        torch.cuda.empty_cache()
        for kind, n in (("tet10", P18_T10_N), ("tet4", P18_TET_N),
                        ("hex8", P18_HEX_N)):
            paths[f"solid {kind} remesh"] = _p18_solid_run(root, kind, n,
                                                          dev)[0]
        for kind in ("mixed", "tet4"):
            keep = None
            if kind == "mixed":
                keep = os.path.join(root, "ck_hcc")
                os.makedirs(keep)
            counts, d, last = _p18_hcc_run(
                root, kind, dev,
                f"checkpoint/step = {P18_HCC_REMESH}\n" if keep else "",
                keep)
            paths[f"hcc {kind} remesh"] = counts
            if keep:
                _p18_resume("hcc mixed", d, keep, last, ["-c", "hcc"], dev)
        keep = os.path.join(root, "ck_solid")
        os.makedirs(keep)
        last = _p18_solid_run(root, "mixed", P18_RESUME_N, dev,
                              "checkpoint/step = 1\n", keep)[3]
        _p18_resume("solid mixed", os.path.dirname(os.path.dirname(last)),
                    keep, last, ["-s"], dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("18 done", seconds=f"{time.perf_counter() - t0:.4f}")
    return first, paths


# ----------------------------------------------------------------------
# phase 19: 2D meshes, HEX20 / HEX27 and the dense element-matrix path
# ----------------------------------------------------------------------
# 2D: box_tri_mesh(512, 512) (524,288 TRI3) and box_quad_mesh(512, 512)
# (262,144 QUAD4), 263,169 nodes each; QUAD9 / QUAD8 from
# box_quad_mesh(256, 256) (65,536 elements; 263,169 / 197,633 nodes);
# HEX27 / HEX20 from box_hex_mesh(24, 24, 24) (13,824 elements; 117,649 /
# 60,625 nodes); all in the brain box (the 2D ones in its x-y rectangle)
P19_TRI_N, P19_QUAD_N, P19_QUAD2_N, P19_HEX_N = 512, 512, 256, 24
P19_PATH_STEPS, P19_DRV_STEPS, P19_DENSE_STEPS = 3, 20, 10
P19_DENSE_N = 28  # the dense path on box_tet_mesh(28, 28, 28)
# K8's tile-edge mesh: 75 elements, three 32-element tiles, the last ragged
P19_EDGE_BOX, P19_EDGE_E = (5, 5, 3), 75
P19_TYPES = {"TRI3": "tri3", "QUAD4": "quad4", "QUAD8": "quad8",
             "QUAD9": "quad9", "HEX20": "hex20", "HEX27": "hex27"}
_P19_HEX_EDGES = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
                  (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]
_P19_HEX_FACES = [(0, 3, 2, 1), (0, 1, 5, 4), (0, 4, 7, 3),
                  (1, 2, 6, 5), (2, 3, 7, 6), (4, 5, 6, 7)]
_P19_QUAD_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]


def _elevate(mesh, elem_type):
    """A QUAD4 or HEX8 mesh raised to QUAD8 / QUAD9 or HEX20 / HEX27: a
    node per edge (and per face and at the centre) in Gmsh order, each
    shared node once, in first-seen order (a copy of
    tests/test_quadratic_io.py's _elevate_hex, for quads too)."""
    from rdcfes_tpu_torch.mesh.core import Mesh

    quad = elem_type.startswith("QUAD")
    full = elem_type in ("QUAD9", "HEX27")
    edges = _P19_QUAD_EDGES if quad else _P19_HEX_EDGES
    faces = _P19_HEX_FACES if full and not quad else []
    coords = mesh.coords
    new, key2id, rows = [coords], {}, []

    def node_at(key, pt):
        if key not in key2id:
            key2id[key] = len(coords) + len(key2id)
            new.append(pt[None])
        return key2id[key]

    for e in mesh.connectivity.tolist():
        row = list(e)
        for a, b in edges:
            row.append(node_at(tuple(sorted((e[a], e[b]))),
                               (coords[e[a]] + coords[e[b]]) / 2))
        for f in faces:
            row.append(node_at(tuple(sorted(e[i] for i in f)),
                               coords[[e[i] for i in f]].mean(0)))
        if full:
            row.append(node_at(tuple(sorted(e)), coords[e].mean(0)))
        rows.append(row)
    return Mesh(np.concatenate(new), np.asarray(rows, np.int32), elem_type,
                mesh.subdomain_id.copy())


@functools.lru_cache(maxsize=None)
def _p19_mesh(elem_type):
    """Phase 19's mesh of elem_type, built once for phases 19 and 20."""
    from rdcfes_tpu_torch.mesh import box_quad_mesh, box_tri_mesh

    b2 = BRAIN[:2]
    if elem_type == "TRI3":
        return box_tri_mesh(P19_TRI_N, P19_TRI_N, bounds=b2)
    if elem_type == "QUAD4":
        return box_quad_mesh(P19_QUAD_N, P19_QUAD_N, bounds=b2)
    if elem_type.startswith("QUAD"):
        return _elevate(box_quad_mesh(P19_QUAD2_N, P19_QUAD2_N, bounds=b2),
                        elem_type)
    return _elevate(box_hex_mesh(P19_HEX_N, P19_HEX_N, P19_HEX_N,
                                 bounds=BRAIN), elem_type)


def _tile_edge_cases(elem_type, tag, dev):
    """K8 f64 and f32 at elem_type on the tile-edge mesh (P19_EDGE_BOX
    raised to elem_type, its elements shuffled, its nodes jittered, as
    tests/test_torch_gpu.py's) at 1, 5 and K.MAX_V species, against the
    plain versions."""
    from rdcfes_tpu_torch.fem.geometry import geometry_factors

    m = _elevate(box_hex_mesh(*P19_EDGE_BOX), elem_type)
    rng = np.random.default_rng(18)
    conn = m.connectivity[rng.permutation(m.n_elems)]
    coords = m.coords + 0.02 * rng.standard_normal(m.coords.shape)
    phi, _, dphi = geometry_factors(torch.as_tensor(coords, device=dev),
                                    torch.as_tensor(conn, device=dev),
                                    elem_type)
    conn_T = torch.as_tensor(np.ascontiguousarray(conn.T), device=dev)
    (Q, Kc), E = phi.shape, conn.shape[0]
    require(E == P19_EDGE_E, f"tile-edge mesh: {E} elements")
    cases = {}
    for dt, name, tol in ((F64, "f64", 1e-13), (F32, "f32", P20_F32_TOL)):
        dp = dphi.to(dt).contiguous()
        for V in (1, 5, K.MAX_V):
            u = torch.as_tensor(rng.standard_normal((V, len(coords))),
                                dtype=dt, device=dev)
            out = K.gather_interp_generic_plain(u, conn_T, phi, dp)
            cases[f"gather_interp_generic_{name}:{tag}@tile edge V={V}"] = (
                dict(kern=lambda u=u, dp=dp: K.gather_interp_generic(
                         u, conn_T, phi, dp),
                     plain=lambda u=u, dp=dp: K.gather_interp_generic_plain(
                         u, conn_T, phi, dp),
                     tol=tol, n_bytes=nbytes(u, conn_T, dp, *out),
                     flops=2.0 * 4 * V * Q * Kc * E, dtype=dt))
    return cases


def _p19_kernels(dev, results, also):
    """(a) K1-K3 at TRI3 and K8 / K6 at QUAD4, QUAD8, QUAD9, HEX20 and
    HEX27 against their plain versions with PIHNA's bench blocks at each
    mesh's bench state (each K8 row's share of its bound printed; K8 at
    HEX20 and HEX27 also on the tile-edge mesh), K4 at the new tables
    (f32, f64 and the block-Jacobi diagonal); K4 at the dense path's W =
    25 over the slot table of box_tet_mesh(28)."""
    from rdcfes_tpu_torch.fem.assembly import build_sparsity, invert_scatter

    for elem_type, tag in P19_TYPES.items():
        mesh = _p19_mesh(elem_type)
        _, params, u0 = bench_case(mesh)
        s = make_system(mesh, dev)
        u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F64,
                            device=dev)
        blocks_of = lambda uq, gq: pihna_blocks(uq, gq, {}, params)
        if elem_type == "TRI3":
            rename = {"restrict_f32": "restrict_f32@tri3",
                      "restrict_f64": "restrict_f64@tri3",
                      "restrict_f64@diagonal": "restrict_f64@tri3 diagonal"}
            cases = {rename.get(k, f"{k}:{tag}"): c
                     for k, c in affine_cases("19a tri3", s, u,
                                              blocks_of).items()}
        else:
            cases = {f"{k}:{tag}": c for k, c in generic_cases(
                tag, s, u, blocks_of, with_restrict=False).items()}
            blk, g = s.blocks[0], s.geom
            u_qp, gq = K.gather_interp_generic_plain(u, blk.conn_T, blk.phi,
                                                     g.dphi)
            wfb = blocks_of(u_qp, gq)
            del u_qp, gq
            V = s.n_vars
            flat32 = blk.apply(K.PLAIN_OPS, u.to(F32),
                               blk.stacks(wfb.cast(F32), g.JxW32), g.JxW32,
                               g.dphi32).reshape(V, -1)
            flat64 = blk.rhs(K.PLAIN_OPS, wfb, g).reshape(V, -1)
            diag64 = blk.diag(wfb, g).reshape(V * V, -1)
            cases[f"restrict_f32@{tag}"] = restrict_case(flat32, s)
            cases[f"restrict_f64@{tag}"] = restrict_case(flat64, s)
            cases[f"restrict_f64@{tag} diagonal"] = restrict_case(diag64, s)
            if elem_type in ("HEX20", "HEX27"):
                cases.update(_tile_edge_cases(elem_type, tag, dev))
        run_cases(f"19a {tag} kernel", cases, results, also)
        for key in cases:
            variant, _, sub = key.partition("@")
            if variant.startswith("gather_interp_generic"):
                r = results[variant] if not sub else also[variant][sub]
                say("19a bound", name=key,
                    E=P19_EDGE_E if sub else mesh.n_elems,
                    ms=f"{r['ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                    pct_of_bound=f"{100.0 * r['bound_ms'] / r['ms']:.1f}",
                    plain_ms=f"{r['plain_ms']:.4f}")
        say(f"19a {tag} shapes", E=mesh.n_elems, N=mesh.n_nodes,
            K=s.conn_T.shape[0], Q=s.geom.JxW.shape[0],
            C=s.node_gather.shape[0])
        del s, u, cases
        torch.cuda.empty_cache()
    # K4 over assemble's slot table: Ke (25, 16 E) onto the nnz node pairs
    mesh = box_tet_mesh(P19_DENSE_N, P19_DENSE_N, P19_DENSE_N, bounds=BRAIN)
    sp = build_sparsity(mesh.connectivity, mesh.n_nodes)
    slots = sp.slots_flat_cf()
    table = torch.as_tensor(invert_scatter(slots, sp.nnz), device=dev)
    rng = np.random.default_rng(19)
    W, M = 25, slots.shape[0]
    flat = torch.as_tensor(rng.standard_normal((W, M)), device=dev)
    idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
    live = int((table < M).sum())
    run_cases("19a dense kernel", {"restrict_f64@dense assemble": dict(
        kern=lambda: K.restrict(flat, table),
        plain=lambda: K.restrict_plain(flat, table), tol=1e-13,
        library=lambda: torch.zeros((W, sp.nnz), dtype=F64, device=dev
                                    ).index_add_(1, idx, flat),
        n_bytes=restrict_bytes(flat, table, sp.nnz), flops=float(W * live),
        dtype=F64)}, results, also)
    say("19a dense shapes", W=W, KKE=M, nnz=sp.nnz, C=table.shape[0])


def _p19_paths(dev):
    """(b) 3 PIHNA steps (the bench deck) on each new element type,
    mixed precision at rtol 1e-12, through the kernels and through the
    plain versions from a common state: per-step relative L2 within
    1e-10; every new instance of the type launched."""
    counts = {}
    for elem_type, tag in P19_TYPES.items():
        mesh = _p19_mesh(elem_type)
        _, params, u0 = bench_case(mesh)
        a, b = (make_system(mesh, dev, ops=ops, precond_refresh=1,
                            rtol=1e-12)
                for ops in (K.KERNEL_OPS, K.PLAIN_OPS))
        sa = a.initial_state(u0)
        worst, iters = 0.0, []
        torch.cuda.synchronize()
        K.reset_launch_counts()
        for _ in range(P19_PATH_STEPS):
            sb, _, rb = b.step(sa, params=params)
            sa, ia, ra = a.step(sa, params=params)
            iters.append(int(ia))
            worst = max(worst, rel_l2(sa["u"], sb["u"]))
            require(max(float(ra), float(rb)) <= 1e-12,
                    f"19b {tag}: residuals {float(ra):.3e}, {float(rb):.3e}")
        torch.cuda.synchronize()
        c = counts[f"19b {tag}"] = K.launch_counts()
        want = ([f"{v}:{tag}" for v in ("gather_interp_affine_f64",
                                        "rhs_affine_f64", "apply_affine_f32",
                                        "apply_affine_f64")]
                if elem_type == "TRI3" else
                [f"{v}:{tag}" for v in ("gather_interp_generic_f64",
                                        "apply_generic_f32",
                                        "apply_generic_f64")])
        want += ["restrict_f32", "restrict_f64"]
        say(f"19b {tag} paths", E=mesh.n_elems, N=mesh.n_nodes,
            steps=P19_PATH_STEPS, rtol=1e-12, precision="mixed",
            iters=iters, worst_rel_l2=f"{worst:.3e}", bar=1e-10,
            launches=" ".join(f"{k}:{c[k]}" for k in want))
        require(worst <= 1e-10, f"19b {tag} kernel vs plain: {worst:.3e}")
        _require_launched(c, want, f"19b {tag}")
        del a, b, sa, sb
        torch.cuda.empty_cache()
    return counts


def _p19_case(root, elem_type, dev):
    """A PIHNA case for `-m pihna` on a Gmsh file of elem_type: the
    shipped deck of make_pihna_case at P19_DRV_STEPS steps with an output
    at the first and the last, the mesh file and the initial nodal and
    elemental fields written the way make_pihna_case writes them (on the
    mesh's own coordinates, so the data stays in its plane)."""
    import os

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.mesh import gmsh

    d = cases.make_pihna_case(os.path.join(root, elem_type.lower()), n=2,
                              n_steps=P19_DRV_STEPS)
    mesh = _p19_mesh(elem_type)
    gmsh.write(mesh, os.path.join(d, "Brain_Model.msh"))
    rng = np.random.default_rng(0)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0 = np.zeros((mesh.n_nodes, 5))
    u0[:, 1] = 2000.0 * np.exp(-r2 / (2 * 25.0**2))
    u0[:, 2] = 500.0 * np.exp(-r2 / (2 * 30.0**2))
    u0[:, 3] = 7200.0 * (1.0 + 0.1 * rng.random(mesh.n_nodes))
    u0[:, 4] = 1e-10
    np.savetxt(os.path.join(d, "Brain_Model_Initial_Nodal_Field.dat"), u0)
    structure = np.zeros((mesh.n_elems, 2))
    structure[:, 0] = 40.0 + 5.0 * rng.random(mesh.n_elems)
    np.savetxt(os.path.join(d, "Brain_Model_Initial_Elemental_Field.dat"),
               structure)
    deck = os.path.join(d, "input.dat")
    with open(deck) as f:
        text = f.read().replace("output_step = 10",
                                f"output_step = {P19_DRV_STEPS}")
    with open(deck, "w") as f:
        f.write(text)
    return d, mesh


def _p19_drivers(dev):
    """(c) cli.main(["-m", "pihna"]) in process, P19_DRV_STEPS steps at
    the driver's settings, on Gmsh files of QUAD4 512^2, TRI3 512^2 and
    HEX27 24^3: the artifacts, every residual <= the rtol, PerfLog's
    split, steps/s and the launches of the type's instances."""
    import shutil
    import tempfile

    counts = {}
    root = tempfile.mkdtemp(prefix="rdcfes_p19_")
    try:
        for elem_type in ("QUAD4", "TRI3", "HEX27"):
            tag = P19_TYPES[elem_type]
            d, mesh = _p19_case(root, elem_type, dev)
            want = ((f"gather_interp_affine_f64:{tag}",
                     f"rhs_affine_f64:{tag}", f"apply_affine_f64:{tag}")
                    if elem_type == "TRI3" else
                    (f"gather_interp_generic_f64:{tag}",
                     f"apply_generic_f64:{tag}")) + ("restrict_f64",)
            c, _, _, _ = _drive_mixed(
                f"pihna {tag}", d, ["-m", "pihna"], dev, P19_DRV_STEPS,
                ("n", "c", "h", "v", "a"), (0, P19_DRV_STEPS),
                "PIHNA_simulation", want, phase="19c")
            counts[f"19c pihna {tag}"] = c
            shutil.rmtree(d, ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def _p19_dense(dev):
    """(d) the dense path: TransientRDCSystem(box_tet_mesh(28), 5,
    physics=pihna_physics), mixed precision, precond_refresh 20, 10 steps
    at rtol 1e-14 (steps/s), each step held to the qp path's step (the
    bench deck's blocks, same settings) from the same state within 1e-10
    relative L2; `assemble` through the kernels and the plain versions,
    values and right-hand side within 1e-13."""
    from rdcfes_tpu_torch.models.pihna import pihna_physics

    mesh, params, u0 = bench_case(box_tet_mesh(P19_DENSE_N, P19_DENSE_N,
                                               P19_DENSE_N, bounds=BRAIN))
    kw = dict(rtol=1e-14, precision="mixed", precond_refresh=20, device=dev)
    dense = TransientRDCSystem(mesh, 5, physics=pihna_physics, **kw)
    qp = TransientRDCSystem(mesh, 5, pihna_blocks, **kw)
    st = dense.initial_state(u0)
    worst, iters, t_dense = 0.0, [], 0.0
    # the dense steps' own launches: the counts set to 0 just before each
    # dense step and read just after it (the qp steps between them, which
    # it is held to, launch K1-K4 too)
    c = {}
    for _ in range(P19_DENSE_STEPS):
        sq, _, _ = qp.step(st, params=params)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        st, it, res = dense.step(st, params=params)
        torch.cuda.synchronize()
        t_dense += time.perf_counter() - t0
        for k, n in K.launch_counts().items():
            c[k] = c.get(k, 0) + n
        iters.append(int(it))
        require(float(res) <= 1e-14, f"19d dense residual {float(res):.3e}")
        worst = max(worst, rel_l2(st["u"], sq["u"]))
    counts = {"19d dense": c}
    want = ["gather_interp_affine_f64", "restrict_f32", "restrict_f64"]
    say("19d dense steps", E=mesh.n_elems, N=mesh.n_nodes,
        steps=P19_DENSE_STEPS, precision="mixed", rtol=1e-14,
        precond_refresh=20, iters=iters,
        dense_steps_per_s=f"{P19_DENSE_STEPS / t_dense:.4f}",
        worst_rel_l2_vs_qp=f"{worst:.3e}", bar=1e-10,
        ke_gb=f"{25 * 16 * mesh.n_elems * 8 / 1e9:.4f}",
        launches=" ".join(f"{k}:{n}" for k, n in sorted(c.items()) if n))
    require(worst <= 1e-10, f"19d dense vs qp path: {worst:.3e}")
    _require_launched(c, want, "19d dense")
    for k in ("rhs_affine_f64", "apply_affine_f32", "apply_affine_f64"):
        require(c.get(k, 0) == 0, f"19d dense launched {k}: {c.get(k)}")
    plain = TransientRDCSystem(mesh, 5, physics=pihna_physics,
                               ops=K.PLAIN_OPS, **kw)
    u_T = st["u"].T.contiguous()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    vk, bk = dense.assemble(u_T, {}, params)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    c = counts["19d assemble"] = K.launch_counts()
    vp, bp = plain.assemble(u_T, {}, params)
    ev = float((vk - vp).abs().max() / vp.abs().max())
    eb = float((bk - bp).abs().max() / bp.abs().max())
    say("19d assemble", nnz=dense.sp.nnz, seconds=f"{t_asm:.4f}",
        values_rel_err=f"{ev:.3e}", rhs_rel_err=f"{eb:.3e}", bar=1e-13,
        restrict_f64=c["restrict_f64"],
        gather_interp_affine_f64=c["gather_interp_affine_f64"])
    require(max(ev, eb) <= 1e-13, f"19d assemble: {ev:.3e}, {eb:.3e}")
    _require_launched(c, ["restrict_f64", "gather_interp_affine_f64"],
                      "19d assemble")
    return counts


def phase_slice6(dev, also):
    """(a) the new kernel instances against their plain versions, (b)
    kernel vs plain paths on each new element type, (c) the PIHNA driver
    on 2D and HEX27 Gmsh files, (d) the dense element-matrix path."""
    t0 = time.perf_counter()
    results = {}
    _p19_kernels(dev, results, also)
    paths = _p19_paths(dev)
    paths.update(_p19_drivers(dev))
    paths.update(_p19_dense(dev))
    say("19 done", seconds=f"{time.perf_counter() - t0:.4f}")
    return results, paths


# ----------------------------------------------------------------------
# phase 20: the transient systems' dtype=float32 serving mode, and ADPM's
# local parity at its shipped rtol
# ----------------------------------------------------------------------
# 20b the PIHNA bench in f32 (BENCH_STEPS), 20c HEX8 PIHNA (HEX_STEPS) and
# the mixed PIHNA case, 20d the dense path on TET4 28^3, 20e ADPM's local
# parity along an oracle trajectory on the bench mesh
P20_MIX_STEPS, P20_DENSE_STEPS, P20_PATH_STEPS = 20, 10, 3
P20_ADPM_STEPS, P20_ADPM_CHECK_N = 60, 12
P20_F32_TOL = 1e-5   # f32 kernels and f32 paths against their plain runs
# 20a's meshes: K1 and K2 f32 on TET4 and TRI3, K8 f32 on the others
P20_MESHES = ("TET4", "TRI3", "HEX8", "PYRAMID5", "PRISM6", "TET10", "QUAD4",
              "QUAD8", "QUAD9", "HEX20", "HEX27")


@functools.lru_cache(maxsize=None)
def _p20_mesh(kind):
    """Phase 20's mesh `kind`, built once for 20a and 20f: TET4 28^3 (the
    PIHNA bench's), HEX8 48^3 (phase 9's), box_mixed_mesh(28) ("PYRAMID5",
    phase 16's), a MixedMesh of one PRISM6 block (box_hex_mesh(28)'s
    cells split in two, 43,904 elements), TET10 28^3, and phase 19's TRI3,
    QUAD4, QUAD8, QUAD9, HEX20, HEX27."""
    from rdcfes_tpu_torch.mesh import (MeshBlock, MixedMesh, box_mixed_mesh,
                                       tet4_to_tet10)

    if kind == "TET4":
        return box_tet_mesh(28, 28, 28, bounds=BRAIN)
    if kind == "HEX8":
        return box_hex_mesh(HEX_N, HEX_N, HEX_N, bounds=BRAIN)
    if kind == "TET10":
        return tet4_to_tet10(box_tet_mesh(MIX_N, MIX_N, MIX_N, bounds=BRAIN))
    if kind == "PRISM6":
        hexm = box_hex_mesh(MIX_N, MIX_N, MIX_N, bounds=BRAIN)
        return MixedMesh(coords=hexm.coords, blocks=[
            MeshBlock("PRISM6", _prism_conn(hexm.connectivity))])
    if kind == "PYRAMID5":
        return box_mixed_mesh(MIX_N, MIX_N, MIX_N, bounds=BRAIN)
    return _p19_mesh(kind)


def _f32_blocks(kind, dev):
    """[(ElementBlock, its mesh)] of the phase-20a mesh `kind` (the mixed
    box: its HEX8 and PYRAMID5 blocks)."""
    from rdcfes_tpu_torch.systems.transient import ElementBlock

    mesh = _p20_mesh(kind)
    if mesh.elem_type != "MIXED":
        return [(ElementBlock(mesh.elem_type, mesh.connectivity, dev), mesh)]
    return [(ElementBlock(b.elem_type, b.connectivity, dev), mesh)
            for b in mesh.blocks if b.elem_type != "TET4"]


def _f32_cases(blk, mesh, label, dev):
    """K1 f32 and K2 f32 (an affine block) or K8 f32 (a generic one) at
    the block's shapes with its f32 geometry, the bench state cast to f32
    and PIHNA's bench blocks built at it in f32: what an f32 system's
    step launches, against the plain f32 versions."""
    g = blk.geometry(torch.as_tensor(mesh.coords, dtype=F64, device=dev),
                     F32)
    _, params, u0 = bench_case(mesh)
    u = torch.as_tensor(np.ascontiguousarray(u0.T), dtype=F32, device=dev)
    V = u.shape[0]
    Kc, E = blk.conn_T.shape
    Q = g.JxW.shape[0]
    suffix = lambda v: v + label
    if blk.affine:
        u_qp, gx1 = K.gather_interp_affine_plain(u, blk.conn_T, blk.phi,
                                                 g.dphi)
        gq = gx1[:, None].expand(V, Q, 3, E)
        rhs = K.stack_rhs(pihna_blocks(u_qp, gq, {}, params))
        fe = K.rhs_affine_plain(rhs, g.JxW, blk.phi, g.dphi)
        return {
            suffix("gather_interp_affine_f32"): dict(
                kern=lambda: K.gather_interp_affine(u, blk.conn_T, blk.phi,
                                                    g.dphi),
                plain=lambda: K.gather_interp_affine_plain(
                    u, blk.conn_T, blk.phi, g.dphi), tol=P20_F32_TOL,
                n_bytes=nbytes(u, blk.conn_T, g.dphi, u_qp, gx1),
                flops=2.0 * V * Kc * E * (Q + 3), dtype=F32),
            suffix("rhs_affine_f32"): dict(
                kern=lambda: K.rhs_affine(rhs, g.JxW, blk.phi, g.dphi),
                plain=lambda: K.rhs_affine_plain(rhs, g.JxW, blk.phi,
                                                 g.dphi), tol=P20_F32_TOL,
                n_bytes=nbytes(rhs.A, rhs.B, g.JxW, g.dphi, fe),
                flops=2.0 * Kc * Q * E * (len(rhs.idxA)
                                          + 3 * len(rhs.idxB)),
                dtype=F32)}
    u_qp, gq = K.gather_interp_generic_plain(u, blk.conn_T, blk.phi, g.dphi)
    return {suffix("gather_interp_generic_f32"): dict(
        kern=lambda: K.gather_interp_generic(u, blk.conn_T, blk.phi,
                                             g.dphi),
        plain=lambda: K.gather_interp_generic_plain(u, blk.conn_T, blk.phi,
                                                    g.dphi),
        tol=P20_F32_TOL, n_bytes=nbytes(u, blk.conn_T, g.dphi, u_qp, gq),
        flops=2.0 * 4 * V * Q * Kc * E, dtype=F32)}


def _p20_kernels(dev, results, also):
    """(a) K1 f32 and K2 f32 at TET4 28^3 and TRI3 512^2, K8 f32 at every
    GENERIC_KQ instance on the meshes of phases 9, 16 and 19, each within
    P20_F32_TOL of its plain f32 version; a row's bound is its f32 bytes
    over the HBM rate."""
    for kind in P20_MESHES:
        for blk, mesh in _f32_blocks(kind, dev):
            elem = blk.elem_type.lower()
            if kind == "PYRAMID5":  # the mixed box's blocks
                label = "@mixed hex8" if elem == "hex8" else ":pyramid5"
            else:
                label = "" if kind in ("TET4", "HEX8") else f":{elem}"
            cases = _f32_cases(blk, mesh, label, dev)
            run_cases(f"20a {elem} kernel", cases, results, also)
            for key in cases:
                variant, _, sub = key.partition("@")
                r = (results.get(variant) if not sub
                     else also[variant][sub])
                say("20a bound", name=key, E=blk.conn_T.shape[1],
                    ms=f"{r['ms']:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
                    pct_of_bound=f"{100.0 * r['bound_ms'] / r['ms']:.1f}",
                    plain_ms=f"{r['plain_ms']:.4f}")
            del cases
        torch.cuda.empty_cache()


def _pihna_f32(cls, mesh, dev):
    """make(ops, dt): phase 20's PIHNA system of class `cls` on `mesh`, the
    bench settings (rtol 3e-11, floored to 1e-6 in f32; "mixed",
    precond_refresh 20), f32 unless dt says otherwise."""
    return lambda ops=K.KERNEL_OPS, dt=F32: cls(
        mesh, 5, pihna_blocks, rtol=3e-11, precision="mixed",
        precond_refresh=20, device=dev, ops=ops, dtype=dt)


def _f32_paths(tag, make, params, u0):
    """P20_PATH_STEPS steps of an f32 system through the kernels and
    through the plain versions from a common state: per-step relative L2
    within P20_F32_TOL, every residual <= the f32 floor."""
    a, b = make(K.KERNEL_OPS), make(K.PLAIN_OPS)
    sa = a.initial_state(u0)
    worst = 0.0
    for _ in range(P20_PATH_STEPS):
        sb, _, rb = b.step(sa, params=params)
        sa, _, ra = a.step(sa, params=params)
        worst = max(worst, rel_l2(sa["u"], sb["u"]))
        require(max(float(ra), float(rb)) <= 1e-6,
                f"{tag}: residuals {float(ra):.3e}, {float(rb):.3e}")
    say(f"{tag} paths", steps=P20_PATH_STEPS, worst_rel_l2=f"{worst:.3e}",
        bar=P20_F32_TOL)
    require(worst <= P20_F32_TOL, f"{tag} kernel vs plain: {worst:.3e}")


def _f32_vs_f64(s32, s64, u0, params, steps):
    """The f32 and the f64 system stepped side by side with step() (the
    same block-Jacobi schedule as run_steps) from u0: each step's
    relative L2 of the f32 state to the f64 one."""
    a, b = s32.initial_state(u0), s64.initial_state(u0)
    gaps = []
    for _ in range(steps):
        a, _, _ = s32.step(a, params=params)
        b, _, _ = s64.step(b, params=params)
        gaps.append(rel_l2(a["u"].double(), b["u"]))
    return gaps


def _f32_run(tag, make, u0, params, steps, want):
    """(b, c) the f32 system's run_steps: steps/s, inner iterations,
    every residual <= the f32 floor, a finite non-negative f32 state, the
    kernels of `want` launched and no f64 instance; the per-step gap to
    the f64 system's run of the same case; then _f32_paths."""
    s32, s64 = make(), make(dt=F64)
    s32.run_steps(s32.initial_state(u0), 5, params=params)  # warm-up
    u, its, ress, wall, counts = _timed_run(s32, s32.initial_state(u0),
                                            steps, params=params)
    gaps = _f32_vs_f64(s32, s64, u0, params, steps)
    f64_used = {k: n for k, n in counts.items() if "f64" in k and n}
    say(tag, steps=steps, seconds=f"{wall:.4f}",
        steps_per_s=f"{steps / wall:.4f}", rtol=s32.rtol,
        precision=f"{s32.precision} (f32: plain solve)",
        inner_iters_total=int(its.sum()),
        max_residual=f"{float(ress.max()):.3e}", n_nodes=s32.mesh.n_nodes,
        n_elems=s32.mesh.n_elems, dtype=str(u.dtype))
    say(f"{tag} vs f64", first=f"{gaps[0]:.3e}", worst=f"{max(gaps):.3e}",
        last=f"{gaps[-1]:.3e}",
        per_step=" ".join(f"{x:.2e}" for x in gaps))
    say(f"{tag} launches", **{k: counts[k] for k in want})
    require(u.dtype == np.float32, f"{tag}: state {u.dtype}")
    require(np.isfinite(u).all(), f"{tag}: non-finite state")
    require((u >= 0).all(), f"{tag}: negative state after the clamp")
    require(float(ress.max()) <= 1e-6,
            f"{tag}: residual {float(ress.max()):.3e} > 1e-6")
    _require_launched(counts, want, tag)
    require(not f64_used, f"{tag}: f64 kernels launched: {f64_used}")
    _f32_paths(tag, make, params, u0)
    return counts


def _p20_bench(dev):
    """(b) the PIHNA bench in f32: BENCH_STEPS steps, rtol 3e-11 floored
    to 1e-6, precond_refresh 20; 3 kernel steps against 3 plain steps."""
    mesh, params, u0 = bench_case()
    return _f32_run("20b pihna f32", _pihna_f32(TransientRDCSystem, mesh,
                                                 dev),
                    u0, params, BENCH_STEPS, K.TRANSIENT_F32_VARIANTS)


def _p20_generic(dev):
    """(c) HEX8 PIHNA on box_hex_mesh(48) (HEX_STEPS) and the mixed PIHNA
    case make_pihna_case(n=28, mixed=True) (P20_MIX_STEPS) in f32."""
    import os
    import shutil
    import tempfile

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.mesh import gmsh
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    counts = {}
    mesh, params, u0 = bench_case(box_hex_mesh(HEX_N, HEX_N, HEX_N,
                                               bounds=BRAIN))
    counts["20c hex8 f32"] = _f32_run(
        "20c hex8 pihna f32", _pihna_f32(TransientRDCSystem, mesh, dev), u0,
        params, HEX_STEPS, K.GENERIC_F32_VARIANTS)
    root = tempfile.mkdtemp(prefix="rdcfes_p20_")
    try:
        d = cases.make_pihna_case(os.path.join(root, "m"), n=MIX_N,
                                  mixed=True)
        mesh = gmsh.read(os.path.join(d, "Brain_Model.msh"))
        params = _pihna_deck_params(d)
        u0 = np.loadtxt(os.path.join(d,
                                     "Brain_Model_Initial_Nodal_Field.dat"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts["20c mixed f32"] = _f32_run(
        "20c mixed pihna f32", _pihna_f32(MixedTransientRDCSystem, mesh, dev),
        u0, params, P20_MIX_STEPS,
        K.TRANSIENT_F32_VARIANTS + K.GENERIC_F32_VARIANTS
        + ("gather_interp_generic_f32:pyramid5",
           "apply_generic_f32:pyramid5"))
    return counts


def _p20_dense(dev):
    """(d) TransientRDCSystem(box_tet_mesh(28), 5, physics=pihna_physics,
    dtype=f32), P20_DENSE_STEPS steps, each held to the f32 qp path's
    step from the same state; `assemble` through the kernels and the
    plain versions."""
    from rdcfes_tpu_torch.models.pihna import pihna_physics

    mesh, params, u0 = bench_case()
    kw = dict(rtol=3e-11, precision="mixed", precond_refresh=20, device=dev,
              dtype=F32)
    dense = TransientRDCSystem(mesh, 5, physics=pihna_physics, **kw)
    qp = TransientRDCSystem(mesh, 5, pihna_blocks, **kw)
    st = dense.initial_state(u0)
    worst, iters, t_dense, c = 0.0, [], 0.0, {}
    for _ in range(P20_DENSE_STEPS):
        sq, _, _ = qp.step(st, params=params)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        st, it, res = dense.step(st, params=params)
        torch.cuda.synchronize()
        t_dense += time.perf_counter() - t0
        for k, n in K.launch_counts().items():
            c[k] = c.get(k, 0) + n
        iters.append(int(it))
        require(float(res) <= 1e-6, f"20d dense residual {float(res):.3e}")
        worst = max(worst, rel_l2(st["u"], sq["u"]))
    f64_used = {k: n for k, n in c.items() if "f64" in k and n}
    say("20d dense f32 steps", E=mesh.n_elems, N=mesh.n_nodes,
        steps=P20_DENSE_STEPS, rtol=dense.rtol, precond_refresh=20,
        iters=iters, dense_steps_per_s=f"{P20_DENSE_STEPS / t_dense:.4f}",
        worst_rel_l2_vs_qp=f"{worst:.3e}", bar=P20_F32_TOL,
        ke_gb=f"{25 * 16 * mesh.n_elems * 4 / 1e9:.4f}",
        launches=" ".join(f"{k}:{n}" for k, n in sorted(c.items()) if n))
    require(worst <= P20_F32_TOL, f"20d dense vs qp path: {worst:.3e}")
    _require_launched(c, ["gather_interp_affine_f32", "restrict_f32"],
                      "20d dense")
    require(not f64_used, f"20d dense launched f64 kernels: {f64_used}")
    require(st["u"].dtype == F32, "20d: the state left f32")
    plain = TransientRDCSystem(mesh, 5, physics=pihna_physics,
                               ops=K.PLAIN_OPS, **kw)
    u_T = st["u"].T.contiguous()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    vk, bk = dense.assemble(u_T, {}, params)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    ca = K.launch_counts()
    vp, bp = plain.assemble(u_T, {}, params)
    ev = float((vk - vp).abs().max() / vp.abs().max())
    eb = float((bk - bp).abs().max() / bp.abs().max())
    say("20d assemble f32", nnz=dense.sp.nnz, seconds=f"{t_asm:.4f}",
        dtype=str(vk.dtype), values_rel_err=f"{ev:.3e}",
        rhs_rel_err=f"{eb:.3e}", bar=P20_F32_TOL,
        restrict_f32=ca["restrict_f32"],
        gather_interp_affine_f32=ca["gather_interp_affine_f32"])
    require(vk.dtype == F32 and max(ev, eb) <= P20_F32_TOL,
            f"20d assemble: {vk.dtype} {ev:.3e}, {eb:.3e}")
    _require_launched(ca, ["restrict_f32", "gather_interp_affine_f32"],
                      "20d assemble")
    return {"20d dense f32": c, "20d assemble f32": ca}


def _oracle_step(orc, u):
    """One AdpmOracle step (its own assembly, src/adpm.C's scheme) solved
    by Jacobi-preconditioned BiCGStab to 1e-13 of |F|: SuperLU's fill on
    the 73,167 unknowns of TET4 28^3 takes minutes a step, so the direct
    solve is held to this one at P20_ADPM_CHECK_N^3 (20e)."""
    import scipy.sparse as sps
    import scipy.sparse.linalg as spla

    Kmat, F = orc.assemble(u, 1.0)
    M = sps.diags(1.0 / Kmat.diagonal())
    x, info = spla.bicgstab(Kmat, F, x0=u.T.reshape(-1), M=M, rtol=1e-13,
                            atol=0.0, maxiter=2000)
    if info != 0:
        raise RuntimeError(f"oracle BiCGStab: info {info}")
    return np.maximum(x.reshape(3, orc.N).T, 0.0)


def _adpm_parity_case(n):
    """The taxis-active ADPM leg's deck, state and tracts on a box of the
    bench's element size (bounds scaled by n / 28)."""
    s = n / 28.0
    mesh = box_tet_mesh(n, n, n, bounds=tuple((0, hi * s)
                                              for _, hi in BRAIN))
    pa, u0, tracts = adpm_case(mesh, 50.0)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(axis=1)
    u0[:, 1] = 1e-3 * np.exp(-r2 / (2 * (20.0 * s) ** 2))
    u0[:, 2] = 1e-4 * np.exp(-r2 / (2 * (15.0 * s) ** 2))
    return mesh, pa, u0, tracts


def _adpm_oracle_trajectory(path, cpu):
    """The oracle's P20_ADPM_STEPS-step trajectory on the bench mesh, run
    in a process of its own while the card works on the other phases, on
    host CPU `cpu` alone at the lowest priority, so that the host-timed
    phases keep the host; saved to `path` (.npy, (steps + 1, N, 3))."""
    import os

    from oracle.adpm_numpy import AdpmOracle

    os.sched_setaffinity(0, {cpu})
    os.nice(19)
    mesh, pa, u0, tracts = _adpm_parity_case(28)
    orc = AdpmOracle(mesh.coords, mesh.connectivity, tracts, pa)
    traj = [u0]
    for _ in range(P20_ADPM_STEPS):
        traj.append(_oracle_step(orc, traj[-1]))
    np.save(path, np.stack(traj))


def start_adpm_oracle():
    """The 20e oracle trajectory, started in a spawned process: (process,
    its output path, its directory)."""
    import multiprocessing
    import os
    import tempfile

    d = tempfile.mkdtemp(prefix="rdcfes_p20_oracle_")
    path = os.path.join(d, "traj.npy")
    cpu = max(os.sched_getaffinity(0))
    proc = multiprocessing.get_context("spawn").Process(
        target=_adpm_oracle_trajectory, args=(path, cpu), daemon=True)
    # one thread in the child: its BLAS and OpenMP pools are sized from
    # the environment it starts with
    one = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in one}
    os.environ.update({k: "1" for k in one})
    try:
        proc.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return proc, path, d


def _p20_types(dev):
    """(f) P20_PATH_STEPS steps of the PIHNA bench deck in f32 (run_steps,
    rtol floored to 1e-6) on each element type 20b and 20c do not step:
    every residual <= 1e-6, a finite non-negative f32 state, the type's
    f32 instances launched and no f64 kernel."""
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    counts = {}
    for kind in ("TRI3", "PRISM6", "TET10", "QUAD4", "QUAD8", "QUAD9",
                 "HEX20", "HEX27"):
        mesh = _p20_mesh(kind)
        _, params, u0 = bench_case(mesh)
        s = _pihna_f32(MixedTransientRDCSystem if mesh.elem_type == "MIXED"
                       else TransientRDCSystem, mesh, dev)()
        tag = kind.lower()
        want = ([f"{v}:{tag}" for v in ("gather_interp_affine_f32",
                                        "rhs_affine_f32", "apply_affine_f32")]
                if kind == "TRI3" else
                [f"{v}:{tag}" for v in ("gather_interp_generic_f32",
                                        "apply_generic_f32")])
        u, its, ress, wall, c = _timed_run(s, s.initial_state(u0),
                                           P20_PATH_STEPS, params=params)
        f64_used = {k: n for k, n in c.items() if "f64" in k and n}
        say(f"20f {tag} f32", E=mesh.n_elems, N=mesh.n_nodes,
            steps=P20_PATH_STEPS, seconds=f"{wall:.4f}",
            iters=its.tolist(), max_residual=f"{float(ress.max()):.3e}",
            launches=" ".join(f"{k}:{c[k]}" for k in want))
        require(u.dtype == np.float32 and np.isfinite(u).all()
                and (u >= 0).all(), f"20f {tag}: state")
        require(float(ress.max()) <= 1e-6,
                f"20f {tag}: residual {float(ress.max()):.3e}")
        _require_launched(c, want + ["restrict_f32"], f"20f {tag}")
        require(not f64_used, f"20f {tag}: f64 kernels launched: {f64_used}")
        counts[f"20f {tag} f32"] = c
        del s
        torch.cuda.empty_cache()
    return counts


def _p20_adpm(dev, oracle):
    """(e) PARITY.md section 10's local parity at the taxis-active leg's
    shipped rtol 1e-9: the port re-seeded from each state of the oracle's
    trajectory on TET4 28^3 takes one step (amplitude 50, dt 0.05,
    "mixed", precond_refresh 10); worst relative L2 to the oracle's next
    state <= 1e-8.  First the oracle's iterative solve is held to its
    direct one on the P20_ADPM_CHECK_N^3 box."""
    import shutil

    from oracle.adpm_numpy import AdpmOracle

    mesh, pa, u0, tracts = _adpm_parity_case(P20_ADPM_CHECK_N)
    orc = AdpmOracle(mesh.coords, mesh.connectivity, tracts, pa)
    u, worst_solve = u0, 0.0
    for _ in range(3):
        ud, _ = orc.step(u, time=1.0)
        worst_solve = max(worst_solve, float(
            np.linalg.norm(_oracle_step(orc, u) - ud) / np.linalg.norm(ud)))
        u = ud
    say("20e oracle solve", n=P20_ADPM_CHECK_N, steps=3,
        iterative_vs_direct=f"{worst_solve:.3e}", bar=1e-12)
    require(worst_solve <= 1e-12,
            f"20e oracle: iterative vs direct {worst_solve:.3e}")
    proc, path, d = oracle
    t0 = time.perf_counter()
    proc.join(timeout=900)
    waited = time.perf_counter() - t0
    require(proc.exitcode == 0, f"20e oracle process: exit {proc.exitcode}")
    traj = np.load(path)
    shutil.rmtree(d, ignore_errors=True)
    mesh, pa, u0, tracts = _adpm_parity_case(28)
    require(np.array_equal(traj[0], u0), "20e: the oracle's initial state")
    s = make_adpm(mesh, dev, 1e-9)
    f = adpm_fields(tracts, dev)
    worst, iters, rels = 0.0, 0, []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for k in range(P20_ADPM_STEPS):
        st, it, res = s.step(s.initial_state(traj[k]), fields=f, params=pa)
        require(float(res) <= 1e-9, f"20e step {k}: residual {float(res)}")
        iters += int(it)
        rels.append(rel_l2(st["u"], traj[k + 1]))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    worst = max(rels)
    say("20e adpm local parity", mesh="box_tet_mesh(28)", n_nodes=mesh.n_nodes,
        steps=P20_ADPM_STEPS, rtol=1e-9, precision="mixed",
        precond_refresh=10, worst_rel_l2=f"{worst:.3e}", bar=1e-8,
        margin=f"{1e-8 / worst:.2f}",
        mean_inner_iters=f"{iters / P20_ADPM_STEPS:.2f}",
        oracle_wait_s=f"{waited:.1f}",
        per_step=" ".join(f"{x:.2e}" for x in rels))
    require(worst <= 1e-8, f"20e: worst local rel L2 {worst:.3e} > 1e-8")
    _require_launched(counts, K.TRANSIENT_VARIANTS, "20e")
    return {"20e adpm": counts}


def phase_f32(dev, also, oracle):
    """(a) the f32 instances of K1, K2 and K8 against their plain
    versions, (b) the PIHNA bench in f32, (c) HEX8 and mixed PIHNA in
    f32, (d) the dense path in f32, (e) ADPM's local parity at rtol
    1e-9, (f) f32 steps on every other element type."""
    laps = [time.perf_counter()]
    lap = lambda: laps.append(time.perf_counter())
    results, paths = {}, {}
    _p20_kernels(dev, results, also)
    lap()
    paths["20b pihna f32"] = _p20_bench(dev)
    lap()
    paths.update(_p20_generic(dev))
    lap()
    paths.update(_p20_dense(dev))
    lap()
    paths.update(_p20_adpm(dev, oracle))
    lap()
    paths.update(_p20_types(dev))
    lap()
    say("20 done", seconds=f"{laps[-1] - laps[0]:.4f}",
        **{f"{sub}_s": f"{b - a:.4f}"
           for sub, a, b in zip("abcdef", laps, laps[1:])})
    return results, paths


# ----------------------------------------------------------------------
# phase 21: the multi-device halo system (D shards on one card)
# ----------------------------------------------------------------------
P21_D = 4
P21_HEX_N = 24        # box_hex_mesh(24): 13,824 HEX8, 15,625 nodes
P21_STEPS, P21_HEX_STEPS = 10, 5
# 21d's depth: 10 steps with the bisection pass at 5 (20 at 10 until
# phase 22's mixed driver pair took its place in the time limit)
P21_DRV_STEPS, P21_DRV_AMR = 10, 5
# the resume run: phase 15's 12^3 case (its bisected nodes are exact in
# the Gmsh writer's 6 digits), AMR at step 4, a checkpoint at step 6
P21_HALO = ("gather_interp_affine_f64", "rhs_affine_f64",
            "apply_affine_f64", "restrict_f64")
P21_HALO_HEX = ("gather_interp_generic_f64", "apply_generic_f64",
                "restrict_f64")


def _halo(mesh, dev, ops=K.KERNEL_OPS, rtol=3e-11):
    from rdcfes_tpu_torch.parallel import HaloShardedSystem

    return HaloShardedSystem(mesh, 5, P21_D, pihna_blocks, rtol=rtol,
                             device=dev, ops=ops)


def _one_device(mesh, dev):
    """The port's single-device system with the drivers' settings (f64
    BiCGStab, block-Jacobi every step, rtol 3e-11)."""
    return TransientRDCSystem(mesh, 5, pihna_blocks, rtol=3e-11,
                              precision="f64", precond_refresh=1,
                              device=dev)


def _shard_shim(h, s):
    """What affine_cases and generic_cases read of a system, for shard s
    of the single-type halo system h: its one block's local connectivity
    into the (V, Nloc) slab, its geometry and the shard's node_gather."""
    from types import SimpleNamespace as NS

    sh = h.shards[s]
    (_, blk, g), = sh.parts
    Nloc = h.plan.No_max + h.plan.Gtot
    return NS(n_vars=h.n_vars, geom=g, conn_T=blk.conn_T, phi=blk.phi,
              node_gather=sh.node_gather,
              mesh=NS(n_elems=blk.conn_T.shape[1], n_nodes=Nloc))


def _rev_case(h, s, W, tol=1e-13):
    """K4 over shard s's rev_gather: the returned ghost partials (W, Gtot)
    summed onto its owned slots (W, No_max), beside index_add_."""
    sh = h.shards[s]
    rg, No, G = sh.rev_gather, h.plan.No_max, h.plan.Gtot
    gen = torch.Generator(device=sh.device).manual_seed(21)
    flat = torch.rand((W, G), dtype=F64, device=sh.device, generator=gen)
    # the owned slot each returned position adds onto (No: a pad position)
    t = rg.long()
    used = t < G
    tgt = torch.full((G,), No, dtype=torch.long, device=sh.device)
    tgt[t[used]] = torch.arange(No, device=sh.device).expand_as(t)[used]
    live = tgt < No
    idx = torch.where(live, tgt, 0)
    src = flat * live
    return dict(
        kern=lambda: K.restrict(flat, rg),
        plain=lambda: K.restrict_plain(flat, rg), tol=tol,
        library=lambda: torch.zeros((W, No), dtype=F64, device=sh.device
                                    ).index_add_(1, idx, src),
        n_bytes=restrict_bytes(flat, rg, No),
        flops=float(W * int((rg < G).sum())), dtype=F64)


def _p21_kernels(dev, mesh, params, u0, hex_mesh, results, also):
    """(a) K1, K2, K3 f64 and K4 f64 at the largest shard of the bench
    mesh (K4 over its node_gather and its rev_gather), K8, K6 f64 and K4
    at the largest shard of box_hex_mesh(24)."""
    blocks_of = lambda uq, gq: pihna_blocks(uq, gq, {}, params)
    for tag, m, state, names in (
            ("tet4", mesh, u0, P21_HALO),
            ("hex8", hex_mesh, bench_case(hex_mesh)[2], P21_HALO_HEX)):
        h = _halo(m, dev)
        s = int(np.argmax(h.plan.elem_counts))
        ug = h.ghost_fill(h.scatter_nodal(state))[s]
        shim = _shard_shim(h, s)
        cases = (affine_cases(f"21a {tag}", shim, ug, blocks_of)
                 if tag == "tet4" else
                 generic_cases(f"21a {tag}", shim, ug, blocks_of))
        cases = {(k if tag == "tet4" or "@" in k else f"{k}@{tag}"): c
                 for k, c in cases.items() if k.partition("@")[0] in names}
        cases[f"restrict_f64@{tag} rev_gather"] = _rev_case(h, s, 5)
        cases[f"restrict_f64@{tag} rev_gather diagonal"] = _rev_case(h, s,
                                                                     25)
        say(f"21a {tag} shard", shard=s, E_s=shim.mesh.n_elems,
            Nloc=shim.mesh.n_nodes, No_max=h.plan.No_max, Gtot=h.plan.Gtot,
            Cr=tuple(h.shards[s].rev_gather.shape)[0])
        run_cases("21a kernel", cases, {}, also, label="halo shard",
                  first=results)
        del h


def _p21_plan(tag, h, W=5):
    p = h.plan
    Nloc = p.No_max + p.Gtot
    say(f"{tag} plan", D=p.D, No_max=p.No_max, Gtot=p.Gtot,
        deltas="/".join(map(str, p.deltas)),
        seg_sizes="/".join(map(str, p.seg_sizes)),
        ghost_share_of_Nloc=f"{p.Gtot / Nloc:.4f}",
        elem_counts="/".join(map(str, p.elem_counts)),
        owned_counts="/".join(map(str, p.owned_counts)),
        ghost_payload_bytes_per_exchange=W * 8 * int(p.D * sum(
            p.seg_sizes)))


def _p21_steps(tag, mesh, params, u0, steps, dev, variants,
               one_device=_one_device, iter_gap=None, h=None):
    """(b, c) `steps` steps of the halo system (h, or one built here)
    and of the single-device system from the same state, each step's
    relative L2 <= 1e-8 (and, with iter_gap, their inner iterations
    within iter_gap); steps/s of each (the host reads of the comparison
    outside the clock)."""
    h = _halo(mesh, dev) if h is None else h
    one = one_device(mesh, dev)
    _p21_plan(tag, h)
    a, b = h.initial_state(u0), one.initial_state(u0)
    # a warm-up step each (first launches, plans), then the counts
    h.step(a, params=params)
    one.step(b, params=params)
    worst, its_h, its_1, t_h, t_1 = 0.0, [], [], 0.0, 0.0
    counts = {}
    for _ in range(steps):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        a, ih, rh = h.step(a, params=params)
        torch.cuda.synchronize()
        t_h += time.perf_counter() - t0
        for k, v in K.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        t0 = time.perf_counter()
        b, i1, _ = one.step(b, params=params)
        torch.cuda.synchronize()
        t_1 += time.perf_counter() - t0
        ua, ub = h.gather(a["u"]), b["u"].cpu().numpy()
        worst = max(worst, float(np.linalg.norm(ua - ub)
                                 / np.linalg.norm(ub)))
        require(float(rh) <= 3e-11, f"{tag}: residual {float(rh):.3e}")
        its_h.append(ih)
        its_1.append(i1)
    require(np.isfinite(ua).all() and (ua >= 0).all(),
            f"{tag}: state not finite and >= 0")
    say(tag, steps=steps, worst_rel_l2=f"{worst:.3e}", bar=1e-8,
        halo_steps_per_s=f"{steps / t_h:.4f}",
        one_device_steps_per_s=f"{steps / t_1:.4f}",
        halo_iters="/".join(map(str, its_h)),
        one_device_iters="/".join(map(str, its_1)),
        n_nodes=mesh.n_nodes, n_elems=mesh.n_elems)
    say(f"{tag} launches", **{k: counts.get(k, 0) for k in variants})
    require(worst <= 1e-8, f"{tag}: halo vs one device {worst:.3e}")
    if iter_gap is not None:
        gap = max(abs(int(a) - int(b)) for a, b in zip(its_h, its_1))
        require(gap <= iter_gap, f"{tag}: inner iterations differ by {gap}")
    _require_launched(counts, variants, f"the halo {tag} step")
    return counts


def _drive_halo(d, dev, argv=("-m", "pihna")):
    """_drive(argv) recording each step and run_steps call of the halo or
    the single-device system: (the system, the state, the inner
    iterations, the residuals)."""
    from rdcfes_tpu_torch.parallel import halo as halo_mod
    from rdcfes_tpu_torch.systems import transient as transient_mod

    seen = []
    saved = [(c, m, getattr(c, m)) for c in (
        halo_mod.HaloShardedSystem, transient_mod.TransientRDCSystem)
        for m in ("step", "run_steps")]

    def wrap(orig):
        def recorded(self, state, *a, **kw):
            out = orig(self, state, *a, **kw)
            its, ress = out[1], out[2]
            seen.append((self, out[0],
                         its.tolist() if torch.is_tensor(its) else [its],
                         [float(r) for r in ress.reshape(-1)]))
            return out
        return recorded

    for c, m, orig in saved:
        setattr(c, m, wrap(orig))
    try:
        wall, counts, out = _drive(d, list(argv), dev)
    finally:
        for c, m, orig in saved:
            setattr(c, m, orig)
    return wall, counts, out, seen


def _p21_driver(dev):
    """(d) `-m pihna` on make_pihna_case(n=28), P21_DRV_STEPS steps with
    one bisection AMR pass at step P21_DRV_AMR, at parallel/n_devices = 4
    and at 1: CSV rows within 1e-8, the VTU's processor_ID the halo
    plan's; then a 4-shard run of phase 15's resume case (12^3, AMR at
    step 4, a checkpoint at step 6) resumed from its checkpoint ends on
    the uninterrupted run's CSV row."""
    import os
    import re
    import shutil
    import tempfile

    from rdcfes_tpu_torch import cases

    par = f"parallel/n_devices = {P21_D}\n"
    root = tempfile.mkdtemp(prefix="rdcfes_halo_")
    try:
        runs = {}
        for tag, extra in (("4 shards", par), ("one device", "")):
            d = cases.make_pihna_case(os.path.join(root, tag.split()[0]),
                                      n=28, n_steps=P21_DRV_STEPS)
            _amr_deck(d, P21_DRV_AMR, 1, "bisection", extra)
            runs[tag] = (d,) + _drive_halo(d, dev)
        d, wall, counts, out, seen = runs["4 shards"]
        res = os.path.join(d, "PIHNA_simulation")
        rows = [_transient_artifacts(os.path.join(r[0], "PIHNA_simulation"),
                                     "Brain_Model",
                                     tuple(range(0, P21_DRV_STEPS + 1, 10)),
                                     ("n", "c", "h", "v", "a"))
                for r in runs.values()]
        num = [np.array([[float(x) for x in ln.split(",")]
                         for ln in r[1:]]) for r in rows]
        scale = 1.0 + np.abs(num[1]).max()
        err = float(np.abs(num[0] - num[1]).max())
        require(np.allclose(num[0], num[1], rtol=1e-8, atol=1e-8 * scale),
                f"21d: CSV rows differ by {err:.3e}")
        h = seen[-1][0]
        require(type(h).__name__ == "HaloShardedSystem" and h.plan.D == P21_D,
                "21d: the 4-shard run did not step the halo system")
        with open(os.path.join(res, f"Brain_Model-{P21_DRV_STEPS}.vtu")
                  ) as f:
            pid = re.search(r'Name="processor_ID"[^>]*>\n(.*?)\n', f.read(),
                            re.S).group(1)
        pid = np.array(pid.split(), dtype=np.int64)
        require(np.array_equal(pid, h.processor_id),
                "21d: the VTU's processor_ID is not the plan's")
        amr = re.findall(r"AMR step (\d+): adapted to (\d+) elements", out)
        require(len(amr) == 1 and h.mesh.n_elems == int(amr[0][1]),
                "21d: one AMR pass onto the halo system's mesh")
        # phase 15's resume case on 4 shards, resumed from its checkpoint
        d = cases.make_pihna_case(os.path.join(root, "resume"),
                                  n=AMR_RESUME_N, n_steps=AMR_RESUME_STEPS)
        _amr_deck(d, AMR_RESUME_AT, 1, "bisection",
                  f"checkpoint/step = {AMR_RESUME_CKPT}\n" + par)
        wall_r, _, _, _ = _drive_halo(d, dev)
        res = os.path.join(d, "PIHNA_simulation")
        ck = os.path.join(root, "checkpoint")
        os.makedirs(ck)
        for name in ("checkpoint.npz", "checkpoint_mesh.msh"):
            shutil.copy(os.path.join(res, name), ck)
        full = open(os.path.join(res, "output.csv")).read().splitlines()
        shutil.rmtree(res)
        with open(os.path.join(d, "input.dat"), "a") as f:
            f.write(f"checkpoint/resume = {ck}/checkpoint.npz\n")
        wall2, _, out2, seen2 = _drive_halo(d, dev)
        require("resumed on AMR mesh" in out2, "21d: not resumed on AMR mesh")
        require(type(seen2[-1][0]).__name__ == "HaloShardedSystem",
                "21d: the resumed run did not step the halo system")
        last = open(os.path.join(res, "output.csv")).read().splitlines()
        a_row = np.array(last[-1].split(","), dtype=float)
        b_row = np.array(full[-1].split(","), dtype=float)
        resumed_err = float(np.abs(a_row - b_row).max())
        require(resumed_err <= 1e-12 * (1.0 + np.abs(b_row).max()),
                f"21d: resumed row differs by {resumed_err:.3e}")
        one = runs["one device"]
        scopes = {tag: _perf_totals(r[3]) for tag, r in runs.items()}
        say("21d pihna driver", steps=P21_DRV_STEPS,
            seconds_4_shards=f"{wall:.4f}",
            seconds_one_device=f"{one[1]:.4f}",
            **{f"{k.replace(' ', '_')}_s_{tag.replace(' ', '_')}":
               f"{t.get(k, 0.0):.4f}" for tag, t in scopes.items()
               for k in ("system setup", "solve", "amr", "vtu output")},
            amr_elements=amr[0][1], csv_max_abs_diff=f"{err:.3e}",
            processor_ids=len(set(pid.tolist())),
            resume_case_seconds=f"{wall_r:.4f}",
            resumed_seconds=f"{wall2:.4f}",
            resumed_row_max_abs_diff=f"{resumed_err:.3e}")
        say("21d launches", **{k: counts[k] for k in P21_HALO})
        _require_launched(counts, P21_HALO, "the 4-shard PIHNA driver")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_halo(dev, card, also):
    """(a) the kernels at one shard's local shapes; (b) the qp-path halo
    system on the PIHNA bench mesh and state against the single-device
    system, 10 steps; (c) the same on HEX8 box_hex_mesh(24), 5 steps;
    (d) the PIHNA driver at parallel/n_devices = 4 and at 1, with AMR and
    a checkpoint resumed.  D = 4 shards, all on `dev`."""
    say("21 card", card=repr(card), shards=P21_D, device=dev)
    mesh, params, u0 = bench_case()
    hex_mesh = box_hex_mesh(P21_HEX_N, P21_HEX_N, P21_HEX_N, bounds=BRAIN)
    results, paths = {}, {}
    _p21_kernels(dev, mesh, params, u0, hex_mesh, results, also)
    paths["halo tet4"] = _p21_steps("21b tet4", mesh, params, u0,
                                    P21_STEPS, dev, P21_HALO)
    paths["halo hex8"] = _p21_steps("21c hex8", hex_mesh, params,
                                    bench_case(hex_mesh)[2], P21_HEX_STEPS,
                                    dev, P21_HALO_HEX)
    paths["halo driver"] = _p21_driver(dev)
    return results, paths


# ----------------------------------------------------------------------
# phase 22: the halo system on TET10, QUAD4 and MixedMesh (D shards on
# one card), and the mixed PIHNA and ADPM drivers on 4 shards
# ----------------------------------------------------------------------
P22_T10_N, P22_QUAD_N, P22_STEPS, P22_MIX_STEPS = 28, 512, 5, 10
# 22e's depth: on the mixed n = 28 case at amplitude 50 a one-device f64
# and a one-device mixed-precision run, both at rtol 1e-12, part by
# 4e-10 of the scale at step 2, 1.4e-7 at step 3 and 7.4e-2 at step 20
# (`python3 -m rdcfes_tpu_torch.parallel.gap adpm` on an H100): past
# step 2 no two solves meet the 1e-8 bar
P22_DRV_STEPS, P22_DRV_AMR, P22_ADPM_STEPS = 20, 10, 2
# both runs of a driver pair solve to 1e-12: the single-device mixed
# system refines in mixed precision past its rtol while the halo step's
# f64 BiCGStab stops at it, and at 3e-11 that gap in the small species
# can cross a CSV threshold (the reference's own mixed RIPF at 8 devices
# shows it)
P22_DRV_TOL = "solver/linear/tolerance = 1e-12\n"
P22_T10 = ("gather_interp_generic_f64:tet10", "apply_generic_f64:tet10",
           "restrict_f64")
P22_QUAD = ("gather_interp_generic_f64:quad4", "apply_generic_f64:quad4",
            "restrict_f64")
P22_MIX = P21_HALO + tuple(f"{v}:{e}" for v in ("gather_interp_generic_f64",
                                                "apply_generic_f64")
                           for e in ("hex8", "pyramid5"))


def _one_device_mixed(mesh, dev):
    """MixedTransientRDCSystem in f64 with the drivers' other settings."""
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    return MixedTransientRDCSystem(mesh, 5, pihna_blocks, rtol=3e-11,
                                   precision="f64", precond_refresh=1,
                                   device=dev)


def _p22_shard_cases(tag, h, s, ug, blocks_of, results, also):
    """K8, K6 f64 and K4 f64 (node_gather, rev_gather) at shard s of the
    single-type generic halo system h."""
    elem = tag.split()[-1]
    shim = _shard_shim(h, s)
    cases = {k if k.startswith("restrict") else f"{k}:{elem}": c
             for k, c in generic_cases(f"22a {tag}", shim, ug, blocks_of,
                                       with_restrict=False).items()
             if not k.startswith("apply_generic_f32")}
    V = h.n_vars
    (_, blk, g), = h.shards[s].parts
    u_qp, gq = K.gather_interp_generic_plain(ug, blk.conn_T, blk.phi, g.dphi)
    wfb = blocks_of(u_qp, gq)
    del u_qp, gq
    cases["restrict_f64@" + elem] = restrict_case(
        block_rhs(wfb, blk.phi, g.JxW, g.dphi).reshape(V, -1), shim)
    cases["restrict_f64@" + elem + " diagonal"] = restrict_case(
        block_diag(wfb, blk.phi, g.JxW, g.dphi).reshape(V * V, -1), shim)
    del wfb
    cases[f"restrict_f64@{elem} rev_gather"] = _rev_case(h, s, V)
    say(f"22a {tag} shard", shard=s, E_s=shim.mesh.n_elems,
        Nloc=shim.mesh.n_nodes, No_max=h.plan.No_max, Gtot=h.plan.Gtot,
        C=int(h.shards[s].node_gather.shape[0]),
        Cr=int(h.shards[s].rev_gather.shape[0]))
    run_cases("22a kernel", cases, {}, also, label="halo shard",
              first=results)


def _p22_mixed_shard_cases(h, params, u0, results, also):
    """At the largest shard of the mixed halo system h that holds all
    three blocks: K1, K2, K3 f64 at its TET4 block, K8 and K6 f64 at its
    HEX8 and PYRAMID5 blocks, K4 f64 over its one table over the blocks
    (W = V and the diagonal's V V) and over its rev_gather."""
    blocks_of = lambda uq, gq: pihna_blocks(uq, gq, {}, params)
    V = h.n_vars
    Nloc = h.plan.No_max + h.plan.Gtot
    full = [s for s, sh in enumerate(h.shards) if len(sh.parts) == 3]
    require(bool(full), "22a: no shard holds all three blocks")
    s = max(full, key=lambda i: int(h.plan.elem_counts[i]))
    sh = h.shards[s]
    ug = h.ghost_fill(h.scatter_nodal(u0))[s]
    flats, diags = [], []
    for _, blk, g in sh.parts:
        elem = blk.elem_type.lower()
        shim = _block_shim(blk, g, V, Nloc)
        if blk.affine:
            cases = {k: c for k, c in affine_cases(
                "22a mixed shard tet4", shim, ug, blocks_of).items()
                if k in P21_HALO[:3]}
            u_qp, gx1 = K.gather_interp_affine_plain(ug, blk.conn_T, blk.phi,
                                                     g.dphi)
            gq = gx1[:, None].expand(V, u_qp.shape[1], 3, gx1.shape[-1])
        else:
            cases = {(k if elem == "hex8" else f"{k}:{elem}"): c
                     for k, c in generic_cases(
                         f"22a mixed shard {elem}", shim, ug, blocks_of,
                         with_restrict=False).items()
                     if not k.startswith("apply_generic_f32")}
            u_qp, gq = K.gather_interp_generic_plain(ug, blk.conn_T, blk.phi,
                                                     g.dphi)
        run_cases("22a kernel", cases, {}, also,
                  label=f"halo mixed shard {elem}", first=results)
        wfb = blocks_of(u_qp, gq)
        flats.append(blk.rhs(K.PLAIN_OPS, wfb, g).reshape(V, -1))
        diags.append((block_diag_affine(wfb, blk.phi, g.JxW, g.dphi[None])
                      if blk.affine else block_diag(wfb, blk.phi, g.JxW,
                                                    g.dphi)
                      ).reshape(V * V, -1))
        del wfb, u_qp, gq
    conns = [blk.conn_T for _, blk, _ in sh.parts]
    cases = _restrict_concat("halo mixed shard", torch.cat(flats, 1),
                             sh.node_gather, conns)
    cases.update({k + " diagonal": c for k, c in _restrict_concat(
        "halo mixed shard", torch.cat(diags, 1), sh.node_gather,
        conns).items()})
    cases["restrict_f64@halo mixed shard rev_gather"] = _rev_case(h, s, V)
    say("22a mixed shard", shard=s, Nloc=Nloc, No_max=h.plan.No_max,
        Gtot=h.plan.Gtot, C=int(sh.node_gather.shape[0]),
        Cr=int(sh.rev_gather.shape[0]),
        **{blk.elem_type: blk.conn_T.shape[1] for _, blk, _ in sh.parts})
    run_cases("22a kernel", cases, {}, also, first=results)


def _p22_driver_pair(root, tag, make, argv, dev, steps, outputs, species,
                     res_dir, edit, want, csv_cols=None, species_bar=False):
    """A driver case at parallel/n_devices = 4 and at 1 (`edit` applied to
    both decks): the CSV rows (or their columns csv_cols) within 1e-8
    (rtol, and atol 1e-8 (1 + max)), the 4-shard run on the halo system
    (its processor_ID in the last VTU), the kernels of `want` launched on
    it; each species' largest gap between the two runs' final states over
    1 + its largest value (with species_bar, each <= 1e-8), and each
    run's largest inner iterations and residual, printed.  Returns
    (counts of the 4-shard run, the runs)."""
    import os
    import re

    runs = {}
    for name, extra in (("4 shards", f"parallel/n_devices = {P21_D}\n"),
                        ("one device", "")):
        d = make(os.path.join(root, f"{tag}-{name.split()[0]}"))
        path = os.path.join(d, "input.dat")
        text = edit(open(path).read())
        with open(path, "w") as f:
            f.write(text + P22_DRV_TOL + extra)
        runs[name] = (d,) + _drive_halo(d, dev, argv)

    def results_dir(d):
        return os.path.join(d, res_dir) if res_dir else os.path.join(
            d, next(e for e in os.listdir(d)
                    if os.path.isdir(os.path.join(d, e))))

    d, wall, counts, out, seen = runs["4 shards"]
    res = results_dir(d)
    base = next(f for f in os.listdir(res) if f.endswith(".pvd"))[:-4]
    rows = [_transient_artifacts(results_dir(r[0]), base, outputs, species)
            for r in runs.values()]
    # each species' largest gap over 1 + its largest value (the
    # multi-device bar's measure: rtol and atol 1e-8 (1 + max)), on the
    # final states at full precision (the VTU holds 6 digits)
    finals = [r[4][-1][0].gather(r[4][-1][1]["u"]) for r in runs.values()]
    gaps = {k: float(np.abs(finals[0][:, i] - finals[1][:, i]).max()
                     / (1.0 + np.abs(finals[1][:, i]).max()))
            for i, k in enumerate(species)}
    num = [np.array([[float(x) for x in ln.split(",")] for ln in r[1:]])
           for r in rows]
    cols = slice(None) if csv_cols is None else csv_cols
    scale = 1.0 + np.abs(num[1][:, cols]).max()
    err = float(np.abs(num[0][:, cols] - num[1][:, cols]).max())
    all_err = float(np.abs(num[0] - num[1]).max())
    h = seen[-1][0]
    with open(os.path.join(res, f"{base}-{outputs[-1]}.vtu")) as f:
        pid = re.search(r'Name="processor_ID"[^>]*>\n(.*?)\n', f.read(),
                        re.S).group(1)
    pid = np.array(pid.split(), dtype=np.int64)
    one = runs["one device"]
    scopes = {name: _perf_totals(r[3]) for name, r in runs.items()}
    solves = {name.replace(" ", "_"): (
        max(i for c in r[4] for i in c[2]),
        f"{max(x for c in r[4] for x in c[3]):.3e}")
        for name, r in runs.items()}
    say(f"22 {tag}", steps=steps, seconds_4_shards=f"{wall:.4f}",
        seconds_one_device=f"{one[1]:.4f}",
        **{f"{k.replace(' ', '_')}_s_{name.replace(' ', '_')}":
           f"{t.get(k, 0.0):.4f}" for name, t in scopes.items()
           for k in ("system setup", "solve", "amr", "vtu output")},
        **{f"max_iters_{n}": v[0] for n, v in solves.items()},
        **{f"max_residual_{n}": v[1] for n, v in solves.items()},
        n_elems=h.mesh.n_elems, csv_max_abs_diff=f"{err:.3e}",
        csv_all_columns_max_abs_diff=f"{all_err:.3e}",
        **{f"gap_{k}": f"{v:.3e}" for k, v in gaps.items()},
        processor_ids=len(set(pid.tolist())))
    say(f"22 {tag} launches", **{k: counts[k] for k in want})
    require(np.allclose(num[0][:, cols], num[1][:, cols], rtol=1e-8,
                        atol=1e-8 * scale),
            f"22 {tag}: CSV rows differ by {err:.3e}")
    require(not species_bar or max(gaps.values()) <= 1e-8,
            f"22 {tag}: species gaps {gaps}")
    require(type(h).__name__ == "HaloShardedSystem" and h.plan.D == P21_D
            and h.mesh.elem_type == "MIXED",
            f"22 {tag}: the 4-shard run did not step the mixed halo system")
    require(np.array_equal(pid, h.processor_id),
            f"22 {tag}: the VTU's processor_ID is not the plan's")
    _require_launched(counts, want, f"the 4-shard {tag} driver")
    return counts, runs


def _p22_drivers(dev):
    """(d) the mixed PIHNA driver with one 1:8 AMR pass (its CSV rows
    held; its species printed: the case parts one-device f64 from
    one-device mixed precision by 7e-3 of the scale in 20 steps); (e)
    the mixed ADPM driver at the taxis amplitude 50, 2 steps; each at 4
    shards and at 1."""
    import os
    import re
    import shutil
    import tempfile

    from rdcfes_tpu_torch import cases

    root = tempfile.mkdtemp(prefix="rdcfes_halo_mixed_")
    paths = {}
    try:
        def pihna_edit(text):
            require("refinement_step = 10000" in text
                    and "mesh/AMR/max_steps = 1" in text,
                    "PIHNA case deck changed")
            return text.replace("refinement_step = 10000",
                                f"refinement_step = {P22_DRV_AMR}")

        counts, runs = _p22_driver_pair(
            root, "mixed pihna", lambda d: cases.make_pihna_case(
                d, n=MIX_N, n_steps=P22_DRV_STEPS, mixed=True),
            ["-m", "pihna"], dev, P22_DRV_STEPS,
            (0, 10, 20), PIHNA_SPECIES, "PIHNA_simulation", pihna_edit,
            P22_MIX)
        out = runs["4 shards"][3]
        amr = re.findall(r"AMR step (\d+): adapted to (\d+) elements "
                         r"\((\d+) hanging nodes\)", out)
        h = runs["4 shards"][4][-1][0]
        require(len(amr) == 1 and h.mesh.n_elems == int(amr[0][1])
                and h.plan.has_cons,
                "22d: one 1:8 pass, hanging nodes on the plan")
        say("22d amr", at=amr[0][0], elements=amr[0][1], hanging=amr[0][2],
            Gtot=h.plan.Gtot, No_max=h.plan.No_max)
        paths["halo mixed pihna driver"] = counts

        def adpm_edit(text):
            require(text.count("0.999999e+3") == 2
                    and "output_step = 20" in text, "ADPM case deck changed")
            return text.replace("0.999999e+3", "50.0").replace(
                "output_step = 20", "output_step = 1")

        # the CSV's time and concentrations (1 + 2 per parcellation); its
        # volumes sum the elements whose corners lie in [1e-12, 1e12],
        # and the seed's tails cross 1e-12: any two solves that stop at
        # different points move elements across it
        counts, _ = _p22_driver_pair(
            root, "mixed adpm", lambda d: cases.make_adpm_case(
                d, n=MIX_N, n_steps=P22_ADPM_STEPS, mixed=True),
            ["-m", "adpm"], dev, P22_ADPM_STEPS,
            tuple(range(P22_ADPM_STEPS + 1)), ("PrP", "A_b", "Tau"), None,
            adpm_edit, P22_MIX, csv_cols=slice(0, 5), species_bar=True)
        paths["halo mixed adpm driver"] = counts
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


def phase_halo_ext(dev, card, also):
    """(a) the kernels at a shard of TET10, QUAD4 and the mixed mesh;
    (b) the halo system on TET10 28^3 and QUAD4 512^2 against the
    single-device system, 5 steps each; (c) on the mixed case's mesh
    against MixedTransientRDCSystem in f64, 10 steps; (d, e) the mixed
    PIHNA (AMR) and ADPM drivers at 4 shards and at 1.  D = 4 shards, all
    on `dev`."""
    from rdcfes_tpu_torch.mesh import (box_mixed_mesh, box_quad_mesh,
                                       tet4_to_tet10)

    say("22 card", card=repr(card), shards=P21_D, device=dev)
    results, paths = {}, {}
    t10 = tet4_to_tet10(box_tet_mesh(P22_T10_N, P22_T10_N, P22_T10_N,
                                     bounds=BRAIN))
    quad = box_quad_mesh(P22_QUAD_N, P22_QUAD_N,
                         bounds=((0.0, 150.0), (0.0, 180.0)))
    mixed = box_mixed_mesh(MIX_N, MIX_N, MIX_N, bounds=BRAIN)
    for tag, mesh, variants in (("tet10", t10, P22_T10),
                                ("quad4", quad, P22_QUAD)):
        _, params, u0 = bench_case(mesh)
        blocks_of = lambda uq, gq, p=params: pihna_blocks(uq, gq, {}, p)
        h = _halo(mesh, dev)
        s = int(np.argmax(h.plan.elem_counts))
        ug = h.ghost_fill(h.scatter_nodal(u0))[s]
        _p22_shard_cases(f"halo {tag}", h, s, ug, blocks_of, results, also)
        del ug
        paths[f"halo {tag}"] = _p21_steps(f"22b {tag}", mesh, params, u0,
                                          P22_STEPS, dev, variants,
                                          iter_gap=2, h=h)
        del h
    _, params, u0 = bench_case(mixed)
    h = _halo(mixed, dev)
    _p22_mixed_shard_cases(h, params, u0, results, also)
    paths["halo mixed"] = _p21_steps("22c mixed", mixed, params, u0,
                                     P22_MIX_STEPS, dev, P22_MIX,
                                     one_device=_one_device_mixed,
                                     iter_gap=2, h=h)
    del h
    paths.update(_p22_drivers(dev))
    return results, paths

# ----------------------------------------------------------------------
# phase 23: the moving mesh on 4 shards and the solid's halo Newton
# ----------------------------------------------------------------------
P23_HCC_N, P23_STEPS, P23_DRV_STEPS = 28, 5, 10
# the f64 pair of a driver: the tangent and the Krylov in f64 in both
# runs, and (P23_NEWTON) full Newton steps (the halo Newton carries no
# modified Newton) stopped by the residual rule alone: the decks' step
# rules (1e-3 HCC, 1e-6 solid) stop where the two runs' inexact linear
# solves still part by ~1e-5 of u_z (HCC n = 28) and VM (solid 48^3),
# and the solid's VM, a gradient on h = 1/48 times E = 1e3, needs its
# residual at 1e-12 (one Newton iteration more, ~1e-14; the f64 floor is
# ~2e-15 on 16^3): the same deck in both runs
P23_F64_DECK = ("solver/nonlinear/tangent_precision = f64\n"
                "solver/linear/precision = f64\n")
P23_NEWTON = {"hcc": (("relative_step_tolerance = 1.e-3",
                       "relative_step_tolerance = 1.e-12"),
                      ("relative_residual_tolerance = 1.e-6",
                       "relative_residual_tolerance = 1.e-8")),
              "solid": (("relative_step_tolerance = 1e-6",
                         "relative_step_tolerance = 1e-12"),
                        ("relative_residual_tolerance = 1e-6",
                         "relative_residual_tolerance = 1e-12"),
                        ("reuse_tangent = true", "reuse_tangent = false"))}
P23_OPTS = NewtonOptions(max_nonlinear_iterations=20,
                         relative_residual_tolerance=1e-8,
                         linear_precision="f64")
P23_MOVING = {"tet4": P21_HALO, "mixed": P22_MIX}


def _k4_case(flat, table, n_out, tol=1.2e-15):
    """K4 over `table` (C, n_out) on flat (W, M), beside index_add_ onto
    the targets the table inverts."""
    W, dt, dev = flat.shape[0], flat.dtype, flat.device
    targets = _flat_targets(table, flat.shape[1])
    return dict(
        kern=lambda: K.restrict(flat, table),
        plain=lambda: K.restrict_plain(flat, table), tol=tol,
        library=lambda: torch.zeros((W, n_out), dtype=dt, device=dev
                                    ).index_add_(1, targets, flat),
        n_bytes=restrict_bytes(flat, table, n_out),
        flops=float(W * int((table < flat.shape[1]).sum())), dtype=dt)


def _p23_solid_kernels(S4, x, results, also):
    """(a) K4 f64 at the largest shard of the halo solid S4 at positions
    x (N, 3): over its node_gather (the residual, W = 3; the diagonal
    blocks, W = 9), over its face group's fgather (W = 3) and over its
    rev_gather (W = 3, 9); and the shard's batched Ke product."""
    from rdcfes_tpu_torch.systems.transient import ElementBlock

    h = S4._halo
    s = int(np.argmax(h.plan.elem_counts))
    sh = h.shards[s]
    xg = h.ghost_fill(h.scatter_nodal(x.cpu().numpy()))[s]
    pt = h._pt(SOLID_PT, sh)
    (Fe, Ke), = h._elements(sh, xg, pt, True)
    K_ = Ke.shape[2]
    Nloc = h.plan.No_max + h.plan.Gtot
    diag = torch.stack([Ke[:, :, i, i, :] for i in range(K_)], dim=2)
    cases = {
        "restrict_f64@solid shard residual": _k4_case(
            Fe.reshape(3, -1).contiguous(), sh.node_gather, Nloc),
        "restrict_f64@solid shard diagonal": _k4_case(
            diag.reshape(9, -1).contiguous(), sh.node_gather, Nloc),
    }
    for fg in sh.faces:
        Rf, _ = h._face_terms(fg, xg, pt)
        cases[f"restrict_f64@solid shard faces {fg['face_type']}"] = \
            _k4_case(Rf.reshape(3, -1).contiguous(), fg["fgather"], Nloc)
    for W, what in ((3, ""), (9, " diagonal")):
        cases[f"restrict_f64@solid shard rev_gather{what}"] = _rev_case(
            h, s, W, tol=1.2e-15)
    say("23a solid shard", shard=s, E_s=Fe.shape[-1], Nloc=Nloc,
        No_max=h.plan.No_max, Gtot=h.plan.Gtot,
        faces=sum(fg["conn"].shape[0] for fg in sh.faces),
        C=sh.node_gather.shape[0], Cr=sh.rev_gather.shape[0])
    run_cases("23a kernel", cases, {}, also, label="", first=results)
    # the shard matvec's batched element product: a library call
    blk = sh.blocks[0]["block"]
    KeB = ElementBlock.batched(Ke)
    del Fe, Ke, diag
    u = torch.rand((3, Nloc), dtype=F64, device=sh.device)
    E = KeB.shape[0]
    ms = cuda_ms(lambda: blk.dense_apply(KeB, u))
    say("23a Ke product", call="torch.bmm (E, 3K, 3K) x (E, 3K, 1)", E=E,
        ms=f"{ms:.4f}", **bound(nbytes(KeB) + 2 * 3 * K_ * E * 8,
                                2.0 * E * (3 * K_) ** 2, F64))


def _p23_solid(dev, results, also):
    """(a) at the halo solid's largest shard, then (b) one load step of
    the halo solid against the single-device one."""
    mesh = box_hex_mesh(SOLID_N, SOLID_N, SOLID_N)
    kw = dict(materials=SOLID_MATERIALS, bcs=SOLID_BCS, penalty=1.0e6,
              newton=P23_OPTS, tangent_precision="f64", device=dev)
    t0 = time.perf_counter()
    S4 = SolidSystem(mesh, device_mesh=P21_D, **kw)
    setup4 = time.perf_counter() - t0
    rng = np.random.default_rng(23)
    x = S4.initial_positions() + torch.as_tensor(
        0.05 / SOLID_N * rng.standard_normal((mesh.n_nodes, 3)), dtype=F64,
        device=dev)
    _p23_solid_kernels(S4, x, results, also)
    del x
    S1 = SolidSystem(mesh, **kw)
    x0 = S1.initial_positions()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r1 = S1.run_solver(x0, SOLID_PT)
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    K.reset_launch_counts()
    t0 = time.perf_counter()
    r4 = S4.run_solver(x0, SOLID_PT)
    torch.cuda.synchronize()
    t4 = time.perf_counter() - t0
    counts = K.launch_counts()
    rel = rel_l2(r4.x, r1.x.cpu().numpy())
    p = S4._halo.plan
    say("23b solid", n_elems=mesh.n_elems, n_nodes=mesh.n_nodes,
        rel_l2=f"{rel:.3e}", bar=1e-8, newton_4_shards=r4.iters,
        newton_one_device=r1.iters, inner_4_shards=r4.linear_iters,
        inner_one_device=r1.linear_iters,
        s_load_step_4_shards=f"{t4:.4f}",
        s_load_step_one_device=f"{t1:.4f}",
        setup_s_4_shards=f"{setup4:.4f}", converged=(r1.converged,
                                                     r4.converged))
    _p21_plan("23b solid", S4._halo, W=3)
    say("23b solid launches", **{k: counts.get(k, 0) for k in
                                 ("restrict_f64", "ell_matvec_f64",
                                  "ell_matvec_f32", "restrict_f32")})
    require(r1.converged and r4.converged, "23b: a load step diverged")
    require(rel <= 1e-8, f"23b: halo solid vs one device {rel:.3e}")
    require(not any(counts.get(k, 0) for k in ("ell_matvec_f64",
                                               "ell_matvec_f32")),
            "23b: K5 launched by the halo Newton")
    _require_launched(counts, ("restrict_f64",), "the halo Newton")
    return counts


def _p23_hcc_case(root, name, mixed=False):
    """make_hcc_case(n=28) (TET4) or its mixed case in root/name: (dir,
    mesh, u0)."""
    import os

    from rdcfes_tpu_torch import cases
    from rdcfes_tpu_torch.mesh import gmsh

    d = cases.make_hcc_case(os.path.join(root, name), n=P23_HCC_N,
                            n_steps=P23_DRV_STEPS, n_loading=1, mixed=mixed)
    mesh = gmsh.read(os.path.join(d, "HCC_Model.msh"))
    u0 = np.loadtxt(os.path.join(d, "HCC_Initial_Nodal_Field.dat"))
    return d, mesh, u0


def _p23_moving(dev, root):
    """(c) the moving halo system against the single-device moving system
    on the HCC case's TET4 mesh and the mixed case's mesh: P23_STEPS
    steps each at a smooth displacement, after a warm-up step."""
    from rdcfes_tpu_torch.models.hcc import hcc_blocks
    from rdcfes_tpu_torch.parallel import HaloShardedSystem
    from rdcfes_tpu_torch.systems import MixedTransientRDCSystem

    paths = {}
    for tag in ("tet4", "mixed"):
        _, mesh, u0 = _p23_hcc_case(root, f"moving_{tag}", tag == "mixed")
        size = float(np.ptp(mesh.coords))
        x = torch.as_tensor(size * _moved(mesh.coords / size, 23, 0.02),
                            dtype=F64, device=dev)
        kw = dict(rtol=3e-11, moving_mesh=True, device=dev)
        h = HaloShardedSystem(mesh, 3, P21_D, hcc_blocks, **kw)
        one = (MixedTransientRDCSystem if tag == "mixed" else
               TransientRDCSystem)(mesh, 3, hcc_blocks, precision="f64",
                                   **kw)
        a, b = h.initial_state(u0), one.initial_state(u0)
        h.step(a, params=HCC_LIVE, coords=x)
        one.step(b, params=HCC_LIVE, coords=x)
        worst, rels, its_h, its_1, t_h, t_1 = 0.0, [], [], [], 0.0, 0.0
        counts = {}
        for _ in range(P23_STEPS):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            a, ih, rh = h.step(a, params=HCC_LIVE, coords=x)
            torch.cuda.synchronize()
            t_h += time.perf_counter() - t0
            for k, v in K.launch_counts().items():
                counts[k] = counts.get(k, 0) + v
            t0 = time.perf_counter()
            b, i1, _ = one.step(b, params=HCC_LIVE, coords=x)
            torch.cuda.synchronize()
            t_1 += time.perf_counter() - t0
            ua, ub = h.gather(a["u"]), b["u"].cpu().numpy()
            r = float(np.linalg.norm(ua - ub) / np.linalg.norm(ub))
            rels.append(f"{r:.3e}")
            worst = max(worst, r)
            its_h.append(int(ih))
            its_1.append(int(i1))
            require(float(rh) <= 3e-11, f"23c {tag}: residual {float(rh)}")
        require(np.isfinite(ua).all(), f"23c {tag}: state not finite")
        say(f"23c moving {tag}", steps=P23_STEPS, n_nodes=mesh.n_nodes,
            n_elems=mesh.n_elems, rel_l2="/".join(rels), bar=1e-8,
            halo_steps_per_s=f"{P23_STEPS / t_h:.4f}",
            one_device_steps_per_s=f"{P23_STEPS / t_1:.4f}",
            halo_iters="/".join(map(str, its_h)),
            one_device_iters="/".join(map(str, its_1)))
        _p21_plan(f"23c moving {tag}", h, W=3)
        say(f"23c moving {tag} launches",
            **{k: counts.get(k, 0) for k in P23_MOVING[tag]})
        require(worst <= 1e-8, f"23c {tag}: halo vs one device {worst:.3e}")
        _require_launched(counts, P23_MOVING[tag],
                          f"the moving halo {tag} step")
        paths[f"moving halo {tag}"] = counts
        del h, one, a, b
    return paths


def _p23_driver_pair(root, tag, argv, make_case, fields, dev):
    """A driver at parallel/n_devices = 4 and without: the last frame's
    `fields` as handed to the VTU writer, within 1e-8; the halo systems'
    calls in the 4-shard run; both runs' scopes.  Returns the 4-shard
    run's launches."""
    import os
    import re

    from rdcfes_tpu_torch.io.vtu import ParaviewWriter
    from rdcfes_tpu_torch.parallel import HaloShardedSystem, HaloSolidSystem

    runs = {}
    saved = [(c, m, getattr(c, m)) for c, m in (
        (ParaviewWriter, "update_pvd"), (HaloShardedSystem, "run_steps"),
        (HaloSolidSystem, "run_solver"))]
    for run, extra in (("4 shards", f"parallel/n_devices = {P21_D}\n"),
                       ("one device", "")):
        d = make_case(os.path.join(root, f"{tag} {run.split()[0]}"))
        path = os.path.join(d, "input.dat")
        deck = open(path).read()
        for old, new in P23_NEWTON[tag]:
            require(old in deck, f"23d {tag}: no {old!r} in the deck")
            deck = deck.replace(old, new)
        with open(path, "w") as f:
            f.write(deck + P23_F64_DECK + extra)
        frames, calls = [], {}

        def record(orig, name):
            def rec(self, *a, **kw):
                if name == "update_pvd":
                    frames.append({n: np.array(v, dtype=np.float64)
                                   for n, v in a[0]})
                else:
                    calls[name] = calls.get(name, 0) + 1
                return orig(self, *a, **kw)
            return rec

        for c, m, orig in saved:
            setattr(c, m, record(orig, m))
        try:
            wall, counts, out = _drive(d, list(argv), dev)
        finally:
            for c, m, orig in saved:
                setattr(c, m, orig)
        runs[run] = (wall, counts, out, frames[-1], calls)
    a, b = runs["4 shards"][3], runs["one device"][3]
    errs = {}
    for k in fields:
        scale = 1.0 + float(np.abs(b[k]).max())
        errs[k] = float(np.abs(a[k] - b[k]).max())
        require(np.allclose(a[k], b[k], rtol=1e-8, atol=1e-8 * scale),
                f"23d {tag}: {k} differs by {errs[k]:.3e}")
    calls = runs["4 shards"][4]
    require(calls.get("run_solver", 0) > 0 and (
        tag == "solid" or calls.get("run_steps", 0) > 0),
        f"23d {tag}: the 4-shard run did not go through the halo systems")
    require(runs["one device"][4] == {},
            f"23d {tag}: the one-device run went through a halo system")
    scopes = ("rds solve", "solid solve") if tag == "hcc" else (
        "newton solve",)
    say(f"23d {tag} driver", **{
        f"seconds_{r.split()[0]}": f"{v[0]:.4f}" for r, v in runs.items()},
        **{f"{k.replace(' ', '_')}_s_{r.split()[0]}":
           f"{_perf_totals(v[2]).get(k, 0.0):.4f}"
           for r, v in runs.items() for k in scopes},
        **{f"{k}_max_abs_diff": f"{e:.3e}" for k, e in errs.items()},
        halo_calls="/".join(f"{k}={v}" for k, v in sorted(calls.items())),
        newton="/".join(f"{r.split()[0]}:" + ",".join(
            re.findall(r"Newton: (\d+) iterations", v[2]))
            for r, v in runs.items()))
    return runs["4 shards"][1]


def _p23_drivers(dev, root):
    """(d) `-c hcc` on make_hcc_case(n=28), P23_DRV_STEPS steps and one
    load step, and `-s` on phase 13's solid deck, 2 load steps, each at
    4 shards and on one device."""
    import os

    from rdcfes_tpu_torch.mesh import gmsh

    def solid_case(d):
        os.makedirs(d)
        gmsh.write(box_hex_mesh(SOLID_N, SOLID_N, SOLID_N),
                   os.path.join(d, "input.msh"))
        with open(os.path.join(d, "input.dat"), "w") as f:
            f.write(DRV_SOLID_DECK)
        return d

    paths = {"hcc halo driver": _p23_driver_pair(
        root, "hcc", ("-c", "hcc"),
        lambda d: _p23_hcc_case(os.path.dirname(d),
                                os.path.basename(d))[0],
        ("c", "u_z", "VM"), dev)}
    paths["solid halo driver"] = _p23_driver_pair(
        root, "solid", ("-s",), solid_case, ("u_z", "VM"), dev)
    _require_launched(paths["hcc halo driver"], P21_HALO + ("restrict_f64",),
                      "the 4-shard HCC driver")
    return paths


def phase_halo_solid(dev, card, also):
    """(a, b) the solid's halo Newton on the solid bench mesh, (c) the
    moving halo system on the HCC meshes, (d) the HCC and solid drivers
    at 4 shards and on one device.  D = 4 shards, all on `dev`."""
    import shutil
    import tempfile

    say("23 card", card=repr(card), shards=P21_D, device=dev)
    results, paths = {}, {}
    t0 = time.perf_counter()
    paths["halo solid"] = _p23_solid(dev, results, also)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="rdcfes_p23_")
    try:
        paths.update(_p23_moving(dev, root))
        paths.update(_p23_drivers(dev, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("23 done", seconds=f"{time.perf_counter() - t0:.4f}")
    return results, paths


# ----------------------------------------------------------------------
# phase 24: the replicated-iterate system (parallel.sharding), D shards
# on one card, and the block-CSR helpers
# ----------------------------------------------------------------------
P24_D, P24_STEPS, P24_HEX_N, P24_RTOL = 4, 3, 24, 1e-12


def _p24_system(mesh, dev, ops=K.KERNEL_OPS):
    from rdcfes_tpu_torch.models.pihna import pihna_physics
    from rdcfes_tpu_torch.parallel import ShardedTransientSystem

    return ShardedTransientSystem(mesh, 5, pihna_physics, P24_D,
                                  rtol=P24_RTOL, device=dev, ops=ops)


def _p24_kernels(tag, S, u0, params, results, also):
    """(a) at shard 0 of S (Eb real elements, the most any shard holds):
    the gather (K1 on TET4, K8 on HEX8) of the replicated state, and K4
    over the shard's (C, N) table for the right-hand side, the
    block-Jacobi diagonal and a matvec's element products, each against
    its plain version, index_add_ beside K4."""
    from types import SimpleNamespace as NS

    sh = S.shards[0]
    blk, g = sh.blk, sh.geom
    V, N = S.n_vars, S.mesh.n_nodes
    Kc, Eb = blk.conn_T.shape
    Q = g.JxW.shape[0]
    u = S.initial_state(u0).T.contiguous()
    args = (u, blk.conn_T, blk.phi, g.dphi)
    if blk.affine:
        name, kern, plain = ("gather_interp_affine_f64",
                             K.gather_interp_affine,
                             K.gather_interp_affine_plain)
        flops = 2.0 * V * Kc * Eb * (Q + 3)
    else:
        name, kern, plain = (f"gather_interp_generic_f64@{tag}",
                             K.gather_interp_generic,
                             K.gather_interp_generic_plain)
        flops = 2.0 * 4 * V * Q * Kc * Eb
    cases = {name: dict(kern=lambda: kern(*args), plain=lambda: plain(*args),
                        tol=1e-13, n_bytes=nbytes(*args[:2], g.dphi,
                                                  *plain(*args)),
                        flops=flops)}
    Fe, Ke, diag_e = S.element_kernels(0, u, {}, params)
    ye = blk.dense_apply(blk.batched(Ke), u)  # the operator on u
    del Ke
    shim = NS(node_gather=sh.node_gather, conn_T=blk.conn_T,
              mesh=NS(n_nodes=N))
    for what, flat, W in (("rhs", Fe, V), ("diagonal", diag_e, V * V),
                          ("matvec", ye, V)):
        cases[f"restrict_f64@{tag} {what}"] = restrict_case(
            flat.reshape(W, -1).contiguous(), shim)
    say(f"24a {tag} shard", shard=0, D=S.n_shards, Eb=Eb,
        E=S.mesh.n_elems, N=N, K=Kc, Q=Q, C=sh.node_gather.shape[0])
    run_cases("24a kernel", cases, {}, also, label="sharded", first=results)


def _p24_steps(mesh, params, u0, dev, card):
    """(b) P24_STEPS steps of ShardedTransientSystem (PIHNA, f64, rtol
    1e-12) against the single-device dense f64 system from the same
    state: step 1 within 3e-8 of each species' scale, every step within
    1e-4, every residual < 1e-10, K1 and K4 launched over the sharded
    steps alone; steps/s of both.  Returns (the sharded steps' launches,
    the single-device system)."""
    from rdcfes_tpu_torch.models.pihna import pihna_physics

    S = _p24_system(mesh, dev)
    one = TransientRDCSystem(mesh, 5, physics=pihna_physics,
                             precision="f64", rtol=P24_RTOL,
                             precond_refresh=1, device=dev)
    u, st = S.initial_state(u0), one.initial_state(u0)
    counts, gaps, its, its1, ress = {}, [], [], [], []
    t_s = t_1 = 0.0
    for i in range(P24_STEPS):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        u, it, res = S.step(u, params=params)
        torch.cuda.synchronize()
        t_s += time.perf_counter() - t0
        for k, v in K.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        t0 = time.perf_counter()
        st, it1, _ = one.step(st, params=params)
        torch.cuda.synchronize()
        t_1 += time.perf_counter() - t0
        a, b = u.cpu().numpy(), st["u"].cpu().numpy()
        gaps.append(max(float(np.abs(a[:, v] - b[:, v]).max()
                              / max(np.abs(b[:, v]).max(), 1e-300))
                        for v in range(5)))
        its.append(it)
        its1.append(int(it1))
        ress.append(float(res))
        require(ress[-1] < 1e-10, f"24b step {i + 1}: residual "
                f"{ress[-1]:.3e}")
    require(np.isfinite(a).all() and (a >= 0).all(),
            "24b: state not finite and >= 0")
    say("24b sharded", card=repr(card), D=P24_D, steps=P24_STEPS,
        worst_species_gap="/".join(f"{x:.3e}" for x in gaps),
        bars="3e-8 (step 1), 1e-4", residuals="/".join(
            f"{x:.3e}" for x in ress),
        sharded_iters="/".join(map(str, its)),
        one_device_iters="/".join(map(str, its1)),
        sharded_steps_per_s=f"{P24_STEPS / t_s:.4f}",
        one_device_steps_per_s=f"{P24_STEPS / t_1:.4f}",
        n_nodes=mesh.n_nodes, n_elems=mesh.n_elems, Eb=S.Eb)
    say("24b launches", **{k: counts.get(k, 0) for k in
                           ("gather_interp_affine_f64", "restrict_f64")})
    require(gaps[0] <= 3e-8, f"24b step 1: {gaps[0]:.3e} of a species' "
            f"scale from one device")
    require(max(gaps) <= 1e-4, f"24b: {max(gaps):.3e} of a species' "
            f"scale from one device")
    _require_launched(counts, ("gather_interp_affine_f64", "restrict_f64"),
                      "the sharded steps")
    return counts, one


def _p24_bcsr(dev, one, params, u0, results, also):
    """(c) the block-CSR helpers on the bench mesh's node-pair sparsity,
    with the PIHNA operator and right-hand side of one step
    (TransientRDCSystem.assemble): K4 over the rows' table against its
    plain version (index_add_ beside it), bcsr_matvec through K4
    against the plain matvec (1e-13), solve_bcsr (BiCGStab, block
    Jacobi, rtol 1e-12) through K4 against the plain solve (relative L2
    1e-10, residual <= 1e-10), each solve timed after a warm-up one.
    Returns the timed kernel solve's launches."""
    from rdcfes_tpu_torch.fem.assembly import scatter_table
    from rdcfes_tpu_torch.fem.bcsr import bcsr_matvec
    from rdcfes_tpu_torch.solvers.krylov import solve_bcsr

    u_T = torch.as_tensor(u0.T, device=dev)
    values, b = one.assemble(u_T, {}, params)
    sp = one.sp
    V, N = b.shape
    cols = torch.as_tensor(sp.cols, device=dev).long()
    rows = torch.as_tensor(sp.rows, device=dev).long()
    prod = torch.einsum("vws,ws->vs", values, u_T[:, cols]).contiguous()
    table = scatter_table(sp.rows, N, dev)
    run_cases("24c kernel", {"restrict_f64@bcsr rows": dict(
        kern=lambda: K.restrict(prod, table),
        plain=lambda: K.restrict_plain(prod, table), tol=1e-13,
        library=lambda: torch.zeros((V, N), dtype=F64, device=dev
                                    ).index_add_(1, rows, prod),
        n_bytes=restrict_bytes(prod, table, N), flops=float(V * sp.nnz))},
        {}, also, label="sharded", first=results)
    y = bcsr_matvec(values, sp.rows, cols, u_T, N)
    mv_err = _err(y, bcsr_matvec(values, sp.rows, cols, u_T, N,
                                 ops=K.PLAIN_OPS))[1]

    def solve(ops):
        """A warm-up solve, then one timed: (result, seconds, launches)."""
        solve_bcsr(values, sp, b, rtol=1e-12, ops=ops)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        r = solve_bcsr(values, sp, b, rtol=1e-12, ops=ops)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, K.launch_counts()

    rk, t_k, counts = solve(K.KERNEL_OPS)
    rp, t_p, _ = solve(K.PLAIN_OPS)
    gap = rel_l2(rk.x, rp.x)
    say("24c bcsr", nnz=sp.nnz, C=table.shape[0], matvec_rel_err=
        f"{mv_err:.3e}", iters=rk.iters, plain_iters=rp.iters,
        residual=f"{float(rk.residual):.3e}", rel_l2_to_plain=f"{gap:.3e}",
        solve_s=f"{t_k:.4f}", plain_solve_s=f"{t_p:.4f}",
        restrict_launches=counts.get("restrict_f64", 0))
    require(mv_err <= 1e-13, f"24c: bcsr_matvec {mv_err:.3e} from plain")
    require(float(rk.residual) <= 1e-10,
            f"24c: solve_bcsr residual {float(rk.residual):.3e}")
    require(gap <= 1e-10, f"24c: solve_bcsr {gap:.3e} from the plain solve")
    _require_launched(counts, ("restrict_f64",), "solve_bcsr")
    return counts


def phase_sharded(dev, card, also):
    """(a) the kernels at shard 0 of the PIHNA bench mesh and of HEX8
    box_hex_mesh(24); (b) the sharded system against the single-device
    dense system, 3 steps; (c) bcsr_matvec and solve_bcsr on the bench
    mesh's sparsity.  D = 4 shards, all on `dev`."""
    say("24 card", card=repr(card), shards=P24_D, device=dev)
    mesh, params, u0 = bench_case()
    hex_mesh = box_hex_mesh(P24_HEX_N, P24_HEX_N, P24_HEX_N, bounds=BRAIN)
    results, paths = {}, {}
    _p24_kernels("tet4", _p24_system(mesh, dev), u0, params, results, also)
    _p24_kernels("hex8", _p24_system(hex_mesh, dev),
                 bench_case(hex_mesh)[2], params, results, also)
    paths["sharded"], one = _p24_steps(mesh, params, u0, dev, card)
    paths["sharded bcsr"] = _p24_bcsr(dev, one, params, u0, results, also)
    return results, paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,"
                    "18,19,20,21,22,23,24",
                    help="comma-separated phases to run (default: all)")
    phases = {int(x) for x in ap.parse_args(argv).phases.split(",")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls, t_lap = {}, [time.perf_counter()]
    dev, card = phase_device()
    oracle = []  # 20e's oracle process, started after the build
    try:
        return _run(phases, dev, card, walls, t_lap, oracle)
    finally:
        for proc, _, _ in oracle:
            if proc.is_alive():
                proc.kill()
                proc.join()


def _run(phases, dev, card, walls, t_lap, oracle) -> int:
    """The phases of `phases`, then the walls, the card and the JSON
    lines; `oracle` receives 20e's oracle process, which runs on the
    host beside phases 2-20."""

    def lap(name):
        """The wall seconds since the last lap, under the phases run."""
        t = time.perf_counter()
        walls[name] = round(t - t_lap[0], 1)
        t_lap[0] = t

    if 1 in phases:
        phase_build()
    if 20 in phases:
        oracle.append(start_adpm_oracle())
    lap("0-1")
    also = {}  # variant -> {shape label: row}, beside its first row
    kern = phase_kernels(dev, also) if 2 in phases else {}
    lap("2")
    if 3 in phases:
        phase_oracle(dev)
    if 4 in phases:
        phase_paths(dev)
    paths = {"transient": phase_slice(dev) if 5 in phases else {}}
    lap("3-5")
    S = (make_solid(SOLID_N, dev, SOLID_BENCH_OPTS, "f32")
         if phases & {6, 8} else None)
    solid_kern = phase_solid_kernels(dev, S) if 6 in phases else {}
    if 7 in phases:
        phase_solid_paths(dev)
    paths["solid"] = phase_solid_slice(dev, S) if 8 in phases else {}
    del S
    lap("6-8")
    H = (make_system(box_hex_mesh(HEX_N, HEX_N, HEX_N, bounds=BRAIN), dev)
         if phases & {9, 12} else None)
    gen_kern = phase_generic_kernels(dev, H, also) if 9 in phases else {}
    if 10 in phases:
        fits, paths["calibration"] = phase_calibration(dev)
    if 11 in phases:
        phase_generic_paths(dev)
    if 12 in phases:
        paths.update(phase_generic_slice(dev, H))
    del H
    lap("9-12")
    if 13 in phases:
        paths["drivers"] = phase_drivers(dev, also)
    lap("13")
    if 14 in phases:
        paths["coupled"] = phase_coupled(dev, also)
    lap("14")
    if 15 in phases:
        paths.update(phase_amr(dev, also))
    lap("15")
    mix_kern = {}
    if 16 in phases:
        mix_kern, mix_paths = phase_mixed(dev, also)
        paths.update(mix_paths)
    lap("16")
    p17_kern = {}
    if 17 in phases:
        p17_kern, p17_paths = phase_mixed_drivers(dev, also)
        paths.update(p17_paths)
    lap("17")
    p18_kern = {}
    if 18 in phases:
        p18_kern, p18_paths = phase_solid_ext(dev, also)
        paths.update(p18_paths)
    lap("18")
    p19_kern = {}
    if 19 in phases:
        p19_kern, p19_paths = phase_slice6(dev, also)
        paths.update(p19_paths)
    lap("19")
    p20_kern = {}
    if 20 in phases:
        p20_kern, p20_paths = phase_f32(dev, also, oracle[0])
        paths.update(p20_paths)
    lap("20")
    p21_kern = {}
    if 21 in phases:
        p21_kern, p21_paths = phase_halo(dev, card, also)
        paths.update(p21_paths)
    lap("21")
    p22_kern = {}
    if 22 in phases:
        p22_kern, p22_paths = phase_halo_ext(dev, card, also)
        paths.update(p22_paths)
    lap("22")
    p23_kern = {}
    if 23 in phases:
        p23_kern, p23_paths = phase_halo_solid(dev, card, also)
        paths.update(p23_paths)
    lap("23")
    p24_kern = {}
    if 24 in phases:
        p24_kern, p24_paths = phase_sharded(dev, card, also)
        paths.update(p24_paths)
    lap("24")
    say("walls", **walls, total=round(sum(walls.values()), 1))
    rows = []
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    k5_keys = ("flushed_ms", "b2b_ms")  # K5's rows only
    for name, (src, replaces) in KERNELS.items():
        # every path that ran, with its zeros
        by_path = {p: c.get(name, 0) for p, c in paths.items() if c}
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(by_path.values()) if by_path else None,
               "launches_by_path": by_path}
        first = (kern.get(name) or solid_kern.get(name)
                 or gen_kern.get(name) or mix_kern.get(name)
                 or p17_kern.get(name) or p18_kern.get(name)
                 or p19_kern.get(name) or p20_kern.get(name)
                 or p21_kern.get(name) or p22_kern.get(name)
                 or p23_kern.get(name) or p24_kern.get(name) or {})
        row.update({k: first.get(k) for k in keys})
        row.update({k: first[k] for k in k5_keys if k in first})
        if name in kern and name in solid_kern:
            also.setdefault(name, {})["solid assembly"] = solid_kern[name]
        if name in also:
            row["also"] = {tag: {k: r[k] for k in keys + k5_keys if k in r}
                           for tag, r in also[name].items()}
        rows.append(row)
    print(card, flush=True)  # again beside the results, for a cut log
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
