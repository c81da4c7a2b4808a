"""Shared pieces of tests/test_torch_*.py: the reference's jit compiles
kept cheap, and its element functions turned into a dense direct solve of
one transient step."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from rdcfes_tpu.fem import assembly as jasm
from rdcfes_tpu.fem import weakform as jwf
from rdcfes_tpu.models.adpm import default_params

NO_CLAMP = lambda u: u  # the ADPM tests clamp nothing; PrP stays ~1


@contextlib.contextmanager
def quick_compile():
    """Compile the reference's jitted programs without XLA's expensive
    optimization passes.  The programs are unrolled over q, k and d, so
    their compile time, not their run time on these tiny meshes, is what a
    fixture costs; the results move at round-off class, far inside the
    1e-10 bars of the step comparisons."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def reference_direct_step(jsys, blocks_fn, u, fields, params, copies=0):
    """One linearized-CN step of the reference system `jsys` from the
    nodal state u (N, V), solved DIRECTLY: the right-hand side and the
    operator come from the reference's own qp-path functions
    (interpolate_ue, the model's blocks, block_rhs, qp_apply, _restrict:
    the CPU path of rdcfes_tpu/systems/transient.py:813-872), applied
    eagerly, and the dense system goes to LAPACK.  Returns the unclamped
    solution (N, V): what the reference's Krylov solve converges to,
    without compiling its step program.

    The operator meets every unit vector in ONE application: the mesh is
    laid out B = V N times side by side (connectivity and gather table
    shifted per copy, geometry and element fields tiled along the element
    axis), every copy carries the state u for the coefficient build, and
    copy j carries unit vector j for the apply.  Build and apply then
    run on arrays of the same shapes, so each eager primitive compiles
    once; `copies` > V N pads B, so that systems with different V N share
    shapes, and compiles, too."""
    V, N = jsys.n_vars, jsys.mesh.n_nodes
    phi = jsys.phi
    conn_T = np.asarray(jsys.conn_T)
    K, E = conn_T.shape
    B = max(V * N, int(copies))
    copy = np.arange(B)
    tile = lambda a, axis=-1: jnp.tile(
        a, tuple(B if i == axis % a.ndim else 1 for i in range(a.ndim)))
    JxW, dphi = tile(jsys.JxW), tile(jsys.dphi)
    conn = jnp.asarray((conn_T[:, None, :] + (copy * N)[None, :, None]
                        ).reshape(K, B * E))
    # flat (k, e) index k E + e -> k (B E) + (j E + e); the pad K E -> K B E
    ng = np.asarray(jsys.node_gather)
    ng = jnp.asarray(np.where(
        ng[:, None, :] == K * E, K * B * E,
        (ng // E)[:, None, :] * (B * E) + copy[None, :, None] * E
        + (ng % E)[:, None, :]).reshape(ng.shape[0], B * N))
    big_fields = {k: tile(v, 0) if getattr(v, "ndim", 0) == 2 else v
                  for k, v in fields.items()}  # (E, .) element fields

    u_qp, grad_qp = jasm.interpolate_ue(tile(jnp.asarray(u).T)[:, conn],
                                        phi, dphi)
    wfb = blocks_fn(u_qp, grad_qp, big_fields, params)
    b = jsys._restrict(jwf.block_rhs(wfb, phi, JxW, dphi).reshape(V, -1),
                       ng)[:, :N]
    X = np.zeros((V, B, N))
    unit = np.arange(V * N)
    X[unit // N, unit, unit % N] = 1.0
    x_qp, gx_qp = jasm.interpolate_ue(
        jnp.asarray(X.reshape(V, B * N))[:, conn], phi, dphi)
    Ye = jwf.qp_apply(wfb, phi, JxW, dphi, x_qp, gx_qp)
    Y = jsys._restrict(Ye.reshape(V, -1), ng)
    A = np.asarray(Y).reshape(V, B, N)[:, :V * N].transpose(0, 2, 1)
    A = A.reshape(V * N, V * N)
    # row equilibration: species scales span many orders
    s = 1.0 / np.abs(A).max(axis=1)
    x = np.linalg.solve(A * s[:, None], np.asarray(b).reshape(-1) * s)
    return x.reshape(V, N).T


def adpm_params(kind):
    """ADPM decks of the port's tests, as plain floats."""
    p = default_params()
    if kind == "all":  # every ADPM term active (the oracle parity deck)
        p.update(dt=0.05, decay_PrP=1e-4, decay_PrP_pulse0=0.01,
                 decay_PrP_pulse1=10.0, decay_PrP_time_exponent=1.0,
                 diffuse_A_b=0.05, taxis1_A_b=0.5, taxis2_A_b=0.2,
                 produce_A_b=0.3, produce_A_b_s0=0.2, produce_A_b_s1=0.8,
                 transform_A_b=0.1, transform_A_b_t0=0.01,
                 transform_A_b_t1=0.1, transform_A_b_t2=0.5,
                 transform_A_b_t3=0.9, decay_A_b=0.05, diffuse_Tau=0.02,
                 taxis1_Tau=0.3, taxis2_Tau=0.1, decay_Tau=1.0)
    elif kind == "taxis":  # the taxis-active bench deck (bench.py:160-170)
        p.update(dt=0.05, decay_PrP=1.0e-4, decay_PrP_pulse0=0.01,
                 decay_PrP_pulse1=10.0, taxis1_A_b=50.0,
                 taxis1_A_b_pulse0=-1.0, taxis1_A_b_pulse1=0.01,
                 taxis1_Tau=50.0, taxis1_Tau_pulse0=-1.0,
                 taxis1_Tau_pulse1=0.01, decay_Tau=1.0e1,
                 decay_Tau_pulse0=0.0005, decay_Tau_pulse1=1.0e20,
                 diffuse_A_b=2e-4, diffuse_A_b_pulse0=-1.0,
                 diffuse_A_b_pulse1=1e20)
    else:
        p.update(dt=0.05)
    return {k: float(v) for k, v in p.items()}


def adpm_state(mesh, kind):
    """Seeded initial state (N, 3) and unit tracts (E, 3)."""
    rng = np.random.default_rng(5)
    r2 = ((mesh.coords - mesh.coords.mean(0)) ** 2).sum(1)
    L2 = (np.ptp(mesh.coords, axis=0) ** 2).sum()
    amp = (1e-3, 1e-4) if kind == "taxis" else (0.3, 0.1)
    u0 = np.zeros((mesh.n_nodes, 3))
    u0[:, 0] = 1.0
    u0[:, 1] = amp[0] * np.exp(-r2 / (0.075 * L2))
    u0[:, 2] = amp[1] * np.exp(-r2 / (0.05 * L2))
    tracts = rng.standard_normal((mesh.n_elems, 3))
    tracts /= np.linalg.norm(tracts, axis=1, keepdims=True)
    return u0, tracts



def assembled_solve(values, b, rows, cols, n_nodes):
    """The unclamped solution (N, V) of the block system values (V, V, nnz)
    on the node pairs (rows, cols), right-hand side b (V, N), by LAPACK
    with row equilibration (the species' scales span many orders)."""
    values, b = np.asarray(values), np.asarray(b)
    V, N = b.shape[0], n_nodes
    A = np.zeros((V, N, V, N))
    for v in range(V):
        for w in range(V):
            A[v, rows, w, cols] = values[v, w]
    A = A.reshape(V * N, V * N)
    s = 1.0 / np.abs(A).max(axis=1)
    return np.linalg.solve(A * s[:, None], b.reshape(-1) * s).reshape(V, N).T


def reference_assembled_step(jsys, u, fields, params):
    """One linearized-CN step of the reference system `jsys` (built with a
    dense `physics`) from the nodal state u (N, V), solved directly: its
    own eager `assemble` (rdcfes_tpu/systems/transient.py:435-450), the
    element-matrix path, and a dense solve.  Returns the unclamped
    solution (N, V): what the reference's Krylov solve converges to."""
    values, b = jsys.assemble(jnp.asarray(np.asarray(u).T), fields, params)
    return assembled_solve(values, b, jsys.sp.rows, jsys.sp.cols,
                           jsys.mesh.n_nodes)


@contextlib.contextmanager
def reference_native_rcb(directory):
    """rdcfes_tpu.native loading the reference's own meshkit.cpp, built
    with the host g++ into `directory`, inside the block: its HaloPlan
    then partitions with the C++ RCB, as the port's does (without the
    library the reference falls back to a NumPy RCB that splits equal
    centroids in another order)."""
    import os
    import shutil
    import subprocess

    import rdcfes_tpu.native as jnative

    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native RCB cannot be built")
    lib = os.path.join(str(directory), "libmeshkit.so")
    src = os.path.join(os.path.dirname(jnative.__file__), "meshkit.cpp")
    subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-o", lib,
                    src], check=True, capture_output=True)
    old = jnative._LIB_PATH, jnative._lib
    jnative._LIB_PATH, jnative._lib = lib, None
    try:
        yield
    finally:
        jnative._LIB_PATH, jnative._lib = old
