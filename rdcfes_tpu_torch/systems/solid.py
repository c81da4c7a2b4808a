"""Quasi-static finite-strain solid mechanics system (torch port of
rdcfes_tpu.systems.solid for single-type TET4 / HEX8 meshes).

The reference app's SolidSystem (src/solid_system.C) with libMesh's Newton
stack, in functional form:

* the unknowns are the current node positions x (N, 3): the geometry
  factors are re-evaluated from x at every Newton iterate;
* element residual and tangent: internal forces B^T sigma plus geometric
  and material stiffness from the batched hyperelastic evaluation
  (element_kernels_cf; src/solid_system.C:146-271);
* assembly gathers the flat element buffers through the inverted scatter
  tables (fem.assembly.assemble_*_gather): kernel K4 on the card;
* penalty Dirichlet conditions on deformed-vs-reference positions, scaled
  by pseudo-time * 1.000001, NaN = free axis (src/solid_system.C:273-371),
  with the reference's inexact linearization (psi_i psi_j * penalty only),
  their face terms summed onto nodes and blocks through the inverse
  tables of their targets too (K4), so every sum of an assembly has a
  fixed order and two assemblies are bit-equal;
* post-processing: per-element averaged Cauchy stress -> pressure and Von
  Mises, and the fibre push-forward F eta (src/solid_system.C:394-538).

tangent_precision="f32" evaluates, contracts and gathers the tangent in
single precision (the residual the Newton rules see stays f64).  The
reference casts x, the tables and pseudo-time to f32 the same way, but its
f64 quadrature weights promote JxW, and with it the contraction and the
assembled values, back to f64; here the whole tangent stays f32, as the
reference's comments intend.

Not ported: MIXED meshes (ROADMAP queue 1 item 13), hanging-node
constraints (item 13) and the multi-device halo solve (item 14); each
raises NotImplementedError naming its item.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..fem.assembly import (assemble_matrix_gather, assemble_vector_gather,
                            build_sparsity, invert_scatter)
from ..fem.geometry import face_geometry_factors, geometry_factors
from ..fem.kernels import KERNEL_OPS, Ops
from ..mesh.core import FACE_TYPE, Mesh
from ..models.eig3 import principal_stress_invariants
from ..models.hyperelastic import stress_and_tangent_cf
from ..solvers.newton import NewtonOptions, NewtonResult, NewtonSolver
from ..utils.convert import material_tables
from ..utils.device import cuda_device

_AMR = "ROADMAP queue 1 item 13 (mixed meshes and AMR)"
_MULTI = "ROADMAP queue 1 item 14 (multi-device)"
_GENERIC = "ROADMAP queue 1 item 8 (generic path)"

# B-matrix slot table: (axis v, voigt a) -> gradient component, for the
# Voigt ordering (00, 11, 22, 01, 12, 02)
_B_SLOTS = {
    (0, 0): 0, (0, 3): 1, (0, 5): 2,
    (1, 1): 1, (1, 3): 0, (1, 4): 2,
    (2, 2): 2, (2, 4): 1, (2, 5): 0,
}


def element_kernels_cf(elem_type, x, conn, X0e_cf, young, poisson,
                       fibre_k, rates, fibres, pseudo_time,
                       want_tangent=True):
    """Element residual/tangent blocks (Fe (3, K, E)[, Ke (3, 3, K, K, E)])
    from current positions x (N, 3) and per-element tables X0e_cf (K, 3, E),
    young/poisson/fibre_k (E,), rates/fibres (E, 3), all in one dtype
    (reference src/solid_system.C:146-271)."""
    phi, JxW, dphi = geometry_factors(x, conn, elem_type)
    Q, K = phi.shape
    # grad_X[d][r] (Q, E) = d X0_d / d x_r
    grad_X = [
        [sum(dphi[:, k, r, :] * X0e_cf[k, d, :] for k in range(K))
         for r in range(3)]
        for d in range(3)
    ]
    lam_e = 1.0 + pseudo_time * rates  # (E, 3)
    lam = [lam_e[:, d] for d in range(3)]   # broadcast (E,) vs (Q, E)
    eta = [fibres[:, d] for d in range(3)]
    sigma, tangent, _F = stress_and_tangent_cf(
        grad_X, lam, eta, young, poisson, fibre_k, want_tangent=want_tangent)
    sig = torch.stack([torch.stack(r) for r in sigma])    # (3, 3, Q, E)
    if not want_tangent:
        Fe = None
        for q in range(Q):
            sig_q = sig[:, :, q, :] * JxW[q]
            fe_q = (sig_q[:, None, :, :] * dphi[q][None, :, :, :]).sum(2)
            Fe = fe_q if Fe is None else Fe + fe_q
        return Fe, None
    tan = torch.stack([torch.stack(r) for r in tangent])  # (6, 6, Q, E)

    Fe = None
    G = None
    Kmat = None
    for q in range(Q):
        sig_q = sig[:, :, q, :] * JxW[q]                  # (3, 3, E)
        dphi_q = dphi[q]                                  # (K, 3, E)
        # residual: (3, K, E) = sum_d sig[v, d] dphi[i, d]
        fe_q = (sig_q[:, None, :, :] * dphi_q[None, :, :, :]).sum(2)
        Fe = fe_q if Fe is None else Fe + fe_q
        # geometric stiffness: s1[i, d] = sum_c dphi[i, c] sig[c, d]
        s1 = (dphi_q[:, :, None, :] * sig_q[None, :, :, :]).sum(1)
        g_q = (s1[:, None, :, :] * dphi_q[None, :, :, :]).sum(2)
        G = g_q if G is None else G + g_q                 # (K, K, E)
        # material stiffness: B (3, 6, K, E) sparse placement of dphi
        zero = torch.zeros_like(dphi_q[:, 0, :])
        Bq = torch.stack([
            torch.stack([dphi_q[:, _B_SLOTS[(v, a)], :]
                         if (v, a) in _B_SLOTS else zero
                         for a in range(6)])
            for v in range(3)
        ])                                                # (3, 6, K, E)
        tan_q = tan[:, :, q, :] * JxW[q]                  # (6, 6, E)
        # T1[a, w, j] = sum_b tan[a, b] B[w, b, j]
        T1 = None
        for b in range(6):
            t = tan_q[:, b][:, None, None, :] * Bq[None, :, b, :, :]
            T1 = t if T1 is None else T1 + t              # (6, 3, K, E)
        # Kmat[v, w, i, j] = sum_a B[v, a, i] T1[a, w, j]
        for a in range(6):
            t = Bq[:, a][:, None, :, None, :] * T1[a][None, :, None, :, :]
            Kmat = t if Kmat is None else Kmat + t        # (3, 3, K, K, E)

    eye = torch.eye(3, dtype=Kmat.dtype, device=Kmat.device)
    Ke = Kmat + eye[:, :, None, None, None] * G[None, None]
    return Fe, Ke


class SolidSystem:
    """Quasi-static hyperelastic equilibrium with load stepping.

    mesh              : host Mesh, TET4 or HEX8
    materials         : {subdomain id: {"young", "poisson",
                        "fibre_stiffness", "stretch_rate_0..2"}}
    bcs               : {boundary id: (ux, uy, uz)}, NaN = free axis
    penalty           : penalty factor of the Dirichlet conditions
    fibres            : (E, 3) fibre directions, or None (no fibres)
    newton            : solvers.newton.NewtonOptions
    tangent_precision : "f64" or "f32" (see the module docstring)
    device            : where the tables and positions live; None (the
                        default) is the CUDA card, and raises without one
    ops               : fem.kernels.KERNEL_OPS (default) or PLAIN_OPS
    """

    def __init__(self, mesh: Mesh, materials: Dict[int, Dict[str, float]],
                 bcs: Dict[int, Tuple[float, float, float]],
                 penalty: float = 1.0e5, fibres: Optional[np.ndarray] = None,
                 newton: NewtonOptions = NewtonOptions(), device_mesh=None,
                 constraints: Optional[np.ndarray] = None,
                 tangent_precision: str = "f64", device=None,
                 ops: Ops = KERNEL_OPS):
        if getattr(mesh, "elem_type", None) == "MIXED":
            raise NotImplementedError(f"MIXED meshes: {_AMR}")
        if device_mesh is not None:
            raise NotImplementedError(f"device_mesh: {_MULTI}")
        if constraints is not None and len(constraints):
            raise NotImplementedError(f"hanging-node constraints: {_AMR}")
        if mesh.elem_type == "TET10":
            raise NotImplementedError(f"TET10 meshes: {_GENERIC}")
        if mesh.elem_type not in ("TET4", "HEX8"):
            raise ValueError(f"solid mechanics supports TET4/HEX8 element "
                             f"types, got {mesh.elem_type}")
        if tangent_precision not in ("f64", "f32"):
            raise ValueError(f"tangent_precision {tangent_precision!r}")
        self.mesh = mesh
        self.newton = newton
        self.penalty = float(penalty)
        self.tangent_precision = tangent_precision
        self.device = cuda_device() if device is None else torch.device(device)
        self.ops = ops
        dev, f64 = self.device, torch.float64
        t = lambda a, dt=f64: torch.as_tensor(np.asarray(a), dtype=dt,
                                              device=dev)
        idx = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)

        conn = np.asarray(mesh.connectivity)
        self.sp = build_sparsity(conn, mesh.n_nodes)
        self.X0 = t(mesh.coords)  # undeformed configuration (N, 3)
        self.conn = idx(conn)  # int32 tables
        self.slot_gather = idx(invert_scatter(self.sp.slots_flat_cf(),
                                              self.sp.nnz))
        self.node_gather = idx(invert_scatter(conn.T.reshape(-1),
                                              mesh.n_nodes))
        # per-element tables (subdomain -> element broadcast of the
        # material deck), in f64 and, for the f32 tangent, cast once
        tabs = material_tables(mesh.subdomain_id, materials, fibres)
        tabs["X0e_cf"] = np.transpose(mesh.coords[conn], (1, 2, 0))
        self.tables = {k: t(v) for k, v in tabs.items()}
        self.tables32 = {k: v.to(torch.float32)
                         for k, v in self.tables.items()}

        # penalty boundary-condition face groups (static shapes)
        self.bc_groups = []
        bfaces, bmask, bdisp = [], [], []
        for bid, disp in bcs.items():
            faces = mesh.boundary_faces[mesh.boundary_id == bid]
            if len(faces) == 0:
                continue
            d = np.asarray(disp, dtype=np.float64)
            bfaces.append(faces)
            bmask.append(np.broadcast_to(~np.isnan(d), (len(faces), 3)))
            bdisp.append(np.broadcast_to(np.nan_to_num(d), (len(faces), 3)))
        if bfaces:
            fc = np.concatenate(bfaces).astype(np.int64)
            # face slots in the node-pair sparsity: the pair keys are the
            # sorted uniques, so searchsorted finds them
            keys = self.sp.rows.astype(np.int64) * mesh.n_nodes + self.sp.cols
            fkeys = fc[:, :, None] * mesh.n_nodes + fc[:, None, :]
            slots = np.searchsorted(keys, fkeys)
            # the penalty terms are summed onto nodes and blocks in a fixed
            # order, through the inverse tables of their targets (K4 on
            # the card), so two assemblies are bit-equal
            self.bc_groups.append({
                "face_type": FACE_TYPE[mesh.elem_type],
                "faces": t(fc, torch.int64),
                "mask": t(np.concatenate(bmask).astype(np.float64)),
                "disp": t(np.concatenate(bdisp)),
                "node_gather": idx(invert_scatter(fc.reshape(-1),
                                                  mesh.n_nodes)),
                "slot_gather": idx(invert_scatter(slots.reshape(-1),
                                                  self.sp.nnz)),
            })
        self._newton = NewtonSolver(self.sp, newton, device=dev, ops=ops)

    # ------------------------------------------------------------------
    def initial_positions(self) -> torch.Tensor:
        return self.X0.clone()

    def _pt(self, pseudo_time, dtype) -> torch.Tensor:
        return torch.as_tensor(pseudo_time, dtype=dtype, device=self.device)

    def _element(self, x, tabs, pseudo_time, want_tangent):
        return element_kernels_cf(
            self.mesh.elem_type, x, self.conn, tabs["X0e_cf"],
            tabs["young"], tabs["poisson"], tabs["fibre_k"], tabs["rates"],
            tabs["fibres"], pseudo_time, want_tangent=want_tangent)

    # ------------------------------------------------------------------
    def assemble(self, x_T: torch.Tensor, pseudo_time
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Residual (3, N) f64 and block tangent values (3, 3, nnz) (f64,
        or f32 under tangent_precision="f32") at channel-first positions
        x_T (3, N)."""
        restrict = self.ops.restrict
        x = x_T.T  # (N, 3)
        if self.tangent_precision == "f32":
            R = self.assemble_residual(x_T, pseudo_time)
            f32 = torch.float32
            x32, pt32 = x.to(f32), self._pt(pseudo_time, f32)
            _, Ke = self._element(x32, self.tables32, pt32, True)
            values = assemble_matrix_gather(Ke, self.slot_gather, restrict)
            if self.bc_groups:
                values = self._penalty_bc_values(x32, values)
            return R, values
        pt = self._pt(pseudo_time, torch.float64)
        Fe, Ke = self._element(x, self.tables, pt, True)
        values = assemble_matrix_gather(Ke, self.slot_gather, restrict)
        R = assemble_vector_gather(Fe, self.node_gather, restrict)
        if self.bc_groups:
            R = self._penalty_bc_residual(x, pt, R)
            values = self._penalty_bc_values(x, values)
        return R, values

    def assemble_residual(self, x_T: torch.Tensor, pseudo_time
                          ) -> torch.Tensor:
        """Residual (3, N) only: the constitutive evaluation without the
        tangent contraction (line-search trials, modified-Newton checks)."""
        x = x_T.T
        pt = self._pt(pseudo_time, torch.float64)
        Fe, _ = self._element(x, self.tables, pt, False)
        R = assemble_vector_gather(Fe, self.node_gather, self.ops.restrict)
        if self.bc_groups:
            R = self._penalty_bc_residual(x, pt, R)
        return R

    def _penalty_bc_residual(self, x, pseudo_time, R):
        """The residual half of the penalty conditions: R (3, N)."""
        ratio = pseudo_time * 1.000001
        for g in self.bc_groups:
            faces = g["faces"]
            psi, JxWf, xyz, _ = face_geometry_factors(x, faces,
                                                      g["face_type"])
            orig = torch.einsum("qk,fkd->fqd", psi, self.X0[faces])
            target = ratio * g["disp"]
            diff = xyz - orig - target[:, None, :]
            masked = diff * g["mask"][:, None, :]
            Rf = self.penalty * torch.einsum("fq,qi,fqv->vfi", JxWf, psi,
                                             masked)
            R = R + self.ops.restrict(Rf.reshape(3, -1).contiguous(),
                                      g["node_gather"])
        return R

    def _penalty_bc_values(self, x, values):
        """The tangent half: penalty * psi_i psi_j on the constrained axes
        of the diagonal blocks; values (3, 3, nnz) in x's dtype."""
        dt_ = values.dtype
        for g in self.bc_groups:
            psi, JxWf, _, _ = face_geometry_factors(x, g["faces"],
                                                    g["face_type"])
            psi_ = psi.to(dt_)
            Kf_pen = self.penalty * torch.einsum(
                "fq,qi,qj->fij", JxWf.to(dt_), psi_, psi_)
            eye = torch.eye(3, dtype=dt_, device=values.device)
            # (3, 3, F, i, j): delta_vw * mask[f, v] * Kf_pen[f, i, j]
            Kblocks = (eye[:, :, None, None, None]
                       * g["mask"].T.to(dt_)[:, None, :, None, None]
                       * Kf_pen[None, None, :, :, :])
            values = values + self.ops.restrict(
                Kblocks.reshape(9, -1), g["slot_gather"]).reshape(3, 3, -1)
        return values

    # ------------------------------------------------------------------
    def run_solver(self, x, pseudo_time: float) -> NewtonResult:
        """One load step: Newton-solve equilibrium at pseudo_time from
        positions x (N, 3) (reference run_solver, src/solid_system.C:
        373-392).  The result's x is (N, 3)."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        pt = float(pseudo_time)
        res = self._newton.solve(
            lambda y: self.assemble(y, pt), x.T.contiguous(),
            residual_only=lambda y: self.assemble_residual(y, pt))
        return res._replace(x=res.x.T)

    # ------------------------------------------------------------------
    def post_process(self, x, pseudo_time: float):
        """Per-element (pressure (E,), Von Mises (E,), current fibre
        vector (E, 3)) at positions x (N, 3) (reference post_process,
        src/solid_system.C:394-538)."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        tabs = self.tables
        phi, JxW, dphi = geometry_factors(x, self.conn, self.mesh.elem_type)
        Q, K = phi.shape
        X0e = tabs["X0e_cf"]
        grad_X = [
            [sum(dphi[:, k, r, :] * X0e[k, d, :] for k in range(K))
             for r in range(3)]
            for d in range(3)
        ]
        lam_e = 1.0 + self._pt(pseudo_time, torch.float64) * tabs["rates"]
        fib = tabs["fibres"]
        sigma, _, F = stress_and_tangent_cf(
            grad_X, [lam_e[:, d] for d in range(3)],
            [fib[:, d] for d in range(3)], tabs["young"], tabs["poisson"],
            tabs["fibre_k"], want_tangent=False)
        # arithmetic qp mean, as the reference
        sigma_avg = torch.stack([
            torch.stack([sigma[i][j].sum(dim=0) / Q for j in range(3)],
                        dim=-1)
            for i in range(3)
        ], dim=-2)  # (E, 3, 3)
        p, vm = principal_stress_invariants(sigma_avg)
        fibre_cur = torch.stack([
            (F[i][0] * fib[:, 0] + F[i][1] * fib[:, 1]
             + F[i][2] * fib[:, 2]).sum(dim=0) / Q
            for i in range(3)
        ], dim=-1)  # (E, 3)
        return p, vm, fibre_cur

    def displacement(self, x) -> torch.Tensor:
        """u = current - undeformed positions (N, 3)."""
        return torch.as_tensor(x, dtype=torch.float64,
                               device=self.device) - self.X0
