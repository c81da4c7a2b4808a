"""Quasi-static finite-strain solid mechanics system (torch port of
rdcfes_tpu.systems.solid for TET4, HEX8, TET10 and MIXED meshes).

The reference app's SolidSystem (src/solid_system.C) with libMesh's Newton
stack, in functional form:

* the unknowns are the current node positions x (N, 3): the geometry
  factors are re-evaluated from x at every Newton iterate;
* element residual and tangent: internal forces B^T sigma plus geometric
  and material stiffness from the batched hyperelastic evaluation
  (element_kernels_cf; src/solid_system.C:146-271), once per element
  block: a single-type mesh is one block, a MixedMesh one per type (K =
  4, 5, 6 or 8), a TET10 mesh one block of K = 10;
* assembly: the blocks' flat element buffers, concatenated in block
  order, are gathered through ONE inverted scatter table over the union
  node-pair sparsity (fem.assembly.build_sparsity_mixed on a MixedMesh),
  one K4 launch for the tangent and one for the residual whatever the
  number of blocks.  Each slot sums its contributions block by block in
  that order; the reference sums per-block assemblies (values + v), so
  the two agree at machine-epsilon class;
* penalty Dirichlet conditions on deformed-vs-reference positions,
  scaled by pseudo-time * 1.000001, NaN = free axis (src/solid_system.C:
  273-371), with the reference's inexact linearization (psi_i psi_j *
  penalty only), grouped by face type (TRI3 or QUAD4, both on a
  MixedMesh, whose boundary faces are -1-padded to 4 nodes; TRI6 on
  TET10); their face terms are summed onto nodes and blocks through the
  inverse tables of their targets too (K4), so every sum of an assembly
  has a fixed order and two assemblies are bit-equal;
* hanging-node constraints (`constraints=`, the rows [h, a, b] of a
  remeshed MIXED mesh) go to the Newton, which solves C^T K C
  (solvers/newton.py);
* post-processing: per-element averaged Cauchy stress -> pressure and Von
  Mises, and the fibre push-forward F eta (src/solid_system.C:394-538),
  the blocks concatenated in the global element order.

tangent_precision="f32" evaluates, contracts and gathers the tangent in
single precision (the residual the Newton rules see stays f64).  The
reference casts x, the tables and pseudo-time to f32 the same way, but its
f64 quadrature weights promote JxW, and with it the contraction and the
assembled values, back to f64; here the whole tangent stays f32, as the
reference's comments intend.

`device_mesh=D` (or a parallel.halo.ShardGroup) runs the load step on D
shards through the halo Newton (parallel/solid_halo.HaloSolidSystem:
element tangents local to their shard, a distributed BiCGStab), in f64:
an f32 tangent prints the reference's notice and stays f64, hanging-node
constraints raise ValueError, as the reference's do; post_process stays
on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..fem.assembly import (assemble_matrix_gather, assemble_vector_gather,
                            block_node_gather, build_sparsity,
                            build_sparsity_mixed, invert_scatter)
from ..fem.geometry import face_geometry_factors, geometry_factors
from ..fem.kernels import KERNEL_OPS, Ops
from ..mesh.core import FACE_TYPE, Mesh
from ..models.eig3 import principal_stress_invariants
from ..models.hyperelastic import stress_and_tangent_cf
from ..solvers.newton import NewtonOptions, NewtonResult, NewtonSolver
from ..utils.convert import material_tables
from ..utils.device import cuda_device

_ELEMENT_TYPES = ("TET4", "HEX8", "TET10", "MIXED")


@dataclass
class SolidBC:
    """One penalty Dirichlet boundary set: displacement per axis, NaN =
    free (the reference's SolidBC; SolidSystem takes the same data as its
    `bcs` dict, {boundary_id: displacement})."""

    boundary_id: int
    displacement: Tuple[float, float, float]


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

    mesh              : host Mesh (TET4, HEX8 or TET10) or MixedMesh
    materials         : {subdomain id: {"young", "poisson",
                        "fibre_stiffness", "stretch_rate_0..2"}}
    bcs               : {boundary id: (ux, uy, uz)}, NaN = free axis
    penalty           : penalty factor of the Dirichlet conditions
    fibres            : (E, 3) fibre directions in the global element
                        order, or None (no fibres)
    newton            : solvers.newton.NewtonOptions
    constraints       : (H, 3) hanging-node rows [h, a, b] (x_h = (x_a +
                        x_b) / 2), or None
    tangent_precision : "f64" or "f32" (see the module docstring)
    device_mesh       : None (one device), a shard count D, placed by
                        parallel.halo.shard_devices(D, device), or a
                        parallel.halo.ShardGroup: the halo Newton
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
        if mesh.elem_type not in _ELEMENT_TYPES:
            raise ValueError(f"solid mechanics supports TET4/HEX8/TET10/"
                             f"MIXED element types, got {mesh.elem_type}")
        if tangent_precision not in ("f64", "f32"):
            raise ValueError(f"tangent_precision {tangent_precision!r}")
        if device_mesh is not None:
            if constraints is not None and len(constraints):
                raise ValueError(
                    "hanging-node constraints in the solid Newton path are "
                    "single-chip only (COMPONENTS.md); run with "
                    "parallel/n_devices = 1")
            if tangent_precision != "f64":
                # the reference's notice (rdcfes_tpu/systems/solid.py:
                # 165-172): the halo Newton carries the f64 tangent only
                print("solid: tangent_precision=f32 is single-chip only; "
                      "multi-chip run keeps the f64 tangent", flush=True)
                tangent_precision = "f64"
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

        N = mesh.n_nodes
        mixed = mesh.elem_type == "MIXED"
        if mixed:
            conns = [(b.elem_type, np.asarray(b.connectivity))
                     for b in mesh.blocks]
            self.sp, slot_lists = build_sparsity_mixed(mesh.blocks, N)
        else:
            conns = [(mesh.elem_type, np.asarray(mesh.connectivity))]
            self.sp = build_sparsity(conns[0][1], N)
            slot_lists = [self.sp.slots_flat_cf()]
        self.X0 = t(mesh.coords)  # undeformed configuration (N, 3)
        # one gather table each over the blocks' concatenated flat
        # buffers (int32): one K4 launch per assembly
        self.slot_gather = idx(invert_scatter(np.concatenate(slot_lists),
                                              self.sp.nnz))
        self.node_gather = idx(block_node_gather([c for _, c in conns], N))
        # per-element tables (subdomain -> element broadcast of the
        # material deck) sliced per block in the global element order, in
        # f64 and, for the f32 tangent, cast once
        tabs = material_tables(mesh.subdomain_id, materials, fibres)
        self.blocks = []
        off = 0
        for et, conn in conns:
            sel = slice(off, off + conn.shape[0])
            off += conn.shape[0]
            tb = {k: t(v[sel]) for k, v in tabs.items()}
            tb["X0e_cf"] = t(np.transpose(mesh.coords[conn], (1, 2, 0)))
            self.blocks.append({
                "elem_type": et, "conn": idx(conn), "tables": tb,
                "tables32": {k: v.to(torch.float32) for k, v in tb.items()},
            })

        # penalty boundary-condition face groups (static shapes), one per
        # face type: a MixedMesh's -1-padded faces carry both arities
        bfaces, bmask, bdisp = [], [], []
        for bid, disp in bcs.items():
            faces = mesh.boundary_faces[mesh.boundary_id == bid]
            if len(faces) == 0:
                continue
            d = np.asarray(disp, dtype=np.float64)
            bfaces.append(faces)
            bmask.append(np.broadcast_to(~np.isnan(d), (len(faces), 3)))
            bdisp.append(np.broadcast_to(np.nan_to_num(d), (len(faces), 3)))
        self.bc_groups = []
        if bfaces:
            faces = np.concatenate(bfaces).astype(np.int64)
            mask = np.concatenate(bmask).astype(np.float64)
            disp = np.concatenate(bdisp)
            if mixed:
                quad = faces[:, 3] >= 0
                face_sets = [("QUAD4", quad, 4), ("TRI3", ~quad, 3)]
            else:
                face_sets = [(FACE_TYPE[mesh.elem_type],
                              np.ones(len(faces), dtype=bool),
                              faces.shape[1])]
            # face slots in the node-pair sparsity: the pair keys are the
            # sorted uniques, so searchsorted finds them
            keys = self.sp.rows.astype(np.int64) * N + self.sp.cols
            for ft, fsel, kf in face_sets:
                if not fsel.any():
                    continue
                fc = faces[fsel][:, :kf]
                slots = np.searchsorted(
                    keys, fc[:, :, None] * N + fc[:, None, :])
                # the penalty terms are summed onto nodes and blocks in a
                # fixed order, through the inverse tables of their
                # targets (K4 on the card), so two assemblies are
                # bit-equal
                self.bc_groups.append({
                    "face_type": ft,
                    "faces": t(fc, torch.int64),
                    "mask": t(mask[fsel]),
                    "disp": t(disp[fsel]),
                    "node_gather": idx(invert_scatter(fc.reshape(-1), N)),
                    "slot_gather": idx(invert_scatter(slots.reshape(-1),
                                                      self.sp.nnz)),
                })
        self._newton = NewtonSolver(self.sp, newton, constraints=constraints,
                                    device=dev, ops=ops)
        self._halo = None
        if device_mesh is not None:
            from ..parallel.halo import ShardGroup, shard_devices
            from ..parallel.solid_halo import HaloSolidSystem

            group = (device_mesh if isinstance(device_mesh, ShardGroup)
                     else ShardGroup(shard_devices(int(device_mesh), device)))
            self._halo = HaloSolidSystem(
                mesh, *(tabs[k] for k in ("young", "poisson", "fibre_k",
                                          "rates", "fibres")),
                bcs=bcs, penalty=self.penalty, newton=newton, group=group,
                device=dev, ops=ops)

    # ------------------------------------------------------------------
    def initial_positions(self) -> torch.Tensor:
        return self.X0.clone()

    def _pt(self, pseudo_time, dtype) -> torch.Tensor:
        return torch.as_tensor(pseudo_time, dtype=dtype, device=self.device)

    def _elements(self, x, pseudo_time, want_tangent, f32=False):
        """Each block's (Fe (3, K, E_b), Ke (3, 3, K, K, E_b) or None)."""
        key = "tables32" if f32 else "tables"
        return [element_kernels_cf(
            b["elem_type"], x, b["conn"], b[key]["X0e_cf"],
            b[key]["young"], b[key]["poisson"], b[key]["fibre_k"],
            b[key]["rates"], b[key]["fibres"], pseudo_time,
            want_tangent=want_tangent) for b in self.blocks]

    @staticmethod
    def _concat(parts, W: int) -> torch.Tensor:
        """The blocks' element buffers flattened to (W, ...) and
        concatenated in block order: the source of one K4 gather."""
        flat = [p.reshape(W, -1) for p in parts]
        return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)

    def _values(self, Kes) -> torch.Tensor:
        """Block values (3, 3, nnz) from the blocks' Ke (K4)."""
        return assemble_matrix_gather(self._concat(Kes, 9).reshape(3, 3, -1),
                                      self.slot_gather, self.ops.restrict)

    def _residual(self, Fes) -> torch.Tensor:
        """Nodal residual (3, N) from the blocks' Fe (K4)."""
        return assemble_vector_gather(self._concat(Fes, 3), self.node_gather,
                                      self.ops.restrict)

    # ------------------------------------------------------------------
    def assemble(self, x_T: torch.Tensor, pseudo_time
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Residual (3, N) f64 and block tangent values (3, 3, nnz) (f64,
        or f32 under tangent_precision="f32") at channel-first positions
        x_T (3, N)."""
        x = x_T.T  # (N, 3)
        if self.tangent_precision == "f32":
            R = self.assemble_residual(x_T, pseudo_time)
            f32 = torch.float32
            x32 = x.to(f32)
            values = self._values([Ke for _, Ke in self._elements(
                x32, self._pt(pseudo_time, f32), True, f32=True)])
            if self.bc_groups:
                values = self._penalty_bc_values(x32, values)
            return R, values
        pt = self._pt(pseudo_time, torch.float64)
        FKs = self._elements(x, pt, True)
        values = self._values([Ke for _, Ke in FKs])
        R = self._residual([Fe for Fe, _ in FKs])
        del FKs
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
        R = self._residual([Fe for Fe, _ in self._elements(x, pt, False)])
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
        373-392).  The result's x is (N, 3).  With device_mesh, the halo
        Newton on its shards."""
        if self._halo is not None:
            return self._halo.run_solver(x, pseudo_time)
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        pt = float(pseudo_time)
        res = self._newton.solve(
            lambda y: self.assemble(y, pt), x.T.contiguous(),
            residual_only=lambda y: self.assemble_residual(y, pt))
        return res._replace(x=res.x.T)

    # ------------------------------------------------------------------
    def post_process(self, x, pseudo_time: float):
        """Per-element (pressure (E,), Von Mises (E,), current fibre
        vector (E, 3)) at positions x (N, 3), the blocks concatenated in
        the global element order (reference post_process,
        src/solid_system.C:394-538)."""
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        ps, vms, fcs = [], [], []
        for b in self.blocks:
            tabs = b["tables"]
            phi, JxW, dphi = geometry_factors(x, b["conn"], b["elem_type"])
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
                [fib[:, d] for d in range(3)], tabs["young"],
                tabs["poisson"], tabs["fibre_k"], want_tangent=False)
            # arithmetic qp mean, as the reference
            sigma_avg = torch.stack([
                torch.stack([sigma[i][j].sum(dim=0) / Q for j in range(3)],
                            dim=-1)
                for i in range(3)
            ], dim=-2)  # (E, 3, 3)
            p, vm = principal_stress_invariants(sigma_avg)
            ps.append(p)
            vms.append(vm)
            fcs.append(torch.stack([
                (F[i][0] * fib[:, 0] + F[i][1] * fib[:, 1]
                 + F[i][2] * fib[:, 2]).sum(dim=0) / Q
                for i in range(3)
            ], dim=-1))  # (E, 3)
        return torch.cat(ps), torch.cat(vms), torch.cat(fcs)

    def displacement(self, x) -> torch.Tensor:
        """u = current - undeformed positions (N, 3)."""
        return torch.as_tensor(x, dtype=torch.float64,
                               device=self.device) - self.X0
