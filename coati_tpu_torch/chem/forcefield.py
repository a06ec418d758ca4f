"""MMFF94s-lite molecular-mechanics minimization (offline).

The port's own copy of coati_tpu/chem/forcefield.py: the same code and the
same results, importing nothing of the JAX package.

The reference's conformer generator minimizes every ETKDG embedding
with MMFF94s and keeps the lowest-energy conformer
(containers/rdkit_utils.py:163-219 mol_to_atoms_coords: optimize=True
-> EmbedMultipleConfs + MMFFOptimizeMoleculeConfs(mmffVariant=
"MMFF94s"), returning the minimized coords and lowest energy). Without
rdkit, ranking conformers by distance-geometry stress only is
geometry-sane but systematically cruder than force-field-relaxed
structures. This module is the offline stand-in: a classical
valence force field over the hydrogen-augmented conformer graph with

  * harmonic bond stretch about the covalent-radius table lengths,
  * harmonic angle bend about hybridization / small-ring ideal angles,
  * cosine torsions — 3-fold staggering about sp3 single bonds, stiff
    2-fold planarity about double / aromatic / amide bonds, and 1-fold
    pins for stereo-assigned cis/trans double bonds,
  * harmonic out-of-plane (improper) terms on trigonal sp2 centers,
  * 12-6 Lennard-Jones van der Waals on >=1-4 pairs (1-4 halved), and
  * signed-volume restraints holding tetrahedral stereocenters in the
    parity their SMILES marker encodes (see conformers._HGraph.tetra).

Deliberate scope vs real MMFF94s (documented, not silent): no partial
charges / electrostatics and no buffered-14-7 vdW — parameterizing
charges offline is out of scope, and the EGNN consumer reads pairwise
distances where the valence terms dominate. Energies are therefore in
arbitrary kcal/mol-like units: valid for RANKING conformers of the
same molecule (the only use the reference makes of the MMFF energy),
not for cross-molecule thermochemistry.

Minimization uses FIRE (Bitzek et al. 2006) — robust on the raw DG
embeddings, no line search, pure numpy. Gradients of every term are
analytic; coati_tpu's tests/test_forcefield.py checks them against central
differences.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ForceField", "build_forcefield"]

# force constants (kcal/mol-ish, Angstrom, radian)
_K_BOND = 300.0
_K_ANGLE = 60.0
_V_TORSION_SP3 = 0.6     # 3-fold staggering barrier
_V_TORSION_PLANAR = 25.0  # 2-fold pi-bond planarity barrier
_V_TORSION_STEREO = 30.0  # 1-fold cis/trans pin
_K_IMPROPER = 40.0
_EPS_VDW = 0.05
_VDW_14_SCALE = 0.5
_K_CHIRAL = 8.0
_CHIRAL_MARGIN = 1.5      # target |signed volume| floor, A^3


class ForceField:
    """Precompiled term arrays for one molecule; energy/grad/minimize.

    All term arrays are integer index arrays into the (n, 3) coordinate
    matrix plus per-term parameter vectors, so energy() and grad() are
    single vectorized numpy passes per term type.
    """

    def __init__(self, n: int):
        self.n = n
        # (m,2) idx, (m,) r0
        self.bond_idx = np.zeros((0, 2), dtype=np.int64)
        self.bond_r0 = np.zeros((0,))
        # (m,3) idx (i, j=center, k), (m,) theta0
        self.angle_idx = np.zeros((0, 3), dtype=np.int64)
        self.angle_t0 = np.zeros((0,))
        # (m,4) idx (i,j,k,l), (m,) n periodicity, V, gamma
        self.tors_idx = np.zeros((0, 4), dtype=np.int64)
        self.tors_n = np.zeros((0,))
        self.tors_v = np.zeros((0,))
        self.tors_g = np.zeros((0,))
        # (m,4) idx (center, i, j, k)
        self.impr_idx = np.zeros((0, 4), dtype=np.int64)
        # (m,2) idx, (m,) rmin, (m,) eps
        self.vdw_idx = np.zeros((0, 2), dtype=np.int64)
        self.vdw_r0 = np.zeros((0,))
        self.vdw_eps = np.zeros((0,))
        # (m,4) ordered neighbor idx, (m,) target sign (+-1)
        self.chir_idx = np.zeros((0, 4), dtype=np.int64)
        self.chir_sign = np.zeros((0,))

    # -- energy / gradient ------------------------------------------------

    def energy(self, x: np.ndarray) -> float:
        e, _ = self._eval(x, want_grad=False)
        return e

    def grad(self, x: np.ndarray) -> np.ndarray:
        _, g = self._eval(x, want_grad=True)
        return g

    def energy_grad(self, x: np.ndarray) -> Tuple[float, np.ndarray]:
        return self._eval(x, want_grad=True)

    def _eval(self, x: np.ndarray, want_grad: bool) -> Tuple[float, Optional[np.ndarray]]:
        x = np.asarray(x, dtype=np.float64)
        g = np.zeros_like(x) if want_grad else None
        e = 0.0

        if len(self.bond_idx):
            i, j = self.bond_idx[:, 0], self.bond_idx[:, 1]
            d = x[i] - x[j]
            r = np.sqrt((d * d).sum(-1) + 1e-12)
            dr = r - self.bond_r0
            e += float(_K_BOND * (dr * dr).sum())
            if want_grad:
                f = (2.0 * _K_BOND * dr / r)[:, None] * d
                np.add.at(g, i, f)
                np.add.at(g, j, -f)

        if len(self.angle_idx):
            i, j, k = (self.angle_idx[:, 0], self.angle_idx[:, 1],
                       self.angle_idx[:, 2])
            u = x[i] - x[j]
            v = x[k] - x[j]
            ru = np.sqrt((u * u).sum(-1) + 1e-12)
            rv = np.sqrt((v * v).sum(-1) + 1e-12)
            uh = u / ru[:, None]
            vh = v / rv[:, None]
            c = np.clip((uh * vh).sum(-1), -1.0 + 1e-9, 1.0 - 1e-9)
            th = np.arccos(c)
            dth = th - self.angle_t0
            e += float(_K_ANGLE * (dth * dth).sum())
            if want_grad:
                s = np.sqrt(1.0 - c * c)
                pref = 2.0 * _K_ANGLE * dth
                # dth/dxi = -(vh - c*uh) / (ru * sin)
                gi = -(vh - c[:, None] * uh) / (ru * s)[:, None]
                gk = -(uh - c[:, None] * vh) / (rv * s)[:, None]
                fi = pref[:, None] * gi
                fk = pref[:, None] * gk
                np.add.at(g, i, fi)
                np.add.at(g, k, fk)
                np.add.at(g, j, -(fi + fk))

        if len(self.tors_idx):
            phi, dphi = _dihedral(x, self.tors_idx, want_grad)
            arg = self.tors_n * phi - self.tors_g
            e += float((0.5 * self.tors_v * (1.0 + np.cos(arg))).sum())
            if want_grad:
                dedphi = -0.5 * self.tors_v * self.tors_n * np.sin(arg)
                for col in range(4):
                    np.add.at(g, self.tors_idx[:, col],
                              dedphi[:, None] * dphi[col])

        if len(self.impr_idx):
            c_, i, j, k = (self.impr_idx[:, 0], self.impr_idx[:, 1],
                           self.impr_idx[:, 2], self.impr_idx[:, 3])
            d = x[c_] - x[i]
            u = x[j] - x[i]
            v = x[k] - x[i]
            nrm = np.cross(u, v)
            ln = np.sqrt((nrm * nrm).sum(-1) + 1e-12)
            h = (d * nrm).sum(-1) / ln
            e += float(_K_IMPROPER * (h * h).sum())
            if want_grad:
                pref = (2.0 * _K_IMPROPER * h)[:, None]
                nh = nrm / ln[:, None]
                gc = nh
                # dh/dxj = (v x d)/|N| - h (v x N)/|N|^2
                gj = (np.cross(v, d) - h[:, None] * np.cross(v, nh)) / ln[:, None]
                gk = (np.cross(d, u) - h[:, None] * np.cross(nh, u)) / ln[:, None]
                gi = -(gc + gj + gk)
                np.add.at(g, c_, pref * gc)
                np.add.at(g, i, pref * gi)
                np.add.at(g, j, pref * gj)
                np.add.at(g, k, pref * gk)

        if len(self.vdw_idx):
            i, j = self.vdw_idx[:, 0], self.vdw_idx[:, 1]
            d = x[i] - x[j]
            r = np.sqrt((d * d).sum(-1) + 1e-12)
            q = self.vdw_r0 / r
            q6 = q ** 6
            e += float((self.vdw_eps * (q6 * q6 - 2.0 * q6)).sum())
            if want_grad:
                # dE/dr = eps * (-12 q^12 + 12 q^6) / r
                dedr = self.vdw_eps * 12.0 * (q6 - q6 * q6) / r
                f = (dedr / r)[:, None] * d
                np.add.at(g, i, f)
                np.add.at(g, j, -f)

        if len(self.chir_idx):
            p1 = x[self.chir_idx[:, 0]]
            p2 = x[self.chir_idx[:, 1]]
            p3 = x[self.chir_idx[:, 2]]
            p4 = x[self.chir_idx[:, 3]]
            a = p2 - p1
            b = p3 - p1
            c = p4 - p1
            bc = np.cross(b, c)
            vol = (a * bc).sum(-1)
            # flat-bottomed: penalize sign*vol falling below the margin
            gap = _CHIRAL_MARGIN - self.chir_sign * vol
            act = gap > 0.0
            e += float(_K_CHIRAL * (np.maximum(gap, 0.0) ** 2).sum())
            if want_grad and act.any():
                pref = np.where(act, -2.0 * _K_CHIRAL * gap * self.chir_sign,
                                0.0)[:, None]
                dv2 = bc                      # dvol/dp2
                dv3 = np.cross(c, a)          # dvol/dp3
                dv4 = np.cross(a, b)          # dvol/dp4
                dv1 = -(dv2 + dv3 + dv4)
                np.add.at(g, self.chir_idx[:, 0], pref * dv1)
                np.add.at(g, self.chir_idx[:, 1], pref * dv2)
                np.add.at(g, self.chir_idx[:, 2], pref * dv3)
                np.add.at(g, self.chir_idx[:, 3], pref * dv4)

        return e, g

    # -- FIRE minimizer ---------------------------------------------------

    def minimize(self, x: np.ndarray, max_iter: int = 600,
                 ftol: float = 0.05) -> Tuple[np.ndarray, float]:
        """FIRE relaxation; returns (coords, final energy). Converges
        when the max per-atom force norm drops under `ftol`."""
        x = np.asarray(x, dtype=np.float64).copy()
        v = np.zeros_like(x)
        dt, dt_max = 0.02, 0.12
        alpha, alpha0 = 0.1, 0.1
        n_pos = 0
        e, g = self.energy_grad(x)
        for _ in range(max_iter):
            f = -g
            if np.sqrt((f * f).sum(-1)).max() < ftol:
                break
            p = float((f * v).sum())
            if p > 0.0:
                n_pos += 1
                fn = np.sqrt((f * f).sum()) + 1e-12
                vn = np.sqrt((v * v).sum())
                v = (1.0 - alpha) * v + alpha * (f / fn) * vn
                if n_pos > 5:
                    dt = min(dt * 1.1, dt_max)
                    alpha *= 0.99
            else:
                v[:] = 0.0
                dt *= 0.5
                alpha = alpha0
                n_pos = 0
            v = v + dt * f
            # cap the per-step displacement for stability on raw embeds
            step = dt * v
            smax = np.sqrt((step * step).sum(-1)).max()
            if smax > 0.25:
                step *= 0.25 / smax
            x = x + step
            e, g = self.energy_grad(x)
        return x, float(e)


def _dihedral(x: np.ndarray, idx: np.ndarray, want_grad: bool):
    """Signed dihedrals phi (m,) for (i,j,k,l) rows plus, when asked,
    the Blondel-Karplus gradient [dphi/dxi, dxj, dxk, dxl] each (m,3)."""
    i, j, k, l = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    b1 = x[j] - x[i]
    b2 = x[k] - x[j]
    b3 = x[l] - x[k]
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    nb2 = np.sqrt((b2 * b2).sum(-1) + 1e-12)
    m1 = np.cross(n1, b2 / nb2[:, None])
    xx = (n1 * n2).sum(-1)
    yy = (m1 * n2).sum(-1)
    phi = np.arctan2(yy, xx)
    if not want_grad:
        return phi, None
    # dphi/dx for THIS phi convention (atan2(m1.n2, n1.n2) with
    # m1 = n1 x b2_hat), verified against central differences over
    # random configurations (coati_tpu's tests/test_forcefield.py):
    #   gi = |b2| n1 / |n1|^2,     gl = -|b2| n2 / |n2|^2,
    #   gj = -(1+t1) gi + t2 gl,   gk = t1 gi - (1+t2) gl,
    # with t1 = b1.b2/|b2|^2, t2 = b3.b2/|b2|^2 (sum is zero:
    # translation invariance).
    ln1 = (n1 * n1).sum(-1) + 1e-12
    ln2 = (n2 * n2).sum(-1) + 1e-12
    gi = (nb2 / ln1)[:, None] * n1
    gl = (-nb2 / ln2)[:, None] * n2
    t1 = ((b1 * b2).sum(-1) / (nb2 * nb2))[:, None]
    t2 = ((b3 * b2).sum(-1) / (nb2 * nb2))[:, None]
    gj = -(1.0 + t1) * gi + t2 * gl
    gk = t1 * gi - (1.0 + t2) * gl
    return phi, (gi, gj, gk, gl)


def build_forcefield(g, tetra: Sequence[Tuple[int, Tuple[int, int, int, int], float]] = (),
                     cistrans: Sequence[Tuple[int, int, int, int, bool]] = ()) -> ForceField:
    """Compile a ForceField from a conformers._HGraph-shaped graph
    (duck-typed: .n/.elem/.arom/.edges/.adj/.angle/.ring_size).
    `tetra` rows are (center, ordered-4-neighbors, sign) signed-volume
    restraints; `cistrans` rows are (i, a, b, l, is_trans) pinned
    torsions about stereo double bonds (both from _HGraph)."""
    from coati_tpu_torch.chem.conformers import (
        _RING_ANGLE, _SP2_ANGLE, _SP_ANGLE, _bond_length, _vdw,
    )

    ff = ForceField(g.n)
    bonds = []
    r0s = []
    order_of = {}
    arom_of = {}
    for a, b, order, ar in g.edges:
        bonds.append((a, b))
        r0s.append(_bond_length(g.elem[a], g.elem[b], order, ar))
        order_of[(a, b)] = order_of[(b, a)] = order
        arom_of[(a, b)] = arom_of[(b, a)] = ar
    ff.bond_idx = np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
    ff.bond_r0 = np.asarray(r0s)

    angles = []
    t0s = []
    for j in range(g.n):
        nbrs = [v for v, _, _ in g.adj[j]]
        theta = g.angle[j]
        theta_ring = _RING_ANGLE.get(g.ring_size[j])
        for xi in range(len(nbrs)):
            for yi in range(xi + 1, len(nbrs)):
                i, k = nbrs[xi], nbrs[yi]
                th = theta
                if (theta_ring is not None
                        and g.ring_size[i] == g.ring_size[j]
                        and g.ring_size[k] == g.ring_size[j]):
                    th = theta_ring
                angles.append((i, j, k))
                t0s.append(th)
    ff.angle_idx = np.asarray(angles, dtype=np.int64).reshape(-1, 3)
    ff.angle_t0 = np.asarray(t0s)

    # stereo-pinned (a, b) -> {(i, l): is_trans}
    pinned = {}
    for i, a, b, l, is_trans in cistrans:
        pinned.setdefault((a, b), {})[(i, l)] = is_trans
        pinned.setdefault((b, a), {})[(l, i)] = is_trans

    tors = []
    tn, tv, tg = [], [], []
    seen_tors = set()
    for a, b, order, ar in g.edges:
        if g.angle[a] >= _SP_ANGLE - 1e-6 or g.angle[b] >= _SP_ANGLE - 1e-6:
            continue  # torsion undefined about a linear center
        pins = pinned.get((a, b), {})
        for i, _, _ in g.adj[a]:
            if i == b:
                continue
            for l, _, _ in g.adj[b]:
                if l == a or l == i:
                    continue
                key = (i, a, b, l) if (a, b, i, l) <= (b, a, l, i) else (l, b, a, i)
                if key in seen_tors:
                    continue
                seen_tors.add(key)
                if (i, l) in pins:
                    # 1-fold pin: min at pi for trans, 0 for cis
                    tors.append((i, a, b, l))
                    tn.append(1.0)
                    tv.append(_V_TORSION_STEREO)
                    tg.append(0.0 if pins[(i, l)] else math.pi)
                elif ar or order >= 2:
                    tors.append((i, a, b, l))
                    tn.append(2.0)
                    tv.append(_V_TORSION_PLANAR)
                    tg.append(math.pi)  # minima at 0 and pi (planar)
                else:
                    tors.append((i, a, b, l))
                    tn.append(3.0)
                    tv.append(_V_TORSION_SP3)
                    tg.append(0.0)  # minima staggered
    ff.tors_idx = np.asarray(tors, dtype=np.int64).reshape(-1, 4)
    ff.tors_n = np.asarray(tn)
    ff.tors_v = np.asarray(tv)
    ff.tors_g = np.asarray(tg)

    imprs = []
    for c_ in range(g.n):
        if abs(g.angle[c_] - _SP2_ANGLE) > 1e-6:
            continue
        nbrs = [v for v, _, _ in g.adj[c_]]
        if len(nbrs) == 3:
            imprs.append((c_, nbrs[0], nbrs[1], nbrs[2]))
    ff.impr_idx = np.asarray(imprs, dtype=np.int64).reshape(-1, 4)

    # topological distance (1-2/1-3 excluded, 1-4 scaled) via 3-step BFS
    n = g.n
    sep = np.full((n, n), 9, dtype=np.int8)
    np.fill_diagonal(sep, 0)
    for a, b, _, _ in g.edges:
        sep[a, b] = sep[b, a] = 1
    for _ in range(2):  # propagate to separations 2 and 3
        nxt = sep.copy()
        for a, b, _, _ in g.edges:
            np.minimum(nxt[a], sep[b] + 1, out=nxt[a])
            np.minimum(nxt[b], sep[a] + 1, out=nxt[b])
        sep = nxt
    vdw_pairs = []
    vdw_r0 = []
    vdw_eps = []
    for i in range(n):
        for k in range(i + 1, n):
            if sep[i, k] <= 2:
                continue
            scale = _VDW_14_SCALE if sep[i, k] == 3 else 1.0
            vdw_pairs.append((i, k))
            vdw_r0.append(0.95 * (_vdw(g.elem[i]) + _vdw(g.elem[k])))
            vdw_eps.append(_EPS_VDW * scale)
    ff.vdw_idx = np.asarray(vdw_pairs, dtype=np.int64).reshape(-1, 2)
    ff.vdw_r0 = np.asarray(vdw_r0)
    ff.vdw_eps = np.asarray(vdw_eps)

    if tetra:
        ff.chir_idx = np.asarray([t[1] for t in tetra], dtype=np.int64)
        ff.chir_sign = np.asarray([t[2] for t in tetra])
    return ff
