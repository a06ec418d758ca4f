"""Offline molecule standardization via the in-tree parser (no RDKit).

The port's own copy of coati_tpu/chem/standardize.py: the same code and the
same results, importing nothing of the JAX package.

Substitute for the reference's mol_standardize pipeline
(containers/rdkit_utils.py:227-248: SaltRemover -> largest fragment ->
Uncharger) so dataset preparation works without the package:

1. Salt stripping — fragments whose charge-stripped canonical form
   (chem/graph_canon.py) matches the canonicalized RDKit default salt
   list (Data/Salts.txt patterns, expanded to common protonation
   states) are removed. `dontRemoveEverything` semantics: if every
   fragment is a salt, the largest one survives.
2. Largest fragment by heavy-atom count (ties broken by canonical
   string, so the choice is input-order-invariant; the reference's
   sort is stable on rdkit's fragment order instead).
3. Uncharge — the Uncharger's core H-shuffle: negatively charged atoms
   gain a proton, positively charged atoms with at least one hydrogen
   lose one; quaternary nitrogens and other H-free cations stay
   charged, metals are left alone (they are salt-stripped anyway).

Differences from RDKit are documented, not silent: matching is by
whole-fragment canonical identity rather than substructure, and the
result is a SMILES string (the offline pipeline has no Mol type to
return).
"""

from __future__ import annotations

from typing import List, Optional, Set

from coati_tpu_torch.chem.graph_canon import canonical_smiles
from coati_tpu_torch.chem.selfies_lite import (
    Bond,
    Mol,
    _Node,
    _ORGANIC,
    parse_smiles,
    write_smiles,
)

__all__ = ["standardize_smiles", "split_fragments"]

# RDKit Data/Salts.txt defaults, written as SMILES in neutral and the
# common ionized protonation states (matching is by canonical form of
# the charge-stripped fragment, so one neutral writing per salt is
# enough; ionized forms are kept for readability/documentation).
_SALTS = [
    "Cl", "Br", "I", "F",
    "[Li+]", "[Na+]", "[K+]", "[Ca+2]", "[Mg+2]", "[Li]", "[Na]", "[K]",
    "O", "N",
    "ON(=O)=O",  # nitric
    "OP(=O)(O)O",  # phosphoric
    "FP(F)(F)(F)(F)F",  # hexafluorophosphate
    "OS(=O)(=O)O",  # sulfuric
    "CS(=O)(=O)O",  # methanesulfonic
    "Cc1ccc(cc1)S(=O)(=O)O",  # p-toluenesulfonic
    "CC(=O)O",  # acetic
    "OC(=O)C(F)(F)F",  # trifluoroacetic
    "OC(=O)C=CC(=O)O",  # fumaric/maleic
    "OC(=O)C(=O)O",  # oxalic
    "OC(=O)C(O)C(O)C(=O)O",  # tartaric
    "C1CCC(CC1)NC1CCCCC1",  # dicyclohexylamine
]

_salt_canon: Set[str] = set()


def _neutral_key(smiles: str) -> Optional[str]:
    """Canonical form with charges and their explicit H bookkeeping
    stripped — so Cl / [Cl-], CC(=O)O / CC(=O)[O-] compare equal."""
    try:
        mol = parse_smiles(smiles)
    except Exception:  # noqa: BLE001
        return None
    for a in mol.atoms:
        a.charge = 0
        if a.element in _ORGANIC and not a.isotope:
            a.hcount = None
        a.chirality = ""
    for b in mol.bonds:
        b.stereo = ""
        b.stereo_at = -1
    try:
        return canonical_smiles(write_smiles(mol), use_chiral=False)
    except Exception:  # noqa: BLE001
        return None


def _salt_keys() -> Set[str]:
    if not _salt_canon:
        for s in _SALTS:
            k = _neutral_key(s)
            if k is not None:
                _salt_canon.add(k)
    return _salt_canon


def _submol(mol: Mol, keep: List[int]) -> Mol:
    """Fragment extraction with remapped atoms/bonds; preserves the
    parse-order `written` bond lists so the writer's stereo parity
    fixup stays valid on the fragment."""
    amap = {old: new for new, old in enumerate(keep)}
    keep_set = set(keep)
    atoms = []
    for new, old in enumerate(keep):
        a = mol.atoms[old]
        atoms.append(
            type(a)(a.element, a.aromatic, a.charge, a.isotope,
                    a.chirality, a.hcount, new, 0)
        )
    bonds, bmap = [], {}
    for bi, b in enumerate(mol.bonds):
        if b.a in keep_set and b.b in keep_set:
            bmap[bi] = len(bonds)
            nb = Bond(amap[b.a], amap[b.b], b.order, b.aromatic,
                      b.stereo, -1 if b.stereo_at < 0 else amap[b.stereo_at])
            bonds.append(nb)
    written = [
        [bmap[bi] for bi in mol.written[old] if bi in bmap]
        for old in keep
    ] if len(mol.written) == len(mol.atoms) else []
    roots = [_Node(amap[n.atom]) for n in mol.roots if n.atom in keep_set]
    return Mol(atoms=atoms, bonds=bonds, roots=roots, written=written)


def split_fragments(smiles: str) -> List[str]:
    """Fragment SMILES of each connected component, parse-order."""
    mol = parse_smiles(smiles)
    frags: dict = {}
    for a in mol.atoms:
        frags.setdefault(a.frag, []).append(a.idx)
    return [write_smiles(_submol(mol, atoms)) for atoms in frags.values()]


def _uncharge(mol: Mol) -> None:
    """The Uncharger H-shuffle. Positively charged atoms always carry an
    explicit bracket hcount (charges require brackets, where absent H
    means zero), so H-removal is well-defined; neutralized organic atoms
    drop to implicit H so the writer emits bare symbols."""
    for a in mol.atoms:
        if a.element not in _ORGANIC:
            continue  # metals etc.: salt stripping handles them
        changed = False
        while a.charge < 0:
            a.charge += 1
            changed = True
            if a.hcount is not None:
                a.hcount += 1
        while a.charge > 0 and (a.hcount or 0) > 0:
            a.charge -= 1
            a.hcount -= 1
            changed = True
        # Only atoms the shuffle actually touched get their H count
        # re-derived; clearing hcount on already-neutral atoms would
        # strip load-bearing explicit hydrogens (aromatic [nH],
        # radicals like [CH3]) and corrupt the molecule.
        if changed and a.charge == 0 and not a.isotope and not a.chirality:
            a.hcount = None  # re-derive implicit H from valence


def standardize_smiles(smiles: str) -> Optional[str]:
    """Salt-strip -> largest fragment -> uncharge, as a SMILES string.
    Returns None when nothing parseable or nothing survives (reference
    mol_standardize returns None on the same conditions)."""
    try:
        mol = parse_smiles(smiles)
    except Exception:  # noqa: BLE001
        return None
    if not mol.atoms:
        return None
    frags: dict = {}
    for a in mol.atoms:
        frags.setdefault(a.frag, []).append(a.idx)
    salt_keys = _salt_keys()
    parts = []
    for atoms in frags.values():
        sub = _submol(mol, atoms)
        s = write_smiles(sub)
        key = _neutral_key(s)
        # Heavy-atom count: explicit [H] atoms don't count toward
        # fragment size (mirrors rdkit's heavy-atom ordering).
        heavy = sum(1 for i in atoms if mol.atoms[i].element != "H")
        canon = canonical_smiles(s) if key is not None else s
        parts.append((heavy, canon, key in salt_keys if key else False, sub))
    survivors = [p for p in parts if not p[2]]
    if not survivors:
        # dontRemoveEverything: keep the largest salt rather than nothing
        survivors = parts
    # largest heavy-atom count; canonical-string tie-break keeps the
    # choice invariant under fragment reordering
    survivors.sort(key=lambda p: (-p[0], p[1]))
    chosen = survivors[0][3]
    _uncharge(chosen)
    try:
        return write_smiles(chosen)
    except Exception:  # noqa: BLE001
        return None
