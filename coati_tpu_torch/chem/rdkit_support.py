"""RDKit quarantine module.

The port's own copy of coati_tpu/chem/rdkit_support.py: the same code and the
same results, importing nothing of the JAX package.

All RDKit usage in the framework goes through here (mirroring the
reference's containers/rdkit_utils.py quarantine pattern). RDKit is an
optional host-side dependency: every function either works without it
(documented fallback) or raises a clear ImportError.

Parity targets: coati/containers/rdkit_utils.py (works_on_smiles :32,
canon_smiles :82, sim_mol :94, identical_canonsmi :104, permute_smiles
:115, mol_to_morgan :140, mol_to_atoms_coords :162, mol_standardize :226,
mol_properties :249, read_sdf :222, draw helpers :110,123).
"""

from __future__ import annotations

import functools
import random
import re
from operator import itemgetter
from typing import Any, Dict, List, Optional

import numpy as np

try:  # optional host-side dependency
    import rdkit
    from rdkit import Chem, DataStructs
    from rdkit.Chem import (
        Crippen,
        Descriptors,
        Draw,
        Lipinski,
        PandasTools,
        rdMolDescriptors,
    )
    from rdkit.Chem.AllChem import (
        EmbedMolecule,
        EmbedMultipleConfs,
        GetMorganFingerprintAsBitVect,
    )
    from rdkit.Chem.MolStandardize.rdMolStandardize import Uncharger
    from rdkit.Chem.rdForceFieldHelpers import MMFFOptimizeMoleculeConfs
    from rdkit.Chem.SaltRemover import SaltRemover

    HAS_RDKIT = True
except ImportError:
    HAS_RDKIT = False


def require_rdkit(what: str = "this operation") -> None:
    if not HAS_RDKIT:
        raise ImportError(
            f"RDKit is required for {what} but is not installed. "
            "Install rdkit, or use the *_or_fallback variants where provided."
        )


def rdkit_version() -> str:
    require_rdkit("rdkit_version")
    return rdkit.__version__


def disable_logger() -> None:
    if HAS_RDKIT:
        from rdkit import RDLogger

        RDLogger.DisableLog("rdApp.*")


def works_on_smiles(raise_on_failure: bool):
    """Decorator lifting a Mol -> Mol/any function to also accept SMILES
    (and convert Mol results back to SMILES)."""

    def decorator(mol_func):
        @functools.wraps(mol_func)
        def wrapped(*args, **kwargs):
            if isinstance(args[0], str):
                require_rdkit(mol_func.__name__)
                mol = Chem.MolFromSmiles(args[0])
                if mol is None:
                    if raise_on_failure:
                        raise ValueError(f"{args[0]} could not be converted to mol.")
                    return None
                new_args = (mol,) + tuple(args[1:])
                try:
                    results = mol_func(*new_args, **kwargs)
                except Exception as ex:  # noqa: BLE001
                    if raise_on_failure:
                        raise
                    print(f"Exception: {ex} for smiles: {args[0]}")
                    return None
                if isinstance(results, Chem.Mol):
                    return Chem.MolToSmiles(results)
                if isinstance(results, tuple):
                    return tuple(
                        Chem.MolToSmiles(r) if isinstance(r, Chem.Mol) else r
                        for r in results
                    )
                return results
            return mol_func(*args, **kwargs)

        return wrapped

    return decorator


# ------------------------------------------------------- canonicalization


def canon_smiles(s: str) -> str:
    """Kekulized canonical SMILES, 'BAD_SMILES' on failure (reference
    semantics). Without RDKit the in-tree canonicalizer
    (chem/graph_canon.py: WL refinement + min-string tie-break) provides
    a real canonical form — invariant under atom-order permutation,
    though written aromatic-form rather than kekulized; grammar outside
    the in-tree parser (wildcards, extended chirality) passes through
    on a syntax check instead."""
    if not HAS_RDKIT:
        from coati_tpu_torch.chem import graph_canon

        try:
            return graph_canon.canonical_smiles(s)
        except Exception:  # noqa: BLE001
            return s if _plausible_smiles(s) else "BAD_SMILES"
    try:
        m = Chem.MolFromSmiles(s)
        if m is None:
            return "BAD_SMILES"
        Chem.Kekulize(m)
        return Chem.MolToSmiles(m)
    except Exception:  # noqa: BLE001
        return "BAD_SMILES"


def canonicalize_or_self(s: str) -> str:
    """Chem.CanonSmiles when available, else the in-tree canonical form
    (graph_canon.canonical_smiles), else the input unchanged. Host
    pipelines and uniqueness statistics use this: previously the
    no-RDKit path was the identity, so offline dedup counted different
    writings of one molecule as distinct."""
    if not HAS_RDKIT:
        from coati_tpu_torch.chem import graph_canon

        try:
            return graph_canon.canonical_smiles(s)
        except Exception:  # noqa: BLE001
            return s
    try:
        return Chem.CanonSmiles(s)
    except Exception:  # noqa: BLE001
        return s


def is_valid_smiles(s: str) -> bool:
    """RDKit validity when available; else GRAPH-level validation via
    the in-tree parser (parse + kekulize + per-atom valence check,
    chem/selfies_lite.py) with the old syntax check as a last resort
    for grammar the parser doesn't cover (wildcards, extended
    chirality)."""
    if HAS_RDKIT:
        return Chem.MolFromSmiles(s) is not None
    if "*" in s or "@T" in s or "@A" in s or "@S" in s:
        # grammar the in-tree parser rejects but RDKit accepts
        # (wildcards, extended chirality): syntax check only
        return _plausible_smiles(s)
    from coati_tpu_torch.chem import selfies_lite as _sl

    return _sl.validate_smiles(s)


_ATOM_RE = re.compile(
    r"(\[[^\]]+\]|Br|Cl|Si|Se|se|As|b|c|n|o|p|s|B|C|N|O|P|S|F|I|\*)"
)


def _plausible_smiles(s: str) -> bool:
    """Syntax-level SMILES plausibility (NOT chemical validity): balanced
    parens/brackets, matched ring-bond digits, only legal characters."""
    if not s:
        return False
    depth = 0
    rings: dict = {}
    i, n = 0, len(s)
    bond_chars = set("-=#:/\\.~$")
    while i < n:
        ch = s[i]
        if ch == "(":
            depth += 1
            i += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                return False
            i += 1
        elif ch == "[":
            j = s.find("]", i)
            if j < 0:
                return False
            i = j + 1
        elif ch == "%":
            if i + 2 >= n or not s[i + 1 : i + 3].isdigit():
                return False
            num = s[i + 1 : i + 3]
            rings[num] = not rings.get(num, False)
            i += 3
        elif ch.isdigit():
            rings[ch] = not rings.get(ch, False)
            i += 1
        elif ch in bond_chars or ch == "@" or ch in "+":
            i += 1
        else:
            m = _ATOM_RE.match(s, i)
            if not m:
                return False
            i = m.end()
    return depth == 0 and not any(rings.values())


def permute_smiles(smiles: str) -> str:
    """Random atom-order SMILES (augmentation, reference
    rdkit_utils.py). Without RDKit the in-tree parser provides the
    permutation (aromatic-form-preserving random DFS; stereo molecules
    pass through unchanged since @/cis-trans markers are
    traversal-order-dependent). Previously this fallback was the
    identity, so p_randsmiles augmentation silently did nothing
    offline."""
    if not HAS_RDKIT:
        from coati_tpu_torch.chem import selfies_lite as _sl

        try:
            return _sl.permute_smiles(smiles)
        except _sl.EncoderError:
            return smiles
    mol = Chem.MolFromSmiles(smiles)
    order = list(range(mol.GetNumAtoms()))
    random.shuffle(order)
    return Chem.MolToSmiles(Chem.RenumberAtoms(mol, order), canonical=False)


def identical_canonsmi(smi1: str, smi2: str, use_chiral: int = 1) -> bool:
    """Same molecule under canonicalization (reference
    rdkit_utils.py:104). Offline: in-tree canonical forms compare,
    with useChiral=0 stripping tetrahedral/cis-trans markers first."""
    if not HAS_RDKIT:
        from coati_tpu_torch.chem import graph_canon

        return graph_canon.canonical_smiles(
            smi1, use_chiral=bool(use_chiral)
        ) == graph_canon.canonical_smiles(smi2, use_chiral=bool(use_chiral))
    return Chem.CanonSmiles(smi1, useChiral=use_chiral) == Chem.CanonSmiles(
        smi2, useChiral=use_chiral
    )


# --------------------------------------------------------- fingerprints


def sim_mol(mol1, mol2) -> float:
    """ECFP4/2048 Tanimoto similarity (reference rdkit_utils.py:94).
    Offline the in-tree circular fingerprint computes it for SMILES
    inputs (chem/fingerprints.py; bit layout differs from RDKit but
    the similarity structure is what callers consume)."""
    if not HAS_RDKIT:
        if isinstance(mol1, str) and isinstance(mol2, str):
            from coati_tpu_torch.chem.fingerprints import smiles_similarity

            return smiles_similarity(mol1, mol2)
        require_rdkit("sim_mol on Mol objects")
    return _sim_mol_rdkit(mol1, mol2)


@works_on_smiles(raise_on_failure=True)
def _sim_mol_rdkit(mol1, mol2) -> float:
    if isinstance(mol2, str):
        mol2 = Chem.MolFromSmiles(mol2)
    fp1 = rdMolDescriptors.GetMorganFingerprintAsBitVect(mol1, 2, 2048)
    fp2 = rdMolDescriptors.GetMorganFingerprintAsBitVect(mol2, 2, 2048)
    return DataStructs.TanimotoSimilarity(fp1, fp2)


def mol_to_morgan(
    mol, radius: int = 3, n_bits: int = 2048, chiral: bool = False, features: bool = False
) -> np.ndarray:
    """Morgan fingerprint bit vector (reference rdkit_utils.py:140).
    Offline: the in-tree ECFP for SMILES inputs (features=FCFP still
    needs RDKit's feature typer and raises without it)."""
    if not HAS_RDKIT:
        if features:
            require_rdkit("feature-typed (FCFP) fingerprints")
        if isinstance(mol, str):
            from coati_tpu_torch.chem.fingerprints import morgan_fingerprint

            return morgan_fingerprint(
                mol, radius=radius, n_bits=n_bits, chiral=chiral
            )
        require_rdkit("mol_to_morgan on Mol objects")
    return _mol_to_morgan_rdkit(
        mol, radius=radius, n_bits=n_bits, chiral=chiral, features=features
    )


@works_on_smiles(raise_on_failure=True)
def _mol_to_morgan_rdkit(
    mol, radius: int = 3, n_bits: int = 2048, chiral: bool = False, features: bool = False
) -> np.ndarray:
    bits = GetMorganFingerprintAsBitVect(
        mol, radius=radius, nBits=n_bits, useChirality=chiral, useFeatures=features
    )
    return np.frombuffer(bits.ToBitString().encode(), "u1") - ord("0")


# ----------------------------------------------------------- 3D / props


def mol_to_atoms_coords(
    m,
    hydrogenate: bool = True,
    adj_matrix: bool = False,
    do_morgan: bool = False,
    optimize: bool = False,
    numConfs: int = 1,
    numThreads: int = 1,
):
    """ETKDG conformer embed (+ optional MMFF94s optimize, lowest-energy
    conformer) -> (atoms, coords[, adjacency][, morgan][, energy]).
    Offline: the in-tree distance-geometry embedder
    (chem/conformers.py — bounds + triangle smoothing + metrized MDS +
    refinement) runs for SMILES inputs, so the 3D/point-encoder path
    works from raw SMILES without rdkit; `optimize` selects the
    lowest-stress of numConfs embeddings (stress = energy surrogate)."""
    if not HAS_RDKIT:
        if not isinstance(m, str):
            require_rdkit("mol_to_atoms_coords on Mol objects")
        from coati_tpu_torch.chem.conformers import embed_smiles_to_atoms_coords

        try:
            return embed_smiles_to_atoms_coords(
                m, hydrogenate=hydrogenate, adj_matrix=adj_matrix,
                do_morgan=do_morgan, optimize=optimize, numConfs=numConfs,
                numThreads=numThreads,
            )
        except Exception:  # noqa: BLE001 - mirror raise_on_failure=False
            return None
    return _mol_to_atoms_coords_rdkit(
        m, hydrogenate=hydrogenate, adj_matrix=adj_matrix,
        do_morgan=do_morgan, optimize=optimize, numConfs=numConfs,
        numThreads=numThreads,
    )


@works_on_smiles(raise_on_failure=False)
def _mol_to_atoms_coords_rdkit(
    m,
    hydrogenate: bool = True,
    adj_matrix: bool = False,
    do_morgan: bool = False,
    optimize: bool = False,
    numConfs: int = 1,
    numThreads: int = 1,
):
    m3 = Chem.AddHs(m) if hydrogenate else m
    lowest_energy = None
    if optimize and hydrogenate:
        try:
            EmbedMultipleConfs(
                m3,
                randomSeed=0xF00D,
                numConfs=numConfs,
                pruneRmsThresh=0.125,
                ETversion=1,
                numThreads=numThreads,
            )
            opt = np.array(
                MMFFOptimizeMoleculeConfs(
                    m3, mmffVariant="MMFF94s", numThreads=numThreads, maxIters=10000
                )
            )
            converged = opt[:, 0] == 0
            best = np.argmin(opt[converged][:, 1])
            lowest_energy = opt[converged][best, 1]
            conf_id = int(np.arange(opt.shape[0])[converged][best])
            c0 = m3.GetConformer(id=conf_id)
        except Exception:  # noqa: BLE001
            EmbedMolecule(m3, randomSeed=0xF00D)
            c0 = m3.GetConformers()[-1]
    else:
        EmbedMolecule(m3, randomSeed=0xF00D)
        c0 = m3.GetConformers()[-1]
    coords = c0.GetPositions()
    atoms = np.array([a.GetAtomicNum() for a in m3.GetAtoms()], dtype=np.uint8)
    out = [atoms, coords]
    if adj_matrix:
        out.append(Chem.GetAdjacencyMatrix(m3))
    if do_morgan:
        out.append(mol_to_morgan(m, radius=3, n_bits=2048, chiral=False))
    if optimize:
        out.append(lowest_energy)
    return tuple(out)


def mol_standardize(mol):
    """Strip salts, keep the largest fragment, neutralize (reference
    rdkit_utils.py:227-248). Offline the in-tree standardizer
    (chem/standardize.py: canonical salt matching + largest fragment +
    Uncharger H-shuffle) handles SMILES inputs and returns a SMILES
    string; with rdkit the original Mol pipeline runs."""
    if not HAS_RDKIT:
        if not isinstance(mol, str):
            require_rdkit("mol_standardize on Mol objects")
        from coati_tpu_torch.chem.standardize import standardize_smiles

        return standardize_smiles(mol)
    return _mol_standardize_rdkit(mol)


@works_on_smiles(raise_on_failure=False)
def _mol_standardize_rdkit(mol):
    res = SaltRemover().StripMol(mol, dontRemoveEverything=True)
    if res.GetNumAtoms():
        frags = sorted(
            ((x.GetNumAtoms(), x) for x in Chem.GetMolFrags(res, asMols=True)),
            key=itemgetter(0),
            reverse=True,
        )
        if frags:
            return Uncharger().uncharge(frags[0][1])
        return None
    print(f'Failed salt removal: "{Chem.MolToSmiles(mol)}"')
    return None


def mol_properties(mol) -> Dict[str, Any]:
    """Descriptor dict (reference rdkit_utils.py:249-265). Offline the
    in-tree engines compute the full set: chem/descriptors.py for the
    counts/TPSA/weights, chem/crippen.py for MolLogP (Wildman-Crippen
    tables over the in-tree SMARTS matcher), chem/qed.py for QED."""
    if not HAS_RDKIT:
        if not isinstance(mol, str):
            require_rdkit("mol_properties on Mol objects")
        from coati_tpu_torch.chem.crippen import mol_logp
        from coati_tpu_torch.chem.descriptors import molecular_descriptors
        from coati_tpu_torch.chem.qed import qed

        try:
            out = dict(molecular_descriptors(mol))
        except Exception:  # noqa: BLE001
            return None
        # MolLogP/QED run per-key: a molecule the descriptor engine
        # handles but the SMARTS/kekulize path trips on (EncoderError in
        # aromaticity) keeps its count/TPSA conditioning tokens and
        # loses only the failing keys.
        try:
            out["MolLogP"] = mol_logp(mol)
        except Exception:  # noqa: BLE001
            pass
        try:
            out["QED"] = qed(mol)
        except Exception:  # noqa: BLE001
            pass
        return out
    return _mol_properties_rdkit(mol)


@works_on_smiles(raise_on_failure=False)
def _mol_properties_rdkit(mol) -> Dict[str, Any]:
    return {
        "MolWt": Descriptors.MolWt(mol),
        "TPSA": Descriptors.TPSA(mol),
        "FractionCSP3": Lipinski.FractionCSP3(mol),
        "HeavyAtomCount": Lipinski.HeavyAtomCount(mol),
        "NumAliphaticRings": Lipinski.NumAliphaticRings(mol),
        "NumAromaticRings": Lipinski.NumAromaticRings(mol),
        "NumHAcceptors": Lipinski.NumHAcceptors(mol),
        "NumHDonors": Lipinski.NumHDonors(mol),
        "NumHeteroatoms": Lipinski.NumHeteroatoms(mol),
        "NumRotatableBonds": Lipinski.NumRotatableBonds(mol),
        "NumSaturatedRings": Lipinski.NumSaturatedRings(mol),
        "RingCount": Lipinski.RingCount(mol),
        "MolLogP": Crippen.MolLogP(mol),
    }


def read_sdf(sdf: Any):
    require_rdkit("read_sdf")
    return PandasTools.LoadSDF(sdf, smilesName="SMILES")


# -------------------------------------------------------------- drawing


@works_on_smiles(raise_on_failure=True)
def draw_mol(mol, size=(300, 300)):
    return Draw.MolToImage(mol, size=size)


def draw_smi_grid(smis: List[str], mols_per_row=5, sub_img_size=(300, 300), legends=None):
    require_rdkit("draw_smi_grid")
    return Draw.MolsToGridImage(
        [Chem.MolFromSmiles(s) for s in smis],
        molsPerRow=mols_per_row,
        subImgSize=sub_img_size,
        legends=legends,
    )
