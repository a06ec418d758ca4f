"""Wildman-Crippen atomic logP (offline MolLogP).

The port's own copy of coati_tpu/chem/crippen.py: the same code and the
same results, importing nothing of the JAX package.

The reference property pipeline reads `Crippen.MolLogP`
(containers/rdkit_utils.py:264) to build descriptors and the
`[IntMolLogP]` COATI2 conditioning token (vocabs/coati2_12_12.json);
this module computes the same quantity without rdkit, from the
published Wildman & Crippen atom-contribution table (J. Chem. Inf.
Comput. Sci. 1999, 39, 868-873 — the table rdkit ships as
Data/Crippen.txt).

Typing follows the paper/rdkit exactly: hydrogens are promoted to graph
atoms, then every atom takes the FIRST pattern in table order that
matches rooted at it. logP = sum of per-atom contributions.

Pinned cross-checks (coati_tpu's tests/test_crippen_qed.py) reproduce rdkit's
MolLogP on hand-computed molecules (benzene 1.6866, ethanol -0.0014,
aspirin 1.3101, ...); full-table agreement is asserted by the gated
rdkit oracle test when the package is present.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

from coati_tpu_torch.chem.aromaticity import perceive_aromaticity
from coati_tpu_torch.chem.selfies_lite import parse_smiles
from coati_tpu_torch.chem.smarts import (
    MolContext,
    add_explicit_hydrogens,
    compile_smarts,
)

__all__ = ["mol_logp", "crippen_contributions", "atom_types"]

# (type, SMARTS, logP contribution) in table order — first match wins.
_TABLE: List[Tuple[str, str, float]] = [
    ("C1", "[CH4]", 0.1441),
    ("C1", "[CH3]C", 0.1441),
    ("C1", "[CH2](C)C", 0.1441),
    ("C2", "[CH](C)(C)C", 0.0),
    ("C2", "[C](C)(C)(C)C", 0.0),
    ("C3", "[CH3][N,O,P,S,F,Cl,Br,I]", -0.2035),
    ("C3", "[CH2X4][N,O,P,S,F,Cl,Br,I]", -0.2035),
    ("C4", "[CH1X4][N,O,P,S,F,Cl,Br,I]", -0.2051),
    ("C4", "[CH0X4][N,O,P,S,F,Cl,Br,I]", -0.2051),
    ("C5", "[C]=[!C;A;!#1]", -0.2783),
    ("C6", "[CH2]=C", 0.1551),
    ("C6", "[CH1](=C)[A;!#1]", 0.1551),
    ("C6", "[CH0](=C)([A;!#1])[A;!#1]", 0.1551),
    ("C6", "[C](=C)=C", 0.1551),
    ("C7", "[CX2]#[A;!#1]", 0.0017),
    ("C8", "[CH3]c", 0.08452),
    ("C9", "[CH3]a", -0.1444),
    ("C10", "[CH2X4]a", -0.0516),
    ("C11", "[CHX4]a", 0.1193),
    ("C12", "[CH0X4]a", -0.0967),
    ("C13", "[cH0]-[A;!C;!N;!O;!S;!F;!Cl;!Br;!I;!#1]", -0.5443),
    ("C14", "[c][#9]", 0.0),
    ("C15", "[c][#17]", 0.245),
    ("C16", "[c][#35]", 0.198),
    ("C17", "[c][#53]", 0.0),
    ("C18", "[cH]", 0.1581),
    ("C19", "[c](:a)(:a):a", 0.2955),
    ("C20", "[c](:a)(:a)-a", 0.2713),
    ("C21", "[c](:a)(:a)-C", 0.136),
    ("C22", "[c](:a)(:a)-N", 0.4619),
    ("C23", "[c](:a)(:a)-O", 0.5437),
    ("C24", "[c](:a)(:a)-S", 0.1893),
    ("C25", "[c](:a)(:a)=C", -0.8186),
    ("C25", "[c](:a)(:a)=N", -0.8186),
    ("C25", "[c](:a)(:a)=O", -0.8186),
    ("C26", "[C](=C)(a)[A;!#1]", 0.264),
    ("C26", "[C](=C)(c)a", 0.264),
    ("C26", "[CH1](=C)a", 0.264),
    ("C26", "[C]=c", 0.264),
    ("C27", "[CX4][A;!C;!N;!O;!P;!S;!F;!Cl;!Br;!I;!#1]", 0.2148),
    ("CS", "[#6]", 0.08129),
    ("H1", "[#1][#6,#1]", 0.1230),
    ("H2", "[#1]O[CX4,c]", -0.2677),
    ("H2", "[#1]O[!C;!N;!O;!S]", -0.2677),
    ("H2", "[#1][!C;!N;!O]", -0.2677),
    ("H3", "[#1][#7]", 0.2142),
    ("H3", "[#1]O[#7]", 0.2142),
    ("H4", "[#1]OC=[#6,#7,#8,#16]", 0.2980),
    ("H4", "[#1]O[O,S]", 0.2980),
    ("HS", "[#1]", 0.1125),
    ("N1", "[NH2+0][A;!#1]", -1.0190),
    ("N2", "[NH+0]([A;!#1])[A;!#1]", -0.7096),
    ("N3", "[NH2+0]a", -1.0270),
    ("N4", "[NH1+0]([!#1;A,a])a", -0.5188),
    ("N5", "[NH+0]=[!#1;A,a]", 0.08387),
    ("N6", "[N+0](=[!#1;A,a])[!#1;A,a]", 0.1836),
    ("N7", "[N+0]([A;!#1])([A;!#1])[A;!#1]", -0.3187),
    ("N8", "[N+0](a)([!#1;A,a])[A;!#1]", -0.4458),
    ("N8", "[N+0](a)(a)a", -0.4458),
    ("N9", "[N+0]#[A;!#1]", 0.01508),
    ("N10", "[NH3,NH2,NH;+,+2,+3]", -1.950),
    ("N11", "[n+0]", -0.3239),
    ("N12", "[n;+,+2,+3]", -1.119),
    ("N13", "[NH0;+,+2,+3]([A;!#1])([A;!#1])([A;!#1])[A;!#1]", -0.3396),
    ("N13", "[NH0;+,+2,+3](=[A;!#1])([A;!#1])[!#1;A,a]", -0.3396),
    ("N13", "[NH0;+,+2,+3](=[#6])=[#7]", -0.3396),
    ("N14", "[N;+,+2,+3]#[A;!#1]", 0.2887),
    ("N14", "[N;-3]", 0.2887),
    ("N14", "[N;+,+2,+3](=[N;-])=N", 0.2887),
    ("NS", "[#7]", -0.4806),
    ("O1", "[o]", 0.1552),
    ("O2", "[OH,OH2]", -0.2893),
    ("O3", "[O]([A;!#1])[A;!#1]", -0.0684),
    ("O4", "[O](a)[!#1;A,a]", -0.4195),
    ("O5", "[O]=[#7,#8]", 0.0335),
    ("O5", "[OX1;-,-2,-3][#7]", 0.0335),
    ("O6", "[OX1;-,-2,-3][#16]", -0.3339),
    ("O6", "[O;-0]=[#16;-0]", -0.3339),
    # O12 precedes O7 in the table so carboxylate oxygens take the
    # dedicated -1.326 contribution (rdkit Crippen.txt ordering quirk)
    ("O12", "[O-]C(=O)", -1.326),
    ("O7", "[OX1;-,-2,-3][!#1;!N;!S]", -1.189),
    ("O8", "[O]=c", 0.1788),
    ("O9", "[O]=[CH]C", -0.1526),
    ("O9", "[O]=C(C)([A;!#1])", -0.1526),
    ("O9", "[O]=[CH][N,O]", -0.1526),
    ("O9", "[O]=[CH2]", -0.1526),
    ("O9", "[O]=[CX2]=O", -0.1526),
    ("O10", "[O]=[CH]c", 0.1129),
    ("O10", "[O]=C([C,c])[a;!#1]", 0.1129),
    ("O10", "[O]=C(c)[A;!#1]", 0.1129),
    ("O11", "[O]=C([!#1;!#6])[!#1;!#6]", 0.4833),
    ("OS", "[#8]", -0.1188),
    ("F", "[#9-0]", 0.4202),
    ("Cl", "[#17-0]", 0.6895),
    ("Br", "[#35-0]", 0.8456),
    ("I", "[#53-0]", 0.8857),
    ("Hal", "[#9,#17,#35,#53;-,-2,-3]", -2.996),
    ("Hal", "[#53;+,+2,+3]", -2.996),
    ("Hal", "[+;#3,#11,#19,#37,#55]", -2.996),
    ("P", "[#15]", 0.8612),
    ("S2", "[S;-,-2,-3,+,+2,+3,+4,+5,+6]", -0.0024),
    ("S1", "[S;-0]", 0.6482),
    ("S3", "[s]", 0.6237),
    ("Me1", "[#3,#11,#19,#37,#55]", -0.3808),
    ("Me1", "[#4,#12,#20,#38,#56]", -0.3808),
    ("Me1", "[#5,#13,#31,#49,#81]", -0.3808),
    ("Me1", "[#14,#32,#50,#82]", -0.3808),
    ("Me1", "[#33,#51,#83]", -0.3808),
    ("Me1", "[#34,#52,#84]", -0.3808),
    ("Me2", "[#21,#22,#23,#24,#25,#26,#27,#28,#29,#30]", -0.0025),
    ("Me2", "[#39,#40,#41,#42,#43,#44,#45,#46,#47,#48]", -0.0025),
    ("Me2", "[#72,#73,#74,#75,#76,#77,#78,#79,#80]", -0.0025),
]


def _compiled():
    return [(t, compile_smarts(p), v) for t, p, v in _TABLE]


_COMPILED = None


def atom_types(smiles: str) -> List[Tuple[str, float]]:
    """(type, contribution) per atom of the H-augmented molecule, in
    atom order (heavy atoms first, then hydrogens)."""
    global _COMPILED
    if _COMPILED is None:
        _COMPILED = _compiled()
    mol = parse_smiles(smiles)
    # rdkit re-perceives aromaticity on parse; the Crippen typer sees
    # the perceived graph (pyrimidinediones etc. type as aromatic)
    perceive_aromaticity(mol)
    mol = add_explicit_hydrogens(mol)
    ctx = MolContext(mol)
    out: List[Tuple[str, float]] = []
    for i in range(len(mol.atoms)):
        for t, pat, v in _COMPILED:
            if pat.match_atom(ctx, i):
                out.append((t, v))
                break
        else:
            out.append(("??", 0.0))
    return out


def crippen_contributions(smiles: str) -> List[float]:
    return [v for _, v in atom_types(smiles)]


@lru_cache(maxsize=100_000)
def mol_logp(smiles: str) -> float:
    """Wildman-Crippen logP (rdkit Crippen.MolLogP analog). Raises
    EncoderError on unparseable SMILES."""
    return round(sum(crippen_contributions(smiles)), 4)
