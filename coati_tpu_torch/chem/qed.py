"""QED — quantitative estimate of drug-likeness (offline).

The port's own copy of coati_tpu/chem/qed.py: the same code and the
same results, importing nothing of the JAX package.

The reference property pipeline reads `QED.qed`
(containers/rdkit_utils.py:249-265 via mol_properties callers and the
`[PercentQED]` COATI2 conditioning token, vocabs/coati2_12_12.json;
the metadynamics examples optimize DUE heads trained on it,
examples/metadynamics/due_qed_barlow.pt). This module computes the
same quantity without rdkit, from the published Bickerton et al. 2012
("Quantifying the chemical beauty of drugs", Nat. Chem. 4, 90-98)
parameterization that rdkit ships:

  QED = exp( sum_i w_i * ln d_i(p_i) / sum_i w_i )

over eight properties p = (MW, ALOGP, HBA, HBD, PSA, ROTB, AROM,
ALERTS), each mapped through an asymmetric double sigmoidal
desirability function

  d(x) = (A + B / (1 + exp(-(x - C + D/2)/E))
              * (1 - 1 / (1 + exp(-(x - C - D/2)/F)))) / DMAX

with the published (A..F, DMAX) fits and weight vectors (max / mean /
unit; the rdkit default `qed()` is the MEAN weights).

Property sources (all in-tree, computed on the aromaticity-perceived
graph like rdkit does):
  MW     average molecular weight          chem/descriptors.py
  ALOGP  Wildman-Crippen logP              chem/crippen.py
  HBA    the QED publication's 11-pattern acceptor SMARTS list
  HBD    N/O atoms with >= 1 hydrogen
  PSA    Ertl TPSA                         chem/descriptors.py
  ROTB   strict rotatable-bond SMARTS (rdkit's Strict definition)
  AROM   SSSR rings with every bond aromatic
  ALERTS number of structural-alert SMARTS with >= 1 match

The ALERTS list below is reconstructed from the publication's
supplementary alert set (the Brenk filters, as shipped by rdkit's
QED implementation). It is the best-effort offline reproduction: a
gated test (coati_tpu's tests/test_crippen_qed.py) asserts exact per-property and
per-alert agreement whenever rdkit is importable; molecules with zero
alerts (the druglike bulk) are unaffected by any residual list gap,
and a missing alert shifts QED by at most a few percent on molecules
the filter already flags.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

from coati_tpu_torch.chem.aromaticity import perceive_aromaticity
from coati_tpu_torch.chem.crippen import mol_logp
from coati_tpu_torch.chem.descriptors import sssr_rings, tpsa
from coati_tpu_torch.chem.graph_canon import implicit_hydrogens
from coati_tpu_torch.chem.selfies_lite import Atom, Bond, Mol, kekulize, parse_smiles
from coati_tpu_torch.chem.smarts import MolContext, compile_smarts

__all__ = [
    "qed",
    "qed_properties",
    "weights_max",
    "weights_mean",
    "weights_none",
    "ads",
    "STRUCTURAL_ALERTS",
    "ACCEPTOR_SMARTS",
]

_PROPS = ("MW", "ALOGP", "HBA", "HBD", "PSA", "ROTB", "AROM", "ALERTS")


@dataclass(frozen=True)
class ADSParameter:
    A: float
    B: float
    C: float
    D: float
    E: float
    F: float
    DMAX: float


# Published ADS fits (Bickerton 2012 supplementary table 1).
ADS_PARAMS: Dict[str, ADSParameter] = {
    "MW": ADSParameter(2.817065973, 392.5754953, 290.7489764,
                       2.419764353, 49.22325677, 65.37051707, 104.9805561),
    "ALOGP": ADSParameter(3.172690585, 137.8624751, 2.534937431,
                          4.581497897, 0.822739154, 0.576295591,
                          131.3186604),
    "HBA": ADSParameter(2.948620388, 160.4605972, 3.615294657,
                        4.435986202, 0.290141953, 1.300669958,
                        148.7763046),
    "HBD": ADSParameter(1.618662227, 1010.051101, 0.985094388,
                        0.000000001, 0.713820843, 0.920922555,
                        258.1632616),
    "PSA": ADSParameter(1.876861559, 125.2232657, 62.90773554,
                        87.83366614, 12.01999824, 28.51324732,
                        104.5686167),
    "ROTB": ADSParameter(0.010000000, 272.4121427, 2.558379970,
                         1.565547684, 1.271567166, 2.758063707,
                         105.4420403),
    "AROM": ADSParameter(3.217788970, 957.7374108, 2.274627939,
                         0.000000001, 1.317690384, 0.375760881,
                         312.3372610),
    "ALERTS": ADSParameter(0.010000000, 1199.094025, -0.09002883,
                           0.000000001, 0.185904477, 0.875193782,
                           417.7253140),
}

# Published weight vectors: per-property-optimal (max), mean over the
# top-1000 optima (mean — the rdkit default), and unit.
WEIGHT_MAX = (0.175, 0.180, 0.140, 0.408, 0.300, 0.065, 0.271, 0.462)
WEIGHT_MEAN = (0.66, 0.46, 0.05, 0.61, 0.06, 0.65, 0.48, 0.95)
WEIGHT_NONE = (1.0,) * 8

# H-bond acceptors: the QED publication's acceptor SMARTS definitions.
ACCEPTOR_SMARTS: Tuple[str, ...] = (
    "[oH0;X2]",
    "[OH1;X2;v2]",
    "[OH0;X2;v2]",
    "[OH0;X1;v2]",
    "[O-;X1]",
    "[SH0;X2;v2]",
    "[SH0;X1;v2]",
    "[S-;X1]",
    "[nH0;X2]",
    "[NH0;X1;v3]",
    "[$([N;+0;X3;v3]);!$(N[C,S]=O)]",
)

# Strict rotatable bonds (rdkit NumRotatableBondsOptions.Strict): single
# acyclic bonds, both ends degree >= 2, excluding terminal-symmetric
# tops (CF3/CCl3/CBr3/t-Bu) and amide-like C(=X)-N linkages.
ROTB_SMARTS = (
    "[!$(*#*)&!D1&!$(C(F)(F)F)&!$(C(Cl)(Cl)Cl)&!$(C(Br)(Br)Br)"
    "&!$(C([CH3])([CH3])[CH3])"
    "&!$([CD3](=[N,O,S])-!@[#7,O,S!D1])"
    "&!$([#7,O,S!D1]-!@[CD3]=[N,O,S])"
    "&!$([CD3](=[N+])-!@[#7!D1])"
    "&!$([#7!D1]-!@[CD3]=[N+])]"
    "-!@"
    "[!$(*#*)&!D1&!$(C(F)(F)F)&!$(C(Cl)(Cl)Cl)&!$(C(Br)(Br)Br)"
    "&!$(C([CH3])([CH3])[CH3])]"
)

# Structural alerts (the publication's supplementary set / Brenk
# filters). ALERTS = number of patterns with at least one match.
STRUCTURAL_ALERTS: Tuple[str, ...] = (
    "*1[O,S,N]*1",                                # 3-membered heterocycle
    "[S,C](=[O,S])[F,Br,Cl,I]",                   # acyl halide
    "[CX4][Cl,Br,I]",                             # alkyl halide
    "[#6]S(=O)(=O)O[#6]",                         # sulfonate ester
    "[$([CH]),$(CC)]#CC(=O)[#6]",                 # propiolate ketone
    "[$([CH]),$(CC)]#CC(=O)O[#6]",                # propiolate ester
    "n[OH]",                                      # N-hydroxyl pyridine
    "[$([CH]),$(CC)]#CS(=O)(=O)[#6]",             # alkynyl sulfone
    "C=C(C=O)C=O",                                # bis-enone
    "n1c([F,Cl,Br,I])cccc1",                      # 2-halo pyridine
    "[CH1](=O)",                                  # aldehyde
    "[#8][#8]",                                   # peroxide
    "[C;!R]=[N;!R]",                              # acyclic imine
    "[N!R]=[N!R]",                                # acyclic azo
    "[#6](=O)[#6](=O)",                           # 1,2-dicarbonyl
    "[#16][#16]",                                 # disulfide
    "[#7][NH2]",                                  # hydrazine
    "C(=O)N[NH2]",                                # acyl hydrazide
    "[#6]=S",                                     # thiocarbonyl
    "[$([CH2]),$([CH][CX4]),$(C([CX4])[CX4])]="
    "[$([CH2]),$([CH][CX4]),$(C([CX4])[CX4])]",   # isolated alkene
    "C1(=[O,N])C=CC(=[O,N])C=C1",                 # para-quinone
    "C1(=[O,N])C(=[O,N])C=CC=C1",                 # ortho-quinone
    "a21aa3a(aa1aaaa2)aaaa3",                     # acenaphthylene core
    "a31a(a2a(aa1)aaaa2)aaaa3",                   # fluorene-like core
    "a1aa2a3a(a1)A=AA=A3=AA=A2",                  # partially reduced acene
    "c1cc([NH2])ccc1",                            # aniline
    "[Hg,Fe,As,Sb,Zn,Se,se,Te,B,Si,Na,Ca,Ge,Ag,Mg,K,Ba,Sr,Be,Ti,Mo,"
    "Mn,Ru,Pd,Ni,Cu,Au,Cd,Al,Ga,Sn,Rh,Tl,Bi,Nb,Li,Pb,Hf,Ho]",  # metals
    "I",                                          # iodine
    "OS(=O)(=O)[O-]",                             # sulfate monoester
    "[N+](=O)[O-]",                               # nitro
    "C(=O)N[OH]",                                 # hydroxamic acid
    "C1NC(=O)NC(=O)C1",                           # dihydrouracil-like
    "[SH]",                                       # thiol
    "[S-]",                                       # thiolate
    "c1ccc([Cl,Br,I,F])c([Cl,Br,I,F])c1[Cl,Br,I,F]",  # polyhalo arene
    "c1cc([Cl,Br,I,F])cc([Cl,Br,I,F])c1[Cl,Br,I,F]",  # polyhalo arene
    "[CR1]1[CR1][CR1][CR1][CR1][CR1][CR1]1",      # cycloheptane
    "[CR1]1[CR1][CR1]cc[CR1][CR1]1",              # benzo-fused 7-ring
    "[CR2]1[CR2][CR2][CR2][CR2][CR2][CR2][CR2]1", # cyclooctane (fused)
    "[CR2]1[CR2][CR2]cc[CR2][CR2][CR2]1",         # benzo-fused 8-ring
    "[CH2R2]1N[CH2R2][CH2R2][CH2R2][CH2R2][CH2R2]1",        # azepane fused
    "[CH2R2]1N[CH2R2][CH2R2][CH2R2][CH2R2][CH2R2][CH2R2]1", # azocane fused
    "C#C",                                        # alkyne
    "[OR2,NR2]@[CR2]@[CR2]@[OR2,NR2]@[CR2]@[CR2]@[OR2,NR2]",  # crown ether
    "[$([N+R]),$([n+R]),$([N+]=C)][O-]",          # N-oxide
    "[#6]=N[OH]",                                 # oxime
    "[#6]=NOC=O",                                 # acyl oxime
    "[#6](=O)[CX4,CR0X3,O][#6](=O)",              # 1,3-dicarbonyl
    "[O+,o+,S+,s+]",                              # onium
    "N=C=O",                                      # isocyanate
    "[NX3,NX4][F,Cl,Br,I]",                       # N-halogen
    "c1ccccc1OC(=O)[#6]",                         # phenol ester
    "[CR0]=[CR0][CR0]=[CR0]",                     # acyclic diene
    "[C+,c+,C-,c-]",                              # carbo-cation/anion
    "N=[N+]=[N-]",                                # azide
    "C12C(NC(N1)=O)CSC2",                         # thiazolidinone core
    "c1c([OH])c([OH,NH2,NH])ccc1",                # catechol-like
    "P",                                          # phosphorus
    "[N,O,S]C#N",                                 # cyanate/thiocyanate
    "C=C=O",                                      # ketene
    "[Si][F,Cl,Br,I]",                            # silyl halide
    "[SX2]O",                                     # sulfenic ester
    "[SiR0;X4]([#6])([#6])[#6]",                  # trialkyl silane
    "O1CCCCC1OC2CCC3CCCCC3C2",                    # saponin-like
    "N=[CR0][N,n,O,S]",                           # amidine-like
    "[cR2]1[cR2][cR2]([Nv3X3,Nv4X4])[cR2][cR2][cR2]1"
    "[cR2]2[cR2][cR2][cR2]([Nv3X3,Nv4X4])[cR2][cR2]2",  # benzidine
    "C=[C!r]C#N",                                 # acrylonitrile
    "[cR2]1[cR2]c([N+0X3R0,nX3R0])c([N+0X3R0,nX3R0])[cR2][cR2]1",
    "[cR2]1[cR2]c([N+0X3R0,nX3R0])[cR2]c([N+0X3R0,nX3R0])[cR2]1",
    "[cR2]1[cR2]c([N+0X3R0,nX3R0])[cR2][cR2]c1([N+0X3R0,nX3R0])",
    "[OH]c1ccc([OH,NH2,NH])cc1",                  # hydroquinone
    "c1ccccc1OC(=O)O",                            # phenol carbonate
    "[SX2H0][N]",                                 # sulfenamide
    "c12ccccc1(SC(S)=N2)",                        # benzothiazole-2-thiol
    "c12ccccc1(SC(=S)N2)",                        # benzothiazole-2-thione
    "c1nnnn1C=O",                                 # acyl tetrazole
    "s1c(S)nnc1NC=O",                             # thiadiazole thiol
    "S1C=CSC1=S",                                 # dithiole-thione
    "C(=O)Onn",                                   # acyloxy diazo
    "OS(=O)(=O)C(F)(F)F",                         # triflate
    "N#CC[OH]",                                   # cyanohydrin
    "N#CC(=O)",                                   # acyl cyanide
    "S(=O)(=O)C#N",                               # sulfonyl cyanide
    "N[CH2]C#N",                                  # aminonitrile
    "S(=O)(=O)[O-,OH]",                           # sulfonic acid
    "NC[F,Cl,Br,I]",                              # aminomethyl halide
    "C=[C!r]O",                                   # acyclic enol ether
    "[NX2+0]=[O+0]",                              # nitroso
    "[OR0,NR0][OR0,NR0]",                         # acyclic N/O-N/O
    "C(=O)N[CH3]",                                # N-methyl amide (alert set)
    "c1ccccc1[C;!R]=[C;!R]c2ccccc2",              # stilbene
    "[NX3R0,NX4R0,OR0,SX2R0][CX4][NX3R0,NX4R0,OR0,SX2R0]",  # aminal/acetal
    "[*]=[N+]=[*]",                               # diazo
    "[SX3](=O)[O-,OH]",                           # sulfinic acid
    "N#N",                                        # diazonium / N2
)


def ads(x: float, p: ADSParameter) -> float:
    """Asymmetric double sigmoidal desirability, normalized to DMAX."""
    exp1 = 1.0 + math.exp(-(x - p.C + p.D / 2.0) / p.E)
    exp2 = 1.0 + math.exp(-(x - p.C - p.D / 2.0) / p.F)
    dx = p.A + p.B / exp1 * (1.0 - 1.0 / exp2)
    return dx / p.DMAX


@lru_cache(maxsize=8192)
def _compiled(pattern: str):
    return compile_smarts(pattern)


@lru_cache(maxsize=100_000)
def _qed_properties_cached(smiles: str) -> tuple:
    from coati_tpu_torch.chem.descriptors import molecular_descriptors

    desc = molecular_descriptors(smiles)
    mol = parse_smiles(smiles)
    perceive_aromaticity(mol)
    ctx = MolContext(mol)

    hba = sum(_compiled(p).count_matches(ctx) for p in ACCEPTOR_SMARTS)
    imp_h = implicit_hydrogens(mol)
    # rdkit CalcNumHBD semantics — SMARTS
    # [$([N;!H0;v3,v4&+1]),$([O,S;H1;+0]),n&H1&+0]: N with >=1 H at
    # valence 3 (any charge) or 4 with +1; O/S with EXACTLY one H and
    # neutral (counts thiols, excludes water's H2 and charged O/S).
    # Valence needs kekulized bond orders (aromatic flags carry none).
    km = Mol(
        atoms=[Atom(a.element, a.aromatic, a.charge, a.isotope,
                    a.chirality, a.hcount, a.idx, a.frag)
               for a in mol.atoms],
        bonds=[Bond(b.a, b.b, b.order, b.aromatic) for b in mol.bonds],
        roots=mol.roots,
    )
    kekulize(km)
    bond_sum = [0] * len(km.atoms)
    for b in km.bonds:
        bond_sum[b.a] += b.order
        bond_sum[b.b] += b.order
    hbd = 0
    for a in mol.atoms:
        h = imp_h[a.idx]
        if h < 1:
            continue
        if a.element == "N":
            v = bond_sum[a.idx] + h
            if v == 3 or (v == 4 and a.charge == 1):
                hbd += 1
        elif a.element in ("O", "S") and h == 1 and a.charge == 0:
            hbd += 1
    rotb = _compiled(ROTB_SMARTS).count_matches(ctx)
    arom = sum(
        1 for ring in sssr_rings(mol)
        if all(mol.bonds[bi].aromatic for bi in ring)
    )
    alerts = sum(
        1 for p in STRUCTURAL_ALERTS if _compiled(p).has_match(ctx)
    )
    return (
        ("MW", desc["MolWt"]),
        ("ALOGP", mol_logp(smiles)),
        ("HBA", float(hba)),
        ("HBD", float(hbd)),
        ("PSA", tpsa(mol, imp_h)),
        ("ROTB", float(rotb)),
        ("AROM", float(arom)),
        ("ALERTS", float(alerts)),
    )


def qed_properties(smiles: str) -> Dict[str, float]:
    """The eight QED input properties (rdkit QED.properties analog).
    Raises EncoderError on unparseable SMILES."""
    return dict(_qed_properties_cached(smiles))


def _qed_from_props(props: Dict[str, float], weights) -> float:
    num = 0.0
    for w, name in zip(weights, _PROPS):
        num += w * math.log(ads(props[name], ADS_PARAMS[name]))
    return math.exp(num / sum(weights))


def qed(smiles: str, weights=WEIGHT_MEAN) -> float:
    """QED with the given weight vector (default: the published mean
    weights — rdkit's `QED.qed` default)."""
    return _qed_from_props(qed_properties(smiles), weights)


def weights_mean(smiles: str) -> float:
    return qed(smiles, WEIGHT_MEAN)


def weights_max(smiles: str) -> float:
    return qed(smiles, WEIGHT_MAX)


def weights_none(smiles: str) -> float:
    return qed(smiles, WEIGHT_NONE)
