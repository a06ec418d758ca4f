"""SMARTS-subset substructure matching over the in-tree Mol type.

The port's own copy of coati_tpu/chem/smarts.py: the same code and the
same results, importing nothing of the JAX package.

The offline stand-in for RDKit's SMARTS engine, powering the Crippen
logP atom typer (chem/crippen.py) and the QED acceptor/structural-alert
counters (chem/qed.py) that the reference property pipeline pulls from
rdkit (reference containers/rdkit_utils.py:249-265 `Crippen.MolLogP`;
data xform property conditioning for the coati2_12_12 vocab).

Supported subset — everything the in-tree pattern tables use:

  atom primitives   ``*`` ``A`` ``a``, element symbols (``C``/``c``,
                    ``Cl``, ...), ``#n`` atomic number, leading digits
                    (isotope), ``Dn`` ``Hn`` ``hn`` ``Xn`` ``xn`` ``vn``
                    ``Rn`` ``rn``, charges (``+`` ``-`` ``+2`` ``++``),
                    ``@``/``@@`` (parsed, matched permissively),
                    ``$(...)`` recursive SMARTS
  logic             ``!``  >  ``&`` (implicit)  >  ``,``  >  ``;``
  bonds             ``-`` ``=`` ``#`` ``:`` ``~`` ``@`` ``/`` ``\\``
                    with the same logic operators; the default bond is
                    single-or-aromatic (Daylight semantics)
  structure         branches ``( )``, ring closures ``1``-``9`` and
                    ``%nn``

Semantics follow Daylight/RDKit:
  ``D``  explicit degree — graph neighbors, explicit-H atoms included
  ``H``  total hydrogen count — implicit + neighboring explicit H atoms
  ``h``  implicit hydrogen count
  ``X``  total connections — degree + implicit hydrogens
  ``x``  ring-bond count — bonds at the atom in any SSSR ring
         (``x`` alone: >= 1)
  ``v``  total bond-order valence (kekulized orders) + total hydrogens
  ``R``  number of SSSR rings containing the atom (``R`` alone: >= 1)
  ``r``  member of an SSSR ring of the given size (``r`` alone: any)

`count_matches` mirrors ``GetSubstructMatches(uniquify=True)``: one
match per distinct matched-atom set.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Dict, List, Optional, Set, Tuple

from coati_tpu_torch.chem.descriptors import sssr_rings
from coati_tpu_torch.chem.graph_canon import implicit_hydrogens
from coati_tpu_torch.chem.selfies_lite import (
    Atom,
    Bond,
    EncoderError,
    Mol,
    kekulize,
    parse_smiles,
)

__all__ = [
    "MolContext",
    "SmartsPattern",
    "compile_smarts",
    "add_explicit_hydrogens",
]

_SYMBOL_TO_Z: Dict[str, int] = {}
_Z_TO_SYMBOL: Dict[int, str] = {}


def _element_tables() -> Tuple[Dict[str, int], Dict[int, str]]:
    if not _SYMBOL_TO_Z:
        from coati_tpu_torch.common.periodic_table import PERIODIC_TABLE

        for row in PERIODIC_TABLE:
            if row["number"] > 0:
                _SYMBOL_TO_Z[row["symbol"]] = row["number"]
                _Z_TO_SYMBOL[row["number"]] = row["symbol"]
    return _SYMBOL_TO_Z, _Z_TO_SYMBOL


# Two-letter element symbols resolved greedily inside brackets (the
# Daylight rule: a known two-letter symbol beats one-letter + garbage).
_TWO_LETTER = {
    "Cl", "Br", "Si", "Se", "As", "Te", "Na", "Li", "Ca", "Mg", "Al",
    "Zn", "Fe", "Cu", "Mn", "Sn", "Pb", "Bi", "He", "Ne", "Ar", "Kr",
    "Xe", "Ba", "Sr", "Be", "Rb", "Cs", "Ni", "Co", "Cr", "Ti", "Ag",
    "Au", "Hg", "Cd", "Pt", "Pd", "Ir", "Os", "Re", "Ta", "Hf", "La",
    "Ce", "Ga", "Ge", "In", "Tl", "Sb", "Po", "At", "Rn", "Fr", "Ra",
    "Mo", "Ru", "Rh", "Nb", "Ho", "Zr", "Tc", "W",
}
_AROMATIC_TWO = {"se", "as", "te", "si"}


# --------------------------------------------------------------- context


class MolContext:
    """Per-molecule lookup tables the atom predicates read. Built once,
    shared across every pattern evaluated on the molecule."""

    __slots__ = (
        "mol", "adj", "degree", "imp_h", "free_h", "tot_h", "valence",
        "ring_count", "ring_sizes", "ring_bonds", "z",
    )

    def __init__(self, mol: Mol):
        self.mol = mol
        sym_to_z, _ = _element_tables()
        n = len(mol.atoms)
        self.adj: List[List[Tuple[int, int]]] = mol.neighbors()
        self.degree = [len(nb) for nb in self.adj]
        self.imp_h = implicit_hydrogens(mol)
        # RDKit's `h` primitive counts only hydrogens the valence model
        # INFERRED — bracket-specified Hs ([nH]) are explicit there, so
        # they contribute to H/X but not to h.
        self.free_h = [
            0 if a.hcount is not None else h
            for a, h in zip(mol.atoms, self.imp_h)
        ]
        self.tot_h = list(self.imp_h)
        for i, nb in enumerate(self.adj):
            self.tot_h[i] += sum(
                1 for j, _ in nb if mol.atoms[j].element == "H"
            )
        # valence on the kekulized graph (aromatic flags are writing
        # convention; kekulized orders + hydrogens is RDKit's default
        # valence for every organic aromatic system)
        km = Mol(
            atoms=[
                Atom(a.element, a.aromatic, a.charge, a.isotope,
                     a.chirality, a.hcount, a.idx, a.frag)
                for a in mol.atoms
            ],
            bonds=[Bond(b.a, b.b, b.order, b.aromatic) for b in mol.bonds],
            roots=mol.roots,
        )
        try:
            kekulize(km)
        except EncoderError:
            pass  # leave aromatic orders at 1; valence degrades gracefully
        bond_sum = [0] * n
        for b in km.bonds:
            bond_sum[b.a] += b.order
            bond_sum[b.b] += b.order
        self.valence = [bond_sum[i] + self.imp_h[i] for i in range(n)]
        rings = sssr_rings(mol)
        self.ring_count = [0] * n
        self.ring_sizes: List[Set[int]] = [set() for _ in range(n)]
        self.ring_bonds: Set[int] = set()
        for ring in rings:
            atoms: Set[int] = set()
            for bi in ring:
                self.ring_bonds.add(bi)
                atoms.add(mol.bonds[bi].a)
                atoms.add(mol.bonds[bi].b)
            for i in atoms:
                self.ring_count[i] += 1
                self.ring_sizes[i].add(len(ring))
        self.z = [sym_to_z.get(a.element, 0) for a in mol.atoms]


def add_explicit_hydrogens(mol: Mol) -> Mol:
    """A copy of `mol` with every hydrogen promoted to a graph atom
    (rdkit AddHs analog) — Crippen typing classifies H atoms with their
    own SMARTS rows. Heavy atoms get hcount=0 so H bookkeeping lives
    solely in the graph."""
    atoms = [
        Atom(a.element, a.aromatic, a.charge, a.isotope,
             a.chirality, a.hcount, a.idx, a.frag)
        for a in mol.atoms
    ]
    bonds = [
        Bond(b.a, b.b, b.order, b.aromatic, b.stereo, b.stereo_at)
        for b in mol.bonds
    ]
    imp = implicit_hydrogens(mol)
    out = Mol(atoms=atoms, bonds=bonds, roots=mol.roots)
    for a in list(out.atoms):
        count = imp[a.idx] if a.element != "H" else 0
        a.hcount = 0
        for _ in range(count):
            h = Atom("H", False, 0, 0, "", 0, len(out.atoms), a.frag)
            out.atoms.append(h)
            out.bonds.append(Bond(a.idx, h.idx, 1, False))
    return out


# ---------------------------------------------------------------- parsing

AtomPred = Callable[[MolContext, int], bool]
BondPred = Callable[[MolContext, int], bool]  # bond index


class _QAtom:
    __slots__ = ("pred",)

    def __init__(self, pred: AtomPred):
        self.pred = pred


class _QBond:
    __slots__ = ("a", "b", "pred")

    def __init__(self, a: int, b: int, pred: BondPred):
        self.a = a
        self.b = b
        self.pred = pred


class SmartsError(ValueError):
    pass


def _prim_any(ctx: MolContext, i: int) -> bool:
    return True


def _parse_atom_primitive(s: str, pos: int) -> Tuple[AtomPred, int]:
    """One atom primitive starting at s[pos]; returns (pred, next_pos)."""
    c = s[pos]
    if c == "*":
        return _prim_any, pos + 1
    if c == "a":
        # two-letter aromatic elements (se, as, te, si)
        if s[pos:pos + 2] == "as":
            return _elem_pred("As", True), pos + 2
        return (lambda ctx, i: ctx.mol.atoms[i].aromatic), pos + 1
    if c == "A":
        # Ag/Al/... two-letter elements take precedence over bare A
        if s[pos:pos + 2] in _TWO_LETTER:
            return _elem_pred(s[pos:pos + 2], False), pos + 2
        return (lambda ctx, i: not ctx.mol.atoms[i].aromatic), pos + 1
    if c == "#":
        j = pos + 1
        while j < len(s) and s[j].isdigit():
            j += 1
        if j == pos + 1:
            raise SmartsError(f"bare # at {pos} in {s!r}")
        z = int(s[pos + 1:j])
        return (lambda ctx, i: ctx.z[i] == z), j
    if c.isdigit():  # isotope
        j = pos
        while j < len(s) and s[j].isdigit():
            j += 1
        iso = int(s[pos:j])
        return (lambda ctx, i: ctx.mol.atoms[i].isotope == iso), j
    if c in "DHXR" and s[pos:pos + 2] in _TWO_LETTER:
        # Hg/Hf/Ho/Rh/Ru/Xe/...: a known two-letter element symbol beats
        # the count-primitive reading (Daylight rule)
        return _elem_pred(s[pos:pos + 2], False), pos + 2
    if c in "DHhXxvRr":
        j = pos + 1
        while j < len(s) and s[j].isdigit():
            j += 1
        num = int(s[pos + 1:j]) if j > pos + 1 else None
        # H with no digit means H1 *unless* H is an element here; inside
        # our primitive stream H is always the hydrogen-count primitive
        # except as the leading element of the expression — the caller
        # handles that case before reaching here.
        if c == "D":
            d = 1 if num is None else num
            return (lambda ctx, i: ctx.degree[i] == d), j
        if c == "H":
            d = 1 if num is None else num
            return (lambda ctx, i: ctx.tot_h[i] == d), j
        if c == "h":
            # Daylight/RDKit: bare `h` means "at least one implicit H";
            # a numbered `h<n>` is EXACT implicit-H count (== n), unlike
            # the >=1 reading a bare h gets. Counts free_h (valence-
            # inferred Hs only), matching RDKit's h on bracket atoms.
            if num is None:
                return (lambda ctx, i: ctx.free_h[i] >= 1), j
            return (lambda ctx, i: ctx.free_h[i] == num), j
        if c == "X":
            d = 1 if num is None else num
            return (lambda ctx, i: ctx.degree[i] + ctx.imp_h[i] == d), j
        if c == "x":
            # ring-bond count (ring connectivity), NOT total connections

            def _ring_bond_count(ctx, i):
                return sum(
                    1 for _, bi in ctx.adj[i] if bi in ctx.ring_bonds
                )

            if num is None:
                return (lambda ctx, i: _ring_bond_count(ctx, i) > 0), j
            return (lambda ctx, i: _ring_bond_count(ctx, i) == num), j
        if c == "v":
            d = 1 if num is None else num
            return (lambda ctx, i: ctx.valence[i] == d), j
        if c == "R":
            if num is None:
                return (lambda ctx, i: ctx.ring_count[i] > 0), j
            if num == 0:
                return (lambda ctx, i: ctx.ring_count[i] == 0), j
            return (lambda ctx, i: ctx.ring_count[i] == num), j
        if c == "r":
            if num is None or num == 0:
                return (lambda ctx, i: ctx.ring_count[i] > 0), j
            return (lambda ctx, i: num in ctx.ring_sizes[i]), j
    if c in "+-":
        j = pos + 1
        # ++ / -- repeats
        reps = 1
        while j < len(s) and s[j] == c:
            reps += 1
            j += 1
        if reps == 1:
            k = j
            while k < len(s) and s[k].isdigit():
                k += 1
            if k > j:
                reps = int(s[j:k])
                j = k
        charge = reps if c == "+" else -reps
        return (lambda ctx, i: ctx.mol.atoms[i].charge == charge), j
    if c == "@":
        j = pos + 1
        if j < len(s) and s[j] == "@":
            j += 1
        return _prim_any, j  # chirality queries matched permissively
    if c == "$":
        if pos + 1 >= len(s) or s[pos + 1] != "(":
            raise SmartsError(f"$ without ( at {pos} in {s!r}")
        depth, j = 1, pos + 2
        while j < len(s) and depth:
            if s[j] == "(":
                depth += 1
            elif s[j] == ")":
                depth -= 1
            j += 1
        if depth:
            raise SmartsError(f"unbalanced $() in {s!r}")
        inner = compile_smarts(s[pos + 2:j - 1])
        return (lambda ctx, i: inner.match_atom(ctx, i)), j
    # element symbols
    if c.islower():
        two = s[pos:pos + 2]
        if two in _AROMATIC_TWO:
            return _elem_pred(two.capitalize(), True), pos + 2
        if c in "bcnops":
            return _elem_pred(c.upper(), True), pos + 1
        raise SmartsError(f"bad aromatic symbol {c!r} at {pos} in {s!r}")
    if c.isupper():
        two = s[pos:pos + 2]
        if len(two) == 2 and two in _TWO_LETTER:
            return _elem_pred(two, False), pos + 2
        return _elem_pred(c, False), pos + 1
    raise SmartsError(f"bad atom primitive {c!r} at {pos} in {s!r}")


def _elem_pred(symbol: str, aromatic: Optional[bool]) -> AtomPred:
    if aromatic is None:
        return lambda ctx, i: ctx.mol.atoms[i].element == symbol
    return lambda ctx, i: (
        ctx.mol.atoms[i].element == symbol
        and ctx.mol.atoms[i].aromatic == aromatic
    )


def _parse_atom_expr(s: str) -> AtomPred:
    """Full bracket-interior expression with !/&/,/; logic. The leading
    position treats `H` as elemental hydrogen (Daylight rule: [H] is the
    element, [CH3] the count)."""
    pos = 0
    n = len(s)

    def parse_not() -> AtomPred:
        nonlocal pos
        if pos < n and s[pos] == "!":
            pos += 1
            inner = parse_not()
            return lambda ctx, i: not inner(ctx, i)
        # leading-H special case: at expression start (or right after a
        # logic operator at position 0 of a term), H followed by
        # non-digit charge/end means the element
        if s[pos] == "H" and pos == 0 and s[pos:pos + 2] not in _TWO_LETTER:
            j = pos + 1
            if j >= n or not s[j].isdigit():
                # [H], [H+], [1H]... leading H with no count digit
                pred = _elem_pred("H", False)
                pos = j
                return pred
        pred, pos2 = _parse_atom_primitive(s, pos)
        pos = pos2
        return pred

    def parse_and() -> AtomPred:  # implicit & and explicit &
        nonlocal pos
        terms = [parse_not()]
        while pos < n and s[pos] not in ",;":
            if s[pos] == "&":
                pos += 1
            terms.append(parse_not())
        if len(terms) == 1:
            return terms[0]
        return lambda ctx, i: all(t(ctx, i) for t in terms)

    def parse_or() -> AtomPred:
        nonlocal pos
        terms = [parse_and()]
        while pos < n and s[pos] == ",":
            pos += 1
            terms.append(parse_and())
        if len(terms) == 1:
            return terms[0]
        return lambda ctx, i: any(t(ctx, i) for t in terms)

    def parse_low_and() -> AtomPred:
        nonlocal pos
        terms = [parse_or()]
        while pos < n and s[pos] == ";":
            pos += 1
            terms.append(parse_or())
        if len(terms) == 1:
            return terms[0]
        return lambda ctx, i: all(t(ctx, i) for t in terms)

    pred = parse_low_and()
    if pos != n:
        raise SmartsError(f"trailing {s[pos:]!r} in atom expression {s!r}")
    return pred


# bond primitives


def _bond_prim(c: str) -> BondPred:
    if c == "-" or c == "/" or c == "\\":
        return lambda ctx, bi: (
            ctx.mol.bonds[bi].order == 1 and not ctx.mol.bonds[bi].aromatic
        )
    if c == "=":
        return lambda ctx, bi: (
            ctx.mol.bonds[bi].order == 2 and not ctx.mol.bonds[bi].aromatic
        )
    if c == "#":
        return lambda ctx, bi: ctx.mol.bonds[bi].order == 3
    if c == ":":
        return lambda ctx, bi: ctx.mol.bonds[bi].aromatic
    if c == "~":
        return lambda ctx, bi: True
    if c == "@":
        return lambda ctx, bi: bi in ctx.ring_bonds
    raise SmartsError(f"bad bond primitive {c!r}")


def _default_bond(ctx: MolContext, bi: int) -> bool:
    b = ctx.mol.bonds[bi]
    return b.aromatic or b.order == 1


_BOND_CHARS = "-=#:~@/\\"


def _parse_bond_expr(s: str, pos: int) -> Tuple[Optional[BondPred], int]:
    """Bond expression (possibly with !,&;, logic) starting at s[pos].
    Returns (None, pos) when no bond characters are present."""
    n = len(s)

    def parse_not(p: int) -> Tuple[BondPred, int]:
        if s[p] == "!":
            inner, p2 = parse_not(p + 1)
            return (lambda ctx, bi: not inner(ctx, bi)), p2
        if p < n and s[p] in _BOND_CHARS:
            return _bond_prim(s[p]), p + 1
        raise SmartsError(f"bad bond expression at {p} in {s!r}")

    if pos >= n or (s[pos] not in _BOND_CHARS and s[pos] != "!"):
        return None, pos
    # precedence: ! > & > , > ;
    def parse_and(p: int) -> Tuple[BondPred, int]:
        terms = []
        t, p = parse_not(p)
        terms.append(t)
        while p < n and (s[p] == "&" or s[p] in _BOND_CHARS or s[p] == "!"):
            if s[p] == "&":
                p += 1
            t, p = parse_not(p)
            terms.append(t)
        if len(terms) == 1:
            return terms[0], p
        return (lambda ctx, bi: all(t(ctx, bi) for t in terms)), p

    def parse_or(p: int) -> Tuple[BondPred, int]:
        terms = []
        t, p = parse_and(p)
        terms.append(t)
        while p < n and s[p] == ",":
            t, p = parse_and(p + 1)
            terms.append(t)
        if len(terms) == 1:
            return terms[0], p
        return (lambda ctx, bi: any(t(ctx, bi) for t in terms)), p

    def parse_low(p: int) -> Tuple[BondPred, int]:
        terms = []
        t, p = parse_or(p)
        terms.append(t)
        while p < n and s[p] == ";":
            t, p = parse_or(p + 1)
            terms.append(t)
        if len(terms) == 1:
            return terms[0], p
        return (lambda ctx, bi: all(t(ctx, bi) for t in terms)), p

    return parse_low(pos)


# ------------------------------------------------------------ pattern


class SmartsPattern:
    """Compiled connected SMARTS query."""

    def __init__(self, pattern: str):
        self.pattern = pattern
        self.atoms: List[_QAtom] = []
        self.bonds: List[_QBond] = []
        self._parse(pattern)
        self.adj: List[List[Tuple[int, int]]] = [[] for _ in self.atoms]
        for qi, qb in enumerate(self.bonds):
            self.adj[qb.a].append((qb.b, qi))
            self.adj[qb.b].append((qb.a, qi))
        self._order = self._match_order()

    # parsing -------------------------------------------------------

    def _parse(self, s: str) -> None:
        pos = 0
        n = len(s)
        prev: Optional[int] = None
        stack: List[Optional[int]] = []
        pending: Optional[BondPred] = None
        ring_open: Dict[int, Tuple[int, Optional[BondPred]]] = {}

        def add_atom(pred: AtomPred) -> None:
            nonlocal prev, pending
            idx = len(self.atoms)
            self.atoms.append(_QAtom(pred))
            if prev is not None:
                self.bonds.append(
                    _QBond(prev, idx, pending or _default_bond)
                )
            elif pending is not None:
                raise SmartsError(f"dangling bond in {s!r}")
            prev = idx
            pending = None

        while pos < n:
            c = s[pos]
            if c == "(":
                stack.append(prev)
                pos += 1
            elif c == ")":
                if not stack:
                    raise SmartsError(f"unbalanced ) in {s!r}")
                prev = stack.pop()
                pos += 1
            elif c == "[":
                depth, j = 1, pos + 1
                while j < n and depth:
                    if s[j] == "[":
                        depth += 1
                    elif s[j] == "]":
                        depth -= 1
                    # skip $() bodies wholesale (they may contain [ ])
                    elif s[j] == "$" and j + 1 < n and s[j + 1] == "(":
                        d2, k = 1, j + 2
                        while k < n and d2:
                            if s[k] == "(":
                                d2 += 1
                            elif s[k] == ")":
                                d2 -= 1
                            k += 1
                        j = k - 1
                    j += 1
                if depth:
                    raise SmartsError(f"unbalanced [ in {s!r}")
                add_atom(_parse_atom_expr(s[pos + 1:j - 1]))
                pos = j
            elif c.isdigit() or c == "%":
                if c == "%":
                    num = int(s[pos + 1:pos + 3])
                    pos += 3
                else:
                    num = int(c)
                    pos += 1
                if prev is None:
                    raise SmartsError(f"ring digit before atom in {s!r}")
                if num in ring_open:
                    other, opred = ring_open.pop(num)
                    self.bonds.append(
                        _QBond(other, prev,
                               pending or opred or _default_bond)
                    )
                    pending = None
                else:
                    ring_open[num] = (prev, pending)
                    pending = None
            elif c in _BOND_CHARS or c == "!":
                pred, pos = _parse_bond_expr(s, pos)
                pending = pred
            else:
                # bare atom outside brackets
                if c == "*":
                    add_atom(_prim_any)
                    pos += 1
                elif c == "A":
                    add_atom(lambda ctx, i: not ctx.mol.atoms[i].aromatic)
                    pos += 1
                elif c == "a":
                    add_atom(lambda ctx, i: ctx.mol.atoms[i].aromatic)
                    pos += 1
                elif c.islower():
                    if c in "bcnops":
                        add_atom(_elem_pred(c.upper(), True))
                        pos += 1
                    else:
                        raise SmartsError(
                            f"bad bare atom {c!r} at {pos} in {s!r}"
                        )
                elif c.isupper():
                    two = s[pos:pos + 2]
                    if two in ("Cl", "Br"):
                        add_atom(_elem_pred(two, False))
                        pos += 2
                    elif c in "BCNOFPSI":
                        add_atom(_elem_pred(c, False))
                        pos += 1
                    else:
                        raise SmartsError(
                            f"bad bare atom {c!r} at {pos} in {s!r}"
                        )
                else:
                    raise SmartsError(f"bad char {c!r} at {pos} in {s!r}")
        if ring_open:
            raise SmartsError(f"unclosed ring bond in {s!r}")
        if stack:
            raise SmartsError(f"unbalanced ( in {s!r}")
        if not self.atoms:
            raise SmartsError(f"empty pattern {s!r}")

    def _match_order(self) -> List[Tuple[int, List[Tuple[int, int]]]]:
        """DFS order from query atom 0; each entry is (query atom, list
        of (already-placed neighbor, bond idx)) — the match loop places
        atoms in this order, checking every back-edge immediately."""
        seen = {0}
        order: List[Tuple[int, List[Tuple[int, int]]]] = [(0, [])]
        frontier = [0]
        while frontier:
            u = frontier.pop()
            for v, _bi in self.adj[u]:
                if v in seen:
                    continue
                seen.add(v)
                back = [(w, bi) for w, bi in self.adj[v] if w in seen and w != v]
                order.append((v, back))
                frontier.append(v)
        if len(seen) != len(self.atoms):
            raise SmartsError(
                f"disconnected SMARTS not supported: {self.pattern!r}"
            )
        return order

    # matching ------------------------------------------------------

    def _extend(self, ctx: MolContext, mapping: List[int],
                used: Set[int], depth: int,
                collect: Optional[Set[frozenset]]) -> bool:
        if depth == len(self._order):
            if collect is None:
                return True
            collect.add(frozenset(mapping))
            return False  # keep searching for more matches
        qi, back = self._order[depth]
        anchor_q, anchor_b = back[0]
        anchor_m = mapping[anchor_q]
        for mi, mbi in ctx.adj[anchor_m]:
            if mi in used or not self.atoms[qi].pred(ctx, mi):
                continue
            if not self.bonds[anchor_b].pred(ctx, mbi):
                continue
            ok = True
            for w, bi in back[1:]:
                mb = _find_bond(ctx, mapping[w], mi)
                if mb is None or not self.bonds[bi].pred(ctx, mb):
                    ok = False
                    break
            if not ok:
                continue
            mapping[qi] = mi
            used.add(mi)
            if self._extend(ctx, mapping, used, depth + 1, collect):
                used.discard(mi)
                return True
            used.discard(mi)
        return False

    def match_atom(self, ctx: MolContext, root: int) -> bool:
        """Does the pattern match with query atom 0 mapped to `root`?"""
        if not self.atoms[0].pred(ctx, root):
            return False
        mapping = [-1] * len(self.atoms)
        mapping[0] = root
        return self._extend(ctx, mapping, {root}, 1, None)

    def has_match(self, ctx: MolContext) -> bool:
        return any(
            self.match_atom(ctx, i) for i in range(len(ctx.mol.atoms))
        )

    def count_matches(self, ctx: MolContext) -> int:
        """Number of distinct matched atom sets (uniquify=True)."""
        found: Set[frozenset] = set()
        for i in range(len(ctx.mol.atoms)):
            if not self.atoms[0].pred(ctx, i):
                continue
            mapping = [-1] * len(self.atoms)
            mapping[0] = i
            self._extend(ctx, mapping, {i}, 1, found)
        return len(found)


def _find_bond(ctx: MolContext, a: int, b: int) -> Optional[int]:
    for j, bi in ctx.adj[a]:
        if j == b:
            return bi
    return None


@lru_cache(maxsize=4096)
def compile_smarts(pattern: str) -> SmartsPattern:
    return SmartsPattern(pattern)
