"""Pure-Python SELFIES v2 codec — offline fallback for the `selfies` package.

The port's own copy of coati_tpu/chem/selfies_lite.py: the same code and the
same results, importing nothing of the JAX package.

The reference routes SMILES through ``selfies.encoder`` before vocab
matching (coati/models/encoding/clip_e2e_selfies.py:13-31) and decodes
generated SELFIES back with ``selfies.decoder``. That package is an
optional dependency; when it is absent this module provides a
spec-faithful SELFIES v2 implementation so the selfies route can
actually execute (tokenizers/selfies_support.py prefers the real
package whenever it is importable).

Implemented per the SELFIES v2 specification (Krenn et al., "SELFIES
and the future of molecular string representations"; aspuru-guzik-group
/selfies v2.x semantics):

- atom symbols ``[<bond><isotope><element><chirality><Hn><charge>]``
  with explicit digits (``[C@@H1]``, ``[NH3+1]``, ``[O-1]``) and bond
  prefixes ``=``, ``#``, ``/``, ``\\``;
- ``[BranchL]`` / ``[=BranchL]`` / ``[#BranchL]`` followed by L index
  symbols encoding (branch length in symbols) - 1;
- ``[RingL]`` / ``[=RingL]`` / ``[#RingL]`` / ``[-/RingL]`` /
  ``[-\\RingL]`` followed by L index symbols Q closing a bond to the
  atom derived Q+1 positions earlier;
- the 16-symbol overloaded index alphabet (INDEX_ALPHABET below);
- decoding under the default bonding-capacity table: over-valent or
  ill-placed symbols degrade gracefully (bond orders clamp to remaining
  capacity; branches need state > 1, rings state >= 1) so every string
  over the semantic alphabet decodes to a valid molecule;
- encoding kekulizes aromatic SMILES first (backtracking perfect
  matching over the needs-a-double-bond aromatic atoms), since the
  SELFIES alphabet is kekulized.

Known divergence, mirrored from the real library: a neutral, unmarked
bracket atom (``[N]`` meaning zero hydrogens) loses its explicit-H
constraint — both encoders emit the plain symbol. Published COATI
selfies vocabularies contain no such token, so the loss is outside the
checkpoint token space.

Exact parity with the installed `selfies` package is asserted by
tests/test_selfies_lite.py whenever that package is importable.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class EncoderError(ValueError):
    """SMILES outside this encoder's domain (parse/kekulize failure)."""


class DecoderError(ValueError):
    """Malformed SELFIES (unbracketed text or an unrecognized symbol)."""


# -- SELFIES v2 constants ---------------------------------------------------

# Overloaded index alphabet: symbol -> digit value 0..15, big-endian
# base-16 for multi-symbol indices.
INDEX_ALPHABET: Tuple[str, ...] = (
    "[C]", "[Ring1]", "[Ring2]",
    "[Branch1]", "[=Branch1]", "[#Branch1]",
    "[Branch2]", "[=Branch2]", "[#Branch2]",
    "[O]", "[N]", "[=N]", "[=C]", "[#C]", "[S]", "[P]",
)
INDEX_OF: Dict[str, int] = {s: i for i, s in enumerate(INDEX_ALPHABET)}

# Default bonding capacities ((element, charge) -> max total bond order,
# explicit hydrogens included). Anything unlisted gets 8.
_CAPS: Dict[Tuple[str, int], int] = {
    ("H", 0): 1, ("F", 0): 1, ("Cl", 0): 1, ("Br", 0): 1, ("I", 0): 1,
    ("B", 0): 3, ("B", 1): 2, ("B", -1): 4,
    ("O", 0): 2, ("O", 1): 3, ("O", -1): 1,
    ("N", 0): 3, ("N", 1): 4, ("N", -1): 2,
    ("C", 0): 4, ("C", 1): 3, ("C", -1): 3,
    ("P", 0): 5, ("P", 1): 6, ("P", -1): 4,
    ("S", 0): 6, ("S", 1): 7, ("S", -1): 5,
}


def capacity(element: str, charge: int) -> int:
    return _CAPS.get((element, charge), 8)


# SMILES implicit-valence ladders (for implicit-H of bare atoms on a
# kekulized graph; OpenSMILES "organic subset" rules).
_SMILES_VALENCE: Dict[str, Tuple[int, ...]] = {
    "B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
}
_ORGANIC = set(_SMILES_VALENCE)
_AROMATIC_BARE = {"b", "c", "n", "o", "p", "s"}
_AROMATIC_BRACKET = _AROMATIC_BARE | {"se", "as", "te", "si"}

_ORDER_CHAR = {1: "", 2: "=", 3: "#"}
_CHAR_ORDER = {"-": 1, "=": 2, "#": 3, "$": 4}


# -- molecular graph --------------------------------------------------------


@dataclass
class Atom:
    element: str  # capitalized ("C", "Cl", "Se")
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    chirality: str = ""  # "", "@", "@@"
    hcount: Optional[int] = None  # None = implicit (bare organic atom)
    idx: int = 0
    frag: int = 0


@dataclass
class Bond:
    a: int
    b: int
    order: int = 1
    aromatic: bool = False  # pre-kekulization flag
    stereo: str = ""  # "/" or "\\", read in the a -> b direction
    stereo_at: int = -1  # atom at which the stereo char was written


@dataclass
class _Node:
    """Parse-tree node: written order of branches and ring closures."""

    atom: int
    rings: List[int] = field(default_factory=list)  # bond indices (at closer)
    children: List[Tuple[int, "_Node"]] = field(default_factory=list)


@dataclass
class Mol:
    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Bond] = field(default_factory=list)
    roots: List[_Node] = field(default_factory=list)
    # Per-atom bond indices in the order they appear in the source text
    # (parent bond first, then ring digits, then branches/chain) — the
    # neighbor ordering SMILES tetrahedral chirality is defined against.
    written: List[List[int]] = field(default_factory=list)

    def neighbors(self) -> List[List[Tuple[int, int]]]:
        adj: List[List[Tuple[int, int]]] = [[] for _ in self.atoms]
        for bi, bd in enumerate(self.bonds):
            adj[bd.a].append((bd.b, bi))
            adj[bd.b].append((bd.a, bi))
        return adj


# -- SMILES parsing ---------------------------------------------------------

_BRACKET_RE = re.compile(
    r"\[(?P<iso>\d+)?(?P<elem>[A-Z][a-z]?|[a-z]{1,2}|\*)"
    r"(?P<chi>@{1,2}(?:TH[12]|AL[12]|SP[1-3])?)?"
    r"(?P<h>H\d*)?"
    r"(?P<chg>\+\+|--|[+-]\d*)?"
    r"(?::(?P<map>\d+))?\]"
)
_TWO_LETTER_BARE = ("Cl", "Br")


def parse_smiles(smiles: str) -> Mol:
    """Parse a SMILES string into a molecular graph + written-order
    parse tree. Raises EncoderError on anything outside the supported
    grammar (wildcards, extended chirality, conflicting ring bonds)."""
    mol = Mol()
    node_of: Dict[int, _Node] = {}
    prev: Optional[int] = None
    pending: Optional[Dict] = None  # bond token awaiting an atom/ring
    ring_open: Dict[int, Tuple[int, Optional[Dict], list]] = {}
    stack: List[Optional[int]] = []
    frag = 0
    i, n = 0, len(smiles)

    def new_atom(atom: Atom) -> int:
        nonlocal prev, pending
        atom.idx = len(mol.atoms)
        atom.frag = frag
        mol.atoms.append(atom)
        mol.written.append([])
        node = _Node(atom.idx)
        node_of[atom.idx] = node
        if prev is None:
            mol.roots.append(node)
        else:
            bd = _make_bond(prev, atom.idx, pending)
            mol.bonds.append(bd)
            node_of[prev].children.append((len(mol.bonds) - 1, node))
            mol.written[prev].append(len(mol.bonds) - 1)
            mol.written[atom.idx].append(len(mol.bonds) - 1)
        pending = None
        prev = atom.idx
        return atom.idx

    def _make_bond(a: int, b: int, tok: Optional[Dict]) -> Bond:
        if tok is None:
            arom = mol.atoms[a].aromatic and mol.atoms[b].aromatic
            return Bond(a, b, order=1, aromatic=arom)
        return Bond(
            a, b,
            order=tok["order"],
            aromatic=tok["aromatic"],
            stereo=tok["stereo"],
            stereo_at=a,
        )

    while i < n:
        c = smiles[i]
        if c == "[":
            m = _BRACKET_RE.match(smiles, i)
            if not m:
                raise EncoderError(f"bad bracket atom at {i}: {smiles!r}")
            elem = m.group("elem")
            if elem == "*":
                raise EncoderError("wildcard atoms are not supported")
            chi = m.group("chi") or ""
            if chi not in ("", "@", "@@"):
                raise EncoderError(f"unsupported chirality {chi!r}")
            aromatic = elem in _AROMATIC_BRACKET
            h = m.group("h")
            hcount = 0 if h is None else (1 if h == "H" else int(h[1:]))
            chg = m.group("chg") or ""
            if chg in ("", None):
                charge = 0
            elif chg == "++":
                charge = 2
            elif chg == "--":
                charge = -2
            elif chg in ("+", "-"):
                charge = 1 if chg == "+" else -1
            else:
                charge = int(chg[1:]) * (1 if chg[0] == "+" else -1)
            new_atom(Atom(
                element=elem.capitalize(),
                aromatic=aromatic,
                charge=charge,
                isotope=int(m.group("iso") or 0),
                chirality=chi,
                hcount=hcount,
            ))
            i = m.end()
        elif smiles.startswith(_TWO_LETTER_BARE, i):
            new_atom(Atom(element=smiles[i : i + 2]))
            i += 2
        elif c in "BCNOPSFI":
            new_atom(Atom(element=c))
            i += 1
        elif c in "bcnops":
            new_atom(Atom(element=c.upper(), aromatic=True))
            i += 1
        elif c in "-=#$:":
            if pending is not None:
                raise EncoderError(f"double bond token at {i}")
            pending = {
                "order": _CHAR_ORDER.get(c, 1),
                "aromatic": c == ":",
                "stereo": "",
            }
            if c == "$":
                raise EncoderError("quadruple bonds are not supported")
            i += 1
        elif c in "/\\":
            if pending is not None:
                raise EncoderError(f"double bond token at {i}")
            pending = {"order": 1, "aromatic": False, "stereo": c}
            i += 1
        elif c == "(":
            if prev is None:
                raise EncoderError(f"branch with no prior atom at {i}")
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise EncoderError(f"unbalanced ')' at {i}")
            prev = stack.pop()
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                if i + 2 >= n or not smiles[i + 1 : i + 3].isdigit():
                    raise EncoderError(f"bad %nn ring number at {i}")
                num = int(smiles[i + 1 : i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if prev is None:
                raise EncoderError("ring number with no prior atom")
            if num in ring_open:
                a, tok_a, slot = ring_open.pop(num)
                tok = pending
                if tok_a is not None and tok is not None:
                    same = (
                        tok_a["order"] == tok["order"]
                        and tok_a["aromatic"] == tok["aromatic"]
                    )
                    if not same:
                        raise EncoderError(
                            f"conflicting ring-bond tokens for ring {num}"
                        )
                use = tok if tok is not None else tok_a
                stereo_at = prev if tok is not None else a
                if use is None:
                    arom = mol.atoms[a].aromatic and mol.atoms[prev].aromatic
                    bd = Bond(a, prev, order=1, aromatic=arom)
                else:
                    bd = Bond(
                        a, prev,
                        order=use["order"],
                        aromatic=use["aromatic"],
                        stereo=use["stereo"],
                        stereo_at=stereo_at,
                    )
                if a == prev:
                    raise EncoderError("self-ring bond")
                mol.bonds.append(bd)
                node_of[prev].rings.append(len(mol.bonds) - 1)
                slot[0] = len(mol.bonds) - 1  # opener's digit position
                mol.written[prev].append(len(mol.bonds) - 1)
                pending = None
            else:
                slot = [None]
                mol.written[prev].append(slot)  # type: ignore[arg-type]
                ring_open[num] = (prev, pending, slot)
                pending = None
        elif c == ".":
            if pending is not None or stack:
                raise EncoderError(f"'.' inside a bond/branch at {i}")
            prev = None
            frag += 1
            i += 1
        elif c in " \t":
            i += 1
        else:
            raise EncoderError(f"unexpected character {c!r} at {i}")
    if stack:
        raise EncoderError("unbalanced '('")
    if ring_open:
        raise EncoderError(f"unclosed ring numbers {sorted(ring_open)}")
    if pending is not None:
        raise EncoderError("dangling bond token")
    if not mol.atoms:
        raise EncoderError("empty SMILES")
    mol.written = [
        [e if isinstance(e, int) else e[0] for e in lst] for lst in mol.written
    ]
    return mol


# -- kekulization -----------------------------------------------------------


def _bridges(mol: Mol) -> set:
    """Bond indices that are bridges (not in any cycle) — iterative
    Tarjan so deep chains don't hit the recursion limit."""
    adj = mol.neighbors()
    n = len(mol.atoms)
    disc = [-1] * n
    low = [0] * n
    out: set = set()
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        stack = [(root, -1, iter(adj[root]))]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            u, pbond, it = stack[-1]
            advanced = False
            for v, bi in it:
                if bi == pbond:
                    continue
                if disc[v] == -1:
                    disc[v] = low[v] = timer
                    timer += 1
                    stack.append((v, bi, iter(adj[v])))
                    advanced = True
                    break
                low[u] = min(low[u], disc[v])
            if not advanced:
                stack.pop()
                if stack:
                    pu = stack[-1][0]
                    low[pu] = min(low[pu], low[u])
                    if low[u] > disc[pu]:
                        out.add(pbond)
    return out


def _needs_double(mol: Mol, ai: int, degree: int, has_exo_double: bool) -> bool:
    """Does aromatic atom ai require exactly one double bond in the
    kekulé structure? Per-element rules matching RDKit/OpenSMILES
    aromaticity conventions for the common heteroaromatics."""
    a = mol.atoms[ai]
    h = a.hcount or 0
    conn = degree + h
    e, c = a.element, a.charge
    if has_exo_double:
        return False
    if e in ("C", "Si"):
        if c == 0:
            return conn <= 3
        return False  # [c+] tropylium-type / [c-] cyclopentadienyl-type
    if e in ("N", "P", "As"):
        if c == 0:
            return conn == 2  # pyridine-type; pyrrole-type (conn 3) is not
        if c == 1:
            return conn == 3  # pyridinium-type
        return False
    if e in ("O", "S", "Se", "Te"):
        return c == 1  # pyrylium/thiopyrylium oxygen/sulfur
    if e == "B":
        return False
    return False


def kekulize(mol: Mol) -> None:
    """Assign single/double orders to aromatic bonds in place (perfect
    matching over the atoms that need a double bond), then clear
    aromatic flags. Raises EncoderError when no kekulé structure
    exists."""
    arom_bonds = [bi for bi, bd in enumerate(mol.bonds) if bd.aromatic]
    if not arom_bonds:
        return
    bridges = _bridges(mol)
    degree = [0] * len(mol.atoms)
    exo_double = [False] * len(mol.atoms)
    for bd in mol.bonds:
        degree[bd.a] += 1
        degree[bd.b] += 1
        if bd.order >= 2 and not bd.aromatic:
            exo_double[bd.a] = True
            exo_double[bd.b] = True
    needy = {
        a.idx
        for a in mol.atoms
        if a.aromatic and _needs_double(mol, a.idx, degree[a.idx], exo_double[a.idx])
    }
    # candidate double bonds: aromatic RING bonds between two needy atoms
    cand: Dict[int, List[Tuple[int, int]]] = {a: [] for a in needy}
    for bi in arom_bonds:
        bd = mol.bonds[bi]
        if bi in bridges:
            continue
        if bd.a in needy and bd.b in needy:
            cand[bd.a].append((bd.b, bi))
            cand[bd.b].append((bd.a, bi))
    matched: Dict[int, int] = {}  # atom -> bond idx

    def backtrack(pool: List[int]) -> bool:
        pool = [a for a in pool if a not in matched]
        if not pool:
            return True
        pool.sort(key=lambda a: sum(1 for nb, _ in cand[a] if nb not in matched))
        a = pool[0]
        options = [(nb, bi) for nb, bi in cand[a] if nb not in matched]
        if not options:
            return False
        for nb, bi in options:
            matched[a] = bi
            matched[nb] = bi
            if backtrack(pool[1:]):
                return True
            del matched[a]
            del matched[nb]
        return False

    if not backtrack(sorted(needy)):
        raise EncoderError("cannot kekulize aromatic system")
    chosen = set(matched.values())
    for bi in arom_bonds:
        mol.bonds[bi].order = 2 if bi in chosen else 1
        mol.bonds[bi].aromatic = False
    for a in mol.atoms:
        a.aromatic = False


# -- encoding ---------------------------------------------------------------


def _atom_symbol(atom: Atom, order: int, stereo: str) -> str:
    prefix = stereo if (order == 1 and stereo) else _ORDER_CHAR[order]
    plain = (
        atom.hcount is None
        and atom.charge == 0
        and atom.isotope == 0
        and not atom.chirality
    )
    # REFERENCE QUIRK (selfies library): a neutral unmarked bracket atom
    # ([N], zero hydrogens) also collapses to the plain symbol.
    if atom.hcount == 0 and atom.charge == 0 and atom.isotope == 0 \
            and not atom.chirality:
        plain = True
    if plain:
        return f"[{prefix}{atom.element}]"
    h = atom.hcount or 0
    body = f"{atom.isotope or ''}{atom.element}{atom.chirality}"
    if h > 0:
        body += f"H{h}"
    if atom.charge:
        body += f"{'+' if atom.charge > 0 else '-'}{abs(atom.charge)}"
    return f"[{prefix}{body}]"


def _index_symbols(q: int) -> List[str]:
    """Minimal-length big-endian base-16 encoding of q over the index
    alphabet (1-3 symbols)."""
    if q < 16:
        return [INDEX_ALPHABET[q]]
    if q < 256:
        return [INDEX_ALPHABET[q // 16], INDEX_ALPHABET[q % 16]]
    if q < 4096:
        return [
            INDEX_ALPHABET[q // 256],
            INDEX_ALPHABET[(q // 16) % 16],
            INDEX_ALPHABET[q % 16],
        ]
    raise EncoderError(f"index {q} exceeds the SELFIES limit of 4095")


def _ring_symbol(bd: Bond, closer: int, q: int) -> List[str]:
    L = len(_index_symbols(q))
    if bd.stereo:
        ch = bd.stereo
        # stereo chars are directional: recorded at the OPENING atom they
        # describe the opener->closer direction; the ring symbol reads
        # closer->opener, so flip
        if bd.stereo_at != closer:
            ch = "/" if ch == "\\" else "\\"
        return [f"[-{ch}Ring{L}]"] + _index_symbols(q)
    return [f"[{_ORDER_CHAR[bd.order]}Ring{L}]"] + _index_symbols(q)


def _emit(mol: Mol, node: _Node, order: int, stereo: str) -> List[str]:
    out: List[str] = []
    while True:
        atom = mol.atoms[node.atom]
        out.append(_atom_symbol(atom, order, stereo))
        for bi in node.rings:
            bd = mol.bonds[bi]
            other = bd.a if bd.b == node.atom else bd.b
            if mol.atoms[other].frag != atom.frag:
                raise EncoderError("ring bond crosses a '.' fragment")
            q = node.atom - other - 1
            if q < 0:
                raise EncoderError("ring closure precedes its opener")
            out.extend(_ring_symbol(bd, node.atom, q))
        if not node.children:
            return out
        for bi, child in node.children[:-1]:
            bd = mol.bonds[bi]
            sub = _emit(mol, child, bd.order, _bond_stereo(bd, node.atom))
            idx = _index_symbols(len(sub) - 1)
            out.append(f"[{_ORDER_CHAR[bd.order]}Branch{len(idx)}]")
            out.extend(idx)
            out.extend(sub)
        bi, child = node.children[-1]
        bd = mol.bonds[bi]
        order, stereo = bd.order, _bond_stereo(bd, node.atom)
        node = child  # trunk continues iteratively (no recursion depth)


def _bond_stereo(bd: Bond, parent: int) -> str:
    if not bd.stereo:
        return ""
    if bd.stereo_at == parent:
        return bd.stereo
    return "/" if bd.stereo == "\\" else "\\"


def encoder(smiles: str, strict: bool = True) -> str:
    """SMILES -> SELFIES. Atom order is preserved (atom i of the input
    is the i-th derived atom of the output), matching the reference
    encoder so token streams line up with published vocabularies."""
    del strict  # accepted for signature compatibility with `selfies`
    mol = parse_smiles(smiles)
    kekulize(mol)
    parts = [
        "".join(_emit(mol, root, order=1, stereo="")) for root in mol.roots
    ]
    return ".".join(parts)


# -- decoding ---------------------------------------------------------------

_SYMBOL_SPLIT_RE = re.compile(r"(\[[^\[\]]*\]|\.)")
_DEC_ATOM_RE = re.compile(
    r"^\[(?P<bond>[=#/\\]?)(?P<iso>\d*)(?P<elem>[A-Z][a-z]?)"
    r"(?P<chi>@{0,2})(?P<h>(?:H\d+)?)(?P<chg>(?:[+-]\d+)?)\]$"
)
_DEC_BRANCH_RE = re.compile(r"^\[(?P<bond>[=#]?)Branch(?P<L>[1-3])\]$")
_DEC_RING_RE = re.compile(
    r"^\[(?P<bond>[=#]?|-[/\\])Ring(?P<L>[1-3])\]$"
)
_BOND_ORDER = {"": 1, "=": 2, "#": 3, "/": 1, "\\": 1, "-/": 1, "-\\": 1}


def split_selfies(selfies: str) -> List[str]:
    """Split a SELFIES string into symbols (and '.' separators),
    raising DecoderError on stray text between brackets."""
    out: List[str] = []
    pos = 0
    for m in _SYMBOL_SPLIT_RE.finditer(selfies):
        if selfies[pos : m.start()].strip():
            raise DecoderError(
                f"stray text {selfies[pos:m.start()]!r} in SELFIES"
            )
        out.append(m.group(0))
        pos = m.end()
    if selfies[pos:].strip():
        raise DecoderError(f"stray text {selfies[pos:]!r} in SELFIES")
    return out


@dataclass
class _DecAtom:
    element: str
    isotope: int
    chirality: str
    hcount: Optional[int]
    charge: int

    def avail(self) -> int:
        return max(0, capacity(self.element, self.charge) - (self.hcount or 0))


class _Deriver:
    """One fragment's derivation state (SELFIES v2 grammar)."""

    def __init__(self) -> None:
        self.atoms: List[_DecAtom] = []
        self.bonds: List[Tuple[int, int, int, str, int]] = []
        self.used: List[int] = []

    def remaining(self, ai: int) -> int:
        return self.atoms[ai].avail() - self.used[ai]

    def derive(self, syms: List[str], head: Optional[int], cap: int) -> None:
        """Derive `syms` continuing from `head` whose next-bond budget
        is `cap`. Mutates in place; ill-fitting symbols are skipped per
        the v2 robustness rules."""
        p = 0
        n = len(syms)
        while p < n:
            s = syms[p]
            p += 1
            m = _DEC_BRANCH_RE.match(s)
            if m is not None:
                state = min(cap, self.remaining(head)) if head is not None else 0
                if head is None or state <= 1:
                    continue  # branch ignored; index symbols are NOT consumed
                L = int(m.group("L"))
                q = 0
                for k in range(L):
                    if p < n:
                        q = q * 16 + INDEX_OF.get(syms[p], 0)
                        p += 1
                length = q + 1
                sub = syms[p : p + length]
                p += len(sub)
                border = _BOND_ORDER[m.group("bond")]
                before = self.used[head]
                self.derive(sub, head, cap=min(border, state - 1))
                cap -= self.used[head] - before
                continue
            m = _DEC_RING_RE.match(s)
            if m is not None:
                state = min(cap, self.remaining(head)) if head is not None else 0
                if head is None or state < 1:
                    continue
                L = int(m.group("L"))
                q = 0
                for k in range(L):
                    if p < n:
                        q = q * 16 + INDEX_OF.get(syms[p], 0)
                        p += 1
                target = max(0, head - (q + 1))
                if target == head:
                    continue
                bond = m.group("bond")
                order = min(
                    _BOND_ORDER[bond], state, self.remaining(target)
                )
                if order < 1:
                    continue
                stereo = bond[1] if bond.startswith("-") else ""
                self.bonds.append((head, target, order, stereo, head))
                self.used[head] += order
                self.used[target] += order
                cap -= order
                continue
            m = _DEC_ATOM_RE.match(s)
            if m is None:
                raise DecoderError(f"unrecognized SELFIES symbol {s!r}")
            h = m.group("h")
            chg = m.group("chg")
            atom = _DecAtom(
                element=m.group("elem"),
                isotope=int(m.group("iso") or 0),
                chirality=m.group("chi"),
                hcount=int(h[1:]) if h else None,
                charge=int(chg[1:]) * (1 if chg[0] == "+" else -1) if chg else 0,
            )
            if head is None:
                self.atoms.append(atom)
                self.used.append(0)
                head = len(self.atoms) - 1
                cap = 10**9
                continue
            bond = m.group("bond")
            order = min(
                _BOND_ORDER[bond],
                cap,
                self.remaining(head),
                atom.avail(),
            )
            if order < 1:
                continue  # saturated head: the atom is skipped
            stereo = bond if bond in ("/", "\\") else ""
            self.atoms.append(atom)
            self.used.append(0)
            ai = len(self.atoms) - 1
            self.bonds.append((head, ai, order, stereo, head))
            self.used[head] += order
            self.used[ai] += order
            head = ai
            cap = 10**9


def _write_atom(a: _DecAtom) -> str:
    h = a.hcount
    bare = (
        a.element in _ORGANIC
        and a.charge == 0
        and a.isotope == 0
        and not a.chirality
        and h is None
    )
    if bare:
        return a.element
    body = f"{a.isotope or ''}{a.element}{a.chirality}"
    if h:
        body += "H" if h == 1 else f"H{h}"
    if a.charge:
        if abs(a.charge) == 1:
            body += "+" if a.charge > 0 else "-"
        else:
            body += f"{'+' if a.charge > 0 else '-'}{abs(a.charge)}"
    return f"[{body}]"


def _write_fragment(d: _Deriver) -> str:
    n = len(d.atoms)
    if n == 0:
        return ""
    adj: List[List[int]] = [[] for _ in range(n)]
    for bi, (a, b, *_rest) in enumerate(d.bonds):
        adj[a].append(bi)
        adj[b].append(bi)

    # classify edges: iterative DFS from atom 0; an edge into an
    # already-seen atom becomes a ring closure recorded at BOTH ends
    seen = [False] * n
    tree: List[List[int]] = [[] for _ in range(n)]  # child bond idxs
    closures: List[List[int]] = [[] for _ in range(n)]
    used_edge = [False] * len(d.bonds)
    seen[0] = True
    stack = [(0, iter(adj[0]))]
    while stack:
        u, it = stack[-1]
        advanced = False
        for bi in it:
            if used_edge[bi]:
                continue
            a, b, *_ = d.bonds[bi]
            v = b if a == u else a
            used_edge[bi] = True
            if seen[v]:
                closures[u].append(bi)
                closures[v].append(bi)
                continue
            seen[v] = True
            tree[u].append(bi)
            stack.append((v, iter(adj[v])))
            advanced = True
            break
        if not advanced:
            stack.pop()

    def other(bi: int, u: int) -> int:
        a, b, *_ = d.bonds[bi]
        return b if a == u else a

    def bond_str(bi: int, frm: int) -> str:
        _a, _b, order, stereo, stereo_at = d.bonds[bi]
        if stereo:
            return stereo if stereo_at == frm else (
                "/" if stereo == "\\" else "\\"
            )
        return _ORDER_CHAR[order]

    def digit_str(digit: int) -> str:
        return str(digit) if digit < 10 else f"%{digit:02d}"

    opened: Dict[int, int] = {}
    free_digits: List[int] = []
    next_digit = [1]
    out: List[str] = []

    def closure_str(u: int) -> str:
        s = ""
        for cbi in closures[u]:
            if cbi in opened:
                digit = opened.pop(cbi)
                free_digits.append(digit)
                _a, _b, order, stereo, _sat = d.bonds[cbi]
                if stereo or order != 1:
                    s += bond_str(cbi, u)
                s += digit_str(digit)
            else:
                if free_digits:
                    digit = free_digits.pop()
                else:
                    digit = next_digit[0]
                    next_digit[0] += 1
                opened[cbi] = digit
                s += digit_str(digit)
        return s

    def walk(u: int) -> None:
        while True:
            out.append(_write_atom(d.atoms[u]))
            out.append(closure_str(u))
            kids = tree[u]
            if not kids:
                return
            for cbi in kids[:-1]:
                out.append("(" + bond_str(cbi, u))
                walk(other(cbi, u))  # recursion bounded by branch depth
                out.append(")")
            cbi = kids[-1]
            out.append(bond_str(cbi, u))
            u = other(cbi, u)

    walk(0)
    return "".join(out)


def decoder(selfies: str) -> str:
    """SELFIES -> SMILES. Any string over the semantic alphabet decodes
    without error; unknown symbols raise DecoderError."""
    syms = split_selfies(selfies)
    frags: List[List[str]] = [[]]
    for s in syms:
        if s == ".":
            frags.append([])
        else:
            frags[-1].append(s)
    parts = []
    for fsyms in frags:
        d = _Deriver()
        d.derive(fsyms, head=None, cap=0)
        smi = _write_fragment(d)
        if smi:
            parts.append(smi)
    return ".".join(parts)


# -- graph utilities beyond the codec ----------------------------------------
# (the parser/kekulizer double as the offline substitute for the rdkit
# helpers chem/rdkit_support.py gates: validity checking and random
# atom-order SMILES augmentation, reference rdkit_utils.py semantics)

_MAX_VALENCE: Dict[Tuple[str, int], int] = {
    ("C", 0): 4, ("C", 1): 3, ("C", -1): 3,
    ("N", 0): 3, ("N", 1): 4, ("N", -1): 2,
    ("O", 0): 2, ("O", 1): 3, ("O", -1): 1,
    ("S", 0): 6, ("S", 1): 5, ("S", -1): 1,
    ("P", 0): 5, ("P", 1): 4, ("P", -1): 6,
    ("B", 0): 3, ("B", -1): 4,
    ("F", 0): 1, ("Cl", 0): 1, ("Br", 0): 1, ("I", 0): 1,
    ("H", 0): 1,
}


def validate_smiles(s: str) -> bool:
    """Graph-level SMILES validity: parses, kekulizes, and every typed
    atom fits its maximum valence (bond orders + explicit H). Far
    stronger than a syntax check; still weaker than RDKit sanitization
    (no aromaticity re-perception, exotic elements pass)."""
    try:
        mol = parse_smiles(s)
        kekulize(mol)
    except EncoderError:
        return False
    bond_sum = [0] * len(mol.atoms)
    for b in mol.bonds:
        bond_sum[b.a] += b.order
        bond_sum[b.b] += b.order
    for a in mol.atoms:
        total = bond_sum[a.idx] + (a.hcount or 0)
        cap = _MAX_VALENCE.get((a.element, a.charge))
        if cap is None:
            continue  # exotic element/charge: permissive
        if total > cap:
            return False
    return True


def _perm_parity(src: list, dst: list) -> int:
    """Parity (0 even / 1 odd) of the permutation taking src to dst.
    Both must hold the same distinct items."""
    pos = {v: i for i, v in enumerate(src)}
    perm = [pos[v] for v in dst]
    seen = [False] * len(perm)
    parity = 0
    for i in range(len(perm)):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = perm[j]
            clen += 1
        parity ^= (clen - 1) & 1
    return parity


def write_smiles(mol: Mol, rng=None, order: Optional[List[int]] = None) -> str:
    """Write a SMILES for a parsed molecule, preserving aromatic
    (lowercase) form. With `rng`, the traversal root and neighbor order
    are randomized — a random-order SMILES of the same molecule
    (reference rdkit_utils permute_smiles semantics). With `order` (a
    total per-atom rank), the traversal is deterministic: lowest-rank
    atom roots each fragment, neighbors visited in ascending rank, and
    fragments emitted in ascending min-rank — the writer under
    canonical ranks (graph_canon.canonical_smiles).

    Tetrahedral markers are re-oriented for the new neighbor order:
    SMILES @/@@ is defined against the WRITTEN order of neighbors
    (preceding atom, then implicit H, then ring digits and branches in
    text order — OpenSMILES §3.9.2), which `mol.written` records at
    parse time; the emitted marker is flipped whenever the permutation
    from written order to emitted order is odd. Directional cis/trans
    bonds need only the existing per-direction flip in bond_char."""
    n = len(mol.atoms)
    adj = mol.neighbors()
    frags: Dict[int, List[int]] = {}
    for a in mol.atoms:
        frags.setdefault(a.frag, []).append(a.idx)
    input_roots = {node.atom for node in mol.roots}

    def atom_str(a: Atom, chi: Optional[str] = None) -> str:
        chirality = a.chirality if chi is None else chi
        sym = a.element.lower() if a.aromatic else a.element
        bare = (
            a.element in _ORGANIC
            and a.charge == 0
            and a.isotope == 0
            and not chirality
            and a.hcount is None
        )
        if bare:
            return sym
        body = f"{a.isotope or ''}{sym}{chirality}"
        h = a.hcount or 0
        if h:
            body += "H" if h == 1 else f"H{h}"
        if a.charge:
            if abs(a.charge) == 1:
                body += "+" if a.charge > 0 else "-"
            else:
                body += f"{'+' if a.charge > 0 else '-'}{abs(a.charge)}"
        return f"[{body}]"

    def bond_char(bd: Bond, frm: int) -> str:
        if bd.stereo:
            return bd.stereo if bd.stereo_at == frm else (
                "/" if bd.stereo == "\\" else "\\"
            )
        if bd.aromatic:
            return ""
        if bd.order == 1:
            # a SINGLE bond between two aromatic atoms (biphenyl) must be
            # explicit or it would read back as aromatic
            if mol.atoms[bd.a].aromatic and mol.atoms[bd.b].aromatic:
                return "-"
            return ""
        return _ORDER_CHAR[bd.order]

    def prep_nbrs(nbrs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        if rng is not None:
            rng.shuffle(nbrs)
        elif order is not None:
            # the DFS pops from the END, so descending rank here means
            # ascending-rank visitation
            nbrs.sort(key=lambda vb: order[vb[0]], reverse=True)
        return nbrs

    frag_lists = list(frags.values())
    if order is not None:
        frag_lists.sort(key=lambda atoms: min(order[a] for a in atoms))

    parts: List[str] = []
    for frag_atoms in frag_lists:
        if rng is not None:
            root = rng.choice(frag_atoms)
        elif order is not None:
            root = min(frag_atoms, key=lambda a: order[a])
        else:
            root = frag_atoms[0]
        seen = {root}
        tree: Dict[int, List[int]] = {a: [] for a in frag_atoms}
        closures: Dict[int, List[int]] = {a: [] for a in frag_atoms}
        parent_bond: Dict[int, int] = {}
        used_edge = set()
        stack = [(root, prep_nbrs(list(adj[root])))]
        while stack:
            u, nbrs = stack[-1]
            advanced = False
            while nbrs:
                v, bi = nbrs.pop()
                if bi in used_edge:
                    continue
                used_edge.add(bi)
                if v in seen:
                    closures[u].append(bi)
                    closures[v].append(bi)
                    continue
                seen.add(v)
                tree[u].append(bi)
                parent_bond[v] = bi
                stack.append((v, prep_nbrs(list(adj[v]))))
                advanced = True
                break
            if not advanced:
                stack.pop()

        # tetrahedral re-orientation for the new written order
        chi_over: Dict[int, str] = {}
        if len(mol.written) == n:
            for u in frag_atoms:
                a = mol.atoms[u]
                if a.chirality not in ("@", "@@"):
                    continue
                in_seq: list = list(mol.written[u])
                out_seq: list = (
                    ([parent_bond[u]] if u in parent_bond else [])
                    + list(closures[u])
                    + list(tree[u])
                )
                if a.hcount == 1:
                    in_seq.insert(0 if u in input_roots else 1, "H")
                    out_seq.insert(1 if u in parent_bond else 0, "H")
                if len(in_seq) < 3 or set(in_seq) != set(out_seq):
                    continue  # defensive: leave the marker unchanged
                if _perm_parity(in_seq, out_seq):
                    chi_over[u] = "@@" if a.chirality == "@" else "@"

        opened: Dict[int, int] = {}
        free_digits: List[int] = []
        next_digit = [1]
        out: List[str] = []

        def closure_str(u: int) -> str:
            s = ""
            for cbi in closures[u]:
                if cbi in opened:
                    digit = opened.pop(cbi)
                    free_digits.append(digit)
                    bd = mol.bonds[cbi]
                    ch = bond_char(bd, u)
                    s += ch + (str(digit) if digit < 10 else f"%{digit:02d}")
                else:
                    if free_digits:
                        digit = free_digits.pop()
                    else:
                        digit = next_digit[0]
                        next_digit[0] += 1
                    opened[cbi] = digit
                    s += str(digit) if digit < 10 else f"%{digit:02d}"
            return s

        def other(bi: int, u: int) -> int:
            bd = mol.bonds[bi]
            return bd.b if bd.a == u else bd.a

        def walk(u: int) -> None:
            while True:
                out.append(atom_str(mol.atoms[u], chi_over.get(u)))
                out.append(closure_str(u))
                kids = tree[u]
                if not kids:
                    return
                for cbi in kids[:-1]:
                    out.append("(" + bond_char(mol.bonds[cbi], u))
                    walk(other(cbi, u))
                    out.append(")")
                cbi = kids[-1]
                out.append(bond_char(mol.bonds[cbi], u))
                u = other(cbi, u)

        walk(root)
        parts.append("".join(out))
    return ".".join(parts)


def permute_smiles(smiles: str, rng=None) -> str:
    """Random atom-order SMILES of the same molecule (augmentation,
    reference rdkit_utils.py permute_smiles). Tetrahedral markers are
    re-oriented for the new traversal (write_smiles parity fixup) and
    cis/trans markers flip with bond direction, so stereo molecules
    permute too — previously they passed through unchanged."""
    import random as _random

    rng = rng or _random
    mol = parse_smiles(smiles)
    return write_smiles(mol, rng=rng)
