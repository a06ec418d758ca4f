"""coati_tpu_torch's chemistry core against coati_tpu's on the CPU: the
canonicalizer through its native C path and its Python path, permuted
SMILES, the SELFIES codec, rings, aromaticity, descriptors, fingerprints,
the native matcher, conformers and their force field, graph tokens, and the
native loader. Every comparison is exact unless a line says otherwise: the
port's modules are copies of the JAX package's host code."""

import dataclasses
import gzip
import random
from pathlib import Path

import numpy as np
import pytest

from coati_tpu.chem import aromaticity as j_arom
from coati_tpu.chem import conformers as j_conf
from coati_tpu.chem import descriptors as j_desc
from coati_tpu.chem import fingerprints as j_fp
from coati_tpu.chem import forcefield as j_ff
from coati_tpu.chem import graph_canon as j_canon
from coati_tpu.chem import rdkit_support as j_rd
from coati_tpu.chem import selfies_lite as j_sl
from coati_tpu.tokenizers import graph_tokens as j_gt
from coati_tpu.tokenizers.matcher import VocabMatcher as JaxMatcher

from coati_tpu_torch import native
from coati_tpu_torch.chem import aromaticity as t_arom
from coati_tpu_torch.chem import conformers as t_conf
from coati_tpu_torch.chem import descriptors as t_desc
from coati_tpu_torch.chem import fingerprints as t_fp
from coati_tpu_torch.chem import forcefield as t_ff
from coati_tpu_torch.chem import graph_canon as t_canon
from coati_tpu_torch.chem import rdkit_support as t_rd
from coati_tpu_torch.chem import selfies_lite as t_sl
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers import graph_tokens as t_gt
from coati_tpu_torch.tokenizers.matcher import VocabMatcher

CORPUS = Path(__file__).resolve().parents[1] / "corpora" / "chembl_synth_v1.smi.gz"
STEREO = ["N[C@@H](C)C(=O)O", "N[C@H](C)C(=O)O", "C[C@H]1CC[C@@H](N)CC1", "F/C=C/F",
          "F/C=C\\F", "CC/C=C(/C)CO", "O[C@@H]1CC[C@H](F)C1", "C[C@@H](O)c1ccccc1",
          "OC(=O)[C@@H]1CCCN1", "C/C=C/C(=O)O", "Cl/C=C/Br", "C[C@H](N)[C@@H](C)O"]
# the conformer molecules: corpus lines and stereo centres, 20 in all
N_CONFORMERS = 20

@pytest.fixture(scope="module")
def corpus():
    return gzip.open(CORPUS, "rt").read().split()


@pytest.fixture(scope="module")
def sample(corpus):
    """A seeded sample of 2,000 corpus lines."""
    return random.Random(0).sample(corpus, 2000)


def _forms(kind, sample):
    if kind == "corpus":
        return sample
    if kind == "permuted":
        rng = random.Random(1)
        return [t_sl.permute_smiles(s, rng) for s in sample[:400]]
    if kind == "kekulized":
        out = []
        for s in sample[:400]:
            mol = t_sl.parse_smiles(s)
            t_sl.kekulize(mol)
            out.append(t_sl.write_smiles(mol))
        return out
    rng = random.Random(2)  # stereo: each molecule and four permuted writings of it
    return STEREO + [t_sl.permute_smiles(s, rng) for s in STEREO for _ in range(4)]


@pytest.fixture
def cold_cache():
    t_canon._canonical_cached.cache_clear()
    yield
    t_canon._canonical_cached.cache_clear()


def _canonicalize_counted(smiles):
    before = dict(native.CANON_PATHS)
    out = [t_canon.canonical_smiles(s) for s in smiles]
    return out, {k: native.CANON_PATHS[k] - before[k] for k in before}


@pytest.mark.parametrize("kind", ["corpus", "permuted", "kekulized", "stereo"])
def test_canonical_smiles_native_and_python_paths_equal_coati_tpu_s(kind, sample, cold_cache,
                                                                     monkeypatch):
    """Both paths of the port give coati_tpu's canonical SMILES byte for
    byte, and the path counters show which one answered: every string here
    is in the C pipeline's domain, so the native path answers each distinct
    one, and with the library taken away the Python path answers each."""
    if native.load_fast_canon() is None:
        pytest.skip("no C compiler: the native path cannot be built")
    forms = _forms(kind, sample)
    distinct = len(set(forms))
    ref = [j_canon.canonical_smiles(s) for s in forms]
    mine, paths = _canonicalize_counted(forms)
    assert paths == {"native": distinct, "python": 0}
    assert mine == ref
    t_canon._canonical_cached.cache_clear()
    monkeypatch.setitem(native._libs, "fast_canon", None)
    python, paths = _canonicalize_counted(forms)
    assert paths == {"native": 0, "python": distinct}
    assert python == ref
    if kind != "corpus":  # another writing of the same molecule: the same string
        originals = STEREO if kind == "stereo" else sample[:400]
        want = {j_canon.canonical_smiles(s) for s in originals}
        assert set(ref) <= want
    else:
        assert ref == forms  # the corpus is written canonically


def _outcome(fn, s):
    try:
        return fn(s)
    except Exception as ex:  # noqa: BLE001 - the type of the failure is compared
        return type(ex).__name__


def test_canonical_smiles_failure_domain_and_chirality_switch(cold_cache):
    """Input outside the C pipeline's domain (the Python path then decides)
    gives coati_tpu's string or raises coati_tpu's error; use_chiral=False
    strips stereo."""
    odd = ["C1CC", "C(C", "[Xx]", "c1cccc1", "C%12CC%12", "[2H]C", "[NH4+]", "C.C", "*C", "ÜC"]
    outcomes = [_outcome(t_canon.canonical_smiles, s) for s in odd]
    assert outcomes == [_outcome(j_canon.canonical_smiles, s) for s in odd]
    assert "EncoderError" in outcomes
    for s in STEREO:
        assert (t_canon.canonical_smiles(s, use_chiral=False)
                == j_canon.canonical_smiles(s, use_chiral=False))
        assert "@" not in t_canon.canonical_smiles(s, use_chiral=False)


def test_permute_smiles_draws_as_coati_tpu_s(sample):
    """Under one seed the same strings: through an rng, and through the
    global random module, which rdkit_support.permute_smiles (the training
    transform's call) draws from."""
    picks = sample[:300] + STEREO
    for seed in (0, 1):
        mine = [t_sl.permute_smiles(s, random.Random(seed)) for s in picks]
        ref = [j_sl.permute_smiles(s, random.Random(seed)) for s in picks]
        assert mine == ref
        random.seed(seed)
        mine = [t_rd.permute_smiles(s) for s in picks]
        after = random.random()
        random.seed(seed)
        ref = [j_rd.permute_smiles(s) for s in picks]
        assert mine == ref and random.random() == after
        assert sum(m != s for m, s in zip(mine, picks)) > 250  # it does permute


def test_selfies_encoder_decoder_round_trips_as_coati_tpu_s(sample):
    for s in sample[:300] + STEREO:
        selfies = t_sl.encoder(s)
        assert selfies == j_sl.encoder(s)
        back = t_sl.decoder(selfies)
        assert back == j_sl.decoder(selfies)
        assert t_canon.canonical_smiles(back) == t_canon.canonical_smiles(s)
    assert t_sl.split_selfies("[C][=O][Branch1]") == j_sl.split_selfies("[C][=O][Branch1]")


def _fields(obj):
    return dataclasses.asdict(obj)


def test_rings_aromaticity_and_descriptors_equal_coati_tpu_s(sample):
    """sssr_rings on the parsed graph, the graph after perceive_aromaticity
    (atoms, bonds, and its writing), and molecular_descriptors."""
    kekulized = _forms("kekulized", sample)[:150]
    for s in sample[:150] + kekulized + STEREO:
        mine, ref = t_sl.parse_smiles(s), j_sl.parse_smiles(s)
        assert t_desc.sssr_rings(mine) == j_desc.sssr_rings(ref)
        t_arom.perceive_aromaticity(mine)
        j_arom.perceive_aromaticity(ref)
        assert [_fields(a) for a in mine.atoms] == [_fields(a) for a in ref.atoms]
        assert [_fields(b) for b in mine.bonds] == [_fields(b) for b in ref.bonds]
        assert t_sl.write_smiles(mine) == j_sl.write_smiles(ref)
        assert t_desc.molecular_descriptors(s) == j_desc.molecular_descriptors(s)


def test_morgan_fingerprints_equal_coati_tpu_s(sample):
    for s in sample[:200] + STEREO:
        for radius, n_bits, chiral in ((2, 2048, False), (3, 1024, True)):
            mine = t_fp.morgan_fingerprint(s, radius=radius, n_bits=n_bits, chiral=chiral)
            ref = j_fp.morgan_fingerprint(s, radius=radius, n_bits=n_bits, chiral=chiral)
            assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
        assert np.array_equal(t_rd.mol_to_morgan(s, radius=2, n_bits=64),
                              j_rd.mol_to_morgan(s, radius=2, n_bits=64))


@pytest.mark.parametrize("native_path", [True, False], ids=["native", "python"])
def test_matcher_splits_as_the_python_scan_and_coati_tpu(native_path, sample, monkeypatch):
    """The port's matcher in C (fast_matcher.c) and in Python, against
    coati_tpu's, on the tokenizer's text for the corpus sample, special-token
    text and noise; a non-ASCII token turns the native path off."""
    vocab = get_vocab("mar")
    tokens = list(vocab["special_tokens"]) + list(vocab["smiles_tokens"])
    if not native_path:
        monkeypatch.setitem(native._libs, "fast_matcher", None)
    mine, ref = VocabMatcher(tokens), JaxMatcher(tokens)
    if native_path and native.load_fast_matcher() is None:
        pytest.skip("no C compiler: the native matcher cannot be built")
    assert mine.uses_native == native_path
    rng = random.Random(0)
    alphabet = "CNOclnos()[]=#@+-1234SET%Br.xyz "
    texts = ["[SMILES]" + s + "[STOP]" for s in sample]
    texts += ["[CLIP][UNK][SET][chembl_mols][SMILES]C[SUFFIX]O[MIDDLE]N[STOP]", "", "[", "[[S"]
    texts += ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 40))) for _ in range(300)]
    for text in texts:
        out = mine.split(text)
        assert out == ref.split(text), text
        assert "".join(out) == text
    mine.add("[Ü]")
    ref.add("[Ü]")
    assert not mine.uses_native and mine.split("C[Ü]O") == ref.split("C[Ü]O")


@pytest.fixture(scope="module")
def conformer_smiles(sample):
    return sample[:N_CONFORMERS - 4] + ["N[C@@H](C)C(=O)O", "F/C=C\\F",
                                        "C[C@H]1CC[C@@H](N)CC1", "OC(=O)[C@@H]1CCCN1"]


def test_conformers_and_force_field_energies_equal_coati_tpu_s(conformer_smiles):
    """embed_smiles_to_atoms_coords (seeded 0xF00D): the same atoms and
    coordinates within 1e-6 Angstrom, the same adjacency and fingerprint;
    build_forcefield on the same graph: the same energy and gradient of
    those coordinates within 1e-9 relative."""
    for s in conformer_smiles:
        atoms, coords, adj, fp = t_conf.embed_smiles_to_atoms_coords(
            s, adj_matrix=True, do_morgan=True)
        r_atoms, r_coords, r_adj, r_fp = j_conf.embed_smiles_to_atoms_coords(
            s, adj_matrix=True, do_morgan=True)
        assert atoms.dtype == r_atoms.dtype and np.array_equal(atoms, r_atoms), s
        assert coords.shape == (len(atoms), 3) and np.isfinite(coords).all()
        np.testing.assert_allclose(coords, r_coords, rtol=0, atol=1e-6, err_msg=s)
        assert np.array_equal(adj, r_adj) and np.array_equal(fp, r_fp)
        g = t_conf._HGraph(t_sl.parse_smiles(s), True)
        r_g = j_conf._HGraph(j_sl.parse_smiles(s), True)
        ff = t_ff.build_forcefield(g, tetra=g.tetra, cistrans=g.cistrans)
        r_ff = j_ff.build_forcefield(r_g, tetra=r_g.tetra, cistrans=r_g.cistrans)
        energy, grad = ff.energy_grad(coords)
        r_energy, r_grad = r_ff.energy_grad(r_coords)
        assert np.isfinite(energy)
        np.testing.assert_allclose(energy, r_energy, rtol=1e-9)
        np.testing.assert_allclose(grad, r_grad, rtol=1e-9, atol=1e-9)
    assert t_conf.embed_conformer(s)[2] == j_conf.embed_conformer(s)[2]


def test_optimized_conformers_rank_by_energy_as_coati_tpu_s(conformer_smiles):
    """mol_to_atoms_coords with optimize: the force-field-minimized
    lowest-energy conformer of three and its energy."""
    for s in conformer_smiles[:2] + ["C[C@H](N)C(=O)O"]:
        atoms, coords, energy = t_rd.mol_to_atoms_coords(s, optimize=True, numConfs=3)
        r_atoms, r_coords, r_energy = j_rd.mol_to_atoms_coords(s, optimize=True, numConfs=3)
        assert np.array_equal(atoms, r_atoms)
        np.testing.assert_allclose(coords, r_coords, rtol=0, atol=1e-6)
        assert np.isfinite(energy) and energy == pytest.approx(r_energy, rel=1e-9)


def test_graph_tokens_equal_coati_tpu_s(sample):
    """adj_mat_to_tokens over edge lists (a, b, order) of parsed molecules,
    with hydrogens, an aromatic order 1.5 and a NaN atom row."""
    for s in sample[:100]:
        mol = t_sl.parse_smiles(s)
        z = np.array([t_fp._atomic_number(a.element) for a in mol.atoms] + [1, 1])
        edges = [(b.a, b.b, 1.5 if b.aromatic else b.order) for b in mol.bonds]
        edges += [(0, len(z) - 2, 1.0), (1, len(z) - 1, 1.0)]
        for only_heavy in (True, False):
            mine = t_gt.adj_mat_to_tokens(np.array(edges), z, only_heavy=only_heavy)
            assert mine == j_gt.adj_mat_to_tokens(np.array(edges), z, only_heavy=only_heavy)
            assert mine.startswith("[GRAPH]") and "[EDGES]" in mine
    assert t_gt.adj_mat_to_tokens(np.zeros((0, 3)), np.array([6.0, np.nan])) == ""


def test_rdkit_support_offline_paths_equal_coati_tpu_s(sample, cold_cache):
    """Without RDKit: the offline paths give coati_tpu's answers, including
    its fallbacks for grammar the parser does not take; the functions that
    need an RDKit Mol raise as coati_tpu's do."""
    assert not t_rd.HAS_RDKIT
    odd = ["C1CC", "*C", "CC(", "", "[C@TH1](F)(Cl)Br", "BAD", "c1ccccc1.[Na+]"]
    for s in sample[:100] + STEREO + odd:
        assert t_rd.canon_smiles(s) == j_rd.canon_smiles(s), s
        assert t_rd.canonicalize_or_self(s) == j_rd.canonicalize_or_self(s), s
        assert t_rd.is_valid_smiles(s) == j_rd.is_valid_smiles(s), s
    for a, b in zip(sample[:50], STEREO * 5):
        for chiral in (0, 1):
            assert (t_rd.identical_canonsmi(a, b, chiral)
                    == j_rd.identical_canonsmi(a, b, chiral))
    assert t_rd.identical_canonsmi("N[C@@H](C)C(=O)O", "C[C@H](N)C(=O)O")
    assert t_rd.mol_to_atoms_coords("C1CC") is None is j_rd.mol_to_atoms_coords("C1CC")
    assert t_rd.sim_mol("CCO", "CCN") == j_rd.sim_mol("CCO", "CCN")
    assert t_rd.mol_standardize("CCO.[Na+].[Cl-]") == j_rd.mol_standardize("CCO.[Na+].[Cl-]")
    assert t_rd.mol_properties("CCO") == j_rd.mol_properties("CCO")
    for fn in (lambda: t_rd.read_sdf("x.sdf"), lambda: t_rd.draw_smi_grid(["CCO"]),
               lambda: t_rd.mol_properties(object())):
        with pytest.raises(ImportError, match="RDKit"):
            fn()


def test_native_loader_builds_into_the_package_and_records_failures(monkeypatch, tmp_path):
    """The library is built once into coati_tpu_torch/_build under a hash of
    the source; a compiler that fails leaves its output in BUILD_ERRORS and
    the consumers on their Python paths; COATI_TPU_NO_NATIVE=1 loads
    nothing."""
    if native.load_fast_canon() is not None:
        path = native.library_path("fast_canon")
        assert path.exists() and path.parent == native.BUILD_DIR
        assert path.parent.name == "_build" and path.parent.parent.name == "coati_tpu_torch"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_ERRORS", {})
    monkeypatch.setenv("CC", "false")  # a compiler that always fails
    assert native.load_fast_canon() is None and native.load_fast_matcher() is None
    assert "false exited 1" in native.BUILD_ERRORS["fast_canon"]
    assert not list(tmp_path.iterdir())
    assert t_canon._try_native("CCO", True, 512) is None
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("COATI_TPU_NO_NATIVE", "1")
    monkeypatch.delenv("CC")
    assert native.load_fast_canon() is None and not list(tmp_path.iterdir())
    assert not VocabMatcher(["C", "Cl"]).uses_native
