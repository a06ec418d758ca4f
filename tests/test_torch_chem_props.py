"""coati_tpu_torch's property chemistry and SELFIES support against
coati_tpu's on the CPU: Crippen logP, QED in its three weightings and its
eight properties, the SMARTS matcher, standardization and fragment
splitting, the RDKit-free mol_standardize / mol_properties / sim_mol,
corpus enumeration, SELFIES documents and the SELFIES training transform.
The port's modules are copies of the JAX package's host code, so every
comparison of chemistry is exact; the one model encoding is held at
atol 3e-5, rtol 1e-4."""

import gzip
import random
from pathlib import Path

import numpy as np
import pytest

from coati_tpu.chem import crippen as j_crippen
from coati_tpu.chem import enumerate as j_enum
from coati_tpu.chem import qed as j_qed
from coati_tpu.chem import rdkit_support as j_rd
from coati_tpu.chem import smarts as j_smarts
from coati_tpu.chem import standardize as j_std
from coati_tpu.chem.aromaticity import perceive_aromaticity as j_perceive
from coati_tpu.chem.selfies_lite import parse_smiles as j_parse
from coati_tpu.models.io import load_e3gnn_smiles_clip_e2e as jax_load
from coati_tpu.models.io import params_to_state
from coati_tpu.models.io import serialize_model as jax_serialize
from coati_tpu.tokenizers import selfies_support as j_sel
from coati_tpu.tokenizers.trie_tokenizer import TrieTokenizer as JaxTokenizer

from tests import torch_port_helpers as hp
from coati_tpu_torch.chem import crippen as t_crippen
from coati_tpu_torch.chem import enumerate as t_enum
from coati_tpu_torch.chem import qed as t_qed
from coati_tpu_torch.chem import rdkit_support as t_rd
from coati_tpu_torch.chem import smarts as t_smarts
from coati_tpu_torch.chem import standardize as t_std
from coati_tpu_torch.chem.aromaticity import perceive_aromaticity as t_perceive
from coati_tpu_torch.chem.selfies_lite import parse_smiles as t_parse
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers import selfies_support as t_sel
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CORPUS = Path(__file__).resolve().parents[1] / "corpora" / "chembl_synth_v1.smi.gz"
# charged, salted, zwitterionic, aromatic heterocycles, isotopes, stereo
HAND_PICKED = [
    "CC(=O)Oc1ccccc1C(=O)O", "C[N+](C)(C)CCO", "CC(=O)[O-].[Na+]", "c1ccccc1.[Na+].[Cl-]",
    "[NH3+]CC(=O)[O-]", "Cn1cnc2c1c(=O)n(C)c(=O)n2C", "c1ccc2[nH]ccc2c1", "c1ccncc1",
    "O=C([O-])c1ccccc1.[K+]", "CC[N+](=O)[O-]", "C1=CC=CC=C1", "[2H]C([2H])([2H])O",
    "N[C@@H](C)C(=O)O", "OC(=O)CCC(=O)O.CN", "Clc1ccc(Cl)cc1", "c1ccsc1", "c1cc[o+]cc1",
    "C[S+](C)C", "O=S(=O)(O)c1ccccc1", "CC(C)(C)c1ccc(O)cc1.Cl",
]


@pytest.fixture(scope="module")
def molecules():
    """Corpus rows 200-399 and the hand-picked cases."""
    return gzip.open(CORPUS, "rt").read().split()[200:400] + HAND_PICKED


def _same(fn_t, fn_j, x):
    """Both packages' answer to fn(x): the value, or the exception type."""
    out = []
    for fn in (fn_t, fn_j):
        try:
            out.append(fn(x))
        except Exception as ex:  # noqa: BLE001 - compared by type
            out.append(type(ex).__name__)
    assert out[0] == out[1], (x, out)
    return out[0]


def test_crippen_and_qed_equal_coati_tpu_s(molecules):
    for s in molecules:
        _same(t_crippen.mol_logp, j_crippen.mol_logp, s)
        _same(t_qed.qed_properties, j_qed.qed_properties, s)
        for t_w, j_w in ((t_qed.weights_mean, j_qed.weights_mean),
                         (t_qed.weights_max, j_qed.weights_max),
                         (t_qed.weights_none, j_qed.weights_none)):
            _same(t_w, j_w, s)
        _same(t_qed.qed, j_qed.qed, s)
    # the three weightings differ, and the corpus gives finite values
    s = molecules[0]
    assert len({t_qed.weights_mean(s), t_qed.weights_max(s), t_qed.weights_none(s)}) == 3
    assert 0.0 < t_qed.qed(s) < 1.0


def test_smarts_matches_equal_coati_tpu_s(molecules):
    patterns = [*t_qed.ACCEPTOR_SMARTS, t_qed.ROTB_SMARTS, *t_qed.STRUCTURAL_ALERTS[:40]]
    assert patterns == [*j_qed.ACCEPTOR_SMARTS, j_qed.ROTB_SMARTS, *j_qed.STRUCTURAL_ALERTS[:40]]
    hits = 0
    for s in molecules[:80] + HAND_PICKED:
        mols = []
        for parse, perceive, smarts in ((t_parse, t_perceive, t_smarts),
                                        (j_parse, j_perceive, j_smarts)):
            mol = parse(s)
            perceive(mol)
            mols.append((smarts.MolContext(mol), smarts))
        (t_ctx, ts), (j_ctx, js) = mols
        for p in patterns:
            mine = ts.compile_smarts(p).count_matches(t_ctx)
            assert mine == js.compile_smarts(p).count_matches(j_ctx), (s, p)
            assert ts.SmartsPattern(p).has_match(t_ctx) == (mine > 0)
            hits += mine
    assert hits > 0


def test_standardize_and_fragments_equal_coati_tpu_s(molecules):
    changed = 0
    for s in molecules:
        out = _same(t_std.standardize_smiles, j_std.standardize_smiles, s)
        _same(t_std.split_fragments, j_std.split_fragments, s)
        changed += out != s
    assert changed > 0
    # the salt goes and the acid is uncharged; as in coati_tpu, the writing
    # after the uncharge is not always the canonical one
    acid = t_std.standardize_smiles("CC(=O)[O-].[Na+]")
    assert acid == j_std.standardize_smiles("CC(=O)[O-].[Na+]") == "CC(O)=O"
    assert t_rd.canon_smiles(acid) == t_rd.canon_smiles("CC(=O)O")


def test_rdkit_free_properties_standardize_and_similarity_equal_coati_tpu_s(molecules):
    assert not t_rd.HAS_RDKIT
    for s in molecules:
        props = _same(t_rd.mol_properties, j_rd.mol_properties, s)
        _same(t_rd.mol_standardize, j_rd.mol_standardize, s)
        assert props is None or {"MolLogP", "QED", "TPSA"} <= set(props)
    for a, b in zip(molecules[:60], molecules[1:61]):
        sim = t_rd.sim_mol(a, b)
        assert sim == j_rd.sim_mol(a, b) and 0.0 <= sim <= 1.0
    assert t_rd.sim_mol(molecules[0], molecules[0]) == 1.0


def test_enumerate_corpus_from_one_seed_equals_coati_tpu_s(molecules):
    seeds = molecules[:12]
    mine, ref = (m.enumerate_corpus(seeds, n_target=60, seed=5) for m in (t_enum, j_enum))
    assert mine == ref and mine["stats"]["n_corpus"] == len(mine["corpus"]) > len(seeds) // 2
    frags_t, pairs_t, seeds_t = t_enum.build_fragment_library(seeds)
    frags_j, pairs_j, seeds_j = j_enum.build_fragment_library(seeds)
    assert (pairs_t, seeds_t) == (pairs_j, seeds_j)
    assert [f.key for f in frags_t] == [f.key for f in frags_j]


# ------------------------------------------------------------------ SELFIES


def test_selfies_document_loads_with_coati_tpu_s_tokens_and_encoding(tmp_path):
    vocab = get_vocab("selfies_mcp_clone")
    n_tok = TrieTokenizer(n_seq=40, **vocab).n_token
    kwargs = dict(n_layer_e3gnn=1, n_layer_xformer=2, n_hidden_xformer=32, n_hidden_e3nn=16,
                  n_embd_common=32, n_head=2, n_seq=40, n_tok=n_tok, norm_clips=True,
                  token_mlp=True)
    jparams, _, _, _ = hp.model_pair(seed=11, **kwargs)
    path = tmp_path / "selfies_doc.pkl"
    path.write_bytes(jax_serialize(
        train_args={"tokenizer_vocab": "selfies_mcp_clone"}, dataset_summary={},
        model_state=params_to_state(jparams), model_kwargs=kwargs))
    model, tok = load_e3gnn_smiles_clip_e2e(str(path), device="cpu")
    jmodel, jtok = jax_load(str(path))
    assert getattr(tok.pre_tokenize, "__func__", None) is t_sel.selfies_pre_tokenize
    smiles = ["CCO", "c1ccccc1O", "CC(=O)N", "OC(=O)C1CC1", "N#CC"]
    rows = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles]
    assert rows == [jtok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles]
    jmodel = type(jmodel)(jmodel.params, jmodel.config.replace(precision="highest"))
    hp.close(model.encode_tokens(rows, tok), jmodel.encode_tokens(np.asarray(rows), jtok))


def test_clip_ar_xform_selfies_gives_coati_tpu_s_batch_from_the_same_seed(molecules):
    tok = TrieTokenizer(n_seq=64, **get_vocab("selfies_mcp_clone"))
    jtok = JaxTokenizer(n_seq=64, **get_vocab("selfies_mcp_clone"))
    smiles = molecules[:8] + ["CCO", "BAD(", "c1ccccc1"]
    batches = []
    for package, tokenizer in ((t_sel, tok), (j_sel, jtok)):
        batch = {"smiles": list(smiles)}
        random.seed(3)
        out = package.clip_ar_xform_selfies(batch, tokenizer, p_dataset=0.0, p_formula=0.5,
                                            rng=random.Random(4))
        batches.append((out, random.getstate()))
    (mine, state_t), (ref, state_j) = batches
    assert state_t == state_j
    assert sorted(mine) == sorted(ref)
    for key in ("tokens", "raw_tokens", "y_next"):
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
    assert (mine["tokens"] > 0).any()
    assert t_sel.selfies_to_smiles(t_sel.sf.encoder("CCO")) == "CCO"
