"""coati_tpu_torch's user entry points (coati_tpu_torch/examples/) and the
last public names of coati_tpu, against coati_tpu on the CPU.

Each example's main runs at a small size with --device cpu and is held
against the coati_tpu functions it wraps on the same inputs: the trained
document docs/eval_model_r5.pkl (coati_tpu at precision "highest") for the
COATI examples, a seeded small COATI2 document, small DUE models, small
training configurations. Then the public-name coverage of the port, the
Trie, the host utilities and the periodic-table constants.

Tolerance atol 3e-5, rtol 1e-4 unless a line says why."""

import ast
import fnmatch
import gzip
import importlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from coati_tpu.generative import purifications as jpu
from coati_tpu.models.api import COATI as JaxCOATI
from coati_tpu.models.io import load_coati2 as jax_load_coati2
from coati_tpu.models.io import load_e3gnn_smiles_clip_e2e as jax_load

from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self
from coati_tpu_torch.examples import (
    chembl_analysis,
    coati2_tutorial,
    finetune_lora,
    generation_examples,
    metadynamics_example,
    serve,
    train_coati2,
    train_grande,
    tutorial,
)
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e, model_to_state, serialize_model
from coati_tpu_torch.regression.due import DueConfig, train_due
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
DOC = str(ROOT / "docs" / "eval_model_r5.pkl")
CORPUS = ROOT / "corpora" / "chembl_synth_v1.smi.gz"
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def jax_trained():
    jmodel, jtok = jax_load(DOC)
    return JaxCOATI(jmodel.params, jmodel.config.replace(precision="highest")), jtok


@pytest.fixture(scope="module")
def small_due(tmp_path_factory):
    """A DUE model over 256-d inputs, fitted for a few steps and saved as
    the port saves one (DueModel.save)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    due = train_due(x, x[:, 0], config=DueConfig(input_dim=256, features=32, n_inducing=8),
                    steps=5, batch_size=32, verbose=False, device="cpu")
    path = tmp_path_factory.mktemp("due") / "due.pkl"
    due.save(str(path))
    return str(path)


# ----------------------------------------------------------------- COATI


def test_loaders_give_the_same_setting_in_both_packages(jax_trained):
    """The generation-quality protocol runs in the setting each package's
    loader gives: float32 weights and compute, a cache of the compute dtype."""
    jmodel, _ = jax_load(DOC)
    tmodel, _ = load_e3gnn_smiles_clip_e2e(DOC, device="cpu")
    for field in ("dtype", "kv_dtype", "kv_scale_dtype"):
        assert getattr(tmodel.config, field) == getattr(jmodel.config, field), field
    assert tmodel.config.dtype == "float32"
    assert not tmodel.config.xformer_config.kv_quantized


def test_tutorial_embeds_as_coati_tpu_and_decodes(jax_trained):
    jmodel, jtok = jax_trained
    out = tutorial.main(["--doc_url", DOC, "--n_analogs", "2", *CPU])
    smiles = [canonicalize_or_self(s) for s in tutorial.DEFAULT_SMILES]
    assert out["smiles"] == smiles
    assert out["embeddings"].shape == (6, 256) and out["embeddings"].dtype == np.float32
    hp.close(out["embeddings"], jpu.embed_smiles_batch(smiles, jmodel, jtok))
    assert len(out["decoded"]) == 6 and all(isinstance(s, str) for s in out["decoded"])
    assert len(out["analogs"]) == 2 and 0 <= out["analogs_valid"] <= 2
    assert 0 <= out["round_trip_exact"] <= 6


def test_chembl_analysis_s2s_likelihoods_match_coati_tpu(jax_trained):
    jmodel, jtok = jax_trained
    out = chembl_analysis.main(["--doc_url", DOC, "--batches", "1", "--batch_size", "2", *CPU])
    nll, mask = jmodel.batch_smiles_to_s2s_likelihood(chembl_analysis.MOLS, jtok)
    np.testing.assert_array_equal(out["s2s_mask"], np.asarray(mask))
    hp.close(out["s2s_nll"], np.asarray(nll))
    assert len(out["generated"]) == 2 and 0.0 <= out["fraction_valid"] <= 1.0


def test_generation_quality_protocol_on_a_small_sample():
    """The protocol's corpus split is coati_tpu's (seed 20260819, 10%
    holdout); its round trip and bulk draw run end to end on a few rows."""
    from coati_tpu.data.synth import SynthCorpusDataset as JaxSynth

    train, hold = chembl_analysis.split_corpus(str(CORPUS))
    jtrain, jhold = JaxSynth.from_files(str(CORPUS), epoch_rows=0).split(0.1)
    assert (train, hold) == (jtrain, jhold) and len(hold) == 12_000
    assert chembl_analysis.rt_subset(hold, 3) == [
        hold[i] for i in np.random.default_rng(11).permutation(len(hold))[:3]]
    model, tok = load_e3gnn_smiles_clip_e2e(DOC, device="cpu")
    share, rows = chembl_analysis.greedy_roundtrip(model, tok, chembl_analysis.rt_subset(hold, 3))
    assert rows == 3 and share in (0.0, 1 / 3, 2 / 3, 1.0)
    bulk = chembl_analysis.bulk_protocol(model, tok, batches=1, batch_size=2, k=10_000,
                                         inv_temp=1.75)
    assert bulk["n_samples"] == 2 and 0.0 <= bulk["fraction_valid"] <= 1.0
    assert bulk["n_unique_canonical"] <= bulk["n_unique_valid"] <= 2


def test_generation_examples_embed_as_coati_tpu_and_score_with_due(jax_trained, small_due,
                                                                  monkeypatch):
    jmodel, jtok = jax_trained
    seeds = generation_examples.SEEDS[:2]
    monkeypatch.setattr(generation_examples, "SEEDS", seeds)
    out = generation_examples.main(["--doc_url", DOC, "--n_bulk", "2", "--n_screen", "2",
                                    "--due_model", small_due, *CPU])
    hp.close(out["embeddings"], jpu.embed_smiles_batch(seeds, jmodel, jtok))
    assert len(out["bulk"]) == 2 and len(out["analogs"]) == 16
    assert out["density_samples"].shape == (2, 256) and len(out["screened"]) == 2
    assert out["due_mean"].shape == (2,) and np.isfinite(out["due_std"]).all()


def test_metadynamics_example_walks_under_a_due_model(small_due):
    walked = metadynamics_example.main(["--doc_url", DOC, "--steps", "1", "--due_qed",
                                        small_due, *CPU])
    assert walked["n_terms"] == 1 and walked["molecules_found"] > 0
    assert np.isfinite(walked["best_score"]) and len(walked["history"]) == 1


def test_finetune_lora_writes_a_document_both_packages_read(tmp_path):
    out_path = str(tmp_path / "tuned.pkl")
    out = finetune_lora.main(["--doc_url", DOC, "--steps", "1", "--batch_size", "4",
                              "--out", out_path, *CPU])
    assert out["rows"] == 10 and len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    tuned, tok = load_e3gnn_smiles_clip_e2e(out_path, device="cpu")
    base = load_e3gnn_smiles_clip_e2e(DOC, device="cpu")[0].params.state_dict()
    moved = {k for k, v in tuned.params.state_dict().items() if not torch.equal(v, base[k])}
    assert moved and all(k.startswith("xformer.") for k in moved)  # only the trunk merged
    jtuned, jtok = jax_load(out_path)
    jtuned = JaxCOATI(jtuned.params, jtuned.config.replace(precision="highest"))
    tokens = np.asarray([tok.tokenize_text("[SMILES]CCO[STOP]", pad=True)])
    hp.close(tuned.encode_tokens(tokens, tok), np.asarray(jtuned.encode_tokens(tokens, jtok)))


def test_serve_tiny_answers_every_endpoint_and_stops():
    out = serve.main(["--tiny", "--requests", "1", "--port", "0", "--max_batch", "8", *CPU])
    assert out["healthz"]["status"] == "ok" and out["healthz"]["device"] == "cpu"
    assert np.asarray(out["embeddings"]).shape == (4, 64)
    assert len(out["generated"]) == 4 and all(isinstance(s, str) for s in out["generated"])
    assert [len(a) for a in out["analogs"]] == [4, 4]
    assert all(len(v) == 1 for v in out["seconds"].values())


# ----------------------------------------------------------------- COATI2


@pytest.fixture(scope="module")
def coati2_document(tmp_path_factory):
    """A seeded small COATI2 written by the port's serialize_model with the
    coati2_12_12 tokenizer, so that the [PROPS] branch runs."""
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
    from coati_tpu_torch.training.train_coati2 import Coati2TrainConfig, fresh_model

    tok = TrieTokenizer(n_seq=48, **get_vocab("coati2_12_12"))
    config = Coati2TrainConfig(n_layer_xformer=2, n_hidden_xformer=64, embed_dim=64, n_head=4,
                               n_seq=48, n_direct_clr=16)
    model = fresh_model(config.model_config(tok.n_token), torch.device("cpu"), seed=4)
    path = tmp_path_factory.mktemp("coati2") / "coati2.pkl"
    path.write_bytes(serialize_model(
        train_args={"tokenizer_vocab": "coati2_12_12"}, dataset_summary={},
        model_state=model_to_state(model), model_kwargs=config.model_kwargs(tok.n_token)))
    return str(path)


def test_coati2_tutorial_embeds_as_coati_tpu_and_conditions_ragged_prefixes(coati2_document):
    out = coati2_tutorial.main(["--doc_url", coati2_document, "--n_per_noise", "2", *CPU])
    jmodel, jtok = jax_load_coati2(coati2_document)
    jmodel = type(jmodel)(jmodel.params, jmodel.config.replace(precision="highest"))
    hp.close(out["embeddings"], np.asarray(jmodel.smiles_to_coati_vec(coati2_tutorial.SEEDS,
                                                                      jtok)))
    assert out["prefix_lengths"] == [5] * 8 + [7] * 8
    from coati_tpu_torch.models.io import load_coati2

    _, tok = load_coati2(coati2_document, device="cpu")
    for row, text in zip(out["conditioned_tokens"],
                         [c for c in coati2_tutorial.CONDITIONS for _ in range(8)]):
        prefix = tok.tokenize_text(text, pad=False)
        assert row[: len(prefix)].tolist() == prefix
    assert sorted(out["noise"]) == [0.0, 0.2, 0.4, 0.6]


def test_train_coati2_dry_run(tmp_path):
    out = train_coati2.main(["--dry_run", "--output_dir", str(tmp_path / "logs"),
                             "--model_dir", str(tmp_path / "models"), *CPU])
    history = out["results"]["history"]
    assert len(history) == 4 and all(np.isfinite(h[3]) for h in history)
    assert out["config"].n_hidden_xformer == 64 and len(list((tmp_path / "models").iterdir()))


# ----------------------------------------------------------------- training


def _small_grande(**overrides):
    from coati_tpu_torch.training.config import grande_config

    return grande_config(n_layer_xformer=2, n_hidden_xformer=32, n_embd_common=32, n_head=4,
                         n_layer_e3gnn=1, n_hidden_e3nn=32, **overrides)


def test_train_grande_dry_run_and_a_short_run_on_a_dataset(tmp_path, monkeypatch):
    """The launcher at a small width (grande_config's recipe, narrower):
    the synthetic dry run, then one epoch of --max_steps_per_epoch 2 over
    COATI_dataset shards of fixture molecules."""
    import pickle

    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.data.dataset import S3_PATH

    monkeypatch.setattr(train_grande, "grande_config", _small_grande)
    args = ["--output_dir", str(tmp_path / "logs"), "--model_dir", str(tmp_path / "models"), *CPU]
    dry = train_grande.main(["--dry_run", *args])
    assert len(dry["results"]["history"]) == 4 and dry["config"].batch_size == 8
    smiles, atoms, coords = load_points_fixture()
    shard = tmp_path / "data" / S3_PATH
    shard.mkdir(parents=True)
    rows = [{"smiles": s, "source_collection": "geom_drugs",
             "atoms": a[: int((a > 0).sum())].astype(np.float64),
             "coords": c[: int((a > 0).sum())].astype(np.float64)}
            for s, a, c in zip(smiles[:400], atoms[:400], coords[:400])]
    with open(shard / "0.pkl", "wb") as f:
        pickle.dump(rows, f)
    monkeypatch.setattr(train_grande, "grande_config",
                        lambda **kw: _small_grande(batch_size=8, **kw))
    real = train_grande.main(["--data_dir", str(tmp_path / "data"), "--n_epochs", "1",
                              "--max_steps_per_epoch", "2", *args])
    assert real["config"].n_epochs == 1
    history = real["results"]["history"]
    assert len(history) == 2 and all(np.isfinite(h[3]) for h in history)


@pytest.mark.parametrize("example", [tutorial, chembl_analysis, generation_examples,
                                     metadynamics_example, finetune_lora])
def test_examples_run_on_the_card_or_refuse_without_one(example, monkeypatch):
    """No --device and no card: the loader refuses; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--doc_url", DOC])


# ---------------------------------------------------------- public names

# names of coati_tpu with no counterpart in the port, and why
JAX_ONLY = {
    "*Params": "parameter pytrees: the port's parameters are nn.Modules",
    "FpHead": "a fingerprint head's parameter pytree: the port's fp_networks nn.Linear",
    "init_*": "seeded JAX inits: the port's nn.Modules and fresh_model are seeded",
    "convert_*": "JAX <-> torch conversion: the port's models/convert.py goes the other way",
    "export_*": "JAX <-> torch conversion: the port's models/convert.py goes the other way",
    "subtree": "a pytree helper of the JAX <-> torch conversion",
    "to_numpy": "a pytree helper of the JAX <-> torch conversion",
    "fused_round_trip": "a jit shape bucket: PyTorch runs eagerly",
    "bucket_size": "a jit shape bucket: PyTorch runs eagerly",
    "mm_precision": "an XLA precision knob",
    "matmul_precision": "an XLA precision knob",
    "attn_softmax_dtype": "an XLA precision knob",
    "tpu_compiler_options": "XLA compilation settings",
    "enable_persistent_compilation_cache": "XLA compilation settings",
    "batch_sharding": "GSPMD: the port places tensors by rank",
    "commit_to_template": "GSPMD: the port places tensors by rank",
    "replicated": "GSPMD: the port places tensors by rank",
    "shard_batch": "GSPMD: the port places tensors by rank",
    "shard_params": "GSPMD: the port places tensors by rank",
    "shard_params_fsdp": "GSPMD: the port places tensors by rank",
    "commit_opt_state": "GSPMD: the port places tensors by rank",
    "torch_linear_init": "JAX stand-ins for torch's own initialisation",
    "torch_embedding_init": "JAX stand-ins for torch's own initialisation",
    "params_from_state": "the JAX side of the document format (port: load_*, model_to_state)",
    "coati2_params_from_state": "the JAX side of the document format (port: load_*)",
    "params_to_state": "the JAX side of the document format (port: model_to_state)",
}


def _jax_only(name: str) -> bool:
    return any(fnmatch.fnmatchcase(part, pattern)
               for part in name.split(".") for pattern in JAX_ONLY)


def _public_names(path: Path):
    """Top-level functions, classes (with their public methods) and
    constants that a module defines."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(f"{node.name}.{m.name}" for m in node.body
                             if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and not m.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets
                         if isinstance(t, ast.Name) and not t.id.startswith("_"))
    return names


JAX_MODULES = sorted(
    str(p.relative_to(ROOT / "coati_tpu").with_suffix("")).replace("/", ".")
    for p in (ROOT / "coati_tpu").rglob("*.py")
    if p.name != "__init__.py" and "pallas" not in p.parts)


def _missing(module: str):
    """The public names of coati_tpu's `module` that the port's module of
    the same path lacks."""
    names = _public_names(ROOT / "coati_tpu" / (module.replace(".", "/") + ".py"))
    port = importlib.import_module(f"coati_tpu_torch.{module}")
    missing = []
    for name in sorted(names):
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    return missing


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_of_coati_tpu_has_a_counterpart(module):
    """Every public name of each coati_tpu module (ops/pallas aside: its
    kernels are the port's csrc/) exists under the same name in the port's
    module of the same path, unless JAX_ONLY gives the reason it cannot."""
    unexplained = [n for n in _missing(module) if not _jax_only(n)]
    assert not unexplained, f"coati_tpu_torch.{module} lacks {unexplained}"


def test_every_jax_only_entry_explains_a_missing_name():
    """JAX_ONLY shrinks with the port: each entry matches a name the port
    lacks."""
    missing = [n for module in JAX_MODULES for n in _missing(module)]
    unused = [p for p in JAX_ONLY
              if not any(fnmatch.fnmatchcase(part, p) for n in missing for part in n.split("."))]
    assert not unused, f"JAX_ONLY entries the port no longer needs: {unused}"


# --------------------------------------------------------- host helpers


def test_trie_splits_the_tokenizer_s_text_as_coati_tpu_s():
    from coati_tpu.tokenizers.matcher import Trie as JaxTrie

    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.matcher import Trie

    vocab = get_vocab("mar")
    tokens = list(vocab["special_tokens"]) + list(vocab["smiles_tokens"])
    mine, ref = Trie(tokens), JaxTrie(tokens)
    with gzip.open(CORPUS, "rt") as f:
        texts = ["[SET][chembl_mols][SMILES]" + next(f).strip() + "[STOP]" for _ in range(200)]
    texts += ["[CLIP][UNK][SMILES]C#N[STOP][PAD]", "CCéO", "", "[SMILES"]
    for text in texts:
        assert mine.split(text) == ref.split(text), text
        assert "".join(mine.split(text)) == text
    cuts = [0, 3, 3, 7]
    assert mine.cut_text("abcdefghij", cuts) == ref.cut_text("abcdefghij", cuts)
    with pytest.raises(RuntimeError):
        mine.cut_text("abc", [2, 1])


def test_util_helpers_equal_coati_tpu_s():
    from coati_tpu.common import util as ju

    from coati_tpu_torch.common import util as tu

    grid = {"a": [1, 2], "b": ["x", "y", "z"], "c": [None]}
    assert tu.tensor_of_dict_of_lists(grid) == ju.tensor_of_dict_of_lists(grid)
    obj = {"i": np.int64(3), "f": np.float32(0.5), "a": np.arange(3), "t": torch.tensor([1.5]),
           "n": [np.int32(1)]}
    assert tu.json_valid_dict(obj) == ju.json_valid_dict(obj)
    assert json.dumps(obj, cls=tu.NpEncoder) == json.dumps(obj, cls=ju.NpEncoder)
    xs = np.random.default_rng(7).normal(size=(20, 3))
    mine, ref = tu.OnlineEstimator(xs[0]), ju.OnlineEstimator(xs[0])
    for x in xs[1:]:
        np.testing.assert_array_equal(np.asarray(mine(x)), np.asarray(ref(x)))
    np.testing.assert_allclose(mine.mean, xs.mean(0), rtol=1e-12)
    rows = [{"k": i, "v": str(i)} for i in range(5)]
    assert tu.dicts_to_keyval(rows, "k", "v") == ju.dicts_to_keyval(rows, "k", "v")
    recs = [5, 3, 8, 1, 9, 2, 7, 4, 6]  # sorted in chunks of n: [3, 5], [1, 8], ...
    assert tu.records_mp(recs, sorted, n=2) == ju.records_mp(recs, sorted, n=2) == \
        [3, 5, 1, 8, 2, 9, 4, 7, 6]
    assert tu.execute_with_timeout(sum, ([1, 2],), 5) == 3
    start = time.perf_counter()
    assert tu.execute_with_timeout(time.sleep, (3,), 1) is None
    assert time.perf_counter() - start < 2.5


def test_periodic_table_constants_equal_coati_tpu_s():
    from coati_tpu.common import periodic_table as jpt

    from coati_tpu_torch.common import periodic_table as tpt

    for z in range(len(jpt.PERIODIC_TABLE)):
        assert tpt.XY_ONE_HOT(z) == jpt.XY_ONE_HOT(z)
        assert tpt.IS_INORGANIC(z) == jpt.IS_INORGANIC(z)
    assert tpt.XY_ONE_HOT("Cl") == jpt.XY_ONE_HOT("Cl")
    for z in (1, 6, 7, 8, 9, 15, 16, 17, 35, 53):
        assert tpt.REVERSE_XY_ONE_HOT(tpt.XY_ONE_HOT(z)) == jpt.REVERSE_XY_ONE_HOT(
            jpt.XY_ONE_HOT(z))
    for prop in ("cpk-hex", "symbol", "atomic_mass", "electronegativity_pauling"):
        assert tpt.PERIODIC_PROPERTY(prop) == jpt.PERIODIC_PROPERTY(prop)
    assert tpt.PERIODIC_PROPERTY() == jpt.PERIODIC_PROPERTY()
    atoms = np.array([6, 8, 0, 1, 17])
    coords = np.random.default_rng(8).normal(size=(5, 3))
    assert tpt.XYZ_STRING(atoms, coords) == jpt.XYZ_STRING(atoms, coords)
