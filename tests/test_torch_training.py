"""coati_tpu_torch's trainer against coati_tpu's on the CPU: the training
configuration, the host pipeline (matcher, batch transform, fixture
dataset), the optimizer (clip, AdamW, schedule), one and three train steps
from the same weights, batch and clip-token choice, the bf16 step, the
small tools (deferred metrics, timer, finite check, FLOP count, logger), and
train_autoencoder end to end with its document read by both packages.

Models are tiny (2 layers x 64 wide, a 1-layer EGNN); float32 with JAX at
precision "highest"; tolerance atol 3e-5, rtol 1e-4 unless a line says why."""

import dataclasses
import glob
import json
import os
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coati_tpu.chem.rdkit_support import canonicalize_or_self
from coati_tpu.data import synth as jsynth
from coati_tpu.data import xform as jxform
from coati_tpu.models.io import load_e3gnn_smiles_clip_e2e as jax_load
from coati_tpu.models.io import params_to_state
from coati_tpu.tokenizers import get_vocab as jax_get_vocab
from coati_tpu.tokenizers.matcher import VocabMatcher as JaxMatcher
from coati_tpu.tokenizers.trie_tokenizer import TrieTokenizer as JaxTokenizer
from coati_tpu.training import config as jconfig
from coati_tpu.training import flops as jflops
from coati_tpu.training import train as jtrain

from coati_tpu_torch.data import fixture_dataset, load_points_fixture
from coati_tpu_torch.data.batch_pipe import batch_rows
from coati_tpu_torch.data.xform import clip_ar_xform
from coati_tpu_torch.models.convert import state_from_coati_tpu
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e, load_model_doc
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.matcher import VocabMatcher
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from coati_tpu_torch.training import config as tconfig
from coati_tpu_torch.training import flops as tflops
from coati_tpu_torch.training import train as ttrain
from coati_tpu_torch.training.diagnostics import finite_check, step_timer
from coati_tpu_torch.training.logger import COATILogger
from tests import torch_port_helpers as hp

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN(CC)CC", "OCC1OC(O)C(O)C(O)C1O", "CC(C)C",
          "NC(=O)c1ccc(N)cc1", "CC1=CC(=O)C=CC1=O"]


# ------------------------------------------------------------- configuration


def test_train_config_and_grande_recipe_equal_coati_tpu():
    """Field for field the JAX package's TrainConfig and grande_config, so
    that params.json files and checkpoint train_args pass between the two."""
    mine, ref = tconfig.TrainConfig(), jconfig.TrainConfig()
    assert mine.as_dict() == ref.as_dict()
    assert [f.name for f in dataclasses.fields(mine)] == [f.name for f in dataclasses.fields(ref)]
    assert tconfig.grande_config().as_dict() == jconfig.grande_config().as_dict()
    over = tconfig.grande_config(dtype="bfloat16", n_epochs=1)
    assert (over.dtype, over.n_epochs, over.batch_size, over.n_seq) == ("bfloat16", 1, 160, 80)
    assert json.loads(json.dumps(over.as_dict())) == over.as_dict()


@pytest.mark.parametrize("field,value", [("parallel_mode", "shard_map"), ("param_sharding", "fsdp")])
def test_more_than_one_device_is_refused(field, value):
    config = tconfig.TrainConfig(**{field: value})
    with pytest.raises(NotImplementedError, match="one device"):
        config.check_single_device()
    with pytest.raises(NotImplementedError, match="one device"):
        ttrain.train_autoencoder(config, None, device="cpu")


def test_orbax_dir_and_a_missing_card_are_refused(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match="orbax_dir"):
        ttrain.train_autoencoder(tconfig.TrainConfig(orbax_dir=str(tmp_path)), None, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train_autoencoder(tconfig.TrainConfig(), None)


def test_model_config_follows_coati_tpu_but_for_the_attention_kernel():
    """Every field of the model config a TrainConfig gives equals the JAX
    package's, except prefill_kernel: "xla" there; in the port the
    short-sequence kernel when no batch can be longer than it takes and the
    model has more than one head, else K2."""
    grande = tconfig.grande_config(dtype="bfloat16")
    mine = ttrain.model_config_from_train_config(grande, 13603)
    ref = jtrain.model_config_from_train_config(jconfig.grande_config(dtype="bfloat16"), 13603)
    for field in dataclasses.fields(mine):
        if field.name != "prefill_kernel" and hasattr(ref, field.name):
            assert getattr(mine, field.name) == getattr(ref, field.name), field.name
    assert (mine.prefill_kernel, ref.prefill_kernel) == ("packed", "xla")
    assert mine.xformer_config.remat and not mine.egnn_config.remat
    assert mine.egnn_config.message_cutoff == ref.egnn_config.message_cutoff
    default = ttrain.model_config_from_train_config(tconfig.TrainConfig(), 100)  # n_seq 200
    assert default.prefill_kernel == "auto"
    one_head = ttrain.model_config_from_train_config(tconfig.TrainConfig(n_seq=80, n_head=1), 100)
    assert one_head.prefill_kernel == "auto"
    edge = ttrain.model_config_from_train_config(tconfig.TrainConfig(n_seq=128), 100)
    assert edge.prefill_kernel == "packed"


# ------------------------------------------------------------- host pipeline


def test_matcher_splits_as_coati_tpu_s():
    """The port's pure-Python matcher (tokens grouped by length per first
    character) against coati_tpu's matcher: the same leftmost-longest
    split on the fixture's SMILES, on special-token text and on noise."""
    vocab = get_vocab("mar")
    tokens = list(vocab["special_tokens"]) + list(vocab["smiles_tokens"])
    mine, ref = VocabMatcher(tokens), JaxMatcher(tokens)
    smiles, _, _ = load_points_fixture()
    rng = random.Random(0)
    alphabet = "CNOclnos()[]=#@+-1234SET%Br.xyz "
    texts = ["[SMILES]" + s + "[STOP]" for s in smiles[:200]]
    texts += ["[CLIP][UNK][SET][chembl_mols][SMILES]C[SUFFIX]O[MIDDLE]N[STOP]", "", "[", "[[SMILES"]
    texts += ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 40))) for _ in range(200)]
    for text in texts:
        out = mine.split(text)
        assert out == ref.split(text), text
        assert "".join(out) == text


def _row_batch(smiles, atoms, coords, **columns):
    from coati_tpu_torch.data.batch_pipe import stack_batch

    rows = []
    for i, s in enumerate(smiles):
        n = int((atoms[i] > 0).sum())
        row = {"smiles": s, "source_collection": "chembl_mols",
               "atoms": atoms[i][:n].astype(np.int32), "coords": coords[i][:n]}
        row.update({k: v[i] for k, v in columns.items()})
        rows.append(row)
    return stack_batch(rows)


GRANDE_XFORM = dict(p_dataset=0.2, p_formula=0.0, p_fim=0.0, p_clip=0.9, p_clip_cut=0.3)
# (keyword arguments of both calls, how the batch differs from rows with atoms
# and canonical SMILES); "verbatim" cases pass canonicalize=False
XFORM_CASES = {
    "grande": (dict(GRANDE_XFORM), ()),
    "all_prefixes_and_fim": (dict(p_dataset=0.5, p_formula=0.5, p_fim=0.8, p_clip=0.4,
                                  p_clip_cut=0.5), ()),
    "permuted_column": (dict(p_dataset=0.2, p_formula=0.2, p_clip=0.9, p_randsmiles=0.5,
                             canonicalize=False), ("rand_smiles",)),
    "canonicalize": (dict(GRANDE_XFORM), ("rewritten",)),
    "permuted": (dict(GRANDE_XFORM, p_randsmiles=0.5), ("rewritten",)),
    "fp_targets": (dict(GRANDE_XFORM, fp_targets=(("morgan", 64), ("morgan", 2048))), ()),
    "p_graph": (dict(GRANDE_XFORM, p_graph=0.5, p_formula=0.3), ("graph",)),
    "no_atoms": (dict(GRANDE_XFORM, p_formula=0.5), ("no_atoms",)),
    "mixed_atoms": (dict(GRANDE_XFORM, p_formula=0.5), ("rows_without_atoms",)),
}


def _graph_columns(smiles):
    """adj_mat (edges a, b, order; 1.5 aromatic) and adj_mat_atoms (Z) of
    each molecule, as a precomputed graph column holds them."""
    from coati_tpu_torch.chem.fingerprints import _atomic_number
    from coati_tpu_torch.chem.selfies_lite import parse_smiles

    adj, z = [], []
    for s in smiles:
        mol = parse_smiles(s)
        z.append(np.array([_atomic_number(a.element) for a in mol.atoms]))
        adj.append(np.array([(b.a, b.b, 1.5 if b.aromatic else b.order) for b in mol.bonds]))
    return adj, z


def _xform_batch(smiles, atoms, coords, changes):
    columns = {}
    if "rand_smiles" in changes:  # any other writing will do: the column is used verbatim
        columns["rand_smiles"] = ["C" + s for s in smiles]
    if "rewritten" in changes:  # other writings of the same molecules
        from coati_tpu_torch.chem.selfies_lite import permute_smiles

        rng = random.Random(9)
        smiles = [permute_smiles(s, rng) for s in smiles]
    batch = _row_batch(smiles, atoms, coords, **columns)
    if "graph" in changes:
        batch["adj_mat"], batch["adj_mat_atoms"] = _graph_columns(smiles)
    if "no_atoms" in changes:
        batch["atoms"], batch["coords"] = np.zeros((len(smiles), 0)), np.zeros((len(smiles), 0, 3))
    if "rows_without_atoms" in changes:
        batch["atoms"][[2, 7, 30]] = 0
    return batch


@pytest.mark.parametrize("case", sorted(XFORM_CASES))
def test_clip_ar_xform_gives_coati_tpu_s_batch_from_the_same_seed(case):
    """The same random.Random seed on both sides, and the same state of the
    global random module (permute_smiles draws from it), gives identical
    tokens, raw_tokens, y_next, atoms, coordinates and fingerprints: the same
    draws in the same order, on every branch of the transform: canonical
    SMILES, other writings canonicalized, permutations from a column and
    computed, fingerprint targets, the graph representation, and conformers
    embedded for rows without atoms. n_seq 40 makes some rows take the
    oversize fallback."""
    smiles, atoms, coords = load_points_fixture()
    pick = slice(100, 148)
    kw, changes = XFORM_CASES[case]
    mine_tok = TrieTokenizer(n_seq=40, **get_vocab("mar"))
    ref_tok = JaxTokenizer(n_seq=40, **jax_get_vocab("mar"))
    for seed in (0, 1):
        random.seed(100 + seed)
        mine = clip_ar_xform(_xform_batch(smiles[pick], atoms[pick], coords[pick], changes),
                             tokenizer=mine_tok, rng=random.Random(seed), **kw)
        mine_draw = random.random()
        random.seed(100 + seed)
        ref = jxform.clip_ar_xform(_xform_batch(smiles[pick], atoms[pick], coords[pick], changes),
                                   tokenizer=ref_tok, rng=random.Random(seed), **kw)
        assert mine_draw == random.random()
        keys = ["tokens", "raw_tokens", "y_next", "atoms"] + ["fp_morgan"] * ("fp_targets" in kw)
        for key in keys:
            assert mine[key].dtype == ref[key].dtype and np.array_equal(mine[key], ref[key]), key
        np.testing.assert_array_equal(mine["coords"], ref["coords"])
        assert mine["tokens"].shape[1] % 8 == 0 and mine["tokens"].shape[1] <= 40
        assert (mine["y_next"] == -1).any() and (mine["tokens"] == mine_tok.clip_token).any()
        assert (mine["atoms"] > 0).any(axis=1).all()
    if "fp_targets" in kw:
        assert mine["fp_morgan"].shape == (48, 2048) and mine["fp_morgan"].any(axis=1).all()
    if "rewritten" in changes or case == "grande":  # the s2s targets, canonical or permuted
        fits = [(row, target) for row, target in zip(mine["raw_tokens"], (
            mine_tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles[pick]))
            if len(target) <= 40 and (row > 0).sum() > 1]  # not a row that was too long
        same = sum(list(row[row > 0]) == target for row, target in fits)
        assert len(fits) > 30
        assert same == len(fits) if case != "permuted" else 0 < same < len(fits)
    if "graph" in changes:
        assert (mine["tokens"] == mine_tok.tokenize_text("[GRAPH]", pad=False)[0]).any()


def test_fixture_smiles_are_canonical_and_the_dataset_serves_them_as_coati_tpu_would():
    """All 1,024 fixture SMILES are fixed points of coati_tpu's
    canonicalizer, so the transform's canonicalization leaves the fixture's
    conformer map keyed by what it trains on. fixture_dataset strips each
    row's padding, and its pipe yields the batches coati_tpu's
    SynthCorpusDataset yields over the same corpus and conformer map."""
    smiles, atoms, coords = load_points_fixture()
    moved = [s for s in smiles if canonicalize_or_self(s) != s]
    assert not moved, f"{len(moved)} fixture SMILES are not canonical: {moved[:3]}"
    data = fixture_dataset(2 * 64, seed=3)
    assert data.summary["n_molecules"] == data.summary["n_with_conformers"] == 1024
    for s, a in list(zip(smiles, atoms))[::97]:
        got_atoms, got_coords = data.conformers[s]
        assert len(got_atoms) == (a > 0).sum() and (got_atoms > 0).all()
        assert got_coords.shape == (len(got_atoms), 3)
    ref = jsynth.SynthCorpusDataset(smiles, 2 * 64, conformers=data.conformers, seed=3)
    mine_batches = list(data.get_data_pipe(batch_size=64))
    ref_batches = list(ref.get_data_pipe(batch_size=64))
    assert len(mine_batches) == len(ref_batches) == 2
    for mine, theirs in zip(mine_batches, ref_batches):
        assert list(mine["smiles"]) == list(theirs["smiles"])
        np.testing.assert_array_equal(mine["atoms"], theirs["atoms"])
        np.testing.assert_array_equal(mine["coords"], theirs["coords"])
        assert mine["atoms"].shape[1] in (64, 96, 128)  # padded to a bucket


def test_synth_corpus_dataset_loads_splits_and_subsets_as_coati_tpu_s(tmp_path):
    """from_files over the committed corpus and a conformer sidecar written
    here: the same rows, split and first batch as coati_tpu's."""
    corpus = str(Path(__file__).resolve().parents[1] / "corpora" / "chembl_synth_v1.smi.gz")
    smiles, atoms, coords = load_points_fixture()
    sidecar = tmp_path / "conformers.npz"
    ragged = np.empty(3, dtype=object)
    ragged_xyz = np.empty(3, dtype=object)
    for i in range(3):
        n = 0 if i == 1 else int((atoms[i] > 0).sum())  # the second embedding "failed"
        ragged[i], ragged_xyz[i] = atoms[i][:n], coords[i][:n]
    np.savez(sidecar, smiles=np.array(smiles[:3]), atoms=ragged, coords=ragged_xyz)
    from coati_tpu_torch.data.synth import SynthCorpusDataset

    mine = SynthCorpusDataset.from_files(corpus, 32, str(sidecar), seed=1)
    ref = jsynth.SynthCorpusDataset.from_files(corpus, 32, str(sidecar), seed=1)
    assert mine.smiles == ref.smiles and len(mine.smiles) > 100_000
    assert mine.summary == ref.summary and mine.summary["n_with_conformers"] == 2
    assert sorted(mine.conformers) == sorted(ref.conformers)
    assert mine.split(0.1) == ref.split(0.1)
    train, hold = mine.split(0.25)
    assert len(hold) == len(mine.smiles) // 4 and not set(train) & set(hold)
    sub, jsub = mine.subset(hold[:64], 16), ref.subset(hold[:64], 16)
    assert sub.epoch_rows == 16 and sub.conformers is mine.conformers
    a, b = next(iter(sub.get_data_pipe(batch_size=8))), next(iter(jsub.get_data_pipe(batch_size=8)))
    assert list(a["smiles"]) == list(b["smiles"]) and set(a["smiles"]) <= set(hold[:64])


# ---------------------------------------------------------------- optimizer


def test_learning_rate_schedule_and_warmup_equal_coati_tpu():
    mine, ref = tconfig.TrainConfig(lr=3e-4, n_epochs=7), jconfig.TrainConfig(lr=3e-4, n_epochs=7)
    for epoch in range(8):
        assert ttrain.cosine_lr(mine, epoch) == jtrain.cosine_lr(ref, epoch)
    assert ttrain.cosine_lr(mine, 0) == 3e-4 and abs(ttrain.cosine_lr(mine, 7)) < 1e-19
    model = torch.nn.Linear(3, 2)
    optimizer = ttrain.make_optimizer(mine, model)
    opt_state = jtrain.make_optimizer(ref).init({"w": jnp.zeros((3, 2))})
    for step in range(4):  # the linear warm-up of the epoch loop
        lr = ttrain.cosine_lr(mine, 2) * (step + 1) / 4
        ttrain.set_learning_rate(optimizer, lr)
        opt_state = jtrain.set_learning_rate(opt_state, lr)
        assert optimizer.param_groups[0]["lr"] == pytest.approx(
            float(opt_state[1].hyperparams["learning_rate"]), rel=1e-7)
    group = optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.99), 1e-8, 0.1)
    assert len(optimizer.param_groups) == 1 and len(group["params"]) == 2  # decay on biases too


@pytest.mark.parametrize("clip", [0.5, 50.0], ids=["clipped", "below_the_clip"])
def test_global_norm_clip_and_adamw_step_equal_optax(clip):
    """clip / max(norm, clip) as optax.clip_by_global_norm, not torch's
    clip / (norm + 1e-6); then one AdamW step, in which a parameter without
    a gradient still decays."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "unused": rng.normal(size=(3,)).astype(np.float32)}
    grads = {"a": rng.normal(size=(5, 4)).astype(np.float32),
             "b": rng.normal(size=(7,)).astype(np.float32),
             "unused": np.zeros((3,), np.float32)}
    config = tconfig.TrainConfig(lr=1e-2, clip_grad=clip)
    jopt = jtrain.make_optimizer(jconfig.TrainConfig(lr=1e-2, clip_grad=clip))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    updates, _ = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jopt.init(jparams),
                             jparams)
    ref = optax.apply_updates(jparams, updates)
    clipped, _ = optax.clip_by_global_norm(clip).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.tensor(v))
                                     for k, v in params.items()})
    optimizer = ttrain.make_optimizer(config, module)
    for k in ("a", "b"):
        module[k].grad = torch.tensor(grads[k])
    norm = optimizer.clip_gradients()
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g**2).sum() for g in grads.values())),
                               rtol=1e-6)
    for k in ("a", "b"):
        np.testing.assert_allclose(module[k].grad.numpy(), np.asarray(clipped[k]), rtol=1e-6)
        module[k].grad = torch.tensor(grads[k])
    optimizer.step()
    for k in params:
        np.testing.assert_allclose(module[k].detach().numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.array_equal(module["unused"].detach().numpy(), params["unused"])


# --------------------------------------------------------------- train steps

LR = 1e-3


def _step_pair(seed, dtype="float32", clip_grad=1.0):
    """A 2-layer, 64-wide model with a 1-layer EGNN in both packages, and
    both trainers' steps over it."""
    tok = hp.tokenizer(32)
    jparams, jcfg, model, tcfg = hp.model_pair(
        seed=seed, n_hidden_xformer=64, n_embd_common=64, n_head=4, remat=True)
    kwargs = dict(stop_token=tok.stop_token, unk_token=tok.unk_token, p_clip_emb_smi=0.5,
                  token_entropy_unit=float(np.log2(tok.n_token)), do_clip=True)
    jopt = jtrain.make_optimizer(jconfig.TrainConfig(lr=LR, clip_grad=clip_grad))
    jstep = jtrain.make_train_step(None, jcfg, jopt, mode="pjit", **kwargs)
    jeval = jtrain.make_train_step(None, jcfg, jopt, mode="pjit", is_training=False, **kwargs)
    tcfg = tcfg.replace(dtype=dtype)
    optimizer = ttrain.make_optimizer(tconfig.TrainConfig(lr=LR, clip_grad=clip_grad), model)
    tstep = ttrain.make_train_step(model, tcfg, optimizer, **kwargs)
    teval = ttrain.make_train_step(model, tcfg, optimizer, is_training=False, **kwargs)
    return tok, jparams, jopt, jstep, jeval, model, tstep, teval


def _batches(tok, n):
    return [hp.batch_arrays(tok, SMILES[i:] + SMILES[:i], seed=60 + i, width=24) for i in range(n)]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_one_and_three_train_steps_track_coati_tpu():
    """Same weights, batches and clip-token choices through both trainers,
    float32. Each step's loss, ar_loss and clip_loss agree within 1e-5
    relative. The parameters after step 1 and step 3 agree within 3 * lr
    everywhere, and 99.9% of them within 1e-3 * lr: Adam's first steps
    divide a gradient by about its own size plus 1e-8, so an element whose
    gradient is near 1e-8 turns a last-bit difference into a different step
    of up to lr, while every other element moves by lr times a ratio that
    agrees to about 1e-5. The gradients themselves are held tightly in
    tests/test_torch_coati.py."""
    tok, jparams, jopt, jstep, jeval, model, tstep, teval = _step_pair(seed=70)
    opt_state = jopt.init(jparams)
    key = jax.random.PRNGKey(71)
    for i, batch in enumerate(_batches(tok, 3)):
        key, sub = jax.random.split(key)
        pick = torch.tensor(np.asarray(jax.random.uniform(sub, (len(SMILES), 1)) > 0.5))
        jparams, opt_state, ref = jstep(jparams, opt_state, sub, hp.jax_batch(batch))
        mine = tstep(None, hp.torch_batch(batch), pick_point=pick)
        for name in ("loss", "ar_loss", "clip_loss"):
            assert mine[name].dtype == torch.float32 and not mine[name].requires_grad
            np.testing.assert_allclose(float(mine[name]), float(ref[name]), rtol=1e-5,
                                       err_msg=f"step {i} {name}")
        if i in (0, 2):
            want = state_from_coati_tpu(params_to_state(jparams))
            diffs = torch.cat([(p.detach() - want[n]).abs().flatten()
                               for n, p in model.named_parameters()])
            assert float(diffs.max()) <= 3 * LR, f"step {i}"
            assert float((diffs <= 1e-3 * LR).float().mean()) >= 0.999, f"step {i}"
        assert all(p.grad is None for p in model.parameters())  # dropped after the update


def test_eval_step_changes_nothing_and_gives_coati_tpu_s_metrics():
    tok, jparams, jopt, _, jeval, model, tstep, teval = _step_pair(seed=72)
    batch = _batches(tok, 1)[0]
    key = jax.random.PRNGKey(73)
    pick = torch.tensor(np.asarray(jax.random.uniform(key, (len(SMILES), 1)) > 0.5))
    tstep(None, hp.torch_batch(batch), pick_point=pick)  # so that the optimizer has state
    jparams = None  # the weights moved: compare the evaluation on the port's own
    before = _state(model)
    moments = [s["exp_avg"].clone() for s in tstep.optimizer.state.values()]
    steps = [int(s["step"]) for s in tstep.optimizer.state.values()]
    mine = teval(None, hp.torch_batch(batch), pick_point=pick)
    after = _state(model)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(a, s["exp_avg"]) for a, s in zip(moments, tstep.optimizer.state.values()))
    assert steps == [int(s["step"]) for s in tstep.optimizer.state.values()]
    assert all(p.grad is None for p in model.parameters())
    again = teval(None, hp.torch_batch(batch), pick_point=pick)
    assert float(mine["loss"]) == float(again["loss"])
    # and against coati_tpu's evaluation step from the same weights
    tok, jparams, jopt, _, jeval, model, _, teval = _step_pair(seed=74)
    _, _, ref = jeval(jparams, jopt.init(jparams), key, hp.jax_batch(batch))
    mine = teval(None, hp.torch_batch(batch), pick_point=pick)
    for name in ("loss", "ar_loss", "clip_loss"):
        np.testing.assert_allclose(float(mine[name]), float(ref[name]), rtol=1e-5)


def test_bf16_step_keeps_float32_masters_gradients_and_moments():
    """bf16 compute: the loss is float32 and within 2e-2 relative of the
    float32 step's, every master parameter the loss reaches gets a float32
    gradient, and the update leaves float32 parameters and moments."""
    tok, _, _, _, _, model, tstep32, _ = _step_pair(seed=75)
    batch = hp.torch_batch(_batches(tok, 1)[0])
    pick = torch.tensor(np.random.default_rng(76).uniform(size=(len(SMILES), 1)) > 0.5)
    full, _, _ = tstep32.losses(None, batch, pick_point=pick)
    _, _, _, _, _, model, tstep, _ = _step_pair(seed=75, dtype="bfloat16")
    assert tstep.model_cfg.xformer_config.compute_dtype == torch.bfloat16
    loss, ar, cl = tstep.losses(None, batch, pick_point=pick)
    assert loss.dtype == ar.dtype == cl.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(full.detach()), rtol=2e-2)
    loss.backward()
    before = _state(model)
    for name, p in model.named_parameters():
        if ".coord_mlp." in name:
            assert p.grad is None
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32 and p.grad.any(), name
    tstep.update()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and not torch.equal(p.detach(), before[name]), name
    for state in tstep.optimizer.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32


# --------------------------------------------------------------- small tools


def test_deferred_metrics_reads_one_step_late_unless_told_to_wait(monkeypatch):
    seen = []
    monkeypatch.delenv("TRAIN_SYNC_METRICS", raising=False)
    dm = ttrain.DeferredMetrics(lambda *a: seen.append(a))
    dm.push(0, {"loss": 1.0}, 8)
    assert seen == [] and not dm.sync
    dm.drain()
    dm.drain()
    assert seen == [(0, {"loss": 1.0}, 8)]
    monkeypatch.setenv("TRAIN_SYNC_METRICS", "1")
    dm = ttrain.DeferredMetrics(lambda *a: seen.append(a))
    dm.push(1, {"loss": 2.0}, 4)
    assert dm.sync and seen[-1] == (1, {"loss": 2.0}, 4)


def test_epoch_metrics_processor_logs_and_totals(tmp_path):
    config = tconfig.TrainConfig(log_batch_loss=2, log_interval=1000)
    logger = COATILogger("m", str(tmp_path / "out"), str(tmp_path / "models"), config.as_dict())
    logger.start()
    offline = {"batch_losses": [], "ar_losses": [], "clip_losses": []}
    totals, arr = {"loss": 0.0, "count": 0}, []
    process = ttrain.make_epoch_metrics_processor(
        config=config, logger=logger, offline_losses=offline, partition="train", epoch=0,
        totals=totals, get_counters=lambda: (100, 8, 0.0), loss_arr=arr)
    for j in range(3):
        process(j, {"loss": torch.tensor(2.0 + j), "ar_loss": torch.tensor(1.0),
                    "clip_loss": torch.tensor(0.5)}, 4)
    logger.stop()
    assert totals == {"loss": 4 * (2.0 + 3.0 + 4.0), "count": 12}
    assert arr == [(2.0, 1.0, 0.5), (3.0, 1.0, 0.5), (4.0, 1.0, 0.5)]
    assert [len(v) for v in offline.values()] == [2, 2, 2]  # steps 0 and 2
    assert open(logger.log_file).read().count('"key": "train_batch_loss"') == 2


def test_step_timer_finite_check_and_flops():
    timer = step_timer()
    for _ in range(3):
        with timer:
            pass
    stats = timer.emit()
    assert len(timer.times) == 3 and stats and all(np.isfinite(v) for v in stats.values())
    model = torch.nn.Linear(3, 2)
    finite_check(model, "model")
    finite_check({"a": torch.ones(2), "n": torch.tensor([1, 2])})
    with torch.no_grad():
        model.bias[1] = float("nan")
    with pytest.raises(FloatingPointError, match="bias"):
        finite_check(model, "model")
    kw = dict(n_layer_xformer=16, n_hidden_xformer=256, n_layer_e3gnn=5, n_hidden_e3nn=256,
              n_tok=13603, batch=160, seq=80, natoms=96)
    assert tflops.coati_train_step_model_flops(**kw) == jflops.coati_train_step_model_flops(**kw)
    assert tflops.transformer_pass_flops(16, 256, 160, 80) == jflops.transformer_pass_flops(
        16, 256, 160, 80)
    assert tflops.egnn_pass_flops(5, 256, 160, 96) == jflops.egnn_pass_flops(5, 256, 160, 96)


# ------------------------------------------------------------- end to end


class TinySyntheticDataset:
    """Own copy of the dataset of tests/test_train_loop.py, over the port's
    batch_rows."""

    summary = {"dataset_type": "synthetic-test"}

    def get_data_pipe(self, batch_size=8, partition="train", required_fields=(),
                      xform_routine=lambda x: x, **kw):
        rng = np.random.default_rng(0)
        frags = ["C", "CC", "CCO", "CCN", "CCC"]

        def rows():
            for i in range(batch_size * 4):
                smi = frags[i % len(frags)]
                n = max(1, len(smi))
                yield {
                    "smiles": smi,
                    "source_collection": "geom_drugs",
                    "atoms": rng.integers(1, 9, size=(n,)).astype(np.float64),
                    "coords": rng.normal(size=(n, 3)),
                }

        return batch_rows(rows(), batch_size=batch_size, partition="raw",
                          xform_routine=xform_routine, required_fields=["smiles"])


def _tiny_config(tmp_path, **kw):
    config = tconfig.TrainConfig(
        n_layer_e3gnn=1, n_hidden_e3nn=16, n_hidden_xformer=16, n_embd_common=16,
        n_layer_xformer=1, n_head=2, n_seq=24, max_n_seq=24, tokenizer_vocab="mar_verysimple",
        batch_size=2, n_epochs=1, lr=1e-3, norm_clips=True, token_mlp=True,
        output_dir=str(tmp_path / "out"), model_dir=str(tmp_path / "models"),
        p_dataset=0.0, p_formula=0.0, p_fim=0.0, p_graph=0.0, p_clip=0.5, p_randsmiles=0.0,
        log_batch_loss=1, ngrad_to_save=1e9,
    )
    for k, v in kw.items():
        setattr(config, k, v)
    return config


def test_train_autoencoder_end_to_end_and_both_packages_read_its_document(tmp_path):
    config = _tiny_config(tmp_path)
    logger = COATILogger(model_name="e3gnn_smiles_clip_e2e", output_path=config.output_dir,
                         model_path=config.model_dir, args=config.as_dict())
    logger.start()
    model, results = ttrain.train_autoencoder(
        config, TinySyntheticDataset(), device="cpu", logger=logger, max_steps_per_epoch=4)
    logger.stop()
    assert len(results["history"]) == 4 == len(results["train_step_seconds"])
    assert all(np.isfinite(h[3:]).all() for h in results["history"])
    params_json = os.path.join(config.output_dir, config.exp_name, config.run_name, "params.json")
    assert json.load(open(params_json))["n_layer_xformer"] == 1

    docs = sorted(glob.glob(os.path.join(config.model_dir, "*")))
    assert docs, "no checkpoint written"
    doc = load_model_doc(docs[-1])
    assert doc["train_args"]["tokenizer_vocab"] == "mar_verysimple"
    assert doc["model_kwargs"]["n_layer_xformer"] == 1 and doc["model_kwargs"]["n_seq"] == 24
    assert doc["n_grads_processed"] == 8 and doc["n_toks_processed"] > 0
    assert doc["offline_loss"]["batch_losses"] and doc["optimizer"]["state"]
    # the flat reference state dict: dotted keys, numpy arrays
    assert all("." in k and isinstance(v, np.ndarray) for k, v in doc["model"].items())
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(doc["model"][name], p.detach().numpy())

    # both packages' loaders read it and embed a SMILES to the same vector
    mine, tok = load_e3gnn_smiles_clip_e2e(docs[-1], device="cpu")
    theirs, jtok = jax_load(docs[-1])
    assert mine.embed_dim == theirs.embed_dim == 16
    text = "[SMILES]CCO[STOP]"
    tokens = np.asarray([tok.tokenize_text(text, pad=True)])
    assert tokens.tolist() == [jtok.tokenize_text(text, pad=True)]
    np.testing.assert_allclose(mine.encode_tokens(tokens, tok).numpy(),
                               np.asarray(theirs.encode_tokens(tokens, jtok)), atol=3e-5)

    # resume with no training step returns the document's weights
    resumed, _ = ttrain.train_autoencoder(
        _tiny_config(tmp_path, resume_document=docs[-1], resume_optimizer=True, n_epochs=0),
        TinySyntheticDataset(), device="cpu")
    for name, p in resumed.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), doc["model"][name])
    # the optimizer's moments are carried on, and training goes on from them
    again, more = ttrain.train_autoencoder(
        _tiny_config(tmp_path, resume_document=docs[-1], resume_optimizer=True),
        TinySyntheticDataset(), device="cpu", max_steps_per_epoch=2)
    assert len(more["history"]) == 2
    assert any(not np.array_equal(p.detach().numpy(), doc["model"][n])
               for n, p in again.named_parameters())
    # transformer-only resume: the trunk is the document's, the rest is fresh
    partial, _ = ttrain.train_autoencoder(
        _tiny_config(tmp_path, resume_document=docs[-1], load_transformer_only=True, n_epochs=0),
        TinySyntheticDataset(), device="cpu", seed=5)
    state = dict(partial.named_parameters())
    np.testing.assert_array_equal(state["xformer.lm_head.weight"].detach().numpy(),
                                  doc["model"]["xformer.lm_head.weight"])
    assert not np.array_equal(state["point_encoder.node_dec.0.weight"].detach().numpy(),
                              doc["model"]["point_encoder.node_dec.0.weight"])


def test_train_autoencoder_resumes_from_a_coati_tpu_document(tmp_path):
    """A document the JAX package wrote (nested parameters, optax state)
    resumes too: the weights load, and its optimizer state, which is not
    this trainer's, is left alone."""
    from coati_tpu.models.io import serialize_model as jax_serialize

    tok = TrieTokenizer(n_seq=24, **get_vocab("mar_verysimple"))
    config = _tiny_config(tmp_path)
    kwargs = dict(n_layer_e3gnn=1, n_layer_xformer=1, n_hidden_xformer=16, n_hidden_e3nn=16,
                  n_embd_common=16, n_head=2, n_seq=24, n_tok=tok.n_token, norm_clips=True,
                  token_mlp=True)
    jparams, _, _, _ = hp.model_pair(seed=80, **kwargs)
    path = tmp_path / "jax_doc.pkl"
    path.write_bytes(jax_serialize(
        train_args=config.as_dict(), dataset_summary={}, model_state=params_to_state(jparams),
        model_kwargs=kwargs, optimizer_state={"not": "ours"}))
    resumed, _ = ttrain.train_autoencoder(
        _tiny_config(tmp_path, resume_document=str(path), resume_optimizer=True, n_epochs=0),
        TinySyntheticDataset(), device="cpu")
    want = state_from_coati_tpu(params_to_state(jparams))
    for name, p in resumed.named_parameters():
        assert torch.equal(p.detach(), want[name]), name


class FixtureRowsDataset:
    """Fixture molecules as training rows, each SMILES written in another
    atom order, so that the transform's canonicalization has work to do;
    the atoms and coordinates are the fixture's. The same batches for either
    package's trainer."""

    summary = {"dataset_type": "fixture-rows-test"}

    def __init__(self, rows):
        from coati_tpu_torch.chem.selfies_lite import permute_smiles

        smiles, atoms, coords = load_points_fixture()
        rng = random.Random(4)
        self.rows = []
        for i in range(rows):
            n = int((atoms[i] > 0).sum())
            self.rows.append({"smiles": permute_smiles(smiles[i], rng),
                              "source_collection": "chembl_mols",
                              "atoms": atoms[i][:n].astype(np.int32), "coords": coords[i][:n]})

    def get_data_pipe(self, batch_size=8, partition="train", required_fields=(),
                      xform_routine=lambda x: x, **kw):
        rows = [dict(r) for r in self.rows]
        return batch_rows(rows, batch_size=batch_size, partition="raw",
                          xform_routine=xform_routine, required_fields=["smiles"])


@pytest.mark.parametrize("steps", [1, 3])
def test_train_autoencoder_runs_the_grande_recipe_as_coati_tpu_does(tmp_path, steps):
    """Both packages' train_autoencoder from one document, on the same rows
    (other writings than the canonical ones), with the grande recipe's
    transform: every row canonicalized, 30% of the targets permuted through
    the global random module, seeded alike before each run, CLIP prefixes
    with cuts. The clip-token choice draws from each package's own generator,
    so p_clip_emb_smi is 1 (always the SMILES embedding). Each step's loss,
    ar_loss and clip_loss agree within atol 3e-5, rtol 1e-4, the token
    counts are equal (the same batches), and the weights after the last step
    agree as in test_one_and_three_train_steps_track_coati_tpu."""
    from coati_tpu.models.io import serialize_model as jax_serialize
    from coati_tpu.parallel.mesh import make_mesh
    from coati_tpu.training.logger import COATILogger as JaxLogger

    grande = tconfig.grande_config()
    recipe = {k: getattr(grande, k) for k in (
        "p_dataset", "p_formula", "p_fim", "p_graph", "p_clip", "p_clip_cut", "p_randsmiles",
        "tokenizer_vocab", "n_seq")}
    assert recipe["p_randsmiles"] == 0.3 and recipe["tokenizer_vocab"] == "mar"
    tok = TrieTokenizer(n_seq=80, **get_vocab("mar"))
    kwargs = dict(n_layer_e3gnn=1, n_layer_xformer=1, n_hidden_xformer=16, n_hidden_e3nn=16,
                  n_embd_common=16, n_head=2, n_seq=80, n_tok=tok.n_token, norm_clips=True,
                  token_mlp=True)
    jparams, _, _, _ = hp.model_pair(seed=81, **kwargs)
    path = tmp_path / "start.pkl"
    path.write_bytes(jax_serialize(
        train_args={}, dataset_summary={}, model_state=params_to_state(jparams),
        model_kwargs=kwargs))
    data = FixtureRowsDataset(8 * steps)
    docs = {}
    for name, config_cls, logger_cls in (("mine", tconfig.TrainConfig, COATILogger),
                                         ("ref", jconfig.TrainConfig, JaxLogger)):
        config = config_cls(**dataclasses.asdict(_tiny_config(tmp_path / name)))
        for k, v in recipe.items():
            setattr(config, k, v)
        config.max_n_seq, config.p_clip_emb_smi, config.batch_size = 80, 1.0, 8
        config.resume_document = str(path)
        logger = logger_cls(model_name="e3gnn_smiles_clip_e2e", output_path=config.output_dir,
                            model_path=config.model_dir, args=config.as_dict())
        logger.start()
        random.seed(7)
        if name == "mine":
            model, _ = ttrain.train_autoencoder(config, data, device="cpu", logger=logger,
                                                max_steps_per_epoch=steps)
        else:
            out, _ = jtrain.train_autoencoder(config, data, mesh=make_mesh(1), logger=logger,
                                              max_steps_per_epoch=steps)
        docs[name] = load_model_doc(sorted(glob.glob(os.path.join(config.model_dir, "*")))[-1])
        logger.stop()
    mine, ref = docs["mine"], docs["ref"]
    assert mine["n_toks_processed"] == ref["n_toks_processed"] > 0
    assert mine["n_grads_processed"] == ref["n_grads_processed"] == 8 * steps
    for key in ("batch_losses", "ar_losses", "clip_losses"):
        got, want = ([(e["step"], e["tag_n_toks"], e["value"]) for e in doc["offline_loss"][key]]
                     for doc in (mine, ref))
        assert len(got) == steps and [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                                   atol=hp.ATOL, rtol=hp.RTOL, err_msg=key)
    want = state_from_coati_tpu(params_to_state(out))
    diffs = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in model.named_parameters()])
    lr = mine["train_args"]["lr"]
    assert float(diffs.max()) <= 3 * lr
    assert float((diffs <= 1e-3 * lr).float().mean()) >= 0.999
