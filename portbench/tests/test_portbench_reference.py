"""The plain reference against the program's own float32 CPU path, at a
small size: tokens, embeddings, decode logits, the point encoder and a
training step's loss and gradients."""

import numpy as np
import pytest
import torch

from small import TINY

from portbench import infer
from portbench.reference import model, weights
from portbench.reference.egnn import encode_points as ref_points
from portbench.reference.tokenizer import Vocabulary
from portbench.reference.train import train_steps

COATI = dict(TINY, family="coati", vocab="mar", n_tok=13603, biases=True, torch_emb=False,
             norm_clips=True, norm_embed=False, token_mlp=True, egnn_cutoff=5.0)
COATI2 = dict(TINY, family="coati2", vocab="coati2_12_12", n_tok=4266, biases=True,
              enc_to_coati="swiglu_resnet", n_direct_clr=16)


@pytest.fixture(scope="module")
def corpus():
    return infer.load_corpus("corpora/chembl_synth_v1.smi.gz")[::997][:120]


def _port(cfg):
    from coati_tpu_torch.models.io import load_coati2, load_e3gnn_smiles_clip_e2e

    tree = weights.seeded(cfg, 5, "cpu")
    doc = weights.document(tree, cfg)
    loader = load_coati2 if cfg["family"] == "coati2" else load_e3gnn_smiles_clip_e2e
    m, tok = loader(doc, device="cpu")
    return tree, m, tok


@pytest.mark.parametrize("vocab", ["mar", "coati2_12_12"])
def test_tokens_match_the_programs_tokenizer(vocab, corpus):
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    tok = TrieTokenizer(n_seq=250, **get_vocab(vocab))
    ref = Vocabulary(vocab)
    for s in corpus:
        text = "[CLIP][UNK][SMILES]" + s + "[STOP]"
        assert ref.encode(text) == tok.tokenize_text(text, pad=False)


@pytest.mark.parametrize("cfg", [COATI, COATI2], ids=["coati", "coati2"])
def test_embeddings_and_decode_logits_match(cfg, corpus):
    from coati_tpu_torch.models.transformer import forward_logits

    tree, m, tok = _port(cfg)
    smiles = [s for s in corpus if len(s) < 60][:6]
    rows = infer.token_rows(tok, smiles)
    got = m.encode_tokens(rows, tok).float()
    vocab = Vocabulary(cfg["vocab"])
    src = torch.as_tensor(vocab.smiles_rows(smiles, cfg["n_seq"]))
    assert torch.equal(src, torch.as_tensor(rows, dtype=torch.long))
    ref = model.embed(tree, cfg, src, vocab.stop)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    prefix = tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False)
    dec = torch.as_tensor(np.asarray([prefix + list(r[1:20]) for r in rows]))
    inj = m._to_token(got)
    got_logits = forward_logits(m.params.xformer, m.config.xformer_config, dec, inj, tok.unk_token)
    ref_logits = model.decode_logits(tree, cfg, ref, dec, vocab.unk, len(prefix))
    torch.testing.assert_close(got_logits, ref_logits, atol=5e-5, rtol=1e-4)


def _fixture_batch(n=6):
    from coati_tpu_torch.data import load_points_fixture

    _, atoms, coords = load_points_fixture()
    return torch.as_tensor(atoms[:n].astype(np.int64)), torch.as_tensor(coords[:n])


def test_point_encoder_matches():
    tree, m, _ = _port(COATI)
    atoms, coords = _fixture_batch()
    got = m.encode_points(atoms.numpy(), coords.numpy()).float()
    ref = model.clip_projection(tree["point_to_clip"], ref_points(tree["point_encoder"], atoms,
                                                                 coords, 5.0))
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)


def test_training_step_loss_and_gradients_match():
    from coati_tpu_torch.training import train
    from coati_tpu_torch.training.config import grande_config

    cfg = dict(COATI, stop_token=1, unk_token=7)
    tree, m, tok = _port(COATI)
    config = grande_config(dtype="float32", batch_size=6, **{k: TINY[k] for k in (
        "n_layer_xformer", "n_hidden_xformer", "n_head", "n_layer_e3gnn", "n_hidden_e3nn",
        "n_embd_common")})
    atoms, coords = _fixture_batch()
    vocab = Vocabulary("mar")
    rows = torch.as_tensor(vocab.smiles_rows(["CCO", "c1ccccc1", "CC(=O)N", "CCN", "O=C=O",
                                              "CCCCl"], 16))
    tokens = torch.cat([torch.tensor([[vocab.clip, vocab.unk]] * 6), rows[:, :14]], 1)
    y = torch.zeros_like(tokens)
    y[:, :-1] = tokens[:, 1:]
    y[(y == vocab.pad) | (y == vocab.clip) | (y == vocab.unk)] = -1
    batch = {"raw_tokens": rows, "tokens": tokens, "y_next": y, "atoms": atoms, "coords": coords}
    pick = torch.tensor([[True], [False], [True], [False], [True], [True]])
    model_cfg = train.model_config_from_train_config(config, tok.n_token)
    step = train.make_train_step(m.params.requires_grad_(True), model_cfg,
                                 train.make_optimizer(config, m.params),
                                 stop_token=tok.stop_token, unk_token=tok.unk_token,
                                 p_clip_emb_smi=config.p_clip_emb_smi,
                                 token_entropy_unit=float(np.log2(tok.n_token)), do_clip=True)
    loss, _, _ = step.losses(None, batch, pick_point=pick)
    loss.backward()
    opt = {"lr": 0.0, "weight_decay": 0.0, "clip_grad": 1e9, "betas": (0.9, 0.99), "eps": 1e-8}
    ref = train_steps(tree, cfg, opt, [batch], [pick])
    assert float(loss.detach()) == pytest.approx(ref["losses"][0][0], rel=1e-5)
    ref_grad = weights.port_leaves(ref["first_grad"])
    for name, p in m.params.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        r = ref_grad[name]
        r = r if r.dim() < 2 or name.endswith("tok_emb.weight") else r.t()  # (in, out) layout
        torch.testing.assert_close(g, r.reshape(g.shape), atol=2e-5, rtol=1e-3, msg=name)


def test_the_programs_parameters_read_back_into_the_seeded_weights():
    # the window step's check starts from the program's own state, read
    # through from_port: the trainer's parameters before its first step
    # are the seeded document it resumed from, leaf for leaf
    from small import context

    from portbench import harness

    ctx = context("coati.train.grande")
    drv = harness.driver("train")
    state = drv.setup(ctx)
    drv.window(ctx, state)
    named = {state.names[i]: p for i, p in state.hooks.before.items()}
    got = weights.port_leaves(weights.from_port(named, ctx.cfg))
    want = weights.port_leaves(weights.seeded(ctx.cfg, ctx.seed, ctx.device))
    assert set(got) == set(want) == set(named)
    assert all(torch.equal(got[k], want[k]) for k in want)
