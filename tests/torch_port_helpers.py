"""Shared pieces of the tests that hold coati_tpu_torch's gradients and
training against coati_tpu on the CPU: one small random COATI in both
packages with the same weights, the map from a JAX gradient pytree to the
port's parameter names, the comparison of the two, and the reader of a
restart-checkpoint directory, and the pieces that make both packages'
COATI2 trainers repeatable and observable within a test."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from coati_tpu.data import xform_coati2 as j_x2
from coati_tpu.models import coati as jco
from coati_tpu.models.io import params_to_state

from coati_tpu_torch.data import xform_coati2 as t_x2
from coati_tpu_torch.models import coati as tco
from coati_tpu_torch.models.convert import gradients_from_coati_tpu, state_from_coati_tpu
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

ATOL, RTOL = 3e-5, 1e-4


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's intra-op threads set to 1 for a module's tests, then restored.
    These tests run many small ops; under the test runner's parallel
    workers every worker's thread pool oversubscribes the cores, and each
    op then waits on threads the scheduler has parked (six such files took
    473 s with 6 workers against 150 s with one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def close(mine, ref, atol=ATOL, rtol=RTOL):
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    np.testing.assert_allclose(mine, np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def tokenizer(n_seq=32):
    return TrieTokenizer(n_seq=n_seq, **get_vocab("mar_verysimple"))


def model_pair(seed=0, n_seq=32, n_tok=None, **kw):
    """(jax params, jax config, port model, port config): a 2-layer, 32-wide
    transformer and a 1-layer, 16-wide EGNN unless `kw` says otherwise, the
    same weights on both sides, the port's requiring grad. The JAX side runs
    at precision "highest" with its plain attention and a float32 softmax,
    which is what the port's kernels compute."""
    kwargs = dict(
        n_layer_e3gnn=1, n_layer_xformer=2, n_hidden_xformer=32, n_hidden_e3nn=16,
        n_embd_common=32, n_head=2, n_seq=n_seq,
        n_tok=n_tok or tokenizer(n_seq).n_token, norm_clips=True, token_mlp=True,
    )
    kwargs.update(kw)
    jkw = dict(kwargs)
    jkw["prefill_kernel"] = "xla"
    jcfg = jco.CoatiConfig(precision="highest", softmax_dtype="float32", **jkw)
    jparams = jco.init_coati(jax.random.PRNGKey(seed), jcfg)
    tcfg = tco.CoatiConfig(**kwargs)
    model = tco.CoatiModel(tcfg)
    model.load_state_dict(state_from_coati_tpu(params_to_state(jparams)), strict=True)
    return jparams, jcfg, model, tcfg


def jax_gradients_by_name(jgrads):
    """A JAX gradient pytree (the structure of the parameters) under the
    port's parameter names and layouts, as numpy."""
    return {k: v.numpy() for k, v in gradients_from_coati_tpu(params_to_state(jgrads)).items()}


def assert_gradients_match(named_parameters, jgrads, atol=ATOL, rtol=RTOL, unused=()):
    """Every port parameter's .grad against the JAX gradient of the same
    name. A parameter no loss reaches (names that contain one of `unused`)
    has no .grad in PyTorch and a zero gradient in JAX."""
    ref = jax_gradients_by_name(jgrads)
    compared = 0
    for name, p in named_parameters:
        assert name in ref, name
        if p.grad is None:
            assert any(u in name for u in unused), f"{name} got no gradient"
            assert not ref[name].any(), f"{name}: JAX has a gradient, the port none"
            continue
        assert p.grad.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=atol, rtol=rtol, err_msg=name)
        compared += 1
    assert compared > 0
    return compared


def batch_arrays(tok, smiles, n_atoms=9, seed=0, width=None):
    """A training batch as numpy: raw_tokens ([SMILES]...[STOP]), tokens
    ([CLIP][UNK][SMILES]...[STOP]), y_next with the special tokens masked,
    ragged atoms and coordinates."""
    rng = np.random.default_rng(seed)
    raw = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    aug = [tok.tokenize_text("[CLIP][UNK][SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    width = width or max(len(r) for r in aug)

    def stack(rows):
        out = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    tokens, raw_tokens = stack(aug), stack(raw)
    y_next = np.zeros_like(tokens)
    y_next[:, :-1] = tokens[:, 1:]
    for special in (tok.clip_token, tok.pad_token, tok.unk_token):
        y_next[y_next == special] = -1
    counts = rng.integers(2, n_atoms + 1, size=len(smiles))
    counts[0] = n_atoms
    atoms = rng.choice([1, 6, 7, 8, 9], size=(len(smiles), n_atoms))
    atoms *= np.arange(n_atoms)[None, :] < counts[:, None]
    coords = rng.normal(scale=2.0, size=(len(smiles), n_atoms, 3)).astype(np.float32)
    return {"raw_tokens": raw_tokens, "tokens": tokens, "y_next": y_next,
            "atoms": atoms.astype(np.int32), "coords": coords}


def torch_batch(batch):
    out = {k: t(batch[k], torch.long) for k in ("raw_tokens", "tokens", "y_next", "atoms")}
    out["coords"] = t(batch["coords"])
    return out


def jax_batch(batch):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in batch.items()}


def restart_states(directory):
    """{step: saved payload} of a restart-checkpoint directory, and the pieces that make both packages'
COATI2 trainers repeatable and observable within a test."""
    return {int(p.stem): torch.load(p, weights_only=True) for p in Path(directory).glob("*.pt")}


def assert_same_state(a, b):
    """Equal nests, every tensor equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_state(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_state(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def fixed_property_draw_order(monkeypatch):
    """Both packages' coati2_ar_xform draw p_prop_each for each property
    while iterating `set(PROPERTY_BUCKETS)`, whose order follows the string
    hashes of this process (PYTHONHASHSEED): the same seeded `random` then
    includes other properties in every process, and a test's batches change
    from run to run. This makes both modules' `set` keep the insertion
    order of PROPERTY_BUCKETS, so the draws, and the batches, are the same
    in every process."""
    for module in (j_x2, t_x2):
        monkeypatch.setattr(module, "set", dict.fromkeys, raising=False)


def capture_coati2_gradients(monkeypatch, port_trainer, jax_trainer):
    """Makes both packages' COATI2 trainers keep, at every step, the
    gradients the optimizer receives (before the clip and the update).
    Returns (port, jax): lists, a dict per step, the JAX side's keyed as
    the parameters' pytree and carried to the port's names by the caller."""
    import optax

    port, ref = [], []
    make_port, make_jax = port_trainer.make_optimizer, jax_trainer.make_optimizer

    def port_optimizer(config, model, grad_norm=None):
        optimizer = make_port(config, model, grad_norm)
        names = {id(p): n for n, p in model.named_parameters()}
        step = optimizer.step

        def step_keeping_grads(*args, **kwargs):
            port.append({names[id(p)]: (p.grad.detach().clone() if p.grad is not None
                                        else torch.zeros_like(p))  # a zero gradient, as optax
                         for g in optimizer.param_groups for p in g["params"]})
            return step(*args, **kwargs)

        optimizer.step = step_keeping_grads
        return optimizer

    def jax_optimizer(config):
        optimizer = make_jax(config)

        def update(grads, state, params=None):
            jax.debug.callback(
                lambda g: ref.append(jax.tree_util.tree_map(np.asarray, g)), grads)
            return optimizer.update(grads, state, params)

        return optax.GradientTransformation(optimizer.init, update)

    monkeypatch.setattr(port_trainer, "make_optimizer", port_optimizer)
    monkeypatch.setattr(jax_trainer, "make_optimizer", jax_optimizer)
    return port, ref
