"""coati_tpu_torch's LoRA fine-tuning against coati_tpu's on the CPU: a
fresh adapter merges to the base bit for bit, an unknown target is refused,
one and three AR steps from adapters carried across (B made nonzero) give
coati_tpu's loss and adapters, the base trunk gets no gradient and does not
move, and a merged model's document reloads to the merged model's
encodings.

A 2-layer, 32-wide trunk with the same weights on both sides, float32, JAX
at precision "highest". Tolerance atol 3e-5, rtol 1e-4 unless a line says
why."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coati_tpu.models import transformer as jtr
from coati_tpu.models.io import params_to_state
from coati_tpu.training import finetune as jft

from coati_tpu_torch.models import transformer as ttr
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.convert import lora_from_coati_tpu, transformer_state_from_coati_tpu
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e, model_to_state, serialize_model
from coati_tpu_torch.training import finetune as tft
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, RTOL = 3e-5, 1e-4
N_TOK, N_SEQ = 40, 24


def _pair(seed=0, n_layer=2, n_embd=32):
    jcfg = jtr.TransformerConfig(n_layer=n_layer, n_embd=n_embd, n_head=2, n_seq=N_SEQ,
                                 n_tok=N_TOK, precision="highest", prefill_kernel="xla")
    jparams = jtr.init_transformer(jax.random.PRNGKey(seed), jcfg)
    tcfg = ttr.TransformerConfig(n_layer=n_layer, n_embd=n_embd, n_head=2, n_seq=N_SEQ,
                                 n_tok=N_TOK)
    model = ttr.SmilesTransformer(tcfg)
    model.load_state_dict(transformer_state_from_coati_tpu(params_to_state(jparams)), strict=True)
    return jparams, jcfg, model, tcfg


def _batch(rows=6, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, N_TOK, size=(rows, N_SEQ)).astype(np.int32)
    tokens[:, -1] = 2
    y_next = np.full_like(tokens, -1)
    y_next[:, :-1] = tokens[:, 1:]
    return tokens, y_next


def _carried_lora(jparams, rank=4, seed=3):
    """coati_tpu's fresh adapters with B drawn nonzero (so that A's
    gradient is too), and the same adapters in the port."""
    jlora = jft.init_lora(jax.random.PRNGKey(1), jparams, rank=rank)
    rng = np.random.default_rng(seed)
    jlora = jlora.replace(b={k: jnp.asarray(rng.normal(scale=0.05, size=v.shape), jnp.float32)
                             for k, v in jlora.b.items()})
    return jlora, lora_from_coati_tpu(jlora)


def test_fresh_lora_is_identity_and_shapes_follow_coati_tpu():
    """B = 0: the merged trunk's logits equal the base's bit for bit; A and
    B have coati_tpu's shapes (L, in, r) and (L, r, out) under its names."""
    jparams, _, model, tcfg = _pair()
    lora = tft.init_lora(torch.Generator().manual_seed(0), model, rank=4)
    jlora = jft.init_lora(jax.random.PRNGKey(1), jparams, rank=4)
    assert sorted(lora.a) == sorted(jlora.a) == ["w_attn", "w_fc", "w_out", "w_proj"]
    for name in jlora.a:
        assert tuple(lora.a[name].shape) == jlora.a[name].shape
        assert tuple(lora.b[name].shape) == jlora.b[name].shape
        # A ~ N(0, 1/in): its spread over every layer within 15% of 1/sqrt(in)
        n_in = lora.a[name].shape[1]
        assert abs(float(lora.a[name].detach().std()) * n_in**0.5 - 1) < 0.15
    tokens, _ = _batch()
    toks = torch.tensor(tokens, dtype=torch.long)
    with torch.no_grad():
        base = ttr.forward_logits(model, tcfg, toks)
        merged = ttr.forward_logits(tft.merge_lora(model, lora), tcfg, toks)
    assert torch.equal(base, merged)


def test_unknown_target_rejected():
    _, _, model, _ = _pair()
    with pytest.raises(ValueError, match="LoRA target"):
        tft.init_lora(torch.Generator().manual_seed(0), model, targets=("tok_emb",))


def test_merge_equals_coati_tpu_merge():
    """merge_lora of carried-across adapters: every merged weight equals
    coati_tpu's, transposed into nn.Linear's layout."""
    jparams, _, model, _ = _pair(seed=2)
    jlora, lora = _carried_lora(jparams)
    want = transformer_state_from_coati_tpu(params_to_state(jft.merge_lora(jparams, jlora)))
    got = tft.merge_lora(model, lora).state_dict()
    assert got.keys() == want.keys()
    for key in want:
        hp.close(got[key], want[key].numpy())


@pytest.mark.parametrize("steps", [1, 3])
def test_lora_ar_steps_track_coati_tpu(steps):
    """make_lora_ar_step from the same trunk, adapters and batches against
    coati_tpu's with optax.adam (torch.optim.Adam, the same lr, betas and
    eps): each step's loss and the adapters after the last step. The base
    trunk gets no gradient and does not move."""
    jparams, jcfg, model, tcfg = _pair(seed=4)
    jlora, lora = _carried_lora(jparams)
    lr = 1e-3
    joptim = optax.adam(lr)
    jstate = joptim.init(jlora)
    jstep = jft.make_lora_ar_step(jparams, jcfg, joptim)
    optimizer = torch.optim.Adam(lora.parameters(), lr=lr)
    step = tft.make_lora_ar_step(model, tcfg, optimizer)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(steps):
        tokens, y_next = _batch(seed=10 + i)
        jlora, jstate, jloss = jstep(jlora, jstate, jnp.asarray(tokens), jnp.asarray(y_next))
        loss = step(lora, tokens, y_next)
        assert loss.dtype == torch.float32 and not loss.requires_grad
        hp.close(loss, np.asarray(jloss))
    for name in jlora.a:
        hp.close(lora.a[name], np.asarray(jlora.a[name]))
        hp.close(lora.b[name], np.asarray(jlora.b[name]))
    assert all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is not None for p in lora.parameters())


def test_lora_step_in_bf16_keeps_float32_adapters_and_lowers_the_loss():
    """Under a bf16 compute dtype the adapters stay float32 with float32
    gradients, the base stays untouched, and ten steps lower the loss of
    a fixed batch."""
    _, _, model, tcfg = _pair(seed=5)
    cfg = tcfg.replace(dtype="bfloat16")
    lora = tft.init_lora(torch.Generator().manual_seed(0), model, rank=4)
    optimizer = torch.optim.Adam(lora.parameters(), lr=1e-2)
    step = tft.make_lora_ar_step(model, cfg, optimizer)
    tokens, y_next = _batch(seed=20)
    losses = [float(step(lora, tokens, y_next)) for _ in range(10)]
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in lora.parameters())
    assert all(p.grad is None for p in model.parameters())


def test_merged_model_document_reloads_to_the_merged_encodings(tmp_path):
    """merged_model of a COATI with trained adapters: its state dict is a
    plain model state dict, the document written from it loads, and the
    loaded model encodes as the merged one does, bit for bit; the base model
    is unchanged."""
    _, _, model, cfg = hp.model_pair(seed=6)
    tok = hp.tokenizer()
    lora = tft.init_lora(torch.Generator().manual_seed(1), model.xformer, rank=4)
    with torch.no_grad():
        for b in lora.b.values():
            b.normal_(std=0.05, generator=torch.Generator().manual_seed(2))
    merged = tft.merged_model(model, lora)
    state = model_to_state(merged)
    assert state.keys() == model.state_dict().keys()
    key = "xformer.transformer.h.0.attn.c_attn.weight"
    assert not np.array_equal(state[key], model.state_dict()[key].numpy())
    kwargs = dict(n_layer_e3gnn=1, n_layer_xformer=2, n_hidden_xformer=32, n_hidden_e3nn=16,
                  n_embd_common=32, n_head=2, n_seq=32, n_tok=tok.n_token, norm_clips=True,
                  token_mlp=True)
    path = tmp_path / "merged.pkl"
    path.write_bytes(serialize_model(train_args={"tokenizer_vocab": "mar_verysimple"},
                                     dataset_summary={}, model_state=state, model_kwargs=kwargs))
    loaded, ltok = load_e3gnn_smiles_clip_e2e(str(path), device="cpu")
    tokens = np.asarray([ltok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True)
                         for s in ("CCO", "c1ccccc1", "CC(=O)O")])
    assert torch.equal(loaded.encode_tokens(tokens, ltok),
                       COATI(merged, cfg).encode_tokens(tokens, tok))
    assert not torch.equal(COATI(model, cfg).encode_tokens(tokens, tok),
                           loaded.encode_tokens(tokens, ltok))
