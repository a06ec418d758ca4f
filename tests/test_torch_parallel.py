"""coati_tpu_torch's multi-device training and sharded inference on the
CPU, held against coati_tpu.

This process runs coati_tpu's steps on its virtual CPU devices (make_mesh(2)
for data parallelism) and on one device, and writes the weights (numpy
.npz), the batches and the clip-token choices under a temporary directory.
Ranks of the port then run in processes spawned by torch.multiprocessing,
over gloo on the CPU (tests/torch_parallel_workers.py, free of JAX, one
torch thread a rank); every join has its own limit and each rank's exit
code is checked; rank 0 writes its losses and its gathered states.

The sizes are small: a 2-layer, 64-wide transformer with 4 heads and a
1-layer, 16-wide EGNN; global batches of 8 rows, 2 steps. Pipeline,
sequence and expert parallelism run in the same two spawned worlds (world
2: pipe, seq or expert 2; world 4: data 2 by each), against coati_tpu's
functions on make_pp_mesh(4, pipe=2) / make_sp_mesh(4, seq=2) over this
process's virtual devices and against the single-device steps. Tolerances are
those of tests/test_torch_training.py's single-device steps: losses within
1e-5 relative; parameters within 3 lr everywhere and 1e-3 lr for 99.9% of
them (Adam's first steps turn a last-bit gradient difference of an element
whose gradient is near 1e-8 into a step of up to lr)."""

import dataclasses
import json
import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from coati_tpu.models import coati2 as j2
from coati_tpu.models import transformer as JT
from coati_tpu.models.api import COATI as JaxCOATI
from coati_tpu.models.coati import cross_entropy_ignore as jax_cross_entropy
from coati_tpu.models.io import params_to_state
from coati_tpu.ops.attention import causal_attention as jax_causal_attention
from coati_tpu.parallel import ep as jep
from coati_tpu.parallel import pp as jpp
from coati_tpu.parallel import sp as jsp
from coati_tpu.parallel.fsdp import fsdp_specs as jax_fsdp_specs
from coati_tpu.parallel.inference import ShardedCOATI as JaxShardedCOATI
from coati_tpu.parallel.inference import ShardedCOATI2 as JaxShardedCOATI2
from coati_tpu.parallel.mesh import batch_sharding
from coati_tpu.parallel.mesh import make_mesh as jax_make_mesh
from coati_tpu.parallel.mesh import replicate_params as jax_replicate
from coati_tpu.parallel.mesh import shard_batch
from coati_tpu.parallel.tp import param_specs as jax_param_specs
from coati_tpu.tokenizers.trie_tokenizer import TrieTokenizer as JaxTokenizer
from coati_tpu.training import config as jconfig
from coati_tpu.training import train as jtrain
from coati_tpu.training import train_coati2 as jt2

from coati_tpu_torch.data import xform_coati2 as t_x2
from coati_tpu_torch.models import coati2 as t2
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.convert import (
    coati2_state_from_coati_tpu,
    gradients_from_coati_tpu,
    merge_stage_states,
    merge_states,
    moe_from_coati_tpu,
    split_state,
    stage_state,
    state_from_coati_tpu,
    transformer_state_from_coati_tpu,
)
from coati_tpu_torch.parallel.fsdp import FullyShardedPlacement
from coati_tpu_torch.parallel.inference import ShardedCOATI, ShardedCOATI2, pad_rows
from coati_tpu_torch.parallel.placement import ReplicatedPlacement, resolve_placement
from coati_tpu_torch.parallel.tp import ShardSpec, TensorParallelPlacement
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from coati_tpu_torch.training import train as ttrain
from tests import torch_parallel_workers as workers
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 1e-3
CLIP = 1.0
STEPS = 2
SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN(CC)CC", "OCC1OC(O)C(O)C(O)C1O", "CC(C)C",
          "c1ccncc1", "CC(=O)Nc1ccc(O)cc1"]
C2_SMILES = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "OC(=O)C1CC1", "N#CCC(=O)N",
             "CN1CCC(CC1)C(=O)O", "Clc1ccccc1", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]
C2_SEQ = 40


# ----------------------------------------------------------------- inputs


def _flat(state):
    return {k: v.detach().numpy() for k, v in state.items()}


def _coati2_tok(n_seq=C2_SEQ):
    return TrieTokenizer(n_seq=n_seq, **get_vocab("coati2_12_12"))


def _coati2_pair(seed, n_seq=C2_SEQ):
    kwargs = dict(n_layer_xformer=2, n_hidden_xformer=64, embed_dim=64, n_head=4, n_seq=n_seq,
                  enc_to_coati="swiglu_resnet", n_direct_clr=16,
                  n_tok=_coati2_tok(n_seq).n_token)
    jcfg = j2.Coati2Config(precision="highest", prefill_kernel="xla", **kwargs)
    jparams = j2.init_coati2(jax.random.PRNGKey(seed), jcfg)
    tcfg = t2.Coati2Config(**kwargs)
    model = t2.Coati2Model(tcfg)
    model.load_state_dict(coati2_state_from_coati_tpu(params_to_state(jparams)), strict=True)
    return jparams, jcfg, model, tcfg


def _port_state(jparams):
    return state_from_coati_tpu(params_to_state(jax.device_get(jparams)))


def _jax_steps(step, params, opt_state, batches, keys, mesh=None):
    losses = []
    for batch, sub in zip(batches, keys):
        device_batch = shard_batch(mesh, batch) if mesh is not None else {
            k: jnp.asarray(v) for k, v in batch.items()}
        params, opt_state, m = step(params, opt_state, sub, device_batch)
        losses.append([float(m[k]) for k in ("loss", "ar_loss", "clip_loss")])
    return losses, params


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs of the spawned ranks, and coati_tpu's results on them."""
    root = tmp_path_factory.mktemp("parallel")
    tok = hp.tokenizer(32)
    jparams, jcfg, model, tcfg = hp.model_pair(seed=80, n_hidden_xformer=64, n_embd_common=64,
                                               n_head=4, remat=True)
    step = dict(stop_token=tok.stop_token, unk_token=tok.unk_token, p_clip_emb_smi=0.5,
                token_entropy_unit=float(np.log2(tok.n_token)), do_clip=True)
    batches, arrays, keys = [], {}, []
    key = jax.random.PRNGKey(81)
    for i in range(STEPS):
        key, sub = jax.random.split(key)
        keys.append(sub)
        batch = hp.batch_arrays(tok, SMILES[i:] + SMILES[:i], seed=82 + i, width=24)
        batches.append(batch)
        pick = np.asarray(jax.random.uniform(sub, (len(SMILES), 1)) > 0.5)
        shard = np.concatenate([np.asarray(jax.random.uniform(
            jax.random.fold_in(sub, r), (len(SMILES) // 2, 1)) > 0.5) for r in range(2)])
        arrays.update({f"batch{i}/{k}": v for k, v in batch.items()})
        arrays[f"batch{i}/pick"], arrays[f"batch{i}/pick_shard"] = pick, shard
        # the same four molecules in each half: equal valid-token counts
        half = SMILES[2 * i:2 * i + 4]
        even = hp.batch_arrays(tok, half + half[::-1], seed=90 + i, width=24)
        assert (even["y_next"][:4] >= 0).sum() == (even["y_next"][4:] >= 0).sum()
        arrays.update({f"even{i}/{k}": v for k, v in even.items()})
        arrays[f"even{i}/pick"] = pick

    # COATI2: batches from the port's transform (the same in both packages)
    tok2 = _coati2_tok()
    j2params, j2cfg, model2, tcfg2 = _coati2_pair(seed=83)
    c2_batches = []
    for i in range(STEPS):
        random.seed(84 + i)
        b = t_x2.coati2_ar_xform({"smiles": C2_SMILES[i:] + C2_SMILES[:i]}, tok2, p_props=0.7,
                                 p_clip=0.7, rng=random.Random(84 + i))
        b = {k: np.asarray(b[k], np.int32) for k in ("tokens", "raw_tokens", "rand_tokens",
                                                      "y_next")}
        c2_batches.append(b)
        arrays.update({f"c2batch{i}/{k}": v for k, v in b.items()})
    step2 = dict(stop_token=tok2.stop_token, unk_token=tok2.unk_token, pad_token=tok2.pad_token,
                 token_entropy_unit=float(np.log2(tok2.n_token)))

    np.savez(root / "weights.npz", **_flat(model.state_dict()))
    np.savez(root / "weights2.npz", **_flat(model2.state_dict()))

    # host copies: the JAX steps donate the parameters they are given
    jparams, j2params = jax.device_get(jparams), jax.device_get(j2params)
    ref = {}
    setup = {"coati": dataclasses.asdict(tcfg), "coati2": dataclasses.asdict(tcfg2), "lr": LR,
             "clip_grad": CLIP, "steps": STEPS, "step": step, "step2": step2,
             "inject": INJECT, "moe_cf": MOE_E / 8}
    ref.update(_pipeline_sequence_expert_inputs(root, jparams, jcfg, model, tcfg, step, batches,
                                                keys, arrays))
    np.savez(root / "batches.npz", **arrays)
    (root / "setup.json").write_text(json.dumps(setup))
    jopt = jtrain.make_optimizer(jconfig.TrainConfig(lr=LR, clip_grad=CLIP))
    mesh = jax_make_mesh(2)
    for mode in ("pjit", "shard_map"):
        jstep = jtrain.make_train_step(mesh, jcfg, jopt, mode=mode, **step)
        placed = jax_replicate(mesh, jparams)
        losses, params = _jax_steps(jstep, placed, jopt.init(placed), batches, keys, mesh)
        ref[mode] = {"losses": losses, "state": _port_state(params)}
    jstep2 = jt2.make_coati2_train_step(None, j2cfg, jopt, mode="pjit", **step2)
    start2 = jax.device_put(j2params)
    losses, params = _jax_steps(jstep2, start2, jopt.init(start2), c2_batches, [None] * STEPS)
    ref["coati2"] = {"losses": losses, "state": coati2_state_from_coati_tpu(
        params_to_state(jax.device_get(params)))}
    ref["fsdp_dims"] = _jax_dims(jparams, jax_fsdp_specs(jparams, 2), state_from_coati_tpu)
    ref["tp_dims"] = _jax_dims(jparams, jax_param_specs(jparams, 2), state_from_coati_tpu)
    ref["coati2_tp_dims"] = _jax_dims(j2params, jax_param_specs(j2params, 2),
                                      coati2_state_from_coati_tpu)
    return root, ref


INJECT = 5  # the token the trunk scenarios inject over
MOE_E, MOE_D, MOE_F = 4, 16, 32


def _gradient_grabber():
    """An optax transformation that changes nothing and keeps the gradients
    as its state: a jitted step then returns them."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _trunk_batch(rng, n_tok, rows, width):
    tokens = rng.integers(0, n_tok, size=(rows, width)).astype(np.int32)
    y_next = np.full_like(tokens, -1)
    y_next[:, :-1] = tokens[:, 1:]
    y_next[rng.random(y_next.shape) < 0.15] = -1
    return tokens, y_next


def _port_single_device_steps(model, tcfg, step, batches, arrays, pick_key):
    """The port's single-device steps from `model`'s weights on the global
    batches with the given clip choices: losses, state, first clip norm."""
    model = copy.deepcopy(model)
    opt = ttrain.make_optimizer(jconfig.TrainConfig(lr=LR, clip_grad=CLIP), model)
    single = ttrain.TrainStep(model, tcfg, opt, **step)
    losses, norms = [], []
    for i, batch in enumerate(batches):
        m = single(None, hp.torch_batch(batch), pick_point=torch.tensor(arrays[f"batch{i}/{pick_key}"]))
        losses.append([float(m[k]) for k in ("loss", "ar_loss", "clip_loss")])
        norms.append(float(opt.last_grad_norm))
    return {"losses": losses, "norms": norms,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def _pipeline_sequence_expert_inputs(root, jparams, jcfg, model, tcfg, step, batches, keys,
                                     arrays):
    """The inputs of the pipeline, sequence and expert scenarios (added to
    `arrays`, the MoE to moe.npz) and coati_tpu's results on them: its
    pipelined steps' gradients on make_pp_mesh(4, pipe=2) (four times the
    single-device gradient there: see parallel/pp.py), its pipelined and
    sequence-parallel logits, its sequence-parallel step and encode, its
    single-device trunk step, dense attention and MoE."""
    ref = {}
    grab = _gradient_grabber()
    jopt = jtrain.make_optimizer(jconfig.TrainConfig(lr=LR, clip_grad=CLIP))
    unscale = 4.0  # data 2 x pipe 2
    pp_mesh = jpp.make_pp_mesh(4, pipe=2)

    # the composite step on make_pp_mesh(4, pipe=2): its first step's gradients
    pp_params = jpp.shard_coati_params_pp(pp_mesh, jparams)
    jstep = jpp.make_pp_coati_train_step(
        pp_mesh, jcfg, pp_params, grab, n_microbatches=2,
        **{k: v for k, v in step.items() if k != "do_clip"})
    batch0 = {k: jax.device_put(jnp.asarray(v), batch_sharding(pp_mesh))
              for k, v in batches[0].items()}
    _, grads, _ = jstep(pp_params, grab.init(pp_params), keys[0], batch0)
    ref["pp_grads"] = {k: v / unscale for k, v in gradients_from_coati_tpu(
        params_to_state(jax.device_get(grads))).items()}
    ref["pp_single_shard_pick"] = _port_single_device_steps(model, tcfg, step, batches, arrays,
                                                            "pick_shard")
    ref["pp_single"] = _port_single_device_steps(model, tcfg, step, batches, arrays, "pick")

    # the bare trunk: pipelined logits, the pipelined AR step's gradients and
    # the single-device AR step
    xparams, xcfg = jparams.xformer, jcfg.xformer_config
    rng = np.random.default_rng(95)
    tokens, y_next = _trunk_batch(rng, xcfg.n_tok, 8, 24)
    inj = rng.normal(size=(8, xcfg.n_embd)).astype(np.float32)
    arrays.update({"trunk/tokens": tokens, "trunk/y_next": y_next, "trunk/inj": inj})
    sharded = jpp.shard_params_pp(pp_mesh, xparams)
    for m in (2, 4):
        ref[f"pp_logits{m}"] = np.asarray(jpp.make_pp_forward_logits(
            pp_mesh, xcfg, sharded, n_microbatches=m)(sharded, jnp.asarray(tokens)))
    ref["pp_logits_inj"] = np.asarray(jpp.make_pp_forward_logits(
        pp_mesh, xcfg, sharded, n_microbatches=2, inject_token=INJECT)(
            sharded, jnp.asarray(tokens), jnp.asarray(inj)))
    ar = jpp.make_pp_ar_train_step(pp_mesh, xcfg, sharded, grab, n_microbatches=2)
    _, grads, _ = ar(sharded, grab.init(sharded), {"tokens": jnp.asarray(tokens),
                                                    "y_next": jnp.asarray(y_next)})
    ref["pp_ar_grads"] = {k: v / unscale for k, v in transformer_state_from_coati_tpu(
        params_to_state(jax.device_get(grads))).items()}

    def trunk_loss(p, tok, y):
        logits = JT.forward_logits(p, xcfg, tok)
        return jax_cross_entropy(logits.reshape(-1, xcfg.n_tok), y.reshape(-1))

    loss, grads = jax.jit(jax.value_and_grad(trunk_loss))(xparams, jnp.asarray(tokens),
                                                          jnp.asarray(y_next))
    updates, _ = jopt.update(grads, jopt.init(xparams), xparams)
    ref["trunk_step"] = {"loss": float(loss), "state": transformer_state_from_coati_tpu(
        params_to_state(jax.device_get(optax.apply_updates(xparams, updates))))}

    # sequence parallelism on make_sp_mesh(4, seq=2)
    sp_mesh = jsp.make_sp_mesh(4, seq=2)
    tokens, y_next = _trunk_batch(rng, xcfg.n_tok, 8, xcfg.n_seq)
    inj = rng.normal(size=(8, xcfg.n_embd)).astype(np.float32)
    enc = rng.integers(4, xcfg.n_tok, size=(8, xcfg.n_seq)).astype(np.int32)
    enc[enc == step["stop_token"]] = 4
    stop = step["stop_token"]
    enc[0, [5, 20, 29]] = stop  # stops in both shards: the first counts
    enc[1, [12, 13]] = stop  # adjacent, one shard
    enc[2, 31] = stop  # the last position
    enc[3, 0] = stop  # the first
    enc[4, 16] = stop  # the second shard's first position
    # rows 5-7: no stop, position 0
    q, k, v = (rng.normal(size=(2, 32, 2, 8)).astype(np.float32) for _ in range(3))
    arrays.update({"sp/tokens": tokens, "sp/y_next": y_next, "sp/inj": inj, "sp/enc_tokens": enc,
                   "sp/q": q, "sp/k": k, "sp/v": v})
    ref["sp_logits"] = np.asarray(jsp.make_sp_forward_logits(sp_mesh, xcfg)(
        xparams, jnp.asarray(tokens)))
    ref["sp_logits_inj"] = np.asarray(jsp.make_sp_forward_logits(sp_mesh, xcfg, INJECT)(
        xparams, jnp.asarray(tokens), jnp.asarray(inj)))
    ref["sp_encode"] = np.asarray(jsp.make_sp_encode(sp_mesh, xcfg, stop)(xparams,
                                                                        jnp.asarray(enc)))

    def ring_loss(q, k, v):
        return jnp.sum(jax_causal_attention(q, k, v) ** 2)

    ref["ring_out"] = np.asarray(jax.jit(jax_causal_attention)(q, k, v))
    ref["ring_grads"] = [np.asarray(g) for g in jax.jit(jax.grad(ring_loss, (0, 1, 2)))(q, k, v)]
    sp_step = jsp.make_sp_train_step(sp_mesh, xcfg, jopt)
    params, _, loss = sp_step(xparams, jopt.init(xparams), jnp.asarray(tokens),
                              jnp.asarray(y_next))
    ref["sp_step"] = {"loss": float(loss), "state": transformer_state_from_coati_tpu(
        params_to_state(jax.device_get(params)))}

    # the MoE on the global batch, its capacity binding (cf E / 8)
    moe = jax.device_get(jax.jit(jep.init_moe, static_argnums=(1, 2, 3))(
        jax.random.PRNGKey(96), MOE_D, MOE_F, MOE_E))
    x = np.random.default_rng(97).normal(size=(4, 16, MOE_D)).astype(np.float32)
    np.savez(root / "moe.npz", **{f: np.asarray(getattr(moe, f)) for f in
                                   ("router", "w_fc", "b_fc", "w_out", "b_out")})
    arrays["ep/x"] = np.asarray(x)

    def moe_loss(p, x):
        out, aux = jep.moe_mlp(p, x, capacity_factor=MOE_E / 8)
        return jnp.sum(out ** 2) + 0.01 * aux

    out, aux = jax.jit(lambda p, x: jep.moe_mlp(p, x, capacity_factor=MOE_E / 8))(moe, x)
    grads = jax.jit(jax.grad(moe_loss))(moe, x)
    ref["moe"] = {"out": np.asarray(out), "aux": float(aux),
                  "grads": {f: np.asarray(getattr(grads, f)) for f in
                            ("router", "w_fc", "b_fc", "w_out", "b_out")}}
    return ref


def _jax_dims(jparams, specs, convert):
    """coati_tpu's PartitionSpecs as the dimension of each port parameter:
    a marker that counts along the sharded dimension goes through the
    converter, which transposes and unstacks as it does the weights."""

    def marker(leaf, spec):
        out = np.zeros(leaf.shape, np.float32)
        axes = [i for i, a in enumerate(tuple(spec)) if a is not None]
        if axes:
            shape = [1] * leaf.ndim
            shape[axes[0]] = leaf.shape[axes[0]]
            out += np.arange(1, leaf.shape[axes[0]] + 1, dtype=np.float32).reshape(shape)
        return out

    marked = jax.tree_util.tree_map(marker, jax.device_get(jparams), specs)
    dims = {}
    for name, t in convert(params_to_state(marked)).items():
        t = t.numpy()
        varying = [d for d in range(t.ndim) if t.shape[d] > 1 and np.diff(t, axis=d).any()]
        dims[name] = varying[0] if varying else None
    return dims


@pytest.fixture(scope="module")
def world2(inputs):
    root, _ = inputs
    return workers.run_world(root, 2, ["dp", "clip_gradient", "fsdp", "coati2_tp", "restart",
                                       "pp", "pp_ar", "sp", "ep"])


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    root, _ = inputs
    return workers.run_world(root, 4, ["tp_dp", "pp", "pp_ar", "sp", "ep", "dryrun"])


def assert_steps_match(mine, ref):
    """Losses within 1e-5 relative; parameters within 3 lr everywhere and
    1e-3 lr for 99.9% of the elements."""
    np.testing.assert_allclose(np.asarray(mine["losses"]), np.asarray(ref["losses"]), rtol=1e-5)
    assert mine["state"].keys() == ref["state"].keys()
    diffs = torch.cat([(mine["state"][k].float() - ref["state"][k].float()).abs().flatten()
                       for k in ref["state"]])
    assert float(diffs.max()) <= 3 * LR
    assert float((diffs <= 1e-3 * LR).float().mean()) >= 0.999


# ------------------------------------------------------- data parallelism


@pytest.mark.parametrize("mode", ["pjit", "shard_map"])
def test_data_parallel_world_2_equals_coati_tpu_s_step(world2, inputs, mode):
    assert_steps_match(world2["dp"][mode], inputs[1][mode])


def test_pjit_and_shard_map_agree_on_equal_token_counts(world2):
    """As tests/test_training.py::test_pjit_and_shard_map_losses_agree: with
    the same number of valid tokens on each rank the per-rank AR mean equals
    the global one, so the two formulations take the same steps."""
    a, b = world2["dp"]["even_pjit"], world2["dp"]["even_shard_map"]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for k in a["state"]:
        torch.testing.assert_close(a["state"][k], b["state"][k], rtol=0, atol=1e-3 * LR)
    # on unequal counts they differ, as in coati_tpu
    unequal = [world2["dp"][m]["losses"][0][1] for m in ("pjit", "shard_map")]
    assert unequal[0] != pytest.approx(unequal[1], rel=1e-5)


def test_all_gather_backward_sums_and_clip_gradient_is_the_global_one(world2):
    """all_gather_rows's backward is a reduce-scatter that sums: each rank
    computes the whole loss, so its rows get the gradient of every rank's
    copy. After the mean over the data axis the CLIP gradient at world 2
    equals the single-device gradient on the concatenated batch; a backward
    that kept only the local slice would give half of it."""
    out = world2["clip_gradient"]
    torch.testing.assert_close(out["gather_grad"], out["gather_want"])
    compared = 0
    for name, g in out["grads"].items():
        want = out["single"][name]
        scale = max(1.0, float(want.abs().max()))
        assert float((g - want).abs().max()) <= 1e-5 * scale, name
        compared += bool(want.abs().max() > 1e-6)
    assert compared > 10


# ---------------------------------------------------------------- FSDP


def test_fsdp_world_2_equals_the_single_device_step(world2, inputs):
    assert_steps_match(world2["fsdp"], inputs[1]["pjit"])


def test_fsdp_shard_dims_follow_coati_tpu_and_moments_are_halved(world2, inputs):
    out = world2["fsdp"]
    assert out["specs"] == inputs[1]["fsdp_dims"]
    assert out["divisible_numel"] > 10 * out["replicated_numel"]
    # each rank's two moments: half of every divisible leaf, all of the rest
    assert out["moment_numel"] == [out["divisible_numel"] // 2 + out["replicated_numel"]] * 2


def test_fsdp_global_norm_clip_binds_on_the_whole_gradient(world2):
    """The clip's norm all-reduces the squares of the shards: it is the
    norm of the whole gradient (the single-device one), above clip_grad, so
    the clip binds."""
    out = world2["fsdp"]
    assert out["norms"][0] == pytest.approx(out["single_norm"], rel=1e-5)
    assert min(out["norms"]) > CLIP


def test_restart_saved_at_world_2_under_fsdp_resumes_at_world_1_bit_for_bit(world2, inputs):
    """train_autoencoder at world 2 under FSDP wrote its gathered state at
    step 3; a world-1 run over the directory takes no step, and its own
    end-of-run checkpoint (step 4) holds that state bit for bit."""
    root, _ = inputs
    assert len(world2["restart"]["history"]) == 3
    saved = hp.restart_states(root / "ckpt")
    assert sorted(saved) == [3]
    for name, p in world2["restart"]["params"].items():
        assert torch.equal(saved[3]["state"]["params"][name], p), name
    model, results = ttrain.train_autoencoder(workers.restart_config(root), workers.RankRows(),
                                              device="cpu", max_steps_per_epoch=3)
    assert results["history"] == []
    saved = hp.restart_states(root / "ckpt")
    assert sorted(saved) == [3, 4]
    hp.assert_same_state(saved[4]["state"], saved[3]["state"])


# ------------------------------------------------------ tensor parallelism


def test_tensor_parallel_2_by_data_parallel_2_equals_the_single_device_step(world4, inputs):
    assert_steps_match(world4["tp_dp"], inputs[1]["pjit"])


def test_tensor_parallel_shard_dims_follow_coati_tpu_s_param_specs(world4, world2, inputs):
    """The mar_verysimple vocabulary (177) is odd, so COATI's embedding and
    head stay replicated; COATI2's 4,266 splits."""
    assert world4["tp_dp"]["specs"] == inputs[1]["tp_dims"]
    assert world4["tp_dp"]["specs"]["xformer.lm_head.weight"] is None
    specs2 = world2["coati2_tp"]["specs"]
    assert specs2 == inputs[1]["coati2_tp_dims"]
    assert specs2["xformer.lm_head.weight"] == specs2["xformer.emb.tok_emb.weight"] == 0
    shapes = world2["coati2_tp"]["local_shapes"]
    assert shapes["xformer.transformer.h.0.attn.c_attn.weight"] == (96, 64)
    assert shapes["xformer.lm_head.weight"] == (4266 // 2, 64)


def test_coati2_tensor_parallel_2_equals_coati_tpu_s_step(world2, inputs):
    assert_steps_match(world2["coati2_tp"], inputs[1]["coati2"])


def test_replicated_keeps_every_parameter_whole_on_a_model_axis(world4):
    assert world4["tp_dp"]["replicated_class"] == "ReplicatedPlacement"
    assert world4["tp_dp"]["replicated_keeps_shapes"]


def test_hybrid_mesh_puts_the_host_factor_outermost(world4):
    """Ranks are numbered host by host (2 ranks a host here): with the host
    (DCN) factor on the data axis a model group stays inside a host; with
    it on the model axis a data group does."""
    assert world4["tp_dp"]["hybrid"] == [[[0, 1], [2, 3]], [[0, 2], [1, 3]]]


def test_qkv_split_keeps_heads_and_merge_inverts_it():
    """q, k and v are split by heads within each third (GSPMD would split
    the 3 D outputs contiguously); merging the shards gives the full state
    back."""
    full = {"w": torch.arange(12 * 3).reshape(12, 3).float(), "b": torch.arange(5).float()}
    specs = {"w": ShardSpec(0, qkv=True)}
    parts = [split_state(full, specs, r, 2) for r in range(2)]
    assert parts[0]["w"][:, 0].tolist() == [0, 3, 12, 15, 24, 27]  # rows 0-1, 4-5, 8-9
    assert torch.equal(parts[1]["b"], full["b"])
    merged = merge_states(parts, specs)
    assert all(torch.equal(merged[k], full[k]) for k in full)


# --------------------------------------------------------------- placement


def _mesh(shape, names):
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names, _init_backend=False, _rank=0)


def test_placement_rules_and_errors_follow_coati_tpu():
    """tests/test_placement.py's cases on the port's resolver."""
    dp, tp = _mesh((8,), ("data",)), _mesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="fsdp"):
        resolve_placement(dp, "fsdp", "shard_map")
    with pytest.raises(ValueError, match="tensor parallelism"):
        resolve_placement(tp, "auto", "shard_map")
    with pytest.raises(ValueError, match="param_sharding"):
        resolve_placement(dp, "zero_infinity", "pjit")
    assert resolve_placement(dp, "fsdp", "pjit") is FullyShardedPlacement
    assert resolve_placement(dp, "auto", "pjit") is ReplicatedPlacement
    assert resolve_placement(dp, "auto", "shard_map") is ReplicatedPlacement
    assert resolve_placement(tp, "auto", "pjit") is TensorParallelPlacement
    # "replicated" is not an alias of "auto": it replicates on a model axis
    assert resolve_placement(tp, "replicated", "pjit") is ReplicatedPlacement
    assert resolve_placement(_mesh((8, 1), ("data", "model")), "auto", "pjit") \
        is ReplicatedPlacement


# -------------------------------------------------------- sharded inference


def test_sharded_coati_gives_the_single_device_and_coati_tpu_s_tokens():
    jparams, jcfg, module, tcfg = hp.model_pair(seed=91, n_seq=32)
    tok, jtok = hp.tokenizer(32), JaxTokenizer(n_seq=32, **get_vocab("mar_verysimple"))
    model = COATI(module.eval(), tcfg)
    sharded = ShardedCOATI(model, ["cpu", "cpu"])
    assert sharded.n_devices == 2 and sharded.replicas[0].params is sharded.replicas[1].params
    smiles = SMILES[:5]  # odd: the second replica gets a padding row
    tokens = np.asarray([tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles])
    h = sharded.encode_tokens(tokens, tok)
    hp.close(h, model.encode_tokens(tokens, tok))
    jsharded = JaxShardedCOATI(JaxCOATI(jparams, jcfg), jax_make_mesh(2))
    hp.close(h, jsharded.encode_tokens(tokens, jtok))
    out = sharded.hclip_to_2d_batch(h, tok, k=1)
    assert len(out) == 5
    assert out == model.hclip_to_2d_batch(h, tok, k=1)
    assert out == jsharded.hclip_to_2d_batch(h.numpy(), jtok, k=1)
    batch = hp.batch_arrays(tok, smiles)
    hp.close(sharded.encode_points(batch["atoms"], batch["coords"]),
             model.encode_points(batch["atoms"], batch["coords"]))


def test_sharded_coati2_gives_the_single_device_and_coati_tpu_s_tokens():
    n_seq = 28
    jparams, jcfg, module, tcfg = _coati2_pair(seed=92, n_seq=n_seq)
    tok = _coati2_tok(n_seq)
    jtok = JaxTokenizer(n_seq=n_seq, **get_vocab("coati2_12_12"))
    model = t2.COATI2(module.eval(), tcfg)
    sharded = ShardedCOATI2(model, ["cpu", "cpu"])
    h = sharded.smiles_to_coati_vec(C2_SMILES[:3], tok)
    hp.close(h, model.smiles_to_coati_vec(C2_SMILES[:3], tok))
    out = sharded.hcoati_to_2d_batch(h, tok, k=1)
    assert out == model.hcoati_to_2d_batch(h, tok, k=1)
    jsharded = JaxShardedCOATI2(j2.COATI2(jparams, jcfg), jax_make_mesh(2))
    assert out == jsharded.hcoati_to_2d_batch(h, jtok, k=1)


def test_pad_rows_repeats_the_first_row_to_a_multiple():
    a = np.arange(10).reshape(5, 2)
    padded = pad_rows(a, 4)
    assert padded.shape == (8, 2) and (padded[5:] == a[0]).all() and (padded[:5] == a).all()
    assert pad_rows(a, 5) is a


# ------------------------------------------ pipeline, sequence, expert


def _world(request, world):
    return request.getfixturevalue(world)


def _grads_close(mine, ref, atol=hp.ATOL, rtol=hp.RTOL):
    assert mine.keys() == ref.keys()
    for name, g in mine.items():
        np.testing.assert_allclose(g.float().numpy(), np.asarray(ref[name]), atol=atol, rtol=rtol,
                                   err_msg=name)


def test_pipeline_composite_step_pipe_2_equals_coati_tpu_s_step(world2, inputs):
    """The whole COATI step over pipe 2, 2 microbatches: EGNN, both trunk
    passes, AR and global CLIP losses; two steps, held to coati_tpu's
    single-device (pjit) step. The global-norm clip binds, and sees the
    single-device gradient's norm."""
    out, ref = world2["pp"], inputs[1]
    assert_steps_match(out, ref["pjit"])
    assert out["norms"][0] == pytest.approx(ref["pp_single"]["norms"][0], rel=1e-5)
    assert min(out["norms"]) > CLIP


def test_pipeline_composite_step_data_2_by_pipe_2(world4, inputs):
    """Data 2 x pipe 2 with the clip choices coati_tpu's pipelined step draws
    per data rank: the steps equal the single-device steps on those choices,
    and the first step's reduced gradients are coati_tpu's on
    make_pp_mesh(4, pipe=2) divided by the mesh's 4 ranks."""
    out, ref = world4["pp"], inputs[1]
    assert_steps_match(out, ref["pp_single_shard_pick"])
    assert out["norms"][0] == pytest.approx(ref["pp_single_shard_pick"]["norms"][0], rel=1e-5)
    _grads_close(out["grads"], ref["pp_grads"])


def test_pipeline_stage_holds_only_its_layers_and_the_permute_rotates(world2):
    out = world2["pp"]
    blocks = {k.split(".")[3] for k in out["stage_keys"] if ".transformer.h." in k}
    assert blocks == {"0"}  # stage 0 of 2 over 2 layers
    assert any(k.startswith("point_encoder.") for k in out["stage_keys"])
    assert out["route"] == "p2p"
    for route in ("p2p", "all_gather"):
        # stage 0 received stage 1's x; its x went to stage 1, which scaled it by 2
        assert out["permuted"][route] == ([1.0, 1.0], [2.0, 2.0]), route


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_pipeline_forward_logits_equal_coati_tpu_s(request, inputs, world):
    out, ref = _world(request, world)["pp_ar"], inputs[1]
    for key in ("pp_logits2", "pp_logits4", "pp_logits_inj"):
        hp.close(out[key[3:]], ref[key], atol=2e-5, rtol=0)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_pipeline_ar_step_equals_the_single_device_step(request, inputs, world):
    """The trunk's pipelined AR step against coati_tpu's single-device step,
    and its reduced gradients against coati_tpu's pipelined ones / 4."""
    out, ref = _world(request, world)["pp_ar"], inputs[1]
    assert out["loss"] == pytest.approx(ref["trunk_step"]["loss"], rel=1e-5)
    assert_steps_match({"losses": [out["loss"]], "state": out["state"]},
                       {"losses": [ref["trunk_step"]["loss"]], "state": ref["trunk_step"]["state"]})
    _grads_close(out["grads"], ref["pp_ar_grads"])


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_sequence_parallel_forward_encode_and_ring_equal_coati_tpu_s(request, inputs, world):
    """Ring attention over seq 2 (world 4: data 2 x seq 2): the logits with and
    without injection, the encode's first [STOP] (rows with several stops,
    with one at either end of a shard, with none), and the ring's output and
    gradients against dense attention."""
    out, ref = _world(request, world)["sp"], inputs[1]
    hp.close(out["logits"], ref["sp_logits"], atol=2e-5, rtol=0)
    hp.close(out["logits_inj"], ref["sp_logits_inj"], atol=2e-5, rtol=0)
    hp.close(out["encode"], ref["sp_encode"], atol=2e-5, rtol=0)
    hp.close(out["ring_out"], ref["ring_out"], atol=2e-6, rtol=0)
    for mine, want in zip(out["ring_grads"], ref["ring_grads"]):
        hp.close(mine, want, atol=5e-5, rtol=0)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_sequence_parallel_step_equals_coati_tpu_s_and_guards_raise(request, inputs, world):
    out, ref = _world(request, world)["sp"], inputs[1]
    assert_steps_match({"losses": [out["loss"]], "state": out["state"]},
                       {"losses": [ref["sp_step"]["loss"]], "state": ref["sp_step"]["state"]})
    assert len(out["errors"]) == 2
    assert "exceeds cfg.n_seq" in out["errors"][0]
    assert "divide evenly" in out["errors"][1]


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_expert_parallel_forward_aux_and_gradients_equal_coati_tpu_s(request, inputs, world):
    """Expert 2 (world 4: data 2 x expert 2) with capacity cf E / 8, which
    drops tokens: the output, the load-balance loss and the gradients equal
    coati_tpu's moe_mlp on the global batch; each rank holds 2 of 4
    experts."""
    out, ref = _world(request, world)["ep"], inputs[1]["moe"]
    dropped = (np.abs(ref["out"]).reshape(-1, MOE_D).max(axis=1) == 0).sum()
    assert dropped > 0, "the capacity does not bind"
    hp.close(out["out"], ref["out"], atol=2e-5, rtol=0)
    assert out["aux"] == pytest.approx(ref["aux"], rel=1e-5)
    _grads_close(out["grads"], ref["grads"], atol=5e-5, rtol=0)
    assert out["local_experts"] == MOE_E // 2


def test_dryrun_multichip_world_4_prints_five_finite_legs(world4):
    out = world4["dryrun"]
    assert list(out["losses"]) == ["dp x tp", "fsdp", "dp x pp", "dp x sp", "dp x ep"]
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert [line.split(" OK")[0] for line in out["lines"]] == [
        f"dryrun_multichip(4) {leg}" for leg in out["losses"]]


def test_stage_state_and_moe_conversion():
    """stage_state keeps a stage's layers under their own keys and every
    replicated key; merge_stage_states joins the stages back; a coati_tpu
    MoeParams carries over field for field."""
    state = {"xformer.emb.tok_emb.weight": torch.zeros(1),
             **{f"xformer.transformer.h.{i}.ln_1.weight": torch.full((1,), float(i))
                for i in range(4)},
             "xformer.lm_head.weight": torch.ones(1)}
    parts = [stage_state(state, 4, 2, s) for s in range(2)]
    assert sorted(parts[1]) == ["xformer.emb.tok_emb.weight", "xformer.lm_head.weight",
                                "xformer.transformer.h.2.ln_1.weight",
                                "xformer.transformer.h.3.ln_1.weight"]
    assert list(merge_stage_states(parts)) == list(state)
    rng = np.random.default_rng(0)
    moe = jep.MoeParams(*(rng.normal(size=shape).astype(np.float32) for shape in
                          ((8, 4), (4, 8, 16), (4, 16), (4, 16, 8), (4, 8))))
    params = moe_from_coati_tpu(moe, device="cpu")
    for f in ("router", "w_fc", "b_fc", "w_out", "b_out"):
        np.testing.assert_array_equal(getattr(params, f).detach().numpy(),
                                      np.asarray(getattr(moe, f)))
