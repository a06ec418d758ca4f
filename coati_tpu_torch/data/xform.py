"""Training batch transform: augmentation + tokenization (host-side).

Own copy of coati_tpu/data/xform.py (numpy only), the reference's
clip_ar_xform. It runs on the host in the input pipeline and emits
fixed-shape numpy batches. Identical augmentation logic, probabilities and
order of random draws, so the same `random.Random` seed gives the same batch
in both packages:

  * random [SET]/<collection>, [FORMULA], [GRAPH] prefixes/suffixes in
    shuffled order, always containing [SMILES]<canonical>;
  * CLIP prefix '[CLIP][UNK]' with probability p_clip, optionally with a
    FIM-style cut (p_clip_cut); plain FIM with p_fim otherwise;
  * random SMILES permutation of the s2s target with p_randsmiles;
  * oversize fallback to the plain SMILES form; failed rows become
    all-pad token rows with a stop-only s2s row (loss-inert);
  * shifted y_next labels with special tokens masked to -1.

`pad_width_to` rounds the trimmed token width up to a multiple (default 16),
so that the attention kernels see few distinct T.

What needs the chemistry modules of the JAX package (coati_tpu/chem, not
ported yet) raises here, naming the missing module, and is never skipped
silently: canonicalize=True, a permutation without a precomputed
`rand_smiles` column, rows without atoms, fp_targets, and the graph
representation (coati_tpu/tokenizers/graph_tokens.py).
"""

from __future__ import annotations

import random as _random
from typing import Dict, Optional

import numpy as np

from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"clip_ar_xform: {what} needs {module} of the JAX package, which is not ported yet"
    )


def _conformers_missing(batch: Dict) -> bool:
    """True when any row lacks 3D inputs. stack_batch always emits
    'atoms'/'coords' columns: SMILES-only rows arrive as present-but-empty
    (B, 0) arrays, and a mixed batch zero-fills the atom-less rows, so a
    key-presence check is not enough. (An all-zero-atom row reaching the
    model is not inert: the EGNN pools nothing and the CLIP loss floors.)"""
    if "atoms" not in batch or "coords" not in batch:
        return True
    atoms = np.asarray(batch["atoms"])
    if atoms.ndim != 2 or atoms.shape[-1] == 0:
        return True
    return not (atoms > 0).any(axis=-1).all()


def _formula_string(atoms_row: np.ndarray) -> str:
    ats = atoms_row.astype(int)
    cts = np.bincount(ats[ats > 0])
    if not (cts < 150).all():
        return ""
    rows = np.stack([np.arange(cts.shape[0])[cts > 0], cts[cts > 0]], -1)
    return "[FORMULA]" + "".join(f"[ELM{r[0]}][NUM{r[1]}]" for r in rows)


def clip_ar_xform(
    batch: Dict,
    tokenizer: TrieTokenizer,
    p_dataset: float = 0.2,
    p_formula: float = 0.2,
    p_fim: float = 0.0,
    p_graph: float = 0.0,
    p_clip: float = 0.9,
    p_clip_cut: float = 0.3,
    p_randsmiles: float = 0.0,
    coord_noise: bool = False,
    pad_width_to: int = 16,
    rng: Optional[_random.Random] = None,
    fp_targets: Optional[tuple] = None,
    canonicalize: bool = True,
) -> Dict:
    """canonicalize=False uses the input strings verbatim (a corpus that
    is already canonical); True is the reference's default and raises here
    until the canonicalizer is ported. fp_targets (the fingerprint
    variant's host-side targets) raises for the same reason."""
    if "smiles" not in batch:
        raise KeyError("clip_ar_xform: the batch has no 'smiles' column")
    if canonicalize:
        raise _not_ported("canonicalize=True", "coati_tpu/chem/graph_canon.py")
    if fp_targets:
        raise _not_ported("fp_targets", "coati_tpu/chem/fingerprints.py")
    if p_randsmiles > 0 and "rand_smiles" not in batch:
        raise _not_ported(
            "p_randsmiles > 0 without a 'rand_smiles' column",
            "coati_tpu/chem/rdkit_support.py (permute_smiles)",
        )
    if p_graph > 0 and "adj_mat" in batch and "adj_mat_atoms" in batch:
        raise _not_ported("p_graph > 0", "coati_tpu/tokenizers/graph_tokens.py")
    if _conformers_missing(batch):
        raise _not_ported("a row without atoms", "coati_tpu/chem/conformers.py")
    rng = rng or _random
    n_seq = tokenizer.n_seq
    token_rows, s2s_rows = [], []

    for k, smiles_in in enumerate(batch["smiles"]):
        canonical = smiles_in
        try:
            reps = ["smiles"]
            if rng.random() < p_dataset:
                src = batch["source_collection"][k] if "source_collection" in batch else None
                if src is not None and f"[{src}]" in tokenizer.special_tokens:
                    reps.append("set")
            if rng.random() < p_formula:
                reps.append("formula")
            rng.random()  # the graph representation's draw; a batch that could take it was refused
            rng.shuffle(reps)

            text = ""
            for rep in reps:
                if rep == "set":
                    text += "[SET][" + batch["source_collection"][k] + "]"
                elif rep == "smiles":
                    text += "[SMILES]" + canonical
                elif rep == "formula":
                    text += _formula_string(batch["atoms"][k])
            text += "[STOP]"
            ttext = tokenizer.tokenize_text(text, pad=False, range_check=False)

            def _tok(s):
                return tokenizer.tokenize_text(s, pad=False, range_check=False)

            if rng.random() < p_clip and len(ttext) > 3:
                if rng.random() < p_clip_cut:
                    stop = ttext.pop()
                    mp = sp = 1
                    while mp == sp:
                        mp, sp = sorted(
                            [rng.randint(2, len(ttext)), rng.randint(2, len(ttext))]
                        )
                    ttext = (
                        _tok("[CLIP][UNK]")
                        + ttext[:mp]
                        + _tok("[SUFFIX]")
                        + ttext[sp:]
                        + _tok("[MIDDLE]")
                        + ttext[mp:sp]
                        + [stop]
                    )
                else:
                    ttext = _tok("[CLIP][UNK]") + ttext
            elif rng.random() < p_fim and len(ttext) > 4:
                stop = ttext.pop()
                mp = sp = 1
                while mp == sp:
                    mp, sp = sorted(
                        [rng.randint(1, len(ttext)), rng.randint(1, len(ttext))]
                    )
                ttext = (
                    _tok("[PREFIX]")
                    + ttext[:mp]
                    + _tok("[SUFFIX]")
                    + ttext[sp:]
                    + _tok("[MIDDLE]")
                    + ttext[mp:sp]
                    + [stop]
                )

            if rng.random() < p_randsmiles:
                # a precomputed permutation column (checked above)
                permuted = str(batch["rand_smiles"][k])
                s2s_text = _tok("[SMILES]" + permuted + "[STOP]")
                unperm = _tok("[SMILES]" + canonical + "[STOP]")
            else:
                s2s_text = _tok("[SMILES]" + canonical + "[STOP]")
                unperm = s2s_text

            if len(ttext) <= n_seq and len(s2s_text) <= n_seq:
                token_rows.append(ttext)
                s2s_rows.append(s2s_text)
            elif len(s2s_text) <= n_seq and len(unperm) <= n_seq:
                # oversize fallback: plain (unpermuted) SMILES form
                token_rows.append(unperm)
                s2s_rows.append(s2s_text)
            else:
                print("Too much seq data.", canonical, len(s2s_text))
                token_rows.append([])
                s2s_rows.append([tokenizer.stop_token])
        except Exception as ex:  # noqa: BLE001 - row-level fault tolerance
            print("Tokenize failure:", canonical, " Except:", ex)
            token_rows.append([])
            s2s_rows.append([tokenizer.stop_token])

    def _stack(rows):
        width = max((len(r) for r in rows), default=1)
        width = max(width, 1)
        if pad_width_to:
            width = ((width + pad_width_to - 1) // pad_width_to) * pad_width_to
        # rows are already length-filtered to <= n_seq, but the rounding
        # can overshoot it — clamp so the model's rotary tables (length
        # n_seq) always cover the batch width
        width = min(width, n_seq)
        out = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    batch["tokens"] = _stack(token_rows)
    batch["raw_tokens"] = _stack(s2s_rows)

    if batch["atoms"].shape[0] < 1:
        raise ValueError("empty batch")
    batch["atoms"] = np.asarray(batch["atoms"], np.int32)
    batch["coords"] = np.asarray(batch["coords"], np.float32)
    if coord_noise:
        batch["coords"] = batch["coords"] + np.random.normal(
            0.0, 0.05, batch["coords"].shape
        ).astype(np.float32)

    # next-token labels, special tokens masked out of the loss
    y_next = np.zeros_like(batch["tokens"])
    y_next[:, :-1] = batch["tokens"][:, 1:]
    for t in (
        tokenizer.clip_token,
        tokenizer.pad_token,
        tokenizer.unk_token,
        tokenizer.suffix_token,
        tokenizer.middle_token,
    ):
        y_next[y_next == t] = -1
    batch["y_next"] = y_next
    return batch
