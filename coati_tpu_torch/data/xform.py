"""Training batch transform: augmentation + tokenization (host-side).

Own copy of coati_tpu/data/xform.py (numpy and the port's own chemistry),
the reference's clip_ar_xform. It runs on the host in the input pipeline and
emits fixed-shape numpy batches. Identical augmentation logic, probabilities
and order of random draws, so the same `random.Random` seed (and, for the
permuted SMILES, the same state of the global `random` module, which
chem/selfies_lite.permute_smiles draws from) gives the same batch in both
packages:

  * every row canonicalized (chem/graph_canon.py: its C pipeline in
    native/fast_canon.c when a compiler is present, else Python; the two
    give the same bytes);
  * random [SET]/<collection>, [FORMULA], [GRAPH] prefixes/suffixes in
    shuffled order, always containing [SMILES]<canonical>;
  * CLIP prefix '[CLIP][UNK]' with probability p_clip, optionally with a
    FIM-style cut (p_clip_cut); plain FIM with p_fim otherwise;
  * random SMILES permutation of the s2s target with p_randsmiles;
  * oversize fallback to the plain SMILES form; failed rows become
    all-pad token rows with a stop-only s2s row (loss-inert);
  * shifted y_next labels with special tokens masked to -1;
  * rows without atoms get a conformer from chem/conformers.py, and
    fp_targets adds host-side fingerprints (chem/fingerprints.py).

`pad_width_to` rounds the trimmed token width up to a multiple (default 16),
so that the attention kernels see few distinct T.
"""

from __future__ import annotations

import functools as _functools
import random as _random
import warnings
from typing import Dict, Optional

import numpy as np

from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self, permute_smiles
from coati_tpu_torch.tokenizers.graph_tokens import adj_mat_to_tokens
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer


# Per-process conformer-synthesis accounting: a corpus that
# systematically fails to embed must be visible, not a silent CLIP-signal
# collapse. Warn once when a batch exceeds the threshold.
EMBED_FAIL_COUNTS = {"attempted": 0, "failed": 0}
_EMBED_FAIL_WARN = 0.25
_embed_fail_warned = False


@_functools.lru_cache(maxsize=50_000)
def _embed_conformer_cached(smiles: str):
    from coati_tpu_torch.chem.rdkit_support import mol_to_atoms_coords

    out = mol_to_atoms_coords(smiles, hydrogenate=True)
    if out is None:
        return None
    return np.asarray(out[0], np.int32), np.asarray(out[1], np.float32)


def _conformers_missing(batch: Dict) -> bool:
    """True when any row lacks 3D inputs. stack_batch (batch_pipe.py:49)
    ALWAYS emits 'atoms'/'coords' columns — SMILES-only rows arrive as
    present-but-EMPTY (B, 0) arrays, and a mixed batch zero-fills the
    atom-less rows — so a key-presence check is not enough. (An
    all-zero-atom batch reaching the model is catastrophic, not inert:
    the EGNN masked-pools nothing, h_e3gnn is row-constant, and the
    CLIP loss floors at exactly ln(B) while its weighted noise gradient
    collapses the SMILES encoder.)"""
    if "atoms" not in batch or "coords" not in batch:
        return True
    atoms = np.asarray(batch["atoms"])
    if atoms.ndim != 2 or atoms.shape[-1] == 0:
        return True
    return not (atoms > 0).any(axis=-1).all()


def _synthesize_conformers(batch: Dict) -> None:
    """Fill missing atoms/coords from SMILES via mol_to_atoms_coords
    (rdkit ETKDG when present, else the in-tree distance-geometry
    embedder chem/conformers.py; reference datasets precompute these
    columns with ETKDG, rdkit_utils.py:162-219). Rows that already
    carry atoms keep them; rows that fail to embed get all-padding
    atoms — the same loss-inert degradation as tokenize failures.
    A batch where many rows fail to embed is NOT inert (zero-atom rows
    degrade the CLIP signal — see _conformers_missing), so failure
    fractions above _EMBED_FAIL_WARN are warned once per process."""
    b = len(batch["smiles"])
    old_a = old_c = None
    if "atoms" in batch and np.asarray(batch["atoms"]).ndim == 2 \
            and np.asarray(batch["atoms"]).shape[-1] > 0:
        old_a = np.asarray(batch["atoms"])
        old_c = np.asarray(batch["coords"])
    rows = []
    n_embedded = n_failed = 0
    for i, s in enumerate(batch["smiles"]):
        if old_a is not None and (old_a[i] > 0).any():
            rows.append((old_a[i], old_c[i]))
        else:
            r = _embed_conformer_cached(str(s))
            rows.append(r)
            n_embedded += 1
            n_failed += r is None
    EMBED_FAIL_COUNTS["attempted"] += n_embedded
    EMBED_FAIL_COUNTS["failed"] += n_failed
    if n_embedded and n_failed / n_embedded > _EMBED_FAIL_WARN:
        global _embed_fail_warned
        if not _embed_fail_warned:
            _embed_fail_warned = True
            warnings.warn(
                f"conformer synthesis failed for {n_failed}/{n_embedded} "
                "rows of a batch; failed rows train with zero atoms, and "
                "a systematically failing corpus collapses the CLIP "
                "signal (see _conformers_missing). Totals in "
                "coati_tpu_torch.data.xform.EMBED_FAIL_COUNTS.",
                stacklevel=2,
            )
    n_max = max((r[0].shape[0] for r in rows if r is not None), default=1)
    atoms = np.zeros((b, n_max), np.int32)
    coords = np.zeros((b, n_max, 3), np.float32)
    for i, r in enumerate(rows):
        if r is None:
            continue
        a, c = r
        atoms[i, : a.shape[0]] = a
        coords[i, : c.shape[0]] = c
    batch["atoms"] = atoms
    batch["coords"] = coords


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
    """fp_targets: optional tuple like (("morgan", 2048),) — computes the
    named fingerprints host-side into batch['fp_<name>'] (the fp-variant
    xform, clip_fp_e2e.py:21,273-278; rdkit when present, else the
    in-tree ECFP engine in chem/fingerprints.py).
    canonicalize=False uses the input strings verbatim — the SELFIES
    adapter needs this: cached selfies are already canonical
    (clip_e2e_selfies.py:76) and RDKit would happily parse
    bracket-atom selfies AS SMILES and rewrite them."""
    if "smiles" not in batch:
        raise KeyError("clip_ar_xform: the batch has no 'smiles' column")
    if _conformers_missing(batch):
        # SMILES-only (or mixed) rows: synthesize 3D inputs on the fly
        _synthesize_conformers(batch)
    rng = rng or _random
    n_seq = tokenizer.n_seq
    token_rows, s2s_rows = [], []

    for k, smiles_in in enumerate(batch["smiles"]):
        canonical = canonicalize_or_self(smiles_in) if canonicalize else smiles_in
        try:
            reps = ["smiles"]
            if rng.random() < p_dataset:
                src = batch["source_collection"][k] if "source_collection" in batch else None
                if src is not None and f"[{src}]" in tokenizer.special_tokens:
                    reps.append("set")
            if rng.random() < p_formula:
                reps.append("formula")
            if rng.random() < p_graph and "adj_mat" in batch and "adj_mat_atoms" in batch:
                reps.append("graph")
            rng.shuffle(reps)

            text = ""
            for rep in reps:
                if rep == "set":
                    text += "[SET][" + batch["source_collection"][k] + "]"
                elif rep == "smiles":
                    text += "[SMILES]" + canonical
                elif rep == "formula":
                    text += _formula_string(batch["atoms"][k])
                elif rep == "graph":
                    text += adj_mat_to_tokens(
                        batch["adj_mat"][k], batch["adj_mat_atoms"][k]
                    )
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
                # precomputed permutation columns (SELFIES caches carry
                # 'rand_smiles'); otherwise permute via RDKit
                if "rand_smiles" in batch:
                    permuted = str(batch["rand_smiles"][k])
                else:
                    permuted = permute_smiles(canonical)
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

    if fp_targets:
        from coati_tpu_torch.chem.rdkit_support import mol_to_morgan

        for name, n_bits in fp_targets:
            if name != "morgan":
                raise ValueError(f"unsupported fp target {name!r}")
            fps = []
            for s in batch["smiles"]:
                fp = mol_to_morgan(str(s), radius=2, n_bits=n_bits)
                fps.append(
                    fp if fp is not None else np.zeros((n_bits,), np.uint8)
                )
            batch[f"fp_{name}"] = np.stack(fps).astype(np.int32)
    return batch
