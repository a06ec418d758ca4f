"""COATI2 training batch transform: property-token conditioning (host-side).

The port's own copy of coati_tpu/data/xform_coati2.py: the same code and
the same results, importing nothing of the JAX package.

BEYOND-PARITY: the reference ships COATI2 as inference only
(coati/models/simple_coati2/, loader io.py:21-84); its training code is
not public. This transform reconstructs the training-side data recipe
from what the published artifacts pin down:

  * the coati2_12_12 vocabulary enumerates the conditioning language —
    [PROPS]...[ENDPROPS] blocks, named property tokens ([IntMolLogP],
    [PercentQED], [TPSA], ...) each followed by a bucketed [NUM<i>] value
    (i in 0..169), stereo tags [CHIRAL]/[RACEMIC]/[DIASTEREOMER]/
    [DIASTEREOMER-MIX], and provenance flags [purchasable]/[fda_approved]
    (tokenizers/vocabs/coati2_12_12.json; README.md:23-25);
  * COATI_Smiles_Inference decodes from a '[CLIP][UNK]' prefix with an
    embedding injected over [UNK] (transformer_only.py:113-153), so
    training rows must carry the same prefix;
  * Coati2Config.n_direct_clr (transformer_only.py:56) implies a
    directCLR-style contrastive objective over a leading slice of the
    embedding — 2D-only, so the two views are two SMILES serializations
    of the same molecule (canonical + random permutation).

Value bucketing (OUR recipe — documented here because generation-time
conditioning must use the same buckets, see `property_tokens`):
  [IntExactMolWt]  [NUM clamp(round(mw / 5), 0, 169)]     (5-Da buckets)
  [IntMolLogP]     [NUM clamp(round(logp) + 10, 0, 169)]  (+10 offset)
  [PercentQED]     [NUM round(qed * 100)]
  [PercentCSP3]    [NUM round(fcsp3 * 100)]
  [TPSA]           [NUM min(round(tpsa), 169)]
  count descriptors ([NumHDonors], ...) use the raw count, clamped.
"""

from __future__ import annotations

import random as _random
from typing import Dict, Optional

import numpy as np

from coati_tpu_torch.chem.rdkit_support import (
    HAS_RDKIT,
    canonicalize_or_self,
    permute_smiles,
)
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer


def _bucket(value: float, lo: int = 0, hi: int = 169) -> int:
    return int(np.clip(int(round(value)), lo, hi))


# property-token -> (source key, bucketing fn). Source keys match
# coati2_properties() below and precomputed dataset columns.
PROPERTY_BUCKETS = {
    "[IntExactMolWt]": ("ExactMolWt", lambda v: _bucket(v / 5.0)),
    "[IntMolLogP]": ("MolLogP", lambda v: _bucket(v + 10.0)),
    "[PercentQED]": ("QED", lambda v: _bucket(v * 100.0)),
    "[PercentCSP3]": ("FractionCSP3", lambda v: _bucket(v * 100.0)),
    "[TPSA]": ("TPSA", lambda v: _bucket(v)),
    "[NumHAcceptors]": ("NumHAcceptors", _bucket),
    "[NumHDonors]": ("NumHDonors", _bucket),
    "[NumRotatableBonds]": ("NumRotatableBonds", _bucket),
    "[NumAromaticRings]": ("NumAromaticRings", _bucket),
    "[NumAromaticCarbocycles]": ("NumAromaticCarbocycles", _bucket),
    "[NumAliphaticCarbocycles]": ("NumAliphaticCarbocycles", _bucket),
}


def coati2_properties(smiles: str) -> Optional[Dict[str, float]]:
    """Descriptors needed by PROPERTY_BUCKETS. With rdkit: the full set.
    Without rdkit the in-tree engines supply the same full set —
    chem/descriptors.py for counts/TPSA/weights, chem/crippen.py for
    MolLogP, chem/qed.py for QED — so [IntMolLogP]/[PercentQED]
    conditioning tokens appear in offline-built rows too. Returns None
    when the molecule does not parse."""
    if not HAS_RDKIT:
        from coati_tpu_torch.chem.crippen import mol_logp
        from coati_tpu_torch.chem.descriptors import molecular_descriptors
        from coati_tpu_torch.chem.qed import qed as _qed

        try:
            out = dict(molecular_descriptors(smiles))
        except Exception:  # noqa: BLE001
            return None
        # per-key so a SMARTS/kekulize trip loses only MolLogP/QED, not
        # the whole conditioning block (property_tokens skips missing
        # keys)
        try:
            out["MolLogP"] = mol_logp(smiles)
        except Exception:  # noqa: BLE001
            pass
        try:
            out["QED"] = _qed(smiles)
        except Exception:  # noqa: BLE001
            pass
        return out
    from rdkit import Chem
    from rdkit.Chem import Crippen, Descriptors, Lipinski, QED

    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return None
    return {
        "ExactMolWt": Descriptors.ExactMolWt(mol),
        "MolLogP": Crippen.MolLogP(mol),
        "QED": QED.qed(mol),
        "FractionCSP3": Lipinski.FractionCSP3(mol),
        "TPSA": Descriptors.TPSA(mol),
        "NumHAcceptors": Lipinski.NumHAcceptors(mol),
        "NumHDonors": Lipinski.NumHDonors(mol),
        "NumRotatableBonds": Lipinski.NumRotatableBonds(mol),
        "NumAromaticRings": Lipinski.NumAromaticRings(mol),
        "NumAromaticCarbocycles": Lipinski.NumAromaticCarbocycles(mol),
        "NumAliphaticCarbocycles": Lipinski.NumAliphaticCarbocycles(mol),
    }


def stereo_tag(smiles: str) -> str:
    """Stereo conditioning token. With rdkit: [CHIRAL] when every
    stereocenter is assigned, [RACEMIC] when none are,
    [DIASTEREOMER-MIX] for a partial assignment; '' for achiral
    molecules. Without rdkit: '@' presence in the SMILES."""
    if not HAS_RDKIT:
        return "[CHIRAL]" if "@" in smiles else ""
    from rdkit import Chem

    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return ""
    centers = Chem.FindMolChiralCenters(
        mol, includeUnassigned=True, useLegacyImplementation=False
    )
    if not centers:
        return ""
    assigned = sum(1 for _, tag in centers if tag != "?")
    if assigned == len(centers):
        return "[CHIRAL]"
    if assigned == 0:
        return "[RACEMIC]"
    return "[DIASTEREOMER-MIX]"


def property_tokens(
    smiles: str,
    tokenizer: TrieTokenizer,
    properties: Optional[Dict[str, float]] = None,
    include: Optional[set] = None,
    with_stereo: bool = True,
) -> str:
    """'[PROPS]...[ENDPROPS]' conditioning block for one molecule.

    `properties` overrides rdkit computation (precomputed dataset columns
    or user-chosen targets at generation time); `include` restricts which
    property tokens appear. Returns '' when nothing is available. Also the
    public API for conditioned generation: build the block, prepend it to
    the '[CLIP][UNK][SMILES]' prefix and sample.
    """
    props = properties if properties is not None else coati2_properties(smiles)
    parts = []
    if with_stereo:
        tag = stereo_tag(smiles)
        if tag and tag in tokenizer.special_tokens:
            parts.append(tag)
    if props:
        for token, (key, fn) in PROPERTY_BUCKETS.items():
            if include is not None and token not in include:
                continue
            if key not in props or token not in tokenizer.special_tokens:
                continue
            num = f"[NUM{fn(float(props[key]))}]"
            if num in tokenizer.special_tokens:
                parts.append(token + num)
    if not parts:
        return ""
    return "[PROPS]" + "".join(parts) + "[ENDPROPS]"


def coati2_ar_xform(
    batch: Dict,
    tokenizer: TrieTokenizer,
    p_props: float = 0.5,
    p_prop_each: float = 0.5,
    p_clip: float = 0.9,
    p_dataset: float = 0.2,
    pad_width_to: int = 16,
    rng: Optional[_random.Random] = None,
) -> Dict:
    """COATI2 training rows from a batch with a 'smiles' column.

    Emits
      tokens      — AR target: [PROPS]...[ENDPROPS] (p_props, each property
                    kept with p_prop_each) + [SET][collection] (p_dataset)
                    + [CLIP][UNK] (p_clip) + [SMILES]<canonical>[STOP];
      raw_tokens  — [SMILES]<canonical>[STOP], the embedding view;
      rand_tokens — [SMILES]<permuted>[STOP], the second (directCLR) view;
      y_next      — shifted labels, conditioning specials masked to -1.

    Precomputed columns honored: 'properties' (list of dicts keyed like
    coati2_properties), 'rand_smiles', 'source_collection',
    'purchasable'/'fda_approved' truthy flags.
    """
    assert "smiles" in batch
    rng = rng or _random
    n_seq = tokenizer.n_seq
    token_rows, raw_rows, rand_rows = [], [], []

    def _tok(s):
        return tokenizer.tokenize_text(s, pad=False, range_check=False)

    for k, smiles_in in enumerate(batch["smiles"]):
        canonical = canonicalize_or_self(str(smiles_in))
        try:
            text = ""
            if rng.random() < p_props:
                props = None
                if "properties" in batch and batch["properties"][k] is not None:
                    props = dict(batch["properties"][k])
                available = set(PROPERTY_BUCKETS)
                include = {t for t in available if rng.random() < p_prop_each}
                block = property_tokens(
                    canonical, tokenizer, properties=props, include=include
                )
                if block:
                    # provenance flags ride inside the block, before [ENDPROPS]
                    flags = "".join(
                        f"[{name}]"
                        for name in ("purchasable", "fda_approved")
                        if name in batch
                        and bool(batch[name][k])
                        and f"[{name}]" in tokenizer.special_tokens
                    )
                    if flags:
                        block = block[: -len("[ENDPROPS]")] + flags + "[ENDPROPS]"
                    text += block
            if rng.random() < p_dataset and "source_collection" in batch:
                src = batch["source_collection"][k]
                if src is not None and f"[{src}]" in tokenizer.special_tokens:
                    text += f"[SET][{src}]"
            if rng.random() < p_clip:
                text += "[CLIP][UNK]"
            text += "[SMILES]" + canonical + "[STOP]"

            ttext = _tok(text)
            raw = _tok("[SMILES]" + canonical + "[STOP]")
            if "rand_smiles" in batch and batch["rand_smiles"][k]:
                permuted = str(batch["rand_smiles"][k])
            else:
                permuted = permute_smiles(canonical)
            rand = _tok("[SMILES]" + (permuted or canonical) + "[STOP]")

            if max(len(ttext), len(raw), len(rand)) <= n_seq:
                token_rows.append(ttext)
                raw_rows.append(raw)
                rand_rows.append(rand)
            elif max(len(raw), len(rand)) <= n_seq:
                # oversize fallback: drop the conditioning prefix
                token_rows.append(raw)
                raw_rows.append(raw)
                rand_rows.append(rand)
            else:
                print("Too much seq data.", canonical, len(raw))
                token_rows.append([])
                raw_rows.append([tokenizer.stop_token])
                rand_rows.append([tokenizer.stop_token])
        except Exception as ex:  # noqa: BLE001 - row-level fault tolerance
            print("Tokenize failure:", canonical, " Except:", ex)
            token_rows.append([])
            raw_rows.append([tokenizer.stop_token])
            rand_rows.append([tokenizer.stop_token])

    def _stack(rows, width=None):
        if width is None:
            width = max((len(r) for r in rows), default=1)
        width = max(width, 1)
        if pad_width_to:
            width = ((width + pad_width_to - 1) // pad_width_to) * pad_width_to
        # clamp the rounded width to the tokenizer/model n_seq: rows are
        # length-filtered to <= n_seq but rounding can overshoot, and the
        # model's rotary tables only cover n_seq positions
        width = min(width, tokenizer.n_seq)
        # pad with the REAL pad id: coati2_12_12's [PAD] is 31, not 0
        # (id 0 is [CHARGE]) — zero-filling would both feed [CHARGE]
        # tokens to the model and leave them unmasked in the loss
        out = np.full((len(rows), width), tokenizer.pad_token, np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    batch["tokens"] = _stack(token_rows)
    # the two directCLR views share a width so the train step can encode
    # them as one doubled batch (coati2_training_forward)
    view_width = max(
        max((len(r) for r in raw_rows), default=1),
        max((len(r) for r in rand_rows), default=1),
    )
    batch["raw_tokens"] = _stack(raw_rows, view_width)
    batch["rand_tokens"] = _stack(rand_rows, view_width)

    y_next = np.full_like(batch["tokens"], tokenizer.pad_token)
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
