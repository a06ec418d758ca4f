"""Likelihood and bulk-generation analysis (script form of the reference's
chembl_analysis notebook):

  1. s2s likelihoods: the NLL that each molecule decodes back to itself;
  2. bulk unconditional sampling with validity / uniqueness fractions
     (the reference's protocol: k 10,000, inverse temperature 1.75, over
     repeated batches);
  3. property distributions of generated against input molecules (needs
     RDKit).

With --corpus it runs, in place of 2 and 3, the evaluation half of the
generation-quality protocol of scripts/eval_generation_quality.py (the
reference's acceptance protocol, chembl_analysis.ipynb cells 24-26) on
that corpus: greedy round trips of the train and holdout splits, then
--batches x --batch_size draws behind '[SET][chembl_mols][SMILES]'.

Run: python -m coati_tpu_torch.examples.chembl_analysis --doc_url <model document>
     [--corpus corpora/chembl_synth_v1.smi.gz]
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np

from coati_tpu_torch.chem.rdkit_support import (
    HAS_RDKIT,
    canon_smiles,
    canonicalize_or_self,
    identical_canonsmi,
    is_valid_smiles,
    mol_properties,
)
from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

MOLS = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "c1ccc2c(c1)cccn2",
    "OCC1OC(O)C(O)C(O)C1O",
    "CC(C)NCC(O)c1ccc(O)c(O)c1",
    "CCN(CC)CCNC(=O)c1ccc(N)cc1",
    "Nc1ccc(cc1)S(=O)(=O)N",
]

# the generation-quality protocol (scripts/eval_generation_quality.py)
QUALITY_PREFIX = "[SET][chembl_mols][SMILES]"
HOLDOUT_FRAC = 0.1  # split seed 20260819: SynthCorpusDataset.split's
RT_SEED = 11
ROUND_TRIP_K, ROUND_TRIP_INV_TEMP = 2, 20.0
ROUND_TRIP_CHUNK = 1024


def split_corpus(corpus_path: str):
    """(train, holdout) SMILES of a corpus file, as the protocol splits it."""
    from coati_tpu_torch.data.synth import SynthCorpusDataset

    data = SynthCorpusDataset.from_files(corpus_path, epoch_rows=0, collection="chembl_mols")
    return data.split(HOLDOUT_FRAC)


def rt_subset(split, n: int):
    """The protocol's round-trip sample: n rows drawn with seed 11, or all."""
    if len(split) <= n:
        return split
    rng = np.random.default_rng(RT_SEED)
    return [split[i] for i in rng.permutation(len(split))[:n]]


def _valid_proxy(s: str, tokenizer) -> bool:
    """The tokenizer takes it and its rings and brackets balance."""
    try:
        tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True)
    except (KeyError, ValueError):
        return False
    if s.count("(") != s.count(")") or s.count("[") != s.count("]"):
        return False
    digits = [c for c in s if c.isdigit()]
    return all(digits.count(d) % 2 == 0 for d in set(digits))


def _same_mol(a: str, b: str) -> bool:
    try:
        return bool(identical_canonsmi(a, b))
    except Exception:  # noqa: BLE001 - an unparseable decode
        return a == b


def roundtrip_rows(tokenizer, smiles):
    """(kept, tokens): the molecules of `smiles` the round trip can take
    (the validity proxy passes, they canonicalize, their canonical writing
    fits n_seq) and the (rows, n_seq) '[SMILES]...[STOP]' tokens of that
    canonical writing, the key the decoder learned."""
    keep, enc = [], []
    for s in smiles:
        if not _valid_proxy(s, tokenizer):
            continue
        try:
            c = canon_smiles(s)
        except Exception:  # noqa: BLE001
            continue
        if len(tokenizer.tokenize_text("[SMILES]" + c + "[STOP]", pad=False)) <= tokenizer.n_seq:
            keep.append(s)
            enc.append(c)
    tokens = np.asarray(
        [tokenizer.tokenize_text("[SMILES]" + c + "[STOP]", pad=True) for c in enc], np.int64)
    return keep, tokens.reshape(len(enc), tokenizer.n_seq)


def roundtrip_share(decoded, kept) -> float:
    """The share of decodes that are the same molecule as their input."""
    return sum(1 for a, b in zip(decoded, kept) if _same_mol(a, b)) / len(kept)


def greedy_roundtrip(model, tokenizer, smiles, chunk: int = ROUND_TRIP_CHUNK):
    """(share, rows): the share of molecules whose embedding of their
    canonical writing decodes (k 2, inverse temperature 20) to the same
    molecule, and how many molecules were tried."""
    keep, tokens = roundtrip_rows(tokenizer, smiles)
    if not keep:
        return 0.0, 0
    decoded = []
    for lo in range(0, len(tokens), chunk):
        h = model.encode_tokens(tokens[lo : lo + chunk], tokenizer)
        decoded.extend(model.hclip_to_2d_batch(h, tokenizer, inv_temp=ROUND_TRIP_INV_TEMP,
                                               k=ROUND_TRIP_K))
    return roundtrip_share(decoded, keep), len(keep)


def bulk_protocol(model, tokenizer, batches: int, batch_size: int, k: int, inv_temp: float,
                  prefix: str = QUALITY_PREFIX) -> dict:
    """batches x batch_size draws behind `prefix`: valid by the in-tree
    parser (chem/selfies_lite.py), unique as raw strings (the notebook's
    measure) and as molecules (chem/graph_canon.py)."""
    from coati_tpu_torch.chem.graph_canon import canonical_smiles
    from coati_tpu_torch.chem.selfies_lite import parse_smiles

    drawn = []
    for i in range(batches):
        drawn.extend(model.complete_batch([prefix] * batch_size, tokenizer, k=k,
                                          inv_temp=inv_temp))
        print(f"batch {i + 1}/{batches} done")
    valid = []
    for d in drawn:
        try:
            parse_smiles(d)
            valid.append(d)
        except Exception:  # noqa: BLE001 - not a molecule
            pass
    canon = set()
    for d in valid:
        try:
            canon.add(canonical_smiles(d))
        except Exception:  # noqa: BLE001
            pass
    n_valid = max(len(valid), 1)
    return {
        "n_samples": len(drawn),
        "fraction_valid": len(valid) / max(len(drawn), 1),
        "n_unique_valid": len(set(valid)),
        "fraction_unique": len(set(valid)) / n_valid,
        "n_unique_canonical": len(canon),
        "fraction_unique_canonical": len(canon) / n_valid,
        "mean_len": float(np.mean([len(d) for d in drawn])),
    }


def generation_quality(model, tokenizer, corpus_path: str, rt_sample: int = 2048,
                       batches: int = 10, batch_size: int = 1024, k: int = 10_000,
                       inv_temp: float = 1.75) -> dict:
    """The evaluation half of scripts/eval_generation_quality.py."""
    train, hold = split_corpus(corpus_path)
    rt_train, n_train = greedy_roundtrip(model, tokenizer, rt_subset(train, rt_sample))
    rt_hold, n_hold = greedy_roundtrip(model, tokenizer, rt_subset(hold, rt_sample))
    print(f"greedy round-trip: train {rt_train:.1%} ({n_train}), "
          f"holdout {rt_hold:.1%} ({n_hold})")
    bulk = bulk_protocol(model, tokenizer, batches, batch_size, k, inv_temp)
    print(f"generated {bulk['n_samples']}: fraction valid {bulk['fraction_valid']:.4f}, "
          f"fraction unique {bulk['fraction_unique']:.4f}, mean length {bulk['mean_len']:.2f}")
    return {"greedy_roundtrip_train": rt_train, "greedy_roundtrip_holdout": rt_hold,
            "rt_rows_train": n_train, "rt_rows_holdout": n_hold, "bulk": bulk}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--doc_url", required=True)
    parser.add_argument("--batches", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--k", type=int, default=10_000)
    parser.add_argument("--inv_temp", type=float, default=1.75)
    parser.add_argument("--corpus", default=None,
                        help="run the generation-quality protocol on this corpus")
    parser.add_argument("--rt_sample", type=int, default=2048,
                        help="round-trip rows per split of the protocol")
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)
    model, tokenizer = load_e3gnn_smiles_clip_e2e(args.doc_url, device=args.device)

    # 1. self-decoding likelihoods
    nll, mask = model.batch_smiles_to_s2s_likelihood(MOLS, tokenizer)
    nll = nll.float().cpu().numpy()
    print("s2s negative log-likelihoods:")
    kept = [m for m, ok in zip(MOLS, mask) if ok]
    for s, v in zip(kept, nll):
        print(f"   {v:8.2f}  {s}")
    out = {"s2s_nll": nll, "s2s_mask": mask}

    if args.corpus:
        out.update(generation_quality(model, tokenizer, args.corpus, args.rt_sample,
                                      args.batches, args.batch_size, args.k, args.inv_temp))
        return out

    # 2. bulk sampling validity / uniqueness (reference cells 24-26)
    all_gen = []
    for b in range(args.batches):
        all_gen.extend(model.complete_batch(
            ["[SMILES]"] * args.batch_size, tokenizer,
            inv_temp=args.inv_temp, k=min(args.k, tokenizer.n_token),
        ))
        print(f"batch {b + 1}/{args.batches} done")
    valid = [canonicalize_or_self(s) for s in all_gen if is_valid_smiles(s)]
    counts = Counter(valid)
    n = len(all_gen)
    print(
        f"generated {n}: fraction valid {len(valid) / n:.3f}, "
        f"#unique {len(counts)}, fraction unique {len(counts) / max(len(valid), 1):.3f}"
    )
    out.update({"generated": all_gen, "fraction_valid": len(valid) / n,
                "n_unique": len(counts), "fraction_unique": len(counts) / max(len(valid), 1)})

    # 3. property distributions
    if HAS_RDKIT and valid:
        gen_props = [mol_properties(s) for s in valid[:500]]
        ref_props = [mol_properties(s) for s in MOLS]
        for key in ("MolWt", "MolLogP", "TPSA"):
            g = np.array([p[key] for p in gen_props if p])
            r = np.array([p[key] for p in ref_props if p])
            out[key] = (float(g.mean()), float(g.std()), float(r.mean()))
            print(f"{key}: generated {g.mean():.1f}+-{g.std():.1f} vs input {r.mean():.1f}")
    return out


if __name__ == "__main__":
    main()
