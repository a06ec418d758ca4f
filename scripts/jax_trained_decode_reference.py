"""The JAX package's own production-against-fp32 gap on the trained grande
document, for the port's decode-quality protocol to stand beside
(scripts/torch_eval_trained_decode.py).

    JAX_PLATFORMS=cpu python scripts/jax_trained_decode_reference.py [N] [--out FILE]

Runs scripts/eval_trained_decode.py's `evaluate` on docs/eval_model_r5.pkl
and on N train and N holdout molecules (default 256 each) of the
generation-quality protocol's split of corpora/chembl_synth_v1.smi.gz (seed
11 within each split, as chembl_analysis.rt_subset draws them), with two of
its configurations: fp32 + exact top-k and the default (bf16 weights, an
int8 KV cache, approximate top-k at recall 0.8). The other three rows are
cut from a copy of the function's source, which is otherwise run as it
stands. On the CPU, N = 256 takes about five minutes.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

import eval_trained_decode  # noqa: E402
from coati_tpu.data.synth import SynthCorpusDataset  # noqa: E402

CUT = (
    '        ("bf16", {"dtype": "bfloat16", "kv_dtype": "compute",\n'
    '                  "topk_recall": 0.95}, True, True),\n',
    '        ("bf16+int8", {"dtype": "bfloat16", "kv_dtype": "int8",\n'
    '                       "topk_recall": 0.95}, True, True),\n',
    '        ("default+pallas_decode", {"dtype": "bfloat16",\n'
    '                                   "decode_kernel": "pallas"}, True, True),\n',
)


def subset(split, n):
    return [split[i] for i in np.random.default_rng(11).permutation(len(split))[:n]]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("n", type=int, nargs="?", default=256)
    parser.add_argument("--out", default="jax_trained_decode_reference.json")
    args = parser.parse_args()
    data = SynthCorpusDataset.from_files(
        os.path.join(ROOT, "corpora", "chembl_synth_v1.smi.gz"), epoch_rows=0,
        collection="chembl_mols")
    train, hold = data.split(0.1)
    source = inspect.getsource(eval_trained_decode.evaluate)
    for row in CUT:
        if row not in source:
            raise SystemExit(f"eval_trained_decode.evaluate changed: {row!r} not found")
        source = source.replace(row, "")
    namespace = dict(vars(eval_trained_decode))
    exec(source, namespace)
    verdict = namespace["evaluate"](os.path.join(ROOT, "docs", "eval_model_r5.pkl"),
                                    subset(train, args.n) + subset(hold, args.n), args.out)
    print(json.dumps(verdict["results"], indent=1))


if __name__ == "__main__":
    main()
