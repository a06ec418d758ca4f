"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch in float32 (TF32 off), written from the published
description of COATI (terraytherapeutics/COATI: the rotary SMILES
transformer, the E(n)-equivariant point encoder, the CLIP heads) and
COATI2 (simple_coati2: the SwiGLU heads). It imports nothing of the
program: it reads the weights from the stacked-layer document format
itself (`weights.py`), tokenizes with its own leftmost-longest matcher
over the vocabulary files (`tokenizer.py`), and computes with no kernel,
cache or batching (`model.py`, `egnn.py`, `train.py`). `lowp.py` holds the
lower-precision forms the controls compute in.
"""
