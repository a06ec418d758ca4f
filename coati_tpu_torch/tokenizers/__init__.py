"""Tokenization layer: vocabularies + trie tokenizer.

Vocabularies are shipped as pure JSON data files in `vocabs/`
({"special_tokens": [...], "smiles_tokens": [...]}), covering all nine
reference vocabs (mar, may, mar_simple, mar_verysimple, giant,
no_composite_special, may_closedparen, selfies_mcp_clone, coati2_12_12).
Parity target: coati/models/encoding/tokenizers/__init__.py:14-28.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

VOCAB_PATH = Path(__file__).parent / "vocabs"


def available_vocabs() -> List[str]:
    return sorted(p.stem for p in VOCAB_PATH.glob("*.json"))


def load_vocab(vocab_name: str) -> Dict[str, List[str]]:
    with open(VOCAB_PATH / f"{vocab_name}.json") as f:
        return json.load(f)


def get_vocab(vocab_name: str) -> Dict[str, List[str]]:
    try:
        return load_vocab(vocab_name)
    except FileNotFoundError as ex:
        raise ValueError(
            f"vocab_name {vocab_name!r} not found; available: {available_vocabs()}"
        ) from ex
