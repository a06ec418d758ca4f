"""Molecule images for notebooks and reports (the port's copy of
coati_tpu/viz/plots.py). Drawing needs RDKit, which is optional: the module
imports without it, and a call that draws raises ImportError."""

from __future__ import annotations

import base64
from io import BytesIO

from coati_tpu_torch.chem.rdkit_support import require_rdkit


def get_smiles_image(s: str, size=(300, 300)):
    """A PIL image of the molecule."""
    require_rdkit("get_smiles_image")
    from rdkit import Chem
    from rdkit.Chem import Draw

    return Draw.MolToImage(Chem.MolFromSmiles(s), size=size)


def wrapped_get_smiles_image(x, size=(300, 300)):
    """get_smiles_image, with methane's image for anything it cannot draw."""
    if not isinstance(x, str):
        return get_smiles_image("C", size=size)
    try:
        return get_smiles_image(x, size=size)
    except Exception:  # noqa: BLE001 - an unparseable SMILES (or no RDKit: raises again)
        return get_smiles_image("C", size=size)


def image_formatter2(im, size=(90, 90)) -> str:
    """A PIL image as a base64 PNG data URI (for chart tooltips)."""
    with BytesIO() as buffer:
        im.thumbnail(size)
        im.save(buffer, "png")
        data = base64.encodebytes(buffer.getvalue()).decode("utf-8")
    return f"data:image/png;base64,{data}"
