"""coati_tpu_torch/viz against coati_tpu/viz on the CPU: roc_data and
tsne_coords give coati_tpu's results (pandas and scikit-learn are present
here); image_formatter2 encodes as coati_tpu's; the charts and the
molecule images need altair and RDKit, which are absent here, and raise
ImportError naming them; with rdkit, altair, pandas and sklearn all made
unimportable, both modules still import and every call that needs one of
them raises ImportError naming it."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from coati_tpu.viz import altair_plots as jalt
from coati_tpu.viz import plots as jplots

from coati_tpu_torch.viz import altair_plots as talt
from coati_tpu_torch.viz import plots as tplots
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]


def _scores(seed=0, n=200):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    return pd.DataFrame({"y": y, "y_pred": y * 0.6 + rng.normal(scale=0.5, size=n),
                         "split": np.where(rng.random(n) < 0.7, "train", "test")})


def test_roc_data_equals_coati_tpu_s():
    source = _scores()
    mine, ref = talt.roc_data(source), jalt.roc_data(source)
    pd.testing.assert_frame_equal(mine, ref)
    assert mine.attrs == ref.attrs and 0.5 < mine.attrs["auROC"] <= 1.0
    mine = talt.roc_data(source, partition_col="split")
    pd.testing.assert_frame_equal(mine, jalt.roc_data(source, partition_col="split"))
    assert sorted(v.split(" - ")[0] for v in mine["split"].unique()) == ["test", "train"]


def test_tsne_coords_equals_coati_tpu_s():
    embs = np.random.default_rng(1).normal(size=(40, 8)).astype(np.float32)
    mine = talt.tsne_coords(embs, seed=3)
    assert mine.shape == (40, 2)
    np.testing.assert_array_equal(mine, jalt.tsne_coords(embs, seed=3))


def test_image_formatter2_equals_coati_tpu_s():
    from PIL import Image

    pixels = np.random.default_rng(2).integers(0, 255, size=(120, 160, 3), dtype=np.uint8)
    mine = tplots.image_formatter2(Image.fromarray(pixels))
    assert mine == jplots.image_formatter2(Image.fromarray(pixels))
    assert mine.startswith("data:image/png;base64,")


def test_what_needs_rdkit_or_altair_raises_without_them():
    """Neither is installed here, in either package."""
    for fn, args in ((tplots.get_smiles_image, ("CCO",)),
                     (tplots.wrapped_get_smiles_image, ("CCO",)),
                     (tplots.wrapped_get_smiles_image, (None,))):
        with pytest.raises(ImportError, match="RDKit"):
            fn(*args)
    assert talt.HAS_ALTAIR == jalt.HAS_ALTAIR is False
    for fn, args in ((talt.roc_plot, (_scores(),)), (talt.embed_altair, (pd.DataFrame(),)),
                     (talt.require_altair, ())):
        with pytest.raises(ImportError, match="altair"):
            fn(*args)


HIDDEN = """
import sys
for name in ("rdkit", "altair", "pandas", "sklearn", "sklearn.metrics", "sklearn.manifold"):
    sys.modules[name] = None  # import of it raises ImportError
from coati_tpu_torch.viz import altair_plots, plots
import numpy as np
calls = [
    ("pandas", lambda: altair_plots.roc_data({"y": [0, 1], "y_pred": [0.1, 0.9]})),
    ("sklearn.manifold", lambda: altair_plots.tsne_coords(np.zeros((4, 2)))),
    ("altair", lambda: altair_plots.roc_plot(None)),
    ("altair", lambda: altair_plots.embed_altair(None)),
    ("RDKit", lambda: plots.get_smiles_image("CCO")),
]
for needed, call in calls:
    try:
        call()
    except ImportError as ex:
        assert needed in str(ex), (needed, str(ex))
    else:
        raise AssertionError(f"no ImportError without {needed}")
print("ok")
"""


def test_viz_imports_and_refuses_calls_without_its_optional_packages():
    run = subprocess.run([sys.executable, "-c", HIDDEN], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip().endswith("ok"), run.stdout + run.stderr
