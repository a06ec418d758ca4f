"""ROC curves and t-SNE maps of embeddings (the port's copy of
coati_tpu/viz/altair_plots.py). pandas, scikit-learn and altair are
optional: the module imports without them, and a call that needs one
raises ImportError naming it."""

from __future__ import annotations

import importlib

import numpy as np

try:
    import altair as alt

    alt.data_transformers.disable_max_rows()
    HAS_ALTAIR = True
except ImportError:
    HAS_ALTAIR = False


def require_altair() -> None:
    if not HAS_ALTAIR:
        raise ImportError("altair is required for this chart but is not installed.")


def _optional(module: str, what: str):
    """`module` imported, or ImportError naming it and `what` needs it."""
    try:
        return importlib.import_module(module)
    except ImportError as ex:
        raise ImportError(f"{module} is required for {what} but is not installed.") from ex


def roc_data(source, y_true="y", y_pred="y_pred", partition_col=None):
    """ROC curves and the auROC of each partition ("train", "test") as
    DataFrames; without `partition_col`, one curve with its auROC in
    `attrs["auROC"]`. Needs pandas and scikit-learn, not altair."""
    pd = _optional("pandas", "roc_data")
    metrics = _optional("sklearn.metrics", "roc_data")

    def curve(frame):
        fpr, tpr, _ = metrics.roc_curve(y_true=frame[y_true], y_score=frame[y_pred])
        df = pd.DataFrame({"False Positive Rate": fpr, "True Positive Rate": tpr})
        return df, round(metrics.auc(fpr, tpr), 3)

    if partition_col is not None:
        frames = []
        for part in ("train", "test"):
            df, area = curve(source[source[partition_col] == part])
            df[partition_col] = f"{part} - auROC: {area}"
            frames.append(df)
        return pd.concat(frames)
    df, area = curve(source)
    df.attrs["auROC"] = area
    return df


def roc_plot(source, y_true="y", y_pred="y_pred", partition_col=None, chart_args=None):
    """roc_data as an altair line chart."""
    require_altair()
    if chart_args is None:
        chart_args = {"height": 400, "width": 400}
    data = roc_data(source, y_true, y_pred, partition_col)
    if partition_col is not None:
        return (
            alt.Chart(data, **chart_args)
            .mark_line()
            .encode(x="False Positive Rate", y="True Positive Rate", color=partition_col)
        )
    return (
        alt.Chart(data, **chart_args)
        .mark_line()
        .encode(x="False Positive Rate", y="True Positive Rate")
        .properties(title=f"auROC: {data.attrs['auROC']}")
    )


def tsne_coords(embs: np.ndarray, seed: int = 0) -> np.ndarray:
    """(N, D) embeddings -> (N, 2) by scikit-learn's t-SNE."""
    manifold = _optional("sklearn.manifold", "tsne_coords")
    return manifold.TSNE(
        n_components=2, learning_rate=100, init="random", random_state=seed
    ).fit_transform(np.asarray(embs))


def embed_altair(
    df,
    tooltip_fields=("smiles", "mol_index"),
    selector_field="library",
    quantity="FOLDOVER_ALL_MEDIAN",
    image_tooltip=True,
    emb_field="emb",
    smiles_field="smiles",
    width=1024,
    height=768,
):
    """A t-SNE scatter of `df[emb_field]` coloured by `quantity`, with
    molecule images in the tooltips and a selector over `selector_field`.
    Adds the columns image, mol_index, X and Y to `df`."""
    require_altair()
    pd = _optional("pandas", "embed_altair")
    from coati_tpu_torch.viz.plots import image_formatter2, wrapped_get_smiles_image

    df["image"] = df[smiles_field].apply(wrapped_get_smiles_image).apply(image_formatter2).copy()
    df["mol_index"] = range(df.shape[0])

    selector = None
    if selector_field is not None:
        substrate_frame = pd.DataFrame({selector_field: df[selector_field].unique().tolist()})
        selection = alt.selection_point(fields=[selector_field])
        color1 = alt.condition(selection, alt.Color(f"{selector_field}:N"), alt.value("lightgray"))
        selector = (
            alt.Chart(substrate_frame)
            .mark_rect()
            .encode(y=selector_field, color=color1)
            .add_params(selection)
        )

    tooltip = [alt.Tooltip(field=f, title=f) for f in tooltip_fields]
    if image_tooltip:
        tooltip.append("image")

    coords = tsne_coords(np.stack(df[emb_field].values.tolist(), 0))
    df.loc[:, "X"] = coords[:, 0]
    df.loc[:, "Y"] = coords[:, 1]

    chart = (
        alt.Chart(df)
        .mark_circle(size=60)
        .encode(
            x=alt.X("X:Q", scale=alt.Scale(zero=False)),
            y=alt.Y("Y:Q", scale=alt.Scale(zero=False)),
            color=alt.Color(f"{quantity}:Q", scale=alt.Scale(range=["orange", "blue"])),
            opacity=alt.value(0.5),
            tooltip=tooltip,
        )
        .properties(title="", width=int(width), height=height)
    )
    if selector is not None:
        return alt.hconcat(selector, chart.transform_filter(selection))
    return chart
