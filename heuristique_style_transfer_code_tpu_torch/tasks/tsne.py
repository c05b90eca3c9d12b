"""t-SNE visualisation (``tasks/tsne.py`` of the JAX package, copied: the
port imports nothing of that package): the static plot
(functions/functions_RESNET50_Truncate.py:423-444 of the reference) and
the interactive Tk GUI (:447-617): picking a point shows its image, a
right click starts a PolygonSelector, "Close Polygon" writes
inside/outside_polygon.json and fills a dropdown, z/a zoom. Without
$DISPLAY the interactive mode falls back to the static plot. scikit-learn,
matplotlib, Tk and Pillow are imported where they are used, never at
import.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np


def _tsne_2d(embeddings: np.ndarray, random_state: int = 0) -> np.ndarray:
    from sklearn.manifold import TSNE

    emb = np.asarray(embeddings).reshape(len(embeddings), -1)
    # sklearn requires perplexity < n_samples
    perplexity = min(30.0, max(1.0, (len(emb) - 1) / 3.0))
    tsne = TSNE(n_components=2, random_state=random_state, perplexity=perplexity)
    return tsne.fit_transform(emb)


def _color_map(labels: np.ndarray, colors: Optional[Sequence[str]], cmap_name="tab20"):
    import matplotlib.pyplot as plt

    unique = np.unique(labels)
    if colors and len(colors) >= len(unique):
        return {int(l): colors[i] for i, l in enumerate(unique)}, unique
    cmap = plt.get_cmap(cmap_name)
    return {int(l): cmap(i / max(len(unique), 1)) for i, l in enumerate(unique)}, unique


def perform_tsne(
    embeddings,
    labels,
    class_names: List[str],
    colors: Optional[Sequence[str]] = None,
    results_dir: str = "results",
    show: bool = False,
    random_state: int = 0,
    filename: str = "tsne_plot.png",
) -> str:
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
        show = False
    import matplotlib.pyplot as plt

    print("Running t-SNE...")
    labels = np.asarray(labels)
    pts = _tsne_2d(embeddings, random_state)
    plt.figure(figsize=(10, 10))
    color_map, unique = _color_map(labels, colors)
    for label in unique:
        idx = labels == label
        plt.scatter(pts[idx, 0], pts[idx, 1], label=class_names[int(label)],
                    color=color_map[int(label)])
    plt.legend()
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, filename)
    plt.savefig(path)
    if show:
        plt.show()
    plt.close()
    print(f"t-SNE plot saved to '{path}'")
    return path


def analyze_polygon_points(
    tsne_results: np.ndarray,
    polygon: List,
    labels,
    classes: List[str],
    img_paths: List[str],
    save_dir: str,
):
    """Polygon containment analysis + JSON artifacts (:544-561). Pulled out of
    the GUI so it is unit-testable headlessly."""
    from matplotlib.path import Path

    inside, outside = [], []
    poly = Path(polygon)
    for i, (x, y) in enumerate(np.asarray(tsne_results)):
        rec = {
            "path": img_paths[i],
            "class": classes[int(labels[i])],
            "position": [float(x), float(y)],
        }
        (inside if poly.contains_point((x, y)) else outside).append(rec)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "inside_polygon.json"), "w") as f:
        json.dump(inside, f)
    with open(os.path.join(save_dir, "outside_polygon.json"), "w") as f:
        json.dump(outside, f)
    return inside, outside


class TsneInteractiveController:
    """All interactive t-SNE behaviour (reference GUI
    functions_RESNET50_Truncate.py:447-617), decoupled from Tk so it runs —
    and is tested — on any matplotlib canvas (Agg included). The ``view`` is
    anything with set_image(pil_image), set_label(str), set_inside_count(str)
    and set_dropdown(values, current_index); production wires a Tk view,
    tests a fake."""

    def __init__(self, pts, labels, classes, img_paths, view, save_dir,
                 colors=None, figsize=(10, 10)):
        import matplotlib.pyplot as plt

        self.pts = np.asarray(pts)
        self.labels = np.asarray(labels)
        self.classes = classes
        self.img_paths = img_paths
        self.view = view
        self.save_dir = save_dir
        self.fig, self.ax = plt.subplots(figsize=figsize)
        color_map, unique = _color_map(self.labels, colors)
        self.ax.scatter(
            self.pts[:, 0], self.pts[:, 1],
            c=[color_map[int(l)] for l in self.labels], picker=True,
        )
        # one scatter (so pick-event indices are global) + proxy legend
        # handles: legend_elements() is empty for an explicit color list
        from matplotlib.lines import Line2D

        self.ax.legend(
            handles=[
                Line2D([], [], marker="o", linestyle="", color=color_map[int(l)],
                       label=classes[int(l)])
                for l in unique
            ]
        )
        self.polygon: List = []
        self._selector = None
        self._cleared = True
        self.fig.canvas.mpl_connect("pick_event", self.onpick)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("button_press_event", self.enable_polygon_selector)

    # ---- event handlers --------------------------------------------------
    def onpick(self, event):
        from PIL import Image

        ind = event.ind[0]
        img = Image.open(self.img_paths[ind]).resize((400, 400), Image.LANCZOS)
        self.view.set_image(img)
        self.view.set_label(f"Label: {self.classes[int(self.labels[ind])]}")

    def on_key(self, event):
        if event.key == "z":
            self.zoom(event.xdata, event.ydata, 0.9)
        elif event.key == "a":
            self.zoom(event.xdata, event.ydata, 1.1)

    def zoom(self, x, y, factor):
        if x is None or y is None:
            return
        ax = self.ax
        xlim, ylim = ax.get_xlim(), ax.get_ylim()
        ax.set_xlim([x - (x - xlim[0]) * factor, x + (xlim[1] - x) * factor])
        ax.set_ylim([y - (y - ylim[0]) * factor, y + (ylim[1] - y) * factor])
        self.fig.canvas.draw_idle()

    def enable_polygon_selector(self, event):
        from matplotlib.widgets import PolygonSelector

        if event.button == 3 and (self._selector is None or self._cleared):
            self._selector = PolygonSelector(self.ax, onselect=self.onselect, useblit=True)
            self._cleared = False
            print("Polygon selector enabled.")

    def onselect(self, verts):
        self.polygon.clear()
        self.polygon.extend(verts)

    def analyze(self):
        if len(self.polygon) < 3:
            print("Polygon not closed. Select at least 3 points.")
            return None
        inside, _ = analyze_polygon_points(
            self.pts, self.polygon, self.labels, self.classes,
            self.img_paths, self.save_dir,
        )
        self.view.set_inside_count(f"Points inside polygon: {len(inside)}")
        self.view.set_dropdown(
            [f"{p['path']} ({p['class']})" for p in inside],
            0 if inside else None,
        )
        return inside

    def clear(self):
        self.polygon.clear()
        if self._selector is not None:
            self._selector.disconnect_events()
            self._selector.set_visible(False)
            self._selector = None
        for p in list(self.ax.patches):  # ArtistList is immutable (mpl>=3.7)
            p.remove()
        self.fig.canvas.draw_idle()
        self.view.set_inside_count("")
        self.view.set_label("")
        self._cleared = True


def plot_tsne_interactive(
    embeddings,
    labels,
    classes: List[str],
    img_paths: List[str],
    colors: Optional[Sequence[str]] = None,
    num_clusters: Optional[int] = None,
    save_dir: str = "results",
    random_state: int = 42,
):
    """Interactive Tk GUI (needs $DISPLAY; falls back to the static plot
    headlessly, keeping the JSON/PNG artifact surface). All behaviour lives
    in TsneInteractiveController; this function only builds the Tk widgets."""
    labels = np.asarray(labels)
    if not os.environ.get("DISPLAY"):
        print("No display available — falling back to static t-SNE plot.")
        return perform_tsne(embeddings, labels, classes, colors, save_dir,
                            random_state=random_state)

    import tkinter as tk
    from tkinter import ttk

    from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
    from PIL import ImageTk

    pts = _tsne_2d(embeddings, random_state)

    root = tk.Tk()
    root.title("Interactive t-SNE with Images")

    img_label = tk.Label(root)
    img_label.grid(row=0, column=1, sticky="nsew")
    label_text = tk.StringVar()
    tk.Label(root, textvariable=label_text).grid(row=1, column=1, sticky="nsew")
    inside_points_label = tk.StringVar()
    tk.Label(root, textvariable=inside_points_label).grid(
        row=2, column=0, columnspan=2, sticky="nsew"
    )
    if num_clusters is not None:
        tk.Label(root, text=f"Number of clusters: {num_clusters}").grid(
            row=3, column=0, columnspan=2, sticky="nsew"
        )
    dropdown = ttk.Combobox(root)

    class TkView:
        def set_image(self, pil_image):
            img_tk = ImageTk.PhotoImage(pil_image)
            img_label.configure(image=img_tk)
            img_label.image = img_tk

        def set_label(self, text):
            label_text.set(text)

        def set_inside_count(self, text):
            inside_points_label.set(text)

        def set_dropdown(self, values, current):
            dropdown["values"] = values
            if current is not None:
                dropdown.current(current)

    ctl = TsneInteractiveController(
        pts, labels, classes, img_paths, TkView(), save_dir, colors
    )

    canvas = FigureCanvasTkAgg(ctl.fig, master=root)
    canvas.draw()
    canvas.get_tk_widget().grid(row=0, column=0, rowspan=2, sticky="nsew")
    for c in range(2):
        root.grid_columnconfigure(c, weight=1)
    for r in range(4):
        root.grid_rowconfigure(r, weight=1)

    tk.Button(root, text="Close Polygon", command=ctl.analyze).grid(row=4, column=0, sticky="ew")
    tk.Button(root, text="Clear Polygon", command=ctl.clear).grid(row=4, column=1, sticky="ew")
    dropdown.grid(row=6, column=0, columnspan=2, sticky="ew")
    root.mainloop()
