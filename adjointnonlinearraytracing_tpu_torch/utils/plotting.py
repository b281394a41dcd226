"""Image and loss-plot dumps of the experiments.

The port's own copy of what the fuel-injection trainer uses of
``adjointnonlinearraytracing_tpu/utils/plotting.py``.  ``matplotlib`` is
imported inside the functions, so nothing else needs it.
"""

from __future__ import annotations

import os

import numpy as np


def _ensure_dir(path: str):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def _to_numpy(a):
    """A tensor (on any device), array or list as a numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
    return np.asarray(a)


def save_multiple_images(images, outname: str):
    """Row-of-images dump."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _ensure_dir(outname)
    n = len(images)
    fig, axes = plt.subplots(1, n, squeeze=False, figsize=(3 * n, 3))
    for i, im in enumerate(images):
        axes[0, i].imshow(_to_numpy(im))
        axes[0, i].axis("off")
    fig.savefig(outname, bbox_inches="tight", dpi=100)
    plt.close(fig)


def save_loss_plot(loss_hist, outname: str):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _ensure_dir(outname)
    fig = plt.figure()
    plt.plot(_to_numpy(loss_hist))
    plt.xlabel("iteration")
    plt.ylabel("loss")
    plt.yscale("log")
    fig.savefig(outname, bbox_inches="tight", dpi=100)
    plt.close(fig)
