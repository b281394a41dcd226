"""Image and loss-plot dumps of the experiments.

The port's own copy of what the experiment drivers use of
``adjointnonlinearraytracing_tpu/utils/plotting.py``.  ``matplotlib`` is
imported inside the functions, so nothing else needs it; where it is not
installed they write nothing and warn.
"""

from __future__ import annotations

import os
import warnings

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


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None, with a warning, where
    matplotlib is not installed: the figures are side products, and no
    number or other file of a run depends on them."""
    try:
        import matplotlib
    except ImportError:
        warnings.warn("matplotlib is not installed: the run writes no figures", stacklevel=3)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_multiple_images(images, outname: str):
    """Row-of-images dump."""
    plt = _pyplot()
    if plt is None:
        return
    _ensure_dir(outname)
    n = len(images)
    fig, axes = plt.subplots(1, n, squeeze=False, figsize=(3 * n, 3))
    for i, im in enumerate(images):
        axes[0, i].imshow(_to_numpy(im))
        axes[0, i].axis("off")
    fig.savefig(outname, bbox_inches="tight", dpi=100)
    plt.close(fig)


def save_loss_plot(loss_hist, outname: str):
    plt = _pyplot()
    if plt is None:
        return
    _ensure_dir(outname)
    fig = plt.figure()
    plt.plot(_to_numpy(loss_hist))
    plt.xlabel("iteration")
    plt.ylabel("loss")
    plt.yscale("log")
    fig.savefig(outname, bbox_inches="tight", dpi=100)
    plt.close(fig)


def save_profile_plot(profile, grad, outname: str):
    """Radial profile and its gradient side by side (the fiber driver's dump)."""
    plt = _pyplot()
    if plt is None:
        return
    _ensure_dir(outname)
    fig, ax = plt.subplots(1, 2, figsize=(8, 3))
    ax[0].plot(_to_numpy(profile))
    ax[0].set_title("radial profile")
    ax[1].plot(_to_numpy(grad))
    ax[1].set_title("gradient profile")
    fig.savefig(outname, bbox_inches="tight", dpi=100)
    plt.close(fig)
