"""Live training-curve plotter (a copy of pope_tpu/utils/animator.py).

Behavioral spec: pose/animator.py:20-59 (d2l-style Animator: incremental
multi-line plot with `add(x, y)`, axes config, legend). The reference
renders through IPython.display; this version works headless too — in a
notebook it live-updates via display/clear_output, otherwise it redraws an
interactive matplotlib window when available and can always `save(path)`
the current figure (a training machine often has no display).
"""

from __future__ import annotations

from typing import Optional, Sequence


def set_axes(axes, xlabel, ylabel, xlim, ylim, xscale, yscale, legend):
    """Axes config helper (pose/animator.py:6-18)."""
    axes.set_xlabel(xlabel)
    axes.set_ylabel(ylabel)
    axes.set_xscale(xscale)
    axes.set_yscale(yscale)
    if xlim:
        axes.set_xlim(xlim)
    if ylim:
        axes.set_ylim(ylim)
    if legend:
        axes.legend(legend)
    axes.grid()


class Animator:
    """Incremental multi-line loss plot (pose/animator.py:20-59 API)."""

    def __init__(self, xlabel=None, ylabel=None, legend: Optional[Sequence[str]] = None,
                 xlim=None, ylim=None, xscale="linear", yscale="linear",
                 fmts=("-", "m--", "g-.", "r:"), figsize=(3.5, 2.5),
                 live: bool = True):
        import matplotlib

        if not matplotlib.get_backend().lower().startswith(("qt", "tk", "macosx", "module")):
            live = live and self._in_ipython()
        from matplotlib import pyplot as plt

        self._plt = plt
        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.config_axes = lambda: set_axes(
            self.ax, xlabel, ylabel, xlim, ylim, xscale, yscale, legend or []
        )
        self.X, self.Y, self.fmts = None, None, fmts
        self.live = live

    @staticmethod
    def _in_ipython() -> bool:
        try:
            from IPython import get_ipython

            return get_ipython() is not None
        except ImportError:
            return False

    def add(self, x, y):
        """Append one (x, y) sample per line and redraw (animator.py:38-59)."""
        if not hasattr(y, "__len__"):
            y = [y]
        n = len(y)
        if not hasattr(x, "__len__"):
            x = [x] * n
        if self.X is None:
            self.X = [[] for _ in range(n)]
            self.Y = [[] for _ in range(n)]
        for i, (a, b) in enumerate(zip(x, y)):
            if a is not None and b is not None:
                self.X[i].append(a)
                self.Y[i].append(b)
        self.ax.cla()
        for xs, ys, fmt in zip(self.X, self.Y, self.fmts):
            self.ax.plot(xs, ys, fmt)
        self.config_axes()
        if self.live:
            if self._in_ipython():
                from IPython import display

                display.display(self.fig)
                display.clear_output(wait=True)
            else:
                self.fig.canvas.draw_idle()
                self._plt.pause(0.001)

    def save(self, path: str):
        """Write the current figure (the headless endpoint)."""
        self.fig.savefig(path, bbox_inches="tight")

    def close(self):
        self._plt.close(self.fig)
