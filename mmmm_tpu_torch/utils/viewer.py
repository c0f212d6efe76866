"""Interactive volume slice viewer, the port of ``mmmm_tpu/utils/viewer.py``
(``mmmm/misc.py:IndexTrackerBinary`` analog).

Scroll-wheel navigation through a (D, H, W) volume with an optional binary
mask overlay. Requires matplotlib; import is deferred so headless training
environments never pay for it.
"""
from __future__ import annotations

import numpy as np


class SliceViewer:
    def __init__(self, volume: np.ndarray, mask: np.ndarray | None = None, alpha: float = 0.4):
        import matplotlib.pyplot as plt

        self.volume = np.asarray(volume)
        self.mask = None if mask is None else np.asarray(mask).astype(bool)
        self.alpha = alpha
        self.index = self.volume.shape[0] // 2
        self.fig, self.ax = plt.subplots()
        self.im = self.ax.imshow(self.volume[self.index], cmap="gray")
        self.overlay = None
        if self.mask is not None:
            self.overlay = self.ax.imshow(
                self._mask_rgba(self.index), interpolation="nearest"
            )
        self.ax.set_title(f"slice {self.index}/{self.volume.shape[0] - 1}")
        self.fig.canvas.mpl_connect("scroll_event", self.on_scroll)

    def _mask_rgba(self, idx: int) -> np.ndarray:
        m = self.mask[idx]
        rgba = np.zeros((*m.shape, 4), np.float32)
        rgba[m] = (1.0, 0.1, 0.1, self.alpha)
        return rgba

    def on_scroll(self, event):
        step = 1 if event.button == "up" else -1
        self.index = int(np.clip(self.index + step, 0, self.volume.shape[0] - 1))
        self.im.set_data(self.volume[self.index])
        if self.overlay is not None:
            self.overlay.set_data(self._mask_rgba(self.index))
        self.ax.set_title(f"slice {self.index}/{self.volume.shape[0] - 1}")
        self.fig.canvas.draw_idle()

    def show(self):
        import matplotlib.pyplot as plt

        plt.show()
