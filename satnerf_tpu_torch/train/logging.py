"""Run logging: TensorBoard scalars/images (the reference's TensorBoardLogger,
main.py:239) plus a metrics.jsonl stream for machine consumption."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class RunLogger:
    def __init__(self, logs_dir: str, exp_name: str):
        self.run_dir = os.path.join(logs_dir, exp_name)
        os.makedirs(self.run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(self.run_dir)
        except Exception:
            self.tb = None

    def scalars(self, step: int, scalars: dict, prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}" if prefix else k
            rec[name] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(name, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def images(self, step: int, tag: str, stack) -> None:
        """stack: (N, 3, H, W) float array in [0, 1]."""
        if self.tb is not None:
            import numpy as np

            self.tb.add_images(tag, np.asarray(stack), step)

    def close(self):
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()


def visualize_depth(depth, cmap: str = "jet"):
    """(H, W) depth -> (3, H, W) colormapped float array in [0, 1]
    (train_utils.py:59-72, matplotlib jet in place of cv2 COLORMAP_JET; a gray
    ramp where matplotlib is not installed)."""
    import numpy as np

    x = np.nan_to_num(np.asarray(depth, np.float64))
    mi, ma = x.min(), x.max()
    x = (x - mi) / (ma - mi + 1e-8)
    try:
        import matplotlib
    except ImportError:  # no colormap at hand: a gray ramp
        return np.repeat(x[None], 3, axis=0).astype("float32")
    rgba = matplotlib.colormaps[cmap](x)
    return np.moveaxis(rgba[..., :3], -1, 0).astype("float32")
