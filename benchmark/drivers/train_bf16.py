"""The training driver (``drivers/train.py``) for the configuration that
rounds its convolutions' operands to bf16 and trains every HC block through
kernel K4 (``compute_dtype="bfloat16"``, ``use_pallas``): the same steps,
traffic parameters and numbers, judged by the reference at that precision
(``reference/dctts_bf16.py``, float64 around the rounding), and K4's
counted work over the window (``k4_least_s``, ``harness/k4_work.py``).

The control (``control()``) is that reference with the operands rounded to
float8 e4m3, the nearest precision below bf16; ``control(tf32_on=False)``,
the witness, is the float64 reference without any rounding: what bf16
operands themselves read."""
from __future__ import annotations

import torch

from ..harness import check, k4_work
from ..reference import dctts as R
from ..reference import dctts_bf16 as Q
from . import train


class Cell(train.Cell):
    def __init__(self, cfg: dict, program: dict, traffic: dict, seed: int,
                 device):
        if (program["compute_dtype"], program["use_pallas"]) != (
                "bfloat16", True):
            raise ValueError("the bf16-operand reference takes "
                             "compute_dtype bfloat16 with use_pallas")
        self.k4_least_s = 0.0
        super().__init__(cfg, program, traffic, seed, device)

    def _step(self, batch):
        self.k4_least_s += k4_work.least_seconds(self.cfg,
                                                 *batch["mels"].shape[:2])
        return super()._step(batch)

    def run_window(self, seconds: float, units: int | None):
        """The parent's window; ``k4_least_s`` sums K4's least time over
        the window's steps."""
        self.k4_least_s = 0.0
        return super().run_window(seconds, units)

    def _reference(self, batches, fmt=torch.bfloat16) -> dict:
        """``check.reference_training`` with the operands rounded to ``fmt``
        (None: not rounded, the plain float64 reference)."""
        with check.tf32(False):
            p0 = check._params(self.cfg, self.network, self.seed,
                               self.device)
            batches = [{k: v.double() if v.is_floating_point() else v
                        for k, v in b.items()} for b in batches]
            tr = R.Trainer(self.cfg, self.network, p0, self.drop_seed) \
                if fmt is None else \
                Q.Trainer(self.cfg, self.network, p0, self.drop_seed, fmt)
            losses = []
            for i, b in enumerate(batches):
                loss, g = tr.step(b)
                losses.append(loss)
                if i == 0:
                    grads = check._norms(g)
                del g
            change = check._norms({k: tr.p[k].detach() - p0[k]
                                   for k in p0})
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change}

    def control(self, tf32_on: bool = True) -> dict:
        """After ``judge``: the float8 control (or, ``tf32_on`` False, the
        unrounded witness) in the program's place, judged as the program
        is."""
        fmt = torch.float8_e4m3fn if tf32_on else None
        return check.train_readings(self._reference(self.checked, fmt),
                                    self.ref)
