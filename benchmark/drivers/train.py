"""The training driver: the step that ``make_text2mel_step`` or
``make_ssrn_step`` builds, driven as the training CLI's loop drives it.

Traffic parameters (``traffic/<name>.json``): ``network``, ``keys`` (what
the step reads of a batch), ``buckets`` ([N, T] grids of the batches),
``text_lens`` and ``mel_lens`` (the range each bucket's per-row lengths
are drawn from), ``pool`` (batches made for each bucket) and
``loss_every`` (steps between the host's reads of the loss, the CLI's
``--log-every``). Batches are made on the card from the seed at set-up,
zero past each row's lengths as the CLI's loader pads them; the steps
visit the buckets in blocks that hold each bucket once, in a seeded order.

Set-up builds the training state, with the benchmark's parameters, and
runs its first steps, one in each bucket, through the same call the window
then continues: they warm every shape and are the steps the reference
follows. What is judged: each of them's loss, the first step's gradient
as the optimizer took it (clipped, read back from Adam's first moment),
and every parameter's change after the last of them."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import check, inputs, work
from ..harness.trace import Spans

B1 = 0.9          # Adam's first-moment decay: mu after one step is (1-B1) g


class Cell:
    def __init__(self, cfg: dict, program: dict, traffic: dict, seed: int,
                 device):
        from dc_tts_tpu_torch.config import Config
        from dc_tts_tpu_torch.params import requires_grad
        from dc_tts_tpu_torch.train import steps as TS
        from dc_tts_tpu_torch.train.optimizer import init_opt_state

        t0 = time.perf_counter()
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.network = device, traffic["network"]
        sizes = {k: cfg[k] for k in Config.__dataclass_fields__ if k in cfg}
        pcfg = Config(**sizes).replace(
            compute_dtype=program["compute_dtype"],
            use_pallas=program["use_pallas"], remat=program["remat"])
        params = inputs.to_tree(inputs.make_params(cfg, self.network, seed,
                                                   device))
        requires_grad(params)
        self.state = TS.TrainState(params, init_opt_state(params), 0)
        make = TS.make_text2mel_step if self.network == "text2mel" \
            else TS.make_ssrn_step
        self.drop_seed = inputs.sub_seed(seed, 5)
        self.step_fn = make(pcfg, seed=self.drop_seed)
        self.gen = torch.Generator(device=device)
        t1 = time.perf_counter()
        self._make_pool()
        t2 = time.perf_counter()
        self._first_steps()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_marks = {"program": t1 - t0, "batches": t2 - t1,
                            "warm-up": time.perf_counter() - t2}

    # ----------------------------------------------------------- inputs
    def _make_pool(self):
        t, cfg, dev = self.traffic, self.cfg, self.device
        B, r = cfg["B"], cfg["r"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(inputs.sub_seed(self.seed, 6))
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 7))
        self.pool = []            # per bucket, a list of batches
        for (N, T), (n0, n1), (t0, t1) in zip(t["buckets"], t["text_lens"],
                                              t["mel_lens"]):
            batches = []
            for _ in range(t["pool"]):
                tl = torch.as_tensor(rng.integers(n0, n1 + 1, B),
                                     dtype=torch.int32, device=dev)
                ml = torch.as_tensor(rng.integers(t0, t1 + 1, B),
                                     dtype=torch.int32, device=dev)
                n_ok = torch.arange(N, device=dev)[None] < tl[:, None]
                t_ok = torch.arange(T, device=dev)[None] < ml[:, None]
                f_ok = torch.arange(r * T, device=dev)[None] < \
                    r * ml[:, None]
                b = {"text_lens": tl, "mel_lens": ml}
                # characters 2.. of the vocabulary, EOS (1) last, PAD after
                texts = torch.randint(2, len(cfg["vocab"]), (B, N),
                                      generator=gen, device=dev)
                texts = torch.where(torch.arange(N, device=dev)[None]
                                    == (tl[:, None] - 1), 1, texts)
                b["texts"] = torch.where(n_ok, texts, 0).to(torch.int32)
                b["mels"] = torch.rand(B, T, cfg["n_mels"], generator=gen,
                                       device=dev) * t_ok[..., None]
                if "mags" in t["keys"]:
                    b["mags"] = torch.rand(B, r * T, cfg["n_fft"] // 2 + 1,
                                           generator=gen, device=dev) \
                        * f_ok[..., None]
                batches.append({k: b[k] for k in t["keys"]})
            self.pool.append(batches)
        order_rng = np.random.default_rng(inputs.sub_seed(self.seed, 8))
        self._order_rng, self._queue = order_rng, []
        self.visits = [0] * len(self.pool)

    def _next(self):
        """(bucket, batch) of the next step: blocks of one step in each
        bucket, each block in a seeded order; each bucket's pool in turn."""
        if not self._queue:
            self._queue = list(self._order_rng.permutation(len(self.pool)))
        b = int(self._queue.pop(0))
        pool = self.pool[b]
        batch = pool[self.visits[b] % len(pool)]
        self.visits[b] += 1
        return b, batch

    # ----------------------------------------------------------- steps
    def _step(self, batch):
        self.state, metrics = self.step_fn(self.state, batch, self.gen)
        if self.state.step % self.traffic["loss_every"] == 0:
            float(metrics["loss"])
        return metrics

    def _first_steps(self):
        """One step in each bucket; keeps what the reference checks."""
        p0 = {k: v.detach().clone() for k, v in
              inputs.flatten(self.state.params).items()}
        self.checked, losses = [], []
        for i in range(len(self.pool)):
            b, batch = self._next()
            self.checked.append(batch)
            losses.append(self._step(batch)["loss"])
            if i == 0:
                mu = inputs.flatten(self.state.opt_state[1]["mu"])
                self.grad_norms = {k: float(torch.linalg.vector_norm(v)
                                            / (1 - B1))
                                   for k, v in mu.items()}
        self.losses = [float(x) for x in losses]
        p = inputs.flatten(self.state.params)
        self.change_norms = {k: float(torch.linalg.vector_norm(
            p[k].detach() - p0[k])) for k in p0}

    def instrument(self, spans: Spans | None):
        """No spans: a step's per-layer metrics come from the trace."""

    def run_window(self, seconds: float, units: int | None):
        """Steps until ``seconds`` have passed on the host (or ``units``
        steps), then one wait for the device -> [] (a step's host time
        says nothing: the host runs ahead of the device)."""
        self.window_flops, n = 0, 0
        cfg, B = self.cfg, self.cfg["B"]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        while True:
            b, batch = self._next()
            N, T = self.traffic["buckets"][b]
            self._step(batch)
            self.window_flops += work.train_flops(cfg, self.network, B, N, T)
            n += 1
            if units is not None:
                if n >= units:
                    break
            elif time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - t0
        self.units = n
        return []

    def attempted(self) -> int:
        return self.units

    def free(self):
        """Drop the program's state and all batches but the checked."""
        self.state = self.step_fn = self.pool = None

    def sample_units(self) -> int:
        """The checked steps ran at set-up; one step more ends a window."""
        return 1

    def _reference(self, batches, **kw) -> dict:
        return check.reference_training(self.cfg, self.network, self.seed,
                                        self.drop_seed, batches, self.device,
                                        **kw)

    def judge(self) -> dict:
        """Frees the program's state, then the checked steps' numbers
        against the reference's (kept as ``ref``)."""
        self.run = {"losses": self.losses, "grad_norms": self.grad_norms,
                    "change_norms": self.change_norms}
        self.free()
        check.release(self.device)
        self.ref = self._reference(self.checked)
        return check.train_readings(self.run, self.ref)

    def control(self, tf32_on: bool = True) -> dict:
        """After ``judge``: the reference's steps in float32 (TF32 on: the
        control; off: float32's own witness), judged as the program is."""
        return check.train_readings(self._reference(
            self.checked, tf32_on=tf32_on, dtype=torch.float32), self.ref)

    def faults(self) -> dict:
        """After ``judge``: half of each checked batch left out and the mean
        taken over the rest, in the reference put in the program's place
        (a state left unchanged reads 1 by measure)."""
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                for b in self.checked]
        return {"half_batch": check.train_readings(self._reference(half),
                                                   self.ref)}
