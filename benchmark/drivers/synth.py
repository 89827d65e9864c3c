"""The synthesis driver: a closed loop of one client through
``Synthesizer.synthesize_ids_chunked``, the program's entry for text to
pcm16 waveforms on the host.

Traffic parameters (``traffic/<name>.json``): ``sentences`` (the texts),
``rows`` (how many a pass sends, the texts tiled) and ``chunk`` (rows a
call). Each seed sends the same rows in another order. A unit of work is
one call: a pass of ``rows / chunk`` calls is timed whole when ``unit`` is
"pass" (throughput: every call's pcm16 on the host, over the window of
whole passes), and each call alone when it is "request" (latency).

Correctness: the outputs of a seeded sample of rows (``sample``: rows a
pass, or requests among the first ``sample_from``; the longest text among
them always), as the window produced them: Y and the attention that the
decode chose, SSRN's Z, and the pcm16 waveforms delivered to the host."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import check, inputs, work
from ..harness.trace import Spans


class Cell:
    def __init__(self, cfg: dict, program: dict, traffic: dict, seed: int,
                 device):
        from dc_tts_tpu_torch.config import Config
        from dc_tts_tpu_torch.pipeline import Synthesizer

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        t0 = time.perf_counter()
        sizes = {k: cfg[k] for k in Config.__dataclass_fields__ if k in cfg}
        pcfg = Config(**sizes).replace(stft_method=program["stft_method"])
        self.synth = Synthesizer(
            pcfg, inputs.to_tree(inputs.make_params(cfg, "text2mel", seed,
                                                    device)),
            inputs.to_tree(inputs.make_params(cfg, "ssrn", seed, device)),
            device=device, decode_mode=program["decode_mode"],
            decode_prec=program["decode_prec"],
            ssrn_precision=program["ssrn_precision"], pcm16=program["pcm16"])
        rng = np.random.default_rng(inputs.sub_seed(seed, 3))
        sents = traffic["sentences"]
        tiled = (sents * -(-traffic["rows"] // len(sents)))[:traffic["rows"]]
        self.ids = inputs.encode(tiled, cfg)[rng.permutation(len(tiled))]
        self.chunk = traffic["chunk"]
        self.per_pass = -(-len(self.ids) // self.chunk)
        self.sample_rng = np.random.default_rng(inputs.sub_seed(seed, 4))
        self.kept = {}             # call index -> [(row, Y, A, Z)]
        self.keep_plan = {}        # call index -> rows of that call to keep
        self.host = {}             # (call index, row) -> pcm16 on the host
        self.calls = 0
        self.spans = None
        self._plan_sample()
        self._wrap()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        # warm-up: one call of the cell's own shape
        self.synth.synthesize_ids_chunked(self.ids[: self.chunk], self.chunk)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_marks = {"program": t1 - t0,
                            "warm-up": time.perf_counter() - t1}
        self.calls = 0

    # ----------------------------------------------------------- sample
    def _plan_sample(self):
        t, n = self.traffic, len(self.ids)
        lens = (self.ids > 0).sum(1)
        if t["unit"] == "pass":
            # ``sample`` rows of each of the first passes; the longest text
            # in the first
            plan = {(0, int(np.argmax(lens)))}
            for p in range(t["sample_passes"]):
                plan |= {(p, int(j)) for j in self.sample_rng.choice(
                    n, t["sample"], replace=False)}
            for p, j in sorted(plan):
                call = p * self.per_pass + j // self.chunk
                self.keep_plan.setdefault(call, []).append(j % self.chunk)
        else:
            first = t["sample_from"]
            calls = set(self.sample_rng.choice(first, t["sample"],
                                               replace=False).tolist())
            order = [self._request_row(i) for i in range(first)]
            calls.add(int(np.argmax([lens[r] for r in order])))
            for c in calls:
                self.keep_plan[int(c)] = list(range(self.chunk))

    def _request_row(self, i: int) -> int:
        return (i * self.chunk) % len(self.ids)

    def _wrap(self):
        """Keep the sampled rows' (Y, A, Z) as the timed path makes them."""
        synth, orig = self.synth, self.synth._synthesize_rows

        def rows(ids):
            out = orig(ids)
            if self.spans is not None:
                end = self.spans.mark()
                self.spans.add("vocoder", self._last, end)
            keep = self.keep_plan.get(self.calls)
            if keep is not None:
                sel = torch.as_tensor(keep, device=out[1].device)
                wav, Y, Z, A = out
                self.kept[self.calls] = (keep, Y[sel], A[sel], Z[sel])
            self.calls += 1
            return out
        synth._synthesize_rows = rows

    def instrument(self, spans: Spans | None):
        """Record device spans around the program's layer entries while
        ``spans`` is set: Text2Mel.decode (TextEnc and the decode K1),
        SSRN.apply, and from there to the call's end (Griffin-Lim K2,
        de-emphasis, pcm16). None takes the wrappers away."""
        from dc_tts_tpu_torch.models.ssrn import SSRN
        from dc_tts_tpu_torch.models.text2mel import Text2Mel

        if spans is None:
            Text2Mel.decode, SSRN.apply = self._orig
            self.spans = None
            return
        self._orig = dec, app = Text2Mel.decode, SSRN.apply
        self.spans = spans

        def decode(this, *a, **k):
            start = spans.mark()
            out = dec(this, *a, **k)
            self._last = spans.mark()
            spans.add("text2mel", start, self._last)
            return out

        def apply(this, *a, **k):
            out = app(this, *a, **k)
            end = spans.mark()
            spans.add("ssrn", self._last, end)
            self._last = end
            return out
        Text2Mel.decode, SSRN.apply = decode, apply

    # ----------------------------------------------------------- window
    def run_window(self, seconds: float, units: int | None):
        """Calls until ``seconds`` have passed (whole passes for "pass"),
        or ``units`` units when given -> the units' host seconds."""
        unit_s = []
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        while True:
            u0 = time.perf_counter()
            self._unit()
            unit_s.append(time.perf_counter() - u0)
            done = len(unit_s)
            if units is not None:
                if done >= units:
                    break
            elif time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.units = len(unit_s)
        return unit_s

    def _unit(self):
        first = self.calls
        if self.traffic["unit"] == "pass":
            ids = self.ids
        else:
            r = self._request_row(first)
            ids = self.ids[r: r + self.chunk]
        self._keep_host(first, self.synth.synthesize_ids_chunked(ids,
                                                                self.chunk))

    def _keep_host(self, first_call: int, wavs: np.ndarray):
        for call in range(first_call, self.calls):
            for j in self.keep_plan.get(call, ()):
                row = (call - first_call) * self.chunk + j
                self.host[(call, j)] = wavs[row].copy()

    # ----------------------------------------------------------- results
    def attempted(self) -> int:
        """Sentences the window synthesised."""
        return self.units * (len(self.ids) if self.traffic["unit"] == "pass"
                             else self.chunk)

    def audio_seconds(self) -> float:
        return self.attempted() * work.n_samples(self.cfg) / self.cfg["sr"]

    def sample(self):
        """(ids, Y, A, Z, pcm16) of the kept rows that the window
        finished, stacked."""
        ids, Y, A, Z, W = [], [], [], [], []
        for call, (rows, y, a, z) in sorted(self.kept.items()):
            if call >= self.calls:
                continue
            base = self._call_rows(call)
            for i, j in enumerate(rows):
                ids.append(self.ids[base + j])
                Y.append(y[i])
                A.append(a[i])
                Z.append(z[i])
                W.append(self.host[(call, j)])
        return (np.stack(ids), torch.stack(Y), torch.stack(A),
                torch.stack(Z), np.stack(W))

    def _call_rows(self, call: int) -> int:
        if self.traffic["unit"] == "pass":
            return (call % self.per_pass) * self.chunk
        return self._request_row(call)

    def free(self):
        """Drop the program's state (weights, packed weights, caches)."""
        self.synth = None

    def sample_units(self) -> int:
        """Units that finish the whole sample: the sampled passes, or the
        requests it is drawn from."""
        t = self.traffic
        return t["sample_passes"] if t["unit"] == "pass" else t["sample_from"]

    def judge(self) -> dict:
        """Frees the program's state, then the reference's numbers of the
        sample."""
        self.sample_ids, Y, A, Z, wav = self.sample()
        self.free()
        check.release(self.device)
        return check.synth_readings(self.cfg, self.seed, self.sample_ids,
                                    Y, A, Z, wav, self.device)

    def control(self, tf32_on: bool = True) -> dict:
        """After ``judge``: the reference in the program's place on the same
        rows (``check.synth_control``), judged by the same numbers."""
        return check.synth_control(self.cfg, self.seed, self.sample_ids,
                                   self.device, tf32_on)

    def faults(self) -> dict:
        """Faults read by the reference in the program's place: none here
        (``tests/test_bench_faults.py`` of the benchmark plants them in the
        program)."""
        return {}

    def work_per_unit(self) -> dict:
        """{stage: (FLOPs, bytes)} of one call (one chunk of rows)."""
        return work.synth_stages(self.cfg, self.chunk, self.cfg["max_N"])

    def calls_per_unit(self) -> int:
        return self.per_pass if self.traffic["unit"] == "pass" else 1
