"""A run with the timed path broken underneath comes out not correct:
the whole run (set-up, window, comparison) on the CPU at the rehearsal
sizes, the harness's look for a card skipped, one fault planted in the
program at a time. Synthesis: half of each batch left out (its rows
copied from the other half), a token altered where it is produced (an
attention row's mass moved, so the next cursor moves), an answer altered
(the waveform scaled), part of a layer's arithmetic left out (every
conv's bias; SSRN's layer-norm shifts). Training: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, a gradient altered where it is produced (the largest leaf's
zeroed), every conv's bias left out. One chip: no exchange between chips
to leave out."""
import pytest
import torch

from benchmark.harness.runner import run_cell


def _half_rows(monkeypatch):
    from dc_tts_tpu_torch.pipeline import Synthesizer
    orig = Synthesizer._synthesize_rows

    def rows(self, ids):
        h = max(1, len(ids) // 2)
        out = orig(self, ids[:h])
        return tuple(torch.cat([o, o])[: len(ids)] for o in out)
    monkeypatch.setattr(Synthesizer, "_synthesize_rows", rows)


def _token(monkeypatch):
    from dc_tts_tpu_torch.models.text2mel import Text2Mel
    orig = Text2Mel.decode

    def decode(self, *a, **k):
        Y, A = orig(self, *a, **k)
        A = A.clone()
        A[:, :, 3] = torch.roll(A[:, :, 3], 1, dims=1)
        return Y, A
    monkeypatch.setattr(Text2Mel, "decode", decode)


def _answer(monkeypatch):
    import dc_tts_tpu_torch.pipeline as P
    orig = P.spectrogram_to_wav
    monkeypatch.setattr(P, "spectrogram_to_wav",
                        lambda z, cfg: 0.9 * orig(z, cfg))


def _bias(monkeypatch):
    import dc_tts_tpu_torch.models.layers as L
    for name in ("conv1d", "conv1d_transpose"):
        orig = getattr(L, name)

        def conv(params, *a, _orig=orig, **k):
            return _orig({**params, "b": 0.0 * params["b"]},
                         *a, **k)
        monkeypatch.setattr(L, name, conv)


def _ssrn_norm_shift(monkeypatch):
    from dc_tts_tpu_torch.models.ssrn import SSRN
    orig = SSRN.apply

    def no_shift(p):
        if isinstance(p, dict):
            return {k: torch.zeros_like(v) if k == "beta" else no_shift(v)
                    for k, v in p.items()}
        return [no_shift(v) for v in p] if isinstance(p, list) else p

    def apply(self, params, *a, **k):
        return orig(self, no_shift(params), *a, **k)
    monkeypatch.setattr(SSRN, "apply", apply)


def _unchanged(monkeypatch):
    import dc_tts_tpu_torch.train.steps as S
    monkeypatch.setattr(S, "apply_updates",
                        lambda params, grads, opt_state, cfg: opt_state)


def _grads(monkeypatch, alter):
    import dc_tts_tpu_torch.train.steps as S
    for name in ("text2mel_grads", "ssrn_grads"):
        orig = getattr(S, name)

        def fn(cfg, params, batch, *a, _orig=orig, **k):
            batch, post = alter(batch)
            metrics, grads = _orig(cfg, params, batch, *a, **k)
            return metrics, post(grads)
        monkeypatch.setattr(S, name, fn)


def _half_batch(monkeypatch):
    _grads(monkeypatch, lambda b: ({k: v[: v.shape[0] // 2]
                                    for k, v in b.items()}, lambda g: g))


def _leaf(monkeypatch):
    def zero_largest(grads):
        i = max(range(len(grads)), key=lambda j: float(grads[j].norm()))
        return [torch.zeros_like(g) if j == i else g
                for j, g in enumerate(grads)]
    _grads(monkeypatch, lambda b: (b, zero_largest))


SYNTH = {"half_batch": _half_rows, "token_altered": _token,
         "answer_altered": _answer, "bias_dropped": _bias,
         "ssrn_norm_shift_dropped": _ssrn_norm_shift}
TRAIN = {"state_unchanged": _unchanged, "half_batch": _half_batch,
         "gradient_altered": _leaf, "bias_dropped": _bias}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("synth.lj.bulk72", "synth.lj.single")
    for f in sorted(SYNTH)
    if (w, f) != ("synth.lj.single", "half_batch")])   # a batch of one
def test_synthesis_faults(monkeypatch, workload, fault):
    SYNTH[fault](monkeypatch)
    result, _ = run_cell(workload, 2 ** 31 + 101, 0.2, False, rehearse=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", ["train.lj.ssrn"])
@pytest.mark.parametrize("fault", sorted(TRAIN))
def test_training_faults(monkeypatch, workload, fault):
    TRAIN[fault](monkeypatch)
    result, _ = run_cell(workload, 2 ** 31 + 103, 0.2, False, rehearse=True)
    assert not result["correct"], result["checks"]
