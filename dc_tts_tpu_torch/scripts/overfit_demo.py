"""Learning demo: overfit one utterance, then synthesize it through the
production path and compare with the training target; the port of
``scripts/overfit_demo.py``:
``python -m dc_tts_tpu_torch.scripts.overfit_demo [--device cpu]
[--steps N]``.

At ``test_config()`` with B = 1 and a warm-up of 200 steps: the sentence
"a quick brown fox." and a synthetic recording of it (a tone a character,
so the audio follows the text), its features from the port's own
``wav_to_spectrograms``. Both networks train ``--steps`` steps
(``DEMO_STEPS``, 3000 by default) from seeded parameters; then the default
``Synthesizer`` (the fused decode K1 at "highest", Griffin-Lim K2, 16-bit
PCM, the chunked path) speaks the sentence. Prints the free-running mel L1
against the target, the attention cursor's monotonic fraction, the
synthesized audio's mel correlation and L1 against the target, and PASS
(mel L1 < 0.15 and correlation > 0.5, the JAX demo's bar) or WEAK.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

SENTENCE = "a quick brown fox."


def demo_config():
    from ..config import test_config
    return test_config().replace(warmup_steps=200.0, B=1)


def utterance(cfg, sentence: str = SENTENCE) -> dict:
    """ids (1, max_N), the target's frame count t, and the training
    features: mels (1, max_T, n_mels), mags (1, max_T * r, n_freq), zero
    past t (host numpy)."""
    from .. import text as text_mod
    from ..dsp.features import reduce_mel, wav_to_spectrograms

    ids = text_mod.encode_batch([sentence], cfg)
    n_chars = int(np.flatnonzero(ids[0])[-1]) + 1
    per_char = (cfg.max_T * cfg.r * cfg.hop_length) // n_chars
    wav = np.concatenate([
        0.4 * np.sin(2 * np.pi * (150 + 35 * (int(c) % 12))
                     * np.arange(per_char) / cfg.sr)
        for c in ids[0, :n_chars]]).astype(np.float32)
    with torch.no_grad():
        mel, mag = wav_to_spectrograms(torch.from_numpy(wav), cfg)
    mel, mag = reduce_mel(mel.numpy(), mag.numpy(), cfg.r)
    t = min(mel.shape[0], cfg.max_T)
    mels = np.zeros((1, cfg.max_T, cfg.n_mels), np.float32)
    mags = np.zeros((1, cfg.max_T * cfg.r, cfg.n_freq), np.float32)
    mels[0, :t] = mel[:t]
    mags[0, : t * cfg.r] = mag[: t * cfg.r]
    return {"ids": ids, "n_chars": n_chars, "t": t, "mels": mels,
            "mags": mags}


def train(cfg, data: dict, steps: int, t2m_state, ssrn_state, device,
          log_every: int = 0):
    """``steps`` steps of each network on the utterance -> (Text2Mel state,
    SSRN state, the last step's metrics of each as floats)."""
    from ..train import steps as TS

    def dev(x):
        return torch.as_tensor(x, device=device)

    batch = {"texts": dev(data["ids"]), "mels": dev(data["mels"]),
             "text_lens": dev(np.array([data["n_chars"]])),
             "mel_lens": dev(np.array([data["t"]]))}
    sbatch = {"mels": batch["mels"], "mags": dev(data["mags"])}
    step1 = TS.make_text2mel_step(cfg, seed=2)
    step2 = TS.make_ssrn_step(cfg, seed=3)
    gen = torch.Generator(device=device)
    t0 = time.time()
    for i in range(steps):
        t2m_state, m1 = step1(t2m_state, batch, gen)
        ssrn_state, m2 = step2(ssrn_state, sbatch, gen)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i}: t2m mels L1 {float(m1['loss_mels']):.4f} "
                  f"att {float(m1['loss_att']):.4f} "
                  f"diag {float(m1['attention_diagonality']):.4f} "
                  f"ssrn mags L1 {float(m2['loss_mags']):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return (t2m_state, ssrn_state, {k: float(v) for k, v in m1.items()},
            {k: float(v) for k, v in m2.items()})


def spectral_match(cfg, data: dict, wav: np.ndarray):
    """(correlation, mean L1) of a waveform's reduced mel spectrogram
    against the training target over the target's frames."""
    from ..dsp.features import reduce_mel, wav_to_spectrograms
    with torch.no_grad():
        mel, _ = wav_to_spectrograms(torch.as_tensor(wav, dtype=torch.float32),
                                     cfg)
    mel = reduce_mel(mel.numpy(), np.zeros((mel.shape[0], cfg.n_freq),
                                           np.float32), cfg.r)[0]
    a = data["mels"][0, :data["t"]].ravel()
    b = mel[:data["t"]].ravel()
    n = min(len(a), len(b))
    return (float(np.corrcoef(a[:n], b[:n])[0, 1]),
            float(np.abs(a[:n] - b[:n]).mean()))


def evaluate(cfg, data: dict, t2m_params, ssrn_params, device, **kw) -> dict:
    """The utterance through ``Synthesizer(pcm16=True, **kw)``: its int16
    waveform from the chunked path (chunk 2 > the batch: the padded last
    chunk), then ``synthesize_ids``' Y, Z and alignment -> the demo's
    measures and those outputs (host numpy)."""
    from ..pipeline import Synthesizer
    from ..train.optimizer import tree_map

    synth = Synthesizer(cfg, tree_map(torch.Tensor.detach, t2m_params),
                        tree_map(torch.Tensor.detach, ssrn_params),
                        device=device, pcm16=True, **kw)
    wavs = synth.synthesize_ids_chunked(data["ids"], chunk=2)
    if wavs.dtype != np.int16 or wavs.shape[0] != 1:
        raise RuntimeError(f"synthesis returned {wavs.dtype} {wavs.shape}")
    _, Y, Z, align = (o.cpu().numpy()
                      for o in synth.synthesize_ids(data["ids"]))
    wav = wavs[0].astype(np.float32) / 32767.0
    t = data["t"]
    cursor = align[0].argmax(axis=0)
    corr, l1 = spectral_match(cfg, data, wav)
    return {"mel_l1": float(np.abs(Y[0, :t] - data["mels"][0, :t]).mean()),
            "monotonic": float(np.mean(np.diff(cursor[:t]) >= 0)),
            "corr": corr, "l1": l1, "wav": wav, "Y": Y, "Z": Z,
            "align": align}


def main(argv=None) -> int:
    from ..device import resolve_device
    from ..train import steps as TS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("DEMO_STEPS", "3000")))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = demo_config()
    data = utterance(cfg)
    s1 = TS.init_text2mel_state(cfg, torch.Generator().manual_seed(0),
                                device)
    s2 = TS.init_ssrn_state(cfg, torch.Generator().manual_seed(1), device)
    s1, s2, _, _ = train(cfg, data, args.steps, s1, s2, device,
                         log_every=500)
    r = evaluate(cfg, data, s1.params, s2.params, device)
    print(f"\nfree-running mel L1 vs target: {r['mel_l1']:.4f}")
    print(f"attention cursor monotonic fraction: {r['monotonic']:.2f}")
    print(f"synthesized-audio mel correlation: {r['corr']:.3f} "
          f"(mel L1 {r['l1']:.4f})")
    ok = r["mel_l1"] < 0.15 and r["corr"] > 0.5
    print("DEMO", "PASS" if ok else "WEAK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
